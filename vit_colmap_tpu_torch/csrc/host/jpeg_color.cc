// libjpeg's decoder steps after the IDCT, on the host: chroma upsampling
// and the YCbCr -> RGB conversion, as libjpeg-turbo 2.x (libjpeg.so.62)
// computes them.  The nvJPEG codec (jpeg_nvjpeg.cc) decodes the planes as
// the file stores them and finishes here, so that only the IDCT's rounding
// separates its bytes from libjpeg's; tests/test_torch_native_io.py holds
// both steps to libjpeg's own decode bit for bit, on planes libjpeg
// decoded raw (jpeg_read_raw_data).
//
// Upsampling (jdsample.c, do_fancy_upsampling on, libjpeg's default):
//   h2v1, downsampled width > 2: each output pair from 3/4 of the nearer
//     and 1/4 of the further input sample, biases 1 and 2 (>> 2);
//   h2v2, downsampled width > 2: the same triangle filter in both axes on
//     column sums (3 x nearer row + further row), biases 8 and 7 (>> 4);
//   h1v2: the vertical filter alone, biases 1 and 2 (>> 2);
//   any other integral factor (and h2v1 / h2v2 at width <= 2): replication.
// The rows above the first and below the last are copies of them (the
// main controller's context rows, jdmainct.c), and the columns beside the
// first and last likewise (the filters' edge cases).
//
// Colour (jdcolor.c, ycc_rgb_convert): R = Y + Cr_r[Cr], B = Y + Cb_b[Cb],
// G = Y + ((Cb_g[Cb] + Cr_g[Cr]) >> 16), each clamped to 0..255, from
// tables in 16-bit fixed point with rounding.

#include <algorithm>
#include <cstdint>

#include "jpeg_backend.h"

namespace vc {
namespace {

// The factor f with ceil(full / f) == part, or 0.
int expansion(int full, int part) {
  for (int f = 1; f <= 4; ++f)
    if ((full + f - 1) / f == part) return f;
  return 0;
}

inline int clampi(int v, int lo, int hi) { return std::min(std::max(v, lo), hi); }

// One chroma plane (pw x ph) -> w x h.
void upsample_plane(const uint8_t* in, int pw, int ph, int fx, int fy,
                    uint8_t* out, int w, int h) {
  const bool fancy_h = fx == 2 && pw > 2;
  if (fx == 2 && fy == 2 && fancy_h) {
    for (int oy = 0; oy < h; ++oy) {
      const int r = oy / 2;
      const uint8_t* near = in + static_cast<size_t>(r) * pw;
      const uint8_t* far =
          in + static_cast<size_t>(clampi(oy % 2 ? r + 1 : r - 1, 0, ph - 1)) * pw;
      uint8_t* o = out + static_cast<size_t>(oy) * w;
      for (int ox = 0; ox < w; ++ox) {
        const int c = ox / 2;
        const int side = clampi(ox % 2 ? c + 1 : c - 1, 0, pw - 1);
        const int this_sum = near[c] * 3 + far[c];
        const int side_sum = near[side] * 3 + far[side];
        o[ox] = static_cast<uint8_t>((this_sum * 3 + side_sum + (ox % 2 ? 7 : 8)) >> 4);
      }
    }
  } else if (fx == 2 && fy == 1 && fancy_h) {
    for (int oy = 0; oy < h; ++oy) {
      const uint8_t* row = in + static_cast<size_t>(oy) * pw;
      uint8_t* o = out + static_cast<size_t>(oy) * w;
      for (int ox = 0; ox < w; ++ox) {
        const int c = ox / 2;
        const int side = clampi(ox % 2 ? c + 1 : c - 1, 0, pw - 1);
        o[ox] = static_cast<uint8_t>((row[c] * 3 + row[side] + (ox % 2 ? 2 : 1)) >> 2);
      }
    }
  } else if (fx == 1 && fy == 2) {
    for (int oy = 0; oy < h; ++oy) {
      const int r = oy / 2;
      const uint8_t* near = in + static_cast<size_t>(r) * pw;
      const uint8_t* far =
          in + static_cast<size_t>(clampi(oy % 2 ? r + 1 : r - 1, 0, ph - 1)) * pw;
      uint8_t* o = out + static_cast<size_t>(oy) * w;
      for (int ox = 0; ox < w; ++ox)
        o[ox] = static_cast<uint8_t>((near[ox] * 3 + far[ox] + (oy % 2 ? 2 : 1)) >> 2);
    }
  } else {  // replication (fx == fy == 1 copies)
    for (int oy = 0; oy < h; ++oy) {
      const uint8_t* row = in + static_cast<size_t>(oy / fy) * pw;
      uint8_t* o = out + static_cast<size_t>(oy) * w;
      for (int ox = 0; ox < w; ++ox) o[ox] = row[ox / fx];
    }
  }
}

struct ColorTables {
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  ColorTables() {
    const int32_t kOneHalf = int32_t(1) << 15;
    auto fix = [](double x) { return static_cast<int32_t>(x * 65536.0 + 0.5); };
    for (int i = 0; i < 256; ++i) {
      const int32_t x = i - 128;
      cr_r[i] = static_cast<int>((fix(1.40200) * x + kOneHalf) >> 16);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + kOneHalf) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + kOneHalf;
    }
  }
};

inline uint8_t clamp255(int v) { return static_cast<uint8_t>(clampi(v, 0, 255)); }

}  // namespace

bool upsample_planes(const Planes& in, Planes* out) {
  const int w = in.w, h = in.h;
  const size_t n = static_cast<size_t>(w) * h;
  out->w = out->cw = w;
  out->h = out->ch = h;
  out->y = in.y;
  if (in.cw == 0 || in.ch == 0) {  // gray: neutral chroma
    out->cb.assign(n, 128);
    out->cr.assign(n, 128);
    return true;
  }
  const int fx = expansion(w, in.cw), fy = expansion(h, in.ch);
  if (fx == 0 || fy == 0) return false;
  out->cb.resize(n);
  out->cr.resize(n);
  upsample_plane(in.cb.data(), in.cw, in.ch, fx, fy, out->cb.data(), w, h);
  upsample_plane(in.cr.data(), in.cw, in.ch, fx, fy, out->cr.data(), w, h);
  return true;
}

void ycc_to_rgb(const uint8_t* y, const uint8_t* cb, const uint8_t* cr,
                size_t n, uint8_t* rgb) {
  static const ColorTables t;
  for (size_t i = 0; i < n; ++i) {
    const int Y = y[i];
    rgb[3 * i] = clamp255(Y + t.cr_r[cr[i]]);
    rgb[3 * i + 1] = clamp255(Y + static_cast<int>((t.cb_g[cb[i]] + t.cr_g[cr[i]]) >> 16));
    rgb[3 * i + 2] = clamp255(Y + t.cb_b[cb[i]]);
  }
}

}  // namespace vc
