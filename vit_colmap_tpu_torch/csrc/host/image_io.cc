// Host image decode for the extraction pipeline (host C++, bound with
// ctypes by vit_colmap_tpu_torch/utils/native_io.py).
//
// The port's counterpart of the JAX package's native/image_io.cc, with its
// C ABI (the batch decode takes one more argument, the CUDA device) and the
// same bytes: JPEG and PNG decoded straight to I420
// (YUV 4:2:0) planes at the patch-aligned target size, the layout the
// yuv420 wire ships (vit_colmap_tpu_torch/ops/transfer.py).  JPEG keeps
// the codec's full-range JFIF YCbCr (no RGB pass); PNG goes to RGB, then to
// full-range YCbCr with the same float arithmetic.  Luma is resampled to
// the target grid and chroma directly to the half-resolution I420 grid, by
// half-pixel bilinear, so the 4:2:0 subsample and the resize are one pass.
//
// PNG is decoded here over zlib's uncompress (libz.so.1), with libpng's
// transformations as the JAX decoder sets them: 16-bit samples keep their
// high byte, alpha is dropped, palettes and gray below 8 bits expand to 8
// bits; interlaced files fail.  JPEG goes through jpeg_backend.h (libjpeg or
// nvJPEG, chosen by the build).
//
// C ABI (every function returns 0 on success):
//   vc_probe(path, &w, &h)                     header-only size probe; a
//                                              wrong extension falls back
//                                              to the other format
//   vc_decode_i420(path, tw, th, out)          one image -> packed I420
//   vc_decode_batch_i420(paths, n, tw, th, out, status, n_threads, device)
//                                              on n_threads new threads;
//                                              nvJPEG runs them on CUDA
//                                              device `device` (< 0: 0)
//   vc_decode_jpeg_pixels(path, w, h, channels, out)
//                                              cv2.imread's RGB (3) or
//                                              IMREAD_GRAYSCALE (1) pixels
//   vc_decode_jpeg_ycc(path, w, h, out)        the codec's full-resolution
//                                              YCbCr, (h, w, 3) interleaved
//   vc_decode_jpeg_planes(path, dims, y, cb, cr, capacity)
//                                              the stored planes (dims: w, h,
//                                              cw, ch; cw = ch = 0 for gray);
//                                              3 when a plane exceeds
//                                              capacity bytes
//   vc_upsample_ycc(y, cb, cr, w, h, cw, ch, out)
//                                              libjpeg's fancy upsampling of
//                                              stored planes -> (h, w, 3)
//   vc_ycc_to_rgb(y, cb, cr, n, out)           libjpeg's YCbCr -> RGB
//   vc_encode_jpeg(path, pixels, w, h, channels, quality, chroma)
// I420 output is (th * 3 / 2) * tw bytes per image, planes Y[th*tw],
// U[(th/2)*(tw/2)], V[...]; th and tw must be even.

#include <algorithm>
#include <atomic>
#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include "jpeg_backend.h"

extern "C" {
// The stable zlib API subset used here (libz.so.1), declared so that no
// zlib.h is needed.
int uncompress(unsigned char* dest, unsigned long* dest_len,
               const unsigned char* source, unsigned long source_len);
unsigned long crc32(unsigned long crc, const unsigned char* buf,
                    unsigned int len);
}

namespace vc {
namespace {

// ------------------------------------------------------------------ resize
// Separable bilinear resample of one plane (src sw x sh -> dst tw x th),
// pixel-centre aligned (the cv2 / jax.image half-pixel convention); the
// JAX decoder's arithmetic, step for step.
void resample_plane(const uint8_t* src, int sw, int sh, int sstride,
                    uint8_t* dst, int tw, int th, int dstride) {
  if (sw == tw && sh == th) {
    for (int y = 0; y < th; ++y)
      std::memcpy(dst + y * dstride, src + y * sstride, tw);
    return;
  }
  const float sx = static_cast<float>(sw) / tw;
  const float sy = static_cast<float>(sh) / th;
  std::vector<int> x0(tw), x1(tw);
  std::vector<float> fx(tw);
  for (int x = 0; x < tw; ++x) {
    float cx = (x + 0.5f) * sx - 0.5f;
    if (cx < 0) cx = 0;
    int ix = static_cast<int>(cx);
    if (ix > sw - 2) ix = sw - 2;
    if (ix < 0) ix = 0;
    x0[x] = ix;
    x1[x] = (sw > 1) ? ix + 1 : ix;
    fx[x] = cx - ix;
  }
  for (int y = 0; y < th; ++y) {
    float cy = (y + 0.5f) * sy - 0.5f;
    if (cy < 0) cy = 0;
    int iy = static_cast<int>(cy);
    if (iy > sh - 2) iy = sh - 2;
    if (iy < 0) iy = 0;
    float fy = cy - iy;
    const uint8_t* r0 = src + iy * sstride;
    const uint8_t* r1 = src + ((sh > 1) ? iy + 1 : iy) * sstride;
    uint8_t* out = dst + y * dstride;
    for (int x = 0; x < tw; ++x) {
      float a = r0[x0[x]] + (r0[x1[x]] - r0[x0[x]]) * fx[x];
      float b = r1[x0[x]] + (r1[x1[x]] - r1[x0[x]]) * fx[x];
      float v = a + (b - a) * fy;
      out[x] = static_cast<uint8_t>(v + 0.5f);
    }
  }
}

// ----------------------------------------------------------------- png path
const uint8_t kPngSignature[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

bool read_file(const char* path, std::vector<uint8_t>* data) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  bool ok = n > 0;
  if (ok) {
    data->resize(static_cast<size_t>(n));
    ok = std::fread(data->data(), 1, data->size(), f) == data->size();
  }
  std::fclose(f);
  return ok;
}

struct PngHeader {
  uint32_t w = 0, h = 0;
  int depth = 0, color = 0, interlace = 0;
};

// Walks the chunks of a PNG in memory.  Critical chunks (upper-case first
// letter) must pass their CRC, as libpng requires.  Stops after IHDR when
// header_only.
bool parse_png(const std::vector<uint8_t>& data, PngHeader* hdr,
               std::vector<uint8_t>* palette, std::vector<uint8_t>* idat,
               bool header_only) {
  if (data.size() < 8 || std::memcmp(data.data(), kPngSignature, 8)) return false;
  size_t pos = 8;
  bool have_header = false;
  while (pos + 12 <= data.size()) {
    const uint32_t len = be32(&data[pos]);
    if (len > data.size() - pos - 12) return false;
    const uint8_t* type = &data[pos + 4];
    const uint8_t* body = &data[pos + 8];
    const bool critical = (type[0] & 0x20) == 0;
    if (critical && crc32(crc32(0, nullptr, 0), type, len + 4) !=
                        be32(body + len))
      return false;
    if (!have_header) {
      if (std::memcmp(type, "IHDR", 4) || len != 13) return false;
      hdr->w = be32(body);
      hdr->h = be32(body + 4);
      hdr->depth = body[8];
      hdr->color = body[9];
      hdr->interlace = body[12];
      if (hdr->w == 0 || hdr->h == 0 || hdr->w > 0x7fffffffu ||
          hdr->h > 0x7fffffffu || body[10] != 0 || body[11] != 0 ||
          hdr->interlace > 1)
        return false;
      const int d = hdr->depth;
      const bool valid =
          (hdr->color == 0 && (d == 1 || d == 2 || d == 4 || d == 8 || d == 16)) ||
          (hdr->color == 3 && (d == 1 || d == 2 || d == 4 || d == 8)) ||
          ((hdr->color == 2 || hdr->color == 4 || hdr->color == 6) &&
           (d == 8 || d == 16));
      if (!valid) return false;
      have_header = true;
      if (header_only) return true;
    } else if (!std::memcmp(type, "PLTE", 4)) {
      if (len % 3 || len > 768) return false;
      std::memcpy(palette->data(), body, len);
    } else if (!std::memcmp(type, "IDAT", 4)) {
      idat->insert(idat->end(), body, body + len);
    } else if (!std::memcmp(type, "IEND", 4)) {
      return !idat->empty();
    }
    pos += 12 + len;
  }
  return false;  // no IEND
}

uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = p > a ? p - a : a - p;
  const int pb = p > b ? p - b : b - p;
  const int pc = p > c ? p - c : c - p;
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  return static_cast<uint8_t>(pb <= pc ? b : c);
}

// Decodes a PNG into 8-bit gray (nc = 1) or RGB (nc = 3) pixels.
bool decode_png_pixels(const char* path, std::vector<uint8_t>* pixels,
                       int* w_out, int* h_out, int* nc_out) {
  std::vector<uint8_t> data, idat;
  std::vector<uint8_t> palette(768, 0);  // libpng pads palettes to 256
  PngHeader hdr;
  if (!read_file(path, &data) || !parse_png(data, &hdr, &palette, &idat, false))
    return false;
  if (hdr.interlace) return false;
  static const int kSamples[7] = {1, 0, 3, 1, 2, 0, 4};
  const int samples = kSamples[hdr.color];
  const size_t w = hdr.w, h = hdr.h;
  const size_t bits = w * samples * hdr.depth;
  const size_t rowbytes = (bits + 7) / 8;
  const size_t bpp = std::max<size_t>(1, samples * hdr.depth / 8);
  unsigned long raw_len = static_cast<unsigned long>((rowbytes + 1) * h);
  std::vector<uint8_t> raw(raw_len);
  if (uncompress(raw.data(), &raw_len, idat.data(), idat.size()) != 0 ||
      raw_len != raw.size())
    return false;
  const int nc = (hdr.color == 2 || hdr.color == 3 || hdr.color == 6) ? 3 : 1;
  pixels->resize(w * h * nc);
  std::vector<uint8_t> prev(rowbytes, 0), cur(rowbytes);
  const int scale = hdr.depth < 8 && hdr.color == 0 ? 255 / ((1 << hdr.depth) - 1) : 1;
  for (size_t y = 0; y < h; ++y) {
    const uint8_t* line = &raw[y * (rowbytes + 1)];
    const int filter = line[0];
    if (filter > 4) return false;
    for (size_t i = 0; i < rowbytes; ++i) {
      const int a = i >= bpp ? cur[i - bpp] : 0;
      const int b = prev[i];
      const int c = i >= bpp ? prev[i - bpp] : 0;
      int pred = 0;
      switch (filter) {
        case 1: pred = a; break;
        case 2: pred = b; break;
        case 3: pred = (a + b) >> 1; break;
        case 4: pred = paeth(a, b, c); break;
      }
      cur[i] = static_cast<uint8_t>(line[1 + i] + pred);
    }
    uint8_t* out = pixels->data() + y * w * nc;
    for (size_t x = 0; x < w; ++x) {
      if (hdr.depth < 8) {  // gray or palette index, packed high bits first
        const size_t bit = x * hdr.depth;
        const int v = (cur[bit / 8] >> (8 - hdr.depth - bit % 8)) &
                      ((1 << hdr.depth) - 1);
        if (hdr.color == 3) {
          std::memcpy(out + 3 * x, &palette[3 * v], 3);
        } else {
          out[x] = static_cast<uint8_t>(v * scale);
        }
        continue;
      }
      const int step = hdr.depth / 8;  // 16-bit samples keep the high byte
      const uint8_t* px = &cur[x * samples * step];
      if (hdr.color == 3) {
        std::memcpy(out + 3 * x, &palette[3 * px[0]], 3);
      } else {
        for (int c = 0; c < nc; ++c) out[x * nc + c] = px[c * step];
      }
    }
    std::swap(prev, cur);
  }
  *w_out = static_cast<int>(w);
  *h_out = static_cast<int>(h);
  *nc_out = nc;
  return true;
}

bool decode_png(const char* path, Planes* out) {
  std::vector<uint8_t> px;
  int w, h, nc;
  if (!decode_png_pixels(path, &px, &w, &h, &nc)) return false;
  const size_t n = static_cast<size_t>(w) * h;
  out->w = out->cw = w;
  out->h = out->ch = h;
  out->cb.assign(n, 128);
  out->cr.assign(n, 128);
  if (nc == 1) {
    out->y = std::move(px);
    return true;
  }
  out->y.resize(n);
  for (size_t i = 0; i < n; ++i) {
    // JFIF full-range BT.601, as the JPEG path and the device inverse
    // (ops/transfer.py unpack_yuv420(full_range=True)) read it.
    float r = px[3 * i], g = px[3 * i + 1], b = px[3 * i + 2];
    float Y = 0.299f * r + 0.587f * g + 0.114f * b;
    float Cb = -0.168736f * r - 0.331264f * g + 0.5f * b + 128.0f;
    float Cr = 0.5f * r - 0.418688f * g - 0.081312f * b + 128.0f;
    out->y[i] = static_cast<uint8_t>(Y < 0 ? 0 : (Y > 255 ? 255 : Y + 0.5f));
    out->cb[i] =
        static_cast<uint8_t>(Cb < 0 ? 0 : (Cb > 255 ? 255 : Cb + 0.5f));
    out->cr[i] =
        static_cast<uint8_t>(Cr < 0 ? 0 : (Cr > 255 ? 255 : Cr + 0.5f));
  }
  return true;
}

bool probe_png(const char* path, int* w, int* h) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::vector<uint8_t> head(33);  // signature + IHDR chunk
  const bool read = std::fread(head.data(), 1, head.size(), f) == head.size();
  std::fclose(f);
  PngHeader hdr;
  if (!read || !parse_png(head, &hdr, nullptr, nullptr, true)) return false;
  *w = static_cast<int>(hdr.w);
  *h = static_cast<int>(hdr.h);
  return true;
}

bool is_png(const char* path) {
  const char* dot = std::strrchr(path, '.');
  if (!dot) return false;
  std::string ext(dot + 1);
  for (auto& c : ext) c = static_cast<char>(std::tolower(c));
  return ext == "png";
}

int decode_one(const char* path, int tw, int th, uint8_t* out) {
  if (tw <= 0 || th <= 0 || (tw & 1) || (th & 1)) return 2;
  Planes p;
  bool ok = is_png(path) ? decode_png(path, &p) : jpeg_decode_ycc(path, &p);
  if (!ok) return 1;
  const int cw = tw / 2, ch = th / 2;
  uint8_t* yp = out;
  uint8_t* up = out + static_cast<size_t>(tw) * th;
  uint8_t* vp = up + static_cast<size_t>(cw) * ch;
  resample_plane(p.y.data(), p.w, p.h, p.w, yp, tw, th, tw);
  // Chroma: the codec's planes -> the half-resolution target in ONE
  // resample (the 4:2:0 subsample and the resize fused).
  resample_plane(p.cb.data(), p.cw, p.ch, p.cw, up, cw, ch, cw);
  resample_plane(p.cr.data(), p.cw, p.ch, p.cw, vp, cw, ch, cw);
  return 0;
}

}  // namespace
}  // namespace vc

extern "C" {

int vc_probe(const char* path, int* w, int* h) {
  using vc::jpeg_probe;
  using vc::probe_png;
  const bool png = vc::is_png(path);
  if (png ? probe_png(path, w, h) : jpeg_probe(path, w, h)) return 0;
  // Wrong-extension fallback: try the other format.
  if (png ? jpeg_probe(path, w, h) : probe_png(path, w, h)) return 0;
  return 1;
}

int vc_decode_i420(const char* path, int tw, int th, uint8_t* out) {
  return vc::decode_one(path, tw, th, out);
}

// out: n contiguous images, each (th*3/2)*tw bytes.  status: n ints.
// Returns the number of images that failed.
int vc_decode_batch_i420(const char** paths, int n, int tw, int th,
                         uint8_t* out, int* status, int n_threads,
                         int device) {
  if (n <= 0) return 0;
  const size_t per = static_cast<size_t>(tw) * th * 3 / 2;
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n) n_threads = n;
  std::atomic<int> next{0};
  std::atomic<int> bad{0};
  auto worker = [&]() {
    // A worker is a new thread, so setting its device leaves the caller's.
    const bool on_device = device < 0 || vc::jpeg_use_device(device);
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      status[i] = on_device ? vc::decode_one(paths[i], tw, th, out + per * i)
                            : 1;
      if (status[i]) bad.fetch_add(1);
    }
  };
  std::vector<std::thread> ts;
  ts.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) ts.emplace_back(worker);
  for (auto& t : ts) t.join();
  return bad.load();
}

int vc_decode_jpeg_pixels(const char* path, int w, int h, int channels,
                          uint8_t* out) {
  return vc::jpeg_decode_pixels(path, w, h, channels, out) ? 0 : 1;
}

int vc_decode_jpeg_ycc(const char* path, int w, int h, uint8_t* out) {
  vc::Planes p;
  if (!vc::jpeg_decode_ycc(path, &p)) return 1;
  if (p.w != w || p.h != h) return 2;
  const size_t n = static_cast<size_t>(w) * h;
  for (size_t i = 0; i < n; ++i) {
    out[3 * i] = p.y[i];
    out[3 * i + 1] = p.cb[i];
    out[3 * i + 2] = p.cr[i];
  }
  return 0;
}

int vc_decode_jpeg_planes(const char* path, int* dims, uint8_t* y,
                          uint8_t* cb, uint8_t* cr, long long capacity) {
  vc::Planes p;
  if (!vc::jpeg_decode_planes(path, &p)) return 1;
  dims[0] = p.w;
  dims[1] = p.h;
  dims[2] = p.cw;
  dims[3] = p.ch;
  const long long n = static_cast<long long>(p.w) * p.h;
  const long long nc = static_cast<long long>(p.cw) * p.ch;
  if (n > capacity || nc > capacity) return 3;
  std::memcpy(y, p.y.data(), n);
  if (nc) {
    std::memcpy(cb, p.cb.data(), nc);
    std::memcpy(cr, p.cr.data(), nc);
  }
  return 0;
}

int vc_upsample_ycc(const uint8_t* y, const uint8_t* cb, const uint8_t* cr,
                    int w, int h, int cw, int ch, uint8_t* out) {
  vc::Planes in, full;
  const size_t n = static_cast<size_t>(w) * h;
  const size_t nc = static_cast<size_t>(cw) * ch;
  in.w = w;
  in.h = h;
  in.cw = cw;
  in.ch = ch;
  in.y.assign(y, y + n);
  if (nc) {
    in.cb.assign(cb, cb + nc);
    in.cr.assign(cr, cr + nc);
  }
  if (!vc::upsample_planes(in, &full)) return 1;
  for (size_t i = 0; i < n; ++i) {
    out[3 * i] = full.y[i];
    out[3 * i + 1] = full.cb[i];
    out[3 * i + 2] = full.cr[i];
  }
  return 0;
}

int vc_ycc_to_rgb(const uint8_t* y, const uint8_t* cb, const uint8_t* cr,
                  long long n, uint8_t* out) {
  vc::ycc_to_rgb(y, cb, cr, static_cast<size_t>(n), out);
  return 0;
}

int vc_encode_jpeg(const char* path, const uint8_t* pixels, int w, int h,
                   int channels, int quality, int chroma) {
  return vc::jpeg_encode(path, pixels, w, h, channels, quality, chroma) ? 0 : 1;
}

}  // extern "C"
