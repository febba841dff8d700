// The JPEG codec on libjpeg.so.62 (the ABI declared in jpeg62.h).
//
// jpeg_decode_ycc is the JAX package's decoder (native/image_io.cc):
// out_color_space JCS_YCbCr (JCS_GRAYSCALE for gray files) with libjpeg's
// defaults (ISLOW IDCT, fancy upsampling), so chroma comes back at full
// resolution.  jpeg_decode_pixels is what cv2.imread gives: JCS_RGB for
// colour, JCS_GRAYSCALE (the Y plane) for gray; a gray file read as RGB
// is its Y replicated.  jpeg_decode_planes reads the stored planes raw
// (raw_data_out, jpeg_read_raw_data), the input of jpeg_color.cc's steps.

#include <csetjmp>
#include <cstring>

#include "jpeg62.h"
#include "jpeg_backend.h"

namespace vc {
namespace {

struct ErrorManager {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void error_exit(j_common_ptr cinfo) {
  longjmp(reinterpret_cast<ErrorManager*>(cinfo->err)->jump, 1);
}

// Opens `path`, reads the JPEG header and runs body(cinfo, row) under the
// error manager's jump; `row` is scratch that outlives a jump (a decode
// error longjmps out of body, past its locals).
template <typename Body>
bool with_decompress(const char* path, Body body) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::vector<uint8_t> row;
  jpeg_decompress_struct cinfo;
  ErrorManager jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return false;
  }
  jpeg_CreateDecompress(&cinfo, JPEG_LIB_VERSION, sizeof(cinfo));
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, 1);
  bool ok = body(&cinfo, row);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(f);
  return ok;
}

}  // namespace

bool jpeg_use_device(int) { return true; }

bool jpeg_probe(const char* path, int* w, int* h) {
  return with_decompress(path, [&](j_decompress_ptr cinfo,
                                   std::vector<uint8_t>&) {
    *w = static_cast<int>(cinfo->image_width);
    *h = static_cast<int>(cinfo->image_height);
    return true;
  });
}

bool jpeg_decode_ycc(const char* path, Planes* out) {
  return with_decompress(path, [&](j_decompress_ptr cinfo,
                                   std::vector<uint8_t>& row) {
    const bool gray = cinfo->jpeg_color_space == JCS_GRAYSCALE;
    cinfo->out_color_space = gray ? JCS_GRAYSCALE : JCS_YCbCr;
    jpeg_start_decompress(cinfo);
    const int w = static_cast<int>(cinfo->output_width);
    const int h = static_cast<int>(cinfo->output_height);
    const int nc = cinfo->output_components;
    const size_t n = static_cast<size_t>(w) * h;
    out->w = out->cw = w;
    out->h = out->ch = h;
    out->y.resize(n);
    out->cb.assign(n, 128);
    out->cr.assign(n, 128);
    row.resize(static_cast<size_t>(w) * nc);
    JSAMPROW rp = row.data();
    while (cinfo->output_scanline < cinfo->output_height) {
      const size_t off = static_cast<size_t>(cinfo->output_scanline) * w;
      jpeg_read_scanlines(cinfo, &rp, 1);
      if (gray) {
        std::memcpy(out->y.data() + off, rp, w);
        continue;
      }
      for (int x = 0; x < w; ++x) {
        out->y[off + x] = rp[3 * x];
        out->cb[off + x] = rp[3 * x + 1];
        out->cr[off + x] = rp[3 * x + 2];
      }
    }
    jpeg_finish_decompress(cinfo);
    return true;
  });
}

bool jpeg_decode_planes(const char* path, Planes* out) {
  return with_decompress(path, [&](j_decompress_ptr cinfo,
                                   std::vector<uint8_t>& row) {
    const bool gray = cinfo->jpeg_color_space == JCS_GRAYSCALE;
    const int nc = gray ? 1 : 3;
    if (cinfo->num_components != nc ||
        (!gray && cinfo->jpeg_color_space != JCS_YCbCr))
      return false;
    cinfo->raw_data_out = 1;
    cinfo->out_color_space = cinfo->jpeg_color_space;
    jpeg_start_decompress(cinfo);
    const auto* comp = static_cast<jpeg_component_info*>(cinfo->comp_info);
    const int max_v = cinfo->max_v_samp_factor;
    if (comp[0].h_samp_factor != cinfo->max_h_samp_factor ||
        comp[0].v_samp_factor != max_v || max_v > 4)
      return false;  // luma must carry the full resolution
    // One iMCU row a call: v_samp x 8 rows of width_in_blocks x 8 samples a
    // component, kept in `row` (it outlives a decode error's jump).
    size_t offs[3], widths[3];
    size_t total = 0;
    for (int c = 0; c < nc; ++c) {
      widths[c] = static_cast<size_t>(comp[c].width_in_blocks) * DCTSIZE;
      offs[c] = total;
      total += widths[c] * comp[c].v_samp_factor * DCTSIZE;
    }
    row.resize(total);
    JSAMPROW rows[3][4 * DCTSIZE];
    JSAMPARRAY arrays[3];
    for (int c = 0; c < nc; ++c) {
      for (int r = 0; r < comp[c].v_samp_factor * DCTSIZE; ++r)
        rows[c][r] = row.data() + offs[c] + r * widths[c];
      arrays[c] = rows[c];
    }
    std::vector<uint8_t>* planes[3] = {&out->y, &out->cb, &out->cr};
    int pw[3], ph[3];
    for (int c = 0; c < nc; ++c) {
      pw[c] = static_cast<int>(comp[c].downsampled_width);
      ph[c] = static_cast<int>(comp[c].downsampled_height);
      planes[c]->resize(static_cast<size_t>(pw[c]) * ph[c]);
    }
    while (cinfo->output_scanline < cinfo->output_height) {
      const int imcu = static_cast<int>(cinfo->output_scanline) / (max_v * DCTSIZE);
      jpeg_read_raw_data(cinfo, arrays, max_v * DCTSIZE);
      for (int c = 0; c < nc; ++c) {
        const int n_rows = comp[c].v_samp_factor * DCTSIZE;
        for (int r = 0; r < n_rows; ++r) {
          const int y = imcu * n_rows + r;
          if (y >= ph[c]) break;
          std::memcpy(planes[c]->data() + static_cast<size_t>(y) * pw[c],
                      rows[c][r], pw[c]);
        }
      }
    }
    jpeg_finish_decompress(cinfo);
    out->w = pw[0];
    out->h = ph[0];
    out->cw = gray ? 0 : pw[1];
    out->ch = gray ? 0 : ph[1];
    if (gray) {
      out->cb.clear();
      out->cr.clear();
    }
    return gray || (pw[2] == pw[1] && ph[2] == ph[1]);
  });
}

bool jpeg_decode_pixels(const char* path, int w, int h, int channels,
                        uint8_t* out) {
  if (channels != 1 && channels != 3) return false;
  return with_decompress(path, [&](j_decompress_ptr cinfo,
                                   std::vector<uint8_t>& row) {
    const bool gray_file = cinfo->jpeg_color_space == JCS_GRAYSCALE;
    cinfo->out_color_space =
        (channels == 1 || gray_file) ? JCS_GRAYSCALE : JCS_RGB;
    jpeg_start_decompress(cinfo);
    if (static_cast<int>(cinfo->output_width) != w ||
        static_cast<int>(cinfo->output_height) != h) {
      return false;  // jpeg_destroy_decompress aborts the decode
    }
    const int nc = cinfo->output_components;
    row.resize(static_cast<size_t>(w) * nc);
    JSAMPROW rp = row.data();
    while (cinfo->output_scanline < cinfo->output_height) {
      uint8_t* dst = out + static_cast<size_t>(cinfo->output_scanline) * w *
                               channels;
      jpeg_read_scanlines(cinfo, &rp, 1);
      if (nc == channels) {
        std::memcpy(dst, rp, static_cast<size_t>(w) * nc);
      } else {  // a gray file read as RGB
        for (int x = 0; x < w; ++x)
          dst[3 * x] = dst[3 * x + 1] = dst[3 * x + 2] = rp[x];
      }
    }
    jpeg_finish_decompress(cinfo);
    return true;
  });
}

bool jpeg_encode(const char* path, const uint8_t* pixels, int w, int h,
                 int channels, int quality, int chroma) {
  if ((channels != 1 && channels != 3) || w <= 0 || h <= 0) return false;
  // Luma's sampling factors over chroma's 1 x 1.
  int hs, vs;
  switch (chroma) {
    case 420: hs = 2; vs = 2; break;
    case 422: hs = 2; vs = 1; break;
    case 440: hs = 1; vs = 2; break;
    case 444: hs = 1; vs = 1; break;
    default: return false;
  }
  FILE* f = std::fopen(path, "wb");
  if (!f) return false;
  jpeg_compress_struct cinfo;
  ErrorManager jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_compress(&cinfo);
    std::fclose(f);
    return false;
  }
  jpeg_CreateCompress(&cinfo, JPEG_LIB_VERSION, sizeof(cinfo));
  jpeg_stdio_dest(&cinfo, f);
  cinfo.image_width = static_cast<JDIMENSION>(w);
  cinfo.image_height = static_cast<JDIMENSION>(h);
  cinfo.input_components = channels;
  cinfo.in_color_space = channels == 3 ? JCS_RGB : JCS_GRAYSCALE;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality, 1);
  if (channels == 3) {
    auto* comp = static_cast<jpeg_component_info*>(cinfo.comp_info);
    comp[0].h_samp_factor = hs;
    comp[0].v_samp_factor = vs;
  }
  jpeg_start_compress(&cinfo, 1);
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW rp = const_cast<uint8_t*>(pixels) +
                  static_cast<size_t>(cinfo.next_scanline) * w * channels;
    jpeg_write_scanlines(&cinfo, &rp, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  return std::fclose(f) == 0;
}

}  // namespace vc
