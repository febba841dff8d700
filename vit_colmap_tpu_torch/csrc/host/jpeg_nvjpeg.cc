// The JPEG codec on nvJPEG (CUDA toolkit), for machines without libjpeg.
//
// The codec runs on the calling thread's current CUDA device (device 0 in
// a new thread; image_io.cc's batch decode sets its workers' device with
// jpeg_use_device) and its results come back as host planes.  Every colour
// decode asks for NVJPEG_OUTPUT_YUV, the planes as the file stores them
// (chroma at its own resolution, half width and height for 4:2:0), and
// finishes on the host with libjpeg's own steps (jpeg_color.cc): fancy
// chroma upsampling for the YCbCr route, then libjpeg's fixed-point
// YCbCr -> RGB for the RGB route.  Only the IDCT is nvJPEG's, so bytes
// differ from libjpeg's by its rounding alone; chip_smoke.py and
// tests/test_torch_gpu.py hold this route to libjpeg's bytes of the JPEGs
// under tests/data/jpeg/.
//
// Each decode borrows a slot (a decoder state, a non-blocking stream and a
// device buffer that only grows) of the current device from a pool that
// lives as long as the process: freeing device memory with cudaFree would wait for the whole
// device, and the extractor decodes while the card runs earlier batches.

#include <algorithm>
#include <cstdio>
#include <mutex>
#include <vector>

#include <cuda_runtime_api.h>
#include <nvjpeg.h>

#include "jpeg_backend.h"

namespace vc {
namespace {

std::once_flag g_once;
nvjpegHandle_t g_handle = nullptr;

nvjpegHandle_t handle() {
  std::call_once(g_once, [] {
    if (nvjpegCreateSimple(&g_handle) != NVJPEG_STATUS_SUCCESS)
      g_handle = nullptr;
  });
  return g_handle;
}

struct Slot {
  int device = 0;
  nvjpegJpegState_t state = nullptr;
  cudaStream_t stream = nullptr;
  uint8_t* buf = nullptr;
  size_t cap = 0;
};

std::mutex g_pool_mu;
std::vector<Slot*> g_pool;

Slot* acquire() {
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess) return nullptr;
  {
    std::lock_guard<std::mutex> lock(g_pool_mu);
    for (size_t i = 0; i < g_pool.size(); ++i) {
      if (g_pool[i]->device != device) continue;
      Slot* s = g_pool[i];
      g_pool.erase(g_pool.begin() + i);
      return s;
    }
  }
  Slot* s = new Slot();
  s->device = device;
  if (handle() &&
      nvjpegJpegStateCreate(g_handle, &s->state) == NVJPEG_STATUS_SUCCESS &&
      cudaStreamCreateWithFlags(&s->stream, cudaStreamNonBlocking) ==
          cudaSuccess)
    return s;
  if (s->state) nvjpegJpegStateDestroy(s->state);
  delete s;
  return nullptr;
}

void release(Slot* s) {
  std::lock_guard<std::mutex> lock(g_pool_mu);
  g_pool.push_back(s);
}

bool reserve(Slot* s, size_t bytes) {
  if (s->cap >= bytes) return true;
  if (s->buf) cudaFreeAsync(s->buf, s->stream);
  s->buf = nullptr;
  s->cap = 0;
  if (cudaMallocAsync(reinterpret_cast<void**>(&s->buf), bytes, s->stream) !=
      cudaSuccess)
    return false;
  s->cap = bytes;
  return true;
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

struct Info {
  int components = 0;
  nvjpegChromaSubsampling_t subsampling = NVJPEG_CSS_UNKNOWN;
  int widths[NVJPEG_MAX_COMPONENT] = {};
  int heights[NVJPEG_MAX_COMPONENT] = {};
  bool gray() const {
    return components == 1 || subsampling == NVJPEG_CSS_GRAY;
  }
};

bool image_info(const std::vector<uint8_t>& data, Info* info) {
  return handle() &&
         nvjpegGetImageInfo(g_handle, data.data(), data.size(),
                            &info->components, &info->subsampling,
                            info->widths, info->heights) ==
             NVJPEG_STATUS_SUCCESS &&
         info->widths[0] > 0 && info->heights[0] > 0 &&
         (info->components == 1 || info->components == 3);
}

// Decodes `data` in `fmt` into planes of the given sizes (pitch = width)
// and copies them, concatenated, into `host`.
bool decode(const std::vector<uint8_t>& data, nvjpegOutputFormat_t fmt,
            const std::vector<int>& widths, const std::vector<int>& heights,
            std::vector<uint8_t>* host) {
  size_t total = 0;
  for (size_t c = 0; c < widths.size(); ++c)
    total += static_cast<size_t>(widths[c]) * heights[c];
  Slot* s = acquire();
  if (!s) return false;
  bool ok = reserve(s, total);
  if (ok) {
    nvjpegImage_t img = {};
    size_t off = 0;
    for (size_t c = 0; c < widths.size(); ++c) {
      img.channel[c] = s->buf + off;
      img.pitch[c] = static_cast<size_t>(widths[c]);
      off += static_cast<size_t>(widths[c]) * heights[c];
    }
    host->resize(total);
    ok = nvjpegDecode(g_handle, s->state, data.data(), data.size(), fmt, &img,
                      s->stream) == NVJPEG_STATUS_SUCCESS &&
         cudaMemcpyAsync(host->data(), s->buf, total, cudaMemcpyDeviceToHost,
                         s->stream) == cudaSuccess &&
         cudaStreamSynchronize(s->stream) == cudaSuccess;
  }
  release(s);
  return ok;
}

// The stored planes of a file read into `data` (see jpeg_decode_planes).
bool decode_planes(const std::vector<uint8_t>& data, const Info& info,
                   Planes* out) {
  std::vector<uint8_t> host;
  const int w = info.widths[0], h = info.heights[0];
  const size_t n = static_cast<size_t>(w) * h;
  out->w = w;
  out->h = h;
  if (info.gray()) {
    if (!decode(data, NVJPEG_OUTPUT_Y, {w}, {h}, &host)) return false;
    out->cw = out->ch = 0;
    out->y.assign(host.begin(), host.end());
    out->cb.clear();
    out->cr.clear();
    return true;
  }
  const int cw = info.widths[1], ch = info.heights[1];
  if (cw <= 0 || ch <= 0 || info.widths[2] != cw || info.heights[2] != ch)
    return false;
  if (!decode(data, NVJPEG_OUTPUT_YUV, {w, cw, cw}, {h, ch, ch}, &host))
    return false;
  const size_t nc = static_cast<size_t>(cw) * ch;
  out->cw = cw;
  out->ch = ch;
  out->y.assign(host.begin(), host.begin() + n);
  out->cb.assign(host.begin() + n, host.begin() + n + nc);
  out->cr.assign(host.begin() + n + nc, host.end());
  return true;
}

}  // namespace

bool jpeg_use_device(int device) {
  return cudaSetDevice(device) == cudaSuccess;
}

bool jpeg_probe(const char* path, int* w, int* h) {
  std::vector<uint8_t> data;
  Info info;
  if (!read_file(path, &data) || !image_info(data, &info)) return false;
  *w = info.widths[0];
  *h = info.heights[0];
  return true;
}

bool jpeg_decode_planes(const char* path, Planes* out) {
  std::vector<uint8_t> data;
  Info info;
  return read_file(path, &data) && image_info(data, &info) &&
         decode_planes(data, info, out);
}

bool jpeg_decode_ycc(const char* path, Planes* out) {
  Planes stored;
  return jpeg_decode_planes(path, &stored) && upsample_planes(stored, out);
}

bool jpeg_decode_pixels(const char* path, int w, int h, int channels,
                        uint8_t* out) {
  if (channels != 1 && channels != 3) return false;
  std::vector<uint8_t> data, host;
  Info info;
  if (!read_file(path, &data) || !image_info(data, &info)) return false;
  if (info.widths[0] != w || info.heights[0] != h) return false;
  const size_t n = static_cast<size_t>(w) * h;
  // Gray files and gray output both take the Y plane.
  if (channels == 1 || info.gray()) {
    if (!decode(data, NVJPEG_OUTPUT_Y, {w}, {h}, &host)) return false;
    for (size_t i = 0; i < n; ++i)
      for (int c = 0; c < channels; ++c) out[i * channels + c] = host[i];
    return true;
  }
  Planes stored, full;
  if (!decode_planes(data, info, &stored) || !upsample_planes(stored, &full))
    return false;
  ycc_to_rgb(full.y.data(), full.cb.data(), full.cr.data(), n, out);
  return true;
}

bool jpeg_encode(const char* path, const uint8_t* pixels, int w, int h,
                 int channels, int quality, int chroma) {
  if ((channels != 1 && channels != 3) || w <= 0 || h <= 0 || !handle())
    return false;
  const size_t bytes = static_cast<size_t>(w) * h * channels;
  nvjpegChromaSubsampling_t css = NVJPEG_CSS_GRAY;
  if (channels == 3) {
    switch (chroma) {
      case 420: css = NVJPEG_CSS_420; break;
      case 422: css = NVJPEG_CSS_422; break;
      case 440: css = NVJPEG_CSS_440; break;
      case 444: css = NVJPEG_CSS_444; break;
      default: return false;
    }
  }
  Slot* s = acquire();
  if (!s) return false;
  nvjpegEncoderState_t state = nullptr;
  nvjpegEncoderParams_t params = nullptr;
  std::vector<uint8_t> stream_bytes;
  size_t length = 0;
  bool ok = reserve(s, bytes) &&
            cudaMemcpyAsync(s->buf, pixels, bytes, cudaMemcpyHostToDevice,
                            s->stream) == cudaSuccess &&
            nvjpegEncoderStateCreate(g_handle, &state, s->stream) ==
                NVJPEG_STATUS_SUCCESS &&
            nvjpegEncoderParamsCreate(g_handle, &params, s->stream) ==
                NVJPEG_STATUS_SUCCESS &&
            nvjpegEncoderParamsSetQuality(params, quality, s->stream) ==
                NVJPEG_STATUS_SUCCESS &&
            nvjpegEncoderParamsSetSamplingFactors(params, css, s->stream) ==
                NVJPEG_STATUS_SUCCESS;
  if (ok) {
    nvjpegImage_t img = {};
    img.channel[0] = s->buf;
    img.pitch[0] = static_cast<size_t>(w) * channels;
    ok = (channels == 3
              ? nvjpegEncodeImage(g_handle, state, params, &img,
                                  NVJPEG_INPUT_RGBI, w, h, s->stream)
              : nvjpegEncodeYUV(g_handle, state, params, &img, css, w, h,
                                s->stream)) == NVJPEG_STATUS_SUCCESS &&
         nvjpegEncodeRetrieveBitstream(g_handle, state, nullptr, &length,
                                       s->stream) == NVJPEG_STATUS_SUCCESS &&
         cudaStreamSynchronize(s->stream) == cudaSuccess;
  }
  if (ok) {
    stream_bytes.resize(length);
    ok = nvjpegEncodeRetrieveBitstream(g_handle, state, stream_bytes.data(),
                                       &length, s->stream) ==
             NVJPEG_STATUS_SUCCESS &&
         cudaStreamSynchronize(s->stream) == cudaSuccess;
  }
  if (params) nvjpegEncoderParamsDestroy(params);
  if (state) nvjpegEncoderStateDestroy(state);
  release(s);
  if (!ok) return false;
  FILE* f = std::fopen(path, "wb");
  if (!f) return false;
  ok = std::fwrite(stream_bytes.data(), 1, length, f) == length;
  return std::fclose(f) == 0 && ok;
}

}  // namespace vc
