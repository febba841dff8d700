// The JPEG codec behind image_io.cc.  One of two sources implements it,
// chosen by the build (vit_colmap_tpu_torch/kernels/host_build.py):
//   jpeg_libjpeg.cc  libjpeg.so.62 (libjpeg-turbo), the JAX package's route;
//   jpeg_nvjpeg.cc   nvJPEG from the CUDA toolkit, where no libjpeg exists,
//                    finishing its planes with jpeg_color.cc's libjpeg steps.
// Every function returns false on failure and never throws.

#ifndef VC_JPEG_BACKEND_H_
#define VC_JPEG_BACKEND_H_

#include <cstddef>
#include <cstdint>
#include <vector>

namespace vc {

// Full-range JFIF YCbCr planes of a decoded image.  Luma is w x h; chroma
// is cw x ch (cw == w and ch == h when the codec upsamples it, and for
// gray images, whose chroma is neutral 128).
struct Planes {
  std::vector<uint8_t> y, cb, cr;
  int w = 0, h = 0, cw = 0, ch = 0;
};

// Runs this thread's later codec calls on CUDA device `device` (nvJPEG;
// libjpeg ignores it).  Without it, nvJPEG uses the thread's current
// device, which is device 0 in a new thread.
bool jpeg_use_device(int device);

bool jpeg_probe(const char* path, int* w, int* h);
// The YCbCr the JPEG stores, without an RGB pass, chroma upsampled to full
// resolution as libjpeg does it; gray JPEG gets neutral chroma.
bool jpeg_decode_ycc(const char* path, Planes* out);
// The planes as the file stores them, after the IDCT: luma w x h, chroma
// cw x ch at its own sampling (cw = ch = 0 and no chroma for gray).
bool jpeg_decode_planes(const char* path, Planes* out);
// (h, w, 3) RGB or (h, w) gray (the Y plane) into out, which holds
// exactly w * h * channels bytes of the probed size.
bool jpeg_decode_pixels(const char* path, int w, int h, int channels,
                        uint8_t* out);
// (h, w, channels) uint8, channels 1 or 3, at the given quality (1-100),
// colour with chroma sampling 420, 422, 440 or 444.
bool jpeg_encode(const char* path, const uint8_t* pixels, int w, int h,
                 int channels, int quality, int chroma);

// Shared by both codecs (jpeg_color.cc): libjpeg's fancy upsampling of
// stored planes to full resolution (false for a sampling it does not
// take), and libjpeg's fixed-point YCbCr -> RGB of n pixels.
bool upsample_planes(const Planes& in, Planes* out);
void ycc_to_rgb(const uint8_t* y, const uint8_t* cb, const uint8_t* cr,
                size_t n, uint8_t* rgb);

}  // namespace vc

#endif  // VC_JPEG_BACKEND_H_
