// The port's native byte moves on NCHW batches, built with no library
// beyond the C++ runtime (the decoders, which need libjpeg, are
// cos_jpeg.cpp):
//   * cos_crop_mirror_u8: the device-side transform's host half, a
//     per-image crop window copy (+ horizontal mirror) on uint8 planes;
//   * cos_transform_batch: Caffe's transform_param on a float batch,
//     out[i] = (crop(mirror(in[i])) - mean) * scale.
// A copy of caffeonspark_tpu/native/cos_native.cpp's byte moves; the
// random draws (crop offsets, flips) stay with the Python caller, so a
// batch equals the numpy path's exactly.  Plain C ABI for ctypes.

#include <cstddef>
#include <cstring>

#include "cos_parallel.h"

extern "C" {

// h_off/w_off: per-image crop origins; mirror_flags: per-image 0/1.
// mean_mode: 0 none, 1 per-channel values (mean[c]), 2 full CHW plane
// (mean has crop*crop*c elements, already cropped by the caller).
void cos_transform_batch(const float* in, int n, int c, int h, int w,
                         int crop, const int* h_off, const int* w_off,
                         const unsigned char* mirror_flags,
                         const float* mean, int mean_mode, float scale,
                         float* out, int num_threads) {
  const int oh = crop > 0 ? crop : h;
  const int ow = crop > 0 ? crop : w;
  cos::parallel_for(n, num_threads, [&](int i) {
    const float* src = in + static_cast<size_t>(i) * c * h * w;
    float* dst = out + static_cast<size_t>(i) * c * oh * ow;
    const int hs = crop > 0 ? h_off[i] : 0;
    const int ws = crop > 0 ? w_off[i] : 0;
    const bool mir = mirror_flags && mirror_flags[i];
    for (int ch = 0; ch < c; ++ch) {
      for (int y = 0; y < oh; ++y) {
        const float* srow =
            src + (static_cast<size_t>(ch) * h + hs + y) * w + ws;
        float* drow = dst + (static_cast<size_t>(ch) * oh + y) * ow;
        for (int x = 0; x < ow; ++x) {
          float v = srow[mir ? (ow - 1 - x) : x];
          if (mean_mode == 1) {
            v -= mean[ch];
          } else if (mean_mode == 2) {
            v -= mean[(static_cast<size_t>(ch) * oh + y) * ow + x];
          }
          drow[x] = v * scale;
        }
      }
    }
  });
}

// crop == 0 means no crop (oh = h, ow = w) and ignores the offsets.
void cos_crop_mirror_u8(const unsigned char* in, int n, int c, int h,
                        int w, int crop, const int* h_off,
                        const int* w_off,
                        const unsigned char* mirror_flags,
                        unsigned char* out, int num_threads) {
  const int oh = crop > 0 ? crop : h;
  const int ow = crop > 0 ? crop : w;
  cos::parallel_for(n, num_threads, [&](int i) {
    const unsigned char* src = in + static_cast<size_t>(i) * c * h * w;
    unsigned char* dst = out + static_cast<size_t>(i) * c * oh * ow;
    const int hs = crop > 0 ? h_off[i] : 0;
    const int ws = crop > 0 ? w_off[i] : 0;
    const bool mir = mirror_flags[i] != 0;
    for (int ch = 0; ch < c; ++ch) {
      const unsigned char* sp = src + static_cast<size_t>(ch) * h * w;
      unsigned char* dp = dst + static_cast<size_t>(ch) * oh * ow;
      for (int y = 0; y < oh; ++y) {
        const unsigned char* row = sp + static_cast<size_t>(hs + y) * w + ws;
        unsigned char* orow = dp + static_cast<size_t>(y) * ow;
        if (!mir) {
          std::memcpy(orow, row, ow);
        } else {
          for (int x = 0; x < ow; ++x) orow[x] = row[ow - 1 - x];
        }
      }
    }
  });
}

int cos_native_version() { return 1; }

}  // extern "C"
