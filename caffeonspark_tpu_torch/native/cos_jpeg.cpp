// The port's native JPEG decoders (linked with -ljpeg): a batch of
// encoded images -> (n, channels, out_h, out_w) planes in BGR order
// (OpenCV's, which Caffe models expect), bilinear-resized, as float32
// or uint8.  A copy of caffeonspark_tpu/native/cos_native.cpp's
// decoders (the jcaffe Mat / cv::imdecode analog); plain C ABI for
// ctypes.

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <algorithm>
#include <atomic>
#include <csetjmp>
#include <cstring>
#include <vector>

#include "cos_parallel.h"

namespace {

struct JpegErr {
  jpeg_error_mgr pub;
  jmp_buf jmp;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jmp, 1);
}

// JPEG bytes -> interleaved rows; false on corrupt input
bool decode_jpeg_raw(const unsigned char* data, long size, int channels,
                     std::vector<unsigned char>* pixels, int* h, int* w) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jmp)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(data),
               static_cast<unsigned long>(size));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = channels == 1 ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *h = cinfo.output_height;
  *w = cinfo.output_width;
  int comps = cinfo.output_components;
  pixels->resize(static_cast<size_t>(*h) * *w * comps);
  while (cinfo.output_scanline < cinfo.output_height) {
    unsigned char* row = pixels->data() +
                         static_cast<size_t>(cinfo.output_scanline) * *w * comps;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// bilinear resize + HWC(RGB) -> CHW(BGR).  The uint8 store truncates,
// so the uint8 output equals the float output cast with astype(uint8).
template <typename T>
void resize_to_chw(const unsigned char* src, int sh, int sw, int channels,
                   int dh, int dw, T* dst) {
  const float ys = dh > 1 ? static_cast<float>(sh - 1) / (dh - 1) : 0.0f;
  const float xs = dw > 1 ? static_cast<float>(sw - 1) / (dw - 1) : 0.0f;
  for (int y = 0; y < dh; ++y) {
    float fy = y * ys;
    int y0 = static_cast<int>(fy);
    int y1 = std::min(y0 + 1, sh - 1);
    float wy = fy - y0;
    for (int x = 0; x < dw; ++x) {
      float fx = x * xs;
      int x0 = static_cast<int>(fx);
      int x1 = std::min(x0 + 1, sw - 1);
      float wx = fx - x0;
      for (int c = 0; c < channels; ++c) {
        const float p00 = src[(y0 * sw + x0) * channels + c];
        const float p01 = src[(y0 * sw + x1) * channels + c];
        const float p10 = src[(y1 * sw + x0) * channels + c];
        const float p11 = src[(y1 * sw + x1) * channels + c];
        float v = p00 * (1 - wy) * (1 - wx) + p01 * (1 - wy) * wx +
                  p10 * wy * (1 - wx) + p11 * wy * wx;
        // BGR plane order: plane (channels-1-c) receives RGB channel c
        int plane = channels == 3 ? 2 - c : c;
        dst[(static_cast<size_t>(plane) * dh + y) * dw + x] =
            static_cast<T>(v);
      }
    }
  }
}

// the number of images decoded; a failed image's slot is zero-filled
template <typename T>
int decode_batch_impl(const unsigned char* blob, const long* offsets,
                      const long* sizes, int n, int channels, int out_h,
                      int out_w, T* out, int num_threads) {
  std::atomic<int> ok(0);
  const size_t plane = static_cast<size_t>(channels) * out_h * out_w;
  cos::parallel_for(n, num_threads, [&](int i) {
    thread_local std::vector<unsigned char> pixels;
    T* dst = out + static_cast<size_t>(i) * plane;
    int h = 0, w = 0;
    if (decode_jpeg_raw(blob + offsets[i], sizes[i], channels, &pixels, &h,
                        &w)) {
      resize_to_chw(pixels.data(), h, w, channels, out_h, out_w, dst);
      ok.fetch_add(1);
    } else {
      std::memset(dst, 0, sizeof(T) * plane);
    }
  });
  return ok.load();
}

}  // namespace

extern "C" {

// offsets[i] / sizes[i] locate image i inside `blob`
int cos_decode_batch(const unsigned char* blob, const long* offsets,
                     const long* sizes, int n, int channels, int out_h,
                     int out_w, float* out, int num_threads) {
  return decode_batch_impl(blob, offsets, sizes, n, channels, out_h, out_w,
                           out, num_threads);
}

// uint8 planes for the device-side transform (COS_DEVICE_TRANSFORM):
// no float buffer and no host cast pass
int cos_decode_batch_u8(const unsigned char* blob, const long* offsets,
                        const long* sizes, int n, int channels, int out_h,
                        int out_w, unsigned char* out, int num_threads) {
  return decode_batch_impl(blob, offsets, sizes, n, channels, out_h, out_w,
                           out, num_threads);
}

}  // extern "C"
