// Native image data-plane: JPEG decode (libjpeg) + PIL-style triangle
// (bilinear-antialias) resize.
//
// The port's copy of native/image_decode.cpp, byte for byte below this
// comment, built by pdae_torch/utils/_host_build.py with the same g++
// flags, so its arithmetic matches the JAX package's library bit for bit.
//
// Why: PIL decode holds work inside one python process where the GIL caps
// thread-pool scaling at ~4 workers (measured 459 imgs/s @128px).  ctypes
// calls release the GIL, so this path scales with the worker pool and
// removes the host ceiling for the multi-million-image LSUN datasets.
//
// Resize matches PIL.Image.BILINEAR semantics: a triangle filter whose
// support scales with the downsampling factor (antialiased), separable
// horizontal-then-vertical passes, float accumulation, round-half-away.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <csetjmp>
#include <vector>

#include <jpeglib.h>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

}  // namespace

extern "C" {

// Decode a JPEG buffer to tightly-packed RGB8.  Returns a malloc'd buffer
// (caller frees with pdae_buffer_free) or nullptr on failure.
uint8_t* pdae_jpeg_decode(const uint8_t* data, size_t len, int* out_w,
                          int* out_h) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  // volatile: `out` is written between setjmp and a potential longjmp;
  // without it the register copy restored by longjmp is indeterminate
  // (C UB) and the error path would free a stale pointer / leak the buffer
  uint8_t* volatile out = nullptr;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    free(out);
    return nullptr;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data),
               static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  const int w = cinfo.output_width;
  const int h = cinfo.output_height;
  const int stride = w * 3;
  out = static_cast<uint8_t*>(malloc(size_t(stride) * h));
  if (!out) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return nullptr;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out + size_t(cinfo.output_scanline) * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  *out_w = w;
  *out_h = h;
  return out;
}

void pdae_buffer_free(uint8_t* p) { free(p); }

namespace {

// Precompute triangle-filter taps for one output axis (PIL semantics).
struct Taps {
  std::vector<int> start;
  std::vector<int> count;
  std::vector<float> weights;  // flattened [out][max_count]
  int max_count = 0;
};

Taps make_taps(int in_size, int out_size) {
  Taps t;
  const double scale = double(in_size) / out_size;
  const double support = scale >= 1.0 ? scale : 1.0;  // filter support = 1
  const int kmax = int(std::ceil(support)) * 2 + 1;
  t.start.resize(out_size);
  t.count.resize(out_size);
  t.weights.assign(size_t(out_size) * kmax, 0.0f);
  t.max_count = kmax;
  for (int xo = 0; xo < out_size; ++xo) {
    const double center = (xo + 0.5) * scale;
    int lo = int(center - support + 0.5);
    int hi = int(center + support + 0.5);
    if (lo < 0) lo = 0;
    if (hi > in_size) hi = in_size;
    double total = 0.0;
    int n = 0;
    for (int xi = lo; xi < hi; ++xi) {
      double x = (xi + 0.5 - center) / (scale >= 1.0 ? scale : 1.0);
      double wgt = x < 0 ? 1.0 + x : 1.0 - x;  // triangle
      if (wgt <= 0.0) continue;
      t.weights[size_t(xo) * kmax + (xi - lo)] = float(wgt);
      total += wgt;
      n = xi - lo + 1;
    }
    t.start[xo] = lo;
    t.count[xo] = n;
    if (total > 0) {
      for (int k = 0; k < n; ++k)
        t.weights[size_t(xo) * kmax + k] /= float(total);
    }
  }
  return t;
}

}  // namespace

// Triangle-filter (PIL BILINEAR) resize of an RGB8 image.
int pdae_resize_triangle(const uint8_t* src, int sw, int sh, uint8_t* dst,
                         int dw, int dh) {
  if (sw <= 0 || sh <= 0 || dw <= 0 || dh <= 0) return -1;
  Taps hx = make_taps(sw, dw);
  Taps vy = make_taps(sh, dh);

  // horizontal pass: [sh, dw, 3] float
  std::vector<float> tmp(size_t(sh) * dw * 3);
  for (int y = 0; y < sh; ++y) {
    const uint8_t* row = src + size_t(y) * sw * 3;
    float* orow = tmp.data() + size_t(y) * dw * 3;
    for (int xo = 0; xo < dw; ++xo) {
      const int lo = hx.start[xo];
      const int n = hx.count[xo];
      const float* wp = hx.weights.data() + size_t(xo) * hx.max_count;
      float r = 0, g = 0, b = 0;
      for (int k = 0; k < n; ++k) {
        const uint8_t* px = row + size_t(lo + k) * 3;
        const float wgt = wp[k];
        r += wgt * px[0];
        g += wgt * px[1];
        b += wgt * px[2];
      }
      orow[xo * 3 + 0] = r;
      orow[xo * 3 + 1] = g;
      orow[xo * 3 + 2] = b;
    }
  }
  // vertical pass
  for (int yo = 0; yo < dh; ++yo) {
    const int lo = vy.start[yo];
    const int n = vy.count[yo];
    const float* wp = vy.weights.data() + size_t(yo) * vy.max_count;
    uint8_t* orow = dst + size_t(yo) * dw * 3;
    for (int x = 0; x < dw * 3; ++x) {
      float acc = 0;
      for (int k = 0; k < n; ++k)
        acc += wp[k] * tmp[size_t(lo + k) * dw * 3 + x];
      int v = int(acc + 0.5f);
      orow[x] = v < 0 ? 0 : (v > 255 ? 255 : uint8_t(v));
    }
  }
  return 0;
}

}  // extern "C"
