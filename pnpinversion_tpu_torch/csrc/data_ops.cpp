// Host kernels of the PIE-Bench data path, the port's own copy of the JAX
// package's csrc/data_ops.cpp (its rle_decode, resize_nearest_u8 and
// resize_bilinear_u8).
//
// The reference harness decodes each RLE mask with a Python double loop; over
// a sweep (700 images, each mask read by every evaluated method) the host
// becomes the bottleneck once the card is fast. These loops keep it fed:
//   - rle_decode: run-length mask decode into a {0, 1} f64 buffer
//   - resize_nearest_u8 / resize_bilinear_u8: HWC uint8 resize
// A plain C interface, built by ops/build.py with the host's g++ at first use
// and bound with ctypes by data/_native.py. Bound by memory: one write of the
// mask, one read and write of an image.
#include <algorithm>
#include <cstdint>
#include <cstring>

extern "C" {

// enc: pairs [start, len] * n_pairs; out: length doubles, 1 inside a run.
// Runs are cut at the end of the buffer; a run that starts outside it, or
// has no length, writes nothing (the numpy decode's rule).
void rle_decode(const int64_t* enc, int64_t n_pairs, double* out, int64_t length) {
  std::memset(out, 0, sizeof(double) * length);
  for (int64_t i = 0; i < n_pairs; ++i) {
    int64_t start = enc[2 * i];
    int64_t run = enc[2 * i + 1];
    if (start < 0 || start >= length) continue;
    int64_t end = std::min(start + run, length);
    if (end <= start) continue;
    std::fill(out + start, out + end, 1.0);
  }
}

void resize_nearest_u8(const uint8_t* src, int64_t sh, int64_t sw, int64_t c,
                       uint8_t* dst, int64_t dh, int64_t dw) {
  for (int64_t y = 0; y < dh; ++y) {
    int64_t sy = std::min<int64_t>(sh - 1, y * sh / dh);
    for (int64_t x = 0; x < dw; ++x) {
      int64_t sx = std::min<int64_t>(sw - 1, x * sw / dw);
      std::memcpy(dst + (y * dw + x) * c, src + (sy * sw + sx) * c, c);
    }
  }
}

// Half-pixel centres, edge-clamped, rounded half up.
void resize_bilinear_u8(const uint8_t* src, int64_t sh, int64_t sw, int64_t c,
                        uint8_t* dst, int64_t dh, int64_t dw) {
  const double ry = (double)sh / dh;
  const double rx = (double)sw / dw;
  for (int64_t y = 0; y < dh; ++y) {
    double fy = (y + 0.5) * ry - 0.5;
    int64_t y0 = std::max<int64_t>(0, (int64_t)fy);
    int64_t y1 = std::min<int64_t>(sh - 1, y0 + 1);
    double wy = fy - y0;
    if (wy < 0) wy = 0;
    for (int64_t x = 0; x < dw; ++x) {
      double fx = (x + 0.5) * rx - 0.5;
      int64_t x0 = std::max<int64_t>(0, (int64_t)fx);
      int64_t x1 = std::min<int64_t>(sw - 1, x0 + 1);
      double wx = fx - x0;
      if (wx < 0) wx = 0;
      for (int64_t k = 0; k < c; ++k) {
        double v00 = src[(y0 * sw + x0) * c + k];
        double v01 = src[(y0 * sw + x1) * c + k];
        double v10 = src[(y1 * sw + x0) * c + k];
        double v11 = src[(y1 * sw + x1) * c + k];
        double v = (1 - wy) * ((1 - wx) * v00 + wx * v01) +
                   wy * ((1 - wx) * v10 + wx * v11);
        dst[(y * dw + x) * c + k] = (uint8_t)(v + 0.5);
      }
    }
  }
}

}  // extern "C"
