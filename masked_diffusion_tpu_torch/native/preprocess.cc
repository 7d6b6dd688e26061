// A copy of masked_diffusion_tpu/native/preprocess.cc, byte for byte below
// this header (the port imports nothing of the JAX package);
// tests/test_torch_port_native.py holds the two equal. The port builds it
// with masked_diffusion_tpu_torch/native/__init__.py into build/native/.
//
// Native host-side image preprocessing for the data layer.
//
// The reference preloads whole datasets into RAM through a per-image Python
// transform chain (torchvision Resize+CenterCrop+ToTensor+Normalize,
// utils/mydataset.py:64-83). On TPU hosts the accelerator is fed from this
// preload, so startup cost is pure host time; this library replaces the
// Python/PIL per-image loop with an OpenMP-parallel C++ pipeline:
//
//   resize the short side to `out_size` (bilinear, uint8 -> float),
//   center-crop to out_size x out_size,
//   scale to [0,1] and optionally map to [-1,1] (Normalize([0.5],[0.5])).
//
// Exposed via a C ABI for ctypes (no pybind11 in the build image):
//   mdt_resize_center_crop   — one image (variable-size image folders)
//   mdt_preprocess_batch     — N same-sized images, OpenMP over images
//
// Build: g++ -O3 -march=native -fopenmp -shared -fPIC (native/__init__.py
// compiles lazily and falls back to the Python path when no compiler).

#include <algorithm>
#include <cmath>
#include <cstdint>

namespace {

// bilinear sample of channel c at (y, x) from an HWC uint8 image
inline float sample_bilinear(const uint8_t* src, int h, int w, int ch,
                             float y, float x, int c) {
  // clamp indices FIRST, then weights relative to the clamped base — out-of-
  // range coords (every upscale's border) must replicate the edge row/col,
  // not blend it with its neighbor (matches datasets._bilinear_resize)
  int y0 = std::min(std::max(static_cast<int>(std::floor(y)), 0), h - 1);
  int x0 = std::min(std::max(static_cast<int>(std::floor(x)), 0), w - 1);
  int y1 = std::min(y0 + 1, h - 1);
  int x1 = std::min(x0 + 1, w - 1);
  float wy = std::min(std::max(y - y0, 0.0f), 1.0f);
  float wx = std::min(std::max(x - x0, 0.0f), 1.0f);
  const float a = src[(y0 * w + x0) * ch + c];
  const float b = src[(y0 * w + x1) * ch + c];
  const float d = src[(y1 * w + x0) * ch + c];
  const float e = src[(y1 * w + x1) * ch + c];
  return a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx +
         d * wy * (1 - wx) + e * wy * wx;
}

inline void resize_crop_one(const uint8_t* src, int h, int w, int ch,
                            float* dst, int out, int to_pm1) {
  // short side -> out (torchvision Resize semantics), then center crop
  int nh, nw;
  if (h < w) {
    nh = out;
    nw = std::max(out, static_cast<int>(std::lround(
                           static_cast<double>(w) * out / h)));
  } else {
    nw = out;
    nh = std::max(out, static_cast<int>(std::lround(
                           static_cast<double>(h) * out / w)));
  }
  const int top = (nh - out) / 2;
  const int left = (nw - out) / 2;
  const float sy = static_cast<float>(h) / nh;
  const float sx = static_cast<float>(w) / nw;
  const float scale = 1.0f / 255.0f;
  for (int oy = 0; oy < out; ++oy) {
    // pixel-center mapping: (i + 0.5) * scale - 0.5
    const float y = (top + oy + 0.5f) * sy - 0.5f;
    for (int ox = 0; ox < out; ++ox) {
      const float x = (left + ox + 0.5f) * sx - 0.5f;
      float* px = dst + (oy * out + ox) * ch;
      for (int c = 0; c < ch; ++c) {
        float v = sample_bilinear(src, h, w, ch, y, x, c) * scale;
        px[c] = to_pm1 ? v * 2.0f - 1.0f : v;
      }
    }
  }
}

}  // namespace

extern "C" {

// one HWC uint8 image -> out_size x out_size x ch float
void mdt_resize_center_crop(const uint8_t* src, int h, int w, int ch,
                            float* dst, int out_size, int to_pm1) {
  resize_crop_one(src, h, w, ch, dst, out_size, to_pm1);
}

// n same-sized HWC uint8 images, parallel over images
void mdt_preprocess_batch(const uint8_t* src, int n, int h, int w, int ch,
                          float* dst, int out_size, int to_pm1) {
  const int64_t in_stride = static_cast<int64_t>(h) * w * ch;
  const int64_t out_stride =
      static_cast<int64_t>(out_size) * out_size * ch;
#pragma omp parallel for schedule(dynamic)
  for (int i = 0; i < n; ++i) {
    resize_crop_one(src + i * in_stride, h, w, ch, dst + i * out_stride,
                    out_size, to_pm1);
  }
}

}  // extern "C"
