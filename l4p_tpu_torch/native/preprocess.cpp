// Native host-side video preprocessing for the l4p_tpu_torch data pipeline
// (the port's copy of l4p_tpu/native/preprocess.cpp).
//
// The reference's data layer is pure Python/torch on the host
// (reference l4p/data/l4p_dataset_mini.py); at production ingest rates the
// host can become what holds the card back. This library provides the
// hot host ops: HWC-uint8 -> CHW-float32 conversion fused with ImageNet
// normalization, bilinear/nearest frame resize (PyTorch index conventions),
// and temporal mirror-pad, multithreaded over frames.
//
// Exposed via a plain C ABI consumed with ctypes (l4p_tpu_torch/native/lib.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

int hw_threads() {
  unsigned n = std::thread::hardware_concurrency();
  return n == 0 ? 4 : static_cast<int>(n);
}

template <typename F>
void parallel_for(int n, F&& fn) {
  int nt = std::min(hw_threads(), n);
  if (nt <= 1) {
    for (int i = 0; i < n; ++i) fn(i);
    return;
  }
  std::vector<std::thread> ts;
  ts.reserve(nt);
  for (int t = 0; t < nt; ++t) {
    ts.emplace_back([=, &fn]() {
      for (int i = t; i < n; i += nt) fn(i);
    });
  }
  for (auto& th : ts) th.join();
}

}  // namespace

extern "C" {

// (T, H, W, 3) uint8 -> (3, T, H, W) float32, (x/255 - mean) / std
void normalize_thwc_u8_to_cthw_f32(const uint8_t* src, float* dst, int T, int H,
                                   int W, const float* mean, const float* std3) {
  const long hw = static_cast<long>(H) * W;
  const long thw = static_cast<long>(T) * hw;
  float scale[3], shift[3];
  for (int c = 0; c < 3; ++c) {
    scale[c] = 1.0f / (255.0f * std3[c]);
    shift[c] = -mean[c] / std3[c];
  }
  parallel_for(T, [&](int t) {
    const uint8_t* s = src + static_cast<long>(t) * hw * 3;
    for (long p = 0; p < hw; ++p) {
      const uint8_t* px = s + p * 3;
      for (int c = 0; c < 3; ++c) {
        dst[c * thw + static_cast<long>(t) * hw + p] = px[c] * scale[c] + shift[c];
      }
    }
  });
}

// bilinear resize, half-pixel convention (torch align_corners=False), float32
// src: (N, H, W) planes; dst: (N, H2, W2)
void resize_bilinear_f32(const float* src, float* dst, int N, int H, int W,
                         int H2, int W2) {
  std::vector<int> y0(H2), y1(H2);
  std::vector<float> wy(H2);
  std::vector<int> x0(W2), x1(W2);
  std::vector<float> wx(W2);
  for (int i = 0; i < H2; ++i) {
    float sy = std::max(0.0f, (i + 0.5f) * H / H2 - 0.5f);
    int f = std::min(static_cast<int>(sy), H - 1);
    y0[i] = f;
    y1[i] = std::min(f + 1, H - 1);
    wy[i] = sy - f;
  }
  for (int j = 0; j < W2; ++j) {
    float sx = std::max(0.0f, (j + 0.5f) * W / W2 - 0.5f);
    int f = std::min(static_cast<int>(sx), W - 1);
    x0[j] = f;
    x1[j] = std::min(f + 1, W - 1);
    wx[j] = sx - f;
  }
  const long in_plane = static_cast<long>(H) * W;
  const long out_plane = static_cast<long>(H2) * W2;
  parallel_for(N, [&](int n) {
    const float* s = src + n * in_plane;
    float* d = dst + n * out_plane;
    for (int i = 0; i < H2; ++i) {
      const float* r0 = s + static_cast<long>(y0[i]) * W;
      const float* r1 = s + static_cast<long>(y1[i]) * W;
      float fy = wy[i];
      float* o = d + static_cast<long>(i) * W2;
      for (int j = 0; j < W2; ++j) {
        float a = r0[x0[j]] * (1 - wx[j]) + r0[x1[j]] * wx[j];
        float b = r1[x0[j]] * (1 - wx[j]) + r1[x1[j]] * wx[j];
        o[j] = a * (1 - fy) + b * fy;
      }
    }
  });
}

// nearest resize with torch's floor(dst * in/out) index; float32 planes
void resize_nearest_f32(const float* src, float* dst, int N, int H, int W,
                        int H2, int W2) {
  std::vector<int> yi(H2), xi(W2);
  for (int i = 0; i < H2; ++i)
    yi[i] = std::min(static_cast<int>(i * (static_cast<float>(H) / H2)), H - 1);
  for (int j = 0; j < W2; ++j)
    xi[j] = std::min(static_cast<int>(j * (static_cast<float>(W) / W2)), W - 1);
  const long in_plane = static_cast<long>(H) * W;
  const long out_plane = static_cast<long>(H2) * W2;
  parallel_for(N, [&](int n) {
    const float* s = src + n * in_plane;
    float* d = dst + n * out_plane;
    for (int i = 0; i < H2; ++i) {
      const float* row = s + static_cast<long>(yi[i]) * W;
      float* o = d + static_cast<long>(i) * W2;
      for (int j = 0; j < W2; ++j) o[j] = row[xi[j]];
    }
  });
}

// temporal mirror-pad: (C, T, H, W) -> (C, 2T-1, H, W), frames T..2T-2 are
// frames T-2..0 (reference l4p_dataset_mini.py:174)
void mirror_pad_time_f32(const float* src, float* dst, int C, int T, int H, int W) {
  const long hw = static_cast<long>(H) * W;
  const int T2 = 2 * T - 1;
  parallel_for(C * T2, [&](int idx) {
    int c = idx / T2;
    int t = idx % T2;
    int ts = t < T ? t : 2 * T - 2 - t;
    std::memcpy(dst + (static_cast<long>(c) * T2 + t) * hw,
                src + (static_cast<long>(c) * T + ts) * hw, hw * sizeof(float));
  });
}

}  // extern "C"
