// Trilinear resize for Hopper (sm_90a), equal bit for bit to
// F.interpolate(mode="trilinear") on the card, for bf16 and fp32, with or
// without align_corners, to any size up or down.
//
// Replaces no TPU kernel: the JAX package resizes with per-axis
// interpolation matrices (l4p_tpu/ops/resize.py:38-78) that XLA turns into
// products. On the card PyTorch's upsample_trilinear3d gives each output
// position (t, h, w) one thread that loops over all N x C planes, so at the
// DPT heads' shapes (512 planes, a few hundred thousand positions) each
// thread makes hundreds of dependent trips and the card idles; this kernel
// is its replacement on the dense heads' path.
//
// Layout: x (N, Ti, Hi, Wi, C) and y (N, To, Ho, Wo, C), channels innermost,
// as the DPT trunk's convolutions hand their outputs over (channels_last_3d,
// which F.interpolate keeps). An NCDHW tensor is the same with C = 1 and N
// the planes, so the one kernel takes both.
//
// Bound: bytes. A resize does about 8 multiply-adds an output, so its least
// time is the input read once and the output written once over 3.35 TB/s.
// The design keeps the device-memory traffic near that and the work on the
// SM near one pass over each intermediate sum:
//   - A thread owns VEC consecutive channels (8 bf16 or 4 fp32: one 16-byte
//     load or store) of one output position (h, w) and walks down every
//     output t. Neighbouring threads own neighbouring channels, then
//     neighbouring w, so a warp's loads and stores are whole 128-byte lines,
//     and the input vectors that neighbouring positions share come from L1
//     and L2, read from device memory about once.
//   - For each input t the thread reads the 4 vectors (h0|h1, w0|w1) and sums
//     along w, then along h, once; consecutive output ts share input ts (t1
//     of one output is t0 of the next at an identity axis), so those sums are
//     kept, not redone, and each output t costs one sum along t.
//   - The source indices and weights are computed in the kernel, as PyTorch
//     computes them (area_pixel_compute_source_index: the same clamp at 0
//     and the same `idx + (idx < in - 1)` neighbour), from the scales the
//     host computes as area_pixel_compute_scale does. The sums run in fp32
//     in PyTorch's order, w innermost, then h, then t, each level
//     l0 * x0 + l1 * x1 contracted as nvcc contracts PyTorch's expression
//     (one fma on the first product), written out with intrinsics so that
//     no compiler choice can move it; each output is rounded once to the
//     output type.
//
// Entry points l4p_resize_trilinear_{bf16,f32}: x and y contiguous in the
// layout above; returns 0 or the CUDA error of the launch
// (cudaErrorInvalidValue for sizes it does not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

struct Axis {
  int in, out;
  float scale;  // area_pixel_compute_scale
};

struct Shape {
  Axis t, h, w;
  int c, cv;       // channels, and vectors of VEC channels
  int align;
  unsigned items;  // N * Ho * Wo * cv threads, below 2^31
};

struct Tap {
  int i0, i1;
  float l0, l1;
};

// area_pixel_compute_source_index and the neighbour of
// upsample_trilinear3d_out_frame
__device__ __forceinline__ Tap tap(const Axis& a, int dst, bool align) {
  float r;
  if (align) {
    r = __fmul_rn(a.scale, static_cast<float>(dst));
  } else {
    r = __fmaf_rn(a.scale, static_cast<float>(dst) + 0.5f, -0.5f);
    r = r < 0.f ? 0.f : r;
  }
  const int i = static_cast<int>(r);
  const float l1 = r - static_cast<float>(i);
  return {i, i + (i < a.in - 1 ? 1 : 0), 1.f - l1, l1};
}

// l0 * x0 + l1 * x1, contracted on the first product
__device__ __forceinline__ float lerp(float l0, float x0, float l1, float x1) {
  return __fmaf_rn(l0, x0, __fmul_rn(l1, x1));
}

// VEC consecutive elements as floats, and back (one 16-byte access where VEC fills it)
template <typename T, int VEC>
struct Vec;

template <>
struct Vec<__nv_bfloat16, 8> {
  __device__ static void load(const __nv_bfloat16* p, float* v) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[2 * k] = __uint_as_float(w[k] << 16);
      v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float* v) {
    unsigned w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
      w[k] = *reinterpret_cast<const unsigned*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <>
struct Vec<float, 4> {
  __device__ static void load(const float* p, float* v) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
  }
  __device__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec<__nv_bfloat16, 1> {
  __device__ static void load(const __nv_bfloat16* p, float* v) { v[0] = __bfloat162float(__ldg(p)); }
  __device__ static void store(__nv_bfloat16* p, const float* v) { *p = __float2bfloat16_rn(v[0]); }
};

template <>
struct Vec<float, 1> {
  __device__ static void load(const float* p, float* v) { v[0] = __ldg(p); }
  __device__ static void store(float* p, const float* v) { *p = v[0]; }
};

// one input t's sum along w, then along h, of the VEC channels at offsets o (h0 w0, h0 w1, h1 w0, h1 w1) of p
template <typename T, int VEC>
__device__ __forceinline__ void along_hw(float* s, const T* p, const long long* o, const Tap& hq, const Tap& wq) {
  float a[VEC], b[VEC], c[VEC], d[VEC];
  Vec<T, VEC>::load(p + o[0], a);
  Vec<T, VEC>::load(p + o[1], b);
  Vec<T, VEC>::load(p + o[2], c);
  Vec<T, VEC>::load(p + o[3], d);
#pragma unroll
  for (int j = 0; j < VEC; ++j)
    s[j] = lerp(hq.l0, lerp(wq.l0, a[j], wq.l1, b[j]), hq.l1, lerp(wq.l0, c[j], wq.l1, d[j]));
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads) resize_kernel(const T* __restrict__ x, T* __restrict__ y, Shape s) {
  unsigned i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= s.items) return;
  const bool align = s.align != 0;
  const int cv = static_cast<int>(i % s.cv);
  i /= s.cv;
  const int wo = static_cast<int>(i % s.w.out);
  i /= s.w.out;
  const int ho = static_cast<int>(i % s.h.out);
  const long long n = i / s.h.out;
  const Tap hq = tap(s.h, ho, align), wq = tap(s.w, wo, align);

  const long long c = s.c, in_t = static_cast<long long>(s.h.in) * s.w.in * c;
  const T* xp = x + n * s.t.in * in_t + cv * VEC;
  const long long o[4] = {(static_cast<long long>(hq.i0) * s.w.in + wq.i0) * c,
                          (static_cast<long long>(hq.i0) * s.w.in + wq.i1) * c,
                          (static_cast<long long>(hq.i1) * s.w.in + wq.i0) * c,
                          (static_cast<long long>(hq.i1) * s.w.in + wq.i1) * c};
  const long long out_t = static_cast<long long>(s.h.out) * s.w.out * c;
  T* yp = y + n * s.t.out * out_t + (static_cast<long long>(ho) * s.w.out + wo) * c + cv * VEC;

  float sa[VEC], sb[VEC];  // the sums of input ts ka and kb
  int ka = -1, kb = -1;
  for (int to = 0; to < s.t.out; ++to, yp += out_t) {
    const Tap tq = tap(s.t, to, align);
    if (tq.i0 != ka) {
      if (tq.i0 == kb) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) sa[j] = sb[j];
      } else {
        along_hw<T, VEC>(sa, xp + tq.i0 * in_t, o, hq, wq);
      }
      ka = tq.i0;
    }
    if (tq.i1 != kb) {
      if (tq.i1 == ka) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) sb[j] = sa[j];
      } else {
        along_hw<T, VEC>(sb, xp + tq.i1 * in_t, o, hq, wq);
      }
      kb = tq.i1;
    }
    float v[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = lerp(tq.l0, sa[j], tq.l1, sb[j]);
    Vec<T, VEC>::store(yp, v);
  }
}

// area_pixel_compute_scale with no scale given: a float, divided on the host
float axis_scale(int in, int out, bool align) {
  if (align) return out > 1 ? static_cast<float>(in - 1) / static_cast<float>(out - 1) : 0.f;
  return static_cast<float>(in) / static_cast<float>(out);
}

template <typename T, int VEC>
int launch_vec(const T* x, T* y, Shape s, long long positions, cudaStream_t stream) {
  s.cv = s.c / VEC;
  const long long items = positions * s.cv;
  if (items >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  s.items = static_cast<unsigned>(items);
  const unsigned blocks = static_cast<unsigned>((items + kThreads - 1) / kThreads);
  resize_kernel<T, VEC><<<blocks, kThreads, 0, stream>>>(x, y, s);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, void* y, int n, int c, int ti, int hi, int wi, int to, int ho, int wo, int align,
           void* stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (n <= 0 || c <= 0 || ti <= 0 || hi <= 0 || wi <= 0 || to <= 0 || ho <= 0 || wo <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool a = align != 0;
  const Shape s{{ti, to, axis_scale(ti, to, a)}, {hi, ho, axis_scale(hi, ho, a)}, {wi, wo, axis_scale(wi, wo, a)},
                c, 0, a ? 1 : 0, 0};
  const long long positions = static_cast<long long>(n) * ho * wo;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;
  if (c % kVec == 0 && aligned) return launch_vec<T, kVec>(xt, yt, s, positions, st);
  return launch_vec<T, 1>(xt, yt, s, positions, st);
}

}  // namespace

extern "C" int l4p_resize_trilinear_bf16(const void* x, void* y, int n, int c, int ti, int hi, int wi, int to, int ho,
                                         int wo, int align, void* stream) {
  return launch<__nv_bfloat16>(x, y, n, c, ti, hi, wi, to, ho, wo, align, stream);
}

extern "C" int l4p_resize_trilinear_f32(const void* x, void* y, int n, int c, int ti, int hi, int wi, int to, int ho,
                                        int wo, int align, void* stream) {
  return launch<float>(x, y, n, c, ti, hi, wi, to, ho, wo, align, stream);
}
