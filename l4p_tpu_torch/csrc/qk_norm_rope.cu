// The prologue of VGGT's attention for Hopper (sm_90a): q/k LayerNorm over
// the head dim, 2D rotary positions and the q/k/v layout, in one pass over
// the QKV product.
//
// Replaces no TPU kernel: the JAX package has no VGGT. On the card the same
// work was a chain of PyTorch operations per block (an fp32 upcast of q and
// k, F.layer_norm, the rotation's multiplies, stack and add, the casts back
// to bf16 and a copy of v into the attention kernel's layout), each of which
// read and wrote the whole of q and k, in fp32 where it could. That chain
// moved ~6.3 GB a block at VGGT's 50,048 tokens x 1024 channels; this
// kernel moves ~0.6 GB.
//
// Bound: bytes. A LayerNorm over 64 values and a rotation are ~12 fp32
// operations an element, so the least time is q, k and v read once and
// written once in bf16 over 3.35 TB/s (the norm parameters and the cos /
// sin table are read from L2). The design keeps every intermediate in
// registers and every device-memory access a whole 16-byte vector:
//   - A head row of D = 64 values is 8 threads of 8 values (16 bytes) each,
//     8 neighbouring lanes of a warp, so its LayerNorm sums are 3 lane
//     shuffles and its rotate_half partner (element j <-> j +- D/4) is the
//     lane 2 away: one shuffle a value, no shared memory.
//   - A warp holds 4 tokens of one head, so its loads are four whole
//     128-byte rows of the QKV product and its stores one 512-byte run of
//     the (B, H, N, D) output (consecutive tokens of a head are consecutive
//     rows there).
//   - A thread owns one token of 4 heads for each of q, k and v: 12 loads in
//     flight, issued before any arithmetic, and the token's cos / sin row
//     and the norm parameters read once for its 8 q and k rows.
//   - The table is one frame's (P, D): token n takes row n mod P, so a
//     global block's S frames read the frame table and no S-times repeated
//     one.
// The arithmetic is the plain version's (ops/qk_norm_rope.py) in fp32:
// mean and biased variance of the bf16 inputs read exactly, rsqrt(var +
// eps), gamma * (rstd * (x - mean)) + beta as PyTorch's CUDA LayerNorm
// writes it, then x * cos + rotate_half(x) * sin as two rounded products
// and a rounded sum (no contraction into an fma), and one rounding to bf16
// at the end. Only the order of the LayerNorm's sums differs from PyTorch's.
//
// Entry point l4p_qk_norm_rope_bf16: qkv (B, N, 3, H, D) bf16 contiguous,
// the four norm vectors (D,) bf16 (null without the norm), cos and sin (P,
// D) fp32 contiguous (null without the rotation), q / k / v (B, H, N, D)
// bf16 contiguous; every pointer 16-byte aligned. Returns 0 or the CUDA
// error of the launch (cudaErrorInvalidValue for what it does not take: D
// other than 64, H not a multiple of 4, N not a multiple of P, neither the
// norm nor the rotation).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kD = 64;                          // head dim
constexpr int kLanes = kD / 8;                  // threads a head row, 8 bf16 (16 bytes) each
constexpr int kPartner = kD / 4 / 8;            // lanes between rotate_half partners
constexpr int kHeads = 4;                       // heads of each of q, k, v a thread
constexpr int kTokens = 32;                     // tokens a block
constexpr int kThreads = kTokens * kLanes;      // 256

struct Args {
  const uint4* qkv;
  const uint4* norm[4];                         // q weight, q bias, k weight, k bias: 8 bf16 a vector
  const float4* cos;
  const float4* sin;
  uint4* out[3];                                // q, k, v
  int n, h, p;
  long long tokens;                             // B * N
  float eps;
};

__device__ __forceinline__ void unpack(const uint4& u, float (&x)[8]) {
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h2[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ uint4 pack(const float (&x)[8]) {
  uint4 u;
  __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h2[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
  return u;
}

// the sum over the 8 lanes of a head row
__device__ __forceinline__ float row_sum(float v, unsigned mask) {
#pragma unroll
  for (int d = 1; d < kLanes; d <<= 1) v += __shfl_xor_sync(mask, v, d);
  return v;
}

template <bool NORM, bool ROPE>
__device__ __forceinline__ uint4 qk_row(const uint4& raw, const float (&w)[8], const float (&b)[8],
                                        const float (&c)[8], const float (&s)[8], bool upper, unsigned mask,
                                        float eps) {
  float x[8];
  unpack(raw, x);
  if (NORM) {
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) sum += x[j];
    const float mean = row_sum(sum, mask) * (1.f / kD);
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float d = __fsub_rn(x[j], mean);
      ss = __fmaf_rn(d, d, ss);
    }
    const float rstd = rsqrtf(row_sum(ss, mask) * (1.f / kD) + eps);
#pragma unroll
    for (int j = 0; j < 8; ++j) x[j] = __fmaf_rn(w[j], __fmul_rn(rstd, __fsub_rn(x[j], mean)), b[j]);
  }
  if (ROPE) {
    // rotate_half within each axis: the first quarter takes -(the second), the second takes the first
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float other = __shfl_xor_sync(mask, x[j], kPartner);
      const float rot = upper ? other : -other;
      x[j] = __fadd_rn(__fmul_rn(x[j], c[j]), __fmul_rn(rot, s[j]));
    }
  }
  return pack(x);
}

__device__ __forceinline__ void load8(const float4* row, int lane, float (&x)[8]) {
  const float4 a = __ldg(row + 2 * lane), b = __ldg(row + 2 * lane + 1);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

template <bool NORM, bool ROPE>
__global__ void __launch_bounds__(kThreads) qk_norm_rope_kernel(Args a) {
  const int lane = threadIdx.x % kLanes;
  const long long t = static_cast<long long>(blockIdx.x) * kTokens + threadIdx.x / kLanes;
  if (t >= a.tokens) return;  // the 8 lanes of a row leave together
  const unsigned mask = 0xffu << (threadIdx.x % 32 & ~(kLanes - 1));
  const int h0 = blockIdx.y * kHeads;
  const long long bi = t / a.n;
  const int ni = static_cast<int>(t - bi * a.n);

  // q, k and v of heads h0 .. h0 + 3 of token t: rows (t, part, h) of the QKV product
  uint4 raw[3][kHeads];
  const uint4* src = a.qkv + (t * 3 * a.h + h0) * kLanes + lane;
#pragma unroll
  for (int part = 0; part < 3; ++part)
#pragma unroll
    for (int j = 0; j < kHeads; ++j) raw[part][j] = __ldg(src + (part * a.h + j) * kLanes);

  float c[8] = {}, s[8] = {};
  if (ROPE) {
    const long long row = (ni % a.p) * (kD / 4);  // float4s a table row
    load8(a.cos + row, lane, c);
    load8(a.sin + row, lane, s);
  }
  float w[2][8] = {}, b[2][8] = {};
  if (NORM) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      unpack(__ldg(a.norm[2 * i] + lane), w[i]);
      unpack(__ldg(a.norm[2 * i + 1] + lane), b[i]);
    }
  }
  const bool upper = lane & kPartner;

  // rows (b, h0 + j, n) of the (B, H, N, D) outputs
  const long long dst = ((bi * a.h + h0) * a.n + ni) * kLanes + lane;
  const long long head = static_cast<long long>(a.n) * kLanes;
#pragma unroll
  for (int j = 0; j < kHeads; ++j) a.out[2][dst + j * head] = raw[2][j];
#pragma unroll
  for (int part = 0; part < 2; ++part)
#pragma unroll
    for (int j = 0; j < kHeads; ++j)
      a.out[part][dst + j * head] = qk_row<NORM, ROPE>(raw[part][j], w[part], b[part], c, s, upper, mask, a.eps);
}

template <bool NORM, bool ROPE>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((a.tokens + kTokens - 1) / kTokens), a.h / kHeads);
  qk_norm_rope_kernel<NORM, ROPE><<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int l4p_qk_norm_rope_bf16(const void* qkv, const void* q_weight, const void* q_bias,
                                     const void* k_weight, const void* k_bias, const void* cos, const void* sin,
                                     void* q, void* k, void* v, int b, int n, int h, int d, int p, int norm,
                                     int rope, float eps, cudaStream_t stream) {
  if (d != kD || h <= 0 || h % kHeads || b <= 0 || n <= 0 || (!norm && !rope) || (rope && (p <= 0 || n % p)) ||
      static_cast<long long>(b) * n / kTokens >= (1ll << 31))
    return cudaErrorInvalidValue;
  Args a{};
  a.qkv = static_cast<const uint4*>(qkv);
  const void* norms[4] = {q_weight, q_bias, k_weight, k_bias};
  for (int i = 0; i < 4; ++i) a.norm[i] = static_cast<const uint4*>(norms[i]);
  a.cos = static_cast<const float4*>(cos);
  a.sin = static_cast<const float4*>(sin);
  a.out[0] = static_cast<uint4*>(q);
  a.out[1] = static_cast<uint4*>(k);
  a.out[2] = static_cast<uint4*>(v);
  a.n = n;
  a.h = h;
  a.p = rope ? p : 1;
  a.tokens = static_cast<long long>(b) * n;
  a.eps = eps;
  cudaError_t err;
  if (norm && rope)
    err = launch<true, true>(a, stream);
  else if (norm)
    err = launch<true, false>(a, stream);
  else
    err = launch<false, true>(a, stream);
  return static_cast<int>(err);
}
