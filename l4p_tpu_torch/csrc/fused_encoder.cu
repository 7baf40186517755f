// The whole-encoder blocks for Hopper (sm_90a): fused_encoder_blocks of
// l4p_tpu_torch/ops/fused_encoder.py, as a short chain of kernels per block.
//
// Replaces the Pallas TPU kernel l4p_tpu/ops/fused_encoder.py:_encoder_kernel,
// which runs all `depth` pre-LN ViT blocks in one program: a sequential grid
// (windows, depth, phases) keeps x, LN(x), q/k/v and an fp32 MLP accumulator
// resident in ~95 MB of VMEM and streams only the weights. Nothing of that
// carries over: a Hopper block has 227 KB of shared memory, the L2 holds
// 50 MB, and blocks run in no order, so nothing carries from one grid step
// to the next. The same function is computed as 7 launches per block:
//
//   ln_rows (LN1) -> gemm_nt<QKV> -> attention (attention.cuh) ->
//   gemm_nt<RESIDUAL> (proj) -> ln_rows (LN2) -> gemm_nt<GELU> (fc1) ->
//   gemm_nt<RESIDUAL> (fc2)
//
// What bounds it: tensor-core FLOPs. Per block and 2048-token window at
// E = 1408, MLP 6144: qkv 24.4, proj 8.1, fc1 35.4, fc2 35.4 and attention
// 23.6 GFLOP, 5.08 TFLOP per window over 40 blocks, against 2.0 GB of
// weights (read once per call) and a few hundred MB of activations per
// window: far above the ~295 FLOP/byte ridge. The design keeps the GEMMs
// on the tensor cores and puts every elementwise step of the block into a
// GEMM epilogue, so the only activations that go through device memory are
// the GEMM operands themselves (LN output, q/k/v, attention output, the MLP
// hidden) and the residual stream.
//
// gemm_nt: C (M, N) = A (M, K) . W (N, K)^T in bf16 with fp32 accumulators,
// W in nn.Linear's (out, in) layout, so no weight is repacked. A 128 x 128
// block tile of 8 warps (2 x 4, 64 x 32 each), 32-deep K chunks and a
// 3-stage cp.async ring; mma.sync m16n8k16 from ldmatrix fragments
// (mma_utils.cuh). Ragged M, N and K edges are zero-filled on load and
// masked on store. Epilogues (the bias is the bf16 parameter, added in fp32):
//   QKV      bf16(acc + (q_bias, 0, v_bias)) written head-major as
//            (3, B, H, N, D), so attention reads q, k and v without copies;
//   GELU     bf16(gelu_tanh(bf16(acc + bias))), the bf16 lane of
//            ops/conv.py:gelu;
//   RESIDUAL x <- bf16(x + bf16(acc + bias)) in place on the residual
//            stream (the JAX package is immutable and writes a new x; the
//            port updates it in place to save a copy per product), and
//            optionally the same value into a second tensor (a hook slot).
// ln_rows: LayerNorm of (M, E) bf16 rows with two-pass fp32 moments, one
// warp per row, bf16 out.
//
// Numerics are those of the port's Block (models/encoder.py) and the JAX
// `_block` step for step: fp32 LN statistics, fp32 accumulation, bias in
// fp32 then bf16, residual adds in bf16, tanh GELU. Attention divides by
// the softmax sum at the end (attention.cuh); the TPU kernel normalises the
// probabilities before P.V, so the two differ in low bits.
//
// The attention runs on wgmma and TMA (attention.cuh); the GEMM's move to
// them and persistence across depth are left for later revisions.

#include <math.h>

#include "attention.cuh"

namespace {

using namespace l4p;
using bf16 = __nv_bfloat16;

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 32;
constexpr int kStages = 3;
constexpr int kSK = kBK + 8;  // +16 B per row: conflict-free ldmatrix
constexpr int kGemmThreads = 256;
constexpr int kGemmSmem = kStages * (kBM + kBN) * kSK * static_cast<int>(sizeof(bf16));

constexpr int kLnWarps = 8;

enum Epilogue { kQKV = 0, kGELU = 1, kRESIDUAL = 2 };

struct EpilogueArgs {
  const bf16* bias;  // (N)
  bf16* out;         // kQKV: (3, B, H, tokens, head_pitch); kGELU: (M, N); kRESIDUAL: the residual stream (M, N)
  bf16* copy_out;    // kRESIDUAL: a second destination of the new stream, or null
  int tokens;        // kQKV: rows per batch item
  int heads;
  int head_dim;
  int head_pitch;    // kQKV: head_row_pitch(head_dim)
};

// The elements between two q/k/v rows in the QKV epilogue's output: head_dim
// rounded up to 16, so that every row starts on a 32-byte sector, which the
// attention's TMA loads need at full rate (PERF.md); the pad is not written
// and not read. ops/fused_encoder.py allocates the buffer by the same rule.
int head_row_pitch(int head_dim) { return (head_dim + 15) / 16 * 16; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float gelu_tanh(float x) {
  const float u = 0.7978845608028654f * (x + 0.044715f * x * x * x);
  return 0.5f * x * (1.f + tanhf(u));
}

__global__ void __launch_bounds__(kLnWarps * 32)
    ln_rows_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w, const bf16* __restrict__ b,
                   bf16* __restrict__ y, int m, int e, float eps) {
  const int row = blockIdx.x * kLnWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= m) return;
  const bf16* xr = x + static_cast<size_t>(row) * e;
  bf16* yr = y + static_cast<size_t>(row) * e;
  float sum = 0.f;
  for (int c = lane * 8; c < e; c += 256) {
    const uint4 u = *reinterpret_cast<const uint4*>(xr + c);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      sum += f.x + f.y;
    }
  }
  const float mean = warp_sum(sum) / e;
  float sq = 0.f;
  for (int c = lane * 8; c < e; c += 256) {
    const uint4 u = *reinterpret_cast<const uint4*>(xr + c);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      sq += (f.x - mean) * (f.x - mean) + (f.y - mean) * (f.y - mean);
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / e + eps);
  for (int c = lane * 8; c < e; c += 256) {
    const uint4 u = *reinterpret_cast<const uint4*>(xr + c);
    const uint4 uw = *reinterpret_cast<const uint4*>(w + c);
    const uint4 ub = *reinterpret_cast<const uint4*>(b + c);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
    const __nv_bfloat162* hw = reinterpret_cast<const __nv_bfloat162*>(&uw);
    const __nv_bfloat162* hb = reinterpret_cast<const __nv_bfloat162*>(&ub);
    uint4 out;
    uint32_t* po = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      const float2 fw = __bfloat1622float2(hw[i]);
      const float2 fb = __bfloat1622float2(hb[i]);
      po[i] = pack_bf16x2((f.x - mean) * rstd * fw.x + fb.x, (f.y - mean) * rstd * fw.y + fb.y);
    }
    *reinterpret_cast<uint4*>(yr + c) = out;
  }
}

// Two neighbouring output columns (col, col + 1) of row r; col is even and
// N % 8 == 0, so both are in range together.
template <int EPI>
__device__ __forceinline__ void store_pair(int r, int col, float v0, float v1, int n, int m,
                                           const EpilogueArgs& ep) {
  const __nv_bfloat162 bias = *reinterpret_cast<const __nv_bfloat162*>(ep.bias + col);
  const float2 fb = __bfloat1622float2(bias);
  v0 = bf16_round(v0 + fb.x);
  v1 = bf16_round(v1 + fb.y);
  if (EPI == kQKV) {
    const int e = ep.heads * ep.head_dim;
    const int s = col / e;
    const int f = col - s * e;
    const int h = f / ep.head_dim;
    const int d = f - h * ep.head_dim;
    const int b = r / ep.tokens;
    const int t = r - b * ep.tokens;
    const int batch = m / ep.tokens;
    const size_t off = ((((static_cast<size_t>(s) * batch + b) * ep.heads + h) * ep.tokens + t) * ep.head_pitch) + d;
    *reinterpret_cast<uint32_t*>(ep.out + off) = pack_bf16x2(v0, v1);
  } else if (EPI == kGELU) {
    *reinterpret_cast<uint32_t*>(ep.out + static_cast<size_t>(r) * n + col) = pack_bf16x2(gelu_tanh(v0), gelu_tanh(v1));
  } else {
    uint32_t* p = reinterpret_cast<uint32_t*>(ep.out + static_cast<size_t>(r) * n + col);
    const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    const uint32_t packed = pack_bf16x2(x.x + v0, x.y + v1);
    *p = packed;
    if (ep.copy_out != nullptr)
      *reinterpret_cast<uint32_t*>(ep.copy_out + static_cast<size_t>(r) * n + col) = packed;
  }
}

template <int EPI>
__global__ void __launch_bounds__(kGemmThreads, 2)
    gemm_nt_kernel(const bf16* __restrict__ a, const bf16* __restrict__ w, int m, int n, int k, EpilogueArgs ep) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sA = reinterpret_cast<bf16*>(smem);  // [kStages][kBM][kSK]
  bf16* sB = sA + kStages * kBM * kSK;       // [kStages][kBN][kSK]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = warp >> 2;  // 64-row half of the block tile
  const int wn = warp & 3;   // 32-column quarter
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;

  auto load_stage = [&](int stage, int kt) {
    const int k0 = kt * kBK;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kGemmThreads;  // 512 16-byte chunks per operand tile
      const int r = c >> 2;
      const int col = (c & 3) * 8;
      const int gk = k0 + col;
      const int ga = m0 + r;
      const bool va = ga < m && gk < k;
      cp_async_16(smem_addr(sA + (stage * kBM + r) * kSK + col), va ? a + static_cast<size_t>(ga) * k + gk : a,
                  va ? 16 : 0);
      const int gb = n0 + r;
      const bool vb = gb < n && gk < k;
      cp_async_16(smem_addr(sB + (stage * kBN + r) * kSK + col), vb ? w + static_cast<size_t>(gb) * k + gk : w,
                  vb ? 16 : 0);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  const int nk = (k + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage kt has landed, and every warp is done with stage kt - 1
    if (kt + kStages - 1 < nk) load_stage((kt + kStages - 1) % kStages, kt + kStages - 1);
    cp_async_commit();
    const bf16* tA = sA + (kt % kStages) * kBM * kSK;
    const bf16* tB = sB + (kt % kStages) * kBN * kSK;
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      uint32_t af[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldmatrix_x4(af[mt], smem_addr(tA + (wm * 64 + mt * 16 + (lane & 15)) * kSK + ks * 16 + (lane >> 4) * 8));
      uint32_t bfr[4][2];
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, smem_addr(tB + (wn * 32 + np * 16 + (lane & 7) + (lane >> 4) * 8) * kSK + ks * 16 +
                                 ((lane >> 3) & 1) * 8));
        bfr[2 * np][0] = b[0];
        bfr[2 * np][1] = b[1];
        bfr[2 * np + 1][0] = b[2];
        bfr[2 * np + 1][1] = b[3];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_16816(acc[mt][nt], af[mt], bfr[nt][0], bfr[nt][1]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    const int row = m0 + wm * 64 + mt * 16 + (lane >> 2);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = n0 + wn * 32 + nt * 8 + (lane & 3) * 2;
      if (col < n) {
        if (row < m) store_pair<EPI>(row, col, acc[mt][nt][0], acc[mt][nt][1], n, m, ep);
        if (row + 8 < m) store_pair<EPI>(row + 8, col, acc[mt][nt][2], acc[mt][nt][3], n, m, ep);
      }
    }
  }
}

template <int EPI>
cudaError_t launch_gemm(const bf16* a, const bf16* w, int m, int n, int k, const EpilogueArgs& ep,
                        cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(gemm_nt_kernel<EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize, kGemmSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  gemm_nt_kernel<EPI><<<grid, kGemmThreads, kGemmSmem, stream>>>(a, w, m, n, k, ep);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// Each entry point returns 0 on success, else the CUDA error code of the
// refused launch (cudaErrorInvalidValue for a shape the kernel does not take);
// the attention returns -(CUresult) when a tensor map cannot be encoded.

extern "C" int l4p_ln_rows_bf16(const void* x, const void* w, const void* b, void* y, int m, int e, float eps,
                                void* stream) {
  if (m <= 0 || e <= 0 || e % 8 != 0 || !aligned16(x) || !aligned16(w) || !aligned16(b) || !aligned16(y))
    return static_cast<int>(cudaErrorInvalidValue);
  ln_rows_kernel<<<(m + kLnWarps - 1) / kLnWarps, kLnWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const bf16*>(b), static_cast<bf16*>(y),
      m, e, eps);
  return static_cast<int>(cudaGetLastError());
}

// epilogue: 0 QKV (out (3, m / tokens, heads, tokens, head_row_pitch(head_dim)), n == 3 * heads * head_dim),
// 1 GELU (out (m, n)), 2 RESIDUAL (out (m, n) updated in place, copy_out (m, n) or null).
extern "C" int l4p_gemm_nt_bf16(const void* a, const void* w, const void* bias, void* out, void* copy_out, int m,
                                int n, int k, int epilogue, int tokens, int heads, int head_dim, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || n % 8 != 0 || k % 8 != 0 || m / kBM >= 65535 || !aligned16(a) ||
      !aligned16(w) || !aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  if (epilogue == kQKV && (tokens <= 0 || m % tokens != 0 || heads <= 0 || head_dim <= 0 || head_dim % 2 != 0 ||
                           n != 3 * heads * head_dim))
    return static_cast<int>(cudaErrorInvalidValue);
  EpilogueArgs ep{static_cast<const bf16*>(bias), static_cast<bf16*>(out), static_cast<bf16*>(copy_out), tokens,
                  heads, head_dim, head_row_pitch(head_dim)};
  const bf16* pa = static_cast<const bf16*>(a);
  const bf16* pw = static_cast<const bf16*>(w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (epilogue == kQKV)
    err = launch_gemm<kQKV>(pa, pw, m, n, k, ep, s);
  else if (epilogue == kGELU)
    err = launch_gemm<kGELU>(pa, pw, m, n, k, ep, s);
  else if (epilogue == kRESIDUAL)
    err = launch_gemm<kRESIDUAL>(pa, pw, m, n, k, ep, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// qkv (3, batch, heads, tokens, head_row_pitch(head_dim)) -> o (batch, tokens, heads * head_dim)
extern "C" int l4p_encoder_attention_bf16(const void* qkv, void* o, int batch, int heads, int tokens, int head_dim,
                                          float scale, void* stream) {
  using namespace l4p::attn;
  const int bh = batch * heads;
  if (batch <= 0 || heads <= 0 || bh > 65535 || tokens <= 0 || head_dim <= 0 || head_dim % 8 != 0 ||
      head_dim > 96 || !aligned16(qkv) || !aligned16(o))
    return static_cast<int>(cudaErrorInvalidValue);
  const int pitch = head_row_pitch(head_dim);
  const size_t part = static_cast<size_t>(bh) * tokens * pitch;
  const bf16* q = static_cast<const bf16*>(qkv);
  const int e = heads * head_dim;
  const float scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long stride_b = static_cast<long long>(tokens) * e;
  return head_dim <= 64 ? launch_attention<64>(q, q + part, q + 2 * part, o, bh, tokens, tokens, head_dim, pitch,
                                               scale_log2, heads, stride_b, head_dim, e, s)
                        : launch_attention<96>(q, q + part, q + 2 * part, o, bh, tokens, tokens, head_dim, pitch,
                                               scale_log2, heads, stride_b, head_dim, e, s);
}
