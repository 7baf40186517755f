// The SAM mask decoder's upscale + hypernetwork contraction for Hopper
// (sm_90a): fused_upscale_hypernet of l4p_tpu_torch/ops/fused_upscale.py.
//
// Replaces the Pallas TPU kernel l4p_tpu/ops/fused_upscale.py:_kernel. Per
// token of src (N, P, C) and deconv1 offset k1 (8 of them):
//   x1 = src . W1[k1] + b1 (C -> d1 = 352) -> LayerNorm(eps) -> GELU -> bf16
//   x2 = x1 . W2[k2] + b2 (d1 -> d2 = 176, for each of k2 = 4 offsets) ->
//        GELU -> bf16 -> out[m, k1, k2] = x2 . hyper[m] (M = 3 mask tokens).
//
// What bounds it: tensor-core operations. At N = 128 queries, P = 2048
// tokens, C = 1408 the two products are 2.08 + 1.04 = 3.1 TFLOP per call
// against ~738 MB of src and ~100 MB of output, ~3,700 FLOP/byte, far above
// the card's ~295 FLOP/byte ridge. Beside the products run ~2.2 G exact-erf
// GELUs on the CUDA cores (the LayerNorm's output and product 2's), ~2.5 ms
// of issue slots at best, each epilogue after the product it follows. The
// (N, P, k1 * d1) and (N, P, k1, k2 * d2) intermediates (3 GB and 6 GB in
// fp32) never leave the SM.
//
// Layouts: src (N, P, C) bf16, C % 32 == 0; w1T (k1, 352, C) and w2T (k2,
// 176, 352) bf16, one (n, k) row-major matrix per offset, d1 <= 352 and
// d2 <= 176 zero-padded to those widths; b1, lnw, lnb (352) and b2 (176)
// fp32, zero-padded; hyper (N, M, 176) bf16 zero-padded, M <= 4; out (N, M,
// P, k1, k2) fp32 with k1 * k2 <= 32. The padding is exact: padded deconv1
// columns are left out of the LayerNorm's moments and come out of it as 0
// (lnw = lnb = 0 there), GELU(0) = 0, and padded hypernetwork entries are 0.
//
// Build-time hooks for scripts/upscale_bounds.py only (each -D gives a
// kernel whose times mean something and whose results do not):
//   L4P_ABLATE_NO_ERF        GELU's erf becomes a multiply (both epilogues);
//   L4P_ABLATE_NO_DOTS       no hypernetwork dots and no logit stores;
//   L4P_ABLATE_NO_EPILOGUE2  product 2 kept, its bias/GELU/rounding/dots not;
//   L4P_ABLATE_NO_EPILOGUE1  no LayerNorm/GELU after product 1 (bf16 cast);
//   L4P_ABLATE_NO_PRODUCT2   product 2, its loads and its epilogue left out;
//   L4P_ABLATE_NO_RELOAD     each ring stage is loaded once; later uses of it
//                            compute on its stale bytes (no L2 -> SM traffic).

#include <math.h>

#include "sm90.cuh"

namespace {

using namespace l4p;
using bf16 = __nv_bfloat16;

constexpr int kRows = 128;        // tokens per block: two consumer warpgroups of 64
constexpr int kD1P = 352;         // product 1's width: two wgmma halves of 176 columns
constexpr int kHalf = kD1P / 2;   // 176
constexpr int kD2P = 176;         // product 2's width
constexpr int kNT = kHalf / 8;    // n8 column chunks of a 176-column accumulator
constexpr int kBox = 32;          // columns per TMA box: 64 bytes, the swizzle span
constexpr int kKK = kD1P / 16;    // k16 steps of product 2
constexpr int kW2Chunks = (kD1P + 63) / 64;  // product 2's ring stages: up to 64 columns of W2[k2]
constexpr int kMaxM = 4;
constexpr int kMaxK = 32;  // k1 * k2 logits per (token, mask token)
constexpr bool kProduct2 =
#ifdef L4P_ABLATE_NO_PRODUCT2
    false;
#else
    true;
#endif

constexpr int kConsumers = 2;
constexpr int kConsumerThreads = kConsumers * 128;
constexpr int kThreads = kConsumerThreads + 128;  // and the producer warpgroup
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kStages = 4;  // the ring beside the staging buffer fills the 227 KB of shared memory
constexpr int kABytes = kRows * 64;  // a box of src: 128 rows x 32 columns
constexpr int kBBytes = kHalf * 64;  // a box of W1 or W2: 176 rows x 32 columns
constexpr int kBSlot = 12 * 1024;    // a B box's place in a stage, 1024-aligned
constexpr int kStageBytes = kABytes + 2 * kBSlot;
// product 1's stage: src at 0, W1[k1] rows 0..175 at kABytes, rows 176..351
// at kABytes + kBSlot; product 2's: W2[k2] columns 64q.. at 0, 64q + 32.. at
// kBSlot
static_assert(kStageBytes % 1024 == 0 && kBBytes <= kBSlot, "stage layout");
// product 2's result + b2, staged for epilogue 2: a warpgroup's 64 rows,
// 180 floats apart (16-byte aligned rows, banks spread)
constexpr int kXStride = kD2P + 4;
constexpr int kE2Cols = kD2P / 2;  // epilogue 2's columns per thread: two threads per row

// The per-column vectors and this query's hypernetwork vectors, in fp32.
struct Params {
  float b1[kD1P], lnw[kD1P], lnb[kD1P], b2[kD2P], hyp[kMaxM][kD2P];
};

// ring, staging, Params, barriers, and slack to align the ring to 1024 bytes
constexpr size_t kSmemBytes =
    kStages * kStageBytes + kConsumers * 64 * kXStride * sizeof(float) + sizeof(Params) + 2 * kStages * 8 + 1024;

__device__ __forceinline__ float gelu_erf(float x) {
#ifdef L4P_ABLATE_NO_ERF
  return 0.5f * x * (1.f + x * 0.70710678118654752f);
#else
  return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
#endif
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

__device__ void load_params(Params& P, const float* b1, const float* lnw, const float* lnb, const float* b2,
                            const bf16* hyper_n, int m, int tid, int nthreads) {
  for (int i = tid; i < kD1P; i += nthreads) {
    P.b1[i] = b1[i];
    P.lnw[i] = lnw[i];
    P.lnb[i] = lnb[i];
  }
  for (int i = tid; i < kMaxM * kD2P; i += nthreads) {
    const int mm = i / kD2P, col = i % kD2P;
    if (mm == 0) P.b2[col] = b2[col];
    P.hyp[mm][col] = mm < m ? __bfloat162float(hyper_n[mm * kD2P + col]) : 0.f;
  }
}

// Accumulator layout of a wgmma m64nNk16 warpgroup: acc[4j + e] is row
// g + 8 (e >> 1) of the warp's 16 rows, column 8j + 2t + (e & 1) (lane =
// 4g + t). acc[h] is product 1's half h (columns 176h..).
//
// Epilogue 1: + b1, two-pass LayerNorm over the d1 valid columns (a row's
// columns lie in one quad), GELU, bf16; returned as the A fragments of
// product 2 (k16 step kk: columns 16kk..16kk+15; the D fragment of two n8
// chunks is the A fragment of one k16 step, sm90.cuh).
__device__ __forceinline__ void epilogue1(float (&acc)[2][4 * kNT], uint32_t (&y)[kKK][4], const Params& P,
                                          float inv_d1, int d1, float eps, int t) {
#ifndef L4P_ABLATE_NO_EPILOGUE1
  float s[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const float2 b = *reinterpret_cast<const float2*>(&P.b1[h * kHalf + 8 * j + 2 * t]);
      acc[h][4 * j] += b.x;
      acc[h][4 * j + 1] += b.y;
      acc[h][4 * j + 2] += b.x;
      acc[h][4 * j + 3] += b.y;
      s[0] += acc[h][4 * j] + acc[h][4 * j + 1];  // padded columns are exactly 0
      s[1] += acc[h][4 * j + 2] + acc[h][4 * j + 3];
    }
  }
  const float mean[2] = {quad_sum(s[0]) * inv_d1, quad_sum(s[1]) * inv_d1};
  float q[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float dv = acc[h][4 * j + e] - mean[e >> 1];
        q[e >> 1] += dv * dv;
      }
    }
  }
  // the sums ran over all 352 columns; each padded one (exactly 0) added
  // mean^2, none at the track head's d1 = 352 (a mask per column instead
  // cost registers that ptxas spilled)
  float rstd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float qv = fmaxf(fmaf(-static_cast<float>(kD1P - d1), mean[r] * mean[r], quad_sum(q[r])), 0.f);
    rstd[r] = rsqrtf(fmaf(qv, inv_d1, eps));
  }
#endif
  // k16 step by k16 step, so that each step's accumulators die as its A
  // fragment is packed
#pragma unroll
  for (int kk = 0; kk < kKK; ++kk) {
    const int h = kk / (kKK / 2), j0 = 2 * (kk % (kKK / 2));
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int j = j0 + i / 4, e = i % 4;
#ifdef L4P_ABLATE_NO_EPILOGUE1
      v[i] = acc[h][4 * j + e];
#else
      const int col = h * kHalf + 8 * j + 2 * t + (e & 1);
      const float xn = (acc[h][4 * j + e] - mean[e >> 1]) * rstd[e >> 1];
      v[i] = gelu_erf(xn * P.lnw[col] + P.lnb[col]);  // 0 on padded columns
#endif
    }
    y[kk][0] = pack_bf16x2(v[0], v[1]);
    y[kk][1] = pack_bf16x2(v[2], v[3]);
    y[kk][2] = pack_bf16x2(v[4], v[5]);
    y[kk][3] = pack_bf16x2(v[6], v[7]);
  }
}

// Epilogue 2 of one (k1, k2) reads product 2's result + b2 from shared
// memory, so that it runs as a short rolled loop: an unrolled one over the
// accumulator registers was ~3 K instructions a thread and ran at a fifth
// of the schedulers' rate (PERF.md). Thread lt of the warpgroup takes row
// lt / 2 and columns 88 (lt % 2)..: bf16(GELU(x)) dotted with each mask
// token's hypernetwork vector; the row's two threads add their dots and the
// first stores the row's M logits (global row p0 + r0 + lt / 2) at offset k
// of its kk = k1 * k2.
__device__ __forceinline__ void epilogue2(const float* sXw, const Params& P, float* out_n, int p, int p0, int r0,
                                          int kk, int k, int m, int lt) {
  const float* x = sXw + (lt >> 1) * kXStride + (lt & 1) * kE2Cols;
  const float* hyp = &P.hyp[0][0] + (lt & 1) * kE2Cols;
  float dot[kMaxM] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
  for (int c = 0; c < kE2Cols; c += 4) {
    const float4 v = *reinterpret_cast<const float4*>(x + c);
#if defined(L4P_ABLATE_NO_EPILOGUE2)
    dot[0] += v.x + v.y + v.z + v.w;
#else
    const float g0 = bf16_round(gelu_erf(v.x)), g1 = bf16_round(gelu_erf(v.y)), g2 = bf16_round(gelu_erf(v.z)),
                g3 = bf16_round(gelu_erf(v.w));
#if defined(L4P_ABLATE_NO_DOTS)
    dot[0] += g0 + g1 + g2 + g3;
#else
#pragma unroll
    for (int mm = 0; mm < kMaxM; ++mm) {
      const float4 h = *reinterpret_cast<const float4*>(hyp + mm * kD2P + c);
      dot[mm] += g0 * h.x + g1 * h.y + g2 * h.z + g3 * h.w;
    }
#endif
#endif
  }
#pragma unroll
  for (int mm = 0; mm < kMaxM; ++mm) dot[mm] += __shfl_xor_sync(0xffffffffu, dot[mm], 1);
  const int row = p0 + r0 + (lt >> 1);
#if defined(L4P_ABLATE_NO_EPILOGUE2) || defined(L4P_ABLATE_NO_DOTS)
  if (dot[0] == -1.2345e-30f) out_n[row] = dot[0];  // keeps the sums alive
#else
  if ((lt & 1) == 0 && row < p) {
#pragma unroll
    for (int mm = 0; mm < kMaxM; ++mm)
      if (mm < m) out_n[(static_cast<size_t>(mm) * p + row) * kk + k] = dot[mm];
  }
#endif
}

// Design (wgmma + TMA + a producer warpgroup; primitives in sm90.cuh):
// - one block owns 128 tokens of one query: two consumer warpgroups of 64
//   rows and a producer warpgroup (384 threads) whose first thread issues
//   every TMA load; the producer gives up registers (setmaxnreg.dec 24) so
//   that the consumers can take 240.
// - per k1 offset, product 1 (64 x 352 per warpgroup, 176 fp32
//   accumulators a thread) runs as wgmma m64n176k16 on two column halves,
//   both operands K-major in shared memory, over 44 chunks of 32 columns of
//   C that arrive by TMA (a src box of 128 rows, two W1[k1] boxes of 176
//   rows) through a ring of 4 stages of 32 KB, each with a full barrier
//   (expect_tx + the TMA bytes) and an empty barrier (all 256 consumers).
//   A warpgroup's row holds all 352 columns in one quad of threads, so the
//   LayerNorm needs only shuffles.
// - epilogue 1 leaves y (bf16) in registers as product 2's A fragments;
//   product 2 per k2 (64 x 176, 88 accumulators) runs as wgmma m64n176k16
//   with A from registers and W2[k2], whose 64-column chunks come through
//   the same ring. Its accumulators + b2 go to shared memory, from which
//   epilogue 2 (GELU, bf16, the M dots) reads them. Only the M logits per
//   (token, k1, k2) leave the SM, each stored once.
// - the epilogues run after the products they follow, both warpgroups at
//   once: the warpgroups share every ring stage, so neither can run ahead
//   of the other by more than the ring while an epilogue lasts, and issuing
//   epilogue 2 in slices between the next product's wgmma made the kernel
//   slower (PERF.md).
// - what bounds it on the card (scripts/upscale_bounds.py, PERF.md): the
//   products and the ring alone run at ~65% of the bf16 peak, and the
//   epilogues' exact-erf GELUs add about as much again after them.
__global__ void __launch_bounds__(kThreads, 1)
    fused_upscale_kernel(const __grid_constant__ CUtensorMap tm_src, const __grid_constant__ CUtensorMap tm_w1,
                         const __grid_constant__ CUtensorMap tm_w2, const float* __restrict__ b1,
                         const float* __restrict__ lnw, const float* __restrict__ lnb, const float* __restrict__ b2,
                         const bf16* __restrict__ hyper, float* __restrict__ out, int p, int c, int d1, int k1n,
                         int k2n, int m, float eps) {
  using namespace sm90;
  constexpr int kLoader = kConsumerThreads;  // the producer thread that issues every TMA load
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  float* sX = reinterpret_cast<float*>(smem + kStages * kStageBytes);  // [kConsumers][64][kXStride]
  Params& P = *reinterpret_cast<Params*>(sX + kConsumers * 64 * kXStride);
  uint64_t* full = reinterpret_cast<uint64_t*>(&P + 1);  // a stage's bytes arrived
  uint64_t* empty = full + kStages;                      // both consumer warpgroups are done with a stage
  const int n = blockIdx.y, p0 = blockIdx.x * kRows;
  const int n_c = c / kBox;

  if (threadIdx.x == kLoader) {
    prefetch_tensor_map(&tm_src);
    prefetch_tensor_map(&tm_w1);
    prefetch_tensor_map(&tm_w2);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerThreads);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // the warpgroup, warp-uniform by construction (so that ptxas can budget
  // registers per branch after setmaxnreg)
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (wg == kConsumers) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kLoader) {
      int it = 0;
      // waits for stage it % kStages to be free and arms its full barrier;
      // returns the stage, or -1 where the NO_RELOAD ablation skips the load
      auto acquire = [&](uint32_t bytes) {
        const int s = it % kStages;
        if (it >= kStages) mbar_wait(&empty[s], (it / kStages - 1) & 1);
#ifdef L4P_ABLATE_NO_RELOAD
        if (it++ >= kStages) {
          mbar_arrive(&full[s]);
          return -1;
        }
#else
        ++it;
#endif
        mbar_arrive_expect_tx(&full[s], bytes);
        return s;
      };
      for (int k1 = 0; k1 < k1n; ++k1) {
        for (int ch = 0; ch < n_c; ++ch) {
          const int s = acquire(kABytes + 2 * kBBytes);
          if (s < 0) continue;
          unsigned char* st = smem + s * kStageBytes;
          tma_load_3d(st, &tm_src, &full[s], ch * kBox, p0, n);
          tma_load_3d(st + kABytes, &tm_w1, &full[s], ch * kBox, 0, k1);
          tma_load_3d(st + kABytes + kBSlot, &tm_w1, &full[s], ch * kBox, kHalf, k1);
        }
        for (int k2 = 0; k2 < (kProduct2 ? k2n : 0); ++k2) {
          for (int q = 0; q < kW2Chunks; ++q) {
            const int boxes = min(2, (kD1P - 64 * q) / kBox);
            const int s = acquire(boxes * kBBytes);
            if (s < 0) continue;
            for (int b = 0; b < boxes; ++b)
              tma_load_3d(smem + s * kStageBytes + b * kBSlot, &tm_w2, &full[s], 64 * q + b * kBox, 0, k2);
          }
        }
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int tid = threadIdx.x, warp = (tid / 32) % 4, lane = tid % 32, t = lane % 4, lt = tid % 128;
    load_params(P, b1, lnw, lnb, b2, hyper + static_cast<size_t>(n) * m * kD2P, m, tid, kConsumerThreads);
    asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumerThreads) : "memory");
    float* out_n = out + static_cast<size_t>(n) * m * p * (k1n * k2n);
    float* sXw = sX + wg * 64 * kXStride;  // this warpgroup's staged rows
    const float inv_d1 = 1.f / d1;

    float acc[2][4 * kNT];
    uint32_t y[kKK][4];
    float acc2[4 * kNT];
    int it = 0;
    auto wait_full = [&]() {
      const int s = it % kStages;
      mbar_wait(&full[s], (it / kStages) & 1);
      return smem + s * kStageBytes;
    };
    auto release = [&](int i) { mbar_arrive(&empty[i % kStages]); };
    // this warpgroup's 64 rows start 64 rows x 64 bytes into every box of src
    const uint32_t a_rows = wg * 64 * 64;
    for (int k1 = 0; k1 < k1n; ++k1) {
      // product 1: acc (64 x 352) = src rows . W1[k1]^T, 2 k16 steps x 2 halves per
      // chunk. Zeroing first also ends the registers' previous life for ptxas.
#pragma unroll
      for (int i = 0; i < 4 * kNT; ++i) acc[0][i] = acc[1][i] = 0.f;
      for (int ch = 0; ch < n_c; ++ch) {
        unsigned char* st = wait_full();
        const uint64_t da = smem_desc(st + a_rows, 16, 512);
        const uint64_t db0 = smem_desc(st + kABytes, 16, 512), db1 = smem_desc(st + kABytes + kBSlot, 16, 512);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < kBox / 16; ++ks) {
          wgmma_m64n176k16_ss(acc[0], da + 2 * ks, db0 + 2 * ks, 1);
          wgmma_m64n176k16_ss(acc[1], da + 2 * ks, db1 + 2 * ks, 1);
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous chunk's products are done with their stage
        if (ch > 0) release(it - 1);
        ++it;
      }
      wgmma_wait<0>();
      fence_regs(acc[0]);
      fence_regs(acc[1]);
      release(it - 1);
      epilogue1(acc, y, P, inv_d1, d1, eps, t);
      if (!kProduct2) {
        if (y[0][0] == 0x12345678u && y[kKK - 1][3] == 0x9abcdef0u) out_n[0] = 0.f;  // keeps the epilogue
        continue;
      }
      // product 2 per k2: acc2 (64 x 176) = y . W2[k2]^T
      for (int k2 = 0; k2 < k2n; ++k2) {
#pragma unroll
        for (int i = 0; i < 4 * kNT; ++i) acc2[i] = 0.f;
#pragma unroll
        for (int q = 0; q < kW2Chunks; ++q) {
          unsigned char* st = wait_full();
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < 4; ++ks) {
            const int kk = 4 * q + ks;
            if (kk < kKK)
              wgmma_m64n176k16_rs(acc2, y[kk], smem_desc(st + (ks / 2) * kBSlot, 16, 512) + 2 * (ks % 2), 1);
          }
          wgmma_commit();
          wgmma_wait<1>();
          if (q > 0) release(it - 1);
          ++it;
        }
        wgmma_wait<0>();
        fence_regs(acc2);
        release(it - 1);
        // stage acc2 + b2 once every thread of the warpgroup is done reading the previous k2's
        asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const int col = 8 * j + 2 * t, r = warp * 16 + lane / 4;
          const float2 b = *reinterpret_cast<const float2*>(&P.b2[col]);
          *reinterpret_cast<float2*>(sXw + r * kXStride + col) = make_float2(acc2[4 * j] + b.x, acc2[4 * j + 1] + b.y);
          *reinterpret_cast<float2*>(sXw + (r + 8) * kXStride + col) =
              make_float2(acc2[4 * j + 2] + b.x, acc2[4 * j + 3] + b.y);
        }
        asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
        epilogue2(sXw, P, out_n, p, p0, wg * 64, k1n * k2n, k1 * k2n + k2, m, lt);
      }
    }
  }
}

}  // namespace

// Returns 0 on success, the CUDA error code of a refused launch, or a
// negative sm90::tensor_map_error.
extern "C" int l4p_fused_upscale_bf16(const void* src, const void* w1T, const void* b1, const void* lnw,
                                      const void* lnb, const void* w2T, const void* b2, const void* hyper, void* out,
                                      int n, int p, int c, int d1, int d1p, int d2p, int k1, int k2, int m, float eps,
                                      void* stream) {
  if (n <= 0 || n > 65535 || p <= 0 || c <= 0 || c % kBox != 0 || d1 <= 0 || d1 > d1p || d1p != kD1P ||
      d2p != kD2P || k1 <= 0 || k2 <= 0 || k1 * k2 > kMaxK || m <= 0 || m > kMaxM)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap ts, tw1, tw2;
  int e = sm90::encode_bf16_3d(&ts, src, c, c, p, n, kBox, kRows);
  if (e == 0) e = sm90::encode_bf16_3d(&tw1, w1T, c, c, kD1P, k1, kBox, kHalf);
  if (e == 0) e = sm90::encode_bf16_3d(&tw2, w2T, kD1P, kD1P, kD2P, k2, kBox, kD2P);
  if (e != 0) return e;
  const cudaError_t err = cudaFuncSetAttribute(fused_upscale_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p + kRows - 1) / kRows, n);
  fused_upscale_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      ts, tw1, tw2, static_cast<const float*>(b1), static_cast<const float*>(lnw), static_cast<const float*>(lnb),
      static_cast<const float*>(b2), static_cast<const bf16*>(hyper), static_cast<float*>(out), p, c, d1, k1, k2, m,
      eps);
  return static_cast<int>(cudaGetLastError());
}
