// The SAM mask decoder's upscale + hypernetwork contraction for Hopper
// (sm_90a): fused_upscale_hypernet of l4p_tpu_torch/ops/fused_upscale.py.
//
// Replaces the Pallas TPU kernel l4p_tpu/ops/fused_upscale.py:_kernel. Per
// token of src (N, P, C) and deconv1 offset k1 (8 of them):
//   x1 = src . W1[k1] + b1 (C -> d1 = 352) -> LayerNorm(eps) -> GELU -> bf16
//   x2 = x1 . W2[k2] + b2 (d1 -> d2 = 176, for each of k2 = 4 offsets) ->
//        GELU -> bf16 -> out[m, k1, k2] = x2 . hyper[m] (M = 3 mask tokens).
//
// What bounds it: tensor-core FLOPs. At N = 128 queries, P = 2048 tokens,
// C = 1408 the two products are 2.08 + 1.04 = 3.1 TFLOP per call against
// ~738 MB of src and ~100 MB of output, ~3,700 FLOP/byte, far above the
// card's ~295 FLOP/byte ridge. The (N, P, k1 * d1) and (N, P, k1, k2 * d2)
// intermediates (3 GB and 6 GB in fp32) are what the XLA chain pays for in
// device memory; this kernel never writes them.
//
// Design: one block of 8 warps owns 64 tokens of one query and loops over
// the k1 offsets. Product 1 runs on mma.sync m16n8k16 from cp.async
// double-buffered 32-column chunks of the src tile and of W1[k1] (warps
// 4 row groups x 2 column halves of d1). Its epilogue adds b1, takes a
// two-pass LayerNorm over the d1 valid columns (row sums through shuffles
// and shared memory), applies the exact erf GELU and leaves the bf16 row
// block in shared memory as the A operand of product 2, whose B fragments
// (W2, 0.5 MB, L2-resident) are read from global memory. Product 2's
// epilogue adds b2, applies GELU, rounds to bf16 and contracts with the M
// hypernetwork vectors on the CUDA cores, so only the M logits per (token,
// k1, k2) leave the SM. The TPU kernel's 128-lane paddings and
// block-diagonal hypernetwork matrix are its layout, not the math: here d1
// is padded to a multiple of 32 and d2 to 16 (zero columns, exact), and
// the (k2, m) pairs are contracted directly. The src tile is re-read from
// L2 for each k1 (64 x 1408 bf16 = 180 KB per block); W1 streams from L2.
// wgmma/TMA and a resident src tile are left for a later revision.
//
// Layouts: src (N, P, C) bf16; w1T (k1, D1P, C) bf16; w2T (k2, D2P, D1P)
// bf16; b1, lnw, lnb (D1P) and b2 (D2P) fp32, zero-padded; hyper
// (N, M, D2P) bf16 zero-padded; out (N, M, P, k1, k2) fp32. C % 32 == 0,
// D1P <= 384, D2P <= 256, M <= 4; ragged P is masked.

#include <math.h>

#include "mma_utils.cuh"

namespace {

using namespace l4p;
using bf16 = __nv_bfloat16;

constexpr int kRows = 64;  // tokens per block
constexpr int kWarps = 8;  // 4 row groups of 16 x 2 column halves
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 32;  // C columns per product-1 stage
constexpr int kChunkStride = kChunk + 8;
constexpr int kMaxNT1 = 384 / 2 / 8;  // n8 tiles per warp in product 1
constexpr int kMaxNT2 = 256 / 2 / 8;  // n8 tiles per warp in product 2
constexpr int kMaxM = 4;

__device__ __forceinline__ float gelu_erf(float x) { return 0.5f * x * (1.f + erff(x * 0.70710678118654752f)); }

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

size_t smem_bytes(int d1p, int d2p) {
  return (2 * kRows * kChunkStride + 2 * d1p * kChunkStride + kRows * (d1p + 8)) * sizeof(bf16) +
         (kMaxM * d2p + 2 * 2 * kRows + 2 * kRows * kMaxM) * sizeof(float);
}

__global__ void __launch_bounds__(kThreads, 1)
    fused_upscale_kernel(const bf16* __restrict__ src, const bf16* __restrict__ w1T, const float* __restrict__ b1,
                         const float* __restrict__ lnw, const float* __restrict__ lnb, const bf16* __restrict__ w2T,
                         const float* __restrict__ b2, const bf16* __restrict__ hyper, float* __restrict__ out, int p,
                         int c, int d1, int d1p, int d2p, int k1n, int k2n, int m, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sA = reinterpret_cast<bf16*>(smem);         // [2][kRows][kChunkStride]
  bf16* sB = sA + 2 * kRows * kChunkStride;         // [2][d1p][kChunkStride]
  bf16* sY = sB + 2 * d1p * kChunkStride;           // [kRows][d1p + 8]
  float* sHyp = reinterpret_cast<float*>(sY + kRows * (d1p + 8));  // [kMaxM][d2p]
  float* sSum = sHyp + kMaxM * d2p;                 // [2 halves][kRows]
  float* sSq = sSum + 2 * kRows;                    // [2 halves][kRows]
  float* sDot = sSq + 2 * kRows;                    // [2 halves][kRows][kMaxM]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wr = warp & 3, wc = warp >> 2;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  const size_t n = blockIdx.y;
  const int p0 = blockIdx.x * kRows;
  const bf16* src_n = src + n * p * c;
  const int ys = d1p + 8;
  const int half1 = d1p / 2, half2 = d2p / 2;
  const int nt1 = half1 / 8, nt2 = half2 / 8;

  for (int i = tid; i < m * d2p; i += kThreads) sHyp[i] = __bfloat162float(hyper[n * m * d2p + i]);

  auto load_chunk = [&](int buf, const bf16* w1k, int kc) {
    for (int i = tid; i < kRows * (kChunk / 8); i += kThreads) {
      const int r = i / (kChunk / 8), col = (i % (kChunk / 8)) * 8;
      const bool valid = p0 + r < p;
      const bf16* gsrc = valid ? src_n + static_cast<size_t>(p0 + r) * c + kc + col : src_n;
      cp_async_16(smem_addr(sA + (buf * kRows + r) * kChunkStride + col), gsrc, valid ? 16 : 0);
    }
    for (int i = tid; i < d1p * (kChunk / 8); i += kThreads) {
      const int r = i / (kChunk / 8), col = (i % (kChunk / 8)) * 8;
      cp_async_16(smem_addr(sB + (buf * d1p + r) * kChunkStride + col), w1k + static_cast<size_t>(r) * c + kc + col,
                  16);
    }
    cp_async_commit();
  };

  const int n_chunks = c / kChunk;
  const int row_a = wr * 16 + g;  // this thread's rows in the block: row_a, row_a + 8
  for (int k1 = 0; k1 < k1n; ++k1) {
    // ---- product 1: x1 (64 x d1p) = src tile . W1[k1]
    const bf16* w1k = w1T + static_cast<size_t>(k1) * d1p * c;
    float acc1[kMaxNT1][4];
#pragma unroll
    for (int j = 0; j < kMaxNT1; ++j) acc1[j][0] = acc1[j][1] = acc1[j][2] = acc1[j][3] = 0.f;
    load_chunk(0, w1k, 0);
    for (int ch = 0; ch < n_chunks; ++ch) {
      const int buf = ch & 1;
      if (ch + 1 < n_chunks) {
        load_chunk(buf ^ 1, w1k, (ch + 1) * kChunk);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const bf16* a_t = sA + buf * kRows * kChunkStride;
      const bf16* b_t = sB + buf * d1p * kChunkStride;
#pragma unroll
      for (int ks = 0; ks < kChunk / 16; ++ks) {
        uint32_t a[4];
        ldmatrix_x4(a, smem_addr(a_t + (wr * 16 + (lane & 15)) * kChunkStride + ks * 16 + (lane >> 4) * 8));
#pragma unroll
        for (int np = 0; np < kMaxNT1 / 2; ++np) {
          if (2 * np < nt1) {
            uint32_t b[4];
            ldmatrix_x4(b, smem_addr(b_t + (wc * half1 + np * 16 + (lane & 7) + (lane >> 4) * 8) * kChunkStride +
                                     ks * 16 + ((lane >> 3) & 1) * 8));
            mma_16816(acc1[2 * np], a, b[0], b[1]);
            mma_16816(acc1[2 * np + 1], a, b[2], b[3]);
          }
        }
      }
      __syncthreads();  // the next iteration's loads overwrite this stage
    }

    // ---- epilogue 1: + b1, LayerNorm over the d1 valid columns, GELU -> sY (bf16)
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxNT1; ++j) {
      if (j < nt1) {
        const int col = wc * half1 + j * 8 + t2;
        acc1[j][0] += b1[col];
        acc1[j][1] += b1[col + 1];
        acc1[j][2] += b1[col];
        acc1[j][3] += b1[col + 1];
        s0 += acc1[j][0] + acc1[j][1];  // padded columns are exactly 0
        s1 += acc1[j][2] + acc1[j][3];
      }
    }
    s0 = quad_sum(s0);
    s1 = quad_sum(s1);
    if ((lane & 3) == 0) {
      sSum[wc * kRows + row_a] = s0;
      sSum[wc * kRows + row_a + 8] = s1;
    }
    __syncthreads();
    const float mean0 = (sSum[row_a] + sSum[kRows + row_a]) / d1;
    const float mean1 = (sSum[row_a + 8] + sSum[kRows + row_a + 8]) / d1;
    float q0 = 0.f, q1 = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxNT1; ++j) {
      if (j < nt1) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (wc * half1 + j * 8 + t2 + e < d1) {
            const float a0 = acc1[j][e] - mean0, a1 = acc1[j][2 + e] - mean1;
            q0 += a0 * a0;
            q1 += a1 * a1;
          }
        }
      }
    }
    q0 = quad_sum(q0);
    q1 = quad_sum(q1);
    if ((lane & 3) == 0) {
      sSq[wc * kRows + row_a] = q0;
      sSq[wc * kRows + row_a + 8] = q1;
    }
    __syncthreads();
    const float rstd0 = rsqrtf((sSq[row_a] + sSq[kRows + row_a]) / d1 + eps);
    const float rstd1 = rsqrtf((sSq[row_a + 8] + sSq[kRows + row_a + 8]) / d1 + eps);
#pragma unroll
    for (int j = 0; j < kMaxNT1; ++j) {
      if (j < nt1) {
        const int col = wc * half1 + j * 8 + t2;
        float y[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int cc = col + (e & 1);
          const float xn = (acc1[j][e] - (e < 2 ? mean0 : mean1)) * (e < 2 ? rstd0 : rstd1);
          y[e] = cc < d1 ? gelu_erf(xn * lnw[cc] + lnb[cc]) : 0.f;
        }
        *reinterpret_cast<uint32_t*>(sY + row_a * ys + col) = pack_bf16x2(y[0], y[1]);
        *reinterpret_cast<uint32_t*>(sY + (row_a + 8) * ys + col) = pack_bf16x2(y[2], y[3]);
      }
    }
    __syncthreads();

    // ---- product 2 per k2 offset: x2 (64 x d2p) = y . W2[k2], then GELU and the hypernet dot
    for (int k2 = 0; k2 < k2n; ++k2) {
      const bf16* w2k = w2T + static_cast<size_t>(k2) * d2p * d1p + static_cast<size_t>(wc * half2 + g) * d1p + t2;
      float acc2[kMaxNT2][4];
#pragma unroll
      for (int j = 0; j < kMaxNT2; ++j) acc2[j][0] = acc2[j][1] = acc2[j][2] = acc2[j][3] = 0.f;
      for (int ks = 0; ks < d1p / 16; ++ks) {
        uint32_t a[4];
        ldmatrix_x4(a, smem_addr(sY + (wr * 16 + (lane & 15)) * ys + ks * 16 + (lane >> 4) * 8));
#pragma unroll
        for (int j = 0; j < kMaxNT2; ++j) {
          if (j < nt2) {
            const bf16* b = w2k + static_cast<size_t>(j * 8) * d1p + ks * 16;
            mma_16816(acc2[j], a, ldg_u32(b), ldg_u32(b + 8));
          }
        }
      }
      float dot[2][kMaxM];
#pragma unroll
      for (int mm = 0; mm < kMaxM; ++mm) dot[0][mm] = dot[1][mm] = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxNT2; ++j) {
        if (j < nt2) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = wc * half2 + j * 8 + t2 + (e & 1);
            const float v = bf16_round(gelu_erf(acc2[j][e] + b2[col]));
#pragma unroll
            for (int mm = 0; mm < kMaxM; ++mm)
              if (mm < m) dot[e >> 1][mm] += v * sHyp[mm * d2p + col];
          }
        }
      }
#pragma unroll
      for (int mm = 0; mm < kMaxM; ++mm) {
        dot[0][mm] = quad_sum(dot[0][mm]);
        dot[1][mm] = quad_sum(dot[1][mm]);
      }
      if ((lane & 3) == 0) {
#pragma unroll
        for (int mm = 0; mm < kMaxM; ++mm) {
          sDot[(wc * kRows + row_a) * kMaxM + mm] = dot[0][mm];
          sDot[(wc * kRows + row_a + 8) * kMaxM + mm] = dot[1][mm];
        }
      }
      __syncthreads();
      for (int i = tid; i < kRows * m; i += kThreads) {
        const int r = i / m, mm = i % m;
        if (p0 + r < p) {
          const size_t o = ((n * m + mm) * p + p0 + r) * static_cast<size_t>(k1n * k2n) + k1 * k2n + k2;
          out[o] = sDot[r * kMaxM + mm] + sDot[(kRows + r) * kMaxM + mm];
        }
      }
      __syncthreads();
    }
  }
}

}  // namespace

// Returns 0 on success, else the CUDA error code of the refused launch.
extern "C" int l4p_fused_upscale_bf16(const void* src, const void* w1T, const void* b1, const void* lnw,
                                      const void* lnb, const void* w2T, const void* b2, const void* hyper, void* out,
                                      int n, int p, int c, int d1, int d1p, int d2p, int k1, int k2, int m, float eps,
                                      void* stream) {
  if (n <= 0 || n > 65535 || p <= 0 || c <= 0 || c % kChunk != 0 || d1 <= 0 || d1 > d1p || d1p % 32 != 0 ||
      d1p > 384 || d2p <= 0 || d2p % 16 != 0 || d2p > 256 || k1 <= 0 || k2 <= 0 || m <= 0 || m > kMaxM)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(d1p, d2p);
  cudaError_t err =
      cudaFuncSetAttribute(fused_upscale_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_upscale_kernel<<<dim3((p + kRows - 1) / kRows, n), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(src), static_cast<const bf16*>(w1T), static_cast<const float*>(b1),
      static_cast<const float*>(lnw), static_cast<const float*>(lnb), static_cast<const bf16*>(w2T),
      static_cast<const float*>(b2), static_cast<const bf16*>(hyper), static_cast<float*>(out), p, c, d1, d1p, d2p,
      k1, k2, m, eps);
  return static_cast<int>(cudaGetLastError());
}
