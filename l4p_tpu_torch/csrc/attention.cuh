// Online-softmax self-attention device code shared by the port's kernels:
// o = softmax(q k^T * scale) v per (batch, head), on mma.sync m16n8k16.
//
// Used by csrc/flash_attention.cu (the encoder attention,
// l4p_tpu/ops/flash_attention.py:_attn_kernel) and csrc/fused_encoder.cu
// (the attention phase of the whole-encoder blocks,
// l4p_tpu/ops/fused_encoder.py:_encoder_kernel).
//
// What bounds it: tensor-core FLOPs, 4 * N^2 * D per (batch, head)
// (QK^T and PV, 2 FLOP per multiply-add). At the giant shape (B*H = 32,
// N = 2048, D = 88) that is 47 GFLOP against ~70 MB of q/k/v/o traffic,
// far above the card's ~295 FLOP/byte ridge. The TPU kernels keep one
// head's whole K/V in VMEM and run a plain softmax over all keys; a Hopper
// block has at most 227 KB of shared memory, so K/V stream in 64-key tiles
// with an online (running max / running sum) softmax. Scores and
// probabilities live in registers only; K/V tiles are double-buffered with
// cp.async so the next tile's load overlaps the current tile's math.
// wgmma/TMA and warp specialisation are left for a later revision.
//
// Layout: q (BH, Nq, D), k and v (BH, Nk, D), contiguous bf16. The output
// row r of (batch b, head h), bh = b * heads + h, starts at
// o + b * o_stride_b + h * o_stride_h + r * o_stride_row, so the caller
// picks (BH, Nq, D) or the token-major (B, Nq, heads * D) the next
// projection reads. D must be a multiple of 8 and at most 128; it is
// zero-padded in shared memory to DP in {64, 96, 128} (88 -> 96), which is
// exact: the pad columns contribute 0 to q.k and produce output columns
// that are never stored. Ragged Nq/Nk tails are masked.
//
// Numerics: scores, running max/sum and the output accumulator are fp32.
// Probabilities are cast to bf16 *unnormalised* before the PV product and
// the division by the row sum happens at the end; the TPU kernels cast the
// normalised probabilities instead, so bf16 results differ in low bits.

#pragma once

#include <math.h>

#include "mma_utils.cuh"

namespace l4p {
namespace attn {

constexpr int kBlockM = 64;  // query rows per block, 16 per warp
constexpr int kBlockN = 64;  // keys per K/V tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

// Copies rows [row0, row0 + kRows) of a (n, d) bf16 matrix into a shared
// tile of kRows x DP (row stride DP + 8), zero-filling rows >= n and
// columns >= d.
template <int DP, int kRows>
__device__ __forceinline__ void load_tile(__nv_bfloat16* tile, const __nv_bfloat16* src, int row0, int n,
                                          int d, int tid) {
  constexpr int kStride = DP + 8;
  constexpr int kChunks = DP / 8;  // 16-byte chunks per row
  for (int c = tid; c < kRows * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * 8;
    const int gr = row0 + r;
    const bool valid = gr < n && col < d;
    const __nv_bfloat16* g = valid ? src + static_cast<size_t>(gr) * d + col : src;
    cp_async_16(smem_addr(tile + r * kStride + col), g, valid ? 16 : 0);
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
    flash_attention_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                               const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int nq,
                               int nk, int d, float scale_log2, int heads, long long o_stride_b,
                               long long o_stride_h, int o_stride_row) {
  constexpr int kStride = DP + 8;  // +16 B per row: conflict-free ldmatrix
  constexpr int kSteps = DP / 16;  // k-steps of QK^T
  constexpr int kTilesS = kBlockN / 8;
  constexpr int kTilesO = DP / 8;

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sK = sQ + kBlockM * kStride;      // [2][kBlockN][kStride]
  __nv_bfloat16* sV = sK + 2 * kBlockN * kStride;  // [2][kBlockN][kStride]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int m0 = blockIdx.x * kBlockM;
  const size_t bh = blockIdx.y;
  const __nv_bfloat16* qb = q + bh * nq * d;
  const __nv_bfloat16* kb = k + bh * nk * d;
  const __nv_bfloat16* vb = v + bh * nk * d;
  __nv_bfloat16* ob = o + static_cast<long long>(bh / heads) * o_stride_b +
                      static_cast<long long>(bh % heads) * o_stride_h;

  load_tile<DP, kBlockM>(sQ, qb, m0, nq, d, tid);
  load_tile<DP, kBlockN>(sK, kb, 0, nk, d, tid);
  load_tile<DP, kBlockN>(sV, vb, 0, nk, d, tid);
  cp_async_commit();

  uint32_t qf[kSteps][4];
  float acc[kTilesO][4];
#pragma unroll
  for (int j = 0; j < kTilesO; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  // this thread's two rows: lane/4 and lane/4 + 8 of the warp's 16
  float row_max[2] = {-INFINITY, -INFINITY};
  float row_sum[2] = {0.f, 0.f};  // partial over this thread's columns

  const int n_tiles = (nk + kBlockN - 1) / kBlockN;
  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t & 1;
    if (t + 1 < n_tiles) {
      load_tile<DP, kBlockN>(sK + (stage ^ 1) * kBlockN * kStride, kb, (t + 1) * kBlockN, nk, d, tid);
      load_tile<DP, kBlockN>(sV + (stage ^ 1) * kBlockN * kStride, vb, (t + 1) * kBlockN, nk, d, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (t == 0) {
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks)
        ldmatrix_x4(qf[ks], smem_addr(sQ + (warp * 16 + (lane & 15)) * kStride + ks * 16 + (lane >> 4) * 8));
    }
    const __nv_bfloat16* sKt = sK + stage * kBlockN * kStride;
    const __nv_bfloat16* sVt = sV + stage * kBlockN * kStride;

    // S = Q K^T for the warp's 16 rows x 64 keys
    float s[kTilesS][4];
#pragma unroll
    for (int j = 0; j < kTilesS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
#pragma unroll
      for (int np = 0; np < kTilesS / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, smem_addr(sKt + (np * 16 + (lane & 7) + (lane >> 4) * 8) * kStride + ks * 16 +
                                 ((lane >> 3) & 1) * 8));
        mma_16816(s[2 * np], qf[ks], b[0], b[1]);
        mma_16816(s[2 * np + 1], qf[ks], b[2], b[3]);
      }
    }

    const int key0 = t * kBlockN;
    if (key0 + kBlockN > nk) {
#pragma unroll
      for (int j = 0; j < kTilesS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (key0 + j * 8 + (lane & 3) * 2 + (e & 1) >= nk) s[j][e] = -INFINITY;
    }

    // online softmax in base 2 (scale_log2 = scale * log2(e))
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < kTilesS; ++j) mt = fmaxf(mt, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      const float m_new = fmaxf(row_max[r], mt * scale_log2);
      const float alpha = exp2f(row_max[r] - m_new);
      row_max[r] = m_new;
      row_sum[r] *= alpha;
#pragma unroll
      for (int j = 0; j < kTilesO; ++j) {
        acc[j][2 * r] *= alpha;
        acc[j][2 * r + 1] *= alpha;
      }
#pragma unroll
      for (int j = 0; j < kTilesS; ++j) {
        s[j][2 * r] = exp2f(fmaf(s[j][2 * r], scale_log2, -m_new));
        s[j][2 * r + 1] = exp2f(fmaf(s[j][2 * r + 1], scale_log2, -m_new));
        row_sum[r] += s[j][2 * r] + s[j][2 * r + 1];
      }
    }

    // O += P V; the S accumulators are already laid out as A fragments
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16x2(s[2 * kk][0], s[2 * kk][1]), pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < DP / 16; ++dp) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, smem_addr(sVt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kStride + dp * 16 +
                                       (lane >> 4) * 8));
        mma_16816(acc[2 * dp], a, b[0], b[1]);
        mma_16816(acc[2 * dp + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // the next iteration's loads overwrite this stage
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = row_sum[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = 1.f / l;
  }
  const int row = m0 + warp * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < kTilesO; ++j) {
    const int col = j * 8 + (lane & 3) * 2;
    if (col < d) {
      if (row < nq)
        *reinterpret_cast<uint32_t*>(ob + static_cast<size_t>(row) * o_stride_row + col) =
            pack_bf16x2(acc[j][0] * inv[0], acc[j][1] * inv[0]);
      if (row + 8 < nq)
        *reinterpret_cast<uint32_t*>(ob + static_cast<size_t>(row + 8) * o_stride_row + col) =
            pack_bf16x2(acc[j][2] * inv[1], acc[j][3] * inv[1]);
    }
  }
}

template <int DP>
cudaError_t launch_attention(const void* q, const void* k, const void* v, void* o, int bh, int nq, int nk, int d,
                             float scale_log2, int heads, long long o_stride_b, long long o_stride_h,
                             int o_stride_row, cudaStream_t stream) {
  const int smem_bytes = (kBlockM + 4 * kBlockN) * (DP + 8) * static_cast<int>(sizeof(__nv_bfloat16));
  cudaError_t err = cudaFuncSetAttribute(flash_attention_fwd_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((nq + kBlockM - 1) / kBlockM, bh);
  flash_attention_fwd_kernel<DP><<<grid, kThreads, smem_bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), nq, nk, d, scale_log2, heads,
      o_stride_b, o_stride_h, o_stride_row);
  return cudaGetLastError();
}

}  // namespace attn
}  // namespace l4p
