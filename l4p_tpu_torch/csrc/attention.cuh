// Self-attention device code shared by the port's kernels, designed for
// Hopper (sm_90a): o = softmax(q k^T * scale) v per (batch, head).
//
// Replaces the Pallas TPU kernel l4p_tpu/ops/flash_attention.py:_attn_kernel.
// Used by csrc/flash_attention.cu (the default encoder's attention) and
// csrc/fused_encoder.cu (the attention phase of the whole-encoder blocks,
// l4p_tpu/ops/fused_encoder.py:_encoder_kernel).
//
// What bounds it: tensor-core operations, 4 * N^2 * D per (batch, head)
// (Q K^T and P V, 2 per multiply-add). At the encoder's shape (B*H = 32,
// N = 2048, D = 88) that is 47 GFLOP against ~46 MB of q/k/v/o traffic, far
// above the card's ~295 FLOP/byte ridge. The TPU kernel holds one head's
// whole K/V in VMEM and runs a plain softmax over all keys; a Hopper block
// has at most 227 KB of shared memory, so K/V stream through a ring of
// shared-memory stages with an online (running max / running sum) softmax.
//
// Design (wgmma + TMA + a producer warpgroup; primitives in sm90.cuh):
// - one block owns 128 query rows of one (batch, head): two consumer
//   warpgroups of 64 rows each and a producer warpgroup (384 threads) whose
//   first thread issues every TMA load; the producer gives up registers
//   (setmaxnreg.dec 24) so that the consumers can take 240 (setmaxnreg.inc).
//   A lone producer warp cannot free what setmaxnreg.inc waits for.
// - Q (128 x D_pad) once, then K and V tiles of 128 keys, arrive by TMA from
//   3-D tensor maps (D, N, B*H): each tile is D_pad / 32 boxes of 32 columns
//   (64 bytes, the 64-byte swizzle span), so every 16-wide k-step of Q K^T
//   and every 32-wide atom of V lies inside one swizzle atom. The maps carry
//   the true D and N: columns D..D_pad and rows past N arrive as zeros and
//   never from the next head. K/V run through a ring of kStages stages,
//   each with a full barrier (the producer's expect_tx + the TMA bytes) and
//   an empty barrier (an arrival from each of the 256 consumer threads).
// - S = Q K^T: D_pad / 16 wgmma m64n128k16, both operands K-major in shared
//   memory. O += P V: 8 wgmma m64n{D_pad}k16 with P from registers (the S
//   accumulator cast to bf16 pairs: its fragment is the A fragment) and V as
//   an MN-major operand (the transpose bit), O in 48 fp32 registers.
// - Each consumer warpgroup issues S(t) together with P(t-1) V(t-1) and
//   runs the softmax of S(t) while the latter is in flight, and the two
//   warpgroups take turns to issue (two named barriers), once per tile
//   (FlashAttention-3's order). S, P and O are live at once: ptxas reports
//   the 168 registers of the launch budget and the consumers' branch gets
//   the 240 of setmaxnreg. At D_pad = 96: no spills, no serialised wgmma
//   (ptxas -v in the build log; C7512 would name a serialised one).
// - Shared memory at D_pad = 96: Q 24 KB + 3 stages x (K 24 KB + V 24 KB) =
//   168 KB, one block per SM. 3 stages measured best (2 leave no tile to
//   prefetch while two are held, 4 gained nothing), and the turns faster
//   than the overlap alone (scripts/attention_bounds.py, PERF.md).
// - What bounds it on the card (scripts/attention_bounds.py, PERF.md):
//   first the rows' alignment. TMA loads rows that start off a 32-byte
//   sector (D = 88: 176-byte rows) at ~1.3x the time, so the callers pad
//   rows to a multiple of 16 elements (pitch); with that it reaches ~45% of
//   the bf16 peak at D = 88. What is left: the softmax and the pipeline
//   around the products (the products alone run at ~60% of the peak).
// - The grid is (query tiles, B*H): B*H on y up to the grid's 65,535, and
//   past that split over z slices of equal height (Video Depth Anything's
//   temporal attention runs 78,144 sequences of 32 frames a call); a block
//   past the last pair returns before it touches a barrier. Such short
//   sequences fill a quarter of a 128-row tile.
// - D is a multiple of 8, at most 256, padded in shared memory to D_pad in
//   {64, 96, 128, 256} (88 -> 96); the pad columns are zeros, contribute 0
//   to q.k and give output columns that are not stored. Keys >= Nk are set
//   to -inf before the row max; rows >= Nq are not stored.
// - D_pad 256 (SAM 2's memory attention: one head of 256 over up to 28,736
//   keys) has its own key tile and ring depth (block_n, kv_stages): 128-key
//   tiles in 3 stages would need Q 64 KB + 3 x (K + V) 128 KB = 448 KB of
//   shared memory, and O alone is 128 fp32 registers a thread (m64n256). It
//   takes 64-key tiles in 2 stages: Q 64 KB + 2 x (32 + 32) KB = 192 KB, S
//   in 32 registers and P in 16 beside O's 128. S = Q K^T is then D_pad / 16
//   wgmma m64n64k16 and P V 4 wgmma m64n256k16. D_pad 64, 96 and 128 keep
//   128 keys in kStages stages, their code unchanged.
//
// Build-time hooks for scripts/attention_bounds.py only (each -D gives a
// kernel whose times mean something and whose results do not, except
// L4P_ATTN_KV_STAGES and L4P_ABLATE_NO_TURNS, which stay exact):
//   L4P_ATTN_KV_STAGES=n   the K/V ring depth up to D_pad 128 (default 3);
//   L4P_ABLATE_NO_TURNS    the warpgroups issue without taking turns;
//   L4P_ABLATE_NO_RELOAD   K/V tiles are loaded once; later tiles reuse them;
//   L4P_ABLATE_NO_EXP      the softmax's exponentials become a multiply;
//   L4P_ABLATE_NO_SOFTMAX  no softmax: P is S cast to bf16.

// Layout: q (BH, Nq, D), k and v (BH, Nk, D), bf16, 16-byte aligned, rows
// `pitch` >= D elements apart (a multiple of 8; heads Nq * pitch or Nk *
// pitch apart). Rows that start on 32-byte sectors (pitch a multiple of 16)
// run 1.3-1.4x faster than D = 88's 176-byte rows (PERF.md), so the callers
// pad: kernel_row_pitch in ops/flash_attention.py, the QKV epilogue of
// fused_encoder.cu. The output row r of (batch b, head h), bh = b * heads + h, starts
// at o + b * o_stride_b + h * o_stride_h + r * o_stride_row, so the caller
// picks (BH, Nq, D) or the token-major (B, Nq, heads * D) the next
// projection reads; it is written with plain 32-bit stores.
//
// Numerics: scores, running max/sum and the output accumulator are fp32, the
// softmax runs in base 2 (scale * log2(e)). Probabilities are cast to bf16
// *unnormalised* before the P V product and the division by the row sum
// happens at the end; the TPU kernel normalises P first, so bf16 results
// differ in low bits.

#pragma once

#include <math.h>

#include "sm90.cuh"

#ifndef L4P_ATTN_KV_STAGES
#define L4P_ATTN_KV_STAGES 3
#endif

namespace l4p {
namespace attn {

constexpr int kBlockM = 128;                   // query rows per block: two consumer warpgroups of 64
constexpr int kBlockN = 128;                   // keys per K/V tile up to D_pad 128
constexpr int kBlockN256 = 64;                 // keys per K/V tile at D_pad 256
constexpr int kStages256 = 2;                  // K/V ring depth at D_pad 256
constexpr int kBox = 32;                       // columns per TMA box: 64 bytes, the swizzle span
constexpr int kBoxBytes = kBlockN * kBox * 2;  // one box of 128 rows: Q's, and K/V's up to D_pad 128
constexpr int kConsumers = 2;                  // consumer warpgroups
constexpr int kConsumerThreads = kConsumers * 128;
constexpr int kThreads = kConsumerThreads + 128;  // and the producer warpgroup
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kStages = L4P_ATTN_KV_STAGES;  // K/V ring depth
constexpr int kMaxGridY = 65535;             // the grid's y (and z) limit
// the most (batch, head) pairs a launch takes: the grid arithmetic below
// (bh + kMaxGridY - 1, and z * y in the kernel) stays inside an int
constexpr int kMaxBH = 0x7fffffff - kMaxGridY + 1;
#ifdef L4P_ABLATE_NO_TURNS
constexpr bool kTurns = false;
#else
constexpr bool kTurns = true;
#endif

// keys per K/V tile and the ring's depth at head width DP
template <int DP>
__host__ __device__ constexpr int block_n() {
  return DP <= 128 ? kBlockN : kBlockN256;
}
template <int DP>
__host__ __device__ constexpr int kv_stages() {
  return DP <= 128 ? kStages : kStages256;
}

template <int DP>
constexpr int smem_bytes() {
  // Q + the ring, the barriers, and slack to align the buffers to 1024 bytes
  constexpr int q_tile = (DP / kBox) * kBlockM * kBox * 2, kv_tile = (DP / kBox) * block_n<DP>() * kBox * 2;
  return q_tile + 2 * kv_stages<DP>() * kv_tile + (1 + 2 * kv_stages<DP>()) * 8 + 1024;
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
#ifdef L4P_ABLATE_NO_EXP
  y = x * 0.5f;
#else
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
#endif
  return y;
}

// One Q, K or V tile: DP / 32 boxes of 32 columns x ROWS rows from row0 of bh.
template <int DP, int ROWS>
__device__ __forceinline__ void load_tile(unsigned char* dst, const CUtensorMap* map, uint64_t* bar, int row0,
                                          int bh) {
#pragma unroll
  for (int j = 0; j < DP / kBox; ++j) sm90::tma_load_3d(dst + j * ROWS * kBox * 2, map, bar, j * kBox, row0, bh);
}

// S = Q K^T for the warpgroup's 64 rows x BN keys: DP / 16 k-steps, each in
// one box (k-step ks: box ks / 2, 32 bytes into its 64-byte rows for odd ks;
// a box of Q holds kBlockM rows, one of K BN rows).
template <int DP, int BN>
__device__ __forceinline__ void issue_s(float (&sc)[BN / 2], uint64_t desc_q, uint64_t desc_k) {
  sm90::wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < DP / 16; ++ks) {
    const uint32_t off_q = ((ks / 2) * kBoxBytes + (ks % 2) * 32) >> 4;
    const uint32_t off_k = ((ks / 2) * BN * kBox * 2 + (ks % 2) * 32) >> 4;
    if constexpr (BN == 128)
      sm90::wgmma_m64n128k16_ss(sc, desc_q + off_q, desc_k + off_k, ks);
    else
      sm90::wgmma_m64n64k16_ss(sc, desc_q + off_q, desc_k + off_k, ks);
  }
  sm90::wgmma_commit();
}

// O += P V: k-step kk reads keys 16kk.. of V (16 rows x 64 bytes in).
template <int DP, int BN>
__device__ __forceinline__ void issue_pv(float (&acc)[DP / 2], const uint32_t (&p)[BN / 16][4], uint64_t desc_v) {
  sm90::fence_regs(acc);
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) sm90::wgmma_rs<DP>(acc, p[kk], desc_v + ((kk * 16 * 64) >> 4));
  sm90::wgmma_commit();
}

// The online softmax of one S tile in base 2: keys >= nk to -inf, the new
// running max, sc <- exp2(s * scale_log2 - max), the running sum; returns in
// alpha the factor O must be rescaled by before this tile's P V.
template <int BN>
__device__ __forceinline__ void online_softmax(float (&sc)[BN / 2], float (&row_max)[2], float (&row_sum)[2],
                                               float (&alpha)[2], int key0, int nk, float scale_log2, int lane) {
#ifdef L4P_ABLATE_NO_SOFTMAX
  alpha[0] = alpha[1] = 1.f;
  row_sum[0] += 1.f;
  row_sum[1] += 1.f;
#else
  // sc[i] holds column (i / 4) * 8 + (lane % 4) * 2 + (i & 1) of the tile
  const int limit = nk - key0 - (lane % 4) * 2;
  if (limit < BN) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i)
      if ((i / 4) * 8 + (i & 1) >= limit) sc[i] = -INFINITY;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // four partial maxima and sums: short dependency chains
    float mx[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
      mx[j % 4] = fmaxf(mx[j % 4], fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
    float mt = fmaxf(fmaxf(mx[0], mx[1]), fmaxf(mx[2], mx[3]));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    const float m_new = fmaxf(row_max[r], mt * scale_log2);
    alpha[r] = fast_exp2(row_max[r] - m_new);
    row_max[r] = m_new;
    float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      sc[4 * j + 2 * r] = fast_exp2(fmaf(sc[4 * j + 2 * r], scale_log2, -m_new));
      sc[4 * j + 2 * r + 1] = fast_exp2(fmaf(sc[4 * j + 2 * r + 1], scale_log2, -m_new));
      sum[j % 4] += sc[4 * j + 2 * r] + sc[4 * j + 2 * r + 1];
    }
    row_sum[r] = row_sum[r] * alpha[r] + ((sum[0] + sum[1]) + (sum[2] + sum[3]));
  }
#endif
}

template <int N>
__device__ __forceinline__ void rescale(float (&acc)[N], const float (&alpha)[2]) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    acc[4 * j] *= alpha[0];
    acc[4 * j + 1] *= alpha[0];
    acc[4 * j + 2] *= alpha[1];
    acc[4 * j + 3] *= alpha[1];
  }
}

// P as A fragments: k-step kk takes the S column chunks 2kk and 2kk + 1.
template <int BN>
__device__ __forceinline__ void pack_p(uint32_t (&p)[BN / 16][4], const float (&sc)[BN / 2]) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    p[kk][0] = pack_bf16x2(sc[8 * kk], sc[8 * kk + 1]);
    p[kk][1] = pack_bf16x2(sc[8 * kk + 2], sc[8 * kk + 3]);
    p[kk][2] = pack_bf16x2(sc[8 * kk + 4], sc[8 * kk + 5]);
    p[kk][3] = pack_bf16x2(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
}

// Named barrier `id` (1 or 2: warpgroup id - 1's turn to issue) over both
// consumer warpgroups: sync waits for the other's arrival.
__device__ __forceinline__ void turn_wait(int id) {
  if (kTurns) asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kConsumerThreads) : "memory");
}
__device__ __forceinline__ void turn_pass(int id) {
  if (kTurns) asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(kConsumerThreads) : "memory");
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
    attention_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o, int bh_count, int nq,
                     int nk, int d, float scale_log2, int heads, long long o_stride_b, long long o_stride_h,
                     int o_stride_row) {
  using namespace sm90;
  constexpr int BN = block_n<DP>();             // keys per K/V tile
  constexpr int S = kv_stages<DP>();            // K/V ring depth
  constexpr int kQTile = DP / kBox * kBoxBytes;  // bytes of the Q tile
  constexpr int kTile = DP / kBox * BN * kBox * 2;  // bytes of one K or V tile
  constexpr int kAcc = DP / 2;                  // O accumulators per thread (m64nDP)
  constexpr int kLoader = kConsumerThreads;     // the producer thread that issues every TMA load
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* sQ = smem;
  unsigned char* sKV = smem + kQTile;  // stage s: K at sKV + 2 s kTile, V right after it
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + kQTile + 2 * S * kTile);
  uint64_t* full = q_full + 1;       // a stage's K and V arrived
  uint64_t* empty = q_full + 1 + S;  // both consumer warpgroups are done with a stage

  const int m0 = blockIdx.x * kBlockM;
  const int bh = blockIdx.z * gridDim.y + blockIdx.y;  // (batch, head) pairs past the grid's y run on along z
  if (bh >= bh_count) return;                          // the last z slice's spare blocks, before any barrier
  const int n_tiles = (nk + BN - 1) / BN;

  if (threadIdx.x == kLoader) {
    prefetch_tensor_map(&tm_q);
    prefetch_tensor_map(&tm_k);
    prefetch_tensor_map(&tm_v);
    mbar_init(q_full, 1);
    for (int s = 0; s < S; ++s) {
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
      mbar_arrive_expect_tx(q_full, kQTile);
      load_tile<DP, kBlockM>(sQ, &tm_q, q_full, m0, bh);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % S;
        if (t >= S) mbar_wait(&empty[s], (t / S - 1) & 1);
#ifdef L4P_ABLATE_NO_RELOAD
        if (t >= S) {
          mbar_arrive(&full[s]);
          continue;
        }
#endif
        mbar_arrive_expect_tx(&full[s], 2 * kTile);
        load_tile<DP, BN>(sKV + 2 * s * kTile, &tm_k, &full[s], t * BN, bh);
        load_tile<DP, BN>(sKV + (2 * s + 1) * kTile, &tm_v, &full[s], t * BN, bh);
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;

    float acc[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
    // this thread's two rows: lane/4 and lane/4 + 8 of the warp's 16
    float row_max[2] = {-INFINITY, -INFINITY};
    float row_sum[2] = {0.f, 0.f};  // partial over this thread's columns
    float alpha[2];
    float sc[BN / 2];
    uint32_t p[BN / 16][4];

    // this warpgroup's 64 Q rows start 64 rows x 64 bytes into every box
    const uint64_t desc_q = smem_desc(sQ + wg * 64 * 64, 16, 512);
    auto desc_k = [&](int t) { return smem_desc(sKV + 2 * (t % S) * kTile, 16, 512); };
    auto desc_v = [&](int t) { return smem_desc(sKV + (2 * (t % S) + 1) * kTile, BN * kBox * 2, 512); };
    mbar_wait(q_full, 0);

    // warpgroup wg issues on turn barrier 1 + wg and passes the turn to the
    // other's once per tile; the first warpgroup starts, the second does not
    // pass after its last issue
    if (wg == 1) turn_pass(1);
    mbar_wait(&full[0], 0);
    turn_wait(1 + wg);
    issue_s<DP, BN>(sc, desc_q, desc_k(0));
    if (wg == 0 || n_tiles > 1) turn_pass(2 - wg);
    wgmma_wait<0>();
    fence_regs(sc);
    online_softmax<BN>(sc, row_max, row_sum, alpha, 0, nk, scale_log2, lane);
    pack_p<BN>(p, sc);
    for (int t = 1; t < n_tiles; ++t) {
      mbar_wait(&full[t % S], (t / S) & 1);
      turn_wait(1 + wg);
      issue_s<DP, BN>(sc, desc_q, desc_k(t));
      rescale(acc, alpha);
      issue_pv<DP, BN>(acc, p, desc_v(t - 1));
      if (wg == 0 || t + 1 < n_tiles) turn_pass(2 - wg);
      wgmma_wait<1>();  // S(t) done; P(t-1) V(t-1) may still run
      fence_regs(sc);
      online_softmax<BN>(sc, row_max, row_sum, alpha, t * BN, nk, scale_log2, lane);
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(&empty[(t - 1) % S]);
      pack_p<BN>(p, sc);
    }
    rescale(acc, alpha);
    issue_pv<DP, BN>(acc, p, desc_v(n_tiles - 1));
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(&empty[(n_tiles - 1) % S]);

    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = row_sum[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      inv[r] = 1.f / l;
    }
    __nv_bfloat16* ob = o + static_cast<long long>(bh / heads) * o_stride_b +
                        static_cast<long long>(bh % heads) * o_stride_h;
    const int row = m0 + wg * 64 + warp * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = j * 8 + (lane % 4) * 2;
      if (col < d) {
        if (row < nq)
          *reinterpret_cast<uint32_t*>(ob + static_cast<size_t>(row) * o_stride_row + col) =
              pack_bf16x2(acc[4 * j] * inv[0], acc[4 * j + 1] * inv[0]);
        if (row + 8 < nq)
          *reinterpret_cast<uint32_t*>(ob + static_cast<size_t>(row + 8) * o_stride_row + col) =
              pack_bf16x2(acc[4 * j + 2] * inv[1], acc[4 * j + 3] * inv[1]);
      }
    }
  }
}

// Encodes the three tensor maps and launches; returns 0, a cudaError_t of a
// refused launch, or a negative sm90::tensor_map_error.
template <int DP>
int launch_attention(const void* q, const void* k, const void* v, void* o, int bh, int nq, int nk, int d, int pitch,
                     float scale_log2, int heads, long long o_stride_b, long long o_stride_h, int o_stride_row,
                     cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int err = sm90::encode_bf16_3d(&tq, q, d, pitch, nq, bh, kBox, kBlockM);
  if (err == 0) err = sm90::encode_bf16_3d(&tk, k, d, pitch, nk, bh, kBox, block_n<DP>());
  if (err == 0) err = sm90::encode_bf16_3d(&tv, v, d, pitch, nk, bh, kBox, block_n<DP>());
  if (err != 0) return err;
  constexpr int smem = smem_bytes<DP>();
  auto* kernel = attention_kernel<DP>;
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  // B*H on y while it fits (one z slice, as every shape up to 65,535 pairs had), else split evenly over z
  const int z = (bh + kMaxGridY - 1) / kMaxGridY;
  const dim3 grid((nq + kBlockM - 1) / kBlockM, (bh + z - 1) / z, z);
  kernel<<<grid, kThreads, smem, stream>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(o), bh, nq, nk, d, scale_log2,
                                           heads, o_stride_b, o_stride_h, o_stride_row);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace attn
}  // namespace l4p
