// The two-way transformer's image side for Hopper (sm_90a): t2i_flash and
// i2t_ln_t2i of l4p_tpu_torch/ops/fused_keys.py.
//
// Replaces the Pallas TPU kernels l4p_tpu/ops/fused_keys.py:_t2i_kernel
// (with _t2i_update) and :_i2t_t2i_kernel. Both stream the per-query image
// embedding `keys` (N, P, C) = (128, 2048, 1408) bf16, ~738 MB per window,
// against ~48 token columns (K = 8 heads x 6 tokens), so their products are
// rank-48: ~35 GFLOP per keys pass against 738 MB, ~48 FLOP/byte, well
// below the card's ~295 FLOP/byte ridge. Their bound is device-memory
// bandwidth: the passes over `keys`.
//
// The TPU kernels keep a (K, C) = (48, 1408) fp32 accumulator (270 KB of
// VMEM) across a sequential grid over P, and the i2t LayerNorm needs whole
// 1408-wide rows. Here that accumulator is spread over a thread-block
// cluster: one cluster of S blocks per (query, split of P), each block
// owning W = C / S columns (S = 8, W = 176 at C = 1408; 16 blocks where
// C / 8 is wider than the kernel's registers take):
//   - resident in each block for its whole life: its columns of the token
//     operands (rT, v2, sT, and ob, lnw, lnb), loaded once;
//   - its columns of 128-row keys tiles stream through a 2-stage TMA ring
//     (boxes of 16 columns, 32-byte swizzle), each tile's load issued while
//     the previous tiles are computed, so loads run across the cluster
//     barriers below;
//   - per tile (8 warps, 16 rows each, mma.sync): the partial i2t logits
//     keys . rT over the block's columns; a reduce-scatter of the
//     (128 x K) fp32 partials through distributed shared memory (each block
//     sums 128 / S rows over the cluster), after which the owner takes each
//     head's softmax over its tokens (fp32, normalised, cast to bf16) and
//     writes the probabilities into every block; y = keys + attn . v2 + ob
//     in fp32 registers; the LayerNorm's moments over C, two-pass within a
//     block and combined across the cluster with Chan's formula in one
//     exchange; the new keys written over the tile in shared memory and
//     stored by TMA; the partial next t2i logits keys_new . sT, reduced the
//     same way; then every block takes the tile's column maxima, and with
//     a running max m and sum l per token (fp32) adds exp(logit - m) (as a
//     bf16 hi + lo pair, below) times the tile into its (K2 x W) fp32
//     accumulator in registers, as _t2i_update does;
//   - t2i_flash is the same kernel without the i2t front and the store;
//     with two stages it runs the previous tile's softmax and accumulation
//     between arriving at and waiting on the cluster barrier after a tile's
//     logits, so the two overlap.
//   A cluster writes wsum = acc / l for its columns, or, where P is split
//   over clusters to fill the card (few queries), (m, l, acc) partials that
//   t2i_combine rescales and adds.
//
// Passes over keys (each 738 MB at the giant shape): t2i_flash reads it
// once; i2t_ln_t2i reads it once and writes the new keys once, which are
// never read back: 1 + 2 + 2 = 5 per window, the TPU kernels' count. The
// logits never leave the cluster.
//
// What bounds them on the card (scripts/keys_bounds.py, PERF.md): not the
// bytes. The keys stream alone runs near the memory rate, but each 128-row
// tile is a chain of dependent steps (products, 5 cluster barriers for
// i2t_ln_t2i and 2 for t2i_flash, owner reductions, the softmaxes) run by
// the 8 warps of the one block an SM holds (shared memory: the ring and the
// resident token operands), so a tile takes ~63,000 cycles of i2t_ln_t2i
// and ~20,000 of t2i_flash (keys_bounds.py --clocks), ~10x and ~7x what
// its keys traffic takes at the memory rate. Spreading a block over 16
// warps (the columns split in halves) spilled at 128 registers and ran
// slower.
//
// Build-time hooks for scripts/keys_bounds.py only (each -D gives a build
// whose times mean something and whose results do not; each stops
// i2t_ln_t2i's tile after one more part):
//   L4P_KEYS_LOADS_ONLY      the keys tiles stream through the ring;
//   L4P_KEYS_NO_V2           ... and the i2t logits and their reduction;
//   L4P_KEYS_NO_LN           ... and y = keys + attn . v2 + ob;
//   L4P_KEYS_NO_NEXT_LOGITS  ... and the LayerNorm and the new keys' store;
//   L4P_KEYS_NO_ACC          ... and the next t2i logits and their reduction;
//   L4P_KEYS_NO_COMBINE      t2i_combine left out (P split over clusters);
//   L4P_KEYS_CLOCKS          thread 0 of each block counts each part's cycles
//                            (clock64) and query 0's first cluster writes
//                            them over its wsum.
//
// Numerics: logits, softmax statistics, accumulators, residual and
// LayerNorm are fp32; the i2t probabilities are normalised then cast to
// bf16 (the TPU kernel's point). The t2i exponentials (unnormalised, as the
// TPU kernel takes them) enter the weighted-sum product as a bf16 pair, hi
// = bf16(e) and lo = bf16(e - hi), with l the fp32 sum of the pairs: ~16
// significant bits where the TPU kernel and the plain version round to
// bf16's 8, one product more per tile. (With one bf16 each the kernel path's
// tracks moved farther from an fp32 attention than the plain path's on
// chip_smoke's witness requests; PERF.md.) Requires C % 16 == 0 and
// K, K2 multiples of 16 up to 64; ragged P is masked.

#include <math.h>

#include "sm90.cuh"

namespace {

using namespace l4p;
using namespace l4p::sm90;
using bf16 = __nv_bfloat16;

constexpr int kMaxK = 64;
constexpr int kRows = 128;  // keys rows per tile: 8 warps x 16
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBoxCols = 16;                      // a TMA box: 16 columns (32 bytes) x 128 rows
constexpr int kBoxBytes = kRows * kBoxCols * 2;  // 4096
constexpr int kPortableCluster = 8;
constexpr int kMaxCluster = 16;
constexpr int kKS = 11;      // k16 column steps a block takes: W <= 176
constexpr int kKSWide = 24;  // t2i_flash beyond that: W <= 384 (16 blocks, C <= 6144)
constexpr int kMaxSmem = 232448;
constexpr int kClockParts = 11;  // the parts L4P_KEYS_CLOCKS times (scripts/keys_bounds.py --clocks)
constexpr int kStop =  // the part after which the hooks stop i2t_ln_t2i's tile (6: none)
#if defined(L4P_KEYS_LOADS_ONLY)
    1;
#elif defined(L4P_KEYS_NO_V2)
    2;
#elif defined(L4P_KEYS_NO_LN)
    3;
#elif defined(L4P_KEYS_NO_NEXT_LOGITS)
    4;
#elif defined(L4P_KEYS_NO_ACC)
    5;
#else
    6;
#endif

// One launch's cluster and shared-memory layout (byte offsets from a
// 1024-aligned base); the same on the host and in every block.
struct Plan {
  int s;       // blocks per cluster
  int ks;      // k16 column steps per block (the last block may own fewer)
  int w;       // columns per block, 16 * ks
  int rpo;     // tile rows each block reduces: ceil(128 / s) up to a multiple of 4
  int ldr;     // the reduce buffer's row stride in floats: max(K, K2) + 2, so rows fall on other banks
  int stages;  // ring stages
  int ring, rt, v2, st, vec, pre, red, xbuf, et, mom, stat, bar, total;
};

// The kernel's other operands. rT, sT: (N, K|K2, C); v2T: (N, C, K);
// per, spe: (N, P, K|K2) fp32; ob, lnw, lnb: (C) fp32; wsum (N, K2, C) or,
// with P split, partials acc_ws (N, splits, K2, C), m_ws and l_ws (N,
// splits, K2), all fp32.
struct Args {
  const bf16* rT;
  const float* per;
  const bf16* v2T;
  const float* ob;
  const float* lnw;
  const float* lnb;
  const bf16* sT;
  const float* spe;
  float* wsum;
  float* acc_ws;
  float* m_ws;
  float* l_ws;
  int p, c, k, k2, q, split;
  float eps;
};

Plan make_plan(bool i2t, int c, int k, int k2, int stages) {
  Plan q{};
  const int cw = c / 16;
  q.ks = (cw + kPortableCluster - 1) / kPortableCluster;
  if (q.ks > kKS) q.ks = (cw + kMaxCluster - 1) / kMaxCluster;
  q.s = (cw + q.ks - 1) / q.ks;
  q.w = 16 * q.ks;
  q.rpo = ((kRows + q.s - 1) / q.s + 3) / 4 * 4;
  q.ldr = (i2t && k > k2 ? k : k2) + 2;
  q.stages = stages;
  int off = 0;
  auto take = [&](int bytes, int align) {
    off = (off + align - 1) / align * align;
    const int at = off;
    off += bytes;
    return at;
  };
  q.ring = take(stages * q.ks * kBoxBytes, 1024);
  q.rt = i2t ? take(k * (q.w + 8) * 2, 16) : 0;
  q.v2 = i2t ? take(q.w * (k + 8) * 2, 16) : 0;
  q.st = take(k2 * (q.w + 8) * 2, 16);
  q.vec = i2t ? take(3 * q.w * 4, 16) : 0;
  q.pre = take(q.rpo * ((i2t ? k + 4 : 0) + k2 + 4) * 4, 16);
  q.red = take(q.s * q.rpo * q.ldr * 4, 16);
  // the i2t probabilities (128, K + 8) bf16, then the next logits token-major
  // (K2, 132) fp32; their exponentials as bf16 hi and lo parts, 2 x (K2, 136)
  const int attn_bytes = i2t ? kRows * (k + 8) * 2 : 0, lg_bytes = k2 * (kRows + 4) * 4;
  const int et_bytes = 2 * k2 * (kRows + 8) * 2;  // the exponentials' bf16 hi and lo parts
  q.xbuf = take(max(max(lg_bytes, attn_bytes), i2t || stages == 1 ? et_bytes : 0), 16);
  // without the window (i2t_ln_t2i, or one stage) the exponentials take xbuf's place
  q.et = !i2t && stages == 2 ? take(et_bytes, 16) : q.xbuf;
  q.mom = i2t ? take(q.s * kRows * 8, 16) : 0;
  q.stat = take(3 * kMaxK * 4, 16);
  q.bar = take(stages * 8, 8);
  q.total = off + 1024;  // and the slack to align the base
  return q;
}

// Byte offset of 16-byte half h of row r in a box of 32-byte rows with
// 32-byte swizzle (the box 256-byte aligned).
__device__ __forceinline__ uint32_t sw32(int r, int h) { return r * 32 + ((h ^ (r >> 2)) & 1) * 16; }

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// Copies `rows` rows of columns [c0, c0 + nv) of a (rows, c) bf16 matrix
// into a (rows, ld) shared matrix (cp.async; the caller waits).
__device__ void load_cols(bf16* dst, const bf16* src, int rows, int c, int c0, int nv, int ld) {
  const int chunks = nv / 8;
  for (int i = threadIdx.x; i < rows * chunks; i += kThreads) {
    const int r = i / chunks, cc = (i % chunks) * 8;
    cp_async_16(smem_addr(dst + r * ld + cc), src + static_cast<size_t>(r) * c + c0 + cc, 16);
  }
}

// Copies `items` 16-byte chunks of this block's shared memory, chunk i at
// byte offset off(i) from `base`, to the same place in the cluster's other
// s - 1 blocks.
template <class Off>
__device__ __forceinline__ void copy_out(const unsigned char* base, int items, Off off, int s, uint32_t rank) {
  for (int i = threadIdx.x; i < items; i += kThreads) {
    const int o = off(i);
    const uint4 v = *reinterpret_cast<const uint4*>(base + o);
    for (int d = 1; d < s; ++d) {
      const int dst = static_cast<int>(rank) + d < s ? static_cast<int>(rank) + d : static_cast<int>(rank) + d - s;
      st_cluster_v4(map_shared(base, dst) + o, v);
    }
  }
}

// acc[j] = this block's part of the tile's logits for its warp's 16 rows:
// rows 16 warp + g (+ 8), tokens 8j + 2t (+ 1); the tile's kv column boxes
// against bT (tokens x columns, row stride ldb) in shared memory.
template <int KS>
__device__ __forceinline__ void tile_logits(float (&acc)[kMaxK / 8][4], const unsigned char* tile, const bf16* bT,
                                            int ldb, int tokens, int kv) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < kMaxK / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    if (s >= kv) break;
    uint32_t a[4];
    ldmatrix_x4(a, smem_addr(tile + s * kBoxBytes + sw32(warp * 16 + (lane & 15), lane >> 4)));
#pragma unroll
    for (int j = 0; j < kMaxK / 8; j += 2) {
      if (j * 8 < tokens) {
        uint32_t b[4];
        ldmatrix_x4(b, smem_addr(bT + (j * 8 + (lane & 7) + ((lane >> 4) << 3)) * ldb + s * 16 +
                                 ((lane >> 3) & 1) * 8));
        mma_16816(acc[j], a, b[0], b[1]);
        mma_16816(acc[j + 1], a, b[2], b[3]);
      }
    }
  }
}

// Writes the warp's partial logits into the reduce buffer of each row's
// owner block: red[rank][row - owner * rpo][token] there (row stride ldr).
__device__ __forceinline__ void send_partials(const float (&acc)[kMaxK / 8][4], const float* red, int tokens,
                                              int rpo, int ldr, uint32_t rank) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = warp * 16 + g + 8 * h, owner = row / rpo;
    const uint32_t base = map_shared(red, owner) + ((rank * rpo + row - owner * rpo) * ldr + 2 * t) * 4;
#pragma unroll
    for (int j = 0; j < kMaxK / 8; ++j)
      if (j * 8 < tokens) st_cluster_f32x2(base + j * 32, acc[j][2 * h], acc[j][2 * h + 1]);
  }
}

// One cluster per (query n, split sp of P); grid (s, splits, n), 256
// threads. kI2T: i2t_ln_t2i (else t2i_flash); KS: the k16 column steps a
// block's registers hold (y, the accumulator); MT2: the m16 tiles of K2
// the accumulator holds (K2 <= 16 MT2).
template <bool kI2T, int KS, int MT2>
__global__ void __launch_bounds__(kThreads, 1)
    keys_cluster_kernel(const __grid_constant__ CUtensorMap tm_keys, const __grid_constant__ CUtensorMap tm_new,
                        const Plan q, const Args a) {
  constexpr int kChunks = (2 * KS + kWarps - 1) / kWarps;  // n8 accumulator column chunks per warp
  constexpr int kStopAt = kI2T ? kStop : (kStop == 1 ? 1 : kStop >= 5 ? kStop : 6);
  // t2i_flash with two stages runs the previous tile's accumulation (and the
  // next tile's load into its stage) inside the cluster barrier after a
  // tile's logits ("the window"); i2t_ln_t2i loads the next tile after its
  // i2t reduction (by then the previous tile's store has read the stage).
  constexpr bool kWindow = !kI2T && kStopAt >= 5;
  const bool windowed = kWindow && q.stages == 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const uint32_t rank = cluster_rank();
  const int n = blockIdx.z, sp = blockIdx.y, splits = gridDim.y;
  const int c = a.c, k = a.k, k2 = a.k2;
  const int c0 = rank * q.w;
  const int nv = min(q.w, c - c0);  // this block's columns, a multiple of 16
  const int kv = nv / 16;
  const int p_lo = sp * a.split, p_hi = min(a.p, p_lo + a.split);
  const int tiles = (p_hi - p_lo + kRows - 1) / kRows;
  const int ldw = q.w + 8, ldk = k + 8, ldl = kRows + 4, lde = kRows + 8, ldp = k + 4, lds = k2 + 4;
  unsigned char* ring = smem + q.ring;
  bf16* rT_s = reinterpret_cast<bf16*>(smem + q.rt);
  bf16* v2_s = reinterpret_cast<bf16*>(smem + q.v2);
  bf16* sT_s = reinterpret_cast<bf16*>(smem + q.st);
  float* vec_s = reinterpret_cast<float*>(smem + q.vec);  // ob, lnw, lnb
  float* per_s = reinterpret_cast<float*>(smem + q.pre);  // this block's reduced rows of per, then spe
  float* spe_s = per_s + (kI2T ? q.rpo * ldp : 0);
  float* red = reinterpret_cast<float*>(smem + q.red);
  bf16* attn = reinterpret_cast<bf16*>(smem + q.xbuf);   // i2t probabilities (kRows, ldk)
  float* lg2T = reinterpret_cast<float*>(smem + q.xbuf);  // next logits (k2, ldl), after attn's use
  bf16* eT = reinterpret_cast<bf16*>(smem + q.et);        // their exponentials (k2, lde)
  float2* mom = reinterpret_cast<float2*>(smem + q.mom);
  float* m_run = reinterpret_cast<float*>(smem + q.stat);
  float* l_run = m_run + kMaxK;
  float* alpha = l_run + kMaxK;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + q.bar);
  const int my_rows = rank * q.rpo;  // the tile rows this block reduces
  const int own = min(q.rpo, kRows - my_rows);
#ifdef L4P_KEYS_CLOCKS
  long long ticks[kClockParts] = {}, tick_last = clock64();
#define L4P_TICK(i)                  \
  if (tid == 0) {                    \
    const long long now = clock64(); \
    ticks[i] += now - tick_last;     \
    tick_last = now;                 \
  }
#else
#define L4P_TICK(i)
#endif

  if (tid == 0) {
    prefetch_tensor_map(&tm_keys);
    if (kI2T) prefetch_tensor_map(&tm_new);
    for (int s = 0; s < q.stages; ++s) mbar_init(&full[s], 1);
    fence_barrier_init();
  }
  // this block's reduced rows of per and spe for tile tt (zero past P), by cp.async
  auto prefetch_rows = [&](int tt) {
    const int kc = kI2T ? k / 4 : 0, kc2 = k2 / 4;  // 16-byte chunks per row
    const int row0 = p_lo + tt * kRows + my_rows;
    for (int i = tid; i < own * (kc + kc2); i += kThreads) {
      const int slot = i / (kc + kc2), ch = i % (kc + kc2), prow = row0 + slot;
      const bool valid = prow < p_hi;
      const size_t row = static_cast<size_t>(n) * a.p + (valid ? prow : 0);
      if (ch < kc)
        cp_async_16(smem_addr(per_s + slot * ldp + ch * 4), a.per + row * k + ch * 4, valid ? 16 : 0);
      else
        cp_async_16(smem_addr(spe_s + slot * lds + (ch - kc) * 4), a.spe + row * k2 + (ch - kc) * 4, valid ? 16 : 0);
    }
    cp_async_commit();
  };
  load_cols(sT_s, a.sT + static_cast<size_t>(n) * k2 * c, k2, c, c0, nv, ldw);
  if (kI2T) {
    load_cols(rT_s, a.rT + static_cast<size_t>(n) * k * c, k, c, c0, nv, ldw);
    const int chunks = k / 8;
    for (int i = tid; i < nv * chunks; i += kThreads) {
      const int cc = i / chunks, kc = (i % chunks) * 8;
      cp_async_16(smem_addr(v2_s + cc * ldk + kc), a.v2T + (static_cast<size_t>(n) * c + c0 + cc) * k + kc, 16);
    }
    for (int i = tid; i < nv; i += kThreads) {
      vec_s[i] = a.ob[c0 + i];
      vec_s[q.w + i] = a.lnw[c0 + i];
      vec_s[2 * q.w + i] = a.lnb[c0 + i];
    }
  }
  if (tid < kMaxK) {
    m_run[tid] = -INFINITY;
    l_run[tid] = 0.f;
  }
  prefetch_rows(0);
  cluster_sync();  // residents' copies issued, barriers ready; every block of the cluster running

  auto issue = [&](int tt) {  // thread 0: tile tt's boxes into its stage
    const int s = tt % q.stages;
    unsigned char* st = ring + s * q.ks * kBoxBytes;
    mbar_arrive_expect_tx(&full[s], kv * kBoxBytes);
    for (int b = 0; b < kv; ++b) tma_load_3d(st + b * kBoxBytes, &tm_keys, &full[s], c0 + b * 16, p_lo + tt * kRows, n);
  };
  // With two stages, tile tt + 1 is loaded during tile tt, once tile tt - 1
  // (whose stage it takes) is accumulated and, for i2t_ln_t2i, its store has
  // read the stage; with one, after tile tt.
  auto issue_next = [&](int tt) {
    if (tid == 0 && tt + 1 < tiles && tt + 1 >= q.stages) {
      if (kI2T) bulk_wait_read();
      fence_proxy_async();
      issue(tt + 1);
    }
  };
  if (tid == 0)
    for (int tt = 0; tt < min(q.stages, tiles); ++tt) issue(tt);

  float acc[kChunks][MT2][4];
#pragma unroll
  for (int i = 0; i < kChunks; ++i)
#pragma unroll
    for (int mt = 0; mt < MT2; ++mt) acc[i][mt][0] = acc[i][mt][1] = acc[i][mt][2] = acc[i][mt][3] = 0.f;
  float lg[kMaxK / 8][4];
  // online softmax over P per token from the logits in x: a half-warp per
  // token (of pairs warp, warp + 8, ...), 8 rows a lane; e = exp(logit - m)
  // in bf16 into eT; then acc (K2 x the warp's column chunks) = acc * alpha
  // + e^T . the tile in `stage`
  constexpr int kPairs = (8 * MT2 + kWarps - 1) / kWarps;
  const int o = lane & 15;
  float x[kPairs][8];
  auto softmax_acc = [&](const unsigned char* stage) {
#pragma unroll
      for (int pi = 0; pi < kPairs; ++pi) {
        const int p = warp + kWarps * pi;
        if (p < k2 / 2) {
          const int j = 2 * p + (lane >> 4);
          float mx = x[pi][0];
#pragma unroll
          for (int u = 1; u < 8; ++u) mx = fmaxf(mx, x[pi][u]);
#pragma unroll
          for (int off = 1; off < 16; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
          const float m_old = m_run[j], m_new = fmaxf(m_old, mx);
          uint32_t hi[4], lo[4];
          float sum = 0.f;
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float e0 = expf(x[pi][2 * u] - m_new), e1 = expf(x[pi][2 * u + 1] - m_new);
            const float h0 = bf16_round(e0), h1 = bf16_round(e1);
            const float l0 = bf16_round(e0 - h0), l1 = bf16_round(e1 - h1);
            hi[u] = pack_bf16x2(h0, h1);
            lo[u] = pack_bf16x2(l0, l1);
            sum += (h0 + l0) + (h1 + l1);
          }
          *reinterpret_cast<uint4*>(eT + j * lde + 8 * o) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
          *reinterpret_cast<uint4*>(eT + (k2 + j) * lde + 8 * o) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
#pragma unroll
          for (int off = 1; off < 16; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
          if (o == 0) {
            const float al = expf(m_old - m_new);
            alpha[j] = al;
            m_run[j] = m_new;
            l_run[j] = l_run[j] * al + sum;
          }
        }
      }
      __syncthreads();
      // acc (K2 x the warp's column chunks) = acc * alpha + e^T . tile
#pragma unroll
      for (int mt = 0; mt < MT2; ++mt) {
        if (mt * 16 < k2) {
          const float al0 = alpha[mt * 16 + g], al1 = alpha[mt * 16 + g + 8];
#pragma unroll
          for (int i = 0; i < kChunks; ++i) {
            acc[i][mt][0] *= al0;
            acc[i][mt][1] *= al0;
            acc[i][mt][2] *= al1;
            acc[i][mt][3] *= al1;
          }
        }
      }
#pragma unroll
      for (int kk = 0; kk < kRows / 16; kk += 2) {
        uint32_t b[kChunks][4];
#pragma unroll
        for (int part = 0; part < 2; ++part) {  // the exponentials' hi, then lo parts
          uint32_t ea[MT2][2][4];
#pragma unroll
          for (int mt = 0; mt < MT2; ++mt)
            if (mt * 16 < k2)
#pragma unroll
              for (int u = 0; u < 2; ++u)
                ldmatrix_x4(ea[mt][u], smem_addr(eT + (part * k2 + mt * 16 + (lane & 15)) * lde + (kk + u) * 16 +
                                                 (lane >> 4) * 8));
#pragma unroll
          for (int i = 0; i < kChunks; ++i) {
            const int jc = warp + kWarps * i;
            if (jc < 2 * kv) {
              if (part == 0) {
                const int row = (kk + (lane >> 4)) * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
                ldmatrix_x4_trans(b[i], smem_addr(stage + (jc >> 1) * kBoxBytes + sw32(row, jc & 1)));
              }
#pragma unroll
              for (int mt = 0; mt < MT2; ++mt) {
                if (mt * 16 < k2) {
                  mma_16816(acc[i][mt], ea[mt][0], b[i][0], b[i][1]);
                  mma_16816(acc[i][mt], ea[mt][1], b[i][2], b[i][3]);
                }
              }
            }
          }
        }
      }
  };

  for (int tt = 0; tt < tiles; ++tt) {
    const int s = tt % q.stages;
    unsigned char* st = ring + s * q.ks * kBoxBytes;
    const int row0 = p_lo + tt * kRows;
    L4P_TICK(0);
    mbar_wait(&full[s], (tt / q.stages) & 1);
    L4P_TICK(1);
    if ((kI2T ? kStopAt < 2 : !kWindow) && q.stages == 2) issue_next(tt);
    // the window: the previous tile's accumulation, then the next tile's load into its stage
    auto window = [&]() {
      if (q.stages == 2) {
        if (kStopAt >= 6 && tt > 0) {
          softmax_acc(ring + ((tt - 1) % 2) * q.ks * kBoxBytes);
          __syncthreads();  // every warp is done with that stage
        }
        issue_next(tt);
      }
    };

    if constexpr (kI2T && kStopAt >= 2) {
      // i2t logits, reduced over the cluster; each owner's softmax per head into every block
      tile_logits<KS>(lg, st, rT_s, ldw, k, kv);
      send_partials(lg, red, k, q.rpo, q.ldr, rank);
      cp_async_wait<0>();
      cluster_sync();
      L4P_TICK(2);
      // the owner's rows: sums over the cluster (+ per) with every thread, then each head's softmax
      for (int i = tid; i < own * k; i += kThreads) {
        const int slot = i / k, j = i - slot * k;
        float v = per_s[slot * ldp + j];
        for (int src = 0; src < q.s; ++src) v += red[(src * q.rpo + slot) * q.ldr + j];
        red[slot * q.ldr + j] = v;
      }
      __syncthreads();
      const int heads = k / a.q;
      for (int i = tid; i < own * heads; i += kThreads) {
        const int slot = i / heads, h0 = (i - slot * heads) * a.q;
        const float* x = red + slot * q.ldr + h0;
        float m = -INFINITY;
        for (int j = 0; j < a.q; ++j) m = fmaxf(m, x[j]);
        float sum = 0.f;
        for (int j = 0; j < a.q; ++j) sum += expf(x[j] - m);
        const float inv = 1.f / sum;
        bf16* out = attn + (my_rows + slot) * ldk + h0;
        for (int j = 0; j < a.q; ++j) out[j] = __float2bfloat16(expf(x[j] - m) * inv);
      }
      __syncthreads();
      {
        const int kc = k / 8;  // 16-byte chunks of a row of probabilities
        copy_out(reinterpret_cast<const unsigned char*>(attn), own * kc,
                 [&](int i) { return ((my_rows + i / kc) * ldk + (i % kc) * 8) * 2; }, q.s, rank);
      }
      cluster_sync();
      if (q.stages == 2) issue_next(tt);
      L4P_TICK(3);
    }
    if constexpr (kI2T && kStopAt >= 3) {
      // y = keys + attn . v2 + ob for the warp's 16 rows and the block's columns, fp32 in registers
      float y[2 * KS][4];
      uint32_t af[kMaxK / 16][4];
#pragma unroll
      for (int kk = 0; kk < kMaxK / 16; ++kk)
        if (kk * 16 < k) ldmatrix_x4(af[kk], smem_addr(attn + (warp * 16 + (lane & 15)) * ldk + kk * 16 + (lane >> 4) * 8));
#pragma unroll
      for (int jc = 0; jc < 2 * KS; jc += 2) {
        if (jc < 2 * kv) {
          y[jc][0] = y[jc][1] = y[jc][2] = y[jc][3] = 0.f;
          y[jc + 1][0] = y[jc + 1][1] = y[jc + 1][2] = y[jc + 1][3] = 0.f;
#pragma unroll
          for (int kk = 0; kk < kMaxK / 16; ++kk) {
            if (kk * 16 < k) {
              uint32_t b[4];
              ldmatrix_x4(b, smem_addr(v2_s + (jc * 8 + (lane & 7) + ((lane >> 4) << 3)) * ldk + kk * 16 +
                                       ((lane >> 3) & 1) * 8));
              mma_16816(y[jc], af[kk], b[0], b[1]);
              mma_16816(y[jc + 1], af[kk], b[2], b[3]);
            }
          }
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int cj = jc + e, col = 8 * cj + 2 * t;
            const float2 ob = *reinterpret_cast<const float2*>(vec_s + col);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = warp * 16 + g + 8 * h;
              const float2 kf = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(st + (cj >> 1) * kBoxBytes + sw32(r, cj & 1) + 4 * t));
              y[cj][2 * h] += kf.x + ob.x;
              y[cj][2 * h + 1] += kf.y + ob.y;
            }
          }
        }
      }
      L4P_TICK(4);
      if constexpr (kStopAt == 3) {
        if (y[0][0] == -1.2345e-30f) a.wsum[0] = y[2 * KS - 1][3];  // keeps y
      }
      if constexpr (kStopAt >= 4) {
        // LayerNorm: each row's (mean, M2) over this block's columns, two-pass,
        // into every block; combined over the cluster (Chan et al.)
        float mean[2], m2[2] = {0.f, 0.f};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float sum = 0.f;
#pragma unroll
          for (int jc = 0; jc < 2 * KS; ++jc)
            if (jc < 2 * kv) sum += y[jc][2 * h] + y[jc][2 * h + 1];
          mean[h] = quad_sum(sum) / nv;
#pragma unroll
          for (int jc = 0; jc < 2 * KS; ++jc) {
            if (jc < 2 * kv) {
              const float d0 = y[jc][2 * h] - mean[h], d1 = y[jc][2 * h + 1] - mean[h];
              m2[h] += d0 * d0 + d1 * d1;
            }
          }
          m2[h] = quad_sum(m2[h]);
        }
        if (t == 0) {
          for (int d = 0; d < q.s; ++d) {
            const uint32_t base = map_shared(mom, d) + (rank * kRows + warp * 16 + g) * 8;
            st_cluster_f32x2(base, mean[0], m2[0]);
            st_cluster_f32x2(base + 64, mean[1], m2[1]);
          }
        }
        cluster_sync();
        L4P_TICK(5);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = warp * 16 + g + 8 * h;
          float mu = 0.f;
          for (int src = 0; src < q.s; ++src) mu += mom[src * kRows + r].x * min(q.w, c - src * q.w);
          mu /= c;
          float var = 0.f;
          for (int src = 0; src < q.s; ++src) {
            const float2 v = mom[src * kRows + r];
            const float d = v.x - mu;
            var += v.y + d * d * min(q.w, c - src * q.w);
          }
          mean[h] = mu;
          m2[h] = rsqrtf(var / c + a.eps);
        }
        // the new keys over the tile (the store and the next logits read them there)
#pragma unroll
        for (int jc = 0; jc < 2 * KS; ++jc) {
          if (jc < 2 * kv) {
            const int col = 8 * jc + 2 * t;
            const float2 w = *reinterpret_cast<const float2*>(vec_s + q.w + col);
            const float2 b = *reinterpret_cast<const float2*>(vec_s + 2 * q.w + col);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = warp * 16 + g + 8 * h;
              *reinterpret_cast<uint32_t*>(st + (jc >> 1) * kBoxBytes + sw32(r, jc & 1) + 4 * t) =
                  pack_bf16x2((y[jc][2 * h] - mean[h]) * m2[h] * w.x + b.x,
                              (y[jc][2 * h + 1] - mean[h]) * m2[h] * w.y + b.y);
            }
          }
        }
        fence_proxy_async();
        __syncthreads();
        if (tid == 0) {
          for (int b = 0; b < kv; ++b) tma_store_3d(&tm_new, st + b * kBoxBytes, c0 + b * 16, row0, n);
          bulk_commit();
        }
        L4P_TICK(6);
      }
    }
    if constexpr (kStopAt >= 5) {
      // next t2i logits + spe, reduced over the cluster into every block (-inf past P), with
      // each owner's column maxima
      tile_logits<KS>(lg, st, sT_s, ldw, k2, kv);
      send_partials(lg, red, k2, q.rpo, q.ldr, rank);
      cp_async_wait<0>();
      cluster_arrive();
      if (!kI2T) window();
      cluster_wait();
      L4P_TICK(7);
      for (int i = tid; i < own * k2; i += kThreads) {
        const int j = i / own, slot = i - j * own;  // rows fastest: lg2T's stores on distinct banks
        float v = -INFINITY;
        if (row0 + my_rows + slot < p_hi) {
          v = spe_s[slot * lds + j];
          for (int src = 0; src < q.s; ++src) v += red[(src * q.rpo + slot) * q.ldr + j];
        }
        lg2T[j * ldl + my_rows + slot] = v;
      }
      __syncthreads();
      if (tt + 1 < tiles) prefetch_rows(tt + 1);  // per and spe are read for this tile
      {
        const int oc = own / 4;  // 16-byte chunks of a token's rows
        copy_out(reinterpret_cast<const unsigned char*>(lg2T), k2 * oc,
                 [&](int i) { return ((i / oc) * ldl + my_rows + (i % oc) * 4) * 4; }, q.s, rank);
      }
      cluster_sync();
      L4P_TICK(8);
    }
    if constexpr (kStopAt >= 6) {
      // this tile's next logits into registers, before other blocks may reuse
      // xbuf; their softmax and accumulation follow at once, or in the next
      // tile's window
#pragma unroll
      for (int pi = 0; pi < kPairs; ++pi) {
        const int p = warp + kWarps * pi;
        if (p < k2 / 2) {
          const float* src = lg2T + (2 * p + (lane >> 4)) * ldl + 8 * o;
          const float4 v0 = *reinterpret_cast<const float4*>(src), v1 = *reinterpret_cast<const float4*>(src + 4);
          x[pi][0] = v0.x, x[pi][1] = v0.y, x[pi][2] = v0.z, x[pi][3] = v0.w;
          x[pi][4] = v1.x, x[pi][5] = v1.y, x[pi][6] = v1.z, x[pi][7] = v1.w;
        }
      }
      if (!windowed) {
        __syncthreads();
        softmax_acc(st);
      }
      L4P_TICK(9);
    } else if constexpr (kStopAt < 5) {
      if (tt + 1 < tiles) prefetch_rows(tt + 1);
    }
    // every warp is done with the stage (and, with one stage, its store has read it)
    cp_async_wait<0>();
    __syncthreads();
    if (q.stages == 1) issue_next(tt);
    L4P_TICK(10);
  }
  if (kStopAt >= 6 && windowed && tiles > 0) {
    __syncthreads();
    softmax_acc(ring + ((tiles - 1) % 2) * q.ks * kBoxBytes);
  }

  // this block's columns of wsum = acc / l, or the split's partials
  const size_t cell = static_cast<size_t>(n) * splits + sp;
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int jc = warp + kWarps * i;
    if (jc < 2 * kv) {
      const int col = c0 + 8 * jc + 2 * t;
#pragma unroll
      for (int mt = 0; mt < MT2; ++mt) {
        if (mt * 16 < k2) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int j = mt * 16 + g + 8 * h;
            float2 v = make_float2(acc[i][mt][2 * h], acc[i][mt][2 * h + 1]);
            if (splits == 1) {
              const float inv = 1.f / l_run[j];
              v.x *= inv;
              v.y *= inv;
              *reinterpret_cast<float2*>(a.wsum + (static_cast<size_t>(n) * k2 + j) * c + col) = v;
            } else {
              *reinterpret_cast<float2*>(a.acc_ws + (cell * k2 + j) * c + col) = v;
            }
          }
        }
      }
    }
  }
  if (splits > 1 && rank == 0 && tid < k2) {
    a.m_ws[cell * k2 + tid] = m_run[tid];
    a.l_ws[cell * k2 + tid] = l_run[tid];
  }
  if (kI2T && tid == 0) bulk_wait();
#ifdef L4P_KEYS_CLOCKS
  // each part's cycles per tile, thread 0 of every block of query 0's first
  // cluster, over wsum[0][0][16 rank ..] (the build's outputs mean nothing)
  if (tid == 0 && n == 0 && sp == 0)
    for (int i = 0; i < kClockParts; ++i) a.wsum[rank * 16 + i] = static_cast<float>(ticks[i]) / tiles;
#endif
  cluster_sync();  // no block leaves while another may still address its shared memory
}

// wsum[n][j][c] = sum_s exp(m_s - m) acc_s / sum_s exp(m_s - m) l_s.
__global__ void t2i_combine_kernel(const float* __restrict__ acc_ws, const float* __restrict__ m_ws,
                                   const float* __restrict__ l_ws, float* __restrict__ wsum, size_t total, int splits,
                                   int k, int c) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int col = static_cast<int>(idx % c);
  const size_t nk = idx / c;
  const int j = static_cast<int>(nk % k);
  const size_t n = nk / k;
  float m = -INFINITY;
  for (int s = 0; s < splits; ++s) m = fmaxf(m, m_ws[(n * splits + s) * k + j]);
  float num = 0.f, den = 0.f;
  for (int s = 0; s < splits; ++s) {
    const size_t cell = n * splits + s;
    const float w = expf(m_ws[cell * k + j] - m);
    num += w * acc_ws[(cell * k + j) * c + col];
    den += w * l_ws[cell * k + j];
  }
  wsum[idx] = num / den;
}

bool bad_shape(int n, int p, int c, int k, int split) {
  return n <= 0 || n > 65535 || p <= 0 || c <= 0 || c % 16 != 0 || k <= 0 || k > kMaxK || k % 16 != 0 ||
         split <= 0 || split % kRows != 0 || (p + split - 1) / split > 65535;
}

// The plan with a 2-stage ring where it fits in shared memory, else 1 stage;
// s = 0 where no plan fits the kernel (too wide for its registers or
// shared memory).
Plan plan_for(bool i2t, int c, int k, int k2) {
  Plan q = make_plan(i2t, c, k, k2, 2);
  if (q.total > kMaxSmem) q = make_plan(i2t, c, k, k2, 1);
  if (q.total > kMaxSmem || q.ks > (i2t ? kKS : kKSWide)) q.s = 0;
  return q;
}

// Launches one cluster per (query, split) and, with P split, the combine.
// Returns 0, a CUDA error code, or a negative sm90::tensor_map_error.
template <bool kI2T, int KS, int MT2>
int launch(const Plan& q, const void* keys, void* keys_new, const Args& a, int n, cudaStream_t stream) {
  CUtensorMap tk, tn;
  int e = encode_bf16_3d(&tk, keys, a.c, a.c, a.p, n, kBoxCols, kRows, CU_TENSOR_MAP_SWIZZLE_32B);
  if (e == 0) e = encode_bf16_3d(&tn, kI2T ? keys_new : keys, a.c, a.c, a.p, n, kBoxCols, kRows,
                                 CU_TENSOR_MAP_SWIZZLE_32B);
  if (e != 0) return e;
  auto kernel = keys_cluster_kernel<kI2T, KS, MT2>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, q.total);
  if (err == cudaSuccess && q.s > kPortableCluster)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int splits = (a.p + a.split - 1) / a.split;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(q.s, splits, n);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = q.total;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = q.s;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // a cluster the card cannot place at all is refused here, not left to hang
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (clusters == 0) return static_cast<int>(cudaErrorLaunchOutOfResources);
  err = cudaLaunchKernelEx(&cfg, kernel, tk, tn, q, a);
  if (err == cudaSuccess) err = cudaGetLastError();
#ifdef L4P_KEYS_NO_COMBINE
  return static_cast<int>(err);
#endif
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t total = static_cast<size_t>(n) * a.k2 * a.c;
  t2i_combine_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0, stream>>>(a.acc_ws, a.m_ws, a.l_ws,
                                                                                    a.wsum, total, splits, a.k2, a.c);
  return static_cast<int>(cudaGetLastError());
}

// launch<kI2T, KS, MT2> for MT2 = K2 / 16.
template <bool kI2T, int KS>
int launch_k2(const Plan& q, const void* keys, void* keys_new, const Args& a, int n, cudaStream_t stream) {
  switch (a.k2 / 16) {
    case 1:
      return launch<kI2T, KS, 1>(q, keys, keys_new, a, n, stream);
    case 2:
      return launch<kI2T, KS, 2>(q, keys, keys_new, a, n, stream);
    case 3:
      return launch<kI2T, KS, 3>(q, keys, keys_new, a, n, stream);
    default:
      return launch<kI2T, KS, 4>(q, keys, keys_new, a, n, stream);
  }
}

}  // namespace

// Each returns 0 on success, else the CUDA error code of the refused launch
// (or a negative tensor-map error). `split` (a multiple of 128) is the keys
// rows per cluster; with more than one split per query, acc_ws (N, splits,
// K2, C), m_ws and l_ws (N, splits, K2) take the partials.

extern "C" int l4p_t2i_flash_bf16(const void* keys, const void* sT, const void* spe, void* wsum, void* acc_ws,
                                  void* m_ws, void* l_ws, int n, int p, int c, int k, int split, void* stream) {
  if (bad_shape(n, p, c, k, split)) return static_cast<int>(cudaErrorInvalidValue);
  const Plan q = plan_for(false, c, 0, k);
  if (q.s == 0) return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.sT = static_cast<const bf16*>(sT);
  a.spe = static_cast<const float*>(spe);
  a.wsum = static_cast<float*>(wsum);
  a.acc_ws = static_cast<float*>(acc_ws);
  a.m_ws = static_cast<float*>(m_ws);
  a.l_ws = static_cast<float*>(l_ws);
  a.p = p;
  a.c = c;
  a.k2 = k;
  a.split = split;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the widest blocks (C > 2816, rare) take one build: K2 <= 64 guarded at run time
  return q.ks <= kKS ? launch_k2<false, kKS>(q, keys, nullptr, a, n, s)
                     : launch<false, kKSWide, 4>(q, keys, nullptr, a, n, s);
}

extern "C" int l4p_i2t_ln_t2i_bf16(const void* keys, const void* rT, const void* per, const void* v2T, const void* ob,
                                   const void* lnw, const void* lnb, const void* sT, const void* spe, void* keys_new,
                                   void* wsum, void* acc_ws, void* m_ws, void* l_ws, int n, int p, int c, int k,
                                   int k2, int heads, int split, float eps, void* stream) {
  if (bad_shape(n, p, c, k, split) || bad_shape(n, p, c, k2, split) || heads <= 0 || k % heads != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan q = plan_for(true, c, k, k2);
  if (q.s == 0) return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.rT = static_cast<const bf16*>(rT);
  a.per = static_cast<const float*>(per);
  a.v2T = static_cast<const bf16*>(v2T);
  a.ob = static_cast<const float*>(ob);
  a.lnw = static_cast<const float*>(lnw);
  a.lnb = static_cast<const float*>(lnb);
  a.sT = static_cast<const bf16*>(sT);
  a.spe = static_cast<const float*>(spe);
  a.wsum = static_cast<float*>(wsum);
  a.acc_ws = static_cast<float*>(acc_ws);
  a.m_ws = static_cast<float*>(m_ws);
  a.l_ws = static_cast<float*>(l_ws);
  a.p = p;
  a.c = c;
  a.k = k;
  a.k2 = k2;
  a.q = k / heads;
  a.split = split;
  a.eps = eps;
  return launch_k2<true, kKS>(q, keys, keys_new, a, n, static_cast<cudaStream_t>(stream));
}
