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
//     operands (rT and sT as wgmma's K-major operands in 32-byte swizzled
//     boxes, v2, and ob, lnw, lnb), loaded once;
//   - its columns of 128-row keys tiles stream through a 2-stage TMA ring
//     (boxes of 16 columns, 32-byte swizzle), each tile's load issued while
//     the previous tile is computed;
//   - 16 warps in 4 warpgroups: wgmma products where the operands sit in
//     shared memory (the logits: warpgroup (row half, token half); the
//     weighted sum: warpgroups 0-2, a 64-column block each), mma.sync for
//     y, where each 16-row group takes two warps, one a half of the block's
//     column boxes;
//   - per tile: the partial i2t logits keys . rT over the block's columns,
//     staged as rows, go to each row's owner block (128 / S rows each) by
//     bulk copies into its shared memory, counted on an mbarrier there; the
//     owner adds them (+ per), takes each head's softmax over its tokens
//     (fp32, normalised, cast to bf16) and bulk-copies its rows of
//     probabilities into every block, again counted on an mbarrier;
//     y = keys + attn . v2 + ob in fp32, box by box, for the LayerNorm's
//     moments over C (merged box by box, over the warp's quad, over the
//     block's two halves and over the cluster, Chan et al.; each block's
//     (mean, M2) of the tile bulk-copied to every block), then once more for
//     the new keys, written over the tile in shared memory and stored by TMA;
//     the partial next t2i logits keys_new . sT to the owners, their sums +
//     spe bulk-copied back the same way; then per token the tile's max over
//     its rows and, with a running max m and sum l (fp32), exp(logit - m)
//     (as a bf16 hi + lo pair, below) into shared memory, and acc^T (the
//     block's columns x the tokens, fp32 registers) = acc^T * alpha + tile^T
//     . e, as _t2i_update does;
//   - t2i_flash is the same kernel without the i2t front and the store;
//     with two stages it runs the previous tile's softmax and accumulation
//     while the partial logits of a tile travel to their owners, so the two
//     overlap.
//   A cluster writes wsum = acc / l for its columns, or, where P is split
//   over clusters to fill the card (few queries), (m, l, acc) partials that
//   t2i_combine rescales and adds. Builds: the weighted sum's token width,
//   48 or 64 (K2 > 48), and t2i_flash's widest blocks (C > 2816: 16 blocks
//   of up to 24 boxes); ops/fused_keys.py:kernel_variant names them.
//
// Passes over keys (each 738 MB at the giant shape): t2i_flash reads it
// once; i2t_ln_t2i reads it once and writes the new keys once, which are
// never read back: 1 + 2 + 2 = 5 per window, the TPU kernels' count. The
// logits never leave the cluster.
//
// What bounds them on the card (scripts/keys_bounds.py, PERF.md): not the
// bytes, and not the products. Each 128-row tile is a chain of dependent
// steps whose exchanges and per-warp latencies decide its time. So every
// exchange is a bulk copy counted on an mbarrier in the receiving block
// (on the card one exchange round took ~3,700 cycles so, ~6,600 through
// remote stores and two cluster barriers; a block now waits ~300-1,100
// cycles a tile for remote data), 16 warps share each step, and the
// products whose operands sit in shared memory run on wgmma. What bounds it
// now is the register file: 16 warps leave 128 registers a thread, and
// every step is a chain within a warp (the owners' sums and softmaxes, y
// box by box, the exponentials): ~40,000 cycles of i2t_ln_t2i a tile and
// ~14,000 of t2i_flash (keys_bounds.py --clocks). y is computed twice
// because holding it across the moments' exchange, or running it on wgmma,
// spilled and ran slower.
//
// Exchanges and their buffers: each barrier (bar_red: the owned rows'
// partials; bar_rcv: the other owners' rows; bar_mom: the moments) opens one
// phase per use, thread 0 expecting its bytes. A buffer is written again only
// after its last readers have answered: a block sends a tile's partials once
// it holds every owner's rows of the tile before, which each owner sent once
// it had summed its partials; the rows a block receives from an owner land
// where its partials for that owner were staged, which the owner has
// received; an owner sends its rows from `out`, which it rewrites only after
// every block has sent it partials that needed them.
//
// Build-time hooks for scripts/keys_bounds.py only (each -D gives a build
// whose times mean something and whose results do not; each stops
// i2t_ln_t2i's tile after one more part):
//   L4P_KEYS_LOADS_ONLY      the keys tiles stream through the ring;
//   L4P_KEYS_NO_V2           ... and the i2t logits, their owners' softmax and
//                            its rows sent back;
//   L4P_KEYS_NO_LN           ... and y = keys + attn . v2 + ob;
//   L4P_KEYS_NO_NEXT_LOGITS  ... and the LayerNorm and the new keys' store;
//   L4P_KEYS_NO_ACC          ... and the next t2i logits and their exchange;
//   L4P_KEYS_NO_COMBINE      t2i_combine left out (P split over clusters);
//   L4P_KEYS_CLOCKS          thread 0 of each block counts each part's cycles
//                            (clock64, into shared memory) and query 0's
//                            first cluster writes them over its wsum.
//
// Numerics: logits, softmax statistics, accumulators, residual and
// LayerNorm are fp32; the i2t probabilities are normalised then cast to
// bf16 (the TPU kernel's point). The t2i exponentials (unnormalised, as the
// TPU kernel takes them) enter the weighted-sum product as a bf16 pair, hi
// = bf16(e) and lo = bf16(e - hi), with l the fp32 sum of the pairs: ~16
// significant bits where the TPU kernel and the plain version round to
// bf16's 8, one product more per tile. (With one bf16 each the kernel path's
// tracks moved farther from an fp32 attention than the plain path's on
// chip_smoke's witness requests; PERF.md.) The next logits come from the
// bf16 new keys, as in the plain version. Requires C % 16 == 0 and K, K2
// multiples of 16 up to 64; ragged P is masked.

#include <math.h>

#include "sm90.cuh"

namespace {

using namespace l4p;
using namespace l4p::sm90;
using bf16 = __nv_bfloat16;

constexpr int kMaxK = 64;
constexpr int kRows = 128;   // keys rows per tile: 8 row groups of 16
constexpr int kWarps = 16;   // 4 warpgroups; in y, two warps a 16-row group, a column half each
constexpr int kThreads = kWarps * 32;
constexpr int kBoxCols = 16;                      // a TMA box: 16 columns (32 bytes) x 128 rows
constexpr int kBoxBytes = kRows * kBoxCols * 2;  // 4096
constexpr int kPortableCluster = 8;
constexpr int kMaxCluster = 16;
constexpr int kKS = 11;      // k16 column steps a block takes: W <= 176
constexpr int kKSWide = 24;  // t2i_flash beyond that: W <= 384 (16 blocks, C <= 6144)
constexpr int kMaxSmem = 232448;
constexpr int kClockParts = 16;  // the parts L4P_KEYS_CLOCKS times (scripts/keys_bounds.py --clocks)
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
  int rpo;     // tile rows each block owns (reduces): ceil(128 / s) up to a multiple of 4
  int ldx;     // fp32 row stride of the exchanged rows: max(K, K2) + 4 (16-byte rows on other banks)
  int stages;  // ring stages
  int ring, rt, v2, st, vec, pre, red, xbuf, et, out, mom, stat, bar, total;
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

// Token rows of a token operand's boxes in shared memory: the tokens and
// room for the 32-token products of the upper half to read past them.
__host__ __device__ constexpr int tok_rows(int tokens) { return tokens / 2 + 32; }

// Tokens of the weighted sum's products (wgmma's N): 48, or 64 past 48.
__host__ __device__ constexpr int acc_tokens(int k2) { return k2 > 48 ? 64 : 48; }

Plan make_plan(bool i2t, int c, int k, int k2, int stages) {
  Plan q{};
  const int cw = c / 16;
  q.ks = (cw + kPortableCluster - 1) / kPortableCluster;
  if (q.ks > kKS) q.ks = (cw + kMaxCluster - 1) / kMaxCluster;
  q.s = (cw + q.ks - 1) / q.ks;
  q.w = 16 * q.ks;
  q.rpo = ((kRows + q.s - 1) / q.s + 3) / 4 * 4;
  q.ldx = (i2t && k > k2 ? k : k2) + 4;
  q.stages = stages;
  int off = 0;
  auto take = [&](int bytes, int align) {
    off = (off + align - 1) / align * align;
    const int at = off;
    off += bytes;
    return at;
  };
  q.ring = take(stages * q.ks * kBoxBytes, 1024);
  q.rt = i2t ? take(q.ks * tok_rows(k) * 32, 256) : 0;
  q.v2 = i2t ? take(q.w * (k + 8) * 2, 16) : 0;
  q.st = take(q.ks * tok_rows(k2) * 32, 256);
  q.vec = i2t ? take(3 * q.w * 4, 16) : 0;
  q.pre = take(q.rpo * ((i2t ? k + 4 : 0) + k2 + 4) * 4, 16);
  const int row_bytes = q.ldx * 4;
  q.red = take(q.s * q.rpo * row_bytes, 16);
  // the tile's rows (128, ldx): this block's partial logits as they are sent,
  // then each owner's rows of i2t probabilities (bf16) or next logits (fp32);
  // then their exponentials as bf16 hi and lo parts, wgmma's K-major B
  // operand: per 16-row k-step a box of (token, 32 bytes) rows, 32-byte swizzle
  const int et_bytes = 2 * (kRows / 16) * (q.ks > kKS ? 64 : acc_tokens(k2)) * 32;  // the widest build takes 64
  q.xbuf = take(max(kRows * row_bytes, i2t || stages == 1 ? et_bytes : 0), 256);
  // without the window (i2t_ln_t2i, or one stage) the exponentials take xbuf's place
  q.et = !i2t && stages == 2 ? take(et_bytes, 256) : q.xbuf;
  q.out = take(q.s > 1 ? q.rpo * row_bytes : 0, 16);  // the owned rows as they are sent
  q.mom = i2t ? take(q.s * kRows * 8, 16) : 0;
  q.stat = take(3 * kMaxK * 4, 16);
  q.bar = take((stages + 3) * 8, 8);
  // the weighted sum reads the last stage in 64-column blocks, warpgroup 3's past the block's columns
  q.total = max(off, ((stages - 1) * q.ks + (q.ks > kKS ? 28 : 16)) * kBoxBytes) + 1024;  // and the slack to align the base
  return q;
}

// Byte offset of 16-byte half h of row r in a box of 32-byte rows with
// 32-byte swizzle (the box 256-byte aligned).
__device__ __forceinline__ uint32_t sw32(int r, int h) { return r * 32 + ((h ^ (r >> 2)) & 1) * 16; }

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Copies columns [c0, c0 + nv) of a (tokens, c) bf16 matrix into shared
// memory as wgmma's K-major operand: a box of 16 columns after another,
// each `trows` rows of 32 bytes with 32-byte swizzle (cp.async; the caller
// waits).
__device__ void load_tokens(bf16* dst, const bf16* src, int tokens, int c, int c0, int nv, int trows) {
  const int chunks = nv / 8;
  for (int i = threadIdx.x; i < tokens * chunks; i += kThreads) {
    const int j = i / chunks, cc = i % chunks;
    cp_async_16(smem_addr(reinterpret_cast<unsigned char*>(dst) + (cc >> 1) * trows * 32 + sw32(j, cc & 1)),
                src + static_cast<size_t>(j) * c + c0 + 8 * cc, 16);
  }
}

// Writes the warp's partial logits (token chunks j0 .. j0 + nj of the wgmma
// fragment d) into the tile's rows x (row stride ldx), from which they go
// to their owners.
__device__ __forceinline__ void stage_partials(const float (&d)[16], float* x, int j0, int nj, int ldx, int rg) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float* row = x + (rg * 16 + g + 8 * h) * ldx + 8 * j0 + 2 * t;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (i < nj) *reinterpret_cast<float2*>(row + 8 * i) = make_float2(d[4 * i + 2 * h], d[4 * i + 2 * h + 1]);
  }
}

// Each owner's rows of the staged tile x (row_bytes each) into its red[rank]
// (this block's own too, so that an owner's sums read red alone),
// completing on its barrier `bar`; threads 0 .. s - 1 issue one copy each
// (after the writers' fence_proxy_async and a barrier).
__device__ __forceinline__ void send_partials(const unsigned char* x, const unsigned char* red, const uint64_t* bar,
                                              int rpo, int row_bytes, int s, uint32_t rank) {
  const int d = threadIdx.x;
  const int count = min(rpo, kRows - d * rpo);
  if (d < s && count > 0)
    bulk_copy_cluster(map_shared(red + rank * rpo * row_bytes, d), x + d * rpo * row_bytes, count * row_bytes,
                      map_shared(bar, d));
}

// Copies `count` rows of `row_bytes` from `src` to rows [first, first + count)
// of `dst` in every other block of the cluster, each copy completing on the
// barrier `bar` there; threads 0 .. s - 1 issue one copy each.
__device__ __forceinline__ void send_rows(const void* dst, const void* src, const uint64_t* bar, int first, int count,
                                          int row_bytes, int s, uint32_t rank) {
  const int d = threadIdx.x;
  if (d < s && d != static_cast<int>(rank) && count > 0)
    bulk_copy_cluster(map_shared(static_cast<const unsigned char*>(dst) + first * row_bytes, d), src,
                      count * row_bytes, map_shared(bar, d));
}

// One cluster per (query n, split sp of P); grid (s, splits, n), 512
// threads. kI2T: i2t_ln_t2i (else t2i_flash); KS: the k16 column steps a
// block takes (11, or 24 for t2i_flash's widest); NT: acc_tokens(K2).
template <bool kI2T, int KS, int NT>
__global__ void __launch_bounds__(kThreads, 1)
    keys_cluster_kernel(const __grid_constant__ CUtensorMap tm_keys, const __grid_constant__ CUtensorMap tm_new,
                        const Plan q, const Args a) {
  constexpr int KSH = (KS + 1) / 2;     // column boxes of y a warp takes
  constexpr int CBW = KS > 12 ? 2 : 1;  // 64-column blocks of the weighted sum a warpgroup of 0-2 takes
  constexpr int kStopAt = kI2T ? kStop : (kStop == 1 ? 1 : kStop >= 5 ? kStop : 6);
  // t2i_flash with two stages runs the previous tile's accumulation (and the
  // next tile's load into its stage) while its partial logits travel to
  // their owners ("the window")
  constexpr bool kWindow = !kI2T && kStopAt >= 5;
  const bool windowed = kWindow && kStopAt >= 6 && q.stages == 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int rg = warp & 7, hf = warp >> 3;  // the warp's rows 16 rg .. 16 rg + 15; its half
  const int wg = warp >> 2, w4 = warp & 3;  // its warpgroup: rows 64 (wg & 1) .., token half wg >> 1 (= hf)
  const uint32_t rank = cluster_rank();
  const int n = blockIdx.z, sp = blockIdx.y, splits = gridDim.y;
  const int c = a.c, k = a.k, k2 = a.k2;
  const int c0 = rank * q.w;
  const int nv = min(q.w, c - c0);  // this block's columns, a multiple of 16
  const int kv = nv / 16;
  const int kv0 = (kv + 1) / 2, yb0 = hf ? kv0 : 0, ynb = hf ? kv - kv0 : kv0;  // the warp's boxes of y
  const int p_lo = sp * a.split, p_hi = min(a.p, p_lo + a.split);
  const int tiles = (p_hi - p_lo + kRows - 1) / kRows;
  const int ldv = k + 8, ldp = k + 4, lds = k2 + 4, ldx = q.ldx, ldk = 2 * ldx;
  const int row_bytes = ldx * 4;  // a row of xbuf, red and out
  const int nj = k / 16, nj2 = k2 / 16;  // each half's n8 token chunks of the logits
  unsigned char* ring = smem + q.ring;
  bf16* rT_s = reinterpret_cast<bf16*>(smem + q.rt);
  bf16* v2_s = reinterpret_cast<bf16*>(smem + q.v2);
  bf16* sT_s = reinterpret_cast<bf16*>(smem + q.st);
  float* vec_s = reinterpret_cast<float*>(smem + q.vec);  // ob, lnw, lnb
  float* per_s = reinterpret_cast<float*>(smem + q.pre);  // this block's owned rows of per, then spe
  float* spe_s = per_s + (kI2T ? q.rpo * ldp : 0);
  float* red = reinterpret_cast<float*>(smem + q.red);    // (s, rpo, ldx): the owned rows' partials by block
  float* xs = reinterpret_cast<float*>(smem + q.xbuf);    // the tile's rows (kRows, ldx): partials as sent
  bf16* attn = reinterpret_cast<bf16*>(smem + q.xbuf);    // then i2t probabilities (kRows, ldk)
  float* lg2 = xs;                                        // or next logits
  unsigned char* eT = smem + q.et;                        // their exponentials, hi then lo
  unsigned char* out = smem + q.out;                      // the owned rows as sent
  float2* mom = reinterpret_cast<float2*>(smem + q.mom);  // (s, kRows): each block's (mean, M2) per row
  float* m_run = reinterpret_cast<float*>(smem + q.stat);
  float* l_run = m_run + kMaxK;
  float* alpha = l_run + kMaxK;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + q.bar);
  uint64_t* bar_red = full + q.stages;  // the owned rows' partial logits, from every block
  uint64_t* bar_rcv = bar_red + 1;      // every other owner's rows of probabilities or logits
  uint64_t* bar_mom = bar_red + 2;      // every block's LayerNorm moments
  uint32_t ph_red = 0, ph_rcv = 0, ph_mom = 0;
  const int my_rows = rank * q.rpo;  // the tile rows this block owns
  const int own = max(0, min(q.rpo, kRows - my_rows));
#ifdef L4P_KEYS_CLOCKS
  // the counts in shared memory, so that the build holds no more registers than the kernel
  __shared__ long long ticks[kClockParts];
  if (tid < kClockParts) ticks[tid] = 0;
  long long tick_last = clock64();
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
    for (int s = 0; s < q.stages + 3; ++s) mbar_init(&full[s], 1);
    fence_barrier_init();
  }
  // this block's owned rows of per and spe for tile tt (zero past P), by cp.async
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
  load_tokens(sT_s, a.sT + static_cast<size_t>(n) * k2 * c, k2, c, c0, nv, tok_rows(k2));
  if (kI2T) {
    load_tokens(rT_s, a.rT + static_cast<size_t>(n) * k * c, k, c, c0, nv, tok_rows(k));
    const int chunks = k / 8;
    for (int i = tid; i < nv * chunks; i += kThreads) {
      const int cc = i / chunks, kc = (i % chunks) * 8;
      cp_async_16(smem_addr(v2_s + cc * ldv + kc), a.v2T + (static_cast<size_t>(n) * c + c0 + cc) * k + kc, 16);
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
    alpha[tid] = 0.f;
  }
  prefetch_rows(0);
  cp_async_wait<0>();  // the residents in place, and visible to wgmma's (async proxy) reads
  fence_proxy_async();
  cluster_sync();  // barriers ready; every block of the cluster running

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
  // thread 0 opens a phase of `bar` that expects `bytes` from the cluster
  auto expect = [&](uint64_t* bar, int bytes) {
    if (tid == 0) mbar_arrive_expect_tx(bar, bytes);
  };
  auto wait = [&](uint64_t* bar, uint32_t& ph) {
    mbar_wait_cluster(bar, ph);
    ph ^= 1;
  };
  if (tid == 0)
    for (int tt = 0; tt < min(q.stages, tiles); ++tt) issue(tt);

  // the warpgroup's part of the tile's logits against a token operand (in
  // its swizzled boxes): rows 64 (wg & 1) .. + 64, 32 tokens from (wg >> 1)
  // tokens / 2 (those past the half are not used), over the block's boxes
  auto logits = [&](float (&d)[16], const unsigned char* stage, const bf16* tok, int tokens) {
    const unsigned char* tb = reinterpret_cast<const unsigned char*>(tok) + (wg >> 1) * (tokens / 2) * 32;
    // the descriptors step by 16-byte units (a rolled loop: unrolled, their
    // hoisted copies would take the registers)
    const uint64_t da = smem_desc(stage + (wg & 1) * 64 * 32, 16, 256, kSwizzle32B);
    const uint64_t db = smem_desc(tb, 16, 256, kSwizzle32B);
    wgmma_fence();
#pragma unroll 1
    for (int b = 0; b < kv; ++b)
      wgmma_m64n32k16_ss(d, da + b * (kBoxBytes >> 4), db + b * tok_rows(tokens) * 2, b > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(d);
  };
  float lgd[16];

  // The weighted sum, transposed: warpgroups 0-2 keep acc^T, their 64-column
  // blocks (64 cb + 16 w4 + g, + 8; cb = wg + 3i) x NT tokens (8j + 2t, + 1),
  // in fp32 registers, with a running max m and sum l per token in shared
  // memory. Per tile: the online softmax over P per token from the logits in
  // x (a half-warp per token of pairs warp, warp + 16, ..., rows o + 16u a
  // lane), e = exp(logit - m) as bf16 hi + lo into eT; then acc^T = acc^T *
  // alpha + tile^T . e (wgmma, the tile MN-major as A from its boxes, e
  // K-major as B).
  float acc[CBW][NT / 2];
#pragma unroll
  for (int i = 0; i < CBW; ++i)
#pragma unroll
    for (int v = 0; v < NT / 2; ++v) acc[i][v] = 0.f;
  constexpr int kPairs = (NT / 2 + kWarps - 1) / kWarps;
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
        float sum = 0.f;
        // row o + 16u of token j: k-step u, element o of its 32-byte row
        unsigned char* ej = eT + j * 32 + (((o >> 3) ^ (j >> 2)) & 1) * 16 + (o & 7) * 2;
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const float e = expf(x[pi][u] - m_new);
          const bf16 h = __float2bfloat16(e);
          const bf16 l = __float2bfloat16(e - __bfloat162float(h));
          *reinterpret_cast<bf16*>(ej + u * NT * 32) = h;
          *reinterpret_cast<bf16*>(ej + (8 + u) * NT * 32) = l;
          sum += __bfloat162float(h) + __bfloat162float(l);
        }
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
    if (!kI2T) L4P_TICK(14);
    fence_proxy_async();  // eT is read by wgmma
    __syncthreads();
    if (!kI2T) L4P_TICK(15);
    {
#pragma unroll
      for (int i = 0; i < CBW; ++i)
#pragma unroll
        for (int j = 0; j < NT / 8; ++j) {
          const float a0 = alpha[8 * j + 2 * t], a1 = alpha[8 * j + 2 * t + 1];
          acc[i][4 * j] *= a0;
          acc[i][4 * j + 1] *= a1;
          acc[i][4 * j + 2] *= a0;
          acc[i][4 * j + 3] *= a1;
        }
      wgmma_fence();
#pragma unroll
      for (int i = 0; i < CBW; ++i) {
        // warpgroup 3 (past the columns: read, not kept) takes a block too, so
        // that every warpgroup runs the same wgmma; descriptors stepped as in logits
        const uint64_t da = smem_desc(stage + 4 * (wg + 3 * i) * kBoxBytes, kBoxBytes, 256, kSwizzle32B);
        const uint64_t db = smem_desc(eT, 16, 256, kSwizzle32B);
#pragma unroll 1
        for (int u = 0; u < 2 * kRows / 16; ++u)  // the hi parts' k-steps, then the lo parts'
          wgmma_ss_ta<NT>(acc[i], da + (u & 7) * (16 * 32 >> 4), db + u * (NT * 32 >> 4), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < CBW; ++i) fence_regs(acc[i]);
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
        if (windowed && tt > 0) {
          softmax_acc(ring + ((tt - 1) % 2) * q.ks * kBoxBytes);
          __syncthreads();  // every warp is done with that stage
        }
        issue_next(tt);
      }
    };

    if constexpr (kI2T && kStopAt >= 2) {
      // i2t logits to their owners; each owner's softmax per head into every block
      logits(lgd, st, rT_s, k);
      stage_partials(lgd, xs, hf * nj, nj, ldx, rg);
      fence_proxy_async();
      __syncthreads();
      expect(bar_red, q.s * own * row_bytes);
      send_partials(reinterpret_cast<unsigned char*>(xs), reinterpret_cast<unsigned char*>(red), bar_red, q.rpo,
                    row_bytes, q.s, rank);
      if (q.stages == 2) issue_next(tt);
      L4P_TICK(2);
      cp_async_wait<0>();
      wait(bar_red, ph_red);
      L4P_TICK(11);
      __syncthreads();  // the per rows every thread copied
      for (int i = tid; i < own * k; i += kThreads) {
        const int slot = i / k, j = i - slot * k;
        const float* src = red + slot * ldx + j;
        float v = per_s[slot * ldp + j];
#pragma unroll
        for (int b = 0; b < kMaxCluster; ++b)
          if (b < q.s) v += src[b * q.rpo * ldx];
        red[(rank * q.rpo + slot) * ldx + j] = v;  // over this block's own partials, read
      }
      __syncthreads();
      const int heads = k / a.q;
      bf16* out_p = reinterpret_cast<bf16*>(out);
      for (int i = tid; i < own * heads; i += kThreads) {
        const int slot = i / heads, h0 = (i - slot * heads) * a.q;
        const float* xr = red + (rank * q.rpo + slot) * ldx + h0;
        float m = -INFINITY;
        for (int j = 0; j < a.q; ++j) m = fmaxf(m, xr[j]);
        float sum = 0.f;
        for (int j = 0; j < a.q; ++j) sum += expf(xr[j] - m);
        const float inv = 1.f / sum;
        for (int j = 0; j < a.q; ++j) {
          const bf16 pr = __float2bfloat16(expf(xr[j] - m) * inv);
          attn[(my_rows + slot) * ldk + h0 + j] = pr;
          out_p[slot * ldk + h0 + j] = pr;
        }
      }
      fence_proxy_async();
      __syncthreads();
      expect(bar_rcv, (kRows - own) * row_bytes);
      send_rows(attn, out, bar_rcv, my_rows, own, row_bytes, q.s, rank);
      L4P_TICK(12);
      wait(bar_rcv, ph_rcv);
      L4P_TICK(3);
    }
    if constexpr (kI2T && kStopAt >= 3) {
      // y = keys + attn . v2 + ob for the warp's 16 rows and its boxes, fp32:
      // once for the LayerNorm's moments, once more (the same operations, so
      // the same values) for the new keys, so that no y is held across the
      // moments' exchange
      const uint32_t a_row = smem_addr(attn + (rg * 16 + (lane & 15)) * ldk + (lane >> 4) * 8);
      auto y_box = [&](int b, float (&y)[2][4]) {
        y[0][0] = y[0][1] = y[0][2] = y[0][3] = 0.f;
        y[1][0] = y[1][1] = y[1][2] = y[1][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < kMaxK / 16; ++kk) {
          if (kk * 16 < k) {
            uint32_t af[4], bm[4];  // attn's fragments reloaded a box: held, they would take the registers
            ldmatrix_x4(af, a_row + kk * 32);
            ldmatrix_x4(bm, smem_addr(v2_s + (b * 16 + (lane & 7) + ((lane >> 4) << 3)) * ldv + kk * 16 +
                                      ((lane >> 3) & 1) * 8));
            mma_16816(y[0], af, bm[0], bm[1]);
            mma_16816(y[1], af, bm[2], bm[3]);
          }
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float2 ob = *reinterpret_cast<const float2*>(vec_s + 16 * b + 8 * e + 2 * t);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float2 kf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                st + b * kBoxBytes + sw32(rg * 16 + g + 8 * h, e) + 4 * t));
            y[e][2 * h] += kf.x + ob.x;
            y[e][2 * h + 1] += kf.y + ob.y;
          }
        }
      };
      // each row's (mean, M2) over the warp's columns: a box's four values a
      // lane, merged box by box, then over the quad (Chan et al.)
      // each row's (mean, M2) over the warp's columns: a box's four values a
      // lane, merged box by box, then over the quad (Chan et al.)
      float mean[2] = {0.f, 0.f}, m2[2] = {0.f, 0.f};
#pragma unroll
      for (int bi = 0; bi < KSH; ++bi) {
        if (bi < ynb) {
          float y[2][4];
          y_box(yb0 + bi, y);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float v0 = y[0][2 * h], v1 = y[0][2 * h + 1], v2 = y[1][2 * h], v3 = y[1][2 * h + 1];
            const float bm = ((v0 + v1) + (v2 + v3)) * 0.25f;
            const float bm2 = (v0 - bm) * (v0 - bm) + (v1 - bm) * (v1 - bm) + (v2 - bm) * (v2 - bm) + (v3 - bm) * (v3 - bm);
            const float d = bm - mean[h], f = 1.f / (bi + 1);  // 4 new values after 4 bi
            mean[h] += d * f;
            m2[h] += bm2 + d * d * (4.f * bi) * f;
          }
        }
      }
      L4P_TICK(4);
      if constexpr (kStopAt == 3) {
        if (mean[0] == -1.2345e-30f) a.wsum[0] = m2[1];  // keeps y
      }
      if constexpr (kStopAt >= 4) {
        if (ynb > 0) {
          float n_lane = 4.f * ynb;
#pragma unroll
          for (int off = 1; off < 4; off <<= 1) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float om = __shfl_xor_sync(0xffffffffu, mean[h], off), om2 = __shfl_xor_sync(0xffffffffu, m2[h], off);
              const float d = om - mean[h];
              m2[h] = (m2[h] + om2) + d * d * (0.5f * n_lane);
              mean[h] = 0.5f * (mean[h] + om);
            }
            n_lane *= 2.f;
          }
        }
        // the row's two halves combined in this block's slot of mom, which
        // goes to every block; then combined over the cluster
        float2* mine = mom + rank * kRows;
        if (hf == 1 && t == 0) {
          mine[rg * 16 + g] = make_float2(mean[0], m2[0]);
          mine[rg * 16 + g + 8] = make_float2(mean[1], m2[1]);
        }
        __syncthreads();
        if (hf == 0 && t == 0) {
          const float na = 16.f * kv0, nb = 16.f * (kv - kv0);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = rg * 16 + g + 8 * h;
            float2 v = make_float2(mean[h], m2[h]);
            if (nb > 0.f) {
              const float2 other = mine[r];
              const float d = other.x - v.x, nn = na + nb;
              v.x += d * (nb / nn);
              v.y += other.y + d * d * (na * nb / nn);
            }
            mine[r] = v;
          }
        }
        fence_proxy_async();
        __syncthreads();
        expect(bar_mom, (q.s - 1) * kRows * 8);
        send_rows(mom, mine, bar_mom, rank, 1, kRows * 8, q.s, rank);
        wait(bar_mom, ph_mom);
        L4P_TICK(5);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = rg * 16 + g + 8 * h;
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
        for (int bi = 0; bi < KSH; ++bi) {
          if (bi < ynb) {
            const int b = yb0 + bi;
            float y[2][4];
            y_box(b, y);
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = 16 * b + 8 * e + 2 * t;
              const float2 w = *reinterpret_cast<const float2*>(vec_s + q.w + col);
              const float2 bb = *reinterpret_cast<const float2*>(vec_s + 2 * q.w + col);
#pragma unroll
              for (int h = 0; h < 2; ++h)
                *reinterpret_cast<uint32_t*>(st + b * kBoxBytes + sw32(rg * 16 + g + 8 * h, e) + 4 * t) =
                    pack_bf16x2((y[e][2 * h] - mean[h]) * m2[h] * w.x + bb.x,
                                (y[e][2 * h + 1] - mean[h]) * m2[h] * w.y + bb.y);
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
      // next t2i logits to their owners; each owner's rows + spe (-inf past P) into every block
      logits(lgd, st, sT_s, k2);
      stage_partials(lgd, xs, hf * nj2, nj2, ldx, rg);
      fence_proxy_async();
      __syncthreads();
      expect(bar_red, q.s * own * row_bytes);
      send_partials(reinterpret_cast<unsigned char*>(xs), reinterpret_cast<unsigned char*>(red), bar_red, q.rpo,
                    row_bytes, q.s, rank);
      cp_async_wait<0>();
      if (!kI2T) window();
      wait(bar_red, ph_red);
      __syncthreads();  // the spe rows every thread copied
      L4P_TICK(7);
      float* out_l = reinterpret_cast<float*>(out);
      for (int i = tid; i < own * k2; i += kThreads) {
        const int slot = i / k2, j = i - slot * k2;
        float v = -INFINITY;
        if (row0 + my_rows + slot < p_hi) {
          const float* src = red + slot * ldx + j;
          v = spe_s[slot * lds + j];
#pragma unroll
          for (int b = 0; b < kMaxCluster; ++b)
            if (b < q.s) v += src[b * q.rpo * ldx];
        }
        lg2[(my_rows + slot) * ldx + j] = v;
        out_l[slot * ldx + j] = v;
      }
      fence_proxy_async();
      __syncthreads();
      if (tt + 1 < tiles) prefetch_rows(tt + 1);  // per and spe are read for this tile
      expect(bar_rcv, (kRows - own) * row_bytes);
      send_rows(lg2, out, bar_rcv, my_rows, own, row_bytes, q.s, rank);
      L4P_TICK(13);
      wait(bar_rcv, ph_rcv);
      L4P_TICK(8);
    }
    if constexpr (kStopAt >= 6) {
      // this tile's next logits into registers; their softmax and accumulation
      // follow at once, or in the next tile's window
#pragma unroll
      for (int pi = 0; pi < kPairs; ++pi) {
        const int p = warp + kWarps * pi;
        if (p < k2 / 2) {
          const int j = 2 * p + (lane >> 4);
#pragma unroll
          for (int u = 0; u < 8; ++u) x[pi][u] = lg2[(o + 16 * u) * ldx + j];
        }
      }
      if (!windowed) {
        __syncthreads();  // every row read before eT takes xbuf's place
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
  if (windowed && tiles > 0) {
    __syncthreads();
    softmax_acc(ring + ((tiles - 1) % 2) * q.ks * kBoxBytes);
  }

  // this block's columns of wsum = acc / l, or the split's partials
  const size_t cell = static_cast<size_t>(n) * splits + sp;
  if (wg < 3) {
#pragma unroll
    for (int i = 0; i < CBW; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = 64 * (wg + 3 * i) + 16 * w4 + g + 8 * h;
        if (col < nv) {
#pragma unroll
          for (int j = 0; j < NT / 8; ++j) {
#pragma unroll
            for (int v = 0; v < 2; ++v) {
              const int tok = 8 * j + 2 * t + v;
              if (tok < k2) {
                const float val = acc[i][4 * j + 2 * h + v];
                if (splits == 1)
                  a.wsum[(static_cast<size_t>(n) * k2 + tok) * c + c0 + col] = val / l_run[tok];
                else
                  a.acc_ws[(cell * k2 + tok) * c + c0 + col] = val;
              }
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
template <bool kI2T, int KS, int NT>
int launch(const Plan& q, const void* keys, void* keys_new, const Args& a, int n, cudaStream_t stream) {
  CUtensorMap tk, tn;
  int e = encode_bf16_3d(&tk, keys, a.c, a.c, a.p, n, kBoxCols, kRows, CU_TENSOR_MAP_SWIZZLE_32B);
  if (e == 0) e = encode_bf16_3d(&tn, kI2T ? keys_new : keys, a.c, a.c, a.p, n, kBoxCols, kRows,
                                 CU_TENSOR_MAP_SWIZZLE_32B);
  if (e != 0) return e;
  auto kernel = keys_cluster_kernel<kI2T, KS, NT>;
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
  // the widest blocks (C > 2816, rare) take a build of their own
  if (q.ks > kKS) return launch<false, kKSWide, 64>(q, keys, nullptr, a, n, s);
  return k > 48 ? launch<false, kKS, 64>(q, keys, nullptr, a, n, s) : launch<false, kKS, 48>(q, keys, nullptr, a, n, s);
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
  return k2 > 48 ? launch<true, kKS, 64>(q, keys, keys_new, a, n, static_cast<cudaStream_t>(stream))
                 : launch<true, kKS, 48>(q, keys, keys_new, a, n, static_cast<cudaStream_t>(stream));
}
