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
// window: far above the ~295 FLOP/byte ridge. The four GEMMs carry ~80% of
// the time, so the design puts them on wgmma and keeps every elementwise
// step of the block in a GEMM epilogue: the only activations that go
// through device memory are the GEMM operands themselves (LN output, q/k/v,
// attention output, the MLP hidden) and the residual stream.
//
// gemm_nt: C (M, N) = A (M, K) . W (N, K)^T in bf16 with fp32 accumulators,
// W in nn.Linear's (out, in) layout, so no weight is repacked: both operands
// are K-major as they lie, which is SS wgmma's layout without a transpose.
// - A block has two consumer warpgroups, each owning 64 rows of a 128 x BN
//   output tile, and a producer warpgroup: its first thread issues every
//   TMA load, its other 3 warps are the epilogue (384 threads; setmaxnreg
//   72 / 216. A lone producer warp cannot free what setmaxnreg.inc waits
//   for, attention.cuh).
// - K goes in steps of 64: one 128-byte row per operand row, loaded by TMA
//   with 128-byte swizzle (CU_TENSOR_MAP_SWIZZLE_128B; the descriptor
//   layout in sm90.cuh) into a ring of 3-4 stages (as many as 227 KB hold
//   beside the staging buffer: 3 at BN = 256, 4 at 176), each with
//   a full barrier (the producer's expect_tx and the TMA bytes) and an
//   empty barrier (an arrival from each consumer thread). A stage is 4
//   wgmma m64nBNk16 per warpgroup, the next stage's products in flight
//   while the previous stage is released (wgmma.wait_group 1).
// - Persistent: one block per SM walks the output tiles (tile, tile +
//   gridDim.x, ...). The ring runs on across tiles, so the producer loads
//   the next tile's stages while the last one's epilogue runs. The walk
//   runs across N under one 128-row panel of A: each panel of A is read
//   from device memory once and reused from L2 by the N / BN tiles after
//   it, and every W of the block (at most 6144 x 1408 bf16, 17.3 MB) stays
//   in the 50 MB L2. Down M under one panel of W measured up to 15% slower
//   at M = 10240 and up to 4% faster at 4096 (PERF.md).
// - The epilogue overlaps the next tile's products. The consumers fetch a
//   tile's bias pairs while its first k-step runs; after its last they put
//   bf16(acc + bias) into a staging buffer of one tile (short unrolled
//   code) and go on to the next tile, while the epilogue warps finish the
//   staged tile from a rolled loop, 16-byte chunks along its rows. A fully
//   unrolled epilogue from the accumulators cost ~8-11 us a tile whatever
//   its arithmetic (PERF.md), and the consumers' own reads of the stream
//   ~0.03 ms per product.
// - BN, the tile width, is chosen per product by
//   ops/fused_encoder.py:gemm_tile_width, from 176 and 256: the wider that
//   divides N, else the one with the less padding. At the giant widths: qkv
//   N = 4224 -> 176 (24 tiles across), proj and fc2 N = 1408 -> 176 (8; at
//   M = 4096, 256 tiles, 1.94 waves on 132 SMs, where 256 would leave half
//   of its 192 tiles half empty), fc1 N = 6144 -> 256 (24). The wider tile
//   reads the less operand traffic per FLOP; 176 divides the widths 256
//   does not. A width of 192 (which divides 4224) measured 2-9% slower
//   than 176 on qkv and slower on the other products (PERF.md).
// - Ragged M, N and K edges come from the tensor maps' zero fill on load
//   and from masks on store. The bias is the bf16 parameter, added in
//   fp32; per 8-column chunk v = bf16(acc + bias) of the staging buffer:
//   QKV      v written head-major as (3, B, H, N, head_row_pitch(D)), so
//            attention reads q, k and v without copies; the tile's row and
//            column offsets are computed once into shared memory (four
//            runtime divisions a chunk cost 0.05 ms at M = 10240); D is a
//            multiple of 8, so a chunk lies in one head;
//   GELU     bf16(gelu_tanh(v)), the bf16 lane of ops/conv.py:gelu;
//   RESIDUAL x <- bf16(x + v) in place on the residual stream (the JAX
//            package is immutable and writes a new x; the port updates it
//            in place to save a copy per product), and optionally the same
//            value into a second tensor (a hook slot). The epilogue warps
//            read x in 16-byte loads, 4 chunks in flight a thread; a chunk
//            is read and written by one thread and tiles are disjoint, so
//            the in-place update needs no ordering across tiles.
// ln_rows: LayerNorm of (M, E) bf16 rows with two-pass fp32 moments, one
// warp per row, bf16 out.
//
// Numerics are those of the port's Block (models/encoder.py) and the JAX
// `_block` step for step: fp32 LN statistics, fp32 accumulation, bias in
// fp32 then bf16, residual adds in bf16, tanh GELU. Attention divides by
// the softmax sum at the end (attention.cuh); the TPU kernel normalises the
// probabilities before P.V, so the two differ in low bits.
//
// Build-time hooks for scripts/encoder_bounds.py only (L4P_GEMM_LOADS_ONLY,
// L4P_GEMM_NO_EPILOGUE and L4P_GEMM_NO_STORE give kernels whose times mean
// something and whose results do not; the others stay exact):
//   L4P_GEMM_LOADS_ONLY          the ring and its TMA loads alone: no
//                                products, no epilogue;
//   L4P_GEMM_NO_EPILOGUE         the products without the epilogue (their
//                                results kept live: ptxas drops a wgmma
//                                whose results nobody reads);
//   L4P_GEMM_NO_STORE            the epilogue without its global stores;
//   L4P_GEMM_ONE_TILE_PER_BLOCK  one block per output tile, not one per SM;
//   L4P_GEMM_RASTER_M            the walk runs down M under one panel of W;
//   L4P_GEMM_STAGES_MAX=n        at most n ring stages (default 8).

#include <math.h>

#include "attention.cuh"

#ifndef L4P_GEMM_STAGES_MAX
#define L4P_GEMM_STAGES_MAX 8
#endif

namespace {

using namespace l4p;
using namespace l4p::sm90;
using bf16 = __nv_bfloat16;

constexpr int kBM = 128;  // rows per output tile: two consumer warpgroups of 64
constexpr int kBK = 64;   // K per ring stage: one 128-byte swizzle row of bf16
constexpr int kATileBytes = kBM * kBK * 2;
constexpr int kConsumers = 2;  // consumer warpgroups
constexpr int kConsumerThreads = kConsumers * 128;
constexpr int kGemmThreads = kConsumerThreads + 128;  // and the producer warpgroup
constexpr int kEpilogueThreads = 96;  // warps 1-3 of the producer warpgroup store the tiles
constexpr int kProducerRegs = 72;     // the TMA thread and the epilogue warps
constexpr int kConsumerRegs = 216;    // 128 x 72 + 256 x 216 = the 384 x 168 the launch holds
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may use on sm_90

template <int BN>
__host__ __device__ constexpr int gemm_stage_bytes() {
  return kATileBytes + BN * kBK * 2;
}
// The staging buffer holds one 128 x BN tile of bf16 results, rows
// staging_row_words 32-bit words apart: BN / 2 rounded to 4 mod 8, so the
// fragment's 8 rows x 4 threads of a warp write 32 different banks.
template <int BN>
__host__ __device__ constexpr int staging_row_words() {
  return BN / 2 % 8 == 4 ? BN / 2 : BN / 2 + 4;
}
template <int BN>
__host__ __device__ constexpr int staging_bytes() {
  return kBM * staging_row_words<BN>() * 4;
}
// the 1024-byte alignment slack, then room for the barriers and QKV's
// (128 + BN / 8) offsets of 8 bytes
constexpr int kSmemReserve = 1024 + 1536;
// as many ring stages as fit beside the staging buffer and the reserve, at
// most L4P_GEMM_STAGES_MAX: 3 at BN = 256, 4 at 176
template <int BN>
__host__ __device__ constexpr int gemm_stages() {
  return (kMaxSmem - kSmemReserve - staging_bytes<BN>()) / gemm_stage_bytes<BN>() < L4P_GEMM_STAGES_MAX
             ? (kMaxSmem - kSmemReserve - staging_bytes<BN>()) / gemm_stage_bytes<BN>()
             : L4P_GEMM_STAGES_MAX;
}
template <int BN>
__host__ __device__ constexpr int gemm_smem_bytes() {
  return gemm_stages<BN>() * (gemm_stage_bytes<BN>() + 16) + 16 + (kBM + BN / 8) * 8 + staging_bytes<BN>() + 1024;
}

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

// The QKV epilogue's destination offset of (row, col) is row_part(row) +
// col_part(col): (((s * batch + b) * heads + h) * tokens + t) * pitch + d
// with row = b * tokens + t and col = s * E + h * head_dim + d.
__device__ __forceinline__ size_t qkv_row_part(int r, const EpilogueArgs& ep) {
  const int b = r / ep.tokens;
  return (static_cast<size_t>(b) * ep.heads * ep.tokens + (r - b * ep.tokens)) * ep.head_pitch;
}

__device__ __forceinline__ size_t qkv_col_part(int col, int m, const EpilogueArgs& ep) {
  const int e = ep.heads * ep.head_dim;
  const int s = col / e;
  const int f = col - s * e;
  const int h = f / ep.head_dim;
  const size_t head = static_cast<size_t>(ep.tokens) * ep.head_pitch;
  return static_cast<size_t>(s) * (m / ep.tokens) * ep.heads * head + h * head + (f - h * ep.head_dim);
}

// The consumer thread's bias pairs of one 128 x BN tile (columns
// n0 + 8j + 2t, +1 for each 8-column chunk j), fetched while the tile's
// first k-step runs.
template <int BN>
struct TileBias {
  uint32_t pair[BN / 8];

  __device__ __forceinline__ void fetch(int n0, int lane, int n, const EpilogueArgs& ep) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + j * 8 + (lane % 4) * 2;
      pair[j] = col < n ? __ldg(reinterpret_cast<const unsigned int*>(ep.bias + col)) : 0u;
    }
  }
};

// bf16(acc + bias) for the accumulators (a0, a1) of two neighbouring columns.
__device__ __forceinline__ uint32_t biased_pair(float a0, float a1, uint32_t bias) {
  const float2 fb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&bias));
  return pack_bf16x2(a0 + fb.x, a1 + fb.y);
}

// A consumer thread puts its fragment of one 128 x BN tile into the staging
// buffer as bf16(acc + bias) pairs: rows `row` and row + 8 of the tile
// (0..127), columns 8j + 2t, +1 of the wgmma D fragment (sm90.cuh). Short
// unrolled code: a fully unrolled epilogue from the accumulators cost ~8-11
// us a tile whatever its arithmetic (PERF.md).
template <int BN>
__device__ __forceinline__ void stage_tile(const float (&acc)[BN / 2], const TileBias<BN>& bias, uint32_t* staging,
                                           int row, int lane) {
  constexpr int kRowWords = staging_row_words<BN>();
  const int t = lane % 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    staging[row * kRowWords + j * 4 + t] = biased_pair(acc[4 * j], acc[4 * j + 1], bias.pair[j]);
    staging[(row + 8) * kRowWords + j * 4 + t] = biased_pair(acc[4 * j + 2], acc[4 * j + 3], bias.pair[j]);
  }
}

// The epilogue threads' work on one staged tile at (m0, n0): chunk c (8
// columns of a row, 16 bytes) is row c / (BN / 8), chunk c % (BN / 8), so
// consecutive threads cover a row. For RESIDUAL each thread takes 4 chunks
// kEpilogueThreads apart at a time and loads their stream before the first
// use; the loop itself is rolled. Per chunk (v: the staged bf16):
//   QKV      v into the head-major rows, 16 bytes at once (D % 8 == 0, so
//            a chunk lies in one head);
//   GELU     bf16(gelu_tanh(v));
//   RESIDUAL bf16(x + v) into the stream and, if given, the hook copy.
template <int EPI, int BN>
__device__ __forceinline__ void store_staged(const uint32_t* staging, const size_t* qkv_offsets, int et, int m0,
                                             int n0, int m, int n, const EpilogueArgs& ep) {
  constexpr int kChunks = BN / 8;
  constexpr int kRowWords = staging_row_words<BN>();
  constexpr int kTotal = kBM * kChunks;
  constexpr int kBatch = EPI == kRESIDUAL ? 4 : 1;
#pragma unroll 1
  for (int c0 = et; c0 < kTotal; c0 += kBatch * kEpilogueThreads) {
    uint4 x[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int c = c0 + b * kEpilogueThreads;
      const int r = m0 + c / kChunks, col = n0 + c % kChunks * 8;
      if (EPI == kRESIDUAL && c < kTotal && r < m && col < n)
        x[b] = *reinterpret_cast<const uint4*>(ep.out + static_cast<size_t>(r) * n + col);
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int c = c0 + b * kEpilogueThreads;
      const int r = m0 + c / kChunks, col = n0 + c % kChunks * 8;
      if (c >= kTotal || r >= m || col >= n) continue;
      uint4 v = *reinterpret_cast<const uint4*>(staging + (c / kChunks) * kRowWords + (c % kChunks) * 4);
      uint32_t* w = reinterpret_cast<uint32_t*>(&v);
      if (EPI == kGELU) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
          w[i] = pack_bf16x2(gelu_tanh(f.x), gelu_tanh(f.y));
        }
      } else if (EPI == kRESIDUAL) {
        const uint32_t* xw = reinterpret_cast<const uint32_t*>(&x[b]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
          const float2 xf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xw[i]));
          w[i] = pack_bf16x2(xf.x + f.x, xf.y + f.y);
        }
      }
#ifdef L4P_GEMM_NO_STORE
      if (v.x != 0x7FC17FC1u) continue;  // never stores: the epilogue without its global stores
#endif
      if (EPI == kQKV) {
        *reinterpret_cast<uint4*>(ep.out + qkv_offsets[c / kChunks] + qkv_offsets[kBM + c % kChunks]) = v;
      } else {
        *reinterpret_cast<uint4*>(ep.out + static_cast<size_t>(r) * n + col) = v;
        if (EPI == kRESIDUAL && ep.copy_out != nullptr)
          *reinterpret_cast<uint4*>(ep.copy_out + static_cast<size_t>(r) * n + col) = v;
      }
    }
  }
}

// Named barrier 1 over the epilogue threads.
__device__ __forceinline__ void epilogue_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kEpilogueThreads) : "memory");
}

// QKV: the epilogue threads put the head-major offsets of the tile at (m0,
// n0) into shared memory: qkv_row_part of its 128 rows, then qkv_col_part of
// its BN / 8 chunks, so that a chunk's destination costs two loads, not four
// runtime divisions.
template <int BN>
__device__ __forceinline__ void qkv_tile_offsets(size_t* offsets, int et, int m0, int n0, int m, int n,
                                                 const EpilogueArgs& ep) {
  for (int i = et; i < kBM + BN / 8; i += kEpilogueThreads) {
    if (i < kBM)
      offsets[i] = m0 + i < m ? qkv_row_part(m0 + i, ep) : 0;
    else
      offsets[i] = n0 + (i - kBM) * 8 < n ? qkv_col_part(n0 + (i - kBM) * 8, m, ep) : 0;
  }
}

// Output tile `tile` of the walk -> its first row and column. Consecutive
// tiles run across N under one 128-row panel of A (or, under
// L4P_GEMM_RASTER_M, down M under one BN-row panel of W).
template <int BN>
__device__ __forceinline__ void tile_origin(int tile, int m, int n, int& m0, int& n0) {
#ifdef L4P_GEMM_RASTER_M
  const int tiles_m = (m + kBM - 1) / kBM;
  m0 = (tile % tiles_m) * kBM;
  n0 = (tile / tiles_m) * BN;
#else
  const int tiles_n = (n + BN - 1) / BN;
  m0 = (tile / tiles_n) * kBM;
  n0 = (tile % tiles_n) * BN;
#endif
}

template <int EPI, int BN>
__global__ void __launch_bounds__(kGemmThreads, 1)
    gemm_nt_kernel(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_w, int m, int n,
                   int k, EpilogueArgs ep) {
  constexpr int kStages = gemm_stages<BN>();
  constexpr int kStageBytes = gemm_stage_bytes<BN>();
  constexpr int kLoader = kConsumerThreads;  // the producer thread that issues every TMA load
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  // one staged tile of results, after the ring
  uint32_t* staging = reinterpret_cast<uint32_t*>(smem + kStages * kStageBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes + staging_bytes<BN>());  // A and W arrived
  uint64_t* empty = full + kStages;  // both consumer warpgroups are done with a stage
  uint64_t* staged = empty + kStages;  // the consumers put a tile into the staging buffer
  uint64_t* stored = staged + 1;       // the epilogue warps have read it
  size_t* qkv_offsets = reinterpret_cast<size_t*>(stored + 1);  // QKV: the tile's row and column offsets
  const int tiles = ((m + kBM - 1) / kBM) * ((n + BN - 1) / BN);
  const int nk = (k + kBK - 1) / kBK;

  if (threadIdx.x == kLoader) {
    prefetch_tensor_map(&tm_a);
    prefetch_tensor_map(&tm_w);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerThreads);
    }
    mbar_init(staged, kConsumerThreads);
    mbar_init(stored, kEpilogueThreads);
    fence_barrier_init();
  }
  __syncthreads();

  // the warpgroup, warp-uniform by construction (so that ptxas can budget
  // registers per branch after setmaxnreg)
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (wg == kConsumers) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kLoader) {
      int it = 0;  // k-steps issued by this block over all its tiles: the ring position
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        int m0, n0;
        tile_origin<BN>(tile, m, n, m0, n0);
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % kStages;
          if (it >= kStages) mbar_wait(&empty[s], (it / kStages - 1) & 1);
          unsigned char* stage = smem + s * kStageBytes;
          mbar_arrive_expect_tx(&full[s], kStageBytes);
          tma_load_3d(stage, &tm_a, &full[s], kt * kBK, m0, 0);
          tma_load_3d(stage + kATileBytes, &tm_w, &full[s], kt * kBK, n0, 0);
        }
      }
    }
#if !defined(L4P_GEMM_LOADS_ONLY) && !defined(L4P_GEMM_NO_EPILOGUE)
    else if (threadIdx.x >= kLoader + 32) {  // the epilogue warps: each staged tile to device memory
      const int et = threadIdx.x - kLoader - 32;
      int count = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++count) {
        int m0, n0;
        tile_origin<BN>(tile, m, n, m0, n0);
        if (EPI == kQKV) {
          epilogue_sync();  // the last tile's offsets are no longer read
          qkv_tile_offsets<BN>(qkv_offsets, et, m0, n0, m, n, ep);
          epilogue_sync();
        }
        mbar_wait(staged, count & 1);
        store_staged<EPI, BN>(staging, qkv_offsets, et, m0, n0, m, n, ep);
        mbar_arrive(stored);
      }
    }
#endif
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    int it = 0, count = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++count) {
      int m0, n0;
      tile_origin<BN>(tile, m, n, m0, n0);
      const int row = wg * 64 + warp * 16 + lane / 4;  // this thread's rows of the tile: row and row + 8
      TileBias<BN> bias;
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % kStages;
        mbar_wait(&full[s], (it / kStages) & 1);
#ifndef L4P_GEMM_LOADS_ONLY
        // this warpgroup's 64 rows of A start 64 rows x 128 bytes into the stage
        const uint64_t desc_a = smem_desc(smem + s * kStageBytes + wg * 64 * 128, 16, 1024, kSwizzle128B);
        const uint64_t desc_w = smem_desc(smem + s * kStageBytes + kATileBytes, 16, 1024, kSwizzle128B);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < kBK / 16; ++ks)  // k16 step ks: 32 bytes into the 128-byte rows
          wgmma_ss<BN>(acc, desc_a + 2 * ks, desc_w + 2 * ks, kt > 0 || ks > 0);
        wgmma_commit();
#endif
#if !defined(L4P_GEMM_LOADS_ONLY) && !defined(L4P_GEMM_NO_EPILOGUE)
        if (kt == 0) bias.fetch(n0, lane, n, ep);  // while the first k-step's products run
#endif
#ifndef L4P_GEMM_LOADS_ONLY
        wgmma_wait<1>();  // the previous k-step's products are done with their stage
#endif
        if (kt > 0) mbar_arrive(&empty[(it - 1) % kStages]);
      }
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(&empty[(it - 1) % kStages]);
#if defined(L4P_GEMM_NO_EPILOGUE)
      // keeps the products live (ptxas drops a wgmma whose results nobody reads)
      float keep = 0.f;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) keep += acc[i];
      if (keep == 1.2345e-30f) ep.out[0] = bf16(0.f);
#elif !defined(L4P_GEMM_LOADS_ONLY)
      if (count > 0) mbar_wait(stored, (count - 1) & 1);  // the epilogue warps have read the last tile
      stage_tile<BN>(acc, bias, staging, row, lane);
      mbar_arrive(staged);
#endif
    }
  }
}

int sm_count() {
  static const int count = [] {
    int device = 0, c = 0;
    if (cudaGetDevice(&device) != cudaSuccess ||
        cudaDeviceGetAttribute(&c, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
      return 0;
    return c;
  }();
  return count;
}

// Encodes A's and W's tensor maps and launches one block per SM (or, under
// L4P_GEMM_ONE_TILE_PER_BLOCK, one block per tile); returns 0, a
// cudaError_t of a refused launch, or a negative sm90::tensor_map_error.
template <int EPI, int BN>
int launch_gemm(const bf16* a, const bf16* w, int m, int n, int k, const EpilogueArgs& ep, cudaStream_t stream) {
  CUtensorMap ta, tw;
  int err = sm90::encode_bf16_3d(&ta, a, k, k, m, 1, kBK, kBM, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == 0) err = sm90::encode_bf16_3d(&tw, w, k, k, n, 1, kBK, BN, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != 0) return err;
  constexpr int smem = gemm_smem_bytes<BN>();
  auto* kernel = gemm_nt_kernel<EPI, BN>;
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles = ((m + kBM - 1) / kBM) * ((n + BN - 1) / BN);
#ifdef L4P_GEMM_ONE_TILE_PER_BLOCK
  const int grid = tiles;
#else
  const int sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const int grid = tiles < sms ? tiles : sms;
#endif
  kernel<<<grid, kGemmThreads, smem, stream>>>(ta, tw, m, n, k, ep);
  return static_cast<int>(cudaGetLastError());
}

template <int EPI>
int launch_gemm_width(const bf16* a, const bf16* w, int m, int n, int k, int tile_n, const EpilogueArgs& ep,
                      cudaStream_t stream) {
  switch (tile_n) {
    case 176:
      return launch_gemm<EPI, 176>(a, w, m, n, k, ep, stream);
    case 256:
      return launch_gemm<EPI, 256>(a, w, m, n, k, ep, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
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

// epilogue: 0 QKV (out (3, m / tokens, heads, tokens, head_row_pitch(head_dim)), n == 3 * heads * head_dim,
// head_dim % 8 == 0),
// 1 GELU (out (m, n)), 2 RESIDUAL (out (m, n) updated in place, copy_out (m, n) or null); tile_n: the output
// tile's width, 176 or 256 (ops/fused_encoder.py:gemm_tile_width).
extern "C" int l4p_gemm_nt_bf16(const void* a, const void* w, const void* bias, void* out, void* copy_out, int m,
                                int n, int k, int epilogue, int tokens, int heads, int head_dim, int tile_n,
                                void* stream) {
  // a and w are TMA bases; out and copy_out take 16-byte stores, bias 4-byte loads
  if (m <= 0 || n <= 0 || k <= 0 || n % 8 != 0 || k % 8 != 0 || !aligned16(a) || !aligned16(w) ||
      !aligned16(out) || (copy_out != nullptr && !aligned16(copy_out)) ||
      (reinterpret_cast<uintptr_t>(bias) & 3) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (epilogue == kQKV && (tokens <= 0 || m % tokens != 0 || heads <= 0 || head_dim <= 0 || head_dim % 8 != 0 ||
                           n != 3 * heads * head_dim))
    return static_cast<int>(cudaErrorInvalidValue);
  EpilogueArgs ep{static_cast<const bf16*>(bias), static_cast<bf16*>(out), static_cast<bf16*>(copy_out), tokens,
                  heads, head_dim, head_row_pitch(head_dim)};
  const bf16* pa = static_cast<const bf16*>(a);
  const bf16* pw = static_cast<const bf16*>(w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (epilogue == kQKV) return launch_gemm_width<kQKV>(pa, pw, m, n, k, tile_n, ep, s);
  if (epilogue == kGELU) return launch_gemm_width<kGELU>(pa, pw, m, n, k, tile_n, ep, s);
  if (epilogue == kRESIDUAL) return launch_gemm_width<kRESIDUAL>(pa, pw, m, n, k, tile_n, ep, s);
  return static_cast<int>(cudaErrorInvalidValue);
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
