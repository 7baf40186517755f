// The two-way transformer's image side for Hopper (sm_90a): t2i_flash and
// i2t_ln_t2i of l4p_tpu_torch/ops/fused_keys.py.
//
// Replaces the Pallas TPU kernels l4p_tpu/ops/fused_keys.py:_t2i_kernel
// (with _t2i_update) and :_i2t_t2i_kernel. Both stream the per-query image
// embedding `keys` (N, P, C) = (128, 2048, 1408) bf16, ~738 MB per window,
// against ~48 token columns (K = 8 heads x 6 tokens), so their products are
// rank-48: ~35 GFLOP per keys pass against 738 MB, ~48 FLOP/byte, well
// below the card's ~295 FLOP/byte ridge. What bounds them is device-memory
// bandwidth: the passes over `keys`.
//
// The TPU kernels keep a (K, C) = (48, 1408) fp32 accumulator (270 KB of
// VMEM) across a sequential grid over P, and the i2t LayerNorm needs whole
// 1408-wide rows. A Hopper block has at most 227 KB of shared memory and
// blocks run in no order, so the work is split by what each step needs:
//
//   row kernels (16 keys rows x all C per block, 8 warps): the logits
//     keys . B (B = the (K, C) token operand, fragments read from L2) with
//     mma.sync, split over C across warps and summed in shared memory. For
//     i2t_ln_t2i the same block then takes each head's softmax over its
//     tokens directly (no group-sum matmul: the TPU's lane-layout detour),
//     multiplies by v2 on the tensor cores, adds the out bias and the
//     residual in fp32, takes a two-pass LayerNorm over the whole row,
//     writes the new keys and computes the next layer's t2i logits on them
//     while they are still in shared memory;
//   t2i_acc (flash-decoding over P): a block owns 128 columns of C and
//     P_SPLIT rows of P, takes the column max of its logits, and adds
//     exp(logit - max) (cast to bf16, as the TPU kernel casts e) times its
//     keys tile into a (K, 128) fp32 accumulator in registers with
//     mma.sync (E^T from shared memory, keys through ldmatrix.trans),
//     cp.async double-buffered; it writes (max, sum, acc) partials;
//   t2i_combine rescales and adds the partials: wsum = sum acc / sum l.
//
// Passes over keys (each 738 MB at the giant shape): t2i_flash reads it
// twice (logits, weighted sum), i2t_ln_t2i reads it once, writes the new
// keys once and reads them once more for the weighted sum: 2 + 3 + 3 = 8
// per window against the TPU kernels' 5. The logits (N, P, K) f32 (50 MB)
// and the partials (N, P/P_SPLIT, K, C) f32 are the price of fitting the
// accumulator into a block.
//
// Numerics: logits, softmax statistics, accumulators, residual and
// LayerNorm are fp32; the i2t probabilities are normalised then cast to
// bf16, the t2i exponentials cast to bf16 unnormalised (the TPU kernel's
// points). Requires C % 16 == 0 and K, K2 multiples of 16 up to 64; ragged
// P is masked.

#include <math.h>

#include "mma_utils.cuh"

namespace {

using namespace l4p;
using bf16 = __nv_bfloat16;

constexpr int kMaxK = 64;
constexpr int kRowTile = 16;  // keys rows per row-kernel block (one m16 tile)
constexpr int kRowWarps = 8;
constexpr int kRowThreads = kRowWarps * 32;
constexpr int kLgStride = kMaxK;      // f32 logits tile row stride
constexpr int kAttnStride = kMaxK + 8;  // bf16 probabilities tile row stride
constexpr int kRedFloats = kRowWarps * kRowTile * kMaxK;

constexpr int kAccCols = 128;  // C columns per t2i_acc block, 32 per warp
constexpr int kAccRows = 64;   // keys rows per t2i_acc tile
constexpr int kAccThreads = 128;
constexpr int kKStride = kAccCols + 8;
constexpr int kEStride = kAccRows + 8;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Copies rows [row0, row0 + 16) of a (p, c) bf16 matrix into a 16 x (c + 8)
// shared tile, zero rows >= p, and waits for it.
__device__ void load_rows(bf16* tile, const bf16* src, int row0, int p, int c) {
  const int chunks = c / 8;
  for (int i = threadIdx.x; i < kRowTile * chunks; i += kRowThreads) {
    const int r = i / chunks, col = (i % chunks) * 8;
    const bool valid = row0 + r < p;
    const bf16* g = valid ? src + static_cast<size_t>(row0 + r) * c + col : src;
    cp_async_16(smem_addr(tile + r * (c + 8) + col), g, valid ? 16 : 0);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
}

// lg[r][j] = sum_c tile[r][c] * bT[j][c] for the 16 tile rows and j < k.
// Warps take every 8th 16-column step of C; `red` holds their partials.
__device__ void rowtile_logits(const bf16* tile, int c, const bf16* __restrict__ bT, int k, float* red,
                               float* lg) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float acc[kMaxK / 8][4];
#pragma unroll
  for (int j = 0; j < kMaxK / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  for (int ks = warp; ks < c / 16; ks += kRowWarps) {
    uint32_t a[4];
    ldmatrix_x4(a, smem_addr(tile + (lane & 15) * (c + 8) + ks * 16 + (lane >> 4) * 8));
    const int kc = ks * 16 + (lane & 3) * 2;
#pragma unroll
    for (int j = 0; j < kMaxK / 8; ++j) {
      if (j * 8 < k) {
        const bf16* b = bT + static_cast<size_t>(j * 8 + (lane >> 2)) * c + kc;
        mma_16816(acc[j], a, ldg_u32(b), ldg_u32(b + 8));
      }
    }
  }
  float* mine = red + warp * kRowTile * kMaxK;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
#pragma unroll
  for (int j = 0; j < kMaxK / 8; ++j) {
    if (j * 8 < k) {
      mine[g * kMaxK + j * 8 + t2] = acc[j][0];
      mine[g * kMaxK + j * 8 + t2 + 1] = acc[j][1];
      mine[(g + 8) * kMaxK + j * 8 + t2] = acc[j][2];
      mine[(g + 8) * kMaxK + j * 8 + t2 + 1] = acc[j][3];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kRowTile * k; i += kRowThreads) {
    const int r = i / k, j = i % k;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kRowWarps; ++w) s += red[(w * kRowTile + r) * kMaxK + j];
    lg[r * kLgStride + j] = s;
  }
  __syncthreads();
}

// out[row][j] = lg[r][j] + add[row][j] for the tile's rows < p.
__device__ void store_logits(const float* lg, const float* __restrict__ add, float* out, int row0, int p, int k) {
  for (int i = threadIdx.x; i < kRowTile * k; i += kRowThreads) {
    const int r = i / k, j = i % k;
    if (row0 + r < p) {
      const size_t idx = static_cast<size_t>(row0 + r) * k + j;
      out[idx] = lg[r * kLgStride + j] + add[idx];
    }
  }
}

size_t logits_smem(int c) {
  return static_cast<size_t>(kRowTile) * (c + 8) * sizeof(bf16) + (kRedFloats + kRowTile * kLgStride) * sizeof(float);
}

// logits = keys . sT^T + spe, 16 rows per block; grid (ceil(p / 16), n).
__global__ void __launch_bounds__(kRowThreads)
    t2i_logits_kernel(const bf16* __restrict__ keys, const bf16* __restrict__ sT, const float* __restrict__ spe,
                      float* __restrict__ logits, int p, int c, int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* tile = reinterpret_cast<bf16*>(smem);
  float* red = reinterpret_cast<float*>(tile + kRowTile * (c + 8));
  float* lg = red + kRedFloats;
  const size_t n = blockIdx.y;
  const int row0 = blockIdx.x * kRowTile;
  load_rows(tile, keys + n * p * c, row0, p, c);
  rowtile_logits(tile, c, sT + n * k * c, k, red, lg);
  store_logits(lg, spe + n * p * k, logits + n * p * k, row0, p, k);
}

size_t i2t_smem(int c) {
  const size_t scratch = static_cast<size_t>(kRowTile) * c > kRedFloats ? static_cast<size_t>(kRowTile) * c
                                                                        : static_cast<size_t>(kRedFloats);
  return static_cast<size_t>(kRowTile) * (c + 8) * sizeof(bf16) + (scratch + kRowTile * kLgStride) * sizeof(float) +
         kRowTile * kAttnStride * sizeof(bf16);
}

// i2t attention + residual + LayerNorm + next t2i logits, 16 rows per
// block; grid (ceil(p / 16), n). `q` = tokens per head (k / heads).
__global__ void __launch_bounds__(kRowThreads)
    i2t_ln_kernel(const bf16* __restrict__ keys, const bf16* __restrict__ rT, const float* __restrict__ per,
                  const bf16* __restrict__ v2T, const float* __restrict__ ob, const float* __restrict__ lnw,
                  const float* __restrict__ lnb, const bf16* __restrict__ sT, const float* __restrict__ spe,
                  bf16* __restrict__ keys_new, float* __restrict__ logits2, int p, int c, int k, int k2, int q,
                  float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int stride = c + 8;
  bf16* tile = reinterpret_cast<bf16*>(smem);
  float* scratch = reinterpret_cast<float*>(tile + kRowTile * stride);  // logit partials, then y
  const int scratch_floats = kRowTile * c > kRedFloats ? kRowTile * c : kRedFloats;
  float* lg = scratch + scratch_floats;
  bf16* attn = reinterpret_cast<bf16*>(lg + kRowTile * kLgStride);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t n = blockIdx.y;
  const int row0 = blockIdx.x * kRowTile;

  load_rows(tile, keys + n * p * c, row0, p, c);
  rowtile_logits(tile, c, rT + n * k * c, k, scratch, lg);

  // softmax of each head over its q tokens, normalised, cast to bf16
  const int heads = k / q;
  for (int i = threadIdx.x; i < kRowTile * heads; i += kRowThreads) {
    const int r = i / heads, h0 = (i % heads) * q;
    float* x = lg + r * kLgStride + h0;
    const float* add = per + (n * p + (row0 + r < p ? row0 + r : 0)) * k + h0;
    float m = -INFINITY;
    for (int t = 0; t < q; ++t) {
      x[t] += add[t];
      m = fmaxf(m, x[t]);
    }
    float s = 0.f;
    for (int t = 0; t < q; ++t) {
      x[t] = expf(x[t] - m);
      s += x[t];
    }
    for (int t = 0; t < q; ++t) attn[r * kAttnStride + h0 + t] = __float2bfloat16(x[t] / s);
  }
  __syncthreads();

  // y = keys + attn . v2 + ob (fp32), one 8-column tile of C at a time
  uint32_t af[kMaxK / 16][4];
#pragma unroll
  for (int s = 0; s < kMaxK / 16; ++s)
    if (s * 16 < k) ldmatrix_x4(af[s], smem_addr(attn + (lane & 15) * kAttnStride + s * 16 + (lane >> 4) * 8));
  const bf16* v2n = v2T + n * c * k;
  float* y = scratch;
  const int g = lane >> 2;
  for (int j = warp; j < c / 8; j += kRowWarps) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    const bf16* b = v2n + static_cast<size_t>(j * 8 + g) * k + (lane & 3) * 2;
#pragma unroll
    for (int s = 0; s < kMaxK / 16; ++s)
      if (s * 16 < k) mma_16816(acc, af[s], ldg_u32(b + s * 16), ldg_u32(b + s * 16 + 8));
    const int col = j * 8 + (lane & 3) * 2;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = g + (e >> 1) * 8, cc = col + (e & 1);
      y[r * c + cc] = acc[e] + __bfloat162float(tile[r * stride + cc]) + ob[cc];
    }
  }
  __syncthreads();

  // LayerNorm over each whole row (two-pass moments); new keys to global and to the tile
  bf16* out = keys_new + n * p * c;
  for (int r = warp; r < kRowTile; r += kRowWarps) {
    const float* yr = y + r * c;
    float s = 0.f;
    for (int i = lane; i < c; i += 32) s += yr[i];
    const float mean = warp_sum(s) / c;
    float v = 0.f;
    for (int i = lane; i < c; i += 32) {
      const float d = yr[i] - mean;
      v += d * d;
    }
    const float rstd = rsqrtf(warp_sum(v) / c + eps);
    const bool valid = row0 + r < p;
    for (int i = lane; i < c; i += 32) {
      const bf16 o = __float2bfloat16((yr[i] - mean) * rstd * lnw[i] + lnb[i]);
      tile[r * stride + i] = o;
      if (valid) out[static_cast<size_t>(row0 + r) * c + i] = o;
    }
  }
  __syncthreads();

  rowtile_logits(tile, c, sT + n * k2 * c, k2, scratch, lg);
  store_logits(lg, spe + n * p * k2, logits2 + n * p * k2, row0, p, k2);
}

// Weighted-sum partials of one (128-column, P-split) cell of one query;
// grid (ceil(c / 128), splits, n). MT = m16 tiles of K.
template <int MT>
__global__ void __launch_bounds__(kAccThreads)
    t2i_acc_kernel(const bf16* __restrict__ keys, const float* __restrict__ logits, float* __restrict__ acc_ws,
                   float* __restrict__ m_ws, float* __restrict__ l_ws, int p, int c, int k, int split) {
  __shared__ __align__(16) bf16 sK[2][kAccRows * kKStride];
  __shared__ __align__(16) bf16 sE[16 * MT * kEStride];
  __shared__ float sM[16 * MT];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c0 = blockIdx.x * kAccCols;
  const int s = blockIdx.y, splits = gridDim.y;
  const size_t n = blockIdx.z;
  const int p0 = s * split;
  const int p1 = min(p, p0 + split);
  const float* L = logits + n * p * k;
  const bf16* kb = keys + n * p * c;

  auto load_keys = [&](bf16* dst, int r0) {
    for (int i = tid; i < kAccRows * (kAccCols / 8); i += kAccThreads) {
      const int r = i / (kAccCols / 8), col = (i % (kAccCols / 8)) * 8;
      const bool valid = r0 + r < p1 && c0 + col < c;
      const bf16* src = valid ? kb + static_cast<size_t>(r0 + r) * c + c0 + col : kb;
      cp_async_16(smem_addr(dst + r * kKStride + col), src, valid ? 16 : 0);
    }
    cp_async_commit();
  };

  load_keys(sK[0], p0);
  if (tid < k) {  // column max of this split's logits
    float m = -INFINITY;
#pragma unroll 8
    for (int r = p0; r < p1; ++r) m = fmaxf(m, L[static_cast<size_t>(r) * k + tid]);
    sM[tid] = m;
  }
  __syncthreads();

  float acc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] = 0.f;
  float l_part = 0.f;  // thread tid < k: sum of its E row

  const int n_tiles = (p1 - p0 + kAccRows - 1) / kAccRows;
  for (int t = 0; t < n_tiles; ++t) {
    const int r0 = p0 + t * kAccRows;
    if (t + 1 < n_tiles) load_keys(sK[(t + 1) & 1], r0 + kAccRows);
    for (int i = tid; i < kAccRows * 16 * MT; i += kAccThreads) {
      const int r = i / (16 * MT), j = i % (16 * MT);
      float e = 0.f;
      if (j < k && r0 + r < p1) e = expf(L[static_cast<size_t>(r0 + r) * k + j] - sM[j]);
      sE[j * kEStride + r] = __float2bfloat16(e);
    }
    if (t + 1 < n_tiles)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();
    if (tid < k)
      for (int r = 0; r < kAccRows; ++r) l_part += __bfloat162float(sE[tid * kEStride + r]);
    const bf16* kt = sK[t & 1];
#pragma unroll
    for (int kk = 0; kk < kAccRows / 16; ++kk) {
      uint32_t b[2][4];
#pragma unroll
      for (int dp = 0; dp < 2; ++dp)
        ldmatrix_x4_trans(b[dp], smem_addr(kt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kKStride +
                                           warp * 32 + dp * 16 + (lane >> 4) * 8));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t a[4];
        ldmatrix_x4(a, smem_addr(sE + (mt * 16 + (lane & 15)) * kEStride + kk * 16 + (lane >> 4) * 8));
        mma_16816(acc[mt][0], a, b[0][0], b[0][1]);
        mma_16816(acc[mt][1], a, b[0][2], b[0][3]);
        mma_16816(acc[mt][2], a, b[1][0], b[1][1]);
        mma_16816(acc[mt][3], a, b[1][2], b[1][3]);
      }
    }
    __syncthreads();  // the next iteration's loads overwrite this stage
  }

  const size_t cell = n * splits + s;
  float* out = acc_ws + cell * k * c;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = mt * 16 + (lane >> 2) + (e >> 1) * 8;
        const int col = c0 + warp * 32 + j * 8 + (lane & 3) * 2 + (e & 1);
        if (row < k && col < c) out[static_cast<size_t>(row) * c + col] = acc[mt][j][e];
      }
  if (tid < k) {
    m_ws[cell * k + tid] = sM[tid];
    l_ws[cell * k + tid] = l_part;
  }
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

cudaError_t weighted_sum(const bf16* keys, const float* logits, float* wsum, float* acc_ws, float* m_ws, float* l_ws,
                         int n, int p, int c, int k, int split, cudaStream_t stream) {
  const int splits = (p + split - 1) / split;
  const dim3 grid((c + kAccCols - 1) / kAccCols, splits, n);
  switch ((k + 15) / 16) {
    case 1:
      t2i_acc_kernel<1><<<grid, kAccThreads, 0, stream>>>(keys, logits, acc_ws, m_ws, l_ws, p, c, k, split);
      break;
    case 2:
      t2i_acc_kernel<2><<<grid, kAccThreads, 0, stream>>>(keys, logits, acc_ws, m_ws, l_ws, p, c, k, split);
      break;
    case 3:
      t2i_acc_kernel<3><<<grid, kAccThreads, 0, stream>>>(keys, logits, acc_ws, m_ws, l_ws, p, c, k, split);
      break;
    default:
      t2i_acc_kernel<4><<<grid, kAccThreads, 0, stream>>>(keys, logits, acc_ws, m_ws, l_ws, p, c, k, split);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t total = static_cast<size_t>(n) * k * c;
  t2i_combine_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0, stream>>>(acc_ws, m_ws, l_ws, wsum, total,
                                                                                    splits, k, c);
  return cudaGetLastError();
}

bool bad_shape(int n, int p, int c, int k, int split) {
  return n <= 0 || n > 65535 || p <= 0 || c <= 0 || c % 16 != 0 || k <= 0 || k > kMaxK || k % 16 != 0 ||
         split <= 0 || (p + split - 1) / split > 65535;
}

}  // namespace

// Each returns 0 on success, else the CUDA error code of the refused launch.

extern "C" int l4p_t2i_flash_bf16(const void* keys, const void* sT, const void* spe, void* wsum, void* logits,
                                  void* acc_ws, void* m_ws, void* l_ws, int n, int p, int c, int k, int split,
                                  void* stream) {
  if (bad_shape(n, p, c, k, split)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = logits_smem(c);
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(t2i_logits_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  t2i_logits_kernel<<<dim3((p + kRowTile - 1) / kRowTile, n), kRowThreads, smem, s>>>(
      static_cast<const bf16*>(keys), static_cast<const bf16*>(sT), static_cast<const float*>(spe),
      static_cast<float*>(logits), p, c, k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(weighted_sum(static_cast<const bf16*>(keys), static_cast<const float*>(logits),
                                       static_cast<float*>(wsum), static_cast<float*>(acc_ws),
                                       static_cast<float*>(m_ws), static_cast<float*>(l_ws), n, p, c, k, split, s));
}

extern "C" int l4p_i2t_ln_t2i_bf16(const void* keys, const void* rT, const void* per, const void* v2T, const void* ob,
                                   const void* lnw, const void* lnb, const void* sT, const void* spe, void* keys_new,
                                   void* wsum, void* logits2, void* acc_ws, void* m_ws, void* l_ws, int n, int p,
                                   int c, int k, int k2, int heads, int split, float eps, void* stream) {
  if (bad_shape(n, p, c, k, split) || bad_shape(n, p, c, k2, split) || heads <= 0 || k % heads != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = i2t_smem(c);
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      cudaFuncSetAttribute(i2t_ln_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  i2t_ln_kernel<<<dim3((p + kRowTile - 1) / kRowTile, n), kRowThreads, smem, s>>>(
      static_cast<const bf16*>(keys), static_cast<const bf16*>(rT), static_cast<const float*>(per),
      static_cast<const bf16*>(v2T), static_cast<const float*>(ob), static_cast<const float*>(lnw),
      static_cast<const float*>(lnb), static_cast<const bf16*>(sT), static_cast<const float*>(spe),
      static_cast<bf16*>(keys_new), static_cast<float*>(logits2), p, c, k, k2, k / heads, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(weighted_sum(static_cast<const bf16*>(keys_new), static_cast<const float*>(logits2),
                                       static_cast<float*>(wsum), static_cast<float*>(acc_ws),
                                       static_cast<float*>(m_ws), static_cast<float*>(l_ws), n, p, c, k2, split, s));
}
