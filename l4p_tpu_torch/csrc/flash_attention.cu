// Encoder self-attention for Hopper (sm_90a): o = softmax(q k^T * scale) v.
//
// Replaces the Pallas TPU kernel l4p_tpu/ops/flash_attention.py:_attn_kernel.
// The device code (wgmma products, TMA loads into a ring of shared-memory
// stages fed by a producer warpgroup, online softmax) lives in attention.cuh,
// whose header says what bounds it and how the design answers that;
// csrc/fused_encoder.cu runs the same code inside the whole-encoder blocks.
//
// Layout: q (BH, Nq, D), k and v (BH, Nk, D), rows `pitch` elements apart
// (pitch >= D, a multiple of 8; ops/flash_attention.py passes the next
// multiple of 16, the fastest loads), o (BH, Nq, D) contiguous, all bf16
// and 16-byte aligned; D a multiple of 8, at most 256 (past 128 the D_pad
// 256 instantiation: 64-key tiles in 2 stages); BH from 1 to kMaxBH (the
// grid splits it over y and z).
//
// Returns 0 on success, the CUDA error code of a refused launch
// (cudaErrorInvalidValue for a shape the kernel does not take), or
// -(CUresult) when a tensor map cannot be encoded.

#include "attention.cuh"

namespace {

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" int l4p_flash_attention_fwd_bf16(const void* q, const void* k, const void* v, void* o, int bh,
                                            int nq, int nk, int d, int pitch, float scale, void* stream) {
  using namespace l4p::attn;
  if (bh <= 0 || bh > kMaxBH || nq <= 0 || nk <= 0 || d <= 0 || d % 8 != 0 || d > 256 || pitch < d ||
      pitch % 8 != 0 || !aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(o))
    return static_cast<int>(cudaErrorInvalidValue);
  const float scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long per_head = static_cast<long long>(nq) * d;
  if (d <= 64) return launch_attention<64>(q, k, v, o, bh, nq, nk, d, pitch, scale_log2, 1, per_head, 0, d, s);
  if (d <= 96) return launch_attention<96>(q, k, v, o, bh, nq, nk, d, pitch, scale_log2, 1, per_head, 0, d, s);
  if (d <= 128) return launch_attention<128>(q, k, v, o, bh, nq, nk, d, pitch, scale_log2, 1, per_head, 0, d, s);
  return launch_attention<256>(q, k, v, o, bh, nq, nk, d, pitch, scale_log2, 1, per_head, 0, d, s);
}
