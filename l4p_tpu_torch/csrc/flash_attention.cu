// Encoder self-attention for Hopper (sm_90a): o = softmax(q k^T * scale) v.
//
// Replaces the Pallas TPU kernel l4p_tpu/ops/flash_attention.py:_attn_kernel.
// The device code (64-key tiles, online softmax, cp.async double buffering,
// mma.sync fragments) lives in attention.cuh, whose header says what bounds
// it and how the design answers that; csrc/fused_encoder.cu runs the same
// code inside the whole-encoder blocks.
//
// Layout: q (BH, Nq, D), k and v (BH, Nk, D), o (BH, Nq, D), all contiguous
// bf16; D a multiple of 8, at most 128.

#include "attention.cuh"

// Returns 0 on success, else the CUDA error code of the refused launch.
extern "C" int l4p_flash_attention_fwd_bf16(const void* q, const void* k, const void* v, void* o, int bh,
                                            int nq, int nk, int d, float scale, void* stream) {
  using namespace l4p::attn;
  if (bh <= 0 || bh > 65535 || nq <= 0 || nk <= 0 || d <= 0 || d % 8 != 0 || d > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  const float scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long per_head = static_cast<long long>(nq) * d;
  cudaError_t err;
  if (d <= 64)
    err = launch_attention<64>(q, k, v, o, bh, nq, nk, d, scale_log2, 1, per_head, 0, d, s);
  else if (d <= 96)
    err = launch_attention<96>(q, k, v, o, bh, nq, nk, d, scale_log2, 1, per_head, 0, d, s);
  else
    err = launch_attention<128>(q, k, v, o, bh, nq, nk, d, scale_log2, 1, per_head, 0, d, s);
  return static_cast<int>(err);
}
