// Fragment helpers shared by the port's kernels: cp.async copies, ldmatrix
// loads and the bf16 mma.sync m16n8k16 tensor-core product (fp32
// accumulate). Written from the PTX specification and checked on the card
// against each kernel's plain version.
//
// Fragment layouts of m16n8k16 (lane = threadIdx.x % 32, g = lane / 4,
// t = lane % 4):
//   A (16x16, row-major) : a[0] = rows g, cols 2t..2t+1; a[1] = row g + 8;
//                          a[2] = row g, cols 2t+8..; a[3] = row g + 8, cols 2t+8..
//   B (16x8, "col")      : b0 = k rows 2t..2t+1 of column g; b1 = k rows 2t+8..
//   C (16x8, fp32)       : c[0..1] = row g, cols 2t..2t+1; c[2..3] = row g + 8.
// So a B fragment is two 32-bit loads from a matrix stored (n, k) row-major.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace l4p {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy global -> shared; src_bytes = 0 writes zeros.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c (16x8 fp32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats -> packed bf16x2, `lo` in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 32-bit read-only load of two neighbouring bf16 values (a B fragment half).
__device__ __forceinline__ uint32_t ldg_u32(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

__device__ __forceinline__ float bf16_round(float x) { return __bfloat162float(__float2bfloat16(x)); }

}  // namespace l4p
