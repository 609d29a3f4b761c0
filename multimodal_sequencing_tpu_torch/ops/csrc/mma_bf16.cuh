// bf16 tensor-core helpers shared by the flash-attention kernels:
// `mma.sync` m16n8k16 (bf16 in, f32 accumulate) and fragment packing.
//
// Fragment layout (g = lane / 4, t = lane % 4): an accumulator tile of 16
// rows x 8 columns holds c[0], c[1] at (row g, cols 2t, 2t+1) and c[2], c[3]
// at (row g + 8, the same cols). The A operand (16 x 16) is four 32-bit
// registers: (row g, k 2t..2t+1), (row g+8, k 2t..), (row g, k 2t+8..),
// (row g+8, k 2t+8..). The B operand (16 x 8) is two: (k 2t..2t+1, col g)
// and (k 2t+8..2t+9, col g).
#pragma once
#include <cuda_bf16.h>
#include <stdint.h>

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Accumulator tiles s[2kk], s[2kk+1] (16 rows x 16 columns) re-packed in
// registers as the A operand of the next product, whose k runs over those
// 16 columns.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                         const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}
