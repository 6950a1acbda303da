// Helpers shared by the attention kernels (K1/K3 in flash_attention.cu,
// K4/K5 in flash_attention_bwd.cu): bf16 packing and the m16n8k16 bf16
// tensor-core product with f32 accumulation.
//
// Fragment layout of mma.sync.m16n8k16 (g = lane / 4, t4 = lane % 4):
//   A 16x16 row-major: a0 (row g, cols 2t4..+1), a1 (row g+8, same cols),
//                      a2 (row g, cols 2t4+8..+9), a3 (row g+8, same cols)
//   B 16x8 col-major:  b0 (rows 2t4..+1, col g), b1 (rows 2t4+8..+9, col g)
//   C 16x8:            c0,c1 (row g, cols 2t4..+1), c2,c3 (row g+8, same)
// so two adjacent 8-column C tiles, packed to bf16, are the A operand of the
// next product (no trip through shared memory).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace fvt {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kPad = 8;  // shared-memory row padding, in bf16 elements: a row
                         // stride of D + 8 keeps the fragment loads of the 8
                         // rows of a quad group on distinct banks

// Two bf16 values packed in a 32-bit register, as floats (.x the low half).
__device__ __forceinline__ float2 unpack_f32(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x is the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// d += a * b for one m16n8k16 tile: a 16x16 (row), b 16x8 (col), d 16x8 f32.
__device__ __forceinline__ void mma_16816(float* d, const uint32_t* a,
                                          const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace fvt
