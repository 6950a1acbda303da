// Helpers shared by the attention kernels (K1/K3 in flash_attention.cu,
// K4/K5 in flash_attention_bwd.cu, P2 in frame_attention.cu): bf16 packing,
// the m16n8k16 bf16 tensor-core product with f32 accumulation, `ldmatrix`
// fragment loads, `cp.async` copies, and the tile steps the two forward
// kernels (K1/K3, P2) share: rows into a padded shared tile, Q's A
// fragments, one 64-key tile's scores and P V, the output's store.
//
// Fragment layout of mma.sync.m16n8k16 (g = lane / 4, t4 = lane % 4):
//   A 16x16 row-major: a0 (row g, cols 2t4..+1), a1 (row g+8, same cols),
//                      a2 (row g, cols 2t4+8..+9), a3 (row g+8, same cols)
//   B 16x8 col-major:  b0 (rows 2t4..+1, col g), b1 (rows 2t4+8..+9, col g)
//   C 16x8:            c0,c1 (row g, cols 2t4..+1), c2,c3 (row g+8, same)
// so two adjacent 8-column C tiles, packed to bf16, are the A operand of the
// next product (no trip through shared memory).
//
// ldmatrix.x4 reads four 8x8 bf16 matrices from shared memory; lanes 8i..8i+7
// give the addresses of matrix i's eight 16-byte rows, and register i of
// lane l receives matrix i's (row l / 4, cols 2(l % 4)..+1), which is the
// fragment layout above:
//   - A (16 rows x 16 cols, row-major): matrices (rows 0-7, cols 0-7),
//     (rows 8-15, cols 0-7), (rows 0-7, cols 8-15), (rows 8-15, cols 8-15)
//     give a0..a3;
//   - B from an [n][k] tile (K's rows for Q K^T): matrices (n 0-7, k 0-7),
//     (n 0-7, k 8-15), (n 8-15, k 0-7), (n 8-15, k 8-15) give b0, b1 of two
//     adjacent 8-column tiles;
//   - B from a [k][n] tile (V's rows for P V) with .trans, which gives lane l
//     (rows 2(l % 4)..+1, col l / 4): matrices (k 0-7, n 0-7), (k 8-15,
//     n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15) give b0, b1 of two tiles.
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

// Four 8x8 bf16 matrices from shared memory (see the layout note above).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

// The same, each matrix transposed on the way to the registers.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* smem) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

// 16 bytes global -> shared without a trip through registers; the first
// `src_bytes` (0 or 16) are read and the rest of the 16 are zero-filled.
__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem,
                                            int src_bytes) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(a),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

// 4 bytes global -> shared (cp.async.ca: .cg takes only 16); `src_bytes` 0
// or 4, the rest zero-filled.
__device__ __forceinline__ void cp_async_4(void* smem, const void* gmem,
                                           int src_bytes) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(a),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

// Closes the group of this thread's cp.async copies issued since the last.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's groups are in flight; the other
// threads' copies are visible after a barrier that follows.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 2^x on the SFU (ex2.approx; results below 2^-126 flush to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Rows [r0, r0 + rows) of one head (row stride ss) into dst (row stride
// D + kPad) by 16-byte cp.async from every thread of the block; rows at or
// past S are zero-filled and not read.
template <int D>
__device__ __forceinline__ void copy_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long ss, int r0, int rows,
                                          int s) {
  constexpr int kLd = D + kPad, kVec = D / 8;
  for (int i = threadIdx.x; i < rows * kVec; i += blockDim.x) {
    const int r = i / kVec, c = (i % kVec) * 8;
    const bool live = r0 + r < s;
    cp_async_16(dst + r * kLd + c, live ? src + (r0 + r) * ss + c : src,
                live ? 16 : 0);
  }
}

// Lane offsets (in elements) of the ldmatrix row addresses: `a` for A
// fragments and .trans B fragments (matrix i = lane / 8 at row 8 (i % 2),
// col 8 (i / 2)), `b` for B fragments from [n][k] rows (row 8 (i / 2),
// col 8 (i % 2)).
template <int D>
__device__ __forceinline__ int lane_off_a(int lane) {
  return (((lane >> 3) & 1) * 8 + (lane & 7)) * (D + kPad) + (lane >> 4) * 8;
}
template <int D>
__device__ __forceinline__ int lane_off_b(int lane) {
  return ((lane >> 4) * 8 + (lane & 7)) * (D + kPad) + ((lane >> 3) & 1) * 8;
}

// The warp's 16 rows of Q as A fragments (sQ: its first row).
template <int D>
__device__ __forceinline__ void load_q(uint32_t (&qf)[D / 16][4],
                                       const __nv_bfloat16* sQ, int off) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldmatrix_x4(qf[kk], sQ + kk * 16 + off);
}

// Raw scores (f32, unscaled) of the warp's 16 rows against one 64-key tile
// (sK: [64][D + kPad]).
template <int D>
__device__ __forceinline__ void tile_scores(float (&s)[8][4],
                                            const uint32_t (&qf)[D / 16][4],
                                            const __nv_bfloat16* sK, int off) {
  constexpr int kLd = D + kPad;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      ldmatrix_x4(b, sK + np * 16 * kLd + kk * 16 + off);
      mma_16816(s[2 * np], qf[kk], b);
      mma_16816(s[2 * np + 1], qf[kk], b + 2);
    }
  }
}

// acc += P V for one 64-key tile, P as packed bf16 A fragments (4 k-steps).
template <int D>
__device__ __forceinline__ void tile_pv(float (&acc)[D / 8][4],
                                        const uint32_t (&pa)[4][4],
                                        const __nv_bfloat16* sV, int off) {
  constexpr int kLd = D + kPad;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, sV + kk * 16 * kLd + dp * 16 + off);
      mma_16816(acc[2 * dp], pa[kk], b);
      mma_16816(acc[2 * dp + 1], pa[kk], b + 2);
    }
  }
}

// The warp's 16 output rows through its own rows of shared memory (sO,
// which held its Q rows), then 16-byte stores of the rows below S.
template <int D>
__device__ __forceinline__ void store_o(const float (&acc)[D / 8][4],
                                        __nv_bfloat16* sO,
                                        __nv_bfloat16* ob, long long ss,
                                        int row0, int s, int lane) {
  constexpr int kLd = D + kPad, kVec = D / 8;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int c = dt * 8 + t4 * 2;
    *reinterpret_cast<uint32_t*>(&sO[g * kLd + c]) =
        pack_f32(acc[dt][0], acc[dt][1]);
    *reinterpret_cast<uint32_t*>(&sO[(g + 8) * kLd + c]) =
        pack_f32(acc[dt][2], acc[dt][3]);
  }
  __syncwarp();
  for (int i = lane; i < 16 * kVec; i += 32) {
    const int r = i / kVec, c = (i % kVec) * 8;
    if (row0 + r < s)
      *reinterpret_cast<uint4*>(ob + (row0 + r) * ss + c) =
          *reinterpret_cast<const uint4*>(&sO[r * kLd + c]);
  }
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
