// P3 and P4: the int4 decode-matvec probe's variants, for Hopper (sm_90a).
//
// Replace the Pallas TPU kernels of scripts/probe_int4_variants.py, launched
// by `make_call` (:150-177) and by `bench_bf16`'s pallas_call (:289-304):
//   P3  k_v1 (:35)   y = sum_b s_b * (x_b . (n_b - 8)), unbias per element
//       k_v2 (:58)   y = sum_b s_b * (x_b . n_b - 8 sum x_b), bias folded
//                    per block (K6's B = 1 arithmetic)
//       k_v3 (:83)   y = x_lo . n_lo + x_hi . n_hi on the biased nibbles, no
//                    scales (the floor; wrong math by design)
//       k_v4 (:97)   y = xs * sum_b s_b * (xq_b . n_b - 8 sum xq_b), int8 x
//                    and int32 dot products
//       k_v5 (:124)  v2's function, the nibbles converted in the packed
//                    domain
//       k_v7_unpackonly (:273)  y = x[0] * bf16(sum over packed rows of
//                    (n_lo + n_hi)), unpack alone
//   P4  k_v6_bf16dot (:266)     y = x @ w, bf16 weights, f32 sums
// x [1, din], q4 [din/2, dout] uint8 with split halves (byte row i holds
// input row i in its low nibble and row i + din/2 in its high nibble, each
// biased by 8, all 16 values possible), scale [nb, dout] f32, one scale per
// (input block of din/nb rows, column): the high nibbles of byte row i take
// scale block nb/2 + i / bs, bs = din/nb. Output [1, dout] bf16.
//
// P3 v1, v2, v3 and v5 are K6's B = 1 kernel (int4_b1.cuh),
// `int4_fold_kernel` with the Unbiased, PerElement, Floor and Packed
// conversions: mma.sync bf16 products of fragments built in registers, one
// launch a matvec through a thread-block cluster along the packed rows;
// grid (dout / 128, split), K6's plan (int4_matmul.py `_b1_plan`), the
// probe's group of 4, 8 or 16 packed rows a lane loads before the products
// that use them as 1, 2 or 4 steps of loads in flight. What they isolate on
// this card, each against v5 (byte_perm and lop3 give bf16 128 + n for two
// nibbles, the bias folded into each scale block's partial sums):
//   v2: a nibble converted int -> f32 on its own (I2FP.F32.U32 on the FP32
//     pipe, then a pack of two f32 into bf16x2);
//   v1: the unbias per element (a bf16x2 subtract of 136 per pair, n - 8
//     in the fragments) against the unbias in the fold;
//   v3: no scales, no per-block folds (one fold at the end of each warp's
//     rows) and 2.1 MB fewer bytes.
//
// v4 and v7 share one skeleton, a template over the variant: grid
// (dout / blk, splits), block (blk / 8, 256 / (blk / 8)). A thread owns 8
// output columns (one 8-byte load of a packed row) and walks groups of G
// consecutive packed rows (G = 4 by default; 8 or 16 put more loads in
// flight before the arithmetic that uses them), strided by the block's rows
// of threads. v4's int8 x rows of the block's split are staged once in
// shared memory. Splits of the packed rows give enough blocks for the 132
// SMs (37 column tiles at the probe's dout 18,944 and blk 512) and hold
// whole scale blocks, so a scale applies to a whole block's partial sum.
// Each block sums its rows of threads in a fixed order and writes f32
// partials [splits, dout]; a second kernel adds the splits in order and
// rounds (no atomics, deterministic). P4 (v6) has a skeleton of the same
// shape over bf16 rows (16-byte loads). What each isolates on this card:
//   v7: a nibble converts int -> f32 per element (for sm_90a nvcc emits
//     I2FP.F32.U32, on the FP32 pipe), and nothing else;
//   v4: a 4 x 4 byte transpose (prmt) turns four packed rows of a column
//     into one word of four int8 lanes for __dp4a against four int8 x;
//     the int32 block dot is exact, the scales apply in f32;
//   v6: 16-byte loads of bf16 rows, widened by a shift, f32 FMA.
//
// Their bound is device-memory bandwidth. At the probe's [1, 3584] @
// [3584, 18944]: v1, v2, v4, v5 read 36.1 MB (10.8 us at 3.35 TB/s), v3
// and v7 34.0 MB (10.1 us), v6 135.8 MB (40.5 us); 135.8 M multiply-adds
// are 0.14 us at the tensor-core peak. PERF.md has their times on an H100
// at G 4, 8 and 16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int4_b1.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 8;       // output columns per thread

enum Variant { kV4 = 4, kV6 = 6, kV7 = 7 };

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// The 8 columns' low and high nibbles of one packed row, as f32.
__device__ __forceinline__ void unpack8(uint2 w, float* lo, float* hi) {
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const unsigned w32 = c < 4 ? w.x : w.y;
    const unsigned byte = (w32 >> (8 * (c & 3))) & 0xFFu;
    lo[c] = static_cast<float>(byte & 15u);
    hi[c] = static_cast<float>(byte >> 4);
  }
}

// Byte c of four words (rows) into one word per column: out[c] holds
// (w0.c, w1.c, w2.c, w3.c), c = 0..3.
__device__ __forceinline__ void transpose4(unsigned w0, unsigned w1,
                                           unsigned w2, unsigned w3,
                                           unsigned* out) {
  const unsigned a01 = __byte_perm(w0, w1, 0x5140);   // w0.0 w1.0 w0.1 w1.1
  const unsigned a23 = __byte_perm(w2, w3, 0x5140);
  const unsigned b01 = __byte_perm(w0, w1, 0x7362);   // w0.2 w1.2 w0.3 w1.3
  const unsigned b23 = __byte_perm(w2, w3, 0x7362);
  out[0] = __byte_perm(a01, a23, 0x5410);
  out[1] = __byte_perm(a01, a23, 0x7632);
  out[2] = __byte_perm(b01, b23, 0x5410);
  out[3] = __byte_perm(b01, b23, 0x7632);
}

// Sum the block's rows of threads for its blk columns in a fixed order and
// write the split's f32 partials.
__device__ __forceinline__ void write_partials(const float* acc, float* red,
                                               float* partial, int dout,
                                               int blk) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int nthreads = blockDim.x * blockDim.y;
  const int tid = ty * blockDim.x + tx;
#pragma unroll
  for (int c = 0; c < kCols; ++c) red[ty * blk + tx * kCols + c] = acc[c];
  __syncthreads();
  for (int i = tid; i < blk; i += nthreads) {
    float s = 0.f;
    for (int t = 0; t < static_cast<int>(blockDim.y); ++t) s += red[t * blk + i];
    partial[static_cast<long long>(blockIdx.y) * dout +
            static_cast<long long>(blockIdx.x) * blk + i] = s;
  }
}

// P3 v4 and v7. Split y covers packed rows [y * rows_per_split, ...),
// whole scale blocks of bs rows (v7: bs = rows_per_split, no scales); G
// packed rows per thread per step.
template <int V, int G>
__global__ void __launch_bounds__(kThreads)
    int4_variant_kernel(const void* __restrict__ xv,
                        const uint8_t* __restrict__ q4,
                        const float* __restrict__ scale,
                        float* __restrict__ partial, int dh, int dout, int blk,
                        int bs, int nbh, int rows_per_split) {
  extern __shared__ float4 smem[];
  float* red = reinterpret_cast<float*>(smem);              // [ty][blk]
  int8_t* xq = reinterpret_cast<int8_t*>(red + blockDim.y * blk);  // v4
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int nthreads = blockDim.x * blockDim.y;
  const int tid = ty * blockDim.x + tx;
  const int col0 = blockIdx.x * blk + tx * kCols;
  const int r0 = blockIdx.y * rows_per_split;
  const int r1 = min(r0 + rows_per_split, dh);
  const int rows = r1 - r0;

  if (V == kV4) {   // [2][rows_per_split]
    const int8_t* x = static_cast<const int8_t*>(xv);
    for (int i = tid; i < 2 * rows; i += nthreads) {
      const int h = i / rows, j = i - h * rows;
      xq[h * rows_per_split + j] = x[h * dh + r0 + j];
    }
  }
  __syncthreads();

  float acc[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c] = 0.f;
  const int step = blockDim.y * G;
  for (int b0 = r0; b0 < r1; b0 += bs) {
    const int b1 = min(b0 + bs, r1);
    int d_lo[kCols], d_hi[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) d_lo[c] = d_hi[c] = 0;
    int si_lo = 0, si_hi = 0;
    for (int g = b0 + ty * G; g < b1; g += step) {
      uint2 w[G];
#pragma unroll
      for (int k = 0; k < G; ++k) {
        w[k] = __ldg(reinterpret_cast<const uint2*>(
            q4 + static_cast<long long>(g + k) * dout + col0));
      }
      const int j = g - r0;
      if (V == kV4) {
#pragma unroll
        for (int k = 0; k < G; k += 4) {
          const int xl = *reinterpret_cast<const int*>(xq + j + k);
          const int xh =
              *reinterpret_cast<const int*>(xq + rows_per_split + j + k);
          si_lo = __dp4a(xl, 0x01010101, si_lo);
          si_hi = __dp4a(xh, 0x01010101, si_hi);
          unsigned cols[kCols];
          transpose4(w[k].x, w[k + 1].x, w[k + 2].x, w[k + 3].x, cols);
          transpose4(w[k].y, w[k + 1].y, w[k + 2].y, w[k + 3].y, cols + 4);
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            const int lo = static_cast<int>(cols[c] & 0x0F0F0F0Fu);
            const int hi = static_cast<int>((cols[c] >> 4) & 0x0F0F0F0Fu);
            d_lo[c] = __dp4a(lo, xl, d_lo[c]);
            d_hi[c] = __dp4a(hi, xh, d_hi[c]);
          }
        }
      } else {   // v7
#pragma unroll
        for (int k = 0; k < G; ++k) {
          float n_lo[kCols], n_hi[kCols];
          unpack8(w[k], n_lo, n_hi);
#pragma unroll
          for (int c = 0; c < kCols; ++c) acc[c] += n_lo[c] + n_hi[c];
        }
      }
    }
    if (V == kV4) {
      const int b = b0 / bs;
      float s_lo[kCols], s_hi[kCols];
      load8(scale + static_cast<long long>(b) * dout + col0, s_lo);
      load8(scale + static_cast<long long>(nbh + b) * dout + col0, s_hi);
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        acc[c] += static_cast<float>(d_lo[c] - 8 * si_lo) * s_lo[c] +
                  static_cast<float>(d_hi[c] - 8 * si_hi) * s_hi[c];
      }
    }
  }
  write_partials(acc, red, partial, dout, blk);
}

// P4: x [1, din] bf16 @ w [din, dout] bf16; split y covers input rows
// [y * rows_per_split, ...); G rows per thread per step.
template <int G>
__global__ void __launch_bounds__(kThreads)
    bf16_matvec_kernel(const __nv_bfloat16* __restrict__ x,
                       const __nv_bfloat16* __restrict__ w,
                       float* __restrict__ partial, int din, int dout, int blk,
                       int rows_per_split) {
  extern __shared__ float4 smem[];
  float* red = reinterpret_cast<float*>(smem);
  float* xs = red + blockDim.y * blk;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int nthreads = blockDim.x * blockDim.y;
  const int tid = ty * blockDim.x + tx;
  const int col0 = blockIdx.x * blk + tx * kCols;
  const int r0 = blockIdx.y * rows_per_split;
  const int r1 = min(r0 + rows_per_split, din);
  for (int i = tid; i < r1 - r0; i += nthreads) {
    xs[i] = __bfloat162float(x[r0 + i]);
  }
  __syncthreads();

  float acc[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c] = 0.f;
  for (int g = r0 + ty * G; g < r1; g += blockDim.y * G) {
    uint4 v[G];
#pragma unroll
    for (int k = 0; k < G; ++k) {
      v[k] = __ldg(reinterpret_cast<const uint4*>(
          w + static_cast<long long>(g + k) * dout + col0));
    }
#pragma unroll
    for (int k = 0; k < G; ++k) {
      const float xk = xs[g - r0 + k];
      const unsigned words[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        acc[2 * h] = fmaf(xk, __uint_as_float(words[h] << 16), acc[2 * h]);
        acc[2 * h + 1] =
            fmaf(xk, __uint_as_float(words[h] & 0xFFFF0000u), acc[2 * h + 1]);
      }
    }
  }
  write_partials(acc, red, partial, dout, blk);
}

// out[i] = bf16 of the splits' partials summed in order; v4 multiplies by
// xs (aux[0]) first, v7 rounds the sum to bf16 and multiplies by x[0]
// (aux[0]), as its TPU body.
template <int V>
__global__ void finish_kernel(const float* __restrict__ partial, int splits,
                              int dout, const __nv_bfloat16* __restrict__ aux,
                              __nv_bfloat16* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= dout) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += partial[static_cast<long long>(k) * dout + i];
  if (V == kV4) s *= __bfloat162float(aux[0]);
  if (V == kV7) s = bf16_round(s) * __bfloat162float(aux[0]);
  out[i] = __float2bfloat16(s);
}

int finish(int v, const float* partial, int splits, int dout, const void* aux,
           void* out, cudaStream_t s) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((dout + 255) / 256);
  const auto* a = static_cast<const __nv_bfloat16*>(aux);
  auto* o = static_cast<__nv_bfloat16*>(out);
  if (v == kV4) {
    finish_kernel<kV4><<<grid, 256, 0, s>>>(partial, splits, dout, a, o);
  } else if (v == kV7) {
    finish_kernel<kV7><<<grid, 256, 0, s>>>(partial, splits, dout, a, o);
  } else {
    finish_kernel<0><<<grid, 256, 0, s>>>(partial, splits, dout, a, o);
  }
  return static_cast<int>(cudaGetLastError());
}

dim3 block_shape(int blk) {
  const int tx = blk / kCols;
  return dim3(tx, kThreads / tx);
}

template <int V, int G>
int launch_variant(const void* x, const void* q4, const void* scale,
                   const void* aux, void* partial, void* out, int dh, int dout,
                   int nb, int blk, int splits, int rows_per_split,
                   void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block = block_shape(blk);
  const int nbh = nb / 2;
  const int bs = V == kV4 ? dh / nbh : rows_per_split;   // v7: no scales
  const size_t stage = V == kV4 ? 2 * rows_per_split : 0;
  const size_t smem = block.y * blk * sizeof(float) + stage;
  int4_variant_kernel<V, G><<<dim3(dout / blk, splits), block, smem, s>>>(
      x, static_cast<const uint8_t*>(q4), static_cast<const float*>(scale),
      static_cast<float*>(partial), dh, dout, blk, bs, nbh, rows_per_split);
  return finish(V, static_cast<const float*>(partial), splits, dout, aux, out,
                s);
}

template <int V>
int launch_group(const void* x, const void* q4, const void* scale,
                 const void* aux, void* partial, void* out, int dh, int dout,
                 int nb, int blk, int splits, int rows_per_split, int group,
                 void* stream) {
  switch (group) {
    case 4:
      return launch_variant<V, 4>(x, q4, scale, aux, partial, out, dh, dout,
                                  nb, blk, splits, rows_per_split, stream);
    case 8:
      return launch_variant<V, 8>(x, q4, scale, aux, partial, out, dh, dout,
                                  nb, blk, splits, rows_per_split, stream);
    case 16:
      return launch_variant<V, 16>(x, q4, scale, aux, partial, out, dh, dout,
                                   nb, blk, splits, rows_per_split, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// P3 v1, v2, v3 and v5: the B = 1 kernel with `Conv` at 1, 2 or 4 steps
// of loads in flight.
template <class Conv>
int launch_fold_depth(const void* x, const void* q4, const void* scale,
                      void* out, int dh, int dout, int nb, int split,
                      int warps, int rows, int depth, cudaStream_t s) {
  switch (depth) {
    case 1:
      return static_cast<int>(launch_fold<Conv, 1>(
          x, q4, scale, out, 0, dh, dout, nb, split, warps, rows, s));
    case 2:
      return static_cast<int>(launch_fold<Conv, 2>(
          x, q4, scale, out, 0, dh, dout, nb, split, warps, rows, s));
    case 4:
      return static_cast<int>(launch_fold<Conv, 4>(
          x, q4, scale, out, 0, dh, dout, nb, split, warps, rows, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int G>
int launch_bf16(const void* x, const void* w, void* partial, void* out,
                int din, int dout, int blk, int splits, int rows_per_split,
                cudaStream_t s) {
  const dim3 block = block_shape(blk);
  const size_t smem = (block.y * blk + rows_per_split) * sizeof(float);
  bf16_matvec_kernel<G><<<dim3(dout / blk, splits), block, smem, s>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), static_cast<float*>(partial), din,
      dout, blk, rows_per_split);
  return finish(kV6, static_cast<const float*>(partial), splits, dout, nullptr,
                out, s);
}

}  // namespace

// P3 v4, v7. x [1, 2 * dh] (int8 for v4, bf16 for v7), q4 [dh, dout] uint8
// (8-byte aligned), scale [nb, dout] f32 (16-byte aligned; unread by v7),
// aux: v4's xs (bf16 scalar), v7's x; partial f32 scratch [splits, dout];
// out [1, dout] bf16. blk a multiple of 8 dividing dout, at most 2048;
// group (packed rows per thread per step) 4, 8 or 16; dh, rows_per_split
// and (v4) the scale block dh / (nb / 2) multiples of group, rows_per_split
// a multiple of the scale block; shared memory (blk x 32 bytes + the staged
// x) under 48 KB. Each returns the cudaError_t of its two launches.
#define FVT_INT4_ENTRY(NAME, V)                                              \
  extern "C" int NAME(const void* x, const void* q4, const void* scale,      \
                      const void* aux, void* partial, void* out, int dh,     \
                      int dout, int nb, int blk, int splits,                 \
                      int rows_per_split, int group, void* stream) {         \
    return launch_group<V>(x, q4, scale, aux, partial, out, dh, dout, nb,    \
                           blk, splits, rows_per_split, group, stream);      \
  }
FVT_INT4_ENTRY(fvt_int4_v4_int8dot, kV4)
FVT_INT4_ENTRY(fvt_int4_v7_unpackonly, kV7)
#undef FVT_INT4_ENTRY

// P3 v5 (Packed), v2 (PerElement), v1 (Unbiased) and v3 (Floor), one launch
// each. x [1, 2 * dh] bf16, q4 [dh, dout] uint8, scale [nb, dout] f32 (v3
// does not read it), out [1, dout] bf16, all contiguous and 16-byte aligned;
// the plan (split, warps, rows) and the shape as launch_fold (int4_b1.cuh)
// takes them; depth 1, 2 or 4 steps of loads in flight. A shape, plan or depth it does not take returns
// cudaErrorInvalidValue before any launch; else the launch's cudaError_t.
#define FVT_INT4_FOLD_ENTRY(NAME, CONV)                                       \
  extern "C" int NAME(const void* x, const void* q4, const void* scale,       \
                      void* out, int dh, int dout, int nb, int split,         \
                      int warps, int rows, int depth, void* stream) {         \
    return launch_fold_depth<CONV>(x, q4, scale, out, dh, dout, nb, split,    \
                                   warps, rows, depth,                        \
                                   static_cast<cudaStream_t>(stream));        \
  }
FVT_INT4_FOLD_ENTRY(fvt_int4_v5_u8mask, Packed)
FVT_INT4_FOLD_ENTRY(fvt_int4_v2_biasfold, PerElement)
FVT_INT4_FOLD_ENTRY(fvt_int4_v1_current, Unbiased)
FVT_INT4_FOLD_ENTRY(fvt_int4_v3_floor, Floor)
#undef FVT_INT4_FOLD_ENTRY

// P4 entry. x [1, din] bf16, w [din, dout] bf16 (16-byte aligned), partial
// f32 scratch [splits, dout], out [1, dout] bf16; blk and group as above;
// din and rows_per_split multiples of group.
extern "C" int fvt_bf16_v6_bf16dot(const void* x, const void* w, void* partial,
                                   void* out, int din, int dout, int blk,
                                   int splits, int rows_per_split, int group,
                                   void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (group) {
    case 4:
      return launch_bf16<4>(x, w, partial, out, din, dout, blk, splits,
                            rows_per_split, s);
    case 8:
      return launch_bf16<8>(x, w, partial, out, din, dout, blk, splits,
                            rows_per_split, s);
    case 16:
      return launch_bf16<16>(x, w, partial, out, din, dout, blk, splits,
                             rows_per_split, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
