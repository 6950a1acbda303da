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
//                    (n_lo + n_hi)), unpack alone (no x rows, no scales)
//   P4  k_v6_bf16dot (:266)     y = x @ w, bf16 weights, f32 sums
// x [1, din], q4 [din/2, dout] uint8 with split halves (byte row i holds
// input row i in its low nibble and row i + din/2 in its high nibble, each
// biased by 8, all 16 values possible), scale [nb, dout] f32, one scale per
// (input block of din/nb rows, column): the high nibbles of byte row i take
// scale block nb/2 + i / bs, bs = din/nb. Output [1, dout] bf16.
//
// P3 v1, v2, v3, v5 and v7 are K6's B = 1 kernel (int4_b1.cuh),
// `int4_fold_kernel` with the Unbiased, PerElement, Floor, Packed and Ones
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
//     rows) and 2.1 MB fewer bytes;
//   v7: v3's kernel with B the constant 1.0 (no x rows read) and an
//     epilogue, bf16(bf16(sum) x[0, 0]); its integer sums are exact.
//
// P4 (v6) is a B = 1 kernel of its own on the same plan (bf16_b1.cuh):
// mma.sync bf16 products of fragments paired from the loaded rows by
// byte_perm, one launch a matvec through a cluster along the rows; grid
// (dout / 64, split), its plan int4_variants.py `bf16_plan`, the group as
// for v1-v3 and v5.
//
// v4 runs the split-partials skeleton (the template's variant number
// names its instances in the SASS): grid (dout / blk, splits), block
// (blk / 8, 256 / (blk / 8)). A thread owns 8
// output columns (one 8-byte load of a packed row) and walks groups of G
// consecutive packed rows (G = 4 by default; 8 or 16 put more loads in
// flight before the arithmetic that uses them), strided by the block's rows
// of threads. The int8 x rows of the block's split are staged once in
// shared memory. Splits of the packed rows give enough blocks for the 132
// SMs (37 column tiles at the probe's dout 18,944 and blk 512) and hold
// whole scale blocks, so a scale applies to a whole block's partial sum.
// Each block sums its rows of threads in a fixed order and writes f32
// partials [splits, dout]; a second kernel adds the splits in order and
// rounds (no atomics, deterministic). What v4 isolates on this card: a
// 4 x 4 byte transpose (prmt) turns four packed rows of a column into one
// word of four int8 lanes for __dp4a against four int8 x; the int32 block
// dot is exact, the scales apply in f32.
//
// Their bound is device-memory bandwidth. At the probe's [1, 3584] @
// [3584, 18944]: v1, v2, v4, v5 read 36.1 MB (10.8 us at 3.35 TB/s), v3
// and v7 34.0 MB (10.1 us), v6 135.8 MB (40.5 us); 135.8 M multiply-adds
// are 0.14 us at the tensor-core peak. PERF.md has their times on an H100
// at G 4, 8 and 16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_b1.cuh"
#include "int4_b1.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 8;       // output columns per thread

enum Variant { kV4 = 4 };

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
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

// P3 v4. Split y covers packed rows [y * rows_per_split, ...), whole scale
// blocks of bs rows; G packed rows per thread per step.
template <int V, int G>
__global__ void __launch_bounds__(kThreads)
    int4_variant_kernel(const void* __restrict__ xv,
                        const uint8_t* __restrict__ q4,
                        const float* __restrict__ scale,
                        float* __restrict__ partial, int dh, int dout, int blk,
                        int bs, int nbh, int rows_per_split) {
  extern __shared__ float4 smem[];
  float* red = reinterpret_cast<float*>(smem);              // [ty][blk]
  int8_t* xq = reinterpret_cast<int8_t*>(red + blockDim.y * blk);
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int nthreads = blockDim.x * blockDim.y;
  const int tid = ty * blockDim.x + tx;
  const int col0 = blockIdx.x * blk + tx * kCols;
  const int r0 = blockIdx.y * rows_per_split;
  const int r1 = min(r0 + rows_per_split, dh);
  const int rows = r1 - r0;

  const int8_t* x = static_cast<const int8_t*>(xv);   // into [2][rows_per_split]
  for (int i = tid; i < 2 * rows; i += nthreads) {
    const int h = i / rows, j = i - h * rows;
    xq[h * rows_per_split + j] = x[h * dh + r0 + j];
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
    }
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
  write_partials(acc, red, partial, dout, blk);
}

// out[i] = bf16 of the splits' partials summed in order, times xs
// (aux[0]).
template <int V>
__global__ void finish_kernel(const float* __restrict__ partial, int splits,
                              int dout, const __nv_bfloat16* __restrict__ aux,
                              __nv_bfloat16* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= dout) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += partial[static_cast<long long>(k) * dout + i];
  s *= __bfloat162float(aux[0]);
  out[i] = __float2bfloat16(s);
}

int finish(const float* partial, int splits, int dout, const void* aux,
           void* out, cudaStream_t s) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  finish_kernel<kV4><<<(dout + 255) / 256, 256, 0, s>>>(
      partial, splits, dout, static_cast<const __nv_bfloat16*>(aux),
      static_cast<__nv_bfloat16*>(out));
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
  const size_t smem = block.y * blk * sizeof(float) + 2 * rows_per_split;
  int4_variant_kernel<V, G><<<dim3(dout / blk, splits), block, smem, s>>>(
      x, static_cast<const uint8_t*>(q4), static_cast<const float*>(scale),
      static_cast<float*>(partial), dh, dout, blk, dh / nbh, nbh,
      rows_per_split);
  return finish(static_cast<const float*>(partial), splits, dout, aux, out, s);
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

// P3 v1, v2, v3, v5 and v7: the B = 1 kernel with `Conv` at 1, 2 or 4
// steps of loads in flight.
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

// P4: the B = 1 bf16 kernel at 1, 2 or 4 steps of loads in flight.
int launch_bf16_depth(const void* x, const void* w, void* out, int din,
                      int dout, int split, int warps, int rows, int depth,
                      cudaStream_t s) {
  switch (depth) {
    case 1:
      return static_cast<int>(launch_bf16_b1<1>(x, w, out, din, dout, split,
                                                warps, rows, s));
    case 2:
      return static_cast<int>(launch_bf16_b1<2>(x, w, out, din, dout, split,
                                                warps, rows, s));
    case 4:
      return static_cast<int>(launch_bf16_b1<4>(x, w, out, din, dout, split,
                                                warps, rows, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// P3 v4. x [1, 2 * dh] int8, q4 [dh, dout] uint8 (8-byte aligned), scale
// [nb, dout] f32 (16-byte aligned), aux: xs (bf16 scalar); partial f32
// scratch [splits, dout]; out [1, dout] bf16. blk a multiple of 8 dividing
// dout, at most 2048; group (packed rows per thread per step) 4, 8 or 16;
// dh, rows_per_split and the scale block dh / (nb / 2) multiples of group,
// rows_per_split a multiple of the scale block; shared memory (blk x 32
// bytes + the staged x) under 48 KB. Returns the cudaError_t of its two
// launches.
extern "C" int fvt_int4_v4_int8dot(const void* x, const void* q4,
                                   const void* scale, const void* aux,
                                   void* partial, void* out, int dh, int dout,
                                   int nb, int blk, int splits,
                                   int rows_per_split, int group,
                                   void* stream) {
  return launch_group<kV4>(x, q4, scale, aux, partial, out, dh, dout, nb, blk,
                           splits, rows_per_split, group, stream);
}

// P3 v5 (Packed), v2 (PerElement), v1 (Unbiased), v3 (Floor) and v7
// (Ones), one launch each. x [1, 2 * dh] bf16, q4 [dh, dout] uint8, scale
// [nb, dout] f32 (v3 and v7 do not read it; v7 reads x[0, 0] alone), out
// [1, dout] bf16, all contiguous and 16-byte aligned;
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
FVT_INT4_FOLD_ENTRY(fvt_int4_v7_unpackonly, Ones)
#undef FVT_INT4_FOLD_ENTRY

// P4, one launch. x [1, din] bf16 (8-byte aligned), w [din, dout] bf16
// (16-byte aligned), out [1, dout] bf16, all contiguous; the plan (split,
// warps, rows) and the shape as launch_bf16_b1 (bf16_b1.cuh) takes them;
// depth 1, 2 or 4 steps of loads in flight. A shape, plan or depth it does
// not take returns cudaErrorInvalidValue before any launch; else the
// launch's cudaError_t.
extern "C" int fvt_bf16_v6_bf16dot(const void* x, const void* w, void* out,
                                   int din, int dout, int split, int warps,
                                   int rows, int depth, void* stream) {
  return launch_bf16_depth(x, w, out, din, dout, split, warps, rows, depth,
                           static_cast<cudaStream_t>(stream));
}

// P4's plan: the clusters of `split` blocks of `warps` warps the card holds
// at once at `depth` steps of loads in flight, or minus a cudaError_t.
extern "C" int fvt_bf16_v6_clusters(int split, int warps, int depth) {
  switch (depth) {
    case 1:
      return bf16_b1_clusters<1>(split, warps);
    case 2:
      return bf16_b1_clusters<2>(split, warps);
    case 4:
      return bf16_b1_clusters<4>(split, warps);
    default:
      return -static_cast<int>(cudaErrorInvalidValue);
  }
}
