// K6: x [B, din] bf16 @ packed int4 [din/2, dout] -> [B, dout], for Hopper
// (sm_90a). The decode matvec of a 4-bit decoder base.
//
// Replaces the Pallas TPU kernel `_int4_matvec_kernel`
// (flash_vstream_tpu/kernels/int4_matmul.py:45, launched by `int4_matmul`).
// Layout (weights/quantize.QuantWeight4): byte row i of q4 holds input row i
// in its low nibble and row i + din/2 in its high nibble, each as q + 8 in
// [1, 15]; scale [nb, dout] f32 holds one scale per (input block of din/nb
// rows, output column), so the high nibbles of byte row i use scale block
// nb/2 + i / bs, not i / bs (bs = din / nb packed rows).
//
// Arithmetic, as the TPU kernel:
//   B == 1: the biased nibbles multiply x on the tensor cores in f32 and the
//     bias and the scale apply to the partial sums:
//     y = sum_b s_b * (x_b . n_b - 8 sum x_b).
//   B > 1: each weight is dequantized to bf16, (n - 8) * bf16(scale), and the
//     product with x accumulates in f32.
//
// What bounds it on this card: device-memory bandwidth (0.5 byte a weight,
// 2 multiply-adds), if each nibble costs few instructions: at 3.35 TB/s the
// card must take in 6.7 T nibbles/s, the order of its whole issue rate.
//
// B == 1 design (`int4_fold_kernel<Packed, kDepth>`, in int4_b1.cuh, which
// the int4 probe's P3 v5 and v2 share): mma.sync m16n8k16 bf16 with f32
// accumulation, its A fragments built in registers from 16-byte loads (bf16
// 128 + n by one byte_perm and one lop3 for two nibbles), the bias and the
// 128 folded into each scale block's partial sums, and one launch a matvec
// through a thread-block cluster along the packed rows. int4_b1.cuh has the
// design and what an H100 measured of its alternatives.
//
// B > 1 (`int4_matvec_kernel`, the speculative-verify path, not yet served):
// threads map along dout, 16 threads x 8 columns over a 128-column tile,
// one 8-byte load a packed row; up to 8 rows of x per block share one
// dequantization; where the packed rows split over grid.y, each split writes
// f32 partials and `int4_reduce_kernel` adds them in a fixed order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int4_b1.cuh"

namespace {

// --- B > 1 -----------------------------------------------------------------

constexpr int kTx = 16;               // threads along dout
constexpr int kTy = 16;               // threads along the packed rows
constexpr int kCols = 8;              // output columns per thread
constexpr int kTile = kTx * kCols;    // 128 columns per block
constexpr int kChunk = 64;            // packed rows staged per pass
constexpr int kRowsPerThread = kChunk / kTy;
constexpr int kThreads = kTx * kTy;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// grid (dout / 128, splits, ceil(B / R)), block (16, 16). Split y covers
// packed rows [y * rows_per_split, min(dh, (y + 1) * rows_per_split)).
// With `partial` set, writes f32 partials [splits, B, dout]; else `out`.
template <int R>
__global__ void __launch_bounds__(kThreads)
    int4_matvec_kernel(const __nv_bfloat16* __restrict__ x,
                       const uint8_t* __restrict__ q4,
                       const float* __restrict__ scale,
                       float* __restrict__ partial, void* __restrict__ out,
                       int out_f32, int B, int dh, int dout, int bs, int nbh,
                       int rows_per_split) {
  __shared__ float xs[2][R][kChunk];
  __shared__ float red[kTy][kTile];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTx + tx;
  const int col0 = blockIdx.x * kTile + tx * kCols;
  const int r_begin = blockIdx.y * rows_per_split;
  const int r_end = min(r_begin + rows_per_split, dh);
  const int b0 = blockIdx.z * R;
  const long long din = 2LL * dh;

  float acc[R][kCols];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  }
  // the bf16-rounded scales of the current block
  float s_lo[kCols], s_hi[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) s_lo[c] = s_hi[c] = 0.f;
  int cur = -1;

  for (int c0 = r_begin; c0 < r_end; c0 += kChunk) {
    for (int i = tid; i < 2 * R * kChunk; i += kThreads) {
      const int h = i / (R * kChunk);
      const int r = (i / kChunk) % R;
      const int j = i % kChunk;
      const int row = c0 + j;
      const int b = b0 + r;
      float v = 0.f;
      if (row < r_end && b < B) {
        v = __bfloat162float(x[b * din + h * dh + row]);
      }
      xs[h][r][j] = v;
    }
    __syncthreads();

    uint2 w[kRowsPerThread];
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      const int row = c0 + ty + k * kTy;
      w[k] = row < r_end
                 ? __ldg(reinterpret_cast<const uint2*>(
                       q4 + static_cast<long long>(row) * dout + col0))
                 : make_uint2(0u, 0u);
    }
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      const int row = c0 + ty + k * kTy;
      if (row >= r_end) break;
      const int blk = row / bs;
      if (blk != cur) {
        cur = blk;
        load8(scale + static_cast<long long>(blk) * dout + col0, s_lo);
        load8(scale + static_cast<long long>(nbh + blk) * dout + col0, s_hi);
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          s_lo[c] = bf16_round(s_lo[c]);
          s_hi[c] = bf16_round(s_hi[c]);
        }
      }
      const int j = row - c0;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const unsigned word = c < 4 ? w[k].x : w[k].y;
        const unsigned byte = (word >> (8 * (c & 3))) & 0xFFu;
        const float w_lo = bf16_round((static_cast<float>(byte & 15u) - 8.f) *
                                      s_lo[c]);
        const float w_hi = bf16_round((static_cast<float>(byte >> 4) - 8.f) *
                                      s_hi[c]);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          acc[r][c] = fmaf(xs[0][r][j], w_lo, acc[r][c]);
          acc[r][c] = fmaf(xs[1][r][j], w_hi, acc[r][c]);
        }
      }
    }
    __syncthreads();
  }

  // sum the 16 row-threads of each column in a fixed order
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) red[ty][tx * kCols + c] = acc[r][c];
    __syncthreads();
    const int b = b0 + r;
    if (tid < kTile && b < B) {
      float s = 0.f;
#pragma unroll
      for (int t = 0; t < kTy; ++t) s += red[t][tid];
      const long long col = static_cast<long long>(blockIdx.x) * kTile + tid;
      if (partial != nullptr) {
        partial[(static_cast<long long>(blockIdx.y) * B + b) * dout + col] = s;
      } else {
        store(out, out_f32, static_cast<long long>(b) * dout + col, s);
      }
    }
    __syncthreads();
  }
}

// out[i] = sum over splits of partial[k, i], k in order.
__global__ void int4_reduce_kernel(const float* __restrict__ partial,
                                   void* __restrict__ out, int out_f32,
                                   int splits, long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += partial[k * n + i];
  store(out, out_f32, i, s);
}

template <int R>
void launch(const void* x, const void* q4, const void* scale, float* partial,
            void* out, int out_f32, int B, int dh, int dout, int nb,
            int splits, int rows_per_split, cudaStream_t stream) {
  const dim3 grid(dout / kTile, splits, (B + R - 1) / R);
  const dim3 block(kTx, kTy);
  const int nbh = nb / 2;
  const int bs = dh / nbh;
  int4_matvec_kernel<R><<<grid, block, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(q4),
      static_cast<const float*>(scale), partial, out, out_f32, B, dh, dout,
      bs, nbh, rows_per_split);
}

}  // namespace

// x [B, 2 * dh] bf16, q4 [dh, dout] uint8, scale [nb, dout] f32, out [B, dout]
// (f32 if out_f32 else bf16), all contiguous and 16-byte aligned; dout a
// multiple of 128, nb even, dh a multiple of 16 and of nb / 2 with
// dh / (nb / 2) a multiple of 8. The plan (int4_matmul.py `_plan`):
// B == 1: `split` ranks of one cluster (1..8) of `warps` warps (4..8), each
//   rank `rows` packed rows (a multiple of 16); `partial` must be null.
// B > 1: `split` blocks along the packed rows of `rows` each (a multiple of
//   64), `warps` 8; with split > 1, `partial` is f32 scratch
//   [split, B, dout] and a second kernel sums it.
// A plan that does not cover dh or takes another size returns
// cudaErrorInvalidValue before any launch; else the launches' cudaError_t.
extern "C" int fvt_int4_matmul(const void* x, const void* q4,
                               const void* scale, void* partial, void* out,
                               int out_f32, int B, int dh, int dout, int nb,
                               int split, int warps, int rows, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || dout % kWarpCols || nb < 2 || nb % 2 || dh % kStepRows ||
      dh % (nb / 2) || (dh / (nb / 2)) % 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 1) {
    if (partial != nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(launch_fold<Packed, kDepth>(
        x, q4, scale, out, out_f32, dh, dout, nb, split, warps, rows, s));
  }
  if (!covers(dh, split, rows, 64) || warps != kThreads / 32 ||
      (split > 1) != (partial != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float* part = static_cast<float*>(partial);
  if (B <= 2) {
    launch<2>(x, q4, scale, part, out, out_f32, B, dh, dout, nb, split, rows,
              s);
  } else if (B <= 4) {
    launch<4>(x, q4, scale, part, out, out_f32, B, dh, dout, nb, split, rows,
              s);
  } else {
    launch<8>(x, q4, scale, part, out, out_f32, B, dh, dout, nb, split, rows,
              s);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || split == 1) return static_cast<int>(err);
  const long long n = static_cast<long long>(B) * dout;
  const int threads = 256;
  int4_reduce_kernel<<<static_cast<unsigned>((n + threads - 1) / threads),
                       threads, 0, s>>>(part, out, out_f32, split, n);
  return static_cast<int>(cudaGetLastError());
}
