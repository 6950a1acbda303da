// K6: x [B, din] bf16 @ packed int4 [din/2, dout] -> [B, dout], for Hopper
// (sm_90a). The decode matvec of a 4-bit decoder base.
//
// Replaces the Pallas TPU kernel `_int4_matvec_kernel`
// (flash_vstream_tpu/kernels/int4_matmul.py:45, launched by `int4_matmul`).
// Layout (weights/quantize.QuantWeight4): byte row i of q4 holds input row i
// in its low nibble and row i + din/2 in its high nibble, each as q + 8 in
// [1, 15]; scale [nb, dout] f32 holds one scale per (input block of din/nb
// rows, output column), so the high nibbles of byte row i use scale block
// nb/2 + i / bs, not i / bs.
//
// Arithmetic, as the TPU kernel:
//   B == 1 (FOLD): the biased nibbles multiply x in f32 and the bias and the
//     scale apply to the partial sums: y = sum_b s_b * (x_b . n_b - 8 sum x_b).
//   B > 1: each weight is dequantized to bf16, (n - 8) * bf16(scale), and the
//     product with x accumulates in f32.
//
// What bounds it on this card: device-memory bandwidth. At B = 1 it does 2
// multiply-adds per 0.5 byte read, far below the card's ops-per-byte ratio.
// Design for that:
// - threads map along dout: 16 threads x 8 columns cover a 128-column tile,
//   and each thread reads its 8 bytes of a packed row with one 8-byte load,
//   so a half-warp reads 128 contiguous bytes; 16 threads along the packed
//   rows stride through them, four rows in flight per thread per pass;
// - the x rows of a pass (both halves, 64 packed rows) are staged in shared
//   memory as f32, so the inner loop does no conversion and every x value is
//   read from device memory once per block;
// - where dout alone gives too few blocks (wk/wv: 512 columns = 4 tiles),
//   the packed rows split over grid.y; each split writes f32 partials and a
//   second kernel adds them in a fixed order (deterministic, no atomics);
// - B > 1 runs up to 8 rows of x per block (grid.z covers the rest), so one
//   dequantization of a weight serves 8 rows.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

__device__ __forceinline__ void store(void* out, int out_f32, long long i,
                                      float v) {
  if (out_f32) {
    static_cast<float*>(out)[i] = v;
  } else {
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16(v);
  }
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
template <int R, bool FOLD>
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
  // FOLD: the partial sums of the current scale block, biased
  float p_lo[kCols], p_hi[kCols];
  float sx_lo = 0.f, sx_hi = 0.f;
  // the scales of the current block: f32 (FOLD) or bf16-rounded
  float s_lo[kCols], s_hi[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    p_lo[c] = p_hi[c] = 0.f;
    s_lo[c] = s_hi[c] = 0.f;
  }
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
        if (FOLD && cur >= 0) {
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            acc[0][c] += (p_lo[c] - 8.f * sx_lo) * s_lo[c] +
                         (p_hi[c] - 8.f * sx_hi) * s_hi[c];
            p_lo[c] = p_hi[c] = 0.f;
          }
          sx_lo = sx_hi = 0.f;
        }
        cur = blk;
        load8(scale + static_cast<long long>(blk) * dout + col0, s_lo);
        load8(scale + static_cast<long long>(nbh + blk) * dout + col0, s_hi);
        if (!FOLD) {
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            s_lo[c] = bf16_round(s_lo[c]);
            s_hi[c] = bf16_round(s_hi[c]);
          }
        }
      }
      const int j = row - c0;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const unsigned word = c < 4 ? w[k].x : w[k].y;
        const unsigned byte = (word >> (8 * (c & 3))) & 0xFFu;
        const float n_lo = static_cast<float>(byte & 15u);
        const float n_hi = static_cast<float>(byte >> 4);
        if (FOLD) {
          p_lo[c] = fmaf(xs[0][0][j], n_lo, p_lo[c]);
          p_hi[c] = fmaf(xs[1][0][j], n_hi, p_hi[c]);
        } else {
          const float w_lo = bf16_round((n_lo - 8.f) * s_lo[c]);
          const float w_hi = bf16_round((n_hi - 8.f) * s_hi[c]);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            acc[r][c] = fmaf(xs[0][r][j], w_lo, acc[r][c]);
            acc[r][c] = fmaf(xs[1][r][j], w_hi, acc[r][c]);
          }
        }
      }
      if (FOLD) {
        sx_lo += xs[0][0][j];
        sx_hi += xs[1][0][j];
      }
    }
    __syncthreads();
  }
  if (FOLD && cur >= 0) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      acc[0][c] += (p_lo[c] - 8.f * sx_lo) * s_lo[c] +
                   (p_hi[c] - 8.f * sx_hi) * s_hi[c];
    }
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

template <int R, bool FOLD>
void launch(const void* x, const void* q4, const void* scale, float* partial,
            void* out, int out_f32, int B, int dh, int dout, int nb,
            int splits, int rows_per_split, cudaStream_t stream) {
  const dim3 grid(dout / kTile, splits, (B + R - 1) / R);
  const dim3 block(kTx, kTy);
  const int nbh = nb / 2;
  const int bs = dh / nbh;
  int4_matvec_kernel<R, FOLD><<<grid, block, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(q4),
      static_cast<const float*>(scale), partial, out, out_f32, B, dh, dout,
      bs, nbh, rows_per_split);
}

}  // namespace

// x [B, 2 * dh] bf16, q4 [dh, dout] uint8, scale [nb, dout] f32, out [B, dout]
// (f32 if out_f32 else bf16), all contiguous and 16-byte aligned; dout a
// multiple of 128, nb even, dh a multiple of nb / 2. With splits > 1,
// `partial` is f32 scratch [splits, B, dout]. Returns the cudaError_t of the
// launches.
extern "C" int fvt_int4_matmul(const void* x, const void* q4,
                               const void* scale, void* partial, void* out,
                               int out_f32, int B, int dh, int dout, int nb,
                               int splits, int rows_per_split, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = splits > 1 ? static_cast<float*>(partial) : nullptr;
  if (B == 1) {
    launch<1, true>(x, q4, scale, part, out, out_f32, B, dh, dout, nb, splits,
                    rows_per_split, s);
  } else if (B <= 2) {
    launch<2, false>(x, q4, scale, part, out, out_f32, B, dh, dout, nb,
                     splits, rows_per_split, s);
  } else if (B <= 4) {
    launch<4, false>(x, q4, scale, part, out, out_f32, B, dh, dout, nb,
                     splits, rows_per_split, s);
  } else {
    launch<8, false>(x, q4, scale, part, out, out_f32, B, dh, dout, nb,
                     splits, rows_per_split, s);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long n = static_cast<long long>(B) * dout;
  const int threads = 256;
  int4_reduce_kernel<<<static_cast<unsigned>((n + threads - 1) / threads),
                       threads, 0, s>>>(part, out, out_f32, splits, n);
  return static_cast<int>(cudaGetLastError());
}
