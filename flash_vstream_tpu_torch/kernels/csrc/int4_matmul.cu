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
// B == 1 design (`int4_fold_kernel`): the TPU kernel's MXU product becomes
// mma.sync m16n8k16 bf16 with f32 accumulation, its A fragments built in
// registers from the packed bytes:
// - a warp owns 128 output columns; lane (g = lane / 4, t4 = lane % 4) loads
//   columns 16g..16g+15 of packed rows 4t4..4t4+3 of a 16-row step, four
//   16-byte loads straight into registers (a step: 16 rows x 128 contiguous
//   bytes; no shared-memory trip for the weights), each asking the L2 for
//   256-byte fetches. What hides the loads' latency is warps:
//   the launch bounds cap the registers at 128, so 16 warps fit an SM, and
//   a warp loads its next step once this one is summed (kDepth 1). On an
//   H100 loading 1 or 2 steps ahead ran 3% and 15% slower (the second
//   spills), 3 ahead at 182 registers 37% slower, and a cp.async ring in
//   shared memory 8-16% slower than register loads at the same registers
//   (PERF.md, scripts/probe_int4_k6.py);
// - fragment map: the product of tile j (0..15) has A row g = the low
//   nibbles and A row g + 8 = the high nibbles of the same bytes, column
//   16g + j of the warp's 128; k slots 2t4, 2t4 + 1, 2t4 + 8, 2t4 + 9 of
//   lane (g, t4) are packed rows 4t4, 4t4 + 1, 4t4 + 2, 4t4 + 3 of the step
//   (the order of k inside one product is free). B column 0 holds x's low
//   half (rows i), column 1 its high half (rows i + din/2), columns 2-7
//   zero, so lane (g, 0)'s c0 is column 16g + j's low-half partial and c3
//   its high-half partial; the cross terms c1, c2 are dropped
//   (int4_matmul.py `fragment_map` mirrors this for the tests);
// - conversion: one byte_perm puts byte j of two rows in the low bytes of
//   two 16-bit lanes; (v & 0x000F000F) | 0x43004300 (one lop3) is bf16
//   128 + n for both low nibbles, the same of v >> 4 for the high ones. No
//   int -> float conversion. The 128 comes off in the fold, as
//   p - (128 + 8) sum x_b (an exact bf16x2 subtract per pair ran 2%
//   slower);
// - fold: x is read per step (8 bytes a lane, lanes g < 2; L1/L2-resident)
//   and each lane sums its own rows of x in f32. At a scale block's end the
//   quad sums are reduced in a fixed order and lanes (g, 0) fold the
//   block's partials into their columns' sums in shared memory, acc +=
//   (p_lo - k sx_lo) s_lo + (p_hi - k sx_hi) s_hi, with the block's scales
//   fetched by cp.async into the warp's shared slot when the warp entered
//   the block;
// - one launch: the warps of a block split its rank's rows and are summed
//   in shared memory in warp order; where the packed rows split over
//   several blocks (`cluster` > 1), they form a thread-block cluster: the
//   other ranks write their sums into rank 0's shared memory (distributed
//   shared memory) and leave, and rank 0, past one cluster barrier, adds
//   them in rank order and writes the output (rank 0 reading the ranks'
//   sums between two full cluster barriers ran 2% slower a decode token). No scratch, no atomics, no second
//   launch: the result is the same bit for bit from run to run. The plan
//   (int4_matmul.py `_plan`) picks the cluster size and 4 or 8 warps a
//   block per shape.
//
// B > 1 (`int4_matvec_kernel`, the speculative-verify path, not yet served):
// threads map along dout, 16 threads x 8 columns over a 128-column tile,
// one 8-byte load a packed row; up to 8 rows of x per block share one
// dequantization; where the packed rows split over grid.y, each split writes
// f32 partials and `int4_reduce_kernel` adds them in a fixed order.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

// --- B == 1 ----------------------------------------------------------------

constexpr int kWarpCols = 128;     // output columns of a warp (and a block)
constexpr int kStepRows = 16;      // packed rows of a step (one k of 16)
constexpr int kMinWarps = 4;
constexpr int kMaxWarps = 8;
constexpr int kMaxCluster = 8;     // the portable cluster size
constexpr int kDepth = 1;          // steps of each warp's loads in flight

__device__ __forceinline__ void store(void* out, int out_f32, long long i,
                                      float v) {
  if (out_f32) {
    static_cast<float*>(out)[i] = v;
  } else {
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16(v);
  }
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// The byte_perm selector of byte j % 4 of two words into bytes 0 and 2
// (0x4400, 0x5511, 0x6622, 0x7733; bytes 1 and 3 are masked off).
__host__ __device__ constexpr uint32_t sel(int j) {
  return 0x4400u + 0x1111u * static_cast<uint32_t>(j & 3);
}

// bf16x2 of 128 + n for the low nibbles of bytes 0 and 2 of v
__device__ __forceinline__ uint32_t magic(uint32_t v) {
  return (v & 0x000F000Fu) | 0x43004300u;
}

// lo += A_lo . x_lo and hi += A_hi . x_hi for one tile (see the map above);
// the cross terms go to registers nothing reads.
__device__ __forceinline__ void mma_fold(float& lo, float& hi,
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  float d1, d2;
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %10, %10, %3};\n"
      : "+f"(lo), "=f"(d1), "=f"(d2), "+f"(hi)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

// 16 bytes of weights, read once: no L1 allocation, and the L2 asks device
// memory for 256 bytes (the neighbouring column tile's too)
__device__ __forceinline__ uint4 ld_weights(const void* p) {
  uint4 v;
  asm volatile(
      "ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

struct Step {
  uint4 w[4];   // packed rows 4t4..4t4+3, columns 16g..16g+15
  uint2 x;      // lanes g < 2: x rows 4t4..4t4+3 of half g
};

// grid (dout / 128, cluster), block 32 * warps, cluster (1, cluster, 1).
// Rank r covers packed rows [r * rows_per_rank, min(dh, (r + 1) *
// rows_per_rank)); its warps take consecutive runs of whole steps.
__global__ void __launch_bounds__(kMaxWarps * 32, 2)
    int4_fold_kernel(const __nv_bfloat16* __restrict__ x,
                     const uint8_t* __restrict__ q4,
                     const float* __restrict__ scale, void* __restrict__ out,
                     int out_f32, int dh, int dout, int bs, int nbh,
                     int rows_per_rank, int rows_per_warp) {
  __shared__ __align__(16) float ss[kMaxWarps][2][kWarpCols];
  __shared__ float red[kMaxWarps][kWarpCols];
  __shared__ float gathered[kMaxCluster][kWarpCols];   // rank 0's: the ranks'

  // a cluster's blocks signal that they have started; each waits for the
  // others only before it writes into rank 0's shared memory, at its end
  if (gridDim.y > 1) {
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int col0 = blockIdx.x * kWarpCols;
  const int rank = blockIdx.y;
  const int r_end = min((rank + 1) * rows_per_rank, dh);
  const int w_begin = rank * rows_per_rank + warp * rows_per_warp;
  const int steps =
      max(0, min(w_begin + rows_per_warp, r_end) - w_begin) >> 4;

  const uint8_t* wp = q4 + static_cast<long long>(w_begin + 4 * t4) * dout +
                      col0 + 16 * g;
  const __nv_bfloat16* xp = x + (g & 1) * dh + w_begin + 4 * t4;
  auto load = [&](Step& st, int s) {   // step s into registers
    if (s < steps) {
      const uint8_t* p = wp + static_cast<long long>(s) * kStepRows * dout;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        st.w[r] = ld_weights(p + r * dout);
      }
      st.x = g < 2 ? __ldg(reinterpret_cast<const uint2*>(xp + s * kStepRows))
                   : make_uint2(0u, 0u);
    }
  };

  float* sslot = &ss[warp][0][0];
  auto fetch_scales = [&](int blk) {   // the block's lo and hi scales
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = lane + 32 * i;           // 64 chunks of 4 floats
      const int h = c >> 5, off = 4 * (c & 31);
      cp_async_16(sslot + h * kWarpCols + off,
                  scale + static_cast<long long>(blk + h * nbh) * dout +
                      col0 + off);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  // lanes t4 == 0 sum their columns' folded blocks in red[warp]
  float* acc = &red[warp][16 * g];
  float p_lo[16], p_hi[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    if (t4 == 0) acc[j] = 0.f;
    p_lo[j] = p_hi[j] = 0.f;
  }
  float sx = 0.f;   // lanes g < 2: the sum of this lane's x in the block
  const float bias = 136.f;   // 8, and the magic's 128
  // the scale block being summed, cur, and its first row, b_lo; no integer
  // division (nvcc would convert through float: I2F)
  int cur = 0, b_lo = 0;

  auto fold = [&]() {
    float t = sx;
    t += __shfl_xor_sync(0xffffffffu, t, 1);
    t += __shfl_xor_sync(0xffffffffu, t, 2);
    const float k_lo = bias * __shfl_sync(0xffffffffu, t, 0);
    const float k_hi = bias * __shfl_sync(0xffffffffu, t, 4);
    sx = 0.f;
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float v = fmaf(p_lo[j] - k_lo, sslot[16 * g + j], acc[j]);
      if (t4 == 0) {
        acc[j] = fmaf(p_hi[j] - k_hi, sslot[kWarpCols + 16 * g + j], v);
      }
      p_lo[j] = p_hi[j] = 0.f;
    }
    __syncwarp();
  };

  auto advance = [&]() {
    fold();
    ++cur;
    b_lo += bs;
    fetch_scales(cur);
  };

  // step s of this warp: its products into p_lo / p_hi, folding where a
  // scale block ends
  auto sum_step = [&](const Step& now, int s) {
    const int row0 = w_begin + s * kStepRows;
    if (row0 >= b_lo + bs) advance();
    // a step spans two scale blocks only where bs % 16 == 8 (rows 0-7 and
    // 8-15, lanes t4 < 2 and t4 >= 2): each block's rows then go through
    // the products in a pass of their own
    const bool two = row0 + 8 >= b_lo + bs;
    for (int pass = 0; pass <= static_cast<int>(two); ++pass) {
      if (pass == 1) advance();
      const bool on = !two || ((t4 < 2) == (pass == 0));
      const uint32_t b0 = on ? now.x.x : 0u, b1 = on ? now.x.y : 0u;
      if (on) {
        const float2 x01 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&now.x.x));
        const float2 x23 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&now.x.y));
        sx += (x01.x + x01.y) + (x23.x + x23.y);
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        // byte j % 4 of word j / 4: rows 0 and 1, rows 2 and 3
        const uint32_t v01 = __byte_perm(word(now.w[0], j >> 2),
                                         word(now.w[1], j >> 2), sel(j));
        const uint32_t v23 = __byte_perm(word(now.w[2], j >> 2),
                                         word(now.w[3], j >> 2), sel(j));
        const uint32_t a[4] = {magic(v01), magic(v01 >> 4), magic(v23),
                               magic(v23 >> 4)};
        mma_fold(p_lo[j], p_hi[j], a, b0, b1);
      }
    }
  };

  if (steps > 0) {
    while (b_lo + bs <= w_begin) {
      b_lo += bs;
      ++cur;
    }
    // a ring of kDepth steps in registers: step s + kDepth is loaded into
    // step s's registers as soon as step s is summed
    Step buf[kDepth];
#pragma unroll
    for (int u = 0; u < kDepth; ++u) load(buf[u], u);
    fetch_scales(cur);
    for (int s0 = 0; s0 < steps; s0 += kDepth) {
#pragma unroll
      for (int u = 0; u < kDepth; ++u) {
        if (s0 + u < steps) {
          sum_step(buf[u], s0 + u);
          load(buf[u], s0 + u + kDepth);
        }
      }
    }
    fold();
  }

  // the warps' sums in warp order, then the ranks' in rank order
  __syncthreads();
  const int tid = threadIdx.x;
  float v = 0.f;
  if (tid < kWarpCols) {
    for (int w = 0; w < warps; ++w) v += red[w][tid];
  }
  if (gridDim.y == 1) {
    if (tid < kWarpCols) store(out, out_f32, col0 + tid, v);
    return;
  }
  // ranks r > 0 put their sums into rank 0's gathered[r] and leave; rank 0
  // waits for every rank's arrival (release / acquire) and adds them in
  // rank order
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (rank > 0) {
    if (tid < kWarpCols) {
      cg::this_cluster().map_shared_rank(&gathered[0][0], 0)
          [rank * kWarpCols + tid] = v;
    }
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    return;
  }
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  if (tid < kWarpCols) {
    for (int r = 1; r < static_cast<int>(gridDim.y); ++r) {
      v += gathered[r][tid];
    }
    store(out, out_f32, col0 + tid, v);
  }
}

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

// Whether `split` ranks of `rows` packed rows (a multiple of `unit`) cover
// dh, each rank at least one row.
bool covers(int dh, int split, int rows, int unit) {
  return split >= 1 && rows > 0 && rows % unit == 0 &&
         static_cast<long long>(split) * rows >= dh &&
         static_cast<long long>(split - 1) * rows < dh;
}

}  // namespace

// x [B, 2 * dh] bf16, q4 [dh, dout] uint8, scale [nb, dout] f32, out [B, dout]
// (f32 if out_f32 else bf16), all contiguous and 16-byte aligned; dout a
// multiple of 128, nb even, dh a multiple of 16 and of nb / 2 with
// dh / (nb / 2) a multiple of 8. The plan (int4_matmul.py `_plan`):
// B == 1: `split` ranks of one cluster (1..8) of `warps` warps (4..16), each
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
    if (!covers(dh, split, rows, kStepRows) || split > kMaxCluster ||
        warps < kMinWarps || warps > kMaxWarps || partial != nullptr) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(dout / kWarpCols, split);
    cfg.blockDim = dim3(32 * warps);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = split;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const int nbh = nb / 2;
    const cudaError_t err = cudaLaunchKernelEx(
        &cfg, int4_fold_kernel, static_cast<const __nv_bfloat16*>(x),
        static_cast<const uint8_t*>(q4), static_cast<const float*>(scale),
        out, out_f32, dh, dout, dh / nbh, nbh, rows,
        (rows + warps * kStepRows - 1) / (warps * kStepRows) * kStepRows);
    return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
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
