// The int4 matvec at B = 1 for Hopper (sm_90a): x [1, 2 dh] bf16 @ packed
// int4 [dh, dout] -> [1, dout], y = sum_b s_b * (x_b . n_b - 8 sum x_b) over
// the biased nibbles n (0..15) of scale block b. One kernel template,
// `int4_fold_kernel<Conv, kSteps>`, over how a nibble becomes a bf16
// (`Conv`) and the steps of each warp's loads in flight (`kSteps`). It is
// K6's B = 1 kernel (int4_matmul.cu: Packed, kDepth) and the int4 probe's
// P3 v5 (Packed) and v2 (PerElement) (int4_variants.cu: kSteps 1, 2, 4 for
// the probe's groups 4, 8, 16).
//
// Layout (weights/quantize.QuantWeight4): byte row i of q4 holds input row i
// in its low nibble and row i + dh in its high nibble; scale [nb, dout] f32
// holds one scale per (input block of 2 dh / nb rows, output column), so the
// high nibbles of byte row i use scale block nb/2 + i / bs, not i / bs (bs =
// dh / (nb / 2) packed rows).
//
// What bounds it on this card: device-memory bandwidth (0.5 byte a weight,
// 2 multiply-adds), if each nibble costs few instructions: at 3.35 TB/s the
// card must take in 6.7 T nibbles/s, the order of its whole issue rate.
//
// Design: the TPU kernel's MXU product becomes mma.sync m16n8k16 bf16 with
// f32 accumulation, its A fragments built in registers from the packed
// bytes:
// - a warp owns 128 output columns; lane (g = lane / 4, t4 = lane % 4) loads
//   columns 16g..16g+15 of packed rows 4t4..4t4+3 of a 16-row step, four
//   16-byte loads straight into registers (a step: 16 rows x 128 contiguous
//   bytes; no shared-memory trip for the weights), each asking the L2 for
//   256-byte fetches. What hides the loads' latency is warps:
//   the launch bounds cap the registers at 128, so 16 warps fit an SM, and
//   a warp loads its next step once this one is summed (K6's kDepth 1). On
//   an H100 loading 1 or 2 steps ahead ran 3% and 15% slower (the second
//   spills), 3 ahead at 182 registers 37% slower, and a cp.async ring in
//   shared memory 8-16% slower than register loads at the same registers
//   (PERF.md, scripts/probe_int4_k6.py);
// - fragment map: the product of tile j (0..15) has A row g = the low
//   nibbles and A row g + 8 = the high nibbles of the same bytes, column
//   16g + j of the warp's 128; k slots 2t4, 2t4 + 1, 2t4 + 8, 2t4 + 9 of
//   lane (g, t4) are packed rows 4t4, 4t4 + 1, 4t4 + 2, 4t4 + 3 of the step
//   (the order of k inside one product is free). B column 0 holds x's low
//   half (rows i), column 1 its high half (rows i + dh), columns 2-7
//   zero, so lane (g, 0)'s c0 is column 16g + j's low-half partial and c3
//   its high-half partial; the cross terms c1, c2 are dropped
//   (int4_matmul.py `fragment_map` mirrors this for the tests);
// - conversion, the template's `Conv`:
//   Packed (K6, P3 v5): one byte_perm puts byte j of two rows in the low
//     bytes of two 16-bit lanes; (v & 0x000F000F) | 0x43004300 (one lop3)
//     is bf16 128 + n for both low nibbles, the same of v >> 4 for the high
//     ones. No int -> float conversion. The 128 comes off in the fold, as
//     p - (128 + 8) sum x_b (an exact bf16x2 subtract per pair ran 2%
//     slower);
//   PerElement (P3 v2): each nibble masked out of its byte and converted
//     int -> f32 on its own (I2FP.F32.U32, on the FP32 pipe), a pair packed
//     into bf16x2 (F2FP.BF16.F32.PACK_AB); the fold takes off 8 sum x_b.
//   Both are exact for every nibble 0..15;
// - fold: x is read per step (8 bytes a lane, lanes g < 2; L1/L2-resident)
//   and each lane sums its own rows of x in f32. At a scale block's end the
//   quad sums are reduced in a fixed order and lanes (g, 0) fold the
//   block's partials into their columns' sums in shared memory, acc +=
//   (p_lo - k sx_lo) s_lo + (p_hi - k sx_hi) s_hi, with the block's scales
//   fetched by cp.async into the warp's shared slot when the warp entered
//   the block;
// - one launch: the warps of a block split its rank's rows and are summed
//   in shared memory in warp order; where the packed rows split over
//   several blocks (`split` > 1), they form a thread-block cluster: the
//   other ranks write their sums into rank 0's shared memory (distributed
//   shared memory) and leave, and rank 0, past one cluster barrier, adds
//   them in rank order and writes the output (rank 0 reading the ranks'
//   sums between two full cluster barriers ran 2% slower a decode token).
//   No scratch, no atomics, no second launch: the result is the same bit
//   for bit from run to run. The plan (int4_matmul.py `_b1_plan`) picks the
//   cluster size and 4 or 8 warps a block per shape.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kWarpCols = 128;     // output columns of a warp (and a block)
constexpr int kStepRows = 16;      // packed rows of a step (one k of 16)
constexpr int kMinWarps = 4;
constexpr int kMaxWarps = 8;
constexpr int kMaxCluster = 8;     // the portable cluster size
constexpr int kDepth = 1;          // K6's steps of each warp's loads in flight

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

// The conversions: `tile` gives tile j's A fragment (a0..a3: the low
// nibbles of rows 0 and 1, their high nibbles, the same of rows 2 and 3,
// each word two bf16, the first row's in the low half) from a step's
// words; the fold takes kBias sum x_b off each block's partial sums.
struct Packed {
  static constexpr float kBias = 136.f;   // 8, and the magic's 128

  // bf16x2 of 128 + n for the low nibbles of bytes 0 and 2 of v
  static __device__ __forceinline__ uint32_t magic(uint32_t v) {
    return (v & 0x000F000Fu) | 0x43004300u;
  }

  static __device__ __forceinline__ void tile(const Step& st, int j,
                                              uint32_t (&a)[4]) {
    // byte j % 4 of word j / 4: rows 0 and 1, rows 2 and 3
    const uint32_t v01 = __byte_perm(word(st.w[0], j >> 2),
                                     word(st.w[1], j >> 2), sel(j));
    const uint32_t v23 = __byte_perm(word(st.w[2], j >> 2),
                                     word(st.w[3], j >> 2), sel(j));
    a[0] = magic(v01);
    a[1] = magic(v01 >> 4);
    a[2] = magic(v23);
    a[3] = magic(v23 >> 4);
  }
};

struct PerElement {
  static constexpr float kBias = 8.f;

  // bf16x2 of (n0, n1), each nibble converted to f32 on its own
  static __device__ __forceinline__ uint32_t pair(uint32_t n0, uint32_t n1) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(static_cast<float>(n0),
                                                   static_cast<float>(n1));
    return *reinterpret_cast<const uint32_t*>(&v);
  }

  static __device__ __forceinline__ void tile(const Step& st, int j,
                                              uint32_t (&a)[4]) {
    uint32_t b[4];   // byte j % 4 of word j / 4 of rows 0..3, in bits 0-7
#pragma unroll
    for (int r = 0; r < 4; ++r) b[r] = word(st.w[r], j >> 2) >> (8 * (j & 3));
    a[0] = pair(b[0] & 15u, b[1] & 15u);
    a[1] = pair((b[0] >> 4) & 15u, (b[1] >> 4) & 15u);
    a[2] = pair(b[2] & 15u, b[3] & 15u);
    a[3] = pair((b[2] >> 4) & 15u, (b[3] >> 4) & 15u);
  }
};

// grid (dout / 128, split), block 32 * warps, cluster (1, split, 1).
// Rank r covers packed rows [r * rows_per_rank, min(dh, (r + 1) *
// rows_per_rank)); its warps take consecutive runs of whole steps.
template <class Conv, int kSteps>
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
  const float bias = Conv::kBias;
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
        uint32_t a[4];
        Conv::tile(now, j, a);
        mma_fold(p_lo[j], p_hi[j], a, b0, b1);
      }
    }
  };

  if (steps > 0) {
    while (b_lo + bs <= w_begin) {
      b_lo += bs;
      ++cur;
    }
    // a ring of kSteps steps in registers: step s + kSteps is loaded into
    // step s's registers as soon as step s is summed
    Step buf[kSteps];
#pragma unroll
    for (int u = 0; u < kSteps; ++u) load(buf[u], u);
    fetch_scales(cur);
    for (int s0 = 0; s0 < steps; s0 += kSteps) {
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        if (s0 + u < steps) {
          sum_step(buf[u], s0 + u);
          load(buf[u], s0 + u + kSteps);
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

// Whether `split` ranks of `rows` packed rows (a multiple of `unit`) cover
// dh, each rank at least one row.
inline bool covers(int dh, int split, int rows, int unit) {
  return split >= 1 && rows > 0 && rows % unit == 0 &&
         static_cast<long long>(split) * rows >= dh &&
         static_cast<long long>(split - 1) * rows < dh;
}

// Launch int4_fold_kernel<Conv, kSteps> on x [1, 2 dh] bf16, q4 [dh, dout]
// uint8 and scale [nb, dout] f32 into out [1, dout] (f32 if out_f32, else
// bf16), all contiguous and 16-byte aligned, with the plan (int4_matmul.py
// `_b1_plan`): `split` ranks of one cluster (1..8) of `warps` warps (4..8),
// each rank `rows` packed rows (a multiple of 16). dout must be a multiple of
// 128, nb even, dh a multiple of 16 and of nb / 2 with dh / (nb / 2) a
// multiple of 8. A shape or plan it does not take returns
// cudaErrorInvalidValue before any launch; else the launch's cudaError_t.
template <class Conv, int kSteps>
cudaError_t launch_fold(const void* x, const void* q4, const void* scale,
                        void* out, int out_f32, int dh, int dout, int nb,
                        int split, int warps, int rows, cudaStream_t stream) {
  if (dout < kWarpCols || dout % kWarpCols || nb < 2 || nb % 2 ||
      dh % kStepRows || dh % (nb / 2) || (dh / (nb / 2)) % 8 ||
      !covers(dh, split, rows, kStepRows) || split > kMaxCluster ||
      warps < kMinWarps || warps > kMaxWarps) {
    return cudaErrorInvalidValue;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(dout / kWarpCols, split);
  cfg.blockDim = dim3(32 * warps);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = split;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int nbh = nb / 2;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, int4_fold_kernel<Conv, kSteps>,
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(q4),
      static_cast<const float*>(scale), out, out_f32, dh, dout, dh / nbh,
      nbh, rows,
      (rows + warps * kStepRows - 1) / (warps * kStepRows) * kStepRows);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace
