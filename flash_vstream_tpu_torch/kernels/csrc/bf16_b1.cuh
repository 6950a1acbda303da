// P4 at B = 1 for Hopper (sm_90a): y = x @ w, x [1, din] bf16, w [din,
// dout] bf16 row-major (dout contiguous), f32 sums, out [1, dout] bf16.
// Replaces `k_v6_bf16dot` (scripts/probe_int4_variants.py:266, launched by
// `bench_bf16`'s pallas_call :290), which the TPU grid runs as dout / blk
// column blocks of one jnp.dot each.
//
// What bounds it on this card: device-memory bandwidth. At the probe's
// [1, 3584] @ [3584, 18944] it moves 135.8 MB (2 bytes a weight, read once),
// 40.5 us at 3.35 TB/s; its 67.9 M multiply-adds are 0.14 us on the tensor
// cores. So the design keeps bytes in flight on every SM and spends few
// instructions a byte:
// - products on the tensor cores: mma.sync m16n8k16 bf16 with f32 sums,
//   A = w's transpose (a row of A is an output column, a k an input row),
//   B column 0 = x, columns 1-7 zero. No conversion and no widening: the
//   loaded words are bf16 already;
// - load map (the order of k inside one product is free): a warp owns 64
//   output columns; lane (g = lane / 4, t4 = lane % 4) loads columns
//   8g..8g+7 of rows 4t4..4t4+3 of a 16-row step, four 16-byte loads
//   straight into registers (`ld_weights`: no L1 allocation, 256-byte L2
//   fetches). A step is 16 rows x 128 contiguous bytes, 2 KB a warp, the
//   bytes of K6's step (int4_b1.cuh);
// - fragments paired in registers: an A word holds two k of one column,
//   a loaded word two columns of one row, so one byte_perm per A word
//   pairs rows k and k + 1 of a column (0x5410 the low columns, 0x7632 the
//   high ones). Tile j (0..3) has A row g = column 8g + 2j and A row g + 8
//   = column 8g + 2j + 1; lane (g, t4)'s k slots 2t4, 2t4 + 1, 2t4 + 8,
//   2t4 + 9 are rows 4t4..4t4+3 of the step, and lanes (0, t4) hold those
//   rows of x as B (8 bytes a step). Lane (g, 0)'s c0 and c2 sum columns
//   8g + 2j and 8g + 2j + 1; c1 and c3 (B column 1) are zero and dropped
//   (int4_variants.py `bf16_fragment` mirrors this for the tests). K6's
//   two k-sets in two B columns would not waste fewer products here: a
//   tile would cover 8 columns x 32 rows in place of 16 x 16;
// - what hides the loads' latency is warps: the launch bounds cap the
//   registers at 128 (16 warps an SM; `kSteps` 1 takes 54, so the card
//   holds more), and at one step a warp 16 warps keep 32 KB of loads in
//   flight an SM; `kSteps` 1, 2 or 4 (the probe's group 4, 8, 16) loads
//   that many steps ahead. On an H100 the products cost nothing beyond
//   the loads: the kernel with its byte_perms and products replaced by an
//   XOR of the loaded words ran as fast (scripts/probe_bf16_b1.py);
// - one launch: the warps of a block split its rank's rows in whole steps
//   and are summed in shared memory in warp order; where the rows split
//   over several blocks (`split` > 1) they form a thread-block cluster
//   along grid y, the other ranks write their sums into rank 0's shared
//   memory and leave, and rank 0, past one cluster barrier, adds them in
//   rank order and writes the output (int4_b1.cuh's tail). No scratch, no
//   atomics, no second launch: the same bits from run to run. The plan
//   (int4_variants.py `bf16_plan`) picks the cluster size and 1, 2, 4 or
//   8 warps a block: a grid the card holds at once (`bf16_b1_clusters`,
//   CUDA's occupancy of the instance), 16 warps an SM with the fewest
//   ranks.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int4_b1.cuh"   // ld_weights, word, covers, kStepRows, kMaxCluster

namespace {

constexpr int kBf16Cols = 64;    // output columns of a warp (and a block)
constexpr int kBf16MaxWarps = 8;

// lo += A . x (c0) and hi += A . x (c2) for one tile; c1 and c3 go to
// registers nothing reads.
__device__ __forceinline__ void mma_x(float& lo, float& hi,
                                      const uint32_t (&a)[4], uint32_t b0,
                                      uint32_t b1) {
  float d1, d3;
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %10, %2, %10};\n"
      : "+f"(lo), "=f"(d1), "+f"(hi), "=f"(d3)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

// The bf16 bits of f, rounded to nearest even (as __float2bfloat16) by
// integer operations, NaN kept a NaN.
__device__ __forceinline__ uint32_t bf16_bits(float f) {
  const uint32_t u = __float_as_uint(f);
  if ((u & 0x7FFFFFFFu) > 0x7F800000u) return 0x7FC0u;
  return (u + 0x7FFFu + ((u >> 16) & 1u)) >> 16;
}

struct Bf16Step {
  uint4 w[4];   // rows 4t4..4t4+3, columns 8g..8g+7
  uint2 x;      // lanes g == 0: x rows 4t4..4t4+3
};

// grid (dout / 64, split), block 32 * warps, cluster (1, split, 1). Rank r
// covers rows [r * rows_per_rank, min(din, (r + 1) * rows_per_rank)); its
// warps take consecutive runs of whole steps.
template <int kSteps>
__global__ void __launch_bounds__(kBf16MaxWarps * 32, 2)
    bf16_b1_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ w,
                   __nv_bfloat16* __restrict__ out, int din, int dout,
                   int rows_per_rank, int rows_per_warp) {
  __shared__ __align__(16) float red[kBf16MaxWarps][kBf16Cols];
  __shared__ __align__(16) float gathered[kMaxCluster][kBf16Cols];

  // a cluster's blocks signal that they have started; each waits for the
  // others only before it writes into rank 0's shared memory, at its end
  if (gridDim.y > 1) {
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int col0 = blockIdx.x * kBf16Cols;
  const int rank = blockIdx.y;
  const int r_end = min((rank + 1) * rows_per_rank, din);
  const int w_begin = rank * rows_per_rank + warp * rows_per_warp;
  const int steps =
      max(0, min(w_begin + rows_per_warp, r_end) - w_begin) >> 4;

  const __nv_bfloat16* wp =
      w + static_cast<long long>(w_begin + 4 * t4) * dout + col0 + 8 * g;
  const __nv_bfloat16* xp = x + w_begin + 4 * t4;
  auto load = [&](Bf16Step& st, int s) {   // step s into registers
    if (s < steps) {
      const __nv_bfloat16* p =
          wp + static_cast<long long>(s) * kStepRows * dout;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        st.w[r] = ld_weights(p + static_cast<long long>(r) * dout);
      }
      st.x = g == 0
                 ? __ldg(reinterpret_cast<const uint2*>(xp + s * kStepRows))
                 : make_uint2(0u, 0u);
    }
  };

  // acc[c]: lanes t4 == 0, column 8g + c (c0 of tile j is 2j, c2 2j + 1)
  float acc[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) acc[c] = 0.f;
  auto sum_step = [&](const Bf16Step& st) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t w0 = word(st.w[0], j), w1 = word(st.w[1], j);
      const uint32_t w2 = word(st.w[2], j), w3 = word(st.w[3], j);
      const uint32_t a[4] = {__byte_perm(w0, w1, 0x5410),
                             __byte_perm(w0, w1, 0x7632),
                             __byte_perm(w2, w3, 0x5410),
                             __byte_perm(w2, w3, 0x7632)};
      mma_x(acc[2 * j], acc[2 * j + 1], a, st.x.x, st.x.y);
    }
  };

  if (steps > 0) {
    // a ring of kSteps steps in registers: step s + kSteps is loaded into
    // step s's registers as soon as step s is summed
    Bf16Step buf[kSteps];
#pragma unroll
    for (int u = 0; u < kSteps; ++u) load(buf[u], u);
    for (int s0 = 0; s0 < steps; s0 += kSteps) {
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        if (s0 + u < steps) {
          sum_step(buf[u]);
          load(buf[u], s0 + u + kSteps);
        }
      }
    }
  }
  if (t4 == 0) {
    float4* r = reinterpret_cast<float4*>(&red[warp][8 * g]);
    r[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    r[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  }

  // warp 0 sums the warps in warp order, then the ranks in rank order:
  // lane l holds columns 2l and 2l + 1
  __syncthreads();
  float2 v = make_float2(0.f, 0.f);
  if (warp == 0) {
    for (int i = 0; i < warps; ++i) {
      const float2 r = reinterpret_cast<const float2*>(red[i])[lane];
      v.x += r.x;
      v.y += r.y;
    }
  }
  auto store = [&]() {
    reinterpret_cast<uint32_t*>(out + col0)[lane] =
        bf16_bits(v.x) | (bf16_bits(v.y) << 16);
  };
  if (gridDim.y == 1) {
    if (warp == 0) store();
    return;
  }
  // ranks r > 0 put their sums into rank 0's gathered[r] and leave; rank 0
  // waits for every rank's arrival (release / acquire) and adds them in
  // rank order
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (rank > 0) {
    if (warp == 0) {
      reinterpret_cast<float2*>(
          cg::this_cluster().map_shared_rank(&gathered[0][0], 0) +
          rank * kBf16Cols)[lane] = v;
    }
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    return;
  }
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  if (warp == 0) {
    for (int r = 1; r < static_cast<int>(gridDim.y); ++r) {
      const float2 s = reinterpret_cast<const float2*>(gathered[r])[lane];
      v.x += s.x;
      v.y += s.y;
    }
    store();
  }
}

// The launch of bf16_b1_kernel with `split` ranks of `warps` warps over
// dout / 64 column tiles.
cudaLaunchConfig_t bf16_config(int dout, int split, int warps,
                               cudaStream_t stream,
                               cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(dout / kBf16Cols, split);
  cfg.blockDim = dim3(32 * warps);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = split;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Launch bf16_b1_kernel<kSteps> on x [1, din] bf16 (8-byte aligned) and w
// [din, dout] bf16 (16-byte aligned), both contiguous, into out [1, dout]
// bf16 (4-byte aligned), with the plan (int4_variants.py `bf16_plan`):
// `split` ranks of one cluster (1..8) of `warps` warps (1..8), each rank
// `rows` rows (a multiple of 16). din must be a multiple of 16 and dout of
// 64. A shape or plan it does not take returns cudaErrorInvalidValue
// before any launch; else the launch's cudaError_t.
template <int kSteps>
cudaError_t launch_bf16_b1(const void* x, const void* w, void* out, int din,
                           int dout, int split, int warps, int rows,
                           cudaStream_t stream) {
  if (dout < kBf16Cols || dout % kBf16Cols || din < kStepRows ||
      din % kStepRows || !covers(din, split, rows, kStepRows) ||
      split > kMaxCluster || warps < 1 || warps > kBf16MaxWarps ||
      reinterpret_cast<uintptr_t>(x) % 8 ||
      reinterpret_cast<uintptr_t>(w) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 4) {
    return cudaErrorInvalidValue;
  }
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      bf16_config(dout, split, warps, stream, attr);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, bf16_b1_kernel<kSteps>, static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(out),
      din, dout, rows,
      (rows + warps * kStepRows - 1) / (warps * kStepRows) * kStepRows);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The clusters of `split` blocks of `warps` warps of bf16_b1_kernel<kSteps>
// that the card holds at once (cudaOccupancyMaxActiveClusters: the
// instances differ in registers, so in warps an SM), or minus the
// cudaError_t.
template <int kSteps>
int bf16_b1_clusters(int split, int warps) {
  if (split < 1 || split > kMaxCluster || warps < 1 ||
      warps > kBf16MaxWarps) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      bf16_config(kBf16Cols, split, warps, nullptr, attr);
  int n = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveClusters(&n, bf16_b1_kernel<kSteps>, &cfg);
  return err != cudaSuccess ? -static_cast<int>(err) : n;
}

}  // namespace
