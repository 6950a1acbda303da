// P2: frame-local attention, a whole-row softmax per (frame, head block), for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `kern` (scripts/probe_vit_variants.py:219,
// launched at :237 by the probe's `framekernel` mode): one program per
// (frame, block of heads) computes, for every head of its block,
//   s = q k^T in f32 * 1/sqrt(Dh);  m = max over all S keys;  p = exp(s - m);
//   l = sum p;  p = (p / l) rounded to bf16;  o = p v in f32, stored in q's
//   dtype,
// with no mask and no causality: the ViT's attention inside one frame. It is
// the TPU body's whole-row softmax, not K1's online one.
//
// Design. One block per (64 query rows, head block, frame), four warps of 16
// query rows, the block's heads handled in turn (so `head_block` is heads
// per block here as it is heads per program on the TPU). Both products run
// on the tensor cores as `mma.sync.m16n8k16` bf16 fragments with f32 sums
// (mma_common.cuh); the score accumulator's register layout is the A
// operand of the P V product, so p goes from the softmax to the product
// without shared memory.
//   - Where a head's K and V fit in shared memory (S <= 256 at Dh 64 and 80,
//     S <= 128 at Dh 128), they are staged whole and each warp keeps its 16
//     rows of scores in registers: one pass, the TPU body's order.
//   - Above that (S up to 1,024, a 448 px frame) the kernel makes two passes
//     over 64-key tiles: the row max and the sum first (the sum rescaled as
//     the max grows), then p = exp(s - m) / l rounded to bf16 and p v. The
//     same arithmetic, with Q K^T computed twice.
// Rows and keys past S are zero-filled on load and masked; the wrapper pads
// nothing. Head dims 64, 80 and 128.
//
// What bounds it on this card: at the ViT's 224 px shapes (4 frames x 16
// heads x 256 or 64 tokens, Dh 80) the bytes (10.5 MB, 3.1 us) and the
// launch; at 448 px (S 1,024) the tensor cores (21.5 GFLOP, 21.7 us). This
// first version loads tiles synchronously: no TMA, no wgmma.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace {

using namespace fvt;

constexpr int kBlockM = 64;  // query rows per block: 4 warps x 16 rows
constexpr int kBlockN = 64;  // keys per tile
constexpr int kWarps = 4;

struct FrameParams {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int s, head_block;
  float scale_log2;  // 1/sqrt(Dh) * log2(e): exponentials run as exp2
};

// Q fragments of rows row0 / row1 (zero past S) for one head.
template <int D>
__device__ __forceinline__ void load_q(uint32_t (&qf)[D / 16][4],
                                       const __nv_bfloat16* qb, long long ss,
                                       int row0, int row1, int s, int t4) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + t4 * 2;
    qf[kk][0] = row0 < s ? ld32(qb + row0 * ss + c) : 0u;
    qf[kk][1] = row1 < s ? ld32(qb + row1 * ss + c) : 0u;
    qf[kk][2] = row0 < s ? ld32(qb + row0 * ss + c + 8) : 0u;
    qf[kk][3] = row1 < s ? ld32(qb + row1 * ss + c + 8) : 0u;
  }
}

// Rows [r0, r0 + rows) of one head's K (and V when sV is given) into shared
// memory with 16-byte loads, zero past S.
template <int D>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* sK, __nv_bfloat16* sV,
                                           const __nv_bfloat16* kb,
                                           const __nv_bfloat16* vb,
                                           const FrameParams& p, int r0,
                                           int rows) {
  constexpr int kLd = D + kPad, kVec = D / 8;
  for (int i = threadIdx.x; i < rows * kVec; i += kWarps * 32) {
    const int r = i / kVec, c = (i % kVec) * 8;
    const bool live = r0 + r < p.s;
    *reinterpret_cast<uint4*>(&sK[r * kLd + c]) =
        live ? *reinterpret_cast<const uint4*>(kb + (r0 + r) * p.k_ss + c)
             : make_uint4(0u, 0u, 0u, 0u);
    if (sV != nullptr) {
      *reinterpret_cast<uint4*>(&sV[r * kLd + c]) =
          live ? *reinterpret_cast<const uint4*>(vb + (r0 + r) * p.v_ss + c)
               : make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// Scores of this warp's 16 rows against the 8 * NS keys staged from sK
// (already in the log2 domain), keys at or past `valid` masked to -inf.
template <int D, int NS>
__device__ __forceinline__ void scores(float (&s)[NS][4],
                                       const uint32_t (&qf)[D / 16][4],
                                       const __nv_bfloat16* sK, int valid,
                                       float scale_log2, int g, int t4) {
  constexpr int kLd = D + kPad;
#pragma unroll
  for (int nt = 0; nt < NS; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) {
      const __nv_bfloat16* kr = &sK[(nt * 8 + g) * kLd + kk * 16 + t4 * 2];
      const uint32_t bf[2] = {ld32(kr), ld32(kr + 8)};
      mma_16816(s[nt], qf[kk], bf);
    }
  }
#pragma unroll
  for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = nt * 8 + t4 * 2 + (e & 1);
      s[nt][e] = col < valid ? s[nt][e] * scale_log2 : -INFINITY;
    }
  }
}

// acc += P V over KS k-steps of 16 keys, P given as packed bf16 A fragments.
template <int D, int KS>
__device__ __forceinline__ void pv(float (&acc)[D / 8][4],
                                   const uint32_t (&pa)[KS][4],
                                   const __nv_bfloat16* sV, int g, int t4) {
  constexpr int kLd = D + kPad;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int r = kk * 16 + t4 * 2;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const int c = dt * 8 + g;
      const uint32_t bf[2] = {
          pack_bf16(sV[r * kLd + c], sV[(r + 1) * kLd + c]),
          pack_bf16(sV[(r + 8) * kLd + c], sV[(r + 9) * kLd + c])};
      mma_16816(acc[dt], pa[kk], bf);
    }
  }
}

template <int D>
__device__ __forceinline__ void store_o(const float (&acc)[D / 8][4],
                                        __nv_bfloat16* ob, long long ss,
                                        int row0, int row1, int s, int t4) {
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int c = dt * 8 + t4 * 2;
    if (row0 < s)
      *reinterpret_cast<uint32_t*>(ob + row0 * ss + c) =
          pack_f32(acc[dt][0], acc[dt][1]);
    if (row1 < s)
      *reinterpret_cast<uint32_t*>(ob + row1 * ss + c) =
          pack_f32(acc[dt][2], acc[dt][3]);
  }
}

// One pass: K and V of a head staged whole (NT tiles of 64 keys), the
// warp's 16 rows of scores kept in registers.
template <int D, int NT>
__global__ void __launch_bounds__(kWarps * 32)
    frame_attention_whole(const FrameParams p) {
  constexpr int kLd = D + kPad;
  constexpr int NS = NT * kBlockN / 8;   // 8-key score tiles
  constexpr int KS = NT * kBlockN / 16;  // 16-key steps of P V
  extern __shared__ __align__(16) __nv_bfloat16 smem[];
  __nv_bfloat16* sK = smem;
  __nv_bfloat16* sV = smem + NT * kBlockN * kLd;

  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = blockIdx.x * kBlockM + warp * 16 + g, row1 = row0 + 8;

  for (int hi = 0; hi < p.head_block; ++hi) {
    const int h = blockIdx.y * p.head_block + hi;
    __syncthreads();  // every warp is done with the previous head's K, V
    stage_rows<D>(sK, sV, p.k + b * p.k_sb + h * p.k_sh,
                  p.v + b * p.v_sb + h * p.v_sh, p, 0, NT * kBlockN);
    uint32_t qf[D / 16][4];
    load_q<D>(qf, p.q + b * p.q_sb + h * p.q_sh, p.q_ss, row0, row1, p.s, t4);
    __syncthreads();

    float s[NS][4];
    scores<D, NS>(s, qf, sK, p.s, p.scale_log2, g, t4);
    float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) {
      m0 = fmaxf(m0, fmaxf(s[nt][0], s[nt][1]));
      m1 = fmaxf(m1, fmaxf(s[nt][2], s[nt][3]));
    }
    m0 = quad_max(m0);  // key 0 is always live: the max is finite
    m1 = quad_max(m1);
    float l0 = 0.f, l1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - m0);
      s[nt][1] = exp2f(s[nt][1] - m0);
      s[nt][2] = exp2f(s[nt][2] - m1);
      s[nt][3] = exp2f(s[nt][3] - m1);
      l0 += s[nt][0] + s[nt][1];
      l1 += s[nt][2] + s[nt][3];
    }
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
    uint32_t pa[KS][4];  // p / l rounded to bf16, as A fragments
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      pa[kk][0] = pack_f32(s[2 * kk][0] / l0, s[2 * kk][1] / l0);
      pa[kk][1] = pack_f32(s[2 * kk][2] / l1, s[2 * kk][3] / l1);
      pa[kk][2] = pack_f32(s[2 * kk + 1][0] / l0, s[2 * kk + 1][1] / l0);
      pa[kk][3] = pack_f32(s[2 * kk + 1][2] / l1, s[2 * kk + 1][3] / l1);
    }
    float acc[D / 8][4];
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
    pv<D, KS>(acc, pa, sV, g, t4);
    store_o<D>(acc, p.o + b * p.o_sb + h * p.o_sh, p.o_ss, row0, row1, p.s,
               t4);
  }
}

// Two passes over 64-key tiles: the row max and sum, then normalized P V.
template <int D>
__global__ void __launch_bounds__(kWarps * 32)
    frame_attention_tiled(const FrameParams p) {
  constexpr int kLd = D + kPad;
  constexpr int NS = kBlockN / 8, KS = kBlockN / 16;
  __shared__ __align__(16) __nv_bfloat16 sK[kBlockN * kLd];
  __shared__ __align__(16) __nv_bfloat16 sV[kBlockN * kLd];

  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = blockIdx.x * kBlockM + warp * 16 + g, row1 = row0 + 8;
  const int n_tiles = (p.s + kBlockN - 1) / kBlockN;

  for (int hi = 0; hi < p.head_block; ++hi) {
    const int h = blockIdx.y * p.head_block + hi;
    const __nv_bfloat16* kb = p.k + b * p.k_sb + h * p.k_sh;
    const __nv_bfloat16* vb = p.v + b * p.v_sb + h * p.v_sh;
    uint32_t qf[D / 16][4];
    load_q<D>(qf, p.q + b * p.q_sb + h * p.q_sh, p.q_ss, row0, row1, p.s, t4);

    // pass 1: the row max m and the row sum l of exp2(s - m)
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    for (int j = 0; j < n_tiles; ++j) {
      __syncthreads();
      stage_rows<D>(sK, nullptr, kb, vb, p, j * kBlockN, kBlockN);
      __syncthreads();
      float s[NS][4];
      scores<D, NS>(s, qf, sK, p.s - j * kBlockN, p.scale_log2, g, t4);
      float t0 = -INFINITY, t1 = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < NS; ++nt) {
        t0 = fmaxf(t0, fmaxf(s[nt][0], s[nt][1]));
        t1 = fmaxf(t1, fmaxf(s[nt][2], s[nt][3]));
      }
      // every tile holds a live key, so the new max is finite
      const float n0 = fmaxf(m0, quad_max(t0)), n1 = fmaxf(m1, quad_max(t1));
      l0 *= exp2f(m0 - n0);
      l1 *= exp2f(m1 - n1);
#pragma unroll
      for (int nt = 0; nt < NS; ++nt) {
        l0 += exp2f(s[nt][0] - n0) + exp2f(s[nt][1] - n0);
        l1 += exp2f(s[nt][2] - n1) + exp2f(s[nt][3] - n1);
      }
      m0 = n0;
      m1 = n1;
    }
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);

    // pass 2: p = exp2(s - m) / l rounded to bf16, acc += p v
    float acc[D / 8][4];
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
    for (int j = 0; j < n_tiles; ++j) {
      __syncthreads();
      stage_rows<D>(sK, sV, kb, vb, p, j * kBlockN, kBlockN);
      __syncthreads();
      float s[NS][4];
      scores<D, NS>(s, qf, sK, p.s - j * kBlockN, p.scale_log2, g, t4);
      uint32_t pa[KS][4];
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        pa[kk][0] = pack_f32(exp2f(s[2 * kk][0] - m0) / l0,
                             exp2f(s[2 * kk][1] - m0) / l0);
        pa[kk][1] = pack_f32(exp2f(s[2 * kk][2] - m1) / l1,
                             exp2f(s[2 * kk][3] - m1) / l1);
        pa[kk][2] = pack_f32(exp2f(s[2 * kk + 1][0] - m0) / l0,
                             exp2f(s[2 * kk + 1][1] - m0) / l0);
        pa[kk][3] = pack_f32(exp2f(s[2 * kk + 1][2] - m1) / l1,
                             exp2f(s[2 * kk + 1][3] - m1) / l1);
      }
      pv<D, KS>(acc, pa, sV, g, t4);
    }
    store_o<D>(acc, p.o + b * p.o_sb + h * p.o_sh, p.o_ss, row0, row1, p.s,
               t4);
  }
}

template <int D, int NT>
int launch_whole(const FrameParams& p, dim3 grid, cudaStream_t stream) {
  constexpr int kBytes = 2 * NT * kBlockN * (D + kPad) * 2;
  static bool opted_in = false;  // above 48 KB needs the opt-in, once
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        frame_attention_whole<D, NT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  frame_attention_whole<D, NT><<<grid, kWarps * 32, kBytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(const FrameParams& p, dim3 grid, cudaStream_t stream) {
  const int tiles = (p.s + kBlockN - 1) / kBlockN;
  if (tiles == 1) return launch_whole<D, 1>(p, grid, stream);
  if (tiles == 2) return launch_whole<D, 2>(p, grid, stream);
  if constexpr (D <= 80) {  // 256 keys of Dh 128 would not fit the registers
    if (tiles <= 4) return launch_whole<D, 4>(p, grid, stream);
  }
  frame_attention_tiled<D><<<grid, kWarps * 32, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q/k/v/o are [B, H, S, D] bf16 with the given element strides (the last
// dimension contiguous); H a multiple of head_block; S <= 1024; D 64, 80 or
// 128. Returns the cudaError_t of the launch.
extern "C" int fvt_frame_attention(
    const void* q, const void* k, const void* v, void* o, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss, int batch, int heads,
    int s, int head_dim, int head_block, float scale, void* stream) {
  if (s < 1 || s > 1024 || head_block < 1 || heads % head_block)
    return static_cast<int>(cudaErrorInvalidValue);
  FrameParams p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.s = s;
  p.head_block = head_block;
  p.scale_log2 = scale * kLog2e;
  const dim3 grid((s + kBlockM - 1) / kBlockM, heads / head_block, batch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64: return launch<64>(p, grid, st);
    case 80: return launch<80>(p, grid, st);
    case 128: return launch<128>(p, grid, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
