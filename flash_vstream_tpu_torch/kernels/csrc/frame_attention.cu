// P2: frame-local attention, a whole-row softmax per (frame, head), for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `kern` (scripts/probe_vit_variants.py:219,
// launched at :237 by the probe's `framekernel` mode): one program per
// (frame, block of heads) computes, for every head of its block,
//   s = q k^T in f32 * 1/sqrt(Dh);  m = max over all S keys;  p = exp(s - m);
//   l = sum p;  p = (p / l) rounded to bf16;  o = p v in f32, stored in q's
//   dtype,
// with no mask and no causality: the ViT's attention inside one frame. It is
// the TPU body's whole-row softmax, not K1's online one. p / l is taken as
// p * (1 / l), and exp as ex2.approx (flushing results below 2^-126 to 0):
// p can land one bf16 step from the division's rounding in rare elements;
// the output stays within one bf16 step of its max from the plain version,
// held to 1e-2 of the max (tests and chip_smoke).
//
// What bounds it on this card (H100 SXM: 989 TFLOP/s bf16, 3.35 TB/s):
//   - 224 px (4 frames x 16 heads x 256 or 64 tokens, Dh 80): the bytes,
//     10.5 MB in and out, 3.1 us, and the launch;
//   - 448 px (S 1,024): the tensor cores, 21.5 GFLOP, 21.7 us for the
//     function, 32.2 GFLOP (32.6 us) with the second Q K^T the two passes
//     make, plus 2 S^2 exponentials per (frame, head) on the SFU (16 a
//     clock an SM: about 35 us at S 1,024).
//
// Design, one block per (q tile, head, frame), 16 query rows a warp:
// 1. Heads on the grid. The TPU's `head_block` (heads per program) does not
//    reach the kernel: the wrapper's `_launch_plan` picks the rows per block
//    (16 to 128) so that every P2 shape of the ViT puts at least 132 blocks
//    on the card, and passes its q tiles in. The output is the same for
//    every head block, bit for bit.
// 2. Fragments by ldmatrix (mma_common.cuh). Q's A fragments, K's B
//    fragments (two 8-key tiles a load) and V's B fragments (.trans, two
//    8-column tiles a load) come from shared memory rows padded by kPad
//    elements: a row stride of D + 8 puts the eight 16-byte rows of every
//    8x8 matrix on distinct banks, so the loads are free of conflicts.
// 3. A cp.async ring. Q, K and V arrive by 16-byte cp.async, rows past S
//    zero-filled by the src-size form (nothing past S is read) and keys past
//    S masked to -inf. In the one-pass kernel (a head's K and V fit: S <= 256
//    at Dh 64 and 80, S <= 128 at Dh 128) each 64-key K tile is its own
//    group, so tile j + 1's copy lands while tile j's scores run, and V's
//    copy, issued before the scores, lands during the softmax; each warp
//    keeps its 16 rows x all keys of scores in registers.
// 4. Above that, two passes over a 3-stage ring of 64-key tiles, tile
//    t + 1's copy overlapping tile t's math: the row max and the sum (the
//    sum rescaled as the max grows), then p = exp(s - m) / l rounded to bf16
//    and p v, pass 2 reading K again beside V. q tiles of 128 rows (8 warps
//    of 16) read each (frame, head)'s K and V 8 times at S 1,024, not 16;
//    128 registers and 90 KB of shared memory put 2 blocks on an SM. It ran
//    0.129-0.132 ms at 448 px on an H100 80GB HBM3 at 700 W, where two
//    measured alternatives ran slower: a head's K kept whole in shared
//    memory for both passes (180 KB, 1 block an SM) 0.169-0.171, and 32
//    rows a warp (half the ldmatrix reads, 238 registers) 0.139 (PERF.md,
//    PR 7). Neither the L2 reads of K nor the shared-memory reads bound it;
//    the two exponentials per score and the second Q K^T are what remain
//    (PERF.md section 7).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace {

using namespace fvt;

constexpr int kBlockN = 64;        // keys per tile
constexpr int kStages = 3;         // the two-pass ring's slots
constexpr int kMaxSmem = 232448;   // the per-block opt-in on Hopper

struct FrameParams {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int s;
  float scale_log2;  // 1/sqrt(Dh) * log2(e): exponentials run as exp2
};

// Keys at or past `valid` (counted from the tile's first) to -inf.
__device__ __forceinline__ void mask_tile(float (&s)[8][4], int valid, int t4) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (nt * 8 + t4 * 2 + (e & 1) >= valid) s[nt][e] = -INFINITY;
  }
}

// p = exp2(s * scale - m * scale) * (1 / l) for one 64-key tile, packed to
// bf16 A fragments (the C layout of two 8-key tiles is one k-step of A).
__device__ __forceinline__ void tile_p(uint32_t (&pa)[4][4],
                                       const float (&s)[8][4],
                                       float sc, float ms0, float ms1,
                                       float r0, float r1) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const float* a = s[2 * kk];
    const float* b = s[2 * kk + 1];
    pa[kk][0] = pack_f32(ex2(fmaf(a[0], sc, -ms0)) * r0,
                         ex2(fmaf(a[1], sc, -ms0)) * r0);
    pa[kk][1] = pack_f32(ex2(fmaf(a[2], sc, -ms1)) * r1,
                         ex2(fmaf(a[3], sc, -ms1)) * r1);
    pa[kk][2] = pack_f32(ex2(fmaf(b[0], sc, -ms0)) * r0,
                         ex2(fmaf(b[1], sc, -ms0)) * r0);
    pa[kk][3] = pack_f32(ex2(fmaf(b[2], sc, -ms1)) * r1,
                         ex2(fmaf(b[3], sc, -ms1)) * r1);
  }
}

// cp.async.wait_group takes an immediate: n is a constant once the caller's
// loop is unrolled.
__device__ __forceinline__ void cp_async_wait_upto4(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    default: cp_async_wait<4>(); break;
  }
}

// One pass: a head's K and V whole in shared memory (NT tiles of 64 keys),
// the warp's 16 rows x NT * 64 keys of scores in registers. Shared memory:
// Q [rows][D + kPad], K and V [NT * 64][D + kPad].
template <int D, int NT>
__global__ void __launch_bounds__(128)
    frame_attention_whole(const FrameParams p) {
  constexpr int kLd = D + kPad;
  extern __shared__ __align__(16) __nv_bfloat16 smem[];
  const int rows = blockDim.x / 2;  // 16 per warp
  __nv_bfloat16* sQ = smem;
  __nv_bfloat16* sK = sQ + rows * kLd;
  __nv_bfloat16* sV = sK + NT * kBlockN * kLd;

  const int b = blockIdx.z, h = blockIdx.y, r0 = blockIdx.x * rows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t4 = lane & 3;
  const __nv_bfloat16* kb = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + h * p.v_sh;

  // groups: Q and K tile 0, K tiles 1 .. NT-1, then V
  copy_rows<D>(sQ, p.q + b * p.q_sb + h * p.q_sh, p.q_ss, r0, rows, p.s);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    copy_rows<D>(sK + j * kBlockN * kLd, kb, p.k_ss, j * kBlockN, kBlockN,
                 p.s);
    cp_async_commit();
  }
  copy_rows<D>(sV, vb, p.v_ss, 0, NT * kBlockN, p.s);
  cp_async_commit();

  uint32_t qf[D / 16][4];
  float s[NT][8][4];
  const int koff = lane_off_b<D>(lane);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    cp_async_wait_upto4(NT - j);  // Q and K tiles 0 .. j have landed
    __syncthreads();
    if (j == 0) load_q<D>(qf, sQ + warp * 16 * kLd, lane_off_a<D>(lane));
    tile_scores<D>(s[j], qf, sK + j * kBlockN * kLd, koff);
    if ((j + 1) * kBlockN > p.s) mask_tile(s[j], p.s - j * kBlockN, t4);
  }

  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      m0 = fmaxf(m0, fmaxf(s[j][n][0], s[j][n][1]));
      m1 = fmaxf(m1, fmaxf(s[j][n][2], s[j][n][3]));
    }
  }
  // key 0 is always live: the max is finite
  const float ms0 = quad_max(m0) * p.scale_log2;
  const float ms1 = quad_max(m1) * p.scale_log2;
  float l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float* e = s[j][n];
      e[0] = ex2(fmaf(e[0], p.scale_log2, -ms0));
      e[1] = ex2(fmaf(e[1], p.scale_log2, -ms0));
      e[2] = ex2(fmaf(e[2], p.scale_log2, -ms1));
      e[3] = ex2(fmaf(e[3], p.scale_log2, -ms1));
      l0 += e[0] + e[1];
      l1 += e[2] + e[3];
    }
  }
  const float r0l = 1.f / quad_sum(l0), r1l = 1.f / quad_sum(l1);
  uint32_t pa[NT][4][4];  // p / l rounded to bf16, as A fragments
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* a = s[j][2 * kk];
      const float* c = s[j][2 * kk + 1];
      pa[j][kk][0] = pack_f32(a[0] * r0l, a[1] * r0l);
      pa[j][kk][1] = pack_f32(a[2] * r1l, a[3] * r1l);
      pa[j][kk][2] = pack_f32(c[0] * r0l, c[1] * r0l);
      pa[j][kk][3] = pack_f32(c[2] * r1l, c[3] * r1l);
    }
  }

  cp_async_wait<0>();  // V has landed
  __syncthreads();
  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  const int voff = lane_off_a<D>(lane);
#pragma unroll
  for (int j = 0; j < NT; ++j)
    tile_pv<D>(acc, pa[j], sV + j * kBlockN * kLd, voff);
  store_o<D>(acc, sQ + warp * 16 * kLd, p.o + b * p.o_sb + h * p.o_sh, p.o_ss,
             r0 + warp * 16, p.s, lane);
}

// Two passes over 64-key tiles: the row max and sum, then p v. Load item t
// of the sequence is K tile t (pass 1, t < nt), then K and V tile t - nt
// (pass 2); item t sits in ring slot t % kStages. Shared memory: Q
// [rows][D + kPad], K and V [kStages * 64][D + kPad] each.
template <int D>
__global__ void __launch_bounds__(256, D > 80 ? 1 : 2)
    frame_attention_tiled(const FrameParams p) {
  constexpr int kLd = D + kPad;
  extern __shared__ __align__(16) __nv_bfloat16 smem[];
  const int rows = blockDim.x / 2;  // 16 per warp
  const int nt = (p.s + kBlockN - 1) / kBlockN;
  __nv_bfloat16* sQ = smem;
  __nv_bfloat16* sK = sQ + rows * kLd;
  __nv_bfloat16* sV = sK + kStages * kBlockN * kLd;

  const int b = blockIdx.z, h = blockIdx.y, r0 = blockIdx.x * rows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t4 = lane & 3;
  const __nv_bfloat16* kb = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + h * p.v_sh;
  __nv_bfloat16* sW = sQ + warp * 16 * kLd;  // this warp's Q rows

  // issue item t and close its group (an empty group past the end keeps
  // the count of groups in flight the same at every step)
  auto issue = [&](int t) {
    const int j = t < nt ? t : t - nt, slot = t % kStages;
    if (t < 2 * nt)
      copy_rows<D>(sK + slot * kBlockN * kLd, kb, p.k_ss, j * kBlockN,
                   kBlockN, p.s);
    if (t >= nt && t < 2 * nt)
      copy_rows<D>(sV + slot * kBlockN * kLd, vb, p.v_ss, j * kBlockN,
                   kBlockN, p.s);
    cp_async_commit();
  };
  copy_rows<D>(sQ, p.q + b * p.q_sb + h * p.q_sh, p.q_ss, r0, rows, p.s);
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) issue(t);

  uint32_t qf[D / 16][4];
  const int koff = lane_off_b<D>(lane), voff = lane_off_a<D>(lane);
  // rows g and g + 8's max, sum, scaled max, 1 / sum
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float ms0 = 0.f, ms1 = 0.f, rl0 = 0.f, rl1 = 0.f;
  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

  for (int t = 0; t < 2 * nt; ++t) {
    cp_async_wait<kStages - 2>();  // item t has landed
    __syncthreads();               // ... for every thread; item t - 1 is done
    issue(t + kStages - 1);        // into item t - 1's slot
    if (t == 0) load_q<D>(qf, sW, lane_off_a<D>(lane));
    const int j = t < nt ? t : t - nt;
    float s[8][4];
    tile_scores<D>(s, qf, sK + (t % kStages) * kBlockN * kLd, koff);
    if ((j + 1) * kBlockN > p.s) mask_tile(s, p.s - j * kBlockN, t4);
    if (t < nt) {
      // pass 1: the row max m and the row sum l of exp2((s - m) * scale)
      float t0 = -INFINITY, t1 = -INFINITY;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        t0 = fmaxf(t0, fmaxf(s[n][0], s[n][1]));
        t1 = fmaxf(t1, fmaxf(s[n][2], s[n][3]));
      }
      // every tile holds a live key, so the new max is finite
      const float n0 = fmaxf(m0, quad_max(t0)), n1 = fmaxf(m1, quad_max(t1));
      const float ns0 = n0 * p.scale_log2, ns1 = n1 * p.scale_log2;
      l0 *= ex2((m0 - n0) * p.scale_log2);
      l1 *= ex2((m1 - n1) * p.scale_log2);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        l0 += ex2(fmaf(s[n][0], p.scale_log2, -ns0)) +
              ex2(fmaf(s[n][1], p.scale_log2, -ns0));
        l1 += ex2(fmaf(s[n][2], p.scale_log2, -ns1)) +
              ex2(fmaf(s[n][3], p.scale_log2, -ns1));
      }
      m0 = n0;
      m1 = n1;
    } else {
      // pass 2: p = exp2((s - m) * scale) / l rounded to bf16, acc += p v
      if (t == nt) {
        ms0 = m0 * p.scale_log2;
        ms1 = m1 * p.scale_log2;
        rl0 = 1.f / quad_sum(l0);
        rl1 = 1.f / quad_sum(l1);
      }
      uint32_t pa[4][4];
      tile_p(pa, s, p.scale_log2, ms0, ms1, rl0, rl1);
      tile_pv<D>(acc, pa, sV + (t % kStages) * kBlockN * kLd, voff);
    }
  }
  store_o<D>(acc, sW, p.o + b * p.o_sb + h * p.o_sh, p.o_ss, r0 + warp * 16,
             p.s, lane);
}

// Raises the kernel's dynamic shared-memory cap to the opt-in once; the
// launch's own size decides the occupancy.
template <typename Kernel>
int opt_in(Kernel kernel, bool& done) {
  if (done) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  done = true;
  return 0;
}

template <int D, int NT>
int launch_whole(const FrameParams& p, dim3 grid, int threads, int smem,
                 cudaStream_t stream) {
  static bool opted_in = false;
  if (const int err = opt_in(frame_attention_whole<D, NT>, opted_in))
    return err;
  frame_attention_whole<D, NT><<<grid, threads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_tiled(const FrameParams& p, dim3 grid, int threads, int smem,
                 cudaStream_t stream) {
  static bool opted_in = false;
  if (const int err = opt_in(frame_attention_tiled<D>, opted_in)) return err;
  frame_attention_tiled<D><<<grid, threads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Shared bytes a launch needs (the wrapper's `_launch_plan` passes the same
// number, which the entry checks), or -1 for a variant that does not take
// this head dim or length.
int smem_needed(int variant, int rows, int s, int d) {
  const int ld = d + kPad, nt = (s + kBlockN - 1) / kBlockN;
  switch (variant) {
    case 1: case 2: case 4:
      if (variant > (d <= 80 ? 4 : 2) || nt > variant) return -1;
      return 2 * ld * (rows + 2 * variant * kBlockN);
    case 0: return 2 * ld * (rows + 2 * kStages * kBlockN);
    default: return -1;
  }
}

template <int D>
int launch(const FrameParams& p, dim3 grid, int threads, int variant, int smem,
           cudaStream_t st) {
  switch (variant) {
    case 1: return launch_whole<D, 1>(p, grid, threads, smem, st);
    case 2: return launch_whole<D, 2>(p, grid, threads, smem, st);
    case 4:
      if constexpr (D <= 80)
        return launch_whole<D, 4>(p, grid, threads, smem, st);
      break;
    case 0: return launch_tiled<D>(p, grid, threads, smem, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q/k/v/o are [B, H, S, D] bf16 with the given element strides (the last
// dimension contiguous); S <= 1024; D 64, 80 or 128. The rest of the launch
// comes from the wrapper's plan (`_launch_plan`): q tiles (the grid is (q
// tiles, H, B)), threads (32 a warp, a warp taking 16 query rows), the
// variant (1, 2, 4: one pass over that many 64-key tiles; 0: two passes
// through a 3-stage ring) and its shared bytes. A plan whose q tiles do not
// cover S once, or whose shared bytes are not what the variant needs, is
// refused. Returns the cudaError_t of the launch.
extern "C" int fvt_frame_attention(
    const void* q, const void* k, const void* v, void* o, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss, int batch, int heads,
    int s, int head_dim, int q_tiles, int threads, int variant,
    int smem_bytes, float scale, void* stream) {
  const int rows = threads / 2;
  const int need = smem_needed(variant, rows, s, head_dim);
  if (batch < 1 || heads < 1 || s < 1 || s > 1024 || threads % 32 ||
      threads < 32 || threads > (variant > 0 ? 128 : 256) || q_tiles < 1 ||
      static_cast<long long>(q_tiles) * rows < s ||
      (q_tiles - 1) * rows >= s || need < 0 || smem_bytes != need ||
      smem_bytes > kMaxSmem)
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
  p.scale_log2 = scale * kLog2e;
  const dim3 grid(q_tiles, heads, batch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64: return launch<64>(p, grid, threads, variant, smem_bytes, st);
    case 80: return launch<80>(p, grid, threads, variant, smem_bytes, st);
    case 128: return launch<128>(p, grid, threads, variant, smem_bytes, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
