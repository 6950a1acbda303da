// K4 and K5: the flash-attention backward for Hopper (sm_90a).
//
// K4 replaces the Pallas TPU kernel `_flash_bwd_dq_kernel`
// (flash_vstream_tpu/kernels/flash_attention.py:285, launched at :407) and K5
// replaces `_flash_bwd_dkv_kernel` (:332, launched at :435). Same function:
// given q, k, v, the forward output o, its cotangent do and the per-row
// logsumexp of K3, recompute p = exp(s * scale - lse) blockwise (0 where lse
// is -inf, a row that saw no key, or where the causal/segment mask hides the
// pair), then
//   delta = rowsum(do * o),   dp = do v^T,   ds = p (dp - delta) scale,
//   dq = ds k,   dk = ds^T q,   dv = p^T do,
// with bf16 tensor-core products, f32 accumulation and bf16 outputs; p and ds
// are rounded to bf16 before their products, as the TPU kernels round them to
// the operand dtype. A padded query (segment -1) gets a zero dq row and a key
// that no query sees zero dk/dv rows, exactly.
//
// What bounds it on this card (H100 SXM: 989 TFLOP/s bf16, 3.35 TB/s). At
// the training shape (q [1, 28, 4096, 128], causal) the tensor cores: K4
// does 3 products per visible (q, k) pair (Q K^T, dO V^T, dS K), 155 GFLOP
// and 0.157 ms by its bound, K5 four (K Q^T, V dO^T, P^T dO, dS^T Q), 207
// GFLOP and 0.209 ms. In fact (PERF.md, scripts/probe_flash_bwd.py's
// ablations) mostly each warp's chain of products and their ldmatrix loads
// (inferred, as for K1): both run at 213-219 TF/s, as K3 does on the same
// form. Taking the tile copies out saves 7-9% at 64 rows a block and
// nothing past the 1% spread at 128; the exponentials 0-3%.
//
// Design, on `mma.sync.m16n8k16` bf16 with f32 sums in registers
// (mma_common.cuh), the pieces K1/K3 measured (flash_attention.cu):
// 1. Both kernels: 16 rows a warp, 64 or 128 rows a block (4 or 8 warps),
//    the wrapper's `_bwd_launch_plan` choosing (64 ran 1-5% faster at S
//    4,096, 128 3.5-5% faster at S 14,000); the C entries build the grid
//    (tiles x Hq, B) and refuse rows or shared bytes other than their own.
//    Every output row has one writer and fixed-order sums: no atomics, the
//    same bits from run to run and at either rows per block.
// 2. A cp.async ring of 64-row tiles (`TileCopy`), one commit group and one
//    barrier a tile: K4's K/V tiles with their kv ids (3 slots), K5's Q/dO
//    tiles with their lse, delta and q ids (2 slots, so that two 64-row
//    blocks share an SM). The math of a tile runs in steps of kSub rows (32
//    at D 128, 64 below) to keep the accumulators in registers.
// 3. Fragments by ldmatrix: K4 takes K's and V's B fragments of Q K^T and
//    dO V^T by `ldmatrix.x4` and K's of dS K by `ldmatrix.x4.trans`; K5 takes
//    K's and V's A fragments and Q's and dO's B fragments of K Q^T and V dO^T
//    by `ldmatrix.x4`, and dO's and Q's of P^T dO and dS^T Q by
//    `ldmatrix.x4.trans`. p and ds stay in registers, packed to bf16, as the
//    A operand of the next product. Rows padded by kPad: no bank conflicts.
// 4. Tile cases (`classify_tile`, K1's): each (warp, tile) is skip, full
//    (no per-element test) or masked, from the tile's id range, the warp's
//    and the causal position. A skipped tile adds nothing, which is what a
//    masked tile with no visible pair adds (+0), so no case changes a bit.
// 5. p = ex2(s * scale log2(e) - lse log2(e)): one FFMA and one MUFU; lse is
//    taken to the log2 domain once per row, a row with lse -inf to +inf (p
//    is then 0 everywhere).
// - K4: one block per (q tile, q head, batch), heaviest q tiles first
//   (blockIdx.x walks them from the last, heads fastest), the K/V tiles
//   before the block's last row. Q and dO come once into registers as A
//   fragments; delta is computed once per row from dO and O and written for
//   K5 (the TPU kernels recompute it for every tile pair). dq leaves through
//   the ring's shared memory in 16-byte stores.
// - K5: one block per (kv tile, q head, batch), split over the GQA group:
//   K and V stay in shared memory for the block, which walks the q tiles
//   from its diagonal (causal) to the end; blockIdx.x walks kv tiles from
//   the first (the heaviest under causality), heads fastest. S^T = K Q^T
//   puts the kv rows on the fragment rows, so p^T and ds^T are the A
//   operands of dV += p^T dO and dK += ds^T Q. With a group of g > 1 q heads
//   a kv head, each block writes its f32 partial dk and dv to the scratch
//   [2, B, Hq, Skv, D] and a second launch, part of K5, sums each kv head's
//   g partials in head order and writes bf16; at g 1 the first pass writes
//   bf16 and the second is not launched.
//
// Registers and spills (ptxas -v, CUDA 12.8, sm_90a): dq<128> / <80> / <64>
// 237 / 212 / 188, dkv 245 / 243 / 233, no spills. K5's sub-step loop is
// not unrolled: unrolled, dkv<128> needs 255 registers and spills (2-3%
// faster; `unroll_dkv` in the probe); 16-row sub-steps ran 10% slower.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace {

using namespace fvt;

constexpr int kMaxRows = 128;     // rows per block: 8 warps of 16
constexpr int kStagesDq = 3;      // slots of K4's K/V ring
constexpr int kStagesDkv = 2;     // slots of K5's Q/dO ring
constexpr int kMaxSmem = 232448;  // the per-block opt-in on Hopper

struct BwdParams {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* o;
  const __nv_bfloat16* dout;
  const float* lse;     // [B, Hq, Sq]
  float* delta;         // [B, Hq, Sq]: written by K4, read by K5
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  float* part;          // K5's f32 partials [2, B, Hq, Skv, D], or null (g 1)
  const int* q_seg;     // [B, Sq] or null
  const int* kv_seg;    // [B, Skv] or null
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  long long do_sb, do_sh, do_ss;
  long long dq_sb, dq_sh, dq_ss;
  long long dk_sb, dk_sh, dk_ss;
  long long dv_sb, dv_sh, dv_ss;
  int batch, hq, sq, skv, group, causal;
  float scale, scale_log2;
};

// Shared bytes of K4 (any rows): kStagesDq slots of K and V [64][d + kPad]
// bf16 and of 64 kv ids.
int dq_smem_bytes(int d) {
  return 2 * (d + kPad) * 2 * kStagesDq * kTileRows +
         4 * kStagesDq * kTileRows;
}

// Shared bytes of K5 at `rows` kv rows: K and V [rows][d + kPad] bf16, then
// kStagesDkv slots of Q and dO [64][d + kPad] bf16 and of 64 lse, delta and
// q ids.
int dkv_smem_bytes(int rows, int d) {
  return 2 * (d + kPad) * (2 * rows + 2 * kStagesDkv * kTileRows) +
         12 * kStagesDkv * kTileRows;
}

// lse in the log2 domain; -inf (a row that sees no key) becomes +inf, so
// that p = ex2(s c - l) is 0 for every key
__device__ __forceinline__ float lse_log2(float l) {
  return l == -INFINITY ? INFINITY : l * kLog2e;
}

// ---------------------------------------------------------------------------
// K4: dq (and delta)
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(2 * kMaxRows, 1)
    flash_bwd_dq_kernel(const BwdParams p) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int kLd = D + kPad;
  constexpr int kTile = kTileRows * kLd;  // elements of one K or V slot
  constexpr int kSteps = D / 16;          // k-steps over the head dim
  constexpr int kSub = D > 80 ? 32 : 64;  // keys per step of the math
  extern __shared__ __align__(16) __nv_bfloat16 smem[];
  __nv_bfloat16* sK = smem;
  __nv_bfloat16* sV = sK + kStagesDq * kTile;
  int* sSeg = reinterpret_cast<int*>(sV + kStagesDq * kTile);

  // heaviest first: the q tiles from the last to the first, heads fastest
  const int rows = blockDim.x / 2;
  const int n_qt = (p.sq + rows - 1) / rows;
  const int h = blockIdx.x % p.hq, b = blockIdx.y, hk = h / p.group;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x) / p.hq) * rows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int w0 = q0 + warp * 16;            // the warp's first row
  const int w1 = min(w0 + 15, p.sq - 1);    // ... and its last below Sq
  const int row0 = w0 + g, row1 = row0 + 8;
  const bool in0 = row0 < p.sq, in1 = row1 < p.sq;

  const __nv_bfloat16* kb = p.k + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + hk * p.v_sh;
  const bool seg = p.kv_seg != nullptr;
  const int* kvs = seg ? p.kv_seg + static_cast<long long>(b) * p.skv
                       : nullptr;

  int n_tiles = (p.skv + kTileRows - 1) / kTileRows;
  if (p.causal)
    n_tiles = min(n_tiles, (min(q0 + rows, p.sq) - 1) / kTileRows + 1);

  // K and V tile j with its kv ids into slot j % kStagesDq, then a commit:
  // one group per tile (an empty group past the last keeps the count of
  // groups in flight the same at every step)
  const TileCopy<D> copy;
  auto issue = [&](int j) {
    const int slot = j % kStagesDq, kv0 = j * kTileRows;
    if (j < n_tiles) {
      copy(sK + slot * kTile, kb + kv0 * p.k_ss, p.k_ss, p.skv - kv0);
      copy(sV + slot * kTile, vb + kv0 * p.v_ss, p.v_ss, p.skv - kv0);
      if (seg) {
        for (int i = threadIdx.x; i < kTileRows; i += blockDim.x) {
          const bool live = kv0 + i < p.skv;
          cp_async_4(sSeg + slot * kTileRows + i, live ? kvs + kv0 + i : kvs,
                     live ? 4 : 0);
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int j = 0; j < kStagesDq - 1; ++j) issue(j);

  // Q and dO as A fragments for the whole kv loop, read once from global
  // memory; delta from dO and O at the same fragment positions, summed over
  // the quad that shares a row
  const __nv_bfloat16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* ob = p.o + b * p.o_sb + h * p.o_sh;
  const __nv_bfloat16* db = p.dout + b * p.do_sb + h * p.do_sh;
  uint32_t qf[kSteps][4], df[kSteps][4];
  float dl0 = 0.f, dl1 = 0.f;
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    const int c = kk * 16 + t4 * 2;
    qf[kk][0] = in0 ? ld32(qb + row0 * p.q_ss + c) : 0u;
    qf[kk][1] = in1 ? ld32(qb + row1 * p.q_ss + c) : 0u;
    qf[kk][2] = in0 ? ld32(qb + row0 * p.q_ss + c + 8) : 0u;
    qf[kk][3] = in1 ? ld32(qb + row1 * p.q_ss + c + 8) : 0u;
    df[kk][0] = in0 ? ld32(db + row0 * p.do_ss + c) : 0u;
    df[kk][1] = in1 ? ld32(db + row1 * p.do_ss + c) : 0u;
    df[kk][2] = in0 ? ld32(db + row0 * p.do_ss + c + 8) : 0u;
    df[kk][3] = in1 ? ld32(db + row1 * p.do_ss + c + 8) : 0u;
    if (in0) {
      const float2 d0 = unpack_f32(df[kk][0]), d2 = unpack_f32(df[kk][2]);
      const float2 o0 = unpack_f32(ld32(ob + row0 * p.o_ss + c));
      const float2 o2 = unpack_f32(ld32(ob + row0 * p.o_ss + c + 8));
      dl0 += d0.x * o0.x + d0.y * o0.y + d2.x * o2.x + d2.y * o2.y;
    }
    if (in1) {
      const float2 d1 = unpack_f32(df[kk][1]), d3 = unpack_f32(df[kk][3]);
      const float2 o1 = unpack_f32(ld32(ob + row1 * p.o_ss + c));
      const float2 o3 = unpack_f32(ld32(ob + row1 * p.o_ss + c + 8));
      dl1 += d1.x * o1.x + d1.y * o1.y + d3.x * o3.x + d3.y * o3.y;
    }
  }
  const float delta0 = quad_sum(dl0), delta1 = quad_sum(dl1);
  const long long stat = (static_cast<long long>(b) * p.hq + h) * p.sq;
  if (t4 == 0) {
    if (in0) p.delta[stat + row0] = delta0;
    if (in1) p.delta[stat + row1] = delta1;
  }
  // a row past Sq gets +inf as well: its p is 0
  const float l0 = in0 ? lse_log2(p.lse[stat + row0]) : INFINITY;
  const float l1 = in1 ? lse_log2(p.lse[stat + row1]) : INFINITY;

  // this thread's rows' segment ids, and the id range of the warp's rows
  int seg0 = 0, seg1 = 0, qmin = 0, qmax = 0;
  if (seg) {
    const int* qs = p.q_seg + static_cast<long long>(b) * p.sq;
    seg0 = in0 ? qs[row0] : 0;
    seg1 = in1 ? qs[row1] : 0;
    const int r = w0 + (lane & 15);
    const int id = r < p.sq ? qs[r] : 0;
    qmin = __reduce_min_sync(0xffffffffu, r < p.sq ? id : INT_MAX);
    qmax = __reduce_max_sync(0xffffffffu, r < p.sq ? id : INT_MIN);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  const float c = p.scale_log2;
  const int koff = lane_off_b<D>(lane), aoff = lane_off_a<D>(lane);

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<kStagesDq - 2>();  // tile j has landed ...
    __syncthreads();  // ... for every thread; j - 1 is done with
    issue(j + kStagesDq - 1);        // into tile j - 1's slot
    const int slot = j % kStagesDq;
    const TileCase t = classify_tile(
        slot, j * kTileRows, p.skv, w0, w1, w0 < p.sq, p.causal, true,
        seg ? sSeg + slot * kTileRows : nullptr, qmin, qmax, lane);
    if (t.skip) continue;
    const __nv_bfloat16* tk = sK + slot * kTile;
    const __nv_bfloat16* tv = sV + slot * kTile;
    const int* ts = sSeg + slot * kTileRows;
#pragma unroll
    for (int sub = 0; sub < kTileRows; sub += kSub) {
      // S = Q K^T and dP = dO V^T: the warp's 16 rows x kSub keys
      float s[kSub / 8][4], dp[kSub / 8][4];
#pragma unroll
      for (int nt = 0; nt < kSub / 8; ++nt) {
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
        dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
#pragma unroll
        for (int np = 0; np < kSub / 16; ++np) {
          const int off = (sub + np * 16) * kLd + kk * 16 + koff;
          uint32_t bk[4], bv[4];
          ldmatrix_x4(bk, tk + off);
          ldmatrix_x4(bv, tv + off);
          mma_16816(s[2 * np], qf[kk], bk);
          mma_16816(s[2 * np + 1], qf[kk], bk + 2);
          mma_16816(dp[2 * np], df[kk], bv);
          mma_16816(dp[2 * np + 1], df[kk], bv + 2);
        }
      }
      // p from the saved lse, masked where the tile needs it; then
      // ds = p (dp - delta) scale, rounded to bf16 as the A operand of dS K
      uint32_t da[kSub / 16][4];
#pragma unroll
      for (int nt = 0; nt < kSub / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool top = e < 2;
          float pr = ex2(fmaf(s[nt][e], c, -(top ? l0 : l1)));
          if (!t.full) {
            const int cl = sub + nt * 8 + t4 * 2 + (e & 1);
            bool vis = cl < t.nv;
            if (seg) {
              const int ks = ts[cl];
              vis = vis && ks >= 0 && ks == (top ? seg0 : seg1);
            }
            if (p.causal) vis = vis && t.t0 + cl <= (top ? row0 : row1);
            if (!vis) pr = 0.f;
          }
          s[nt][e] = pr * (dp[nt][e] - (top ? delta0 : delta1)) * p.scale;
        }
        da[nt / 2][(nt & 1) * 2] = pack_f32(s[nt][0], s[nt][1]);
        da[nt / 2][(nt & 1) * 2 + 1] = pack_f32(s[nt][2], s[nt][3]);
      }
      // dQ += dS K: K's rows are the k dimension, so its B fragments come
      // transposed
#pragma unroll
      for (int kk = 0; kk < kSub / 16; ++kk) {
#pragma unroll
        for (int dp2 = 0; dp2 < D / 16; ++dp2) {
          uint32_t bf[4];
          ldmatrix_x4_trans(bf, tk + (sub + kk * 16) * kLd + dp2 * 16 + aoff);
          mma_16816(acc[2 * dp2], da[kk], bf);
          mma_16816(acc[2 * dp2 + 1], da[kk], bf + 2);
        }
      }
    }
  }

  // the ring is free once every warp is done: the warp's rows of it stage
  // its dq rows (128 rows fit in slots 0 and 1 of K)
  cp_async_wait<0>();
  __syncthreads();
  store_o<D>(acc, sK + warp * 16 * kLd, p.dq + b * p.dq_sb + h * p.dq_sh,
             p.dq_ss, w0, p.sq, lane);
}

// ---------------------------------------------------------------------------
// K5: dk, dv
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(2 * kMaxRows, 1)
    flash_bwd_dkv_kernel(const BwdParams p) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int kLd = D + kPad;
  constexpr int kTile = kTileRows * kLd;  // elements of one Q or dO slot
  constexpr int kSteps = D / 16;          // k-steps over the head dim
  constexpr int kSub = D > 80 ? 32 : 64;  // q rows per step of the math
  extern __shared__ __align__(16) __nv_bfloat16 smem[];
  const int rows = blockDim.x / 2;
  __nv_bfloat16* sK = smem;                 // [rows][kLd]
  __nv_bfloat16* sV = sK + rows * kLd;      // [rows][kLd]
  __nv_bfloat16* sQ = sV + rows * kLd;      // kStagesDkv slots
  __nv_bfloat16* sD = sQ + kStagesDkv * kTile;
  float* sL = reinterpret_cast<float*>(sD + kStagesDkv * kTile);  // lse
  float* sDl = sL + kStagesDkv * kTileRows;                       // delta
  int* sSeg = reinterpret_cast<int*>(sDl + kStagesDkv * kTileRows);

  // heaviest first: the kv tiles from the first (under causality the one
  // every q tile sees) to the last, heads fastest
  const int h = blockIdx.x % p.hq, b = blockIdx.y, hk = h / p.group;
  const int kv0 = (static_cast<int>(blockIdx.x) / p.hq) * rows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int w0 = kv0 + warp * 16;           // the warp's first kv row
  const int w1 = min(w0 + 15, p.skv - 1);   // ... and its last below Skv
  const int r0 = w0 + g, r1 = r0 + 8;       // this thread's kv rows

  const __nv_bfloat16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* db = p.dout + b * p.do_sb + h * p.do_sh;
  const long long stat = (static_cast<long long>(b) * p.hq + h) * p.sq;
  const bool seg = p.q_seg != nullptr;
  const int* qs = seg ? p.q_seg + static_cast<long long>(b) * p.sq : nullptr;

  // q tiles of 64 rows; under causality those before the block's first kv
  // row see none of its keys
  const int n_q = (p.sq + kTileRows - 1) / kTileRows;
  const int first = p.causal ? kv0 / kTileRows : 0;

  // Q and dO tile first + i with its lse, delta and q ids into slot
  // i % kStagesDkv, then a commit (empty past the last tile)
  const TileCopy<D> copy;
  auto issue = [&](int i) {
    const int slot = i % kStagesDkv, q0 = (first + i) * kTileRows;
    if (first + i < n_q) {
      copy(sQ + slot * kTile, qb + q0 * p.q_ss, p.q_ss, p.sq - q0);
      copy(sD + slot * kTile, db + q0 * p.do_ss, p.do_ss, p.sq - q0);
      for (int x = threadIdx.x; x < 3 * kTileRows; x += blockDim.x) {
        const int which = x / kTileRows, r = x % kTileRows;
        const bool live = q0 + r < p.sq;
        const long long at = stat + q0 + r;
        if (which == 0)
          cp_async_4(sL + slot * kTileRows + r, live ? p.lse + at : p.lse,
                     live ? 4 : 0);
        else if (which == 1)
          cp_async_4(sDl + slot * kTileRows + r,
                     live ? p.delta + at : p.delta, live ? 4 : 0);
        else if (seg)
          cp_async_4(sSeg + slot * kTileRows + r, live ? qs + q0 + r : qs,
                     live ? 4 : 0);
      }
    }
    cp_async_commit();
  };
  copy_rows<D>(sK, p.k + b * p.k_sb + hk * p.k_sh, p.k_ss, kv0, rows, p.skv);
  copy_rows<D>(sV, p.v + b * p.v_sb + hk * p.v_sh, p.v_ss, kv0, rows, p.skv);
#pragma unroll
  for (int i = 0; i < kStagesDkv - 1; ++i) issue(i);  // K/V join tile 0's

  // this thread's kv rows' ids, and the id range of the warp's kv rows
  int kseg0 = 0, kseg1 = 0, kmin = 0, kmax = 0;
  if (seg) {
    const int* ks = p.kv_seg + static_cast<long long>(b) * p.skv;
    kseg0 = r0 < p.skv ? ks[r0] : -1;
    kseg1 = r1 < p.skv ? ks[r1] : -1;
    const int r = w0 + (lane & 15);
    const int id = r < p.skv ? ks[r] : 0;
    kmin = __reduce_min_sync(0xffffffffu, r < p.skv ? id : INT_MAX);
    kmax = __reduce_max_sync(0xffffffffu, r < p.skv ? id : INT_MIN);
  }

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    dk[dt][0] = dk[dt][1] = dk[dt][2] = dk[dt][3] = 0.f;
    dv[dt][0] = dv[dt][1] = dv[dt][2] = dv[dt][3] = 0.f;
  }
  const float c = p.scale_log2;
  const int koff = lane_off_b<D>(lane), aoff = lane_off_a<D>(lane);
  const __nv_bfloat16* wk = sK + warp * 16 * kLd;  // the warp's K and V rows
  const __nv_bfloat16* wv = sV + warp * 16 * kLd;

  for (int i = 0; first + i < n_q; ++i) {
    cp_async_wait<kStagesDkv - 2>();  // tile i (and K/V) has landed ...
    __syncthreads();  // ... for every thread; i - 1 is done with
    issue(i + kStagesDkv - 1);        // into tile i - 1's slot
    const int slot = i % kStagesDkv;
    const TileCase t = classify_tile(
        slot, (first + i) * kTileRows, p.sq, w0, w1, w0 < p.skv, p.causal,
        false, seg ? sSeg + slot * kTileRows : nullptr, kmin, kmax, lane);
    if (t.skip) continue;
    const __nv_bfloat16* tq = sQ + slot * kTile;
    const __nv_bfloat16* td = sD + slot * kTile;
    const float* tl = sL + slot * kTileRows;
    const float* tdl = sDl + slot * kTileRows;
    const int* ts = sSeg + slot * kTileRows;
#pragma unroll 1
    for (int sub = 0; sub < kTileRows; sub += kSub) {
      // S^T = K Q^T and dP^T = V dO^T: the warp's 16 kv rows x kSub q rows
      float st[kSub / 8][4], dpt[kSub / 8][4];
#pragma unroll
      for (int nt = 0; nt < kSub / 8; ++nt) {
        st[nt][0] = st[nt][1] = st[nt][2] = st[nt][3] = 0.f;
        dpt[nt][0] = dpt[nt][1] = dpt[nt][2] = dpt[nt][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        uint32_t ka[4], va[4];
        ldmatrix_x4(ka, wk + kk * 16 + aoff);
        ldmatrix_x4(va, wv + kk * 16 + aoff);
#pragma unroll
        for (int np = 0; np < kSub / 16; ++np) {
          const int off = (sub + np * 16) * kLd + kk * 16 + koff;
          uint32_t bq[4], bd[4];
          ldmatrix_x4(bq, tq + off);
          ldmatrix_x4(bd, td + off);
          mma_16816(st[2 * np], ka, bq);
          mma_16816(st[2 * np + 1], ka, bq + 2);
          mma_16816(dpt[2 * np], va, bd);
          mma_16816(dpt[2 * np + 1], va, bd + 2);
        }
      }
      // p^T from the saved lse, masked where the tile needs it, and
      // ds^T = p^T (dp^T - delta) scale, both rounded to bf16 as A operands
      uint32_t pa[kSub / 16][4], da[kSub / 16][4];
#pragma unroll
      for (int nt = 0; nt < kSub / 8; ++nt) {
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int cl = sub + nt * 8 + t4 * 2 + x;   // the q row in the tile
          const float l = lse_log2(tl[cl]), dl = tdl[cl];
          int qid = 0;
          if (seg && !t.full) qid = ts[cl];
#pragma unroll
          for (int y = 0; y < 2; ++y) {               // kv rows r0, r1
            const int e = 2 * y + x;
            float pr = ex2(fmaf(st[nt][e], c, -l));
            if (!t.full) {
              bool vis = cl < t.nv;
              if (seg) vis = vis && qid >= 0 && qid == (y ? kseg1 : kseg0);
              if (p.causal) vis = vis && (y ? r1 : r0) <= t.t0 + cl;
              if (!vis) pr = 0.f;
            }
            st[nt][e] = pr;
            dpt[nt][e] = pr * (dpt[nt][e] - dl) * p.scale;
          }
        }
        pa[nt / 2][(nt & 1) * 2] = pack_f32(st[nt][0], st[nt][1]);
        pa[nt / 2][(nt & 1) * 2 + 1] = pack_f32(st[nt][2], st[nt][3]);
        da[nt / 2][(nt & 1) * 2] = pack_f32(dpt[nt][0], dpt[nt][1]);
        da[nt / 2][(nt & 1) * 2 + 1] = pack_f32(dpt[nt][2], dpt[nt][3]);
      }
      // dV += P^T dO and dK += dS^T Q: the q rows are the k dimension, so
      // dO's and Q's B fragments come transposed
#pragma unroll
      for (int kk = 0; kk < kSub / 16; ++kk) {
#pragma unroll
        for (int dp2 = 0; dp2 < D / 16; ++dp2) {
          const int off = (sub + kk * 16) * kLd + dp2 * 16 + aoff;
          uint32_t bd[4], bq[4];
          ldmatrix_x4_trans(bd, td + off);
          ldmatrix_x4_trans(bq, tq + off);
          mma_16816(dv[2 * dp2], pa[kk], bd);
          mma_16816(dv[2 * dp2 + 1], pa[kk], bd + 2);
          mma_16816(dk[2 * dp2], da[kk], bq);
          mma_16816(dk[2 * dp2 + 1], da[kk], bq + 2);
        }
      }
    }
  }

  cp_async_wait<0>();
  __syncthreads();  // every copy into K/V has landed, whatever the loop ran
  if (p.part == nullptr) {
    // g 1: bf16 out, staged through the warp's own K and V rows
    store_o<D>(dk, sK + warp * 16 * kLd, p.dk + b * p.dk_sb + hk * p.dk_sh,
               p.dk_ss, w0, p.skv, lane);
    store_o<D>(dv, sV + warp * 16 * kLd, p.dv + b * p.dv_sb + hk * p.dv_sh,
               p.dv_ss, w0, p.skv, lane);
    return;
  }
  // g > 1: this q head's f32 partials, [2, B, Hq, Skv, D]
  const long long plane = static_cast<long long>(p.batch) * p.hq * p.skv * D;
  float* pk = p.part + (static_cast<long long>(b) * p.hq + h) * p.skv * D;
  float* pv = pk + plane;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + t4 * 2;
    if (r0 < p.skv) {
      *reinterpret_cast<float2*>(pk + r0 * D + col) =
          make_float2(dk[dt][0], dk[dt][1]);
      *reinterpret_cast<float2*>(pv + r0 * D + col) =
          make_float2(dv[dt][0], dv[dt][1]);
    }
    if (r1 < p.skv) {
      *reinterpret_cast<float2*>(pk + r1 * D + col) =
          make_float2(dk[dt][2], dk[dt][3]);
      *reinterpret_cast<float2*>(pv + r1 * D + col) =
          make_float2(dv[dt][2], dv[dt][3]);
    }
  }
}

// K5's second pass (g > 1): dk and dv of each kv head, the sum of its g q
// heads' partials in head order, as bf16; four columns a thread.
__global__ void __launch_bounds__(256)
    flash_bwd_dkv_sum_kernel(const BwdParams p, int d) {
  const int cols = d / 4;
  const long long hkv = p.hq / p.group;
  const long long per = static_cast<long long>(p.batch) * hkv * p.skv * cols;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= 2 * per) return;
  const int which = static_cast<int>(i / per);  // 0: dk, 1: dv
  long long rest = i % per;
  const int col = static_cast<int>(rest % cols) * 4;
  rest /= cols;
  const int s = static_cast<int>(rest % p.skv);
  rest /= p.skv;
  const int hk = static_cast<int>(rest % hkv);
  const int b = static_cast<int>(rest / hkv);
  const long long head = static_cast<long long>(p.skv) * d;
  const long long plane = static_cast<long long>(p.batch) * p.hq * head;
  const float* src = p.part + which * plane +
                     (static_cast<long long>(b) * p.hq + hk * p.group) * head +
                     static_cast<long long>(s) * d + col;
  float4 acc = *reinterpret_cast<const float4*>(src);
  for (int j = 1; j < p.group; ++j) {
    const float4 x = *reinterpret_cast<const float4*>(src + j * head);
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  __nv_bfloat16* dst =
      which == 0 ? p.dk + b * p.dk_sb + hk * p.dk_sh + s * p.dk_ss
                 : p.dv + b * p.dv_sb + hk * p.dv_sh + s * p.dv_ss;
  *reinterpret_cast<uint2*>(dst + col) =
      make_uint2(pack_f32(acc.x, acc.y), pack_f32(acc.z, acc.w));
}

// Raise a kernel's dynamic shared-memory cap to the opt-in once (before the
// first launch, so never inside a CUDA-graph capture); the launch's own
// size decides the occupancy.
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  done = err == cudaSuccess;
  return err;
}

template <int D>
int launch_dq(const BwdParams& p, int rows, int smem, cudaStream_t stream) {
  static bool opted_in = false;
  const cudaError_t err = opt_in(flash_bwd_dq_kernel<D>, opted_in);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(((p.sq + rows - 1) / rows) * p.hq, p.batch);
  flash_bwd_dq_kernel<D><<<grid, 2 * rows, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const BwdParams& p, int rows, int smem, cudaStream_t stream) {
  static bool opted_in = false;
  cudaError_t err = opt_in(flash_bwd_dkv_kernel<D>, opted_in);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(((p.skv + rows - 1) / rows) * p.hq, p.batch);
  flash_bwd_dkv_kernel<D><<<grid, 2 * rows, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.part == nullptr) return static_cast<int>(err);
  const long long items =
      2LL * p.batch * (p.hq / p.group) * p.skv * (D / 4);
  flash_bwd_dkv_sum_kernel<<<static_cast<unsigned>((items + 255) / 256), 256,
                             0, stream>>>(p, D);
  return static_cast<int>(cudaGetLastError());
}

BwdParams make_params(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, const void* q_seg, const void* kv_seg, void* scratch,
    const long long* st, int batch, int hq, int sq, int skv, int hkv,
    int causal, float scale) {
  BwdParams p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<const __nv_bfloat16*>(o);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.part = static_cast<float*>(scratch);
  p.q_seg = static_cast<const int*>(q_seg);
  p.kv_seg = static_cast<const int*>(kv_seg);
  long long* dst[24] = {&p.q_sb,  &p.q_sh,  &p.q_ss,  &p.k_sb,  &p.k_sh,
                        &p.k_ss,  &p.v_sb,  &p.v_sh,  &p.v_ss,  &p.o_sb,
                        &p.o_sh,  &p.o_ss,  &p.do_sb, &p.do_sh, &p.do_ss,
                        &p.dq_sb, &p.dq_sh, &p.dq_ss, &p.dk_sb, &p.dk_sh,
                        &p.dk_ss, &p.dv_sb, &p.dv_sh, &p.dv_ss};
  for (int i = 0; i < 24; ++i) *dst[i] = st[i];
  p.batch = batch;
  p.hq = hq;
  p.sq = sq;
  p.skv = skv;
  p.group = hq / hkv;
  p.causal = causal;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  return p;
}

bool bad_call(int batch, int hq, int sq, int skv, int hkv, int rows,
              int smem, int smem_needed) {
  return batch < 1 || hq < 1 || sq < 1 || skv < 1 || hkv < 1 || hq % hkv ||
         (rows != 64 && rows != kMaxRows) || smem != smem_needed ||
         smem > kMaxSmem;
}

}  // namespace

// The backward entries share one signature. q/k/v/o/dout/dq/dk/dv are
// [B, H, S, D] bf16 with the given element strides (24 values: batch, head and
// row stride of each, in that order; the last dimension contiguous); lse and
// delta are contiguous [B, Hq, Sq] f32; segment pointers may be null.
// `rows_per_block` (64 or 128: q rows a K4 block, kv rows a K5 block) and
// `smem_bytes` come from the wrapper's `_bwd_launch_plan`; shared bytes other
// than this file's count for those rows are refused, and so is a K5 call
// with Hq > Hkv and no scratch. fvt_flash_attention_bwd_dq (K4) writes dq
// and delta; fvt_flash_attention_bwd_dkv (K5) reads delta and writes dk and
// dv, so it runs after K4 on the same stream; with Hq > Hkv it takes
// `scratch`, contiguous f32 [2, B, Hq, Skv, D], and launches its second pass.
// Each returns the cudaError_t of its launches.
#define FVT_BWD_ARGS                                                        \
  const void *q, const void *k, const void *v, const void *o,               \
      const void *dout, const void *lse, void *delta, void *dq, void *dk,   \
      void *dv, const void *q_seg, const void *kv_seg, void *scratch,       \
      const long long *st, int batch, int hq, int sq, int skv, int hkv,     \
      int head_dim, int causal, int rows_per_block, int smem_bytes,         \
      float scale, void *stream

extern "C" int fvt_flash_attention_bwd_dq(FVT_BWD_ARGS) {
  if (bad_call(batch, hq, sq, skv, hkv, rows_per_block, smem_bytes,
               dq_smem_bytes(head_dim)))
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdParams p =
      make_params(q, k, v, o, dout, lse, delta, dq, dk, dv, q_seg, kv_seg,
                  nullptr, st, batch, hq, sq, skv, hkv, causal, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64: return launch_dq<64>(p, rows_per_block, smem_bytes, s);
    case 80: return launch_dq<80>(p, rows_per_block, smem_bytes, s);
    case 128: return launch_dq<128>(p, rows_per_block, smem_bytes, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int fvt_flash_attention_bwd_dkv(FVT_BWD_ARGS) {
  if (bad_call(batch, hq, sq, skv, hkv, rows_per_block, smem_bytes,
               dkv_smem_bytes(rows_per_block, head_dim)) ||
      (hq > hkv) != (scratch != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdParams p =
      make_params(q, k, v, o, dout, lse, delta, dq, dk, dv, q_seg, kv_seg,
                  scratch, st, batch, hq, sq, skv, hkv, causal, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64: return launch_dkv<64>(p, rows_per_block, smem_bytes, s);
    case 80: return launch_dkv<80>(p, rows_per_block, smem_bytes, s);
    case 128: return launch_dkv<128>(p, rows_per_block, smem_bytes, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
