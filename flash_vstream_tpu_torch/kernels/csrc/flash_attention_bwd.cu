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
// Design. The TPU kernels walk a sequential grid axis and carry their sums in
// VMEM scratch; here each sum is a loop inside one block with the
// accumulators in registers.
// - K4: one block per (batch, q head, 64 q rows), four warps of 16 rows. Q and
//   dO stay in registers as mma A fragments; the loop runs over 32-row kv
//   tiles (causal tiles past the diagonal skipped) staged in shared memory.
//   K4 also computes delta once per row from its dO and O fragments and
//   writes it out for K5; the TPU kernels recompute it for every tile pair.
// - K5: one block per (batch, kv head, 64 kv rows), four warps of 16 rows. The
//   loop runs over every q head of the GQA group and every 32-row q tile
//   (causal tiles before the diagonal skipped), so dk and dv are summed over
//   the group inside the block and written once per kv head, as the TPU
//   kernel does (:336-337). The transposed scores S^T = K Q^T put the kv rows
//   on the fragment rows, so p^T and ds^T are A operands of dV += p^T dO and
//   dK += ds^T Q without a trip through shared memory.
// dq, dk and dv each have one writer, so nothing needs atomics and the result
// is deterministic. FlashAttention-2 instead accumulates dq with f32 atomics
// from the dk/dv blocks, which saves K4's second pass over Q K^T but adds an
// f32 dq buffer, a conversion pass and run-to-run differences in the sums.
//
// What bounds it on this card. At the training shape (S 4096-14000, D 128,
// causal) both kernels are tensor-core bound: K4 does 3 products per (q, k)
// pair (Q K^T, dO V^T, dS K) and K5 four (K Q^T, V dO^T, P^T dO, dS^T Q). This
// first version is plain `mma.sync` with synchronous tile loads; K5 has only
// B x Hkv x Skv / 64 blocks (256 at S 4096), about two per SM. wgmma, TMA and
// a split of K5 over the group are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace {

using namespace fvt;

constexpr int kWarps = 4;
constexpr int kRows = 64;   // rows per block (q rows in K4, kv rows in K5)
constexpr int kTile = 32;   // rows per inner tile (kv in K4, q in K5)

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
  int hq, sq, skv, group, causal;
  float scale, scale_log2;
};

// Copy `rows` rows of D bf16 starting at row r0 of `src` (row stride `ss`)
// into shared memory with row stride kLd, 16 bytes per thread and step; rows
// at or past `limit` are zero-filled.
template <int D, int kLd>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long ss, int r0, int rows,
                                          int limit, int tid) {
  constexpr int kVec = D / 8;
  for (int i = tid; i < rows * kVec; i += kWarps * 32) {
    const int r = i / kVec, c = (i % kVec) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < limit)
      x = *reinterpret_cast<const uint4*>(src + (r0 + r) * ss + c);
    *reinterpret_cast<uint4*>(&dst[r * kLd + c]) = x;
  }
}

// ---------------------------------------------------------------------------
// K4: dq (and delta)
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
    flash_bwd_dq_kernel(const BwdParams p) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int kSteps = D / 16;        // k-steps over the head dim
  constexpr int kDTiles = D / 8;        // n-tiles of dQ
  constexpr int kNTiles = kTile / 8;    // n-tiles of S and dP
  constexpr int kLd = D + kPad;

  __shared__ __align__(16) __nv_bfloat16 sK[kTile * kLd];
  __shared__ __align__(16) __nv_bfloat16 sV[kTile * kLd];
  __shared__ int sSeg[kTile];

  const int q_tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / p.group;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = q_tile * kRows;
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  const bool in0 = row0 < p.sq, in1 = row1 < p.sq;

  const __nv_bfloat16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* ob = p.o + b * p.o_sb + h * p.o_sh;
  const __nv_bfloat16* db = p.dout + b * p.do_sb + h * p.do_sh;
  const __nv_bfloat16* kb = p.k + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + hk * p.v_sh;

  // Q and dO fragments for the whole kv loop; delta from dO and O at the
  // same fragment positions, summed over the quad that shares a row
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
  // lse in the log2 domain; -inf (no visible key, or a row past Sq) gates p
  const float lse0 = in0 ? p.lse[stat + row0] * kLog2e : -INFINITY;
  const float lse1 = in1 ? p.lse[stat + row1] * kLog2e : -INFINITY;
  const bool live0 = isfinite(lse0), live1 = isfinite(lse1);
  const int seg0 = (p.q_seg && in0) ? p.q_seg[b * p.sq + row0] : 0;
  const int seg1 = (p.q_seg && in1) ? p.q_seg[b * p.sq + row1] : 0;

  float acc[kDTiles][4];
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

  int n_tiles = (p.skv + kTile - 1) / kTile;
  if (p.causal) n_tiles = min(n_tiles, (q0 + kRows - 1) / kTile + 1);

  for (int j = 0; j < n_tiles; ++j) {
    const int kv0 = j * kTile;
    __syncthreads();  // every warp is done reading the previous tile
    load_tile<D, kLd>(sK, kb, p.k_ss, kv0, kTile, p.skv, tid);
    load_tile<D, kLd>(sV, vb, p.v_ss, kv0, kTile, p.skv, tid);
    if (tid < kTile) {
      const int col = kv0 + tid;
      // -2 marks a kv row past Skv; caller segment ids are >= -1
      sSeg[tid] = col < p.skv ? (p.kv_seg ? p.kv_seg[b * p.skv + col] : 0)
                              : -2;
    }
    __syncthreads();

    // S = Q K^T and dP = dO V^T for this warp's 16 rows x kTile kv columns
    float s[kNTiles][4], dp[kNTiles][4];
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
#pragma unroll
      for (int nt = 0; nt < kNTiles; ++nt) {
        const int off = (nt * 8 + g) * kLd + kk * 16 + t4 * 2;
        const uint32_t bk[2] = {ld32(&sK[off]), ld32(&sK[off + 8])};
        const uint32_t bv[2] = {ld32(&sV[off]), ld32(&sV[off + 8])};
        mma_16816(s[nt], qf[kk], bk);
        mma_16816(dp[nt], df[kk], bv);
      }
    }

    // p from the saved lse, then ds = p (dp - delta) scale, kept in s
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cl = nt * 8 + t4 * 2 + (e & 1);
        const bool top = e < 2;
        const int row = top ? row0 : row1;
        const int kseg = sSeg[cl];
        bool vis = kseg != -2 && (top ? live0 : live1);
        if (p.kv_seg) vis = vis && kseg >= 0 && kseg == (top ? seg0 : seg1);
        if (p.causal) vis = vis && kv0 + cl <= row;
        const float pr =
            vis ? exp2f(s[nt][e] * p.scale_log2 - (top ? lse0 : lse1)) : 0.f;
        s[nt][e] = pr * (dp[nt][e] - (top ? delta0 : delta1)) * p.scale;
      }
    }

    // dQ += dS K, dS rounded to bf16 as the A operand
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      const uint32_t a[4] = {
          pack_f32(s[2 * kk][0], s[2 * kk][1]),
          pack_f32(s[2 * kk][2], s[2 * kk][3]),
          pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const int r = kk * 16 + t4 * 2;
#pragma unroll
      for (int dt = 0; dt < kDTiles; ++dt) {
        const int c = dt * 8 + g;
        const uint32_t bf[2] = {
            pack_bf16(sK[r * kLd + c], sK[(r + 1) * kLd + c]),
            pack_bf16(sK[(r + 8) * kLd + c], sK[(r + 9) * kLd + c])};
        mma_16816(acc[dt], a, bf);
      }
    }
  }

  __nv_bfloat16* out = p.dq + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt) {
    const int c = dt * 8 + t4 * 2;
    if (in0)
      *reinterpret_cast<uint32_t*>(out + row0 * p.dq_ss + c) =
          pack_f32(acc[dt][0], acc[dt][1]);
    if (in1)
      *reinterpret_cast<uint32_t*>(out + row1 * p.dq_ss + c) =
          pack_f32(acc[dt][2], acc[dt][3]);
  }
}

// ---------------------------------------------------------------------------
// K5: dk, dv
// ---------------------------------------------------------------------------

template <int D>
constexpr int dkv_smem_bytes() {
  // K, V (kRows each) and Q, dO (kTile each) tiles, plus per-q-row lse,
  // delta and segment id
  return (2 * kRows + 2 * kTile) * (D + kPad) * 2 + 3 * kTile * 4;
}

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
    flash_bwd_dkv_kernel(const BwdParams p) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int kSteps = D / 16;        // k-steps over the head dim
  constexpr int kDTiles = D / 8;        // n-tiles of dK and dV
  constexpr int kNTiles = kTile / 8;    // n-tiles of S^T and dP^T
  constexpr int kLd = D + kPad;

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sV = sK + kRows * kLd;
  __nv_bfloat16* sQ = sV + kRows * kLd;
  __nv_bfloat16* sD = sQ + kTile * kLd;                         // dO
  float* sLse = reinterpret_cast<float*>(sD + kTile * kLd);    // log2 domain
  float* sDelta = sLse + kTile;
  int* sSeg = reinterpret_cast<int*>(sDelta + kTile);

  const int kv_tile = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int kv0 = kv_tile * kRows;
  const int wr = warp * 16 + g;                  // this thread's tile rows
  const int r0 = kv0 + wr, r1 = r0 + 8;          // wr and wr + 8
  const int kseg0 = r0 < p.skv ? (p.kv_seg ? p.kv_seg[b * p.skv + r0] : 0) : -2;
  const int kseg1 = r1 < p.skv ? (p.kv_seg ? p.kv_seg[b * p.skv + r1] : 0) : -2;

  load_tile<D, kLd>(sK, p.k + b * p.k_sb + hk * p.k_sh, p.k_ss, kv0, kRows,
                    p.skv, tid);
  load_tile<D, kLd>(sV, p.v + b * p.v_sb + hk * p.v_sh, p.v_ss, kv0, kRows,
                    p.skv, tid);

  float dk[kDTiles][4], dv[kDTiles][4];
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt) {
    dk[dt][0] = dk[dt][1] = dk[dt][2] = dk[dt][3] = 0.f;
    dv[dt][0] = dv[dt][1] = dv[dt][2] = dv[dt][3] = 0.f;
  }

  const int n_q = (p.sq + kTile - 1) / kTile;
  const int first = p.causal ? kv0 / kTile : 0;   // earlier q rows see no key here
  for (int hh = 0; hh < p.group; ++hh) {
    const int h = hk * p.group + hh;
    const __nv_bfloat16* qb = p.q + b * p.q_sb + h * p.q_sh;
    const __nv_bfloat16* db = p.dout + b * p.do_sb + h * p.do_sh;
    const long long stat = (static_cast<long long>(b) * p.hq + h) * p.sq;
    for (int i = first; i < n_q; ++i) {
      const int q0 = i * kTile;
      __syncthreads();  // every warp is done reading the previous tile
      load_tile<D, kLd>(sQ, qb, p.q_ss, q0, kTile, p.sq, tid);
      load_tile<D, kLd>(sD, db, p.do_ss, q0, kTile, p.sq, tid);
      if (tid < kTile) {
        const int row = q0 + tid;
        const bool in = row < p.sq;
        const float l = in ? p.lse[stat + row] : -INFINITY;
        sLse[tid] = isfinite(l) ? l * kLog2e : -INFINITY;
        sDelta[tid] = in ? p.delta[stat + row] : 0.f;
        // -2 marks a q row past Sq
        sSeg[tid] = in ? (p.q_seg ? p.q_seg[b * p.sq + row] : 0) : -2;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: this warp's 16 kv rows x kTile q cols
      float st[kNTiles][4], dpt[kNTiles][4];
#pragma unroll
      for (int nt = 0; nt < kNTiles; ++nt) {
        st[nt][0] = st[nt][1] = st[nt][2] = st[nt][3] = 0.f;
        dpt[nt][0] = dpt[nt][1] = dpt[nt][2] = dpt[nt][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        const int c = kk * 16 + t4 * 2;
        const uint32_t ka[4] = {ld32(&sK[wr * kLd + c]),
                                ld32(&sK[(wr + 8) * kLd + c]),
                                ld32(&sK[wr * kLd + c + 8]),
                                ld32(&sK[(wr + 8) * kLd + c + 8])};
        const uint32_t va[4] = {ld32(&sV[wr * kLd + c]),
                                ld32(&sV[(wr + 8) * kLd + c]),
                                ld32(&sV[wr * kLd + c + 8]),
                                ld32(&sV[(wr + 8) * kLd + c + 8])};
#pragma unroll
        for (int nt = 0; nt < kNTiles; ++nt) {
          const int off = (nt * 8 + g) * kLd + c;
          const uint32_t bq[2] = {ld32(&sQ[off]), ld32(&sQ[off + 8])};
          const uint32_t bd[2] = {ld32(&sD[off]), ld32(&sD[off + 8])};
          mma_16816(st[nt], ka, bq);
          mma_16816(dpt[nt], va, bd);
        }
      }

      // p^T from the saved lse (kept in st), ds^T = p^T (dp^T - delta) scale
      // (kept in dpt)
#pragma unroll
      for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int cl = nt * 8 + t4 * 2 + (e & 1);
          const bool top = e < 2;
          const int krow = top ? r0 : r1;
          const int kseg = top ? kseg0 : kseg1;
          const int qseg = sSeg[cl];
          const float lse = sLse[cl];
          bool vis = qseg != -2 && kseg != -2 && lse != -INFINITY;
          if (p.q_seg) vis = vis && kseg >= 0 && kseg == qseg;
          if (p.causal) vis = vis && krow <= q0 + cl;
          const float pr = vis ? exp2f(st[nt][e] * p.scale_log2 - lse) : 0.f;
          st[nt][e] = pr;
          dpt[nt][e] = pr * (dpt[nt][e] - sDelta[cl]) * p.scale;
        }
      }

      // dV += P^T dO and dK += dS^T Q, both A operands rounded to bf16
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        const uint32_t pa[4] = {
            pack_f32(st[2 * kk][0], st[2 * kk][1]),
            pack_f32(st[2 * kk][2], st[2 * kk][3]),
            pack_f32(st[2 * kk + 1][0], st[2 * kk + 1][1]),
            pack_f32(st[2 * kk + 1][2], st[2 * kk + 1][3])};
        const uint32_t da[4] = {
            pack_f32(dpt[2 * kk][0], dpt[2 * kk][1]),
            pack_f32(dpt[2 * kk][2], dpt[2 * kk][3]),
            pack_f32(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]),
            pack_f32(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3])};
        const int r = kk * 16 + t4 * 2;
#pragma unroll
        for (int dt = 0; dt < kDTiles; ++dt) {
          const int c = dt * 8 + g;
          const uint32_t bd[2] = {
              pack_bf16(sD[r * kLd + c], sD[(r + 1) * kLd + c]),
              pack_bf16(sD[(r + 8) * kLd + c], sD[(r + 9) * kLd + c])};
          const uint32_t bq[2] = {
              pack_bf16(sQ[r * kLd + c], sQ[(r + 1) * kLd + c]),
              pack_bf16(sQ[(r + 8) * kLd + c], sQ[(r + 9) * kLd + c])};
          mma_16816(dv[dt], pa, bd);
          mma_16816(dk[dt], da, bq);
        }
      }
    }
  }

  __nv_bfloat16* dkb = p.dk + b * p.dk_sb + hk * p.dk_sh;
  __nv_bfloat16* dvb = p.dv + b * p.dv_sb + hk * p.dv_sh;
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt) {
    const int c = dt * 8 + t4 * 2;
    if (r0 < p.skv) {
      *reinterpret_cast<uint32_t*>(dkb + r0 * p.dk_ss + c) =
          pack_f32(dk[dt][0], dk[dt][1]);
      *reinterpret_cast<uint32_t*>(dvb + r0 * p.dv_ss + c) =
          pack_f32(dv[dt][0], dv[dt][1]);
    }
    if (r1 < p.skv) {
      *reinterpret_cast<uint32_t*>(dkb + r1 * p.dk_ss + c) =
          pack_f32(dk[dt][2], dk[dt][3]);
      *reinterpret_cast<uint32_t*>(dvb + r1 * p.dv_ss + c) =
          pack_f32(dv[dt][2], dv[dt][3]);
    }
  }
}

template <int D>
int launch_dq(const BwdParams& p, int batch, cudaStream_t stream) {
  const dim3 grid((p.sq + kRows - 1) / kRows, p.hq, batch);
  flash_bwd_dq_kernel<D><<<grid, kWarps * 32, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const BwdParams& p, int batch, int hkv, cudaStream_t stream) {
  constexpr int bytes = dkv_smem_bytes<D>();
  // above 48 KB only as opted-in dynamic shared memory; set once per head
  // dim, before the first launch (so never inside a CUDA-graph capture)
  static const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.skv + kRows - 1) / kRows, hkv, batch);
  flash_bwd_dkv_kernel<D><<<grid, kWarps * 32, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

BwdParams make_params(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, const void* q_seg, const void* kv_seg, const long long* st,
    int hq, int sq, int skv, int hkv, int causal, float scale) {
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
  p.q_seg = static_cast<const int*>(q_seg);
  p.kv_seg = static_cast<const int*>(kv_seg);
  long long* dst[24] = {&p.q_sb,  &p.q_sh,  &p.q_ss,  &p.k_sb,  &p.k_sh,
                        &p.k_ss,  &p.v_sb,  &p.v_sh,  &p.v_ss,  &p.o_sb,
                        &p.o_sh,  &p.o_ss,  &p.do_sb, &p.do_sh, &p.do_ss,
                        &p.dq_sb, &p.dq_sh, &p.dq_ss, &p.dk_sb, &p.dk_sh,
                        &p.dk_ss, &p.dv_sb, &p.dv_sh, &p.dv_ss};
  for (int i = 0; i < 24; ++i) *dst[i] = st[i];
  p.hq = hq;
  p.sq = sq;
  p.skv = skv;
  p.group = hq / hkv;
  p.causal = causal;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  return p;
}

}  // namespace

// The backward entries share one signature. q/k/v/o/dout/dq/dk/dv are
// [B, H, S, D] bf16 with the given element strides (24 values: batch, head and
// row stride of each, in that order; the last dimension contiguous); lse and
// delta are contiguous [B, Hq, Sq] f32; segment pointers may be null.
// fvt_flash_attention_bwd_dq (K4) writes dq and delta; fvt_flash_attention_
// bwd_dkv (K5) reads delta and writes dk and dv, so it runs after K4 on the
// same stream. Each returns the cudaError_t of its launch.
#define FVT_BWD_ARGS                                                        \
  const void *q, const void *k, const void *v, const void *o,               \
      const void *dout, const void *lse, void *delta, void *dq, void *dk,   \
      void *dv, const void *q_seg, const void *kv_seg, const long long *st, \
      int batch, int hq, int sq, int skv, int hkv, int head_dim, int causal, \
      float scale, void *stream

extern "C" int fvt_flash_attention_bwd_dq(FVT_BWD_ARGS) {
  const BwdParams p = make_params(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                  q_seg, kv_seg, st, hq, sq, skv, hkv, causal,
                                  scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64: return launch_dq<64>(p, batch, s);
    case 80: return launch_dq<80>(p, batch, s);
    case 128: return launch_dq<128>(p, batch, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int fvt_flash_attention_bwd_dkv(FVT_BWD_ARGS) {
  const BwdParams p = make_params(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                  q_seg, kv_seg, st, hq, sq, skv, hkv, causal,
                                  scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64: return launch_dkv<64>(p, batch, hkv, s);
    case 80: return launch_dkv<80>(p, batch, hkv, s);
    case 128: return launch_dkv<128>(p, batch, hkv, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
