// K1 and K3: flash-attention forward for Hopper (sm_90a).
//
// K1 replaces the Pallas TPU kernel `_flash_kernel`
// (flash_vstream_tpu/kernels/flash_attention.py:90, launched by `_pallas_flash`).
// K3 replaces `_flash_kernel_stats` (:158, `save_stats=True`): the same kernel,
// given an lse pointer, also writes each row's logsumexp m + log(l) of the
// scaled scores, -inf for a row that sees no key, as [B, Hq, Sq] f32 (the TPU
// kernel lane-replicates it to [B, Hq, Sq, 128]). The backward kernels
// (flash_attention_bwd.cu) recompute the probabilities from it. Without the
// pointer (every no-grad call) it is K1 and writes nothing more.
//
// Same function as the TPU kernels: blockwise online-softmax attention over
// bf16 q/k/v with the running max, denominator and accumulator in f32;
// p = exp(s - m_new) rounded to bf16 unnormalised before the P V product,
// acc / l at the end; optional causal mask (q_offset 0); optional segment ids
// (equal ids attend, kv id -1 is never attended); GQA with kv head = q head /
// (Hq / Hkv), K/V never repeated in memory; a row with no visible key writes
// exactly 0 (the l > 0 test of the Pallas finalize). Head dims 64, 80, 128;
// ragged Sq and Skv are masked in-kernel, so the wrapper pads nothing.
//
// What bounds it on this card (H100 SXM: 989 TFLOP/s bf16, 3.35 TB/s). By
// its bound, the tensor cores at the answer prefill (q [1, 28, 3008, 128],
// causal, segments: 54 GFLOP, 0.055 ms), the training step ([1, 28, 4096,
// 128]: 0.105 ms) and the ViT's 448 px frames ([4, 16, 1024, 80]: 21.5
// GFLOP, 0.022 ms); the bytes at its 224 px frames ([4, 16, 256, 80]:
// 10.5 MB, 0.003 ms) and, at S 64, the launch and one tile's load latency.
// In fact, inferred from scripts/probe_flash_fwd.py's ablations (PERF.md):
// the latency of each tile's chain Q K^T -> softmax -> P V in a warp, with
// only two warps a scheduler at D 128 (one block of 8 warps an SM). Taking
// Q K^T out saves 19-24%, P V (the same count of HMMA and LDSM, off the
// chain's critical path) at most 11%, the exponentials 3-6%, the K/V
// copies 18-21%.
//
// Design: one block per (q tile, head, batch), 16 q rows a warp, on
// `mma.sync.m16n8k16` bf16 with f32 sums in registers (mma_common.cuh):
// 1. q tiles of up to 128 rows (1-8 warps). The wrapper's `_launch_plan`
//    starts at 128, no more than Sq needs, and above Sq 256 halves while
//    the grid has fewer than 132 blocks (below, a block's loop is short and
//    more blocks only load K/V again); the C entry takes the rows per block,
//    builds the grid from B, Hq and Sq itself and refuses rows outside
//    {16, 32, 64, 128} or shared bytes other than its own. Each K/V tile
//    staged in shared memory serves up to 128 rows, half the fills and L2
//    reads per FLOP of 64-row tiles. blockIdx.x walks the q tiles
//    from the last to the first, heads fastest: a causal grid starts its
//    longest blocks in the first wave, and a GQA group's blocks read the
//    same K/V from L2 together.
// 2. K/V through a 3-slot cp.async ring of 64-key tiles (dynamic shared
//    memory above 48 KB by the opt-in): tile j + 2's copies (K, V and the
//    tile's kv segment ids, one commit group) are issued before tile j's
//    math, behind one barrier a tile. Rows past Skv are zero-filled by the
//    src-size-0 form and masked. Each thread walks its chunks of a tile with
//    a pointer add a chunk (`TileCopy`), not a division and a 64-bit
//    multiply. Q arrives the same way once and stays in registers as A
//    fragments. Measured and dropped (PERF.md; each is a patch in
//    scripts/probe_flash_fwd.py): K and V in separate groups with a second
//    barrier before P V, so the scores wait only for K (18-22% slower at
//    D 128); 2 slots (1%); the first copy loop (12-14%); tile j + 1's
//    Q K^T issued before tile j's softmax (255 registers, 3-5% slower at
//    D 128; spills at D 80).
// 3. Fragments by ldmatrix: K's B fragments by `ldmatrix.x4` (two 8-key
//    tiles a load), V's by `ldmatrix.x4.trans` (two 8-column tiles a load),
//    an eighth of the shared loads of 16-bit reads of V. Rows stay padded
//    by kPad elements: a stride of D + 8 puts the eight 16-byte rows of
//    every 8x8 matrix on distinct banks, so the loads are free of conflicts.
// 4. Masks only where a tile needs them. When a tile's ids land, each warp
//    takes their min and max over the keys below Skv and, with its rows'
//    id range (taken once) and the causal position, puts the (warp, tile)
//    in one of three cases: skip (no pair can be visible: above the warp's
//    diagonal, every key -1, or id ranges apart), with no math but the
//    block's barriers; full (every pair visible: below the diagonal, inside
//    Skv, one id >= 0 for all keys and rows), with no per-element test; or
//    masked (a test per score). A skipped tile leaves m, l and acc as they
//    were, which is what a masked tile with no visible pair computes (alpha
//    is 1 when the max does not move, every p is 0), and the full path's
//    products are the masked path's; the case depends only on the warp's 16
//    rows, which are the same for every rows per block. So every output and
//    lse bit is the same whichever case a tile takes and whatever the rows
//    per block (held on the card by the tests and chip_smoke).
// 5. Softmax with the scale folded into the exponent: the max is taken over
//    raw scores and p = ex2(s * c - m * c) is one FFMA and one MUFU, with
//    c = scale * log2(e); ex2.approx flushes results below 2^-126 to 0. The
//    outputs stay within one or two bf16 steps of each row's max from the
//    plain version (row errors 7.6e-3 to 9.4e-3 of the row's max).
//
// Registers and spills (ptxas -v, CUDA 12.8, sm_90a): <128> 209 registers
// (one block of 8 warps an SM), no spills; <80> and <64> 128 registers, the
// cap for two blocks an SM, with 104 and 64 bytes of spill stores (without
// the cap, `one_block` in the probe, <80> runs 20% slower at 448 px).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace {

using namespace fvt;

constexpr int kBlockN = kTileRows;  // keys per tile
constexpr int kStages = 3;        // slots of the K/V ring
constexpr int kMaxRows = 128;     // q rows per block: 8 warps of 16
constexpr int kMaxSmem = 232448;  // the per-block opt-in on Hopper

struct FlashParams {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  float* lse;         // [B, Hq, Sq] (K3) or null (K1)
  const int* q_seg;   // [B, Sq] or null
  const int* kv_seg;  // [B, Skv] or null
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int hq, sq, skv, group, causal;
  float scale_log2;   // softmax scale * log2(e): exponentials run as exp2
};

// Shared bytes of a block of `rows` q rows: Q [rows][d + kPad] bf16, then
// kStages slots of K and V [64][d + kPad] bf16, then kStages x 64 kv ids.
int smem_needed(int rows, int d) {
  return 2 * (d + kPad) * (rows + 2 * kStages * kBlockN) +
         4 * kStages * kBlockN;
}

template <int D>
__global__ void __launch_bounds__(2 * kMaxRows, D > 80 ? 1 : 2)
    flash_fwd_kernel(const FlashParams p) {
  constexpr int kLd = D + kPad;
  constexpr int kTile = kBlockN * kLd;  // elements of one K or V slot
  extern __shared__ __align__(16) __nv_bfloat16 smem[];
  const int rows = blockDim.x / 2;      // 16 a warp
  __nv_bfloat16* sQ = smem;
  __nv_bfloat16* sK = sQ + rows * kLd;
  __nv_bfloat16* sV = sK + kStages * kTile;
  int* sSeg = reinterpret_cast<int*>(sV + kStages * kTile);

  // heaviest first: the q tiles from the last to the first, heads fastest
  const int n_qt = (p.sq + rows - 1) / rows;
  const int h = blockIdx.x % p.hq, b = blockIdx.y, hk = h / p.group;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x) / p.hq) * rows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;  // mma fragment row group / column
  const int w0 = q0 + warp * 16;            // the warp's first row
  const int w1 = min(w0 + 15, p.sq - 1);    // ... and its last below Sq
  const int row0 = w0 + g, row1 = row0 + 8;

  const __nv_bfloat16* kb = p.k + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + hk * p.v_sh;
  const bool seg = p.kv_seg != nullptr;
  const int* kvs = seg ? p.kv_seg + static_cast<long long>(b) * p.skv
                       : nullptr;

  int n_tiles = (p.skv + kBlockN - 1) / kBlockN;
  if (p.causal)
    n_tiles = min(n_tiles, (min(q0 + rows, p.sq) - 1) / kBlockN + 1);

  // K and V tile j with its kv ids into slot j % kStages, then a commit:
  // one group per tile (an empty group past the last tile keeps the count
  // of groups in flight the same at every step)
  const TileCopy<D> copy;
  auto issue = [&](int j) {
    const int slot = j % kStages, kv0 = j * kBlockN;
    if (j < n_tiles) {
      copy(sK + slot * kTile, kb + kv0 * p.k_ss, p.k_ss, p.skv - kv0);
      copy(sV + slot * kTile, vb + kv0 * p.v_ss, p.v_ss, p.skv - kv0);
      if (seg) {
        for (int i = threadIdx.x; i < kBlockN; i += blockDim.x) {
          const bool live = kv0 + i < p.skv;
          cp_async_4(sSeg + slot * kBlockN + i, live ? kvs + kv0 + i : kvs,
                     live ? 4 : 0);
        }
      }
    }
    cp_async_commit();
  };
  copy_rows<D>(sQ, p.q + b * p.q_sb + h * p.q_sh, p.q_ss, q0, rows, p.sq);
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) issue(j);  // Q joins tile 0's group

  // this thread's rows' segment ids, and the id range of the warp's rows
  int seg0 = 0, seg1 = 0, qmin = 0, qmax = 0;
  if (seg) {
    const int* qs = p.q_seg + static_cast<long long>(b) * p.sq;
    seg0 = row0 < p.sq ? qs[row0] : 0;
    seg1 = row1 < p.sq ? qs[row1] : 0;
    const int r = w0 + (lane & 15);
    const int id = r < p.sq ? qs[r] : 0;
    qmin = __reduce_min_sync(0xffffffffu, r < p.sq ? id : INT_MAX);
    qmax = __reduce_max_sync(0xffffffffu, r < p.sq ? id : INT_MIN);
  }

  uint32_t qf[D / 16][4];
  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  // running max of the raw scores and this thread's share of the
  // denominator, for rows row0 and row1
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  const float c = p.scale_log2;
  const int koff = lane_off_b<D>(lane), aoff = lane_off_a<D>(lane);

  // which case tile j is for this warp's rows (warp-uniform); its ids have
  // landed
  auto classify = [&](int j) {
    const int slot = j % kStages;
    return classify_tile(slot, j * kBlockN, p.skv, w0, w1, w0 < p.sq,
                         p.causal, true,
                         seg ? sSeg + slot * kBlockN : nullptr, qmin, qmax,
                         lane);
  };
  // the warp's raw scores against tile t; a masked score is -inf, so its p
  // is exactly 0
  auto scores = [&](const TileCase& t, float (&s)[8][4]) {
    tile_scores<D>(s, qf, sK + t.slot * kTile, koff);
    if (t.full) return;
    const int* ts = sSeg + t.slot * kBlockN;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cl = nt * 8 + t4 * 2 + (e & 1);
        bool vis = cl < t.nv;
        if (seg) {
          const int ks = ts[cl];
          vis = vis && ks >= 0 && ks == (e < 2 ? seg0 : seg1);
        }
        if (p.causal) vis = vis && t.t0 + cl <= (e < 2 ? row0 : row1);
        if (!vis) s[nt][e] = -INFINITY;
      }
    }
  };
  // the online softmax step over tile t's scores: m, l and acc rescaled,
  // p rounded to bf16 as the A fragments of P V
  auto softmax = [&](const float (&s)[8][4], uint32_t (&pa)[4][4]) {
    float t0 = -INFINITY, t1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      t0 = fmaxf(t0, fmaxf(s[nt][0], s[nt][1]));
      t1 = fmaxf(t1, fmaxf(s[nt][2], s[nt][3]));
    }
    const float n0 = fmaxf(m0, quad_max(t0)), n1 = fmaxf(m1, quad_max(t1));
    // alpha is 1 exactly when the max does not move; a row that has seen
    // no visible key keeps m = -inf, and its p are 0 against the base 0
    const float alpha0 = m0 == n0 ? 1.f : ex2((m0 - n0) * c);
    const float alpha1 = m1 == n1 ? 1.f : ex2((m1 - n1) * c);
    const float ms0 = n0 == -INFINITY ? 0.f : n0 * c;
    const float ms1 = n1 == -INFINITY ? 0.f : n1 * c;
    m0 = n0;
    m1 = n1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float x[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float* y = s[2 * kk + i];
        x[i][0] = ex2(fmaf(y[0], c, -ms0));
        x[i][1] = ex2(fmaf(y[1], c, -ms0));
        x[i][2] = ex2(fmaf(y[2], c, -ms1));
        x[i][3] = ex2(fmaf(y[3], c, -ms1));
        rs0 += x[i][0] + x[i][1];
        rs1 += x[i][2] + x[i][3];
      }
      pa[kk][0] = pack_f32(x[0][0], x[0][1]);
      pa[kk][1] = pack_f32(x[0][2], x[0][3]);
      pa[kk][2] = pack_f32(x[1][0], x[1][1]);
      pa[kk][3] = pack_f32(x[1][2], x[1][3]);
    }
    l0 = l0 * alpha0 + rs0;
    l1 = l1 * alpha1 + rs1;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      acc[dt][0] *= alpha0;
      acc[dt][1] *= alpha0;
      acc[dt][2] *= alpha1;
      acc[dt][3] *= alpha1;
    }
  };
  auto pv = [&](const TileCase& t, const uint32_t (&pa)[4][4]) {
    tile_pv<D>(acc, pa, sV + t.slot * kTile, aoff);
  };

  cp_async_wait<kStages - 2>();  // tile 0 and Q have landed ...
  __syncthreads();               // ... for every thread
  load_q<D>(qf, sQ + warp * 16 * kLd, aoff);
  for (int j = 0; j < n_tiles; ++j) {
    if (j > 0) {
      cp_async_wait<kStages - 2>();  // tile j has landed ...
      __syncthreads();  // ... for every thread; j - 1 is done with
    }
    issue(j + kStages - 1);  // into tile j - 1's slot
    const TileCase t = classify(j);
    if (!t.skip) {
      float s[8][4];
      uint32_t pa[4][4];
      scores(t, s);
      softmax(s, pa);
      pv(t, pa);
    }
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    acc[dt][0] = l0 > 0.f ? acc[dt][0] / l0 : 0.f;
    acc[dt][1] = l0 > 0.f ? acc[dt][1] / l0 : 0.f;
    acc[dt][2] = l1 > 0.f ? acc[dt][2] / l1 : 0.f;
    acc[dt][3] = l1 > 0.f ? acc[dt][3] / l1 : 0.f;
  }
  // the warp's own Q rows of shared memory stage its output rows
  store_o<D>(acc, sQ + warp * 16 * kLd, p.o + b * p.o_sb + h * p.o_sh,
             p.o_ss, w0, p.sq, lane);
  if (p.lse != nullptr && t4 == 0) {
    // ln(sum exp(s * scale)) = (m * c + log2 l) * ln 2
    float* lb = p.lse + (static_cast<long long>(b) * p.hq + h) * p.sq;
    if (row0 < p.sq)
      lb[row0] = l0 > 0.f ? (m0 * c + log2f(l0)) * kLn2 : -INFINITY;
    if (row1 < p.sq)
      lb[row1] = l1 > 0.f ? (m1 * c + log2f(l1)) * kLn2 : -INFINITY;
  }
}

template <int D>
int launch(const FlashParams& p, dim3 grid, int threads, int smem,
           cudaStream_t stream) {
  // raise the dynamic shared-memory cap to the opt-in once; the launch's
  // own size decides the occupancy
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  flash_fwd_kernel<D><<<grid, threads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q/k/v/o are [B, H, S, D] bf16 with the given element strides (the last
// dimension contiguous); lse ([B, Hq, Sq] f32, contiguous) and the segment
// pointers may be null. `rows_per_block` (16, 32, 64 or 128: 32 threads per
// 16 rows) and `smem_bytes` come from the wrapper's `_launch_plan`; the grid
// (q tiles x Hq, B) is built here, and shared bytes other than this file's
// count for those rows are refused. Returns the cudaError_t of the launch.
extern "C" int fvt_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const void* q_seg, const void* kv_seg, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, long long o_sb,
    long long o_sh, long long o_ss, int batch, int hq, int sq, int skv,
    int hkv, int head_dim, int causal, int rows_per_block, int smem_bytes,
    float scale, void* stream) {
  const int rows = rows_per_block;
  if (batch < 1 || hq < 1 || sq < 1 || skv < 1 || hkv < 1 || hq % hkv ||
      (rows != 16 && rows != 32 && rows != 64 && rows != 128) ||
      smem_bytes != smem_needed(rows, head_dim) || smem_bytes > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  FlashParams p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
  p.q_seg = static_cast<const int*>(q_seg);
  p.kv_seg = static_cast<const int*>(kv_seg);
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.hq = hq;
  p.sq = sq;
  p.skv = skv;
  p.group = hq / hkv;
  p.causal = causal;
  p.scale_log2 = scale * kLog2e;
  const dim3 grid(((sq + rows - 1) / rows) * hq, batch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64: return launch<64>(p, grid, 2 * rows, smem_bytes, st);
    case 80: return launch<80>(p, grid, 2 * rows, smem_bytes, st);
    case 128: return launch<128>(p, grid, 2 * rows, smem_bytes, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* fvt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
