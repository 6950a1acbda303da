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
// Same function as the TPU kernels: blockwise online-softmax attention over bf16 q/k/v with the
// running max, denominator and accumulator in f32; optional causal mask
// (q_offset 0, kv tiles wholly above the diagonal are skipped); optional
// segment ids (equal ids attend, kv id -1 is never attended); GQA with
// kv head = q head / (Hq / Hkv), K/V never repeated in memory; a row with no
// visible key writes exactly 0 (the l > 0 test of the Pallas finalize).
//
// Design. One thread block per (batch, q head, 64-row q tile), four warps,
// each warp owns 16 q rows. The TPU kernel carries m/l/acc in VMEM scratch
// across a sequential kv grid axis; here that axis is a loop inside the block
// and the state lives in registers. Both products (Q K^T and P V) run on the
// tensor cores as `mma.sync.m16n8k16` bf16 fragments with f32 accumulation.
// The S accumulator's register layout equals the A-operand layout of the next
// product, so P goes from the softmax to the P V product without touching
// shared memory. K and V tiles (64 rows) are staged in shared memory with
// 16-byte loads; ragged q rows and kv rows are masked in-kernel (zero-filled
// loads, no stores), so the wrapper pads nothing.
//
// What bounds it on this card. The answer prefill (S ~ 3k, D 128, causal) is
// tensor-core bound; the ViT frame attention (S 256 / 64, D 80) is small and
// bound by launch and load latency. This first version is plain `mma.sync`
// with synchronous tile loads and no pipelining: wgmma, TMA and warp
// specialisation are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace {

using namespace fvt;

constexpr int kBlockM = 64;  // q rows per block: 4 warps x 16 rows
constexpr int kBlockN = 64;  // kv rows per tile
constexpr int kWarps = 4;

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

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
    flash_fwd_kernel(const FlashParams p) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int kSteps = D / 16;       // k-steps of Q K^T
  constexpr int kDTiles = D / 8;       // n-tiles of P V
  constexpr int kNTiles = kBlockN / 8; // n-tiles of S
  constexpr int kLd = D + kPad;
  constexpr int kVec = D / 8;          // 16-byte chunks per row

  __shared__ __align__(16) __nv_bfloat16 sK[kBlockN * kLd];
  __shared__ __align__(16) __nv_bfloat16 sV[kBlockN * kLd];
  __shared__ int sSeg[kBlockN];

  const int q_tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / p.group;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;  // mma fragment row group / column
  const int q0 = q_tile * kBlockM;
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;

  const __nv_bfloat16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kb = p.k + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + hk * p.v_sh;

  // Q fragments stay in registers for the whole kv loop.
  uint32_t qf[kSteps][4];
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    const int c = kk * 16 + t4 * 2;
    qf[kk][0] = row0 < p.sq ? ld32(qb + row0 * p.q_ss + c) : 0u;
    qf[kk][1] = row1 < p.sq ? ld32(qb + row1 * p.q_ss + c) : 0u;
    qf[kk][2] = row0 < p.sq ? ld32(qb + row0 * p.q_ss + c + 8) : 0u;
    qf[kk][3] = row1 < p.sq ? ld32(qb + row1 * p.q_ss + c + 8) : 0u;
  }
  const int seg0 = (p.q_seg && row0 < p.sq) ? p.q_seg[b * p.sq + row0] : 0;
  const int seg1 = (p.q_seg && row1 < p.sq) ? p.q_seg[b * p.sq + row1] : 0;

  float acc[kDTiles][4];
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  // running max (log2 domain) and this thread's share of the denominator,
  // for rows row0 and row1
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  int n_tiles = (p.skv + kBlockN - 1) / kBlockN;
  if (p.causal) n_tiles = min(n_tiles, (q0 + kBlockM - 1) / kBlockN + 1);

  for (int j = 0; j < n_tiles; ++j) {
    const int kv0 = j * kBlockN;
    __syncthreads();  // every warp is done reading the previous tile
    for (int i = tid; i < kBlockN * kVec; i += kWarps * 32) {
      const int r = i / kVec, c = (i % kVec) * 8;
      uint4 kx = make_uint4(0u, 0u, 0u, 0u), vx = kx;
      if (kv0 + r < p.skv) {
        kx = *reinterpret_cast<const uint4*>(kb + (kv0 + r) * p.k_ss + c);
        vx = *reinterpret_cast<const uint4*>(vb + (kv0 + r) * p.v_ss + c);
      }
      *reinterpret_cast<uint4*>(&sK[r * kLd + c]) = kx;
      *reinterpret_cast<uint4*>(&sV[r * kLd + c]) = vx;
    }
    if (tid < kBlockN) {
      const int col = kv0 + tid;
      // -2 marks a kv row past Skv; caller segment ids are >= -1
      sSeg[tid] = col < p.skv ? (p.kv_seg ? p.kv_seg[b * p.skv + col] : 0)
                              : -2;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 kv columns
    float s[kNTiles][4];
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt)
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
#pragma unroll
      for (int nt = 0; nt < kNTiles; ++nt) {
        const __nv_bfloat16* kr = &sK[(nt * 8 + g) * kLd + kk * 16 + t4 * 2];
        const uint32_t bf[2] = {ld32(kr), ld32(kr + 8)};
        mma_16816(s[nt], qf[kk], bf);
      }
    }

    // mask and scale; a masked score is -inf, so its p is exactly 0
    float tmax0 = -INFINITY, tmax1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cl = nt * 8 + t4 * 2 + (e & 1);
        const int row = e < 2 ? row0 : row1;
        const int kseg = sSeg[cl];
        bool vis = kseg != -2;
        if (p.kv_seg) vis = vis && kseg >= 0 && kseg == (e < 2 ? seg0 : seg1);
        if (p.causal) vis = vis && kv0 + cl <= row;
        const float x = vis ? s[nt][e] * p.scale_log2 : -INFINITY;
        s[nt][e] = x;
        if (e < 2) tmax0 = fmaxf(tmax0, x);
        else tmax1 = fmaxf(tmax1, x);
      }
    }
    const float mn0 = fmaxf(m0, quad_max(tmax0));
    const float mn1 = fmaxf(m1, quad_max(tmax1));
    // a row that has seen no visible key keeps m = -inf; exp2 against base 0
    // then gives p = 0 and alpha = 0 with no inf - inf
    const float base0 = mn0 == -INFINITY ? 0.f : mn0;
    const float base1 = mn1 == -INFINITY ? 0.f : mn1;
    const float alpha0 = exp2f(m0 - base0), alpha1 = exp2f(m1 - base1);
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - base0);
      s[nt][1] = exp2f(s[nt][1] - base0);
      s[nt][2] = exp2f(s[nt][2] - base1);
      s[nt][3] = exp2f(s[nt][3] - base1);
      rs0 += s[nt][0] + s[nt][1];
      rs1 += s[nt][2] + s[nt][3];
    }
    l0 = l0 * alpha0 + rs0;
    l1 = l1 * alpha1 + rs1;
#pragma unroll
    for (int dt = 0; dt < kDTiles; ++dt) {
      acc[dt][0] *= alpha0;
      acc[dt][1] *= alpha0;
      acc[dt][2] *= alpha1;
      acc[dt][3] *= alpha1;
    }

    // acc += P V, with P rounded to bf16 as the A operand
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_f32(s[2 * kk][0], s[2 * kk][1]),
          pack_f32(s[2 * kk][2], s[2 * kk][3]),
          pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const int r = kk * 16 + t4 * 2;
#pragma unroll
      for (int dt = 0; dt < kDTiles; ++dt) {
        const int c = dt * 8 + g;
        const uint32_t bf[2] = {
            pack_bf16(sV[r * kLd + c], sV[(r + 1) * kLd + c]),
            pack_bf16(sV[(r + 8) * kLd + c], sV[(r + 9) * kLd + c])};
        mma_16816(acc[dt], pa, bf);
      }
    }
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  __nv_bfloat16* ob = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt) {
    const int c = dt * 8 + t4 * 2;
    if (row0 < p.sq) {
      *reinterpret_cast<uint32_t*>(ob + row0 * p.o_ss + c) =
          l0 > 0.f ? pack_f32(acc[dt][0] / l0, acc[dt][1] / l0) : 0u;
    }
    if (row1 < p.sq) {
      *reinterpret_cast<uint32_t*>(ob + row1 * p.o_ss + c) =
          l1 > 0.f ? pack_f32(acc[dt][2] / l1, acc[dt][3] / l1) : 0u;
    }
  }
  if (p.lse != nullptr && t4 == 0) {
    // m is in the log2 domain: ln(sum exp(s * scale)) = (m + log2 l) * ln 2
    float* lb = p.lse + (static_cast<long long>(b) * p.hq + h) * p.sq;
    if (row0 < p.sq) lb[row0] = l0 > 0.f ? (m0 + log2f(l0)) * kLn2 : -INFINITY;
    if (row1 < p.sq) lb[row1] = l1 > 0.f ? (m1 + log2f(l1)) * kLn2 : -INFINITY;
  }
}

template <int D>
int launch(const FlashParams& p, int batch, int hq, cudaStream_t stream) {
  const dim3 grid((p.sq + kBlockM - 1) / kBlockM, hq, batch);
  flash_fwd_kernel<D><<<grid, kWarps * 32, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q/k/v/o are [B, H, S, D] bf16 with the given element strides (the last
// dimension contiguous); lse ([B, Hq, Sq] f32, contiguous) and the segment
// pointers may be null. Returns the cudaError_t of the launch.
extern "C" int fvt_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const void* q_seg, const void* kv_seg, long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, long long o_sb, long long o_sh,
    long long o_ss, int batch, int hq, int sq, int skv, int hkv,
    int head_dim, int causal, float scale, void* stream) {
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64: return launch<64>(p, batch, hq, st);
    case 80: return launch<80>(p, batch, hq, st);
    case 128: return launch<128>(p, batch, hq, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* fvt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
