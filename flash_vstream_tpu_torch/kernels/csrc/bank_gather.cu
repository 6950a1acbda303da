// P1: bank gather out[i] = bank[idx[i]] through the bulk-copy engine (TMA),
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `gather_kernel`
// (scripts/probe_bank_gather.py:81, launched by `pallas_gather` at :91): a
// scalar-prefetch grid over the K indices whose every step DMAs one [P, D]
// bank row HBM -> VMEM -> out. K2 (gather_rows.cu) ports the same function
// as a vector copy through the threads' registers; this kernel takes the
// route the TPU kernel takes, one asynchronous bulk copy per piece of a row,
// so that the DAM-gather probe can time both Hopper routes side by side.
//
// Design. Grid (splits, K): blockIdx.y is the output row and reads its own
// index (the TPU's scalar prefetch); the row's bytes are cut into `splits`
// chunks of a multiple of 16 bytes, one per block, so that K 30 rows fill
// the 132 SMs. One thread of each block streams its chunk through a ring of
// kStages shared-memory stages of at most kStageBytes each:
//   - `cp.async.bulk` global -> shared signals the stage's mbarrier with the
//     bytes it delivered (expect_tx / complete_tx);
//   - once that barrier's phase flips, `cp.async.bulk` shared -> global
//     writes the stage out, committed as a bulk group;
//   - a stage is loaded again only after `cp.async.bulk.wait_group.read`
//     says the store that read it has finished reading.
// So kStages - 1 loads and up to two stores are in flight per block. The
// copy moves bytes only: bf16 and f32 banks share it.
//
// Limits: the bulk copy takes 16-byte aligned addresses and sizes in
// multiples of 16 (the wrapper raises otherwise); an mbarrier phase counts
// at most 2^20 - 1 transaction bytes, far above the 16 KB stage; the 64 KB
// of dynamic shared memory needs cudaFuncSetAttribute above 48 KB.
//
// What bounds it on this card: device-memory bandwidth. The probe gathers
// 30 rows of 256 x 1280 bf16 (19.7 MB read, 19.7 MB written): 11.7 us at
// 3.35 TB/s.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStages = 4;
constexpr int kStageBytes = 16 * 1024;
constexpr int kSmemBytes = kStages * kStageBytes;
constexpr int kBlocksPerSm = 3;  // 3 x 64 KB of the SM's 227 KB

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
                   dst),
               "r"(smem_addr(src)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until all but the newest N committed stores have read their source.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

__global__ void __launch_bounds__(32)
    bank_gather_kernel(const uint8_t* __restrict__ bank,
                       const int* __restrict__ idx, uint8_t* __restrict__ out,
                       long long row_bytes, long long chunk) {
  extern __shared__ __align__(128) uint8_t stage[];
  __shared__ __align__(8) uint64_t bar[kStages];
  if (threadIdx.x != 0) return;

  const long long begin = static_cast<long long>(blockIdx.x) * chunk;
  if (begin >= row_bytes) return;
  const long long len = min(chunk, row_bytes - begin);
  const uint8_t* src =
      bank + static_cast<long long>(__ldg(idx + blockIdx.y)) * row_bytes +
      begin;
  uint8_t* dst = out + static_cast<long long>(blockIdx.y) * row_bytes + begin;
  const int pieces = static_cast<int>((len + kStageBytes - 1) / kStageBytes);

  for (int s = 0; s < kStages; ++s) mbar_init(&bar[s]);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");

  auto piece_bytes = [&](int i) {
    return static_cast<uint32_t>(
        min(static_cast<long long>(kStageBytes),
            len - static_cast<long long>(i) * kStageBytes));
  };
  auto load = [&](int i) {
    const int s = i % kStages;
    const uint32_t n = piece_bytes(i);
    mbar_expect_tx(&bar[s], n);
    bulk_load(stage + s * kStageBytes,
              src + static_cast<long long>(i) * kStageBytes, n, &bar[s]);
  };

  for (int i = 0; i < min(pieces, kStages); ++i) load(i);
  for (int i = 0; i < pieces; ++i) {
    const int s = i % kStages;
    mbar_wait(&bar[s], (i / kStages) & 1);  // the stage's use count's parity
    bulk_store(dst + static_cast<long long>(i) * kStageBytes,
               stage + s * kStageBytes, piece_bytes(i));
    // refill the stage the previous store read, once it has read it (the
    // store just issued may still be reading its own stage)
    const int next = i - 1 + kStages;
    if (i >= 1 && next < pieces) {
      bulk_wait_read<1>();
      load(next);
    }
  }
  // the stores must finish reading before the block's shared memory goes
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

int g_sms = 0;  // the SM count and the shared-memory opt-in, set on first use

}  // namespace

// bank [T, row_bytes] and out [n_idx, row_bytes], both 16-byte aligned with
// row_bytes a multiple of 16; idx [n_idx] int32, in range, n_idx <= 65535.
// Returns the cudaError_t of the launch.
extern "C" int fvt_bank_gather(const void* bank, const void* idx, void* out,
                               int n_idx, long long row_bytes, void* stream) {
  if (g_sms == 0) {
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(bank_gather_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    g_sms = sms;
  }
  // enough blocks to give every SM kBlocksPerSm, but no chunk under a stage
  const long long want = (static_cast<long long>(g_sms) * kBlocksPerSm +
                          n_idx - 1) / n_idx;
  const long long most = (row_bytes + kStageBytes - 1) / kStageBytes;
  const long long splits = want < most ? want : most;
  // chunks of a multiple of 16 bytes keep every bulk copy aligned
  const long long chunk = ((row_bytes + splits - 1) / splits + 15) / 16 * 16;
  const long long blocks = (row_bytes + chunk - 1) / chunk;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(n_idx));
  bank_gather_kernel<<<grid, 32, kSmemBytes,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bank), static_cast<const int*>(idx),
      static_cast<uint8_t*>(out), row_bytes, chunk);
  return static_cast<int>(cudaGetLastError());
}
