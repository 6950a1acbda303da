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
// Design: one wave. The grid (splits, rows) never holds more blocks than
// the card holds at once (the driver's occupancy of this kernel times the
// SMs: `fvt_bank_gather_resident`), so no block waits for a second wave.
// Each row is cut into `splits` equal shares of `unit` bytes, grid x:
// share c takes `share` bytes from c * share + unit * min(c, extra), a
// unit more for c < extra, so shares differ by at most a unit: 128 bytes
// (an L2 line) where the rows allow, since a cut inside a 32-byte DRAM
// sector, two blocks storing into it, cost about 3 us at the probe's shape
// (PERF.md, PR 15). Block (c, y) copies share c of rows y, y + rows, ...:
// one row where the K rows fit the wave (splits = resident / K), several
// where K exceeds it (splits 1). The
// wrapper's plan (kernels/bank_gather.py `bank_gather_plan`) computes the
// grid and shares, and mirrors the copies for the tests.
//
// One thread of each block streams its share of each row through a ring of
// kStages shared-memory stages of at most kStageBytes each:
//   - `cp.async.bulk` global -> shared signals the stage's mbarrier with the
//     bytes it delivered (expect_tx / complete_tx);
//   - once that barrier's phase flips, `cp.async.bulk` shared -> global
//     writes the stage out, committed as a bulk group;
//   - a stage is loaded again only after `cp.async.bulk.wait_group.read`
//     says the store that read it has finished reading.
// So kStages - 1 loads and up to two stores are in flight per block. The
// copy moves bytes only: bf16 and f32 banks share it. The ring and the
// stores' L2 policy are constants here; the probe
// (scripts/probe_bank_gather.py --sweep) times patched copies of them.
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
// the stores' lines marked first to leave the L2 (createpolicy
// evict_first): 0.0124 ms against 0.0128 without, at the probe's shape on
// an H100 (scripts/probe_bank_gather.py --sweep; PERF.md, PR 15)
constexpr bool kEvictFirst = true;
constexpr int kMaxDevices = 16;

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
                                           uint32_t bytes, uint64_t policy) {
  if constexpr (kEvictFirst) {
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint [%0], "
        "[%1], %2, %3;\n" ::"l"(dst),
        "r"(smem_addr(src)), "r"(bytes), "l"(policy)
        : "memory");
  } else {
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
            dst),
        "r"(smem_addr(src)), "r"(bytes)
        : "memory");
  }
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
                       int n_idx, long long row_bytes, long long share,
                       int extra, int unit) {
  extern __shared__ __align__(128) uint8_t stage[];
  __shared__ __align__(8) uint64_t bar[kStages];
  if (threadIdx.x != 0) return;
  // the first row's index, asked for before the barriers are set up so
  // that its latency overlaps theirs
  int bank_row = __ldg(idx + blockIdx.y);

  const long long c = blockIdx.x;
  const long long begin =
      c * share + unit * min(c, static_cast<long long>(extra));
  const long long len = share + (c < extra ? unit : 0);
  const int pieces = static_cast<int>((len + kStageBytes - 1) / kStageBytes);

  for (int s = 0; s < kStages; ++s) mbar_init(&bar[s]);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  uint64_t policy = 0;
  if constexpr (kEvictFirst) {
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
                 : "=l"(policy));
  }

  auto piece_bytes = [&](int i) {
    return static_cast<uint32_t>(
        min(static_cast<long long>(kStageBytes),
            len - static_cast<long long>(i) * kStageBytes));
  };
  // piece t of the block (t0 of them before this row) goes through stage
  // t % kStages, that stage's use t / kStages
  int t0 = 0;
  for (int row = blockIdx.y; row < n_idx; row += gridDim.y, t0 += pieces) {
    const uint8_t* src =
        bank + static_cast<long long>(bank_row) * row_bytes + begin;
    // the next row's index, in flight while this row streams
    if (row + gridDim.y < n_idx) bank_row = __ldg(idx + row + gridDim.y);
    uint8_t* dst = out + static_cast<long long>(row) * row_bytes + begin;
    auto load = [&](int i) {
      const int s = (t0 + i) % kStages;
      const uint32_t n = piece_bytes(i);
      mbar_expect_tx(&bar[s], n);
      bulk_load(stage + s * kStageBytes,
                src + static_cast<long long>(i) * kStageBytes, n, &bar[s]);
    };
    for (int i = 0; i < min(pieces, kStages); ++i) load(i);
    for (int i = 0; i < pieces; ++i) {
      const int s = (t0 + i) % kStages;
      mbar_wait(&bar[s], ((t0 + i) / kStages) & 1);
      bulk_store(dst + static_cast<long long>(i) * kStageBytes,
                 stage + s * kStageBytes, piece_bytes(i), policy);
      // refill the stage the previous store read, once it has read it (the
      // store just issued may still be reading its own stage)
      const int next = i - 1 + kStages;
      if (i >= 1 && next < pieces) {
        bulk_wait_read<1>();
        load(next);
      }
    }
    // the next row's first loads take stages the last stores may still read
    bulk_wait_read<0>();
  }
  // the stores must finish before the block's shared memory goes
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Whether each device's kernel has been opened to kSmemBytes of dynamic
// shared memory.
bool g_open[kMaxDevices] = {};

cudaError_t open_smem() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!g_open[dev]) {
    err = cudaFuncSetAttribute(bank_gather_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
    if (err != cudaSuccess) return err;
    g_open[dev] = true;
  }
  return cudaSuccess;
}

}  // namespace

// The blocks of P1's kernel the current card holds at once (the driver's
// occupancy times the SMs), or minus a cudaError_t; ring[0] and ring[1]
// get the stage bytes and the stages.
extern "C" int fvt_bank_gather_resident(int* ring) {
  ring[0] = kStageBytes;
  ring[1] = kStages;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = open_smem();
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, bank_gather_kernel, 32, kSmemBytes);
  }
  return err == cudaSuccess ? per_sm * sms : -static_cast<int>(err);
}

// bank [T, row_bytes] and out [n_idx, row_bytes], both 16-byte aligned with
// row_bytes a multiple of 16; idx [n_idx] int32, in range. The plan
// (kernels/bank_gather.py `bank_gather_plan`): a grid of (splits, rows)
// blocks, rows <= n_idx and <= 65535; share c of a row takes share + unit
// bytes for c < extra and share for the others (unit a multiple of 16
// dividing row_bytes and share), covering the row exactly. grid[0] and grid[1] get the grid launched. A
// plan it does not take returns cudaErrorInvalidValue before any launch;
// else the launch's cudaError_t.
extern "C" int fvt_bank_gather(const void* bank, const void* idx, void* out,
                               int n_idx, long long row_bytes, int splits,
                               int rows, long long share, int extra,
                               int unit, int* grid, void* stream) {
  if (n_idx < 1 || unit < 16 || unit % 16 || row_bytes < unit ||
      row_bytes % unit || splits < 1 || rows < 1 || rows > n_idx ||
      rows > 65535 || share < unit || share % unit || extra < 0 ||
      extra >= splits ||
      static_cast<long long>(splits) * share +
              static_cast<long long>(unit) * extra !=
          row_bytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = open_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 blocks(static_cast<unsigned>(splits), static_cast<unsigned>(rows));
  bank_gather_kernel<<<blocks, 32, kSmemBytes,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bank), static_cast<const int*>(idx),
      static_cast<uint8_t*>(out), n_idx, row_bytes, share, extra, unit);
  grid[0] = static_cast<int>(blocks.x);
  grid[1] = static_cast<int>(blocks.y);
  return static_cast<int>(cudaGetLastError());
}
