// K2: row gather out[i] = bank[idx[i]] for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_copy_kernel`
// (flash_vstream_tpu/kernels/gather_rows.py:23, launched by `_pallas_gather`),
// which copies one [P, D] row per scalar-prefetched index with one DMA each.
//
// Design. A 2-D grid: blockIdx.y is the output row, which reads its own
// index (the TPU's scalar prefetch becomes one load per block); the blocks
// along x split that row and copy it with 16-byte vector loads and stores,
// grid-striding when the row is longer than one pass. The copy is bytes
// only, so bf16 and f32 banks share it.
//
// What bounds it on this card: device-memory bandwidth. The DAM gather moves
// 30 rows of 256 x 1280 bf16 (19.7 MB read, 19.7 MB written) per ingest;
// with every load 16 bytes wide and neighbouring threads on neighbouring
// addresses, each warp moves 512 contiguous bytes per instruction.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocksPerRow = 64;

__global__ void __launch_bounds__(kThreads)
    gather_rows_kernel(const uint4* __restrict__ bank,
                       const int* __restrict__ idx, uint4* __restrict__ out,
                       long long row_vecs) {
  const long long src = static_cast<long long>(__ldg(idx + blockIdx.y)) *
                        row_vecs;
  const long long dst = static_cast<long long>(blockIdx.y) * row_vecs;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < row_vecs; i += step) {
    out[dst + i] = bank[src + i];
  }
}

}  // namespace

// bank [T, row_bytes] and out [n_idx, row_bytes], both 16-byte aligned with
// row_bytes a multiple of 16; idx [n_idx] int32, in range. Returns the
// cudaError_t of the launch.
extern "C" int fvt_gather_rows(const void* bank, const void* idx, void* out,
                               int n_idx, long long row_bytes, void* stream) {
  const long long row_vecs = row_bytes / 16;
  long long bx = (row_vecs + kThreads - 1) / kThreads;
  if (bx > kMaxBlocksPerRow) bx = kMaxBlocksPerRow;
  const dim3 grid(static_cast<unsigned>(bx), static_cast<unsigned>(n_idx));
  gather_rows_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(bank), static_cast<const int*>(idx),
      static_cast<uint4*>(out), row_vecs);
  return static_cast<int>(cudaGetLastError());
}
