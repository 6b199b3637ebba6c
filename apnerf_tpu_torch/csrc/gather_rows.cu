// The backward of a row gather, summed in a fixed order without atomics.
//
// Replaces no Pallas kernel. Its JAX counterpart is XLA's transpose of
// take_along_axis / take_onehot (apnerf_tpu/models/propnet.py:119-125,
// apnerf_tpu/ops/pdf.py:74), which XLA sums deterministically. PyTorch's
// own backward of gather on the card is scatter_add_, whose atomicAdd
// order changes from run to run; in the proposal loss many cotangents of
// a row land on one of its 65 bins, so the flagship's gradients, and then
// its whole run, did not repeat for a given seed. This kernel computes
//
//   out[r, k] = sum over lists L in (a, b), then over q ascending with
//               idx_L[r, q] = k, of g_L[r, q]
//
// adding each term to the sum so far, in that order: the order of the
// CPU's sequential scatter_add_ over list a, then over list b, so it
// matches that plain version bit for bit, for any index order. An index
// outside [0, n_bins) adds nothing (the forward gather refuses it first).
//
// What bounds it on an H100: device memory, and at the port's shapes the
// launch floor. It reads each cotangent (4 B) and index (8 B) once and
// writes each output once: at [2048, 128] x 2 into 65 bins 6.8 MB, 2.0 us
// at 3.35 TB/s. A row's sums are a chain of dependent adds (the order is
// the result), so the design keeps every row's chain in flight at once,
// each link short, and the reads coalesced:
//
// - 16 rows a block (128 blocks for 2048 rows: every SM has one), one
//   thread a row for the sums (its order is the thread's own program
//   order), 128 threads to stage: each warp reads whole rows, lane after
//   lane, of up to two [16, 128] tiles (list a's and list b's queries, in
//   the order they are summed), every load issued before the first store
//   into shared memory, rows padded to 129 words, so the row-per-thread
//   reads hit 32 banks.
// - A thread takes its row's tile 8 queries at a time into registers and
//   adds each term to its bin's sum in shared memory: a chain of one load,
//   one add and one store a term, without branches. (A running sum kept in
//   registers until the bin changes took twice the device time on an
//   H100, 19.8 against 9.8 us at the flagship's shape: the bin changes at
//   different terms in the warp's different rows, so its branch diverges.)
// - The sums sit in shared memory at [bin][17], so the block's final
//   coalesced write of its 16 output rows (contiguous in device memory)
//   hits 32 banks.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 16;          // rows a block, one summing thread each
constexpr int kThreads = 128;      // threads staging the tiles
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 128;        // queries of a row a tile holds
constexpr int kTiles = 2;          // tiles staged at a time
constexpr int kBatch = 8;          // queries a summing thread holds in registers
constexpr int kTileStride = kChunk + 1;
constexpr int kAccStride = kRows + 1;

__global__ void __launch_bounds__(kThreads)
    gather_rows_bwd_kernel(const float* __restrict__ g_a, const long long* __restrict__ idx_a,
                           const float* __restrict__ g_b, const long long* __restrict__ idx_b,
                           int n_rows, int n_queries, int n_bins, float* __restrict__ out) {
  extern __shared__ float smem[];
  float* acc = smem;                                 // [n_bins][kAccStride]
  float* tile_g = acc + n_bins * kAccStride;         // [kTiles][kRows][kTileStride]
  int* tile_k = reinterpret_cast<int*>(tile_g + kTiles * kRows * kTileStride);
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  const int rows = static_cast<int>(min(static_cast<long long>(kRows), n_rows - row0));
  for (int i = t; i < n_bins * kAccStride; i += kThreads) acc[i] = 0.f;

  // the tiles in the order they are summed: list a's chunks, then list b's
  const int n_chunks = (n_queries + kChunk - 1) / kChunk;
  const int n_tiles = (g_b == nullptr ? 1 : 2) * n_chunks;
  for (int first = 0; first < n_tiles; first += kTiles) {
    __syncthreads();  // the last tiles are consumed (and the sums zeroed)
    // every load of the tiles in flight before the first store: each warp
    // takes rows warp, warp + 4, ..., each lane queries lane, lane + 32, ...
    constexpr int kRowsPerWarp = kRows / kWarps, kPerLane = kChunk / 32;
    float vg[kTiles][kRowsPerWarp][kPerLane];
    long long vk[kTiles][kRowsPerWarp][kPerLane];
#pragma unroll
    for (int slot = 0; slot < kTiles; ++slot) {
      const int tile = first + slot;
      const int list = tile / n_chunks, q0 = tile % n_chunks * kChunk;
      const int qc = tile < n_tiles ? min(kChunk, n_queries - q0) : 0;
      const float* g = list == 0 ? g_a : g_b;
      const long long* idx = list == 0 ? idx_a : idx_b;
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const int r = warp + kWarps * i;
        const long long at = (row0 + r) * n_queries + q0;
#pragma unroll
        for (int j = 0; j < kPerLane; ++j) {
          const int q = lane + 32 * j;
          const bool in = r < rows && q < qc;
          vg[slot][i][j] = in ? g[at + q] : 0.f;
          vk[slot][i][j] = in ? idx[at + q] : -1;
        }
      }
    }
#pragma unroll
    for (int slot = 0; slot < kTiles; ++slot) {
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const int at = (slot * kRows + warp + kWarps * i) * kTileStride;
#pragma unroll
        for (int j = 0; j < kPerLane; ++j) {
          const long long k = vk[slot][i][j];
          tile_g[at + lane + 32 * j] = vg[slot][i][j];
          tile_k[at + lane + 32 * j] = k >= 0 && k < n_bins ? static_cast<int>(k) : -1;
        }
      }
    }
    __syncthreads();
    if (t >= rows) continue;
    for (int slot = 0; slot < kTiles && first + slot < n_tiles; ++slot) {
      const int qc = min(kChunk, n_queries - (first + slot) % n_chunks * kChunk);
      const float* row_g = tile_g + (slot * kRows + t) * kTileStride;
      const int* row_k = tile_k + (slot * kRows + t) * kTileStride;
      for (int q = 0; q < qc; q += kBatch) {
        int ks[kBatch];
        float gs[kBatch];
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          ks[j] = q + j < qc ? row_k[q + j] : -1;
          gs[j] = q + j < qc ? row_g[q + j] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < kBatch; ++j)
          if (ks[j] >= 0) acc[ks[j] * kAccStride + t] += gs[j];
      }
    }
  }
  __syncthreads();
  // the block's output rows are contiguous in device memory
  float* dst = out + row0 * n_bins;
  for (int e = t; e < rows * n_bins; e += kThreads) {
    const int r = e / n_bins, k = e - r * n_bins;
    dst[e] = acc[k * kAccStride + r];
  }
}

size_t smem_bytes(int n_bins) {
  return sizeof(float) *
         (static_cast<size_t>(n_bins) * kAccStride + 2 * kTiles * kRows * kTileStride);
}

}  // namespace

// out [n_rows, n_bins] (f32) from one or two lists of cotangents g [n_rows,
// n_queries] (f32) at indices idx [n_rows, n_queries] (int64), on `stream`;
// g_b and idx_b null for one list. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a call outside those terms (n_bins past what
// shared memory holds); allocates nothing.
extern "C" int apnerf_gather_rows_bwd(const float* g_a, const long long* idx_a,
                                      const float* g_b, const long long* idx_b, int n_rows,
                                      int n_queries, int n_bins, float* out, void* stream) {
  if (n_rows <= 0 || n_queries <= 0 || n_bins <= 0 || g_a == nullptr || idx_a == nullptr ||
      (g_b == nullptr) != (idx_b == nullptr) || out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(n_bins);
  int device = 0, limit = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (smem > static_cast<size_t>(limit)) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gather_rows_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (n_rows + kRows - 1) / kRows;
  gather_rows_bwd_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      g_a, idx_a, g_b, idx_b, n_rows, n_queries, n_bins, out);
  return static_cast<int>(cudaGetLastError());
}
