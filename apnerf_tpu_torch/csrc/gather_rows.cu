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
// adding each term to the sum so far, from 0.f, in that order: the order of
// the CPU's sequential scatter_add_ over list a, then over list b, so it
// matches that plain version bit for bit, for any index order. An index
// outside [0, n_bins) adds nothing (the forward gather refuses it first).
//
// What bounds it on an H100: device memory. It reads each cotangent (4 B)
// and index (8 B) once and writes each output once: at [2048, 128] x 2
// into 65 bins 6.8 MB, 2.0 us at 3.35 TB/s. The design keeps every chain
// of dependent adds as short as one bin's terms, and the row's reads in
// flight together:
//
// - One warp a row, 32 queries a chunk (lane l query q0 + l), 4 chunks
//   loaded at a time, the next 4 in flight while these are summed; both
//   lists' first chunks are loaded before anything is summed.
// - Every caller of the port passes rows sorted ascending (searchsorted of
//   sorted queries into sorted edges, clamped). There each bin's terms are
//   one run of consecutive queries in each list. A lane whose bin differs
//   from the lane before starts a run; a ballot of the lanes where the bin
//   changes gives each start its run's last lane, and the start lane adds
//   its run's terms in order, read from the other lanes by shuffles (as
//   many rounds as the chunk's longest run). A run that reaches the
//   chunk's last lane is carried on into the next chunk. List a's sums are
//   written to the row's output (zeroed first, for the bins without a
//   term); list b's runs start from what is there, read for a whole group
//   of chunks at once. (Keeping the row's sums in shared memory and
//   writing the output once, and unrolling the shuffles 4 deep, moved the
//   flagship's 6.4 us of device time by 0.1 us on an H100: not kept.)
// - A row that is not sorted (a warp-wide check of idx[q] < idx[q - 1]
//   as the chunks are summed) is summed again in the serial order: each
//   lane takes a bin and walks both lists whole, adding its bin's terms.
//   The same launch, the same bits, slower.
// - Nothing grows with the bins or the queries: a row of any length is a
//   loop over its chunks, an output of any width a loop over its bins.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;          // rows a block, a warp each
constexpr int kGroup = 4;          // chunks of 32 queries loaded at a time
constexpr int kGroupQueries = 32 * kGroup;
constexpr unsigned kFull = 0xffffffffu;

// A lane's query of a chunk: its bin (clamped to [-1, n_bins], which keeps
// the order; n_bins past the row's end) and its cotangent.
struct Term {
  int k;
  float v;
};

struct Group {
  Term t[kGroup];
};

__device__ __forceinline__ Group load_group(const long long* __restrict__ idx,
                                            const float* __restrict__ g, int q0, int Q,
                                            int n_bins, int lane) {
  Group out;
#pragma unroll
  for (int j = 0; j < kGroup; ++j) {
    const int q = q0 + 32 * j + lane;
    out.t[j] = {n_bins, 0.f};
    if (q < Q) {
      const long long k = idx[q];
      out.t[j] = {k < 0 ? -1 : (k >= n_bins ? n_bins : static_cast<int>(k)), g[q]};
    }
  }
  return out;
}

// Adds one list's runs into the row's output o, list a (kFirst) from 0.f and
// list b from o, the row's first group given; false, with the row half
// summed, where the list is not sorted.
template <bool kFirst>
__device__ bool sum_runs(const long long* __restrict__ idx, const float* __restrict__ g, int Q,
                         int n_bins, float* o, int lane, Group cur) {
  float carry = 0.f;  // the sum so far of the run that reaches past the chunk before
  int carry_bin = -2;  // that run's bin (-2 before the first chunk)
  for (int q0 = 0; q0 < Q; q0 += kGroupQueries) {
    Group nxt;
    if (q0 + kGroupQueries < Q) nxt = load_group(idx, g, q0 + kGroupQueries, Q, n_bins, lane);
    float from[kGroup];  // list b: the output so far at each lane's bin
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const int k = cur.t[j].k;
      from[j] = !kFirst && k >= 0 && k < n_bins ? o[k] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      if (q0 + 32 * j >= Q) break;
      const Term t = cur.t[j];
      int prev = __shfl_up_sync(kFull, t.k, 1);
      if (lane == 0) prev = carry_bin;
      if (__any_sync(kFull, t.k < prev)) return false;
      if (lane == 0 && carry_bin >= 0 && carry_bin < n_bins && t.k != carry_bin)
        o[carry_bin] = carry;  // the carried run ended with the last chunk
      const bool start = lane == 0 || t.k != prev;
      const int next = __shfl_down_sync(kFull, t.k, 1);
      const unsigned ends = __ballot_sync(kFull, lane == 31 || t.k != next);
      const int len = __ffs(ends >> lane);  // from this lane to its run's last lane
      const int rounds = __reduce_max_sync(kFull, start ? len : 0);
      float s = lane == 0 && t.k == carry_bin ? carry : from[j];
      for (int i = 0; i < rounds; ++i) {
        const float v = __shfl_sync(kFull, t.v, min(lane + i, 31));
        if (start && i < len) s += v;
      }
      const unsigned starts = __ballot_sync(kFull, start);
      carry = __shfl_sync(kFull, s, 31 - __clz(starts));
      carry_bin = __shfl_sync(kFull, t.k, 31);
      if (start && lane + len < 32 && t.k >= 0 && t.k < n_bins) o[t.k] = s;
    }
    cur = nxt;
  }
  if (lane == 0 && carry_bin >= 0 && carry_bin < n_bins) o[carry_bin] = carry;
  return true;
}

// The serial order for a row that is not sorted: lane l takes bins l, l +
// 32, ... and walks both lists, adding its bin's terms in order.
__device__ void sum_serial(const long long* const* idx, const float* const* g, int lists, int Q,
                           int n_bins, float* o, int lane) {
  for (int k0 = 0; k0 < n_bins; k0 += 32) {
    const int bin = k0 + lane;
    float s = 0.f;
    for (int l = 0; l < lists; ++l) {
      for (int q0 = 0; q0 < Q; q0 += kGroupQueries) {
        const Group grp = load_group(idx[l], g[l], q0, Q, n_bins, lane);
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
          for (int i = 0; i < 32; ++i) {
            const int k = __shfl_sync(kFull, grp.t[j].k, i);
            const float v = __shfl_sync(kFull, grp.t[j].v, i);
            if (k == bin) s += v;  // past the row k is n_bins: no bin's
          }
        }
      }
    }
    if (bin < n_bins) o[bin] = s;
  }
}

__global__ void __launch_bounds__(32 * kWarps)
    gather_rows_bwd_kernel(const float* __restrict__ g_a, const long long* __restrict__ idx_a,
                           const float* __restrict__ g_b, const long long* __restrict__ idx_b,
                           int n_rows, int n_queries, int n_bins, float* __restrict__ out) {
  const int lane = threadIdx.x % 32;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (row >= n_rows) return;  // uniform across the warp
  const int Q = n_queries, lists = g_b == nullptr ? 1 : 2;
  const long long at = row * Q;
  const long long* idx[2] = {idx_a + at, g_b == nullptr ? nullptr : idx_b + at};
  const float* g[2] = {g_a + at, g_b == nullptr ? nullptr : g_b + at};
  // both lists' first chunks in flight before anything is summed
  const Group a0 = load_group(idx[0], g[0], 0, Q, n_bins, lane);
  Group b0;
  if (lists == 2) b0 = load_group(idx[1], g[1], 0, Q, n_bins, lane);
  float* o = out + row * n_bins;
  for (int k = lane; k < n_bins; k += 32) o[k] = 0.f;
  __syncwarp();
  bool sorted = sum_runs<true>(idx[0], g[0], Q, n_bins, o, lane, a0);
  __syncwarp();  // list a's sums are written before list b reads them
  if (sorted && lists == 2) sorted = sum_runs<false>(idx[1], g[1], Q, n_bins, o, lane, b0);
  if (!sorted) {
    __syncwarp();
    sum_serial(idx, g, lists, Q, n_bins, o, lane);
  }
}

}  // namespace

// out [n_rows, n_bins] (f32) from one or two lists of cotangents g [n_rows,
// n_queries] (f32) at indices idx [n_rows, n_queries] (int64), on `stream`;
// g_b and idx_b null for one list. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a call outside those terms; allocates nothing.
extern "C" int apnerf_gather_rows_bwd(const float* g_a, const long long* idx_a,
                                      const float* g_b, const long long* idx_b, int n_rows,
                                      int n_queries, int n_bins, float* out, void* stream) {
  if (n_rows <= 0 || n_queries <= 0 || n_bins <= 0 || g_a == nullptr || idx_a == nullptr ||
      (g_b == nullptr) != (idx_b == nullptr) || out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n_rows + kWarps - 1) / kWarps;
  gather_rows_bwd_kernel<<<blocks, 32 * kWarps, 0, static_cast<cudaStream_t>(stream)>>>(
      g_a, idx_a, g_b, idx_b, n_rows, n_queries, n_bins, out);
  return static_cast<int>(cudaGetLastError());
}
