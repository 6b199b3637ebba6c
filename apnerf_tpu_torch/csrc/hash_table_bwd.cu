// The backward of the hash grid's row gather, summed in a fixed order
// without atomics.
//
// Replaces no Pallas kernel. Its JAX counterpart is XLA's transpose of the
// table gather in apnerf_tpu/ops/hashgrid.py, which XLA sums
// deterministically. PyTorch's index_add_ on the card adds with float
// atomics in an order that changes from run to run, so the NGP fields'
// table gradients, and then their runs, did not repeat for a seed. This
// kernel computes
//
//   out[k, f] = sum over the rows m with idx[m] = k of g[m, f]
//
// for k in [0, n_rows) (an index outside adds nothing), from the indices
// sorted stably (skey, with perm the rows in that order: a library sort,
// itself deterministic), in an order fixed by the sorted positions alone:
//
// - Pass 1, one warp a tile of kTile consecutive sorted positions, 32 at a
//   time (lane l position c0 + l). Each lane reads its key, its row of g
//   through perm, and the chunk is scanned by segments of equal keys
//   (Hillis-Steele over the lanes of a segment: 5 rounds of shuffles).
//   A segment that reaches the chunk's last lane is carried into the next
//   chunk (the carry added first). A finished segment is written once: to
//   out[k] if it lies inside the tile, else to the tile's head (a segment
//   that began in the tile before) or tail (one that goes on into the next
//   tile) slot, a tile that is one key from end to end to its head slot.
// - Pass 2, one thread a tile whose tail goes on and in which its key's
//   run begins: the tail slot, then the following tiles' head slots in
//   order, to the tile where the run ends; the sum is written to out[k].
//
// So a run of any length is a fixed tree within each chunk, a chain over
// the chunks of a tile and a chain over the tiles: the bits repeat from run
// to run, whatever the scheduling, and no sum waits on more than
// 5 + kTile / 32 + (the tiles its run spans) dependent adds. No memory
// grows with the run lengths; the rows' order within a run (ascending,
// from the stable sort) only fixes which term goes where.
//
// What bounds it on an H100: device memory. The gather of g through perm
// reads whole 32-byte sectors for rows of 16 bytes, so at F = 4 about 48 B
// a row move (key, perm, two rows of g), against 20 B that the function
// itself must read.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 1024;       // sorted positions a warp
constexpr int kWarps = 4;         // tiles a block
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const int* skey;        // [M] sorted indices
  const int64_t* perm;    // [M] the row of g at each sorted position
  const float* g;         // [M, F]
  long long M;
  int F;
  int n_rows;
  long long n_tiles;
  float* out;             // [n_rows, F], zero where no row lands
  float* head;            // [n_tiles, F]
  float* tail;            // [n_tiles, F]
  unsigned char* cont;    // [n_tiles]: the tile is one key that goes on both ways
};

__device__ inline void flush(const Args& a, long long t, int key, const float* v, int f0, int nf,
                             bool is_head, bool is_tail) {
  if (key < 0 || key >= a.n_rows) return;
  float* dst = is_head ? a.head + t * a.F
                       : (is_tail ? a.tail + t * a.F : a.out + (long long)key * a.F);
  for (int f = 0; f < nf; ++f) dst[f0 + f] = v[f];
}

// NF features a pass over the tile: F = 1, 2 or 4 in one pass (NF = F, g's
// base 16-byte aligned at 4), any other F in passes of 8
template <int NF>
__global__ void __launch_bounds__(kWarps * 32)
hash_table_bwd_tiles_kernel(Args a) {
  const int lane = threadIdx.x & 31;
  const long long t = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (t >= a.n_tiles) return;
  const long long p0 = t * kTile;
  const long long p1 = p0 + kTile < a.M ? p0 + kTile : a.M;
  const int first = a.skey[p0], last = a.skey[p1 - 1];
  const int prev_key = p0 > 0 ? a.skey[p0 - 1] : -1;
  const int next_key = p1 < a.M ? a.skey[p1] : -1;
  const bool from_prev = p0 > 0 && prev_key == first;
  if (lane == 0) a.cont[t] = first == last && from_prev && p1 < a.M && next_key == last;
  const unsigned below = lane == 31 ? kFull : (2u << lane) - 1u;  // lanes 0..lane

  for (int f0 = 0; f0 < a.F; f0 += NF) {
    const int nf = a.F - f0 < NF ? a.F - f0 : NF;
    bool have_carry = false, carry_touch = false;
    int carry_key = -1;
    float carry[NF];
#pragma unroll
    for (int f = 0; f < NF; ++f) carry[f] = 0.f;
    for (long long c0 = p0; c0 < p1; c0 += 32) {
      const long long p = c0 + lane;
      const bool valid = p < p1;
      const int k = valid ? a.skey[p] : -1;
      float v[NF];
      const long long row = valid ? a.perm[p] : 0;
      if constexpr (NF == 4) {  // F = 4: a row is one 16-byte load
        const float4 x = valid ? reinterpret_cast<const float4*>(a.g)[row]
                               : make_float4(0.f, 0.f, 0.f, 0.f);
        v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
      } else {
#pragma unroll
        for (int f = 0; f < NF; ++f) v[f] = (valid && f < nf) ? a.g[row * a.F + f0 + f] : 0.f;
      }
      // the carry: added first to the chunk's first segment if it has the
      // carry's key, else finished on its own (it ended at the chunk before)
      const int k0 = __shfl_sync(kFull, k, 0);
      const bool joins = have_carry && k0 == carry_key;
      if (have_carry && !joins && lane == 0)
        flush(a, t, carry_key, carry, f0, nf, carry_touch && from_prev, false);
      // segments of equal keys within the chunk, scanned over their lanes
      const int k_up = __shfl_up_sync(kFull, k, 1);
      const unsigned starts = __ballot_sync(kFull, lane == 0 || k != k_up);
      const int s = 31 - __clz(starts & below);
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
        for (int f = 0; f < NF; ++f) {
          const float u = __shfl_up_sync(kFull, v[f], d);
          if (lane - d >= s) v[f] += u;
        }
      }
      if (s == 0 && joins) {
#pragma unroll
        for (int f = 0; f < NF; ++f) v[f] = carry[f] + v[f];
      }
      // whether this lane's segment began at the tile's first position
      const bool touch = s == 0 && (c0 == p0 || (joins && carry_touch));
      const int k_dn = __shfl_down_sync(kFull, k, 1);
      const bool end = valid && (lane == 31 || k_dn != k);
      const bool at_last = p == p1 - 1;
      if (end && !(lane == 31 && !at_last))
        flush(a, t, k, v, f0, nf, touch && from_prev, at_last && next_key == k);
      // the chunk's last segment goes on into the next chunk of the tile
      const bool carry_on = __shfl_sync(kFull, valid && !at_last, 31);
      if (carry_on) {
        carry_key = __shfl_sync(kFull, k, 31);
        carry_touch = __shfl_sync(kFull, touch, 31);
#pragma unroll
        for (int f = 0; f < NF; ++f) carry[f] = __shfl_sync(kFull, v[f], 31);
      }
      have_carry = carry_on;
    }
  }
}

__global__ void hash_table_bwd_runs_kernel(Args a) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= a.n_tiles) return;
  const long long p0 = t * kTile;
  const long long p1 = p0 + kTile < a.M ? p0 + kTile : a.M;
  const int key = a.skey[p1 - 1];
  // only a tile whose last run goes on into the next tile, and begins here
  if (p1 >= a.M || a.skey[p1] != key || a.cont[t] || key < 0 || key >= a.n_rows) return;
  for (int f = 0; f < a.F; ++f) {
    float sum = a.tail[t * a.F + f];
    for (long long u = t + 1; u < a.n_tiles; ++u) {
      sum += a.head[u * a.F + f];
      if (!a.cont[u]) break;
    }
    a.out[(long long)key * a.F + f] = sum;
  }
}

}  // namespace

extern "C" int apnerf_hash_table_bwd(const void* skey, const void* perm, const void* g,
                                     long long M, int F, int n_rows, void* out, void* head,
                                     void* tail, void* cont, void* stream) {
  if (M <= 0 || F <= 0) return 0;
  Args a;
  a.skey = static_cast<const int*>(skey);
  a.perm = static_cast<const int64_t*>(perm);
  a.g = static_cast<const float*>(g);
  a.M = M;
  a.F = F;
  a.n_rows = n_rows;
  a.n_tiles = (M + kTile - 1) / kTile;
  a.out = static_cast<float*>(out);
  a.head = static_cast<float*>(head);
  a.tail = static_cast<float*>(tail);
  a.cont = static_cast<unsigned char*>(cont);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long blocks = (a.n_tiles + kWarps - 1) / kWarps;
  if (F == 1) hash_table_bwd_tiles_kernel<1><<<(unsigned)blocks, kWarps * 32, 0, s>>>(a);
  else if (F == 2) hash_table_bwd_tiles_kernel<2><<<(unsigned)blocks, kWarps * 32, 0, s>>>(a);
  else if (F == 4) hash_table_bwd_tiles_kernel<4><<<(unsigned)blocks, kWarps * 32, 0, s>>>(a);
  else hash_table_bwd_tiles_kernel<8><<<(unsigned)blocks, kWarps * 32, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  hash_table_bwd_runs_kernel<<<(unsigned)((a.n_tiles + 255) / 256), 256, 0, s>>>(a);
  return (int)cudaGetLastError();
}
