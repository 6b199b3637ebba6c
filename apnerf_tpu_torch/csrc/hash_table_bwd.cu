// The hash grid's table gradient, summed in a fixed order without atomic
// float adds and without a sort of the whole index array.
//
// Replaces no Pallas kernel. Its JAX counterpart is the table half of
// _rowgather_interp_bwd in apnerf_tpu/ops/hashgrid.py, XLA's scatter-add of
// the weighted cotangents, which XLA sums deterministically. The kernel
// takes the encoding's backward at that boundary:
//
//   out[k, f] = sum over the terms m with idx[m] = k of w[m] * g[m / K, f]
//
// for k in [0, n_rows) (an index outside adds nothing): g [M / K, F] the
// encoding's cotangent, w [M] the trilinear weights, K = 8 corners a
// position. Without weights (K = 1, w = 1) it is the plain row gather's
// backward. The product is one float32 multiply (__fmul_rn, so that no FMA
// folds it into an add), the one autograd takes.
//
// The index range splits into buckets of 2^b rows, b = row_bits(F), so that
// a bucket's rows fit a block's shared memory. Passes, all on the caller's
// stream (a tile is `tile` consecutive terms, sized so that the partition's
// blocks fill the card once):
//
// 1. count: a block a tile, its terms counted by bucket in shared memory
//    (integer atomics: the same counts in any order) -> counts [tile, bucket].
// 2. scan (three small kernels): each bucket's start, the offsets of its
//    terms from each tile, its segments (SEGMENT terms each) and the slots
//    of the split buckets' partial slices.
// 3. partition: a block a tile, in batches of 2048 terms: the batch's terms
//    formed (w * g) and staged in shared memory, sorted stably by bucket
//    (cub::BlockRadixSort on the batch's span of buckets), each bucket's run
//    placed after the tile's running offset of the bucket and written out in
//    sorted order (a warp's stores on the runs). A bucket's terms land in
//    ascending m, each as its key's low b bits and its term.
// 4. reduce: a block a segment. Its slice of the table, zero, in shared
//    memory; its terms walked in chunks of CHUNK, the next chunk's in
//    registers while this one is summed. Each chunk is summed by its tree
//    (below), each key's sum then added to the slice; a key's first term
//    in the chunk (the least place wins an atomicMax of stamped places in a
//    table of the slice's rows: an integer, whatever order the atomics come
//    in) names the key for the tree. The slice is written once, zeros
//    included, to the table or, where the bucket has more than one
//    segment, to the segment's partial slot.
// 5. combine: a block a split bucket's entries, each the chain of its
//    segments' partial slices in segment order.
//
// The order of adds, emulated bit for bit by hash_table_bwd_emulated in
// apnerf_tpu_torch/ops/cuda/hash_table.py: the terms of a key in ascending
// m. Within a chunk, this tree: sorted (stably) by the order of their key's
// first appearance among them, a thread's ITEMS consecutive items a chain
// that restarts where the key changes, the threads' last runs (head
// flags, (f1, v1) + (f2, v2) = (f1 | f2, f2 ? v2 : v1 + v2)) by a
// Hillis-Steele scan over the 32 lanes of a warp, then a chain over the
// warps; an item whose run began before its thread adds its thread's
// exclusive prefix to its own chain; the run's sum added to the slice.
// Across chunks and segments, a chain. The bits repeat from run to run,
// whatever the scheduling.
//
// What bounds it on an H100: device memory and the block sorts. At the
// ngp+occ step's 33.5M terms into 16 x 2^19 rows of 4 floats the function
// reads idx, w and g and writes the table (470 MB); the kernel reads idx
// twice and writes the partition's terms and reads them again (18 B a
// term): about 1.7 GB. The tree's sort, on the bits of the keys'
// first-appearance ids (more passes the more keys a chunk holds), is most of
// the reduce's time. Claim rounds (a key's first terms chained into the
// slice before the tree) halved the reduce on corners of uniform positions
// but slowed the example trainers' real steps, so they were taken out.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <cub/block/block_radix_sort.cuh>
#include <cub/block/block_scan.cuh>

namespace {

constexpr int kThreads = 256;              // threads of a reduce block
constexpr int kItems = 4;                  // sorted items a thread
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = kThreads * kItems;  // terms a chunk
constexpr int kSegment = 32768;            // terms a reduce block at most
constexpr int kSliceFloats = 16384;        // a bucket's rows x F, at most
constexpr int kGroup = 64;                 // tiles a scan thread
constexpr int kScanThreads = 1024;
constexpr int kPartWarps = 8;              // warps of a count or partition block
constexpr int kPartThreads = kPartWarps * 32;
constexpr int kPartItems = 8;              // terms a partitioning thread a batch
constexpr int kBatch = kPartThreads * kPartItems;
constexpr int kBatchBits = 11;             // a batch's places, below the bucket in the sort
static_assert(kBatch == (1 << kBatchBits), "a batch's places fill kBatchBits");
constexpr int kCountThreads = 1024;        // threads of a count block
constexpr int kAhead = 4;                  // chunks of keys a counting warp loads at once
constexpr int kCombineAhead = 8;           // partial slices a combining thread loads at once
constexpr int kPosBits = 10;               // a chunk's places, below the key in the sort
static_assert(kChunk <= (1 << kPosBits), "a chunk's positions fit kPosBits");
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const int* idx;          // [M]
  const float* g;          // [M / K, F]
  const float* w;          // [M] or null (all 1)
  long long M;
  int K, F, n_rows, bits, n_buckets, tile, n_tiles, n_groups;
  int* counts;             // [n_tiles, n_buckets]: counts, then offsets
  int* gsum;               // [n_groups, n_buckets]
  int* base;               // [n_buckets + 1]: a bucket's first term
  int* total;              // [n_buckets]
  int* seg_first;          // [n_buckets + 1]: a bucket's first segment
  int* slot_first;         // [n_buckets + 1]: a split bucket's first partial slot
  int* split_list;         // [n_buckets + 1]: the split buckets, their number last
  unsigned short* keys;    // [M]: a term's low key bits, bucket by bucket
  float* terms;            // [M, F]: a term, bucket by bucket
  float* partial;          // [slots, 2^bits, F]
  float* out;              // [n_rows, F]
};

__device__ __forceinline__ int bucket_of(const Args& a, int key) {
  return (key >= 0 && key < a.n_rows) ? (key >> a.bits) : -1;
}

// 1. a block a tile: the tile's terms by bucket (integer adds in shared
// memory, the same counts in any order: one a warp where its 32 terms share a
// bucket, else one a term); each warp loads kAhead chunks of 32 keys before it
// counts them
__global__ void __launch_bounds__(kCountThreads) hash_table_bwd_count_kernel(Args a) {
  extern __shared__ int hist[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long t = blockIdx.x;
  for (int b = threadIdx.x; b < a.n_buckets; b += kCountThreads) hist[b] = 0;
  __syncthreads();
  const long long p0 = t * a.tile, p1 = p0 + a.tile < a.M ? p0 + a.tile : a.M;
  for (long long c0 = p0 + 32 * warp; c0 < p1; c0 += (long long)kCountThreads * kAhead) {
    int key[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const long long p = c0 + (long long)kCountThreads * u + lane;
      key[u] = p < p1 ? a.idx[p] : -1;
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int bucket = bucket_of(a, key[u]);
      if (__all_sync(kFull, bucket == __shfl_sync(kFull, bucket, 0))) {
        if (lane == 0 && bucket >= 0) atomicAdd(&hist[bucket], 32);
      } else if (bucket >= 0) {
        atomicAdd(&hist[bucket], 1);
      }
    }
  }
  __syncthreads();
  int* row = a.counts + t * a.n_buckets;
  for (int b = threadIdx.x; b < a.n_buckets; b += kCountThreads) row[b] = hist[b];
}

// 2a. each (bucket, group of kGroup tiles): the group's count
__global__ void hash_table_bwd_scan_groups_kernel(Args a) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x, grp = blockIdx.y;
  if (b >= a.n_buckets) return;
  const int t1 = min(a.n_tiles, (grp + 1) * kGroup);
  int s = 0;
  for (int t = grp * kGroup; t < t1; ++t) s += a.counts[(long long)t * a.n_buckets + b];
  a.gsum[grp * a.n_buckets + b] = s;
}

// 2b. one block: each bucket's groups' offsets, its total, then the
// exclusive sums over buckets of the totals, the segments, the slots and
// the split buckets (listed in split_list, their number last)
__global__ void __launch_bounds__(kScanThreads) hash_table_bwd_scan_buckets_kernel(Args a) {
  using Scan = cub::BlockScan<int, kScanThreads>;
  __shared__ typename Scan::TempStorage tmp;
  for (int b = threadIdx.x; b < a.n_buckets; b += kScanThreads) {
    int run = 0;
    for (int grp = 0; grp < a.n_groups; ++grp) {
      const int c = a.gsum[grp * a.n_buckets + b];
      a.gsum[grp * a.n_buckets + b] = run;
      run += c;
    }
    a.total[b] = run;
  }
  __syncthreads();
  int carry[4] = {0, 0, 0, 0};
  for (int b0 = 0; b0 < a.n_buckets; b0 += kScanThreads) {
    const int b = b0 + threadIdx.x;
    const int n = b < a.n_buckets ? a.total[b] : 0;
    const int nseg = b < a.n_buckets ? max(1, (n + kSegment - 1) / kSegment) : 0;
    const int v[4] = {n, nseg, nseg > 1 ? nseg : 0, nseg > 1 ? 1 : 0};
    int x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int agg;
      Scan(tmp).ExclusiveSum(v[i], x[i], agg);
      __syncthreads();
      x[i] += carry[i];
      carry[i] += agg;
    }
    if (b < a.n_buckets) {
      a.base[b] = x[0];
      a.seg_first[b] = x[1];
      a.slot_first[b] = x[2];
      if (nseg > 1) a.split_list[x[3]] = b;
    }
  }
  if (threadIdx.x == 0) {
    a.base[a.n_buckets] = carry[0];
    a.seg_first[a.n_buckets] = carry[1];
    a.slot_first[a.n_buckets] = carry[2];
    a.split_list[a.n_buckets] = carry[3];
  }
}

// 2c. each (bucket, group): the tiles' counts become their offsets
__global__ void hash_table_bwd_scan_tiles_kernel(Args a) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x, grp = blockIdx.y;
  if (b >= a.n_buckets) return;
  const int t1 = min(a.n_tiles, (grp + 1) * kGroup);
  int run = a.base[b] + a.gsum[grp * a.n_buckets + b];
  for (int t = grp * kGroup; t < t1; ++t) {
    int* c = a.counts + (long long)t * a.n_buckets + b;
    const int n = *c;
    *c = run;
    run += n;
  }
}

// 3. a block a tile, in batches of kBatch terms (a thread kPartItems
// consecutive ones): the batch staged in shared memory by its places, sorted
// stably by bucket (the place below the bucket in the sort key, on the
// batch's span of buckets), each bucket's run placed after the tile's running
// offset of the bucket, and written out in sorted order, so that a warp's
// stores fall on the buckets' runs: coalesced where a run is long. A bucket's
// terms land in ascending m, whatever the tile.
using PartSort = cub::BlockRadixSort<unsigned int, kPartThreads, kPartItems>;
using PartScan = cub::BlockScan<int, kPartThreads>;

// the staging arrays' slots of a batch's place q, padded so that a thread's
// consecutive places and a warp's consecutive threads fall on distinct
// banks: a word every 32 places, a 16-byte row every 8
constexpr int kBatchPad = kBatch + kBatch / 32;
__device__ __forceinline__ int pad32(int q) { return q + (q >> 5); }
__device__ __forceinline__ int pad8(int q) { return q + (q >> 3); }
// floats a partition block stages its batch's terms in: rows of 4 are
// loaded ahead and formed as the batch is loaded; any other term as it is
// written out, from its row of g, which the load brought into L2
__host__ __device__ constexpr int stage_floats(int F) {
  return F == 4 ? 4 * (kBatch + kBatch / 8) : 0;
}

// F floats of the term at position p: w[p] * g[p / K] (one float32 multiply
// each), or g[p] without weights
__device__ __forceinline__ void form_term(const Args& a, long long p, float* dst) {
  const float* src = a.g + (a.w ? p / a.K : p) * a.F;
  if (a.F == 4) {
    const float4 x = *reinterpret_cast<const float4*>(src);
    const float w = a.w ? a.w[p] : 1.f;
    *reinterpret_cast<float4*>(dst) =
        a.w ? make_float4(__fmul_rn(w, x.x), __fmul_rn(w, x.y), __fmul_rn(w, x.z), __fmul_rn(w, x.w))
            : x;
    return;
  }
  for (int f = 0; f < a.F; ++f) dst[f] = a.w ? __fmul_rn(a.w[p], src[f]) : src[f];
}

// a thread's kPartItems consecutive terms of a batch, loaded ahead: the
// keys, the weights and, at F = 4, the rows of g (kRows: 1 where the items
// share a row, w * g with K a multiple of kPartItems; else one an item)
template <int kRows>
struct Raw {
  int k[kPartItems];
  float w[kPartItems];
  float4 g[kRows];
};

template <int kRows>
__device__ __forceinline__ void load_raw(const Args& a, long long b0, long long p1,
                                         Raw<kRows>& r) {
  const long long p = b0 + threadIdx.x * kPartItems;
  if (p + kPartItems <= p1) {  // whole: 16-byte loads (idx and w 16-byte aligned, p of 8)
#pragma unroll
    for (int i = 0; i < kPartItems; i += 4) {
      const int4 k = __ldg(reinterpret_cast<const int4*>(a.idx + p + i));
      r.k[i] = k.x; r.k[i + 1] = k.y; r.k[i + 2] = k.z; r.k[i + 3] = k.w;
      const float4 w = a.w ? __ldg(reinterpret_cast<const float4*>(a.w + p + i))
                           : make_float4(1.f, 1.f, 1.f, 1.f);
      r.w[i] = w.x; r.w[i + 1] = w.y; r.w[i + 2] = w.z; r.w[i + 3] = w.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kPartItems; ++i) {
      r.k[i] = p + i < p1 ? __ldg(a.idx + p + i) : -1;
      r.w[i] = (p + i < p1 && a.w) ? __ldg(a.w + p + i) : 1.f;
    }
  }
  if (a.F == 4) {
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      if (p + i < p1)
        r.g[i] = __ldg(reinterpret_cast<const float4*>(a.g) + (a.w ? (p + i) / a.K : p + i));
  } else if (p < p1) {  // the rows into L2, for the write-out
    const long long last = min(p + kPartItems, p1) - 1;
    const char* lo = reinterpret_cast<const char*>(a.g + (a.w ? p / a.K : p) * a.F);
    const char* hi = reinterpret_cast<const char*>(a.g + ((a.w ? last / a.K : last) + 1) * a.F);
    for (const char* c = lo; c < hi; c += 128) asm volatile("prefetch.global.L2 [%0];" ::"l"(c));
  }
}

template <int kRows>
__global__ void __launch_bounds__(kPartThreads) hash_table_bwd_partition_kernel(Args a) {
  extern __shared__ __align__(16) float part_smem[];
  __shared__ union {
    typename PartSort::TempStorage sort;
    typename PartScan::TempStorage scan;
  } tmp;
  __shared__ int edge_bucket[2][kPartThreads];  // each thread's first and last sorted bucket
  __shared__ int span[2];  // the batch's least and greatest bucket
  const int nb = a.n_buckets, F = a.F, tid = threadIdx.x;
  const bool staged = F == 4;
  // shared memory: the batch's terms (F = 4: [kBatch + kBatch / 8, 4]), the
  // offsets [nb], each sorted place's destination and source, each place's
  // low key bits [kBatchPad]
  float* s_stage = part_smem;
  int* off = reinterpret_cast<int*>(part_smem + stage_floats(F));
  int* s_dst = off + nb;
  unsigned short* s_src = reinterpret_cast<unsigned short*>(s_dst + kBatchPad);
  unsigned short* s_low = s_src + kBatchPad;
  const long long t = blockIdx.x;
  const int* row = a.counts + t * nb;
  for (int b = tid; b < nb; b += kPartThreads) off[b] = row[b];
  const int low_mask = (1 << a.bits) - 1;
  const long long p0 = t * a.tile, p1 = p0 + a.tile < a.M ? p0 + a.tile : a.M;
  Raw<kRows> raw;  // the batch's terms, loaded while the batch before was sorted
  load_raw(a, p0, p1, raw);
  if (tid == 0) span[0] = INT_MAX, span[1] = -1;
  for (long long b0 = p0; b0 < p1; b0 += kBatch) {
    __syncthreads();  // the batch before is written out; the offsets are loaded
    // the batch sorts on its buckets' span alone: bits enough for the least to
    // the greatest bucket, and one past it for indices out of range
    int lo = INT_MAX, hi = -1;
#pragma unroll
    for (int i = 0; i < kPartItems; ++i) {
      const int bucket = bucket_of(a, raw.k[i]);
      if (bucket >= 0) lo = min(lo, bucket), hi = max(hi, bucket);
    }
    if (hi >= 0) atomicMin(&span[0], lo), atomicMax(&span[1], hi);
    __syncthreads();
    lo = span[1] < 0 ? 0 : span[0];
    const int past = span[1] < 0 ? 0 : span[1] - span[0] + 1;  // the sort's bucket for out of range
    unsigned key[kPartItems];
#pragma unroll
    for (int i = 0; i < kPartItems; ++i) {
      const int q = tid * kPartItems + i;
      const int k = raw.k[i];
      const int bucket = bucket_of(a, k);
      key[i] = ((unsigned)(bucket < 0 ? past : bucket - lo) << kBatchBits) | (unsigned)q;
      s_low[pad32(q)] = (unsigned short)(k & low_mask);
      if (!staged || bucket < 0) continue;
      const float4 x = raw.g[kRows == 1 ? 0 : i];
      const float w = raw.w[i];
      reinterpret_cast<float4*>(s_stage)[pad8(q)] = a.w
          ? make_float4(__fmul_rn(w, x.x), __fmul_rn(w, x.y), __fmul_rn(w, x.z), __fmul_rn(w, x.w))
          : x;
    }
    if (b0 + kBatch < p1) load_raw(a, b0 + kBatch, p1, raw);
    PartSort(tmp.sort).Sort(key, kBatchBits, kBatchBits + 32 - __clz(past));
    int bucket[kPartItems], head_at = 0;
    bool head[kPartItems];
#pragma unroll
    for (int i = 0; i < kPartItems; ++i) {
      const int d = (int)(key[i] >> kBatchBits);
      bucket[i] = d < past ? lo + d : nb;
    }
    edge_bucket[0][tid] = bucket[0];
    edge_bucket[1][tid] = bucket[kPartItems - 1];
    __syncthreads();  // the sort is done with tmp; the edges are written
#pragma unroll
    for (int i = 0; i < kPartItems; ++i) {
      head[i] = i > 0 ? bucket[i] != bucket[i - 1]
                      : (tid == 0 || bucket[0] != edge_bucket[1][tid - 1]);
      if (head[i]) head_at = tid * kPartItems + i;
    }
    // each sorted place's run start: the last head at or before it
    int run_start;
    PartScan(tmp.scan).ExclusiveScan(head_at, run_start, 0, cub::Max());
    const int next = tid + 1 < kPartThreads ? edge_bucket[0][tid + 1] : -1;
    int dst[kPartItems];
#pragma unroll
    for (int i = 0; i < kPartItems; ++i) {
      const int q = tid * kPartItems + i;
      if (head[i]) run_start = q;
      dst[i] = bucket[i] < nb ? off[bucket[i]] + (q - run_start) : -1;
    }
    __syncthreads();  // every offset and the span are read
    if (tid == 0) span[0] = INT_MAX, span[1] = -1;
#pragma unroll
    for (int i = 0; i < kPartItems; ++i) {
      const int q = tid * kPartItems + i;
      const int nk = i + 1 < kPartItems ? bucket[i + 1] : next;
      if (bucket[i] < nb && nk != bucket[i]) off[bucket[i]] = dst[i] + 1;
      s_dst[pad32(q)] = dst[i];
      s_src[pad32(q)] = (unsigned short)(key[i] & ((1u << kBatchBits) - 1u));
    }
    __syncthreads();
    // written out in sorted order, a warp 32 consecutive places
#pragma unroll 2
    for (int r = 0; r < kPartItems; ++r) {
      const int q = tid + kPartThreads * r;
      const int d = s_dst[pad32(q)];
      if (d < 0) continue;
      const int src = s_src[pad32(q)];
      a.keys[d] = s_low[pad32(src)];
      float* out = a.terms + (long long)d * F;
      if (staged) {
        reinterpret_cast<float4*>(out)[0] = reinterpret_cast<const float4*>(s_stage)[pad8(src)];
      } else {
        form_term(a, b0 + src, out);
      }
    }
  }
}

// 4. a block a segment of a bucket, in chunks of kChunk terms, with the
// next chunk's keys and terms loaded into registers while this one is summed.
// Each key's first term in the chunk (the least place, by an atomicMax of a
// stamped place in a table of the slice's rows: an integer, whatever order
// the atomics come in) names the key by its first appearance; the chunk's
// tree sorts the terms by that name (cub::BlockRadixSort, stable), chains
// them in a thread, scans the threads' last runs over a warp's lanes
// (Hillis-Steele) and chains the warps, then adds each key's sum to the
// slice. Features past NF are read from device memory as they are needed.
using BlockSort = cub::BlockRadixSort<unsigned int, kThreads, kItems>;
using BlockScan = cub::BlockScan<int, kThreads>;

// nf of NF floats of a row, 16 bytes a load where rows of F floats allow
template <int NF>
__device__ __forceinline__ void load_row(const float* src, int nf, int F, float (&v)[NF]) {
  if constexpr (NF % 4 == 0) {
    if (nf == NF && F % 4 == 0) {
#pragma unroll
      for (int f = 0; f < NF; f += 4) {
        const float4 x = reinterpret_cast<const float4*>(src)[f / 4];
        v[f] = x.x; v[f + 1] = x.y; v[f + 2] = x.z; v[f + 3] = x.w;
      }
      return;
    }
  }
#pragma unroll
  for (int f = 0; f < NF; ++f) v[f] = f < nf ? src[f] : 0.f;
}

// slice row += y, nf of NF features
template <int NF>
__device__ __forceinline__ void add_row(float* dst, int nf, const float (&y)[NF]) {
  if constexpr (NF == 4) {
    if (nf == 4) {  // the row one 16-byte load and store
      float4 o = *reinterpret_cast<float4*>(dst);
      o.x = o.x + y[0]; o.y = o.y + y[1]; o.z = o.z + y[2]; o.w = o.w + y[3];
      *reinterpret_cast<float4*>(dst) = o;
      return;
    }
  }
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    if (f < nf) dst[f] = dst[f] + y[f];
  }
}

// A chunk's claims: each item in `left` offers its stamped place (a later
// stamp above any earlier one, a lesser place above a greater) to its row's
// entry of the table; after the barrier the items whose offer stands, one a
// key (its least place), are returned, a bit each.
__device__ __forceinline__ unsigned claim(unsigned* table, const unsigned short (&key)[kItems],
                                          unsigned left, unsigned stamp) {
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    if (left >> i & 1u)
      atomicMax(table + key[i], (stamp << kPosBits) | (kChunk - 1 - (threadIdx.x * kItems + i)));
  }
  __syncthreads();
  unsigned won = 0;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const unsigned mine = (stamp << kPosBits) | (kChunk - 1 - (threadIdx.x * kItems + i));
    if ((left >> i & 1u) && table[key[i]] == mine) won |= 1u << i;
  }
  return won;
}

// a chunk's keys and the first NF features of its terms, blocked: thread t
// the places t * kItems + i; R past the chunk's terms
template <int NF>
__device__ __forceinline__ void load_chunk(const Args& a, long long at, int n, int nf, int R,
                                           unsigned short (&k)[kItems],
                                           float (&v)[kItems][NF]) {
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int q = threadIdx.x * kItems + i;
    k[i] = q < n ? a.keys[at + q] : (unsigned short)R;
    if (q < n) {
      load_row<NF>(a.terms + (at + q) * a.F, nf, a.F, v[i]);
    } else {
#pragma unroll
      for (int f = 0; f < NF; ++f) v[i][f] = 0.f;
    }
  }
}

template <int NF>
__global__ void __launch_bounds__(kThreads) hash_table_bwd_reduce_kernel(Args a) {
  extern __shared__ float smem[];
  __shared__ typename BlockSort::TempStorage sort_tmp;
  __shared__ typename BlockScan::TempStorage scan_tmp;
  __shared__ int first_key[kThreads], last_key[kThreads];
  __shared__ unsigned short id_key[kChunk];  // the tree's keys by their first appearance
  __shared__ int warp_flag[kWarps];
  __shared__ float warp_sum[kWarps][NF];

  const int s = blockIdx.x;
  if (s >= a.seg_first[a.n_buckets]) return;
  int lo = 0, hi = a.n_buckets;  // the bucket b with seg_first[b] <= s < seg_first[b + 1]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (a.seg_first[mid] <= s) lo = mid; else hi = mid;
  }
  const int b = lo, j = s - a.seg_first[b], nseg = a.seg_first[b + 1] - a.seg_first[b];
  const int R = 1 << a.bits, F = a.F, nf0 = min(NF, F);
  const int rows = min(R, a.n_rows - b * R);
  const long long seg0 = (long long)a.base[b] + (long long)j * kSegment;
  const int n_seg = min(kSegment, a.total[b] - j * kSegment);

  float* slice = smem;                                          // [R, F]
  unsigned* table = reinterpret_cast<unsigned*>(smem + R * F);  // [R]: stamped places
  float* stage = smem + R * (F + 1);                            // [kChunk, NF]: the tree's terms
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int e = tid; e < rows * F; e += kThreads) slice[e] = 0.f;
  for (int e = tid; e < R; e += kThreads) table[e] = 0u;
  unsigned stamp = 0;

  unsigned short nk[kItems];
  float nv[kItems][NF];
  if (n_seg > 0) load_chunk<NF>(a, seg0, min(kChunk, n_seg), nf0, R, nk, nv);
  for (int c0 = 0; c0 < n_seg; c0 += kChunk) {
    const long long at = seg0 + c0;
    unsigned short key[kItems];
    float v[kItems][NF];
    unsigned left = 0;  // the chunk's terms, a bit each
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      key[i] = nk[i];
#pragma unroll
      for (int f = 0; f < NF; ++f) v[i][f] = nv[i][f];
      left |= (key[i] < R ? 1u : 0u) << i;
    }
    if (c0 + kChunk < n_seg)
      load_chunk<NF>(a, at + kChunk, min(kChunk, n_seg - c0 - kChunk), nf0, R, nk, nv);
    __syncthreads();  // the chunk before is done with the slice, the table and the stage
    // each key's first term (the least place) wins its row's claim
    const unsigned won = claim(table, key, left, ++stamp);
    __syncthreads();  // every claim is read before the tree names the keys

    // the chunk's tree over its terms, the places past them as padding: each
    // key named by the order of its first appearance
    int first, n_ids;
    BlockScan(scan_tmp).ExclusiveSum(__popc(won), first, n_ids);
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      if (!(won >> i & 1u)) continue;
      const int id = first + __popc(won & ((1u << i) - 1u));
      table[key[i]] = (unsigned)id;
      id_key[id] = key[i];
    }
    __syncthreads();
    unsigned k[kItems], pos[kItems];
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const unsigned id = (left >> i & 1u) ? table[key[i]] : (unsigned)n_ids;  // padding last
      k[i] = (id << kPosBits) | (unsigned)(tid * kItems + i);
#pragma unroll
      for (int f = 0; f < NF; ++f) stage[(tid * kItems + i) * NF + f] = v[i][f];
    }
    BlockSort(sort_tmp).Sort(k, kPosBits, kPosBits + 32 - __clz(n_ids));
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      pos[i] = k[i] & ((1u << kPosBits) - 1u);
      k[i] >>= kPosBits;
    }
    first_key[tid] = (int)k[0];
    last_key[tid] = (int)k[kItems - 1];
    bool h[kItems];  // head flags: the item's key differs from the item before
    __syncthreads();
    h[0] = tid == 0 || (int)k[0] != last_key[tid - 1];
#pragma unroll
    for (int i = 1; i < kItems; ++i) h[i] = k[i] != k[i - 1];
    const int next = tid + 1 < kThreads ? first_key[tid + 1] : -1;
    bool flag = false;
#pragma unroll
    for (int i = 0; i < kItems; ++i) flag |= h[i];

    for (int f0 = 0; f0 < F; f0 += NF) {
      const int nf = min(NF, F - f0);
      if (f0 > 0) __syncthreads();  // the pass before is done with warp_sum
      // each thread's chain over its items
      float acc[kItems][NF];
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        float u[NF];
        if (k[i] >= (unsigned)n_ids) {
#pragma unroll
          for (int f = 0; f < NF; ++f) u[f] = 0.f;
        } else if (f0 == 0) {
          load_row<NF>(stage + pos[i] * NF, NF, NF, u);
        } else {
          load_row<NF>(a.terms + (at + pos[i]) * F + f0, nf, F, u);
        }
#pragma unroll
        for (int f = 0; f < NF; ++f) acc[i][f] = (i == 0 || h[i]) ? u[f] : acc[i - 1][f] + u[f];
      }
      // the threads' last runs over the warp's lanes
      bool fl = flag;
      float sum[NF];
#pragma unroll
      for (int f = 0; f < NF; ++f) sum[f] = acc[kItems - 1][f];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const bool fu = __shfl_up_sync(kFull, fl, d);
#pragma unroll
        for (int f = 0; f < NF; ++f) {
          const float u = __shfl_up_sync(kFull, sum[f], d);
          if (lane >= d && !fl) sum[f] = u + sum[f];
        }
        if (lane >= d) fl = fl || fu;
      }
      if (lane == 31) {
        warp_flag[warp] = fl;
#pragma unroll
        for (int f = 0; f < NF; ++f) warp_sum[warp][f] = sum[f];
      }
      const bool fx = __shfl_up_sync(kFull, fl, 1);
      float ex[NF];
#pragma unroll
      for (int f = 0; f < NF; ++f) ex[f] = __shfl_up_sync(kFull, sum[f], 1);
      __syncthreads();
      float x[NF];
      if (!h[0]) {
        // the chain over the warps before this one
        float carry[NF];
#pragma unroll
        for (int f = 0; f < NF; ++f) carry[f] = 0.f;
        for (int w = 0; w < warp; ++w) {
#pragma unroll
          for (int f = 0; f < NF; ++f)
            carry[f] = (w == 0 || warp_flag[w]) ? warp_sum[w][f] : carry[f] + warp_sum[w][f];
        }
        // the thread's exclusive prefix
#pragma unroll
        for (int f = 0; f < NF; ++f)
          x[f] = lane == 0 ? carry[f] : ((warp > 0 && !fx) ? carry[f] + ex[f] : ex[f]);
      }
      bool cont = true;
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        cont = cont && !h[i];
        const int nk_i = i + 1 < kItems ? k[i + 1] : next;
        if (k[i] >= (unsigned)n_ids || nk_i == (int)k[i]) continue;  // padding, or not a run's end
        float y[NF];
#pragma unroll
        for (int f = 0; f < NF; ++f) y[f] = cont ? x[f] + acc[i][f] : acc[i][f];
        add_row<NF>(slice + id_key[k[i]] * F + f0, nf, y);
      }
    }
  }
  __syncthreads();
  float* dst = nseg > 1
      ? a.partial + ((long long)a.slot_first[b] + j) * R * F
      : a.out + (long long)b * R * F;
  for (int e = tid; e < rows * F; e += kThreads) dst[e] = slice[e];
}

// 5. a block a split bucket's 256 entries: each the chain of the segments'
// partial slices in segment order (kCombineAhead loads issued together)
__global__ void __launch_bounds__(256) hash_table_bwd_combine_kernel(Args a) {
  const long long RF = (long long)a.F << a.bits;
  const long long e = (long long)blockIdx.x * 256 + threadIdx.x;
  for (int s = blockIdx.y; s < a.split_list[a.n_buckets]; s += gridDim.y) {
    const int b = a.split_list[s];
    const int nseg = a.seg_first[b + 1] - a.seg_first[b];
    if (e >= min(RF, (long long)(a.n_rows - b * (1 << a.bits)) * a.F)) continue;
    const float* src = a.partial + a.slot_first[b] * RF + e;
    float acc = src[0];
    int q = 1;
    for (; q + kCombineAhead <= nseg; q += kCombineAhead) {
      float v[kCombineAhead];
#pragma unroll
      for (int u = 0; u < kCombineAhead; ++u) v[u] = src[(q + u) * RF];
#pragma unroll
      for (int u = 0; u < kCombineAhead; ++u) acc = acc + v[u];
    }
    for (; q < nseg; ++q) acc = acc + src[q * RF];
    a.out[b * RF + e] = acc;
  }
}

// the dynamic shared memory a launch asks for (over 48 KB with the static,
// only once allowed)
template <typename Kernel>
cudaError_t allow_smem(Kernel k, size_t bytes) {
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int NF>
cudaError_t launch_reduce(const Args& a, unsigned blocks, cudaStream_t s) {
  const size_t bytes = ((size_t)(1 << a.bits) * (a.F + 1) + (size_t)kChunk * NF) * sizeof(float);
  cudaError_t err = allow_smem(hash_table_bwd_reduce_kernel<NF>, bytes);
  if (err != cudaSuccess) return err;
  hash_table_bwd_reduce_kernel<NF><<<blocks, kThreads, bytes, s>>>(a);
  return cudaGetLastError();
}

// shared memory of a partition block
size_t partition_bytes(int F, int n_buckets) {
  return (size_t)stage_floats(F) * sizeof(float) + (size_t)n_buckets * sizeof(int) +
         (size_t)kBatchPad * (sizeof(int) + 2 * sizeof(short));
}

}  // namespace

// The partition blocks the card holds at once, for F features and n_buckets
// buckets, a row of g for each thread's terms (one_row: w * g with K a
// multiple of 8) or one each: the host sizes its tiles so that they fill the
// card once.
extern "C" int apnerf_hash_table_bwd_slots(int F, int n_buckets, int one_row) {
  const size_t bytes = partition_bytes(F, n_buckets);
  const auto kernel = one_row ? hash_table_bwd_partition_kernel<1>
                              : hash_table_bwd_partition_kernel<kPartItems>;
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      allow_smem(kernel, bytes) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kPartThreads, bytes) !=
          cudaSuccess)
    return -1;
  return sms * per_sm;
}

extern "C" int apnerf_hash_table_bwd(const void* idx, const void* g, const void* w, long long M,
                                     int K, int F, int n_rows, int bits, int n_buckets, int tile,
                                     void* ws_int, void* keys, void* terms, void* partial,
                                     void* out, void* stream) {
  if (M <= 0 || F <= 0) return 0;
  Args a;
  a.idx = static_cast<const int*>(idx);
  a.g = static_cast<const float*>(g);
  a.w = static_cast<const float*>(w);
  a.M = M;
  a.K = K;
  a.F = F;
  a.n_rows = n_rows;
  a.bits = bits;
  a.n_buckets = n_buckets;
  a.tile = tile;
  a.n_tiles = (int)((M + tile - 1) / tile);
  a.n_groups = (a.n_tiles + kGroup - 1) / kGroup;
  int* ws = static_cast<int*>(ws_int);
  a.counts = ws;
  a.gsum = a.counts + (long long)a.n_tiles * n_buckets;
  a.base = a.gsum + (long long)a.n_groups * n_buckets;
  a.total = a.base + n_buckets + 1;
  a.seg_first = a.total + n_buckets;
  a.slot_first = a.seg_first + n_buckets + 1;
  a.split_list = a.slot_first + n_buckets + 1;
  a.keys = static_cast<unsigned short*>(keys);
  a.terms = static_cast<float*>(terms);
  a.partial = static_cast<float*>(partial);
  a.out = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t count_bytes = (size_t)n_buckets * sizeof(int);
  const bool one_row = w && K % kPartItems == 0;
  const size_t part_bytes = partition_bytes(F, n_buckets);
  const dim3 scan_grid((n_buckets + 255) / 256, a.n_groups);
  const auto partition = one_row ? hash_table_bwd_partition_kernel<1>
                                 : hash_table_bwd_partition_kernel<kPartItems>;
  cudaError_t err = allow_smem(hash_table_bwd_count_kernel, count_bytes);
  if (err == cudaSuccess) err = allow_smem(partition, part_bytes);
  if (err != cudaSuccess) return (int)err;
  hash_table_bwd_count_kernel<<<a.n_tiles, kCountThreads, count_bytes, s>>>(a);
  hash_table_bwd_scan_groups_kernel<<<scan_grid, 256, 0, s>>>(a);
  hash_table_bwd_scan_buckets_kernel<<<1, kScanThreads, 0, s>>>(a);
  hash_table_bwd_scan_tiles_kernel<<<scan_grid, 256, 0, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  partition<<<a.n_tiles, kPartThreads, part_bytes, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long max_split = (M + kSegment - 1) / kSegment;  // a split bucket has > kSegment
  const unsigned blocks = (unsigned)(n_buckets + max_split);
  if (F == 1) err = launch_reduce<1>(a, blocks, s);
  else if (F == 2) err = launch_reduce<2>(a, blocks, s);
  else if (F <= 4) err = launch_reduce<4>(a, blocks, s);
  else err = launch_reduce<8>(a, blocks, s);
  if (err != cudaSuccess) return (int)err;
  const dim3 combine_grid((unsigned)((((long long)F << bits) + 255) / 256),
                          (unsigned)min((long long)min(n_buckets, 64), max_split));
  hash_table_bwd_combine_kernel<<<combine_grid, 256, 0, s>>>(a);
  return (int)cudaGetLastError();
}
