// The spectral field on the H100, shared by the kernels that evaluate it
// (fused_field_heads.cu, fused_field_volrend.cu): the whole main field, or
// its trunk alone for the trunk kernels (fused_mlp.py, forward and
// backward). Same math as apnerf_tpu/ops/pallas/fused_field_heads.py::
// _make_field_fwd_kernel and apnerf_tpu/ops/pallas/fused_mlp.py::
// _make_enc_fwd_kernel / _make_fwd_kernel, rows as samples, the two heads
// formed and rounded as two heads:
//
//   proj = 2*pi * (bf16(u) . bf16(W)) + phase;  enc = bf16[cos, sin]
//   trunk: bf16(relu(. @ w + b)) hidden layers, f32 last layer
//   raw = out[0], geo = bf16(out[1:]);  sigma = exp(raw - 1) * in-cube
//   rgb = sigmoid(head_rgb([bf16 SH, geo]));  sem = head_sem(geo)
//
// The phase is formed exactly as the TPU kernels form it: u and W rounded
// to bf16, their K=3 product summed in f32, then scaled and shifted with
// separate roundings. proj reaches ~4.5e4 rad at the production
// frequencies, so the precise sincosf is required. Biases are added in f32
// before the bf16 rounding, as Pallas does.
//
// Widths. The kernels are templates on the trunk width H in {64, 128, 256,
// 512, 1024} (APNERF_TILE_WIDTHS), with heads H/4 wide; a narrower field runs on
// the next instance with its weights zero-padded by the host
// (field_images.py). The first layer's input is not part of the instance:
// it is multiplied one 64-column k-block at a time, a run-time count of
// them (n_kb). The encoding of m frequencies is [cos of m | sin of m],
// zero past 2m: the plain chain's own column order, so the kernel's f32
// sums are the plain chain's, 16-column step by step (a reordered encoding
// changes the sums' rounding, and with it bf16 roundings of the hidden
// layers). The whole field's kernels are instances of a tier too, the
// padded widths of the trunk output and the semantic output, (T_out,
// C_pad) in (16, 64), (32, 128), (48, 256), (64, 1024)
// (APNERF_FIELD_TIERS): a field with 1 + geo <= T_out and classes <= C_pad
// runs on the smallest tier that takes both. The trunk output and the
// heads' first layers are products of that width (T_out / 16 k-steps back
// into the trunk); the heads' input [SH 16 | geo | 0] is one image up to
// T_out = 48 and two at 64, the heads' first layers a k-block each; the
// semantic output is formed 64 columns a slab, C_pad / 64 slabs, each
// product staged and written before the next. Both counts are
// compile-time: a wgmma chain in a loop of run-time length spills (so the
// classes stay capped at the last tier's C_pad: a run-time slab count
// would put the slab loop's wgmma chain in a loop of run-time length).
// Where the encoding fits the tile's buffer it is formed in place
// at once (each sincosf gives a cos and a sin column); a wider one is
// formed block by block into two staging images in turn, block b + 1
// while block b's product runs, one sincosf a column. The trunk kernels'
// input x enters as ceil(din / 64) staged blocks the same way, zero past
// din. An encoding in place of exactly the buffer's images (the shipping
// widths) is a kernel instance of its own (kWhole), whose k-block loop has
// a compile-time count: a wgmma chain in a loop of run-time length (or
// under a run-time guard) costs ptxas spills of the whole tile. The trunk
// alone (K1, K3) writes any output width, 16 columns at a time.
//
// Design. A persistent block per SM: two consumer warpgroups and a
// producer warpgroup of which one thread works (setmaxnreg moves its
// registers to the consumers). Up to H = 256 each consumer warpgroup owns a
// 64-row tile of a 128-row pass and every column; at H = 512 both own the
// one 64-row tile of a pass, and each forms one n = 256 half of every
// trunk layer's columns (an m64n512 accumulator would be 256 registers a
// thread), both halves multiplying the same activation buffer. At H = 1024
// the tile's activation is 16 images (128 KB) and each warpgroup forms its
// 512 columns as two products of n = 256 in turn, over the whole input:
// the first half's bf16 results wait in device memory (64 words a thread,
// L2-resident) until the second is formed, then both go over the input; the ring has one 64
// KB slot, each trunk slab [512, 64] holding both warpgroups' 256 rows of
// one half, each head slab one image, the trunk output one k-block a slab,
// and the first layer's input lies in place (at most 8 k-blocks). Every layer
// is a wgmma product m64 x n whose A operand is the tile's activation
// buffer in shared memory and whose B operand is a weight slab that the
// producer streams through a ring (4 slots, 2 of 64 KB at H = 512, 1 of 64
// KB at 1024) with
// cp.async.bulk and mbarriers (the weights lie in global memory as ready
// tile images, hopper_tile.cuh), so the next slab's copy overlaps this
// slab's product and both warpgroups multiply against every slab. The
// accumulators stay in registers: bias, ReLU and the bf16 rounding are
// applied there and the result goes back, swizzled, over the layer's own
// input as the next A operand (a fresh accumulator is declared as such,
// hopper_tile.cuh::fresh, or ptxas keeps the last pass's values alive).
// Both heads run on the tile's own rows, rgb and semantics as two chains
// of one batch. What a kernel does with a tile's values is its
// epilogue struct: it stages them in shared memory and writes them out as
// 16-byte stores. A kernel with a backward passes a save struct: the
// activations leave as whole tile images by bulk stores (the layout the
// weight-gradient kernel multiplies from) and the ReLU masks as two words
// per thread, in the accumulator's own bit order.
//
// What bounds it: on paper tensor-core math (a row of the shipping field
// costs ~0.45 MFLOP against ~150 bytes). On the card the shipping instance
// reaches about a third of that bound (PERF.md), and a pass of 128 rows
// splits into three parts of about equal size: the trunk's products,
// during which the tensor pipe is busy for one warpgroup or the other; the
// encode, 128 precise sincosf a row, bound by instruction issue; and the
// latency chain of the five small products and epilogues after the trunk.
// The slab ring is not in the way: the kernel took the same time with the
// ring's copies left out. The ring re-reads the weight images from L2 once
// per pass; a faster tile would need a cluster's multicast or more rows a
// block.

#pragma once

#include "hopper_tile.cuh"

// The field's weights as the kernels read them (field_images.py builds
// the buffers). At namespace scope: extern "C" entries take structs that
// hold it.
struct FieldWeights {
  const float* W;      // [3, n_freq]
  const float* phase;  // [n_freq]
  const __nv_bfloat16* wfwd;  // forward slabs
  const __nv_bfloat16* wbwd;  // backward slabs
  const float* bias;          // every layer's bias, padded (bias_offsets)
  unsigned int* keep;         // H = 1024: per block, a layer's first half of bf16 results
                              // [kHwn / 4][256 threads] words (keep_words), else null
  int tile_h;                 // trunk width H: the instance
  int n_hidden;               // trunk hidden layers, 2 or 3
  int geo, n_classes;
  int t_out, c_tile;          // the whole field's tier: trunk output and semantic output, padded
  int n_freq, n_kb;           // frequencies of the encode; the first layer's 64-column k-blocks
  int out;                    // the trunk alone: its output width
};

// The save struct of a kernel that keeps no activation.
struct NoSave {
  static constexpr bool kSaves = false;
};

// the trunk widths H of the tile's kernels
#define APNERF_TILE_WIDTHS(X) X(64) X(128) X(256) X(512) X(1024)
// the whole field's tiers: (tier, T_out, C_pad), the padded widths of the
// trunk output (1 + geo) and of the semantic output (classes)
#define APNERF_FIELD_TIERS(X) X(0, 16, 64) X(1, 32, 128) X(2, 48, 256) X(3, 64, 1024)

// A source that defines APNERF_PARTS before this header is compiled once
// per part p with -DAPNERF_PART=p (ops/cuda/build.py), so that the tile's
// instances compile in parallel: instance (H, tier) in part part_of(H,
// tier), everything else in part 0, which dispatches to the parts' entries
// (name_p0, name_p1, ...; kElsewhere: not an instance of that part).
#ifndef APNERF_PART
#define APNERF_PART 0
#endif
#define APNERF_CAT_(a, b) a##b
#define APNERF_CAT(a, b) APNERF_CAT_(a, b)
#define APNERF_IN_PART(name) APNERF_CAT(name, APNERF_CAT(_p, APNERF_PART))

constexpr int kElsewhere = -1;

constexpr int width_index(int h) {
  return h == 64 ? 0 : h == 128 ? 1 : h == 256 ? 2 : h == 512 ? 3 : 4;
}

template <int kParts>
constexpr int part_of(int h, int tier) {
  return (width_index(h) + 5 * tier) % kParts;
}

// the tier of (T_out, C_pad), or -1
inline int tier_of(int t_out, int c_tile) {
#define APNERF_TIER(T_, TO_, CP_) \
  if (t_out == TO_ && c_tile == CP_) return T_;
  APNERF_FIELD_TIERS(APNERF_TIER)
#undef APNERF_TIER
  return -1;
}

namespace {

using namespace hopper;

constexpr int kShw = 16;       // SH features of a ray direction
constexpr int kRgbPad = 16;    // rgb-head output width, padded
constexpr int kSemChunk = 64;  // semantic-output columns a forward slab (C_pad / 64 slabs)
constexpr int kOutChunk = 16;  // the trunk alone's output columns a forward slab
constexpr float kTwoPi = 6.283185307179586f;

constexpr int kTileRows = 64;
constexpr int kWg = 128;                // threads of a warpgroup
constexpr int kFieldThreads = 3 * kWg;  // two consumer warpgroups and the producer's
// 2 x 128 x 232 + 128 x 40 registers fit the SM's 65,536 at every instance;
// the shipping one needs them (ptxas refused it at 128), the narrower ones
// leave some unused
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kBlockFreqs = 32;             // frequencies of a k-block of the encoding
constexpr int kAlignSlack = 1024;
constexpr int kUTileBytes = kTileRows * 3 * 4;       // a tile's coordinates
constexpr int kYStageBytes = kTileRows * 16 * 4;     // a tile's 16 trunk-output columns, f32

// H = 1024: words a block keeps of a layer's first half (its 256 consumer
// threads' 64 each), a thread's at stride 256
__host__ __device__ constexpr int keep_words(int h) { return h > 512 ? 64 * 256 : 0; }

// the consumers' activation buffers, together: two 64-row tiles of a
// hidden activation up to H = 512 (one at 512), one tile's at 1024
__host__ __device__ constexpr int buf_bytes(int h) { return (h > 512 ? 16 : 8) * kImgBytes64; }

// the forward and backward rings' slots
__host__ __device__ constexpr int fwd_stages(int h) { return h > 512 ? 1 : h > 256 ? 2 : 4; }

// a trunk slab: [H, 64], or at H = 1024 [512, 64], both warpgroups' rows of
// one half of a layer's columns
__host__ __device__ constexpr int trunk_slab(int h) {
  return (h > 512 ? h / 2 : h) * kImgRowBytes;
}

// A forward ring slot: a trunk slab, the heads' first or second layers
// (at H = 1024 one image a slab) or the first of their output slabs
__host__ __device__ constexpr int fwd_slot(int h) {
  const int hh = h / 4, hi = (hh + 63) / 64;
  const int heads = h > 512 ? hh * kImgRowBytes : 2 * hi * hh * kImgRowBytes;
  const int out0 = hi * (kRgbPad + kSemChunk) * kImgRowBytes;
  const int s = trunk_slab(h) > heads ? trunk_slab(h) : heads;
  return s > out0 ? s : out0;
}

// The widths of one instance, in images and bytes.
template <int H>
struct Tile {
  static_assert(H == 64 || H == 128 || H == 256 || H == 512 || H == 1024,
                "H is 64, 128, 256, 512 or 1024");
  static constexpr int kSplit = H > 256 ? 2 : 1;       // warpgroups that share a tile's columns
  static constexpr int kTiles = 2 / kSplit;            // 64-row tiles of a pass
  static constexpr int kPassRows = kTileRows * kTiles;
  static constexpr int kTT = kWg * kSplit;             // threads of a tile
  static constexpr int kHw = H / kSplit;               // trunk columns a warpgroup forms
  static constexpr int kNh = kHw > 256 ? 2 : 1;        // products a warpgroup forms them in
  static constexpr int kHwn = kHw / kNh;               // trunk columns of one product
  static constexpr int kHh = H / 4;                    // head width
  static constexpr int kHhw = kHh / kSplit;            // head columns a warpgroup forms
  static constexpr int kHI = (kHh + 63) / 64;          // images of a head's activation
  static constexpr int kMhw = kHhw > 64 ? 2 : 1;       // a head's ReLU mask words a row half
  static constexpr int kHImgs = H / 64;                // k-blocks of a hidden layer
  static constexpr int kHBytes = kHImgs * kImgBytes64;  // a tile's hidden activation
  static constexpr int kTrunkSlab = trunk_slab(H);
  static constexpr int kHeadImg = kHh * kImgRowBytes;   // a head image: [H/4, 64]
  static constexpr int kActBytes = buf_bytes(H) / kTiles;  // a tile's activation buffer
  static constexpr int kStages = fwd_stages(H);        // forward and backward rings
  static constexpr int kFwdSlot = fwd_slot(H);
  // one image a slab for the heads' layers and one k-block a slab for the
  // trunk output (H = 1024), or each layer one slab
  static constexpr bool kPerImage = H > 512;
};

// allow `kernel` that much dynamic shared memory -> the CUDA error code
inline int set_smem(const void* kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ unsigned char* align_smem(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// two mask bits of a packed bf16 pair: element > 0
__device__ __forceinline__ uint32_t pos_bits(uint32_t packed) {
  return ((packed & 0x7FFFu) ? 1u : 0u) | ((packed & 0x7FFF0000u) ? 2u : 0u);
}

// shared-memory layout of the forward kernels, from the aligned base
struct FwdSmem {
  int ring, act, bias, u, y, bars, total;
};

// biases: the hidden layers', the trunk output's (t_out), the heads' first
// and second layers (rgb, sem: H/4 each) and their outputs (16, c_tile).
// The trunk alone's output bias (any width) follows the hidden ones in
// global memory.
__host__ __device__ inline int bias_floats(int n_hidden, int h, int t_out, int c_tile) {
  return n_hidden * h + t_out + h + kRgbPad + c_tile;
}

// images of the heads' input [SH | geo | 0] at the tier's T_out
__host__ __device__ constexpr int xs_imgs(int t_out) { return (kShw + t_out + 63) / 64; }

// whether a forward at the instance h is the kWhole instance: its first
// layer the encoding in place, n_kb = a tile buffer's images (none at 1024)
inline bool whole_enc(int h, bool encode, int n_kb) {
  return h <= 512 && encode && n_kb == (h > 256 ? 8 : 4);
}

// at the instance h and the tier (t_out, c_tile)
__host__ __device__ inline FwdSmem fwd_smem(int h, int n_hidden, int t_out, int c_tile) {
  FwdSmem s;
  s.ring = 0;
  s.act = fwd_stages(h) * fwd_slot(h);
  s.bias = s.act + buf_bytes(h);
  s.u = s.bias + (bias_floats(n_hidden, h, t_out, c_tile) * 4 + 127) / 128 * 128;
  s.y = s.u + 2 * 2 * kUTileBytes;  // per tile: this pass's coordinates and the next one's
  s.bars = s.y + 2 * kYStageBytes;
  s.total = s.bars + 16 * fwd_stages(h) + kAlignSlack;
  return s;
}

// (byte offset, bytes) of forward slab s of the schedule (field_images.py::
// fwd_slabs): the first layer's n_kb slabs, the hidden layers' (n_trunk in
// all; at H = 1024 each layer's two halves in turn), then with the heads
// the trunk output (kTO columns), the heads' two layers (the first a
// k-block per image of their input) and their outputs (rgb with the first
// 64 semantic columns, then 64 semantic columns a slab), or for the trunk
// alone its output layer 16 columns a slab. At H = 1024 the trunk output
// is one k-block a slab and the heads' layers one image a slab.
template <int H, int kTO>
__device__ __forceinline__ void fwd_slab(int s, int n_trunk, bool heads, uint32_t& off,
                                         uint32_t& bytes) {
  using T = Tile<H>;
  constexpr bool kPI = T::kPerImage;
  constexpr int kXs = xs_imgs(kTO);
  constexpr uint32_t out_t = T::kHImgs * kTO * kImgRowBytes;
  constexpr uint32_t l1 = 2 * kXs * T::kHeadImg, l2 = 2 * T::kHI * T::kHeadImg;
  constexpr int n_out = kPI ? T::kHImgs : 1, n_l1 = kPI ? 2 * kXs : 1, n_l2 = kPI ? 2 * T::kHI : 1;
  constexpr uint32_t o0 = T::kHI * (kRgbPad + kSemChunk) * kImgRowBytes;
  constexpr uint32_t oc = T::kHI * kSemChunk * kImgRowBytes;
  int t = s - n_trunk;
  uint32_t base = (uint32_t)n_trunk * T::kTrunkSlab;
  if (t < 0) {
    off = (uint32_t)s * T::kTrunkSlab;
    bytes = T::kTrunkSlab;
  } else if (!heads) {
    bytes = T::kHImgs * kOutChunk * kImgRowBytes;
    off = base + (uint32_t)t * bytes;
  } else if (t < n_out) {
    bytes = out_t / n_out;
    off = base + (uint32_t)t * bytes;
  } else if ((t -= n_out) < n_l1) {
    bytes = l1 / n_l1;
    off = base + out_t + (uint32_t)t * bytes;
  } else if ((t -= n_l1) < n_l2) {
    bytes = l2 / n_l2;
    off = base + out_t + l1 + (uint32_t)t * bytes;
  } else if ((t -= n_l2) == 0) {
    off = base + out_t + l1 + l2;
    bytes = o0;
  } else {
    off = base + out_t + l1 + l2 + o0 + (uint32_t)(t - 1) * oc;
    bytes = oc;
  }
}

// The consumer side of one slab: slab_begin waits for it and returns its
// shared address; the caller issues its wgmma chain; slab_end waits for the
// products and hands the slot back.
template <int kStages>
__device__ __forceinline__ uint32_t slab_begin(const Ring<kStages>& ring, uint32_t ring_base,
                                               int slot_bytes) {
  ring.wait_full();
  wgmma_fence();
  return ring_base + ring.stage * slot_bytes;
}

template <int kStages>
__device__ __forceinline__ void slab_release(Ring<kStages>& ring, int tid) {
  if (tid == 0) mbar_arrive(ring.empty_bar());
  ring.advance();
}

template <int kStages>
__device__ __forceinline__ void slab_end(Ring<kStages>& ring, int tid) {
  wgmma_commit();
  wgmma_wait<0>();
  slab_release(ring, tid);
}

// st[0 .. n) -> g[0 .. n) by threads t of nt, 16 bytes at a time (g is
// 16-byte aligned)
__device__ __forceinline__ void copy_out(float* __restrict__ g, const float* st, int n, int t,
                                         int nt) {
  const int n4 = n / 4;
  for (int e = t; e < n4; e += nt)
    reinterpret_cast<float4*>(g)[e] = reinterpret_cast<const float4*>(st)[e];
  for (int e = 4 * n4 + t; e < n; e += nt) g[e] = st[e];
}

// A tile's coordinates u[row0 .. row0 + 63, :] as 192 floats, two a thread
// of the first 128 (zero past n_rows): fetch issues the loads, stash puts
// them in shared memory.
__device__ __forceinline__ float2 fetch_u(const float* __restrict__ u, int row0, int n_rows,
                                          int tid) {
  const long long first = (long long)row0 * 3, end = (long long)n_rows * 3;
  float2 v = make_float2(0.f, 0.f);
  if (first + tid < end) v.x = u[first + tid];
  if (tid < kTileRows * 3 - kWg && first + kWg + tid < end) v.y = u[first + kWg + tid];
  return v;
}

__device__ __forceinline__ void stash_u(float* dst, float2 v, int tid) {
  dst[tid] = v.x;
  if (tid < kTileRows * 3 - kWg) dst[kWg + tid] = v.y;
}

// columns 64 b .. 64 b + 63 of x[row0 .. row0 + 63, :din] (bf16, or f32
// rounded to bf16) as the image `img`, zero past din and past n_rows; din
// is a multiple of 16 and every row 16-byte aligned; threads t of nt
__device__ __forceinline__ void load_x_block(const void* x, int x_f32, int din, int row0,
                                             int n_rows, int b, unsigned char* img, int t,
                                             int nt) {
  for (int e = t; e < kTileRows * 8; e += nt) {
    const int i = e / 8, ch = e % 8, col = 64 * b + 8 * ch;
    const int row = row0 + i;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < n_rows && col < din) {
      if (x_f32) {
        const float4* p =
            reinterpret_cast<const float4*>(static_cast<const float*>(x) + (size_t)row * din + col);
        const float4 lo = p[0], hi = p[1];
        val = make_uint4(pack_bf16(lo.x, lo.y), pack_bf16(lo.z, lo.w), pack_bf16(hi.x, hi.y),
                         pack_bf16(hi.z, hi.w));
      } else {
        val = *reinterpret_cast<const uint4*>(static_cast<const bf16*>(x) + (size_t)row * din + col);
      }
    }
    *reinterpret_cast<uint4*>(img + img_off(i, 8 * ch)) = val;
  }
}

// the phases of frequency f (weights w0..w2 and phase ph, bf16-rounded
// already) at rows i0 .. i0 + 7 of the tile's coordinates ut
__device__ __forceinline__ void phases8(const float* ut, int i0, float w0, float w1, float w2,
                                        float ph, float (&proj)[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float* ur = ut + (i0 + k) * 3;  // zero past n_rows
    const float dot = round_bf16(ur[0]) * w0 + round_bf16(ur[1]) * w1 + round_bf16(ur[2]) * w2;
    proj[k] = __fadd_rn(__fmul_rn(dot, kTwoPi), ph);
  }
}

// frequency f's weights and phase (zero past n_freq) → whether it exists
__device__ __forceinline__ bool freq_weights(const float* __restrict__ W,
                                             const float* __restrict__ phase, int n_freq, int f,
                                             float& w0, float& w1, float& w2, float& ph) {
  if (f >= n_freq) return false;
  w0 = round_bf16(W[f]);
  w1 = round_bf16(W[n_freq + f]);
  w2 = round_bf16(W[2 * n_freq + f]);
  ph = phase[f];
  return true;
}

__device__ __forceinline__ void put_bf16(unsigned char* act, int i, int col, float v) {
  *reinterpret_cast<bf16*>(act + (col / 64) * kImgBytes64 + img_off(i, col % 64)) =
      __float2bfloat16(v);
}

// The whole encoding of the tile's 64 rows `ut`, [cos of m | sin of m]
// and zero up to 64 n_kb columns, in place as images 0 .. n_kb - 1 of
// `act`; threads t of nt >= m: thread t owns frequency t % m (its weights
// and phase in w, loaded once a kernel) of every (nt / m)-th block of
// eight rows, so that eight sincosf chains overlap. kM: m at compile time
// (the shipping widths), or 0
template <int kM = 0>
__device__ __forceinline__ void encode_all(const float4& w, int m_rt, int n_kb, const float* ut,
                                           unsigned char* act, int t, int nt) {
  const int m = kM ? kM : m_rt;
  const int groups = nt / m, f = t % m, grp = t / m;
  for (int e = t; e < kTileRows * (64 * n_kb - 2 * m); e += nt)
    put_bf16(act, e % kTileRows, 2 * m + e / kTileRows, 0.f);
  if (grp >= groups) return;
  const float w0 = w.x, w1 = w.y, w2 = w.z, ph = w.w;
  for (int rb = grp; rb < kTileRows / 8; rb += groups) {
    const int i0 = 8 * rb;
    float proj[8];
    phases8(ut, i0, w0, w1, w2, ph, proj);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      float s, c;
      sincosf(proj[k], &s, &c);
      put_bf16(act, i0 + k, f, c);
      put_bf16(act, i0 + k, m + f, s);
    }
  }
}

// The encoding's k-block b (columns 64 b .. 64 b + 63 of [cos of m | sin
// of m | 0]) as the image `img`; threads t of nt: thread t owns column
// t % 64 of every (nt / 64)-th block of eight rows, one sincosf a column
__device__ __forceinline__ void encode_block(const float* __restrict__ W,
                                             const float* __restrict__ phase, int m, int b,
                                             const float* ut, unsigned char* img, int t, int nt) {
  const int col = 64 * b + t % 64;
  const bool is_sin = col >= m;
  float w0 = 0.f, w1 = 0.f, w2 = 0.f, ph = 0.f;
  const bool real = freq_weights(W, phase, m, is_sin ? col - m : col, w0, w1, w2, ph) &&
                    col < 2 * m;
  for (int rb = t / 64; rb < kTileRows / 8; rb += nt / 64) {
    const int i0 = 8 * rb;
    float proj[8];
    phases8(ut, i0, w0, w1, w2, ph, proj);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      float s = 0.f, c = 0.f;
      if (real) sincosf(proj[k], &s, &c);
      *reinterpret_cast<bf16*>(img + img_off(i0 + k, t % 64)) = __float2bfloat16(is_sin ? s : c);
    }
  }
}

// The first layer's k-block b of a tile into staging image b % 2 of act:
// the encoding's or x's
template <class P>
__device__ __forceinline__ void form_block(const P& a, const void* x, int x_f32, int din, int row0,
                                           int n_rows, int b, const float* ut,
                                           unsigned char* act, int t, int nt) {
  unsigned char* img = act + (b & 1) * kImgBytes64;
  if (x == nullptr)
    encode_block(a.W, a.phase, a.n_freq, b, ut, img, t, nt);
  else
    load_x_block(x, x_f32, din, row0, n_rows, b, img, t, nt);
}

// The field over every pass of this block, at the instance H. P holds the
// FieldWeights members; S is NoSave or holds
//   enc, h[3], xs, hid1, hid2   bf16 tile images per 64-row tile: n_kb,
//                               H/64, xs_imgs(kTO), 2 kHI, 2 kHI images
//                               (hid: rgb | sem)
//   mask_t[3], mask_h           uint2 per (row, lane % 4, column half): the ReLU masks
// The first layer's input is the encoding of u or, where x is given, x
// itself [n_rows, din] (bf16, or f32 when x_f32). With `heads` false the
// pass ends after the trunk's hidden layers (the trunk kernels'
// backwards: Epi is then not called) or, where Epi::kTrunkOut, after the
// trunk's output layer (the trunk kernels' forwards: Epi writes y). Epi
// stages a tile's values in shared memory (density, rgb, sem) and writes
// them out: at C_pad = 64 every value of a tile at once (flush), past it the
// density and rgb (flush_head) and then 64 semantic columns a chunk
// (flush_sem). kWhole: the first layer is the encoding in place in all of
// the buffer's images (n_kb = their count); else any first layer. kCP,
// kTO: the tier (C_pad, T_out; the trunk kernels, without the heads, take
// the first). smem is the block's dynamic shared memory, fwd_smem().total
// bytes. Every thread of the block calls it.
template <int H, bool kWhole, int kCP, int kTO, class P, class S, class Epi>
__device__ __forceinline__ void field_forward(const P& a, const S& sv,
                                              const float* __restrict__ u, const void* x,
                                              int x_f32, int din, bool heads,
                                              const float* __restrict__ sh, int n_rows,
                                              int n_samples, unsigned char* smem_raw, Epi epi) {
  using T = Tile<H>;
  constexpr int kHw = T::kHw, kHwn = T::kHwn, kHhw = T::kHhw, kHh = T::kHh, kHI = T::kHI;
  constexpr int kTT = T::kTT;
  constexpr int kSlot = T::kFwdSlot;
  constexpr int kSt = T::kStages;
  unsigned char* smem = align_smem(smem_raw);
  const int nh = a.n_hidden, nkb = a.n_kb;
  const FwdSmem L = fwd_smem(H, nh, kTO, kCP);
  float* bias_s = reinterpret_cast<float*>(smem + L.bias);
  const uint32_t full = smem_u32(smem + L.bars), empty = full + 8 * kSt;
  const uint32_t ring_base = smem_u32(smem + L.ring);
  const bool encode = x == nullptr;
  constexpr int kImgs = T::kActBytes / kImgBytes64;  // a tile buffer's images
  constexpr int kXs = xs_imgs(kTO), kXs0 = kImgs - kXs;  // the heads' input: its images
  // the whole first layer's input at once (the encoding or, at H = 1024, x
  // too; the host keeps it to 8 k-blocks there), or block by block
  const bool in_place = kWhole || ((encode || T::kNh > 1) && nkb <= kImgs);
  const int n_bias_s = heads ? bias_floats(nh, H, kTO, kCP) : nh * H;
  for (int i = threadIdx.x; i < n_bias_s; i += kFieldThreads) bias_s[i] = a.bias[i];
  if (threadIdx.x == 0) ring_init<kSt>(full, empty, 2);
  __syncthreads();
  const int n_pass = (n_rows + T::kPassRows - 1) / T::kPassRows;
  const int n_trunk = T::kNh * (nkb + (nh - 1) * T::kHImgs);
  bool out_layer = heads;
  if constexpr (Epi::kTrunkOut) out_layer = true;
  constexpr int kNch = kCP / kSemChunk;  // the semantic output's slabs
  // the heads' slabs: the trunk output, their two layers, their outputs
  constexpr int kHeadSlabs =
      (T::kPerImage ? T::kHImgs + 2 * kXs + 2 * T::kHI : 3) + kNch;
  const int n_out = heads ? kHeadSlabs : (Epi::kTrunkOut ? (a.out + 15) / 16 : 0);
  const int n_slabs = n_trunk + n_out;
  Ring<kSt> ring;
  ring.full = full;
  ring.empty = empty;

  if (threadIdx.x >= 2 * kWg) {
    // ---- producer: one thread streams the slab schedule, once per pass
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 2 * kWg) {
      const unsigned char* w = reinterpret_cast<const unsigned char*>(a.wfwd);
      for (int pass = blockIdx.x; pass < n_pass; pass += gridDim.x) {
        for (int s = 0; s < n_slabs; ++s) {
          uint32_t off, bytes;
          fwd_slab<H, kTO>(s, n_trunk, heads, off, bytes);
          ring.wait_empty();
          mbar_expect_tx(ring.full_bar(), bytes);
          bulk_load(ring_base + ring.stage * kSlot, w + off, bytes, ring.full_bar());
          ring.advance();
        }
      }
    }
    return;
  }

  // ---- consumers
  reg_alloc<kConsumerRegs>();
  const int wg = threadIdx.x / kWg, tid = threadIdx.x % kWg;
  const int tl = wg / T::kSplit, cw = wg % T::kSplit;  // the warpgroup's tile and column half
  const int tt = tid + cw * kWg;                       // thread of the tile
  const int g = (tid % 32) / 4, q = tid % 4;
  const int r_lo = 16 * (tid / 32) + g;  // this thread's accumulator rows: r_lo, r_lo + 8
  const int bar_id = 1 + tl;
  unsigned char* act = smem + L.act + tl * T::kActBytes;
  const uint32_t act_a = smem_u32(act);
  const int G = a.geo, C = a.n_classes;

  auto tile_sync = [&]() { named_barrier(bar_id, kTT); };
  // a bulk store of the buffer may still read it: wait before overwriting
  auto before_overwrite = [&]() {
    if constexpr (S::kSaves) {
      if (tt == 0) bulk_store_wait_read();
    }
    tile_sync();
  };
  // the tile's writes are visible to wgmma and to bulk stores
  auto after_write = [&]() {
    fence_async_smem();
    tile_sync();
  };

  // the in-place encode's weights and phase of this thread's frequency
  float4 enc_w = make_float4(0.f, 0.f, 0.f, 0.f);
  if (in_place && encode)
    freq_weights(a.W, a.phase, a.n_freq, tt % a.n_freq, enc_w.x, enc_w.y, enc_w.z, enc_w.w);

  // the coordinates of a pass are fetched a pass ahead, so that the encode
  // does not wait on device memory
  float* u_s = reinterpret_cast<float*>(smem + L.u) + tl * 2 * (kUTileBytes / 4);
  int slot = 0;
  if (encode && cw == 0 && (int)blockIdx.x < n_pass)
    stash_u(u_s, fetch_u(u, blockIdx.x * T::kPassRows + tl * kTileRows, n_rows, tid), tid);
  tile_sync();

  for (int pass = blockIdx.x; pass < n_pass; pass += gridDim.x, slot ^= 1) {
    const int row0 = pass * T::kPassRows + tl * kTileRows;
    const size_t tile = (size_t)(row0 / kTileRows);
    const float* ut = u_s + slot * (kUTileBytes / 4);

    // the first layer's k-block b formed into staging image b % 2, and saved
    auto save_block = [&](int b) {
      if constexpr (S::kSaves) {
        if (tt == 0)
          bulk_store(sv.enc + (tile * nkb + b) * (kImgBytes64 / 2), act_a + (b & 1) * kImgBytes64,
                     kImgBytes64);
      }
    };

    float2 u_next = make_float2(0.f, 0.f);
    if (encode && cw == 0) {
      const int next = pass + gridDim.x;
      if (next < n_pass) u_next = fetch_u(u, next * T::kPassRows + tl * kTileRows, n_rows, tid);
    }
    if (kWhole && a.n_freq == 32 * kImgs) {
      // the shipping widths: every loop of the encode of a compile-time length
      encode_all<32 * kImgs>(enc_w, 0, kImgs, ut, act, tt, kTT);
      after_write();
      if constexpr (S::kSaves) {
        if (tt == 0)
          bulk_store(sv.enc + tile * nkb * (kImgBytes64 / 2), act_a, nkb * kImgBytes64);
      }
    } else if (in_place) {
      if (encode) {
        encode_all(enc_w, a.n_freq, nkb, ut, act, tt, kTT);
      } else {
        for (int b = 0; b < nkb; ++b)
          load_x_block(x, x_f32, din, row0, n_rows, b, act + b * kImgBytes64, tt, kTT);
      }
      after_write();
      if constexpr (S::kSaves) {
        if (tt == 0)
          bulk_store(sv.enc + tile * nkb * (kImgBytes64 / 2), act_a, nkb * kImgBytes64);
      }
    } else {
      form_block(a, x, x_f32, din, row0, n_rows, 0, ut, act, tt, kTT);
      after_write();
      save_block(0);
    }
    // the next pass's coordinates go to the other slot (the streamed
    // encode reads this pass's until the first layer ends)
    if (encode && cw == 0) stash_u(u_s + (slot ^ 1) * (kUTileBytes / 4), u_next, tid);

    // the trunk's hidden layers, in place; the first layer's k-blocks either
    // lie in place or are staged, block kb + 1 formed while kb's product runs.
    // A warpgroup forms its columns in kNh products (two at H = 1024, each
    // over the whole input): the first's bf16 results wait in device memory
    // (each thread its own words, L2-resident) until the last is formed,
    // then every half goes over the input
    for (int l = 0; l < nh; ++l) {
      const bool staged = T::kNh == 1 && l == 0 && !in_place;
      const float* b = bias_s + l * H + cw * kHw;
      // the first half's words [j][row half] of this thread (H = 1024), in device memory
      uint32_t* keep = T::kNh > 1 ? a.keep + (size_t)blockIdx.x * keep_words(H) + tt : nullptr;
#pragma unroll
      for (int hf = 0; hf < T::kNh; ++hf) {
        float d[kHwn / 2];
        fresh(d);
        const uint32_t wrow = cw * kHwn * kImgRowBytes;  // the warpgroup's rows of a slab
        // the products in place: compile-time k-block counts for every hidden
        // layer and kWhole's first layer (one loop where the two counts agree)
        if (l > 0 || (kWhole && kImgs == T::kHImgs)) {
#pragma unroll
          for (int kb = 0; kb < T::kHImgs; ++kb) {
            const uint32_t slab = slab_begin(ring, ring_base, kSlot) + wrow;
#pragma unroll
            for (int ks = 0; ks < 4; ++ks)
              wgmma<kHwn, 0, 0>(d, kmajor_desc(act_a + kb * kImgBytes64, ks),
                                kmajor_desc(slab, ks), (kb | ks) != 0);
            slab_end(ring, tid);
          }
        } else if (kWhole) {
#pragma unroll
          for (int kb = 0; kb < kImgs; ++kb) {
            const uint32_t slab = slab_begin(ring, ring_base, kSlot) + wrow;
#pragma unroll
            for (int ks = 0; ks < 4; ++ks)
              wgmma<kHwn, 0, 0>(d, kmajor_desc(act_a + kb * kImgBytes64, ks),
                                kmajor_desc(slab, ks), (kb | ks) != 0);
            slab_end(ring, tid);
          }
        } else if (!staged) {
          for (int kb = 0; kb < nkb; ++kb) {
            const uint32_t slab = slab_begin(ring, ring_base, kSlot) + wrow;
#pragma unroll
            for (int ks = 0; ks < 4; ++ks)
              wgmma<kHwn, 0, 0>(d, kmajor_desc(act_a + kb * kImgBytes64, ks),
                                kmajor_desc(slab, ks), (kb | ks) != 0);
            slab_end(ring, tid);
          }
        }
        const int n_k = kWhole ? 0 : nkb;
        for (int kb = 0; staged && kb < n_k; ++kb) {
          const uint32_t slab = slab_begin(ring, ring_base, kSlot) + wrow;
          const uint32_t img = act_a + (kb & 1) * kImgBytes64;
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
            wgmma<kHwn, 0, 0>(d, kmajor_desc(img, ks), kmajor_desc(slab, ks), (kb | ks) != 0);
          wgmma_commit();
          const bool next = kb + 1 < n_k;
          if (next) {
            if constexpr (S::kSaves) before_overwrite();
            form_block(a, x, x_f32, din, row0, n_rows, kb + 1, ut, act, tt, kTT);
          }
          wgmma_wait<0>();
          slab_release(ring, tid);
          if (next) {
            after_write();
            save_block(kb + 1);
          }
        }
        if (hf + 1 < T::kNh) {
#pragma unroll
          for (int j = 0; j < kHwn / 8; ++j) {
            const float2 bb = *reinterpret_cast<const float2*>(b + hf * kHwn + 8 * j + 2 * q);
            keep[2 * j * kTT] =
                pack_bf16(fmaxf(d[4 * j] + bb.x, 0.f), fmaxf(d[4 * j + 1] + bb.y, 0.f));
            keep[(2 * j + 1) * kTT] =
                pack_bf16(fmaxf(d[4 * j + 2] + bb.x, 0.f), fmaxf(d[4 * j + 3] + bb.y, 0.f));
          }
          continue;
        }
        before_overwrite();
#pragma unroll
        for (int h2 = 0; h2 < T::kNh; ++h2) {
          uint32_t mk[4] = {0u, 0u, 0u, 0u};  // [row half][word]
#pragma unroll
          for (int j = 0; j < kHwn / 8; ++j) {
            const int c = h2 * kHwn + 8 * j + 2 * q;  // the warpgroup's column
            uint32_t lo, hi;
            if (h2 + 1 < T::kNh) {
              lo = keep[2 * j * kTT];
              hi = keep[(2 * j + 1) * kTT];
            } else {
              const float2 bb = *reinterpret_cast<const float2*>(b + c);
              lo = pack_bf16(fmaxf(d[4 * j] + bb.x, 0.f), fmaxf(d[4 * j + 1] + bb.y, 0.f));
              hi = pack_bf16(fmaxf(d[4 * j + 2] + bb.x, 0.f), fmaxf(d[4 * j + 3] + bb.y, 0.f));
            }
            unsigned char* img = act + ((cw * kHw + c) / 64) * kImgBytes64;
            *reinterpret_cast<uint32_t*>(img + img_off(r_lo, c % 64)) = lo;
            *reinterpret_cast<uint32_t*>(img + img_off(r_lo + 8, c % 64)) = hi;
            if constexpr (S::kSaves) {
              mk[j / 16] |= pos_bits(lo) << (2 * (j % 16));
              mk[2 + j / 16] |= pos_bits(hi) << (2 * (j % 16));
            }
          }
          if constexpr (S::kSaves) {
            const int mc = cw * T::kNh + h2;  // the mask's column quarter
            sv.mask_t[l][((size_t)(row0 + r_lo) * 4 + q) * (T::kSplit * T::kNh) + mc] =
                make_uint2(mk[0], mk[1]);
            sv.mask_t[l][((size_t)(row0 + r_lo + 8) * 4 + q) * (T::kSplit * T::kNh) + mc] =
                make_uint2(mk[2], mk[3]);
          }
        }
      }
      after_write();
      if constexpr (S::kSaves) {
        if (tt == 0) bulk_store(sv.h[l] + tile * (T::kHBytes / 2), act_a, T::kHBytes);
      }
    }
    if (!out_layer) {
      // the next pass's first block overwrites the buffer the last store reads
      before_overwrite();
      continue;
    }

    if constexpr (Epi::kTrunkOut) {
      // the trunk alone: y = h @ w_out + b_out (f32), 16 columns a slab; both
      // column halves form the whole product, the first writes it
      float* ys = reinterpret_cast<float*>(smem + L.y) + tl * (kYStageBytes / 4);
      const float* b_out = a.bias + nh * H;
      for (int ch = 0; ch < n_out; ++ch) {
        float dd[8];
        fresh(dd);
        const uint32_t slab = slab_begin(ring, ring_base, kSlot);
#pragma unroll
        for (int kb = 0; kb < T::kHImgs; ++kb) {
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
            wgmma_n16<0, 0>(dd, kmajor_desc(act_a + kb * kImgBytes64, ks),
                            kmajor_desc(slab + kb * kOutChunk * kImgRowBytes, ks), (kb | ks) != 0);
        }
        slab_end(ring, tid);
        if (cw == 0) {
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const int c = 8 * (e / 4) + 2 * q + (e & 1), i = r_lo + 8 * ((e >> 1) & 1);
            const int col = 16 * ch + c;
            ys[i * 16 + c] = dd[e] + (col < a.out ? b_out[col] : 0.f);
          }
        }
        tile_sync();
        epi.flush_chunk(ys, row0, min(kTileRows, n_rows - row0), ch, tt, kTT);
        tile_sync();
      }
      continue;
    }

    // trunk output (f32), density, and the heads' input [bf16 SH | bf16 geo | 0]
    // as the buffer's last kXs images; both column halves form the product,
    // the first writes what follows from it
    float sig[2] = {0.f, 0.f}, dsd[2] = {0.f, 0.f};
    {
      float dd[kTO / 2];
      fresh(dd);
      constexpr int kOutPer = T::kPerImage ? 1 : T::kHImgs;  // k-blocks a slab
#pragma unroll
      for (int g0 = 0; g0 < T::kHImgs; g0 += kOutPer) {
        const uint32_t slab = slab_begin(ring, ring_base, kSlot);
#pragma unroll
        for (int kb = g0; kb < g0 + kOutPer; ++kb) {
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
            wgmma<kTO, 0, 0>(dd, kmajor_desc(act_a + kb * kImgBytes64, ks),
                             kmajor_desc(slab + (kb - g0) * kTO * kImgRowBytes, ks),
                             (kb | ks) != 0);
        }
        slab_end(ring, tid);
      }
      before_overwrite();
      const float* b = bias_s + nh * H;
      unsigned char* xs = act + kXs0 * kImgBytes64;
      auto xs_at = [&](int i, int col) {  // element (i, col) of the heads' input
        return xs + (col / 64) * kImgBytes64 + img_off(i, col % 64);
      };
      if (cw == 0) {
#pragma unroll
        for (int e = 0; e < kTO / 2; ++e) {
          const int c = 8 * (e / 4) + 2 * q + (e & 1), half = (e >> 1) & 1;
          const int i = r_lo + 8 * half;
          const float v = dd[e] + b[c];
          if (c == 0) {
            const int row = row0 + i;
            const float* ur = ut + i * 3;
            const bool in = row < n_rows && ur[0] > 0.f && ur[0] < 1.f && ur[1] > 0.f &&
                            ur[1] < 1.f && ur[2] > 0.f && ur[2] < 1.f;
            sig[half] = in ? expf(v - 1.f) : 0.f;
            dsd[half] = in ? expf(fminf(v - 1.f, 15.f)) : 0.f;
            *reinterpret_cast<bf16*>(xs_at(i, kShw + kTO - 1)) = __float2bfloat16(0.f);
          } else {
            *reinterpret_cast<bf16*>(xs_at(i, kShw - 1 + c)) = __float2bfloat16(c <= G ? v : 0.f);
          }
        }
      }
      // chunks 0, 1: SH of the row's ray; the chunks past [SH | trunk output]: zero
      constexpr int kXsCh = 8 * kXs - kTO / 8;  // chunks of a row written here
      for (int e = tt; e < kTileRows * kXsCh; e += kTT) {
        const int i = e / kXsCh, ch = e % kXsCh < 2 ? e % kXsCh : e % kXsCh + kTO / 8;
        const int row = row0 + i;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (ch < 2 && row < n_rows) {
          const float4* s4 =
              reinterpret_cast<const float4*>(sh + (size_t)(row / n_samples) * kShw + ch * 8);
          const float4 lo = s4[0], hi = s4[1];
          val = make_uint4(pack_bf16(lo.x, lo.y), pack_bf16(lo.z, lo.w), pack_bf16(hi.x, hi.y),
                           pack_bf16(hi.z, hi.w));
        }
        *reinterpret_cast<uint4*>(xs_at(i, ch * 8)) = val;
      }
      after_write();
      if constexpr (S::kSaves) {
        if (tt == 0)
          bulk_store(sv.xs + tile * kXs * (kImgBytes64 / 2), act_a + kXs0 * kImgBytes64,
                     kXs * kImgBytes64);
      }
    }

    // heads: rgb on [SH | geo], semantics on geo; hidden activations in
    // images 0 .. kHI - 1 (rgb) and kHI .. 2 kHI - 1 (sem), columns past H/4 zero
    // the ReLU masks [word][row half][rgb, sem]: one word, layer 1 the low 16
    // bits and layer 2 the high, or (kMhw = 2) a word a layer
    constexpr int kMhw = T::kMhw;
    uint32_t mh[4 * kMhw];
#pragma unroll
    for (int w = 0; w < 4 * kMhw; ++w) mh[w] = 0u;
    const uint32_t xs_a = act_a + kXs0 * kImgBytes64;
    for (int l = 0; l < 2; ++l) {
      float dr[kHhw / 2], ds[kHhw / 2];
      fresh(dr);
      fresh(ds);
      if constexpr (T::kPerImage) {
        // one image a slab: rgb's k-blocks, then sem's
#pragma unroll
        for (int hd = 0; hd < 2; ++hd) {
          float(&acc)[kHhw / 2] = hd ? ds : dr;
          if (l == 0) {
#pragma unroll
            for (int kb = 0; kb < kXs; ++kb) {
              const uint32_t slab = slab_begin(ring, ring_base, kSlot) + cw * kHhw * kImgRowBytes;
#pragma unroll
              for (int ks = 0; ks < 4 && 4 * kb + ks < 1 + kTO / 16; ++ks)
                wgmma<kHhw, 0, 0>(acc, kmajor_desc(xs_a + kb * kImgBytes64, ks),
                                  kmajor_desc(slab, ks), (kb | ks) != 0);
              slab_end(ring, tid);
            }
          } else {
#pragma unroll
            for (int kb = 0; kb < kHI; ++kb) {
              const uint32_t slab = slab_begin(ring, ring_base, kSlot) + cw * kHhw * kImgRowBytes;
#pragma unroll
              for (int ks = 0; ks < 4; ++ks)
                wgmma<kHhw, 0, 0>(acc, kmajor_desc(act_a + (hd * kHI + kb) * kImgBytes64, ks),
                                  kmajor_desc(slab, ks), (kb | ks) != 0);
              slab_end(ring, tid);
            }
          }
        }
      } else {
        const uint32_t slab = slab_begin(ring, ring_base, kSlot) + cw * kHhw * kImgRowBytes;
        if (l == 0) {
#pragma unroll
          for (int ks = 0; ks < 1 + kTO / 16; ++ks) {
            const uint32_t x = xs_a + (ks / 4) * kImgBytes64;  // rgb's k-blocks, then sem's
            wgmma<kHhw, 0, 0>(dr, kmajor_desc(x, ks % 4),
                              kmajor_desc(slab + (ks / 4) * T::kHeadImg, ks % 4), ks != 0);
            wgmma<kHhw, 0, 0>(ds, kmajor_desc(x, ks % 4),
                              kmajor_desc(slab + (kXs + ks / 4) * T::kHeadImg, ks % 4), ks != 0);
          }
        } else {
#pragma unroll
          for (int ks = 0; ks < kHh / 16; ++ks) {
            const int kb = ks / 4;
            wgmma<kHhw, 0, 0>(dr, kmajor_desc(act_a + kb * kImgBytes64, ks % 4),
                              kmajor_desc(slab + kb * T::kHeadImg, ks % 4), ks != 0);
            wgmma<kHhw, 0, 0>(ds, kmajor_desc(act_a + (kHI + kb) * kImgBytes64, ks % 4),
                              kmajor_desc(slab + (kHI + kb) * T::kHeadImg, ks % 4), ks != 0);
          }
        }
        slab_end(ring, tid);
      }
      before_overwrite();
      const float* br = bias_s + nh * H + kTO + l * 2 * kHh;
      const float* bs = br + kHh;
#pragma unroll
      for (int j = 0; j < kHhw / 8; ++j) {
        const int c0 = cw * kHhw + 8 * j, col = c0 + 2 * q;  // c0: a whole 8-column chunk
        const float2 b0 = *reinterpret_cast<const float2*>(br + col);
        const float2 b1 = *reinterpret_cast<const float2*>(bs + col);
        const uint32_t rl = pack_bf16(fmaxf(dr[4 * j] + b0.x, 0.f), fmaxf(dr[4 * j + 1] + b0.y, 0.f));
        const uint32_t rh =
            pack_bf16(fmaxf(dr[4 * j + 2] + b0.x, 0.f), fmaxf(dr[4 * j + 3] + b0.y, 0.f));
        const uint32_t sl = pack_bf16(fmaxf(ds[4 * j] + b1.x, 0.f), fmaxf(ds[4 * j + 1] + b1.y, 0.f));
        const uint32_t sh_ =
            pack_bf16(fmaxf(ds[4 * j + 2] + b1.x, 0.f), fmaxf(ds[4 * j + 3] + b1.y, 0.f));
        unsigned char* ri = act + (c0 / 64) * kImgBytes64;
        unsigned char* si = act + (kHI + c0 / 64) * kImgBytes64;
        const int cc = c0 % 64 + 2 * q;
        *reinterpret_cast<uint32_t*>(ri + img_off(r_lo, cc)) = rl;
        *reinterpret_cast<uint32_t*>(ri + img_off(r_lo + 8, cc)) = rh;
        *reinterpret_cast<uint32_t*>(si + img_off(r_lo, cc)) = sl;
        *reinterpret_cast<uint32_t*>(si + img_off(r_lo + 8, cc)) = sh_;
        if constexpr (S::kSaves) {
          const int at = kMhw == 1 ? 16 * l + 2 * j : 2 * j, w = kMhw == 1 ? 0 : 4 * l;
          mh[w] |= pos_bits(rl) << at;
          mh[w + 1] |= pos_bits(sl) << at;
          mh[w + 2] |= pos_bits(rh) << at;
          mh[w + 3] |= pos_bits(sh_) << at;
        }
      }
      if constexpr (kHh < 64) {
        // the images' unused columns, which the saved images carry to dW
#pragma unroll
        for (int j = kHh / 8; j < 8; ++j) {
          const int c = 8 * j + 2 * q;
#pragma unroll
          for (int w = 0; w < 2; ++w) {
            *reinterpret_cast<uint32_t*>(act + w * kImgBytes64 + img_off(r_lo, c)) = 0u;
            *reinterpret_cast<uint32_t*>(act + w * kImgBytes64 + img_off(r_lo + 8, c)) = 0u;
          }
        }
      }
      after_write();
      if constexpr (S::kSaves) {
        bf16* dst = l == 0 ? sv.hid1 : sv.hid2;
        if (tt == 0)
          bulk_store(dst + tile * (kHI * kImgBytes64), act_a, 2 * kHI * kImgBytes64);
      }
    }
    if constexpr (S::kSaves) {
#pragma unroll
      for (int w = 0; w < kMhw; ++w) {
        const size_t m = (size_t)T::kSplit * kMhw;  // words a (row, q)
        sv.mask_h[((size_t)(row0 + r_lo) * 4 + q) * m + cw * kMhw + w] =
            make_uint2(mh[4 * w], mh[4 * w + 1]);
        sv.mask_h[((size_t)(row0 + r_lo + 8) * 4 + q) * m + cw * kMhw + w] =
            make_uint2(mh[4 * w + 2], mh[4 * w + 3]);
      }
    }

    // head outputs, one slab of 64 semantic columns at a time (rgb's with the
    // first); with two column halves the first forms rgb, the second the
    // semantics. At C_pad = 64 a tile's values are staged together over the
    // buffer (the whole of it is free by then); past it the density and rgb
    // over the rgb head's activation (free after the first slab) and each
    // semantic chunk [64, 64] f32 past the heads' activations, which the
    // later chunks still multiply
    const float* br = bias_s + nh * H + kTO + 4 * kHh;
    const float* bs = br + kRgbPad;
    float* st = reinterpret_cast<float*>(act);
    float* ss = kNch == 1 ? st : reinterpret_cast<float*>(act + 2 * kHI * kImgBytes64);
    const int n_valid = min(kTileRows, n_rows - row0);
#pragma unroll
    for (int ch = 0; ch < kNch; ++ch) {
      float dr[8], ds[32];
      fresh(dr);
      fresh(ds);
      const bool do_rgb = cw == 0 && ch == 0, do_sem = cw == T::kSplit - 1;
      {
        const uint32_t slab = slab_begin(ring, ring_base, kSlot);
        const uint32_t sem_w = slab + (ch == 0 ? kHI * kRgbPad * kImgRowBytes : 0);
#pragma unroll
        for (int ks = 0; ks < kHh / 16; ++ks) {
          const int kb = ks / 4;
          if (do_rgb)
            wgmma_n16<0, 0>(dr, kmajor_desc(act_a + kb * kImgBytes64, ks % 4),
                            kmajor_desc(slab + kb * kRgbPad * kImgRowBytes, ks % 4), ks != 0);
          if (do_sem)
            wgmma_n64<0, 0>(ds, kmajor_desc(act_a + (kHI + kb) * kImgBytes64, ks % 4),
                            kmajor_desc(sem_w + kb * kImgBytes64, ks % 4), ks != 0);
        }
        slab_end(ring, tid);
      }
      before_overwrite();
      if (do_rgb) {
        if (q == 0) {
          epi.density(st, r_lo, sig[0], dsd[0]);
          epi.density(st, r_lo + 8, sig[1], dsd[1]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 2 * q + (e & 1);
          if (c < 3) epi.rgb(st, r_lo + 8 * (e >> 1), c, 1.f / (1.f + expf(-(dr[e] + br[c]))));
        }
      }
      if (do_sem) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 8 * j + 2 * q + (e & 1), i = r_lo + 8 * (e >> 1);
            const float v = ds[4 * j + e] + bs[kSemChunk * ch + c];
            if constexpr (kNch == 1) {
              if (c < C) epi.sem(st, i, c, v);
            } else {
              ss[i * kSemChunk + c] = v;
            }
          }
        }
      }
      tile_sync();
      if (n_valid > 0) {
        if constexpr (kNch == 1) {
          epi.flush(st, row0, n_valid, tt, kTT);
        } else {
          if (ch == 0) epi.flush_head(st, row0, n_valid, tt, kTT);
          epi.flush_sem(ss, row0, n_valid, ch, tt, kTT);
        }
      }
      tile_sync();
    }
  }
  if constexpr (S::kSaves) {
    if (tt == 0) bulk_store_wait();
  }
}

}  // namespace
