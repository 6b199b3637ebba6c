// The spectral field on the H100, shared by the kernels that evaluate it
// (fused_field_heads.cu, fused_field_volrend.cu): the whole main field,
// or its trunk alone for the trunk kernels' backwards (fused_mlp.py). Same
// math as apnerf_tpu/ops/pallas/fused_field_heads.py::_make_field_fwd_kernel,
// rows as samples, the two heads formed and rounded as two heads:
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
// Widths. The kernels are templates on the frequency count M (the encoding
// is 2M wide) and the trunk width H, with heads H/4 wide: M in {32, 64,
// 128} and H in {64, 128, 256}, nine instances (APNERF_TILE_WIDTHS). The
// first layer has 2M/64 k-blocks of 64 columns, every other trunk layer
// H/64; a warpgroup's trunk accumulator is H/2 floats a thread. The trunk
// kernels' input x (no encode) enters as the instance's first-layer
// images, zero-padded to 2M columns.
//
// Design. A persistent block per SM: two consumer warpgroups, each owning
// a 64-row tile of a 128-row pass, and a producer warpgroup of which one
// thread works (setmaxnreg moves its registers to the consumers). Every layer is a
// wgmma product m64 x n (n = H in the trunk, one instruction chain per
// 64-column k-block) whose A operand is the warpgroup's own activation
// buffer in shared memory and whose B operand is a weight slab that the
// producer streams through a 4-slot ring with cp.async.bulk and mbarriers
// (the weights lie in global memory as ready tile images, hopper_tile.cuh),
// so the next slab's copy overlaps this slab's product and both
// warpgroups multiply against every slab. The accumulators stay in
// registers: bias, ReLU and the bf16 rounding are applied there and the
// result goes back, swizzled, over the layer's own input as the next A
// operand. Both heads run on the warpgroup's own rows, rgb and semantics
// as two n = H/4 chains of one batch. What a kernel does with a tile's
// values is its epilogue struct: it stages them in shared memory and
// writes them out as 16-byte stores. A kernel with a backward passes a
// save struct: the activations leave as whole tile images by bulk stores
// (the layout the weight-gradient kernel multiplies from) and the ReLU
// masks as two words per thread, in the accumulator's own bit order.
//
// What bounds it: on paper tensor-core math (a row of the shipping field
// costs ~0.45 MFLOP against ~150 bytes). On the card the shipping instance
// reaches about a third of that bound (PERF.md), and a pass of 128 rows
// splits into three parts of about equal size: the trunk's products,
// during which the tensor pipe is busy for one warpgroup or the other; the
// encode, 128 precise sincosf a row, bound by instruction issue, which both
// warpgroups run at the same time and which therefore hides behind no
// product (without it the kernel takes 27 % less); and the latency chain
// of the five small products and epilogues after the trunk. The slab ring
// is not in the way: the kernel takes the same time with the ring's copies
// left out, and with the hidden layers' epilogue stores left out. Letting
// the warpgroups take turns at the tensor cores, and keeping two slabs'
// products in flight, each moved it by under 3 % and were taken out again.
// The ring re-reads the ~440 KB of weight images from L2 once per 128
// rows, ~2.6 TB/s at this speed; a faster tile would need a cluster's
// multicast or more rows a block.

#pragma once

#include "hopper_tile.cuh"

// The field's weights as the kernels read them (field_images.py builds
// the buffers). At namespace scope: extern "C" entries take structs that
// hold it.
struct FieldWeights {
  const float* W;      // [3, M]
  const float* phase;  // [M]
  const __nv_bfloat16* wfwd;  // forward slabs
  const __nv_bfloat16* wbwd;  // backward slabs
  const float* bias;          // every layer's bias, padded (bias_offsets)
  int tile_m, tile_h;         // frequencies M and trunk width H: the instance
  int n_hidden;               // trunk hidden layers, 2 or 3
  int geo, n_classes;
};

// The save struct of a kernel that keeps no activation.
struct NoSave {
  static constexpr bool kSaves = false;
};

// the (M, H) instances of the tile's kernels
#define APNERF_TILE_WIDTHS(X) \
  X(32, 64) X(32, 128) X(32, 256) X(64, 64) X(64, 128) X(64, 256) X(128, 64) X(128, 128) X(128, 256)

namespace {

using namespace hopper;

constexpr int kShw = 16;     // SH features of a ray direction
constexpr int kTOut = 16;    // trunk output width, padded
constexpr int kRgbPad = 16;  // rgb-head output width, padded
constexpr int kCPad = 64;    // semantic-head output width, padded
constexpr float kTwoPi = 6.283185307179586f;

constexpr int kTileRows = 64;
constexpr int kPassRows = 128;
constexpr int kWg = 128;                       // threads of a warpgroup
constexpr int kFieldThreads = 3 * kWg;  // two consumer warpgroups and the producer's
// 2 x 128 x 232 + 128 x 40 registers fit the SM's 65,536 at every instance;
// the shipping one needs them (ptxas refused it at 128), the narrower ones
// leave some unused
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kActBytes = 4 * kImgBytes64;      // a warpgroup's activation buffer
constexpr int kFwdStages = 4;
constexpr int kAlignSlack = 1024;
constexpr int kUTileBytes = kTileRows * 3 * 4;  // a tile's coordinates

// The widths of one instance, in images and bytes.
template <int M, int H>
struct Tile {
  static_assert(M == 32 || M == 64 || M == 128, "M is 32, 64 or 128");
  static_assert(H == 64 || H == 128 || H == 256, "H is 64, 128 or 256");
  static constexpr int kHh = H / 4;                          // head width
  static constexpr int kEncImgs = 2 * M / 64;                // k-blocks of the first layer
  static constexpr int kHImgs = H / 64;                      // k-blocks of the other layers
  static constexpr int kEncBytes = kEncImgs * kImgBytes64;   // a tile's encoding
  static constexpr int kHBytes = kHImgs * kImgBytes64;       // a tile's hidden activation
  static constexpr int kTrunkSlab = H * kImgRowBytes;        // a trunk slab: [H, 64]
  static constexpr int kHeadImg = kHh * kImgRowBytes;        // a head layer's [H/4, 64]
};

// bytes of a forward ring slot: a trunk slab or the heads' output slab
__host__ __device__ constexpr int fwd_slot(int h) {
  return h * kImgRowBytes > (kRgbPad + kCPad) * kImgRowBytes ? h * kImgRowBytes
                                                             : (kRgbPad + kCPad) * kImgRowBytes;
}

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
  int ring, act, bias, u, bars, total;
};

// biases: the hidden layers', the trunk output's (16), the heads' first and
// second layers (rgb, sem: H/4 each) and their outputs (16, 64)
__host__ __device__ inline int bias_floats(int n_hidden, int h) {
  return n_hidden * h + kTOut + h + kRgbPad + kCPad;
}

__host__ __device__ inline FwdSmem fwd_smem(int h, int n_hidden) {
  FwdSmem s;
  s.ring = 0;
  s.act = kFwdStages * fwd_slot(h);
  s.bias = s.act + 2 * kActBytes;
  s.u = s.bias + (bias_floats(n_hidden, h) * 4 + 127) / 128 * 128;
  s.bars = s.u + 2 * 2 * kUTileBytes;  // per warpgroup: this pass's and the next one's
  s.total = s.bars + 16 * kFwdStages + kAlignSlack;
  return s;
}

// forward slab s of the schedule (field_images.py::fwd_slabs): the trunk's
// hidden layers, then with the heads the trunk output, the heads' two
// layers and their outputs
template <int M, int H>
__device__ __forceinline__ void fwd_slab(int s, int n_hidden, uint32_t& off, uint32_t& bytes) {
  using T = Tile<M, H>;
  const int n_trunk = T::kEncImgs + (n_hidden - 1) * T::kHImgs;
  const int t = s - n_trunk;
  const uint32_t base = (uint32_t)n_trunk * T::kTrunkSlab;
  const uint32_t out_t = T::kHImgs * kTOut * kImgRowBytes;
  if (t < 0) {
    off = (uint32_t)s * T::kTrunkSlab;
    bytes = T::kTrunkSlab;
  } else if (t == 0) {
    off = base;
    bytes = out_t;
  } else if (t == 1) {
    off = base + out_t;
    bytes = 2 * T::kHeadImg;
  } else if (t == 2) {
    off = base + out_t + 2 * T::kHeadImg;
    bytes = 2 * T::kHeadImg;
  } else {
    off = base + out_t + 4 * T::kHeadImg;
    bytes = kRgbPad * kImgRowBytes + kImgBytes64;
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
__device__ __forceinline__ void slab_end(Ring<kStages>& ring, int tid) {
  wgmma_commit();
  wgmma_wait<0>();
  if (tid == 0) mbar_arrive(ring.empty_bar());
  ring.advance();
}

// st[0 .. n) -> g[0 .. n) by the warpgroup's threads, 16 bytes at a time
// (g is 16-byte aligned)
__device__ __forceinline__ void copy_out(float* __restrict__ g, const float* st, int n, int tid) {
  const int n4 = n / 4;
  for (int e = tid; e < n4; e += kWg)
    reinterpret_cast<float4*>(g)[e] = reinterpret_cast<const float4*>(st)[e];
  for (int e = 4 * n4 + tid; e < n; e += kWg) g[e] = st[e];
}

// A tile's coordinates u[row0 .. row0 + 63, :] as 192 floats, two a thread
// (zero past n_rows): fetch issues the loads, stash puts them in shared memory.
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

// x[row0 .. row0 + 63, :din] (bf16, or f32 rounded to bf16) into the first
// `cols` / 64 images of `act`, zero past din and past n_rows; din is a
// multiple of 16 and every row 16-byte aligned
__device__ __forceinline__ void load_x_tile(const void* x, int x_f32, int din, int row0, int n_rows,
                                            int cols, unsigned char* act, int tid) {
  const int per_row = cols / 8;
  for (int e = tid; e < kTileRows * per_row; e += kWg) {
    const int i = e / per_row, col = 8 * (e % per_row);
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
    *reinterpret_cast<uint4*>(act + (col / 64) * kImgBytes64 + img_off(i, col % 64)) = val;
  }
}

// The field over every pass of this block, at the instance (M, H). P holds
// the FieldWeights members; S is NoSave or holds
//   enc, h[3], xs, hid1, hid2   bf16 tile images per 64-row tile: 2M/64,
//                               H/64, 1, 2, 2 images (hid: rgb | sem)
//   mask_t[3], mask_h           uint2 per (row, lane % 4): the ReLU masks
// The first layer's input is the encoding of u or, where x is given, x
// itself [n_rows, din] (bf16, or f32 when x_f32; din <= 2M). With `heads`
// false the pass ends after the trunk's hidden layers (the trunk kernels'
// backwards: Epi is then not called). Epi stages a tile's values in shared
// memory (density, rgb, sem) and writes them out (flush). smem is the
// block's dynamic shared memory, fwd_smem().total bytes. Every thread of
// the block calls it.
template <int M, int H, class P, class S, class Epi>
__device__ __forceinline__ void field_forward(const P& a, const S& sv,
                                              const float* __restrict__ u, const void* x,
                                              int x_f32, int din, bool heads,
                                              const float* __restrict__ sh, int n_rows,
                                              int n_samples, unsigned char* smem_raw, Epi epi) {
  using T = Tile<M, H>;
  constexpr int kHh = T::kHh;
  constexpr int kSlot = fwd_slot(H);
  unsigned char* smem = align_smem(smem_raw);
  const int nh = a.n_hidden;
  const FwdSmem L = fwd_smem(H, nh);
  float* bias_s = reinterpret_cast<float*>(smem + L.bias);
  const uint32_t full = smem_u32(smem + L.bars), empty = full + 8 * kFwdStages;
  const uint32_t ring_base = smem_u32(smem + L.ring);
  const bool encode = x == nullptr;
  for (int i = threadIdx.x; i < bias_floats(nh, H); i += kFieldThreads) bias_s[i] = a.bias[i];
  if (threadIdx.x == 0) ring_init<kFwdStages>(full, empty, 2);
  __syncthreads();
  const int n_pass = (n_rows + kPassRows - 1) / kPassRows;
  const int n_slabs = T::kEncImgs + (nh - 1) * T::kHImgs + (heads ? 4 : 0);
  Ring<kFwdStages> ring;
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
          fwd_slab<M, H>(s, nh, off, bytes);
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
  const int g = (tid % 32) / 4, q = tid % 4;
  const int r_lo = 16 * (tid / 32) + g;  // this thread's accumulator rows: r_lo, r_lo + 8
  const int bar_id = 1 + wg;
  unsigned char* act = smem + L.act + wg * kActBytes;
  const uint32_t act_a = smem_u32(act);
  const int G = a.geo, C = a.n_classes;
  // the encode: thread tid owns frequency f of the rows of its group
  constexpr int kGroups = kWg / M;
  const int f = tid % M, grp = tid / M;
  float w0 = 0.f, w1 = 0.f, w2 = 0.f, ph = 0.f;
  if (encode) {
    w0 = round_bf16(a.W[f]);
    w1 = round_bf16(a.W[M + f]);
    w2 = round_bf16(a.W[2 * M + f]);
    ph = a.phase[f];
  }

  // a bulk store of the buffer may still read it: wait before overwriting
  auto before_overwrite = [&]() {
    if constexpr (S::kSaves) {
      if (tid == 0) bulk_store_wait_read();
    }
    named_barrier(bar_id, kWg);
  };
  // the warpgroup's writes are visible to wgmma and to bulk stores
  auto after_write = [&]() {
    fence_async_smem();
    named_barrier(bar_id, kWg);
  };

  // the coordinates of a pass are fetched a pass ahead, so that the encode
  // does not wait on device memory
  float* u_s = reinterpret_cast<float*>(smem + L.u) + wg * 2 * (kUTileBytes / 4);
  int slot = 0;
  if (encode && (int)blockIdx.x < n_pass)
    stash_u(u_s, fetch_u(u, blockIdx.x * kPassRows + wg * kTileRows, n_rows, tid), tid);
  named_barrier(bar_id, kWg);

  for (int pass = blockIdx.x; pass < n_pass; pass += gridDim.x, slot ^= 1) {
    const int row0 = pass * kPassRows + wg * kTileRows;
    const size_t tile = (size_t)(row0 / kTileRows);
    const float* ut = u_s + slot * (kUTileBytes / 4);
    if (encode) {
      const int next = pass + gridDim.x;
      float2 u_next = make_float2(0.f, 0.f);
      if (next < n_pass) u_next = fetch_u(u, next * kPassRows + wg * kTileRows, n_rows, tid);

      // eight rows at a time, so that their sincosf chains overlap; the
      // groups of threads take every kGroups-th block of eight rows
      for (int b = grp; b < kTileRows / 8; b += kGroups) {
        const int i0 = 8 * b;
        float proj[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float* ur = ut + (i0 + k) * 3;  // zero past n_rows
          const float dot =
              round_bf16(ur[0]) * w0 + round_bf16(ur[1]) * w1 + round_bf16(ur[2]) * w2;
          proj[k] = __fadd_rn(__fmul_rn(dot, kTwoPi), ph);
        }
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          float s, c;
          sincosf(proj[k], &s, &c);
          *reinterpret_cast<bf16*>(act + (f / 64) * kImgBytes64 + img_off(i0 + k, f % 64)) =
              __float2bfloat16(c);
          *reinterpret_cast<bf16*>(act + ((M + f) / 64) * kImgBytes64 +
                                   img_off(i0 + k, (M + f) % 64)) = __float2bfloat16(s);
        }
      }
      stash_u(u_s + (slot ^ 1) * (kUTileBytes / 4), u_next, tid);
    } else {
      load_x_tile(x, x_f32, din, row0, n_rows, 2 * M, act, tid);
    }
    after_write();
    if constexpr (S::kSaves) {
      if (tid == 0) bulk_store(sv.enc + tile * (T::kEncBytes / 2), act_a, T::kEncBytes);
    }

    // trunk hidden layers, in place
    for (int l = 0; l < nh; ++l) {
      float d[H / 2];
      const int n_kb = l == 0 ? T::kEncImgs : T::kHImgs;
      for (int kb = 0; kb < n_kb; ++kb) {
        const uint32_t slab = slab_begin(ring, ring_base, kSlot);
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          wgmma<H, 0, 0>(d, kmajor_desc(act_a + kb * kImgBytes64, ks), kmajor_desc(slab, ks),
                         (kb | ks) != 0);
        slab_end(ring, tid);
      }
      before_overwrite();
      const float* b = bias_s + l * H;
      uint32_t mk[4] = {0u, 0u, 0u, 0u};  // [row half][word]
#pragma unroll
      for (int j = 0; j < H / 8; ++j) {
        const int c = 8 * j + 2 * q;
        const float2 bb = *reinterpret_cast<const float2*>(b + c);
        const uint32_t lo = pack_bf16(fmaxf(d[4 * j] + bb.x, 0.f), fmaxf(d[4 * j + 1] + bb.y, 0.f));
        const uint32_t hi =
            pack_bf16(fmaxf(d[4 * j + 2] + bb.x, 0.f), fmaxf(d[4 * j + 3] + bb.y, 0.f));
        unsigned char* img = act + (j / 8) * kImgBytes64;
        *reinterpret_cast<uint32_t*>(img + img_off(r_lo, c % 64)) = lo;
        *reinterpret_cast<uint32_t*>(img + img_off(r_lo + 8, c % 64)) = hi;
        if constexpr (S::kSaves) {
          mk[j / 16] |= pos_bits(lo) << (2 * (j % 16));
          mk[2 + j / 16] |= pos_bits(hi) << (2 * (j % 16));
        }
      }
      after_write();
      if constexpr (S::kSaves) {
        sv.mask_t[l][(size_t)(row0 + r_lo) * 4 + q] = make_uint2(mk[0], mk[1]);
        sv.mask_t[l][(size_t)(row0 + r_lo + 8) * 4 + q] = make_uint2(mk[2], mk[3]);
        if (tid == 0) bulk_store(sv.h[l] + tile * (T::kHBytes / 2), act_a, T::kHBytes);
      }
    }
    if (!heads) {
      // the next pass's encode overwrites the buffer the last store reads
      before_overwrite();
      continue;
    }

    // trunk output (f32), density, and the heads' input [bf16 SH | bf16 geo | 0]
    // as image 3 of the buffer
    float sig[2] = {0.f, 0.f}, dsd[2] = {0.f, 0.f};
    {
      float d[8];
      {
        const uint32_t slab = slab_begin(ring, ring_base, kSlot);
#pragma unroll
        for (int kb = 0; kb < T::kHImgs; ++kb) {
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
            wgmma_n16<0, 0>(d, kmajor_desc(act_a + kb * kImgBytes64, ks),
                            kmajor_desc(slab + kb * kTOut * kImgRowBytes, ks), (kb | ks) != 0);
        }
        slab_end(ring, tid);
      }
      before_overwrite();
      const float* b = bias_s + nh * H;
      unsigned char* xs = act + 3 * kImgBytes64;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int c = 8 * (e / 4) + 2 * q + (e & 1), half = (e >> 1) & 1;
        const int i = r_lo + 8 * half;
        const float v = d[e] + b[c];
        if (c == 0) {
          const int row = row0 + i;
          const float* ur = ut + i * 3;
          const bool in = row < n_rows && ur[0] > 0.f && ur[0] < 1.f && ur[1] > 0.f &&
                          ur[1] < 1.f && ur[2] > 0.f && ur[2] < 1.f;
          sig[half] = in ? expf(v - 1.f) : 0.f;
          dsd[half] = in ? expf(fminf(v - 1.f, 15.f)) : 0.f;
          *reinterpret_cast<bf16*>(xs + img_off(i, 2 * kShw - 1)) = __float2bfloat16(0.f);
        } else {
          *reinterpret_cast<bf16*>(xs + img_off(i, kShw - 1 + c)) =
              __float2bfloat16(c <= G ? v : 0.f);
        }
      }
      // chunks 0, 1: SH of the row's ray; chunks 4..7: zero
      for (int e = tid; e < kTileRows * 6; e += kWg) {
        const int i = e / 6, ch = e % 6 < 2 ? e % 6 : e % 6 + 2;
        const int row = row0 + i;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (ch < 2 && row < n_rows) {
          const float4* s4 =
              reinterpret_cast<const float4*>(sh + (size_t)(row / n_samples) * kShw + ch * 8);
          const float4 lo = s4[0], hi = s4[1];
          val = make_uint4(pack_bf16(lo.x, lo.y), pack_bf16(lo.z, lo.w), pack_bf16(hi.x, hi.y),
                           pack_bf16(hi.z, hi.w));
        }
        *reinterpret_cast<uint4*>(xs + img_off(i, ch * 8)) = val;
      }
      after_write();
      if constexpr (S::kSaves) {
        if (tid == 0) bulk_store(sv.xs + tile * (kImgBytes64 / 2), act_a + 3 * kImgBytes64,
                                 kImgBytes64);
      }
    }

    // heads: rgb on [SH | geo], semantics on geo; hidden activations in
    // images 0 (rgb), 1 (sem), columns H/4 .. 63 zero
    uint32_t mh[4] = {0u, 0u, 0u, 0u};  // [row half][rgb, sem]; layer 1 low 16 bits, layer 2 high
    for (int l = 0; l < 2; ++l) {
      float dr[kHh / 2], ds[kHh / 2];
      {
        const uint32_t slab = slab_begin(ring, ring_base, kSlot);
        if (l == 0) {
#pragma unroll
          for (int ks = 0; ks < 2; ++ks) {
            wgmma<kHh, 0, 0>(dr, kmajor_desc(act_a + 3 * kImgBytes64, ks), kmajor_desc(slab, ks),
                             ks != 0);
            wgmma<kHh, 0, 0>(ds, kmajor_desc(act_a + 3 * kImgBytes64, ks),
                             kmajor_desc(slab + T::kHeadImg, ks), ks != 0);
          }
        } else {
#pragma unroll
          for (int ks = 0; ks < kHh / 16; ++ks) {
            wgmma<kHh, 0, 0>(dr, kmajor_desc(act_a, ks), kmajor_desc(slab, ks), ks != 0);
            wgmma<kHh, 0, 0>(ds, kmajor_desc(act_a + kImgBytes64, ks),
                             kmajor_desc(slab + T::kHeadImg, ks), ks != 0);
          }
        }
        slab_end(ring, tid);
      }
      before_overwrite();
      const float* br = bias_s + nh * H + kTOut + l * 2 * kHh;
      const float* bs = br + kHh;
#pragma unroll
      for (int j = 0; j < kHh / 8; ++j) {
        const int c = 8 * j + 2 * q;
        const float2 b0 = *reinterpret_cast<const float2*>(br + c);
        const float2 b1 = *reinterpret_cast<const float2*>(bs + c);
        const uint32_t rl = pack_bf16(fmaxf(dr[4 * j] + b0.x, 0.f), fmaxf(dr[4 * j + 1] + b0.y, 0.f));
        const uint32_t rh =
            pack_bf16(fmaxf(dr[4 * j + 2] + b0.x, 0.f), fmaxf(dr[4 * j + 3] + b0.y, 0.f));
        const uint32_t sl = pack_bf16(fmaxf(ds[4 * j] + b1.x, 0.f), fmaxf(ds[4 * j + 1] + b1.y, 0.f));
        const uint32_t sh_ =
            pack_bf16(fmaxf(ds[4 * j + 2] + b1.x, 0.f), fmaxf(ds[4 * j + 3] + b1.y, 0.f));
        *reinterpret_cast<uint32_t*>(act + img_off(r_lo, c)) = rl;
        *reinterpret_cast<uint32_t*>(act + img_off(r_lo + 8, c)) = rh;
        *reinterpret_cast<uint32_t*>(act + kImgBytes64 + img_off(r_lo, c)) = sl;
        *reinterpret_cast<uint32_t*>(act + kImgBytes64 + img_off(r_lo + 8, c)) = sh_;
        if constexpr (S::kSaves) {
          const int at = 16 * l + 2 * j;
          mh[0] |= pos_bits(rl) << at;
          mh[1] |= pos_bits(sl) << at;
          mh[2] |= pos_bits(rh) << at;
          mh[3] |= pos_bits(sh_) << at;
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
        if (tid == 0) bulk_store(dst + tile * kImgBytes64, act_a, 2 * kImgBytes64);
      }
    }
    if constexpr (S::kSaves) {
      sv.mask_h[(size_t)(row0 + r_lo) * 4 + q] = make_uint2(mh[0], mh[1]);
      sv.mask_h[(size_t)(row0 + r_lo + 8) * 4 + q] = make_uint2(mh[2], mh[3]);
    }

    // head outputs into the staging area (the whole buffer is free by then)
    {
      float dr[8], ds[32];
      {
        const uint32_t slab = slab_begin(ring, ring_base, kSlot);
#pragma unroll
        for (int ks = 0; ks < kHh / 16; ++ks) {
          wgmma_n16<0, 0>(dr, kmajor_desc(act_a, ks), kmajor_desc(slab, ks), ks != 0);
          wgmma_n64<0, 0>(ds, kmajor_desc(act_a + kImgBytes64, ks),
                          kmajor_desc(slab + kRgbPad * kImgRowBytes, ks), ks != 0);
        }
        slab_end(ring, tid);
      }
      before_overwrite();
      float* st = reinterpret_cast<float*>(act);
      const float* br = bias_s + nh * H + kTOut + 4 * kHh;
      const float* bs = br + kRgbPad;
      if (q == 0) {
        epi.density(st, r_lo, sig[0], dsd[0]);
        epi.density(st, r_lo + 8, sig[1], dsd[1]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 2 * q + (e & 1);
        if (c < 3) epi.rgb(st, r_lo + 8 * (e >> 1), c, 1.f / (1.f + expf(-(dr[e] + br[c]))));
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + 2 * q + (e & 1);
          if (c < C) epi.sem(st, r_lo + 8 * (e >> 1), c, ds[4 * j + e] + bs[c]);
        }
      }
      named_barrier(bar_id, kWg);
      const int n_valid = min(kTileRows, n_rows - row0);
      if (n_valid > 0) epi.flush(st, row0, n_valid, tid);
      named_barrier(bar_id, kWg);
    }
  }
  if constexpr (S::kSaves) {
    if (tid == 0) bulk_store_wait();
  }
}

}  // namespace
