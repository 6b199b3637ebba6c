// The whole main field on the H100, shared by the kernels that evaluate
// it (fused_field_heads.cu, fused_field_volrend.cu). Same math as
// apnerf_tpu/ops/pallas/fused_field_heads.py::_make_field_fwd_kernel, rows
// as samples, the two heads formed and rounded as two heads:
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
// Design. A persistent block per SM: two consumer warpgroups, each owning
// a 64-row tile of a 128-row pass, and a producer warpgroup of which one
// thread works (setmaxnreg moves its registers to the consumers). Every layer is a
// wgmma product m64 x n (n = 256 in the trunk, one instruction chain per
// 64-column k-block) whose A operand is the warpgroup's own activation
// buffer in shared memory and whose B operand is a weight slab that the
// producer streams through a 4-slot ring with cp.async.bulk and mbarriers
// (the weights lie in global memory as ready tile images, hopper_tile.cuh),
// so the next slab's copy overlaps this slab's product and both
// warpgroups multiply against every slab. The accumulators stay in
// registers: bias, ReLU and the bf16 rounding are applied there and the
// result goes back, swizzled, over the layer's own input as the next A
// operand. Both heads run on the warpgroup's own rows, rgb and semantics
// as two n = 64 chains of one batch. What a kernel does with a tile's
// values is its epilogue struct: it stages them in shared memory and
// writes them out as 16-byte stores. A kernel with a backward passes a
// save struct: the activations leave as whole tile images by bulk stores
// (the layout the weight-gradient kernel multiplies from) and the ReLU
// masks as two words per thread, in the accumulator's own bit order.
//
// What bounds it: on paper tensor-core math (a row costs ~0.45 MFLOP against
// ~150 bytes). On the card the kernel reaches about a third of that bound
// (PERF.md), and a pass of 128 rows splits into three parts of about
// equal size: the trunk's products, during which the tensor pipe is busy
// for one warpgroup or the other; the encode, 128 precise sincosf a row,
// bound by instruction issue, which both warpgroups run at the same time
// and which therefore hides behind no product (without it the kernel takes
// 27 % less); and the latency chain of the five small products and
// epilogues after the trunk. The slab ring is not in the way: the kernel
// takes the same time with the ring's copies left out, and with the hidden
// layers' epilogue stores left out. Letting the warpgroups take turns at
// the tensor cores, and keeping two slabs' products in flight, each moved
// it by under 3 % and were taken out again. The ring re-reads the ~440 KB
// of weight images from L2 once per 128 rows, ~2.6 TB/s at this speed; a
// faster tile would need a cluster's multicast or more rows a block.

#pragma once

#include "hopper_tile.cuh"

// The field's weights as the kernels read them (field_images.py builds
// the buffers). At namespace scope: extern "C" entries take structs that
// hold it.
struct FieldWeights {
  const float* W;      // [3, 128]
  const float* phase;  // [128]
  const __nv_bfloat16* wfwd;  // forward slabs
  const __nv_bfloat16* wbwd;  // backward slabs
  const float* bias;          // every layer's bias, padded (bias_offsets)
  int n_hidden;               // trunk hidden layers, 2 or 3
  int geo, n_classes;
};

// The save struct of a kernel that keeps no activation.
struct NoSave {
  static constexpr bool kSaves = false;
};

namespace {

using namespace hopper;

constexpr int kM = 128;      // spectral frequencies
constexpr int kH = 256;      // trunk width
constexpr int kHh = 64;      // head width
constexpr int kShw = 16;     // SH features of a ray direction
constexpr int kTOut = 16;    // trunk output width, padded
constexpr int kRgbPad = 16;  // rgb-head output width, padded
constexpr int kCPad = 64;    // semantic-head output width, padded
constexpr float kTwoPi = 6.283185307179586f;

constexpr int kTileRows = 64;
constexpr int kPassRows = 128;
constexpr int kWg = 128;                       // threads of a warpgroup
constexpr int kFieldThreads = 3 * kWg;  // two consumer warpgroups and the producer's
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kSlabBytes = 256 * kImgRowBytes;  // a ring slot
constexpr int kActBytes = 4 * kImgBytes64;      // a warpgroup's activation buffer
constexpr int kFwdStages = 4;
constexpr int kAlignSlack = 1024;

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

constexpr int kUTileBytes = kTileRows * 3 * 4;  // a tile's coordinates

__host__ __device__ inline int bias_floats(int n_hidden) { return n_hidden * kH + 352; }

__host__ __device__ inline FwdSmem fwd_smem(int n_hidden) {
  FwdSmem s;
  s.ring = 0;
  s.act = kFwdStages * kSlabBytes;
  s.bias = s.act + 2 * kActBytes;
  s.u = s.bias + (bias_floats(n_hidden) * 4 + 127) / 128 * 128;
  s.bars = s.u + 2 * 2 * kUTileBytes;  // per warpgroup: this pass's and the next one's
  s.total = s.bars + 16 * kFwdStages + kAlignSlack;
  return s;
}

// forward slab s of the schedule (field_images.py::fwd_slabs)
__device__ __forceinline__ void fwd_slab(int s, int n_hidden, uint32_t& off, uint32_t& bytes) {
  const int t = s - 4 * n_hidden;
  const uint32_t base = 4u * n_hidden * kSlabBytes;
  if (t < 0) {
    off = (uint32_t)s * kSlabBytes;
    bytes = kSlabBytes;
  } else if (t == 0) {
    off = base;
    bytes = 4 * kTOut * kImgRowBytes;
  } else if (t == 1) {
    off = base + 8192;
    bytes = 2 * kImgBytes64;
  } else if (t == 2) {
    off = base + 8192 + 16384;
    bytes = 2 * kImgBytes64;
  } else {
    off = base + 8192 + 32768;
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

// The field over every pass of this block. P holds the FieldWeights
// members; S is NoSave or holds
//   enc, h[3], xs, hid1, hid2   bf16 tile images per 64-row tile: 4, 4, 1,
//                               2, 2 images (hid: rgb | sem)
//   mask_t[3], mask_h           uint2 per (row, lane % 4): the ReLU masks
// Epi stages a tile's values in shared memory (density, rgb, sem) and
// writes them out (flush). smem is the block's dynamic shared memory,
// fwd_smem().total bytes. Every thread of the block calls it.
template <class P, class S, class Epi>
__device__ __forceinline__ void field_forward(const P& a, const S& sv,
                                              const float* __restrict__ u,
                                              const float* __restrict__ sh, int n_rows,
                                              int n_samples, unsigned char* smem_raw, Epi epi) {
  unsigned char* smem = align_smem(smem_raw);
  const int nh = a.n_hidden;
  const FwdSmem L = fwd_smem(nh);
  float* bias_s = reinterpret_cast<float*>(smem + L.bias);
  const uint32_t full = smem_u32(smem + L.bars), empty = full + 8 * kFwdStages;
  const uint32_t ring_base = smem_u32(smem + L.ring);
  for (int i = threadIdx.x; i < bias_floats(nh); i += kFieldThreads) bias_s[i] = a.bias[i];
  if (threadIdx.x == 0) ring_init<kFwdStages>(full, empty, 2);
  __syncthreads();
  const int n_pass = (n_rows + kPassRows - 1) / kPassRows;
  const int n_slabs = 4 * nh + 4;
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
          fwd_slab(s, nh, off, bytes);
          ring.wait_empty();
          mbar_expect_tx(ring.full_bar(), bytes);
          bulk_load(ring_base + ring.stage * kSlabBytes, w + off, bytes, ring.full_bar());
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
  const float w0 = round_bf16(a.W[tid]), w1 = round_bf16(a.W[kM + tid]),
              w2 = round_bf16(a.W[2 * kM + tid]), ph = a.phase[tid];

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
  if ((int)blockIdx.x < n_pass)
    stash_u(u_s, fetch_u(u, blockIdx.x * kPassRows + wg * kTileRows, n_rows, tid), tid);
  named_barrier(bar_id, kWg);

  for (int pass = blockIdx.x; pass < n_pass; pass += gridDim.x, slot ^= 1) {
    const int row0 = pass * kPassRows + wg * kTileRows;
    const size_t tile = (size_t)(row0 / kTileRows);
    const float* ut = u_s + slot * (kUTileBytes / 4);
    const int next = pass + gridDim.x;
    float2 u_next = make_float2(0.f, 0.f);
    if (next < n_pass) u_next = fetch_u(u, next * kPassRows + wg * kTileRows, n_rows, tid);

    // encode: thread tid owns frequency tid of every row; eight rows at a
    // time, so that their sincosf chains overlap
    for (int i0 = 0; i0 < kTileRows; i0 += 8) {
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
        *reinterpret_cast<bf16*>(act + (tid / 64) * kImgBytes64 + img_off(i0 + k, tid % 64)) =
            __float2bfloat16(c);
        *reinterpret_cast<bf16*>(act + (2 + tid / 64) * kImgBytes64 + img_off(i0 + k, tid % 64)) =
            __float2bfloat16(s);
      }
    }
    stash_u(u_s + (slot ^ 1) * (kUTileBytes / 4), u_next, tid);
    after_write();
    if constexpr (S::kSaves) {
      if (tid == 0) bulk_store(sv.enc + tile * (kActBytes / 2), act_a, kActBytes);
    }

    // trunk hidden layers, in place
    for (int l = 0; l < nh; ++l) {
      float d[128];
      for (int kb = 0; kb < 4; ++kb) {
        const uint32_t slab = slab_begin(ring, ring_base, kSlabBytes);
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          wgmma_n256<0, 0>(d, kmajor_desc(act_a + kb * kImgBytes64, ks), kmajor_desc(slab, ks),
                           (kb | ks) != 0);
        slab_end(ring, tid);
      }
      before_overwrite();
      const float* b = bias_s + l * kH;
      uint32_t mk[4] = {0u, 0u, 0u, 0u};  // [row half][word]
#pragma unroll
      for (int j = 0; j < 32; ++j) {
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
        if (tid == 0) bulk_store(sv.h[l] + tile * (kActBytes / 2), act_a, kActBytes);
      }
    }

    // trunk output (f32), density, and the heads' input [bf16 SH | bf16 geo | 0]
    // as image 3 of the buffer
    float sig[2] = {0.f, 0.f}, dsd[2] = {0.f, 0.f};
    {
      float d[8];
      {
        const uint32_t slab = slab_begin(ring, ring_base, kSlabBytes);
#pragma unroll
        for (int kb = 0; kb < 4; ++kb) {
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
            wgmma_n16<0, 0>(d, kmajor_desc(act_a + kb * kImgBytes64, ks),
                            kmajor_desc(slab + kb * kTOut * kImgRowBytes, ks), (kb | ks) != 0);
        }
        slab_end(ring, tid);
      }
      before_overwrite();
      const float* b = bias_s + nh * kH;
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

    // heads: rgb on [SH | geo], semantics on geo; hidden activations in images 0 (rgb), 1 (sem)
    uint32_t mh[4] = {0u, 0u, 0u, 0u};  // [row half][rgb, sem]; layer 1 low 16 bits, layer 2 high
    for (int l = 0; l < 2; ++l) {
      float dr[32], ds[32];
      {
        const uint32_t slab = slab_begin(ring, ring_base, kSlabBytes);
        if (l == 0) {
#pragma unroll
          for (int ks = 0; ks < 2; ++ks) {
            wgmma_n64<0, 0>(dr, kmajor_desc(act_a + 3 * kImgBytes64, ks), kmajor_desc(slab, ks),
                            ks != 0);
            wgmma_n64<0, 0>(ds, kmajor_desc(act_a + 3 * kImgBytes64, ks),
                            kmajor_desc(slab + kImgBytes64, ks), ks != 0);
          }
        } else {
#pragma unroll
          for (int ks = 0; ks < 4; ++ks) {
            wgmma_n64<0, 0>(dr, kmajor_desc(act_a, ks), kmajor_desc(slab, ks), ks != 0);
            wgmma_n64<0, 0>(ds, kmajor_desc(act_a + kImgBytes64, ks),
                            kmajor_desc(slab + kImgBytes64, ks), ks != 0);
          }
        }
        slab_end(ring, tid);
      }
      before_overwrite();
      const float* br = bias_s + nh * kH + 16 + l * 128;
      const float* bs = br + 64;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
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
        const uint32_t slab = slab_begin(ring, ring_base, kSlabBytes);
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          wgmma_n16<0, 0>(dr, kmajor_desc(act_a, ks), kmajor_desc(slab, ks), ks != 0);
          wgmma_n64<0, 0>(ds, kmajor_desc(act_a + kImgBytes64, ks),
                          kmajor_desc(slab + kRgbPad * kImgRowBytes, ks), ks != 0);
        }
        slab_end(ring, tid);
      }
      before_overwrite();
      float* st = reinterpret_cast<float*>(act);
      const float* br = bias_s + nh * kH + 16 + 256;
      const float* bs = br + 16;
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
