// The whole train render: field, volume rendering, the 3-term loss and
// the closed-form backward to every main-field parameter gradient.
//
// Replaces apnerf_tpu/ops/pallas/fused_field_volrend.py::
// fused_field_volrend_lossgrad (kernel _make_fvr_lossgrad_kernel,
// launched by _call_fvr_lossgrad), with its helpers _field_fwd_chains,
// _volrend_chains and _field_bwd_v. Same math, not the TPU's layout:
// rows are samples, row-major, the two heads stay two heads.
//
//   field     proj = 2*pi * (bf16(u) . bf16(W)) + phase;  enc = bf16[cos, sin]
//             trunk: bf16(relu(. @ w + b)) hidden layers, f32 last layer
//             -> raw, geo = bf16(out[1:]);  sigma = exp(raw - 1) * in-cube
//             rgb = sigmoid(head_rgb([bf16 SH(dir), geo])); sem = head_sem(geo)
//   volrend   a = sigma * dt;  T = exp(-exclusive sum a);  w = T (1 - e^-a)
//   per ray   sums of bf16(w rgb), bf16(w), bf16(w t_mid), bf16(w sem)
//   loss      huber(rgb + bk (1 - op), pix) + huber(depth, dgt) + CE(sem)
//   backward  bf16 cotangents of the sums; dw from the direct terms;
//             da = dw T e^-a - sum_{j>s} dw_j w_j;  dsigma = da dt;
//             graw = dsigma exp(min(raw - 1, 15)) * in-cube; then back
//             through both heads, the trunk and the encode.
//
// What bounds it on an H100: tensor-core math. A row costs ~1.3 MFLOP
// across forward and backward (the 3x256 trunk three times over), and a
// member step has 262,144 rows, ~3.4e11 FLOP. The design is several
// launches from one wrapper, all written here, no library product; every
// matrix pass is wgmma on 128-byte-swizzled tile images, its weights
// streamed through a shared-memory ring by cp.async.bulk (hopper_tile.cuh,
// field_tile.cuh):
//   1. fvr_field_fwd_kernel: the whole field (field_tile.cuh) with a save
//      struct: the bf16 activations leave as tile images by bulk stores
//      (~0.7 GB per call at the shipping shape), the ReLU masks as bits,
//      and the per-sample sigma, rgb, sem as staged 16-byte stores;
//   2. fvr_ray_kernel: one warp per ray, so the exclusive and the
//      reverse scans are warp scans; weights, per-ray sums, loss rows and
//      the per-sample cotangents;
//   3. fvr_field_bwd_kernel: dX = dY W^T with the ReLU masks applied in
//      registers, the same persistent two-warpgroup block as the forward,
//      back to the spectral phase; every cotangent leaves as tile images,
//      and per-tile f32 column sums give the bias, phase and spectrum
//      gradients;
//   4. dw_kernel: dW = X^T dY, one launch for every weight: the saved
//      images are the MN-major wgmma operands as they lie, rows are the
//      product's K, and each block sums a chunk of row tiles into f32
//      partials; dw_reduce_kernel adds the partials in a fixed order, so
//      the gradients are the same from run to run (float atomics would
//      not be).
// At the train shape (262,144 rows; PERF.md) the four launches take
// 0.43, 0.20, 0.48 and 0.55 ms. The forward and the backward are within
// 2x of the device-memory time of what they save and reload (~0.7 GB each
// way), the weight gradients at it: a block holds a [128, 256] f32
// accumulator, so each trunk matrix is two items that both read its dY,
// 1.8 GB a call at the card's 3.35 TB/s. From the wrapper the call is
// bound by the host, not by these kernels.
//
// The file also holds the ray kernel of the forward-only render
// (fused_field_volrend's forward, section 2b below), which shares the
// per-ray scan with fvr_ray_kernel and stops after the sums, and that
// render's backward (TPU counterpart _make_fvr_bwd_kernel,
// launched by _call_fvr_bwd): launches 1, 3 and 4 as they are, and
// fvr_ray_kernel<false>, which starts from the given cotangents of the
// per-ray sums and of the weights instead of the loss. The packed field's
// backward (fused_field_heads.cu) runs launches 1, 3 and 4 too. The field
// backward returns the position gradient du where the call asks for it.

#include <cfloat>

#include "field_train_args.cuh"
#include "warp_reduce.cuh"

namespace {

constexpr int kRayWarps = 8;    // rays per block of fvr_ray_kernel
constexpr int kRayChan = 128;   // per-ray channel slots in shared memory (3 + C <= 64, twice)

// bias layout of a tile_part row: trunk pre-activation sums (n_hidden x H),
// trunk output (16), rgb head (hh, hh), sem head (hh, hh), dphase (M),
// dW_spec (3 x M, scaled by 2 pi)
__host__ __device__ inline int n_bias(int n_hidden) {
  return n_hidden * kH + kTOut + 4 * kHh + 4 * kM;
}

// ---- 1. field forward -------------------------------------------------------

// per-sample outputs of the train step's field pass: each staged as the
// tile's contiguous run of its array
struct TrainEpilogue {
  float* sigma;
  float* dsd;
  float* rgb_out;
  float* sem_out;
  int n_classes;
  __device__ void density(float* st, int i, float s, float d) {
    st[i] = s;
    st[kTileRows + i] = d;
  }
  __device__ void rgb(float* st, int i, int c, float v) { st[2 * kTileRows + i * 3 + c] = v; }
  __device__ void sem(float* st, int i, int c, float v) {
    st[5 * kTileRows + i * n_classes + c] = v;
  }
  __device__ void flush(const float* st, int row0, int n_valid, int tid) {
    copy_out(sigma + row0, st, n_valid, tid);
    copy_out(dsd + row0, st + kTileRows, n_valid, tid);
    copy_out(rgb_out + (size_t)row0 * 3, st + 2 * kTileRows, n_valid * 3, tid);
    copy_out(sem_out + (size_t)row0 * n_classes, st + 5 * kTileRows, n_valid * n_classes, tid);
  }
};

__global__ void __launch_bounds__(kFieldThreads, 1)
    fvr_field_fwd_kernel(const __grid_constant__ FvrArgs a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  // the call's arguments are the field's weights and its save buffers
  field_forward(a, a, a.u, a.sh, a.n_rows, a.n_samples, smem,
                TrainEpilogue{a.sigma, a.dsd, a.rgb, a.sem, a.n_classes});
}

// ---- 2. per-ray volume rendering, loss and cotangents -------------------------

// kLoss: the train step's kernel, which forms the loss and its per-ray
// cotangents itself. Otherwise the backward of the forward-only render:
// the per-ray cotangents are given (g_acc, rounded to bf16 as the TPU
// kernel rounds them, and g_w, which may be null), the weights are
// recomputed and nothing but the per-sample cotangents is written.
template <bool kLoss>
__global__ void __launch_bounds__(kRayWarps * 32) fvr_ray_kernel(FvrArgs a) {
  extern __shared__ float rsm[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ray = blockIdx.x * kRayWarps + warp;
  if (ray >= a.n_rays) return;  // uniform across the warp
  const int S = a.n_samples, C = a.n_classes, NC = 3 + C;
  float* wb = rsm + (size_t)warp * (2 * S + 2 * kRayChan);
  float* tb = wb + S;
  float* acc = tb + S;         // [NC] per-ray sums: rgb, then semantics
  float* gch = acc + kRayChan;  // [NC] their bf16-rounded cotangents
  const size_t base = (size_t)ray * S;
  const float eps = FLT_EPSILON;

  // weights, opacity and depth numerator
  float carry = 0.f, op = 0.f, dn = 0.f;
  for (int c0 = 0; c0 < S; c0 += 32) {
    const int i = c0 + lane;
    float s = 0.f;
    if (i < S) s = a.sigma[base + i] * a.dt[base + i];
    float incl = s;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += v;
    }
    if (i < S) {
      const float t = expf(-((carry + incl) - s));
      const float w = t * (1.f - expf(-s));
      wb[i] = w;
      tb[i] = t;
      if constexpr (kLoss) {
        a.w[base + i] = w;
        op += round_bf16(w);
        dn += round_bf16(w * a.tm[base + i]);
      }
    }
    carry += __shfl_sync(kFull, incl, 31);
  }
  float gop, gdn;  // bf16-rounded cotangents of the opacity and the depth numerator
  if constexpr (kLoss) {
    op = warp_sum(op);
    dn = warp_sum(dn);
    __syncwarp();
    for (int ch = lane; ch < NC; ch += 32) {
      float s = 0.f;
      for (int i = 0; i < S; ++i) {
        const float v = ch < 3 ? a.rgb[(base + i) * 3 + ch] : a.sem[(base + i) * C + (ch - 3)];
        s += round_bf16(v * wb[i]);
      }
      acc[ch] = s;
    }
    __syncwarp();

    // loss and its cotangents (every lane holds the ray's scalars)
    float l_rgb = 0.f, g_op = 0.f;
    for (int c = 0; c < 3; ++c) {
      const float bkc = a.bk[c];
      const float res = acc[c] + bkc * (1.f - op) - a.pix[(size_t)ray * 3 + c];
      const float ares = fabsf(res);
      const float hub = fminf(fmaxf(res, -1.f), 1.f);
      l_rgb += ares <= 1.f ? 0.5f * res * res : ares - 0.5f;
      g_op += hub * (-bkc);
      if (lane == 0) gch[c] = round_bf16(a.c_rgb * hub);
    }
    const float ope = fmaxf(op, eps);
    const float dres = dn / ope - a.dgt[ray];
    const float adres = fabsf(dres);
    const float hubd = fminf(fmaxf(dres, -1.f), 1.f);
    const float l_dep = adres <= 1.f ? 0.5f * dres * dres : adres - 0.5f;
    g_op = a.c_rgb * g_op + (op > eps ? a.c_dep * hubd * (-dn) / (ope * ope) : 0.f);
    gop = round_bf16(g_op);
    gdn = round_bf16(a.c_dep * hubd / ope);
    float mx = -FLT_MAX;
    for (int k = lane; k < C; k += 32) mx = fmaxf(mx, acc[3 + k]);
    mx = warp_max(mx);
    float zs = 0.f;
    for (int k = lane; k < C; k += 32) zs += expf(acc[3 + k] - mx);
    zs = warp_sum(zs);
    const int lb = a.lab[ray];
    for (int k = lane; k < C; k += 32)
      gch[3 + k] = round_bf16(a.c_sem * (expf(acc[3 + k] - mx) / zs - (k == lb ? 1.f : 0.f)));
    if (lane == 0) {
      const float picked = (lb >= 0 && lb < C) ? acc[3 + lb] : 0.f;
      a.lossrows[ray] = l_rgb;
      a.lossrows[a.n_rays + ray] = l_dep;
      a.lossrows[2 * a.n_rays + ray] = mx + logf(zs) - picked;
    }
  } else {
    // acc columns: 0:3 rgb, 3 opacity, 4 depth numerator, 5: semantics
    const float* ga = a.g_acc + (size_t)ray * (5 + C);
    for (int ch = lane; ch < NC; ch += 32) gch[ch] = round_bf16(ga[ch < 3 ? ch : ch + 2]);
    gop = round_bf16(ga[3]);
    gdn = round_bf16(ga[4]);
  }
  __syncwarp();

  // dw from the direct terms, the reverse scan of dw*w, and the per-sample
  // cotangents of raw and of the head outputs
  float pr0 = 0.f, pr1 = 0.f, pr2 = 0.f, wsum = 0.f;
  carry = 0.f;  // sum of dw*w over the later chunks
  for (int c0 = ((S - 1) / 32) * 32; c0 >= 0; c0 -= 32) {
    const int i = c0 + lane;
    float v = 0.f, dw = 0.f;
    if (i < S) {
      const size_t row = base + i;
      const float w = wb[i];
      const float* rg = a.rgb + row * 3;
      dw = gop + a.tm[row] * gdn;
      float gp[3];
      for (int c = 0; c < 3; ++c) {
        dw += rg[c] * gch[c];
        gp[c] = gch[c] * w * rg[c] * (1.f - rg[c]);
      }
      const float* sr = a.sem + row * C;
      for (int k = 0; k < C; ++k) dw += sr[k] * gch[3 + k];
      if constexpr (!kLoss) {
        if (a.g_w != nullptr) dw += a.g_w[row];
      }
      v = dw * w;
      pr0 += gp[0];
      pr1 += gp[1];
      pr2 += gp[2];
      wsum += w;
      bf16* go = a.gout_rgb + row * kRgbPad;
      for (int c = 0; c < kRgbPad; ++c) go[c] = __float2bfloat16(c < 3 ? gp[c] : 0.f);
      bf16* gs = a.gout_sem + row * a.c_pad;
      for (int k = 0; k < a.c_pad; ++k) gs[k] = __float2bfloat16(k < C ? gch[3 + k] * w : 0.f);
    }
    float incl = v;  // sum over lanes >= lane of this chunk
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float t = __shfl_down_sync(kFull, incl, off);
      if (lane + off < 32) incl += t;
    }
    if (i < S) {
      const size_t row = base + i;
      const float suffix = (carry + incl) - v;
      const float s = a.sigma[row] * a.dt[row];
      const float da = dw * tb[i] * expf(-s) - suffix;
      a.graw[row] = da * a.dt[row] * a.dsd[row];
    }
    carry += __shfl_sync(kFull, incl, 0);
  }
  pr0 = warp_sum(pr0);
  pr1 = warp_sum(pr1);
  pr2 = warp_sum(pr2);
  wsum = warp_sum(wsum);
  float* part = a.ray_part + (size_t)ray * (kRgbPad + a.c_pad);
  for (int c = lane; c < kRgbPad + a.c_pad; c += 32) {
    float v = 0.f;
    if (c == 0) v = pr0;
    else if (c == 1) v = pr1;
    else if (c == 2) v = pr2;
    else if (c >= kRgbPad && c - kRgbPad < C) v = gch[3 + c - kRgbPad] * wsum;
    part[c] = v;
  }
}

// ---- 2b. forward-only volume rendering over packed field values ------------------
//
// Replaces apnerf_tpu/ops/pallas/fused_field_volrend.py::fused_field_volrend
// (forward: kernel _make_fvr_fwd_kernel, launched by _call_fvr_fwd) together
// with the packed field pass of fused_field_heads.cu, which the wrapper
// launches first: a = sigma dt, T = exp(-exclusive sum a), w = T (1 - e^-a),
// then per ray the f32 sums of bf16(w rgb), bf16(w), bf16(w t_mid) and
// bf16(w sem), the TPU kernel's rounding points. y is the packed field
// output [n_rays * S, 4 + C]; acc is row-major [n_rays, 5 + C]: 0:3 rgb,
// 3 opacity, 4 depth numerator, 5: semantics. One warp per ray, the scan
// chunked by 32 with a carry, so any S and any ray count go. Memory-bound:
// it reads 4 (4 + C) + 8 bytes per sample once and writes 4.
__global__ void __launch_bounds__(kRayWarps * 32)
    fvr_fwd_ray_kernel(const float* __restrict__ y, const float* __restrict__ dt,
                       const float* __restrict__ tm, float* __restrict__ acc,
                       float* __restrict__ w_out, int n_rays, int S, int C) {
  extern __shared__ float rsm[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ray = blockIdx.x * kRayWarps + warp;
  if (ray >= n_rays) return;  // uniform across the warp
  const int ld = 4 + C;
  float* wb = rsm + (size_t)warp * S;
  const size_t base = (size_t)ray * S;

  float carry = 0.f, op = 0.f, dn = 0.f;
  for (int c0 = 0; c0 < S; c0 += 32) {
    const int i = c0 + lane;
    float s = 0.f;
    if (i < S) s = y[(base + i) * ld + 3] * dt[base + i];
    float incl = s;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += v;
    }
    if (i < S) {
      const float t = expf(-((carry + incl) - s));
      const float w = t * (1.f - expf(-s));
      wb[i] = w;
      w_out[base + i] = w;
      op += round_bf16(w);
      dn += round_bf16(w * tm[base + i]);
    }
    carry += __shfl_sync(kFull, incl, 31);
  }
  op = warp_sum(op);
  dn = warp_sum(dn);
  __syncwarp();
  float* out = acc + (size_t)ray * (5 + C);
  for (int ch = lane; ch < 3 + C; ch += 32) {
    const int col = ch < 3 ? ch : ch + 1;  // past the sigma column
    float s = 0.f;
    for (int i = 0; i < S; ++i) s += round_bf16(y[(base + i) * ld + col] * wb[i]);
    out[ch < 3 ? ch : ch + 2] = s;
  }
  if (lane == 0) {
    out[3] = op;
    out[4] = dn;
  }
}

// ---- 3. field backward ------------------------------------------------------------
//
// The forward's block design run backwards: per 128-row pass the producer
// warp streams the backward slabs (B[n][k] = w[n][k0 + k], so the product
// is dX = dY W^T) and then the two tiles' saved encodings; each consumer
// warpgroup walks its 64 rows from the head outputs down to the spectral
// phase with its cotangent buffer (four images) as the A operand. The ReLU
// masks come as bits in the accumulator's own order, two words a thread a
// layer. Image slots of the buffer over time:
//   0 gout_rgb -> g1 rgb   1 gout_sem -> g1 sem   2 g2 rgb -> gt
//   3 g2 sem -> f32 trunk-output cotangent (for its column sums)
// then all four hold gh[l], and at the end the f32 dproj [64, 128].

constexpr int kBwdStages = 4;

struct BwdSmem {
  int ring, act, u, bars, total;
};

__host__ __device__ inline BwdSmem bwd_smem() {
  BwdSmem s;
  s.ring = 0;
  s.act = kBwdStages * kSlabBytes;
  s.u = s.act + 2 * kActBytes;
  s.bars = s.u + 2 * kUTileBytes;  // a tile's coordinates per warpgroup
  s.total = s.bars + 16 * kBwdStages + kAlignSlack;
  return s;
}

// backward weight slab s of the schedule (field_images.py::bwd_slabs)
__device__ __forceinline__ void bwd_slab(int s, uint32_t& off, uint32_t& bytes) {
  if (s == 0) {
    off = 0;
    bytes = 2 * kImgBytes64;
  } else if (s == 1) {
    off = 16384;
    bytes = 2 * kImgBytes64;
  } else if (s == 2) {
    off = 32768;
    bytes = 2 * 32 * kImgRowBytes;
  } else {
    off = 40960 + (uint32_t)(s - 3) * kSlabBytes;
    bytes = kSlabBytes;
  }
}

// part[c] = sum over the image's 64 rows of column c (bf16 values, f32 sum,
// rows in order)
__device__ __forceinline__ float image_column_sum(const unsigned char* img, int c) {
  float acc = 0.f;
#pragma unroll 16
  for (int i = 0; i < kTileRows; ++i)
    acc += __bfloat162float(*reinterpret_cast<const bf16*>(img + img_off(i, c)));
  return acc;
}

// masked bf16 pair: element e kept where bit e of `bits` is set
__device__ __forceinline__ uint32_t masked_pack(float lo, float hi, uint32_t bits) {
  return pack_bf16((bits & 1u) ? lo : 0.f, (bits & 2u) ? hi : 0.f);
}

// f32 dproj element (i, j) of the swizzled [64, 128] buffer
__device__ __forceinline__ int dp_at(int i, int j) { return i * kM + (j ^ ((i & 7) << 3)); }

__global__ void __launch_bounds__(kFieldThreads, 1)
    fvr_field_bwd_kernel(const __grid_constant__ FvrArgs a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);
  const BwdSmem L = bwd_smem();
  const int nh = a.n_hidden;
  const uint32_t full = smem_u32(smem + L.bars), empty = full + 8 * kBwdStages;
  const uint32_t ring_base = smem_u32(smem + L.ring);
  if (threadIdx.x == 0) ring_init<kBwdStages>(full, empty, 2);
  __syncthreads();
  const int n_pass = (a.n_rows + kPassRows - 1) / kPassRows;
  const int n_slabs = 4 + 4 * nh;
  Ring<kBwdStages> ring;
  ring.full = full;
  ring.empty = empty;

  if (threadIdx.x >= 2 * kWg) {
    // ---- producer: the weight slabs, then the two tiles' saved encodings
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 2 * kWg) {
      const unsigned char* w = reinterpret_cast<const unsigned char*>(a.wbwd);
      for (int pass = blockIdx.x; pass < n_pass; pass += gridDim.x) {
        for (int s = 0; s < n_slabs + 2; ++s) {
          uint32_t off, bytes;
          const unsigned char* src;
          if (s < n_slabs) {
            bwd_slab(s, off, bytes);
            src = w + off;
          } else {
            bytes = kActBytes;
            src = reinterpret_cast<const unsigned char*>(a.enc) +
                  (size_t)(2 * pass + (s - n_slabs)) * kActBytes;
          }
          ring.wait_empty();
          mbar_expect_tx(ring.full_bar(), bytes);
          bulk_load(ring_base + ring.stage * kSlabBytes, src, bytes, ring.full_bar());
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
  const int G = a.geo, cp = a.c_pad;
  const int off_gtr = nh * kH;
  const int off_r1 = off_gtr + kTOut;
  const int off_r2 = off_r1 + kHh, off_s1 = off_r2 + kHh, off_s2 = off_s1 + kHh;
  const int off_dph = off_s2 + kHh;  // then dW_spec at off_dph + M
  float* u_s = reinterpret_cast<float*>(smem + L.u) + wg * (kUTileBytes / 4);

  auto before_overwrite = [&]() {
    if (tid == 0) bulk_store_wait_read();
    named_barrier(bar_id, kWg);
  };
  auto after_write = [&]() {
    fence_async_smem();
    named_barrier(bar_id, kWg);
  };

  for (int pass = blockIdx.x; pass < n_pass; pass += gridDim.x) {
    const int row0 = pass * kPassRows + wg * kTileRows;
    const size_t tile = (size_t)(row0 / kTileRows);
    float* part = a.tile_part + tile * n_bias(nh);
    const uint2 mh_lo = a.mask_h[(size_t)(row0 + r_lo) * 4 + q];
    const uint2 mh_hi = a.mask_h[(size_t)(row0 + r_lo + 8) * 4 + q];
    // what the end of the pass reads from device memory is fetched now
    stash_u(u_s, fetch_u(a.u, row0, a.n_rows, tid), tid);
    float graw[2] = {0.f, 0.f};
    if (q == 0) {
      if (row0 + r_lo < a.n_rows) graw[0] = a.graw[row0 + r_lo];
      if (row0 + r_lo + 8 < a.n_rows) graw[1] = a.graw[row0 + r_lo + 8];
    }

    // head output cotangents into images 0 (rgb) and 1 (sem), zero-padded
    // (rows past n_rows are zero)
    // (eight 16-byte chunks a thread, every load issued before the first store)
    uint4 gv[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int e = tid + k * kWg;
      const int i = e / 16, ch = e % 8, which = (e / 8) % 2;
      const int row = row0 + i;
      gv[k] = make_uint4(0u, 0u, 0u, 0u);
      if (row < a.n_rows) {
        if (which == 0 && ch < kRgbPad / 8)
          gv[k] = *reinterpret_cast<const uint4*>(a.gout_rgb + (size_t)row * kRgbPad + ch * 8);
        if (which == 1 && ch < cp / 8)
          gv[k] = *reinterpret_cast<const uint4*>(a.gout_sem + (size_t)row * cp + ch * 8);
      }
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int e = tid + k * kWg;
      const int i = e / 16, ch = e % 8, which = (e / 8) % 2;
      *reinterpret_cast<uint4*>(act + which * kImgBytes64 + img_off(i, ch * 8)) = gv[k];
    }
    after_write();
    if (tid == 0) bulk_store(a.gout + tile * kImgBytes64, act_a, 2 * kImgBytes64);

    // heads, from the top: layer 2's and layer 1's pre-activation cotangents
    for (int l = 1; l >= 0; --l) {
      float dr[32], ds[32];
      const uint32_t src = act_a + (l == 1 ? 0 : 2 * kImgBytes64);
      {
        const uint32_t slab = slab_begin(ring, ring_base, kSlabBytes);
        if (l == 1) {
          wgmma_n64<0, 0>(dr, kmajor_desc(src, 0), kmajor_desc(slab, 0), 0);
          for (int ks = 0; ks < cp / 16; ++ks)
            wgmma_n64<0, 0>(ds, kmajor_desc(src + kImgBytes64, ks),
                            kmajor_desc(slab + kImgBytes64, ks), ks != 0);
        } else {
#pragma unroll
          for (int ks = 0; ks < 4; ++ks) {
            wgmma_n64<0, 0>(dr, kmajor_desc(src, ks), kmajor_desc(slab, ks), ks != 0);
            wgmma_n64<0, 0>(ds, kmajor_desc(src + kImgBytes64, ks),
                            kmajor_desc(slab + kImgBytes64, ks), ks != 0);
          }
        }
        slab_end(ring, tid);
      }
      before_overwrite();
      unsigned char* dst = act + (l == 1 ? 2 * kImgBytes64 : 0);
      const int sft = 16 * l;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 8 * j + 2 * q, at = sft + 2 * j;
        *reinterpret_cast<uint32_t*>(dst + img_off(r_lo, c)) =
            masked_pack(dr[4 * j], dr[4 * j + 1], mh_lo.x >> at);
        *reinterpret_cast<uint32_t*>(dst + img_off(r_lo + 8, c)) =
            masked_pack(dr[4 * j + 2], dr[4 * j + 3], mh_hi.x >> at);
        *reinterpret_cast<uint32_t*>(dst + kImgBytes64 + img_off(r_lo, c)) =
            masked_pack(ds[4 * j], ds[4 * j + 1], mh_lo.y >> at);
        *reinterpret_cast<uint32_t*>(dst + kImgBytes64 + img_off(r_lo + 8, c)) =
            masked_pack(ds[4 * j + 2], ds[4 * j + 3], mh_hi.y >> at);
      }
      after_write();
      if (tid == 0)
        bulk_store((l == 1 ? a.g2 : a.g1) + tile * kImgBytes64,
                   act_a + (l == 1 ? 2 * kImgBytes64 : 0), 2 * kImgBytes64);
      part[(l == 1 ? (tid < 64 ? off_r2 : off_s2 - 64) : (tid < 64 ? off_r1 : off_s1 - 64)) + tid] =
          image_column_sum(dst + (tid / 64) * kImgBytes64, tid % 64);
    }

    // heads' first layers back to their input: d[SH | geo] from both heads in
    // one accumulator; the trunk output's cotangent [graw | d geo | 0] as
    // image 2 (bf16) and in image 3's place (f32, for its column sums)
    {
      float dx[16];
      {
        const uint32_t slab = slab_begin(ring, ring_base, kSlabBytes);
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          wgmma_n32<0, 0>(dx, kmajor_desc(act_a, ks), kmajor_desc(slab, ks), ks != 0);
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          wgmma_n32<0, 0>(dx, kmajor_desc(act_a + kImgBytes64, ks),
                          kmajor_desc(slab + 32 * kImgRowBytes, ks), 1);
        slab_end(ring, tid);
      }
      before_overwrite();
      unsigned char* gt = act + 2 * kImgBytes64;
      float* gtf = reinterpret_cast<float*>(act + 3 * kImgBytes64);  // [64, 16]
#pragma unroll
      for (int e = 8; e < 16; ++e) {
        const int c = 8 * (e / 4) + 2 * q + (e & 1);  // column of [SH | geo], 16..31
        const int i = r_lo + 8 * ((e >> 1) & 1), k = c - kShw;
        if (k < kTOut - 1) {
          const float v = k < G ? dx[e] : 0.f;
          gtf[i * kTOut + 1 + k] = v;
          *reinterpret_cast<bf16*>(gt + img_off(i, 1 + k)) = __float2bfloat16(v);
        }
      }
      if (q == 0) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = r_lo + 8 * half;
          const float v = graw[half];
          gtf[i * kTOut] = v;
          *reinterpret_cast<bf16*>(gt + img_off(i, 0)) = __float2bfloat16(v);
        }
      }
      for (int e = tid; e < kTileRows * 6; e += kWg)
        *reinterpret_cast<uint4*>(gt + img_off(e / 6, (2 + e % 6) * 8)) = make_uint4(0u, 0u, 0u, 0u);
      after_write();
      if (tid == 0) bulk_store(a.gt + tile * (kImgBytes64 / 2), act_a + 2 * kImgBytes64, kImgBytes64);
      if (tid < kTOut) {
        float s = 0.f;
#pragma unroll 16
        for (int i = 0; i < kTileRows; ++i) s += gtf[i * kTOut + tid];
        part[off_gtr + tid] = s;
      }
    }

    // trunk: gh[l] = bf16((gh[l + 1] @ w[l + 1]^T) * (h[l] > 0)), from the top
    for (int l = nh - 1; l >= 0; --l) {
      const uint2 m_lo = a.mask_t[l][(size_t)(row0 + r_lo) * 4 + q];
      const uint2 m_hi = a.mask_t[l][(size_t)(row0 + r_lo + 8) * 4 + q];
      float d[128];
      if (l == nh - 1) {
        const uint32_t slab = slab_begin(ring, ring_base, kSlabBytes);
        wgmma_n256<0, 0>(d, kmajor_desc(act_a + 2 * kImgBytes64, 0), kmajor_desc(slab, 0), 0);
        slab_end(ring, tid);
      } else {
        for (int kb = 0; kb < 4; ++kb) {
          const uint32_t slab = slab_begin(ring, ring_base, kSlabBytes);
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
            wgmma_n256<0, 0>(d, kmajor_desc(act_a + kb * kImgBytes64, ks), kmajor_desc(slab, ks),
                             (kb | ks) != 0);
          slab_end(ring, tid);
        }
      }
      before_overwrite();
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int c = 8 * j + 2 * q, at = 2 * (j % 16);
        const uint32_t b_lo = (j < 16 ? m_lo.x : m_lo.y) >> at;
        const uint32_t b_hi = (j < 16 ? m_hi.x : m_hi.y) >> at;
        unsigned char* img = act + (j / 8) * kImgBytes64;
        *reinterpret_cast<uint32_t*>(img + img_off(r_lo, c % 64)) =
            masked_pack(d[4 * j], d[4 * j + 1], b_lo);
        *reinterpret_cast<uint32_t*>(img + img_off(r_lo + 8, c % 64)) =
            masked_pack(d[4 * j + 2], d[4 * j + 3], b_hi);
      }
      after_write();
      if (tid == 0) bulk_store(a.gh[l] + tile * (kActBytes / 2), act_a, kActBytes);
      for (int c = tid; c < kH; c += kWg)
        part[l * kH + c] = image_column_sum(act + (c / 64) * kImgBytes64, c % 64);
    }

    // encode: g_enc = gh[0] @ w0^T; dproj = cos * g_sin - sin * g_cos, the
    // dphase and dW_spec sums, and du where asked for
    {
      float d[128];
      for (int kb = 0; kb < 4; ++kb) {
        const uint32_t slab = slab_begin(ring, ring_base, kSlabBytes);
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          wgmma_n256<0, 0>(d, kmajor_desc(act_a + kb * kImgBytes64, ks), kmajor_desc(slab, ks),
                           (kb | ks) != 0);
        slab_end(ring, tid);
      }
      // the two tiles' encodings arrive in the next two slots; this
      // warpgroup reads its own
      const int st0 = ring.stage;
      ring.wait_full();
      const uint32_t bar0 = ring.empty_bar();
      ring.advance();
      const int st1 = ring.stage;
      ring.wait_full();
      const uint32_t bar1 = ring.empty_bar();
      ring.advance();
      const unsigned char* enc = smem + L.ring + (wg == 0 ? st0 : st1) * kSlabBytes;
      before_overwrite();
      float* dp = reinterpret_cast<float*>(act);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = 8 * j + 2 * q;
        const unsigned char* ic = enc + (c / 64) * kImgBytes64;
        const unsigned char* is = ic + 2 * kImgBytes64;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = r_lo + 8 * half;
          const float2 co = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(ic + img_off(i, c % 64)));
          const float2 si = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(is + img_off(i, c % 64)));
          const float gc0 = d[4 * j + 2 * half], gc1 = d[4 * j + 2 * half + 1];
          const float gs0 = d[4 * (j + 16) + 2 * half], gs1 = d[4 * (j + 16) + 2 * half + 1];
          *reinterpret_cast<float2*>(dp + dp_at(i, c)) =
              make_float2(co.x * gs0 - si.x * gc0, co.y * gs1 - si.y * gc1);
        }
      }
      named_barrier(bar_id, kWg);
      if (tid == 0) {
        mbar_arrive(bar0);
        mbar_arrive(bar1);
      }
      {
        // thread tid owns frequency tid: dphase and the three rows of dW_spec
        float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll 16
        for (int i = 0; i < kTileRows; ++i) {
          const int row = row0 + i;
          const float v = dp[dp_at(i, tid)];
          s0 += v;
          if (row < a.n_rows) {
            const float vb = round_bf16(v);
            s1 += round_bf16(u_s[i * 3 + 0]) * vb;
            s2 += round_bf16(u_s[i * 3 + 1]) * vb;
            s3 += round_bf16(u_s[i * 3 + 2]) * vb;
          }
        }
        part[off_dph + tid] = s0;
        part[off_dph + kM + tid] = s1 * kTwoPi;
        part[off_dph + 2 * kM + tid] = s2 * kTwoPi;
        part[off_dph + 3 * kM + tid] = s3 * kTwoPi;
      }
      if (a.du != nullptr) {
        for (int e = tid; e < kTileRows * 3; e += kWg) {
          const int i = e / 3, dd = e % 3;
          const int row = row0 + i;
          if (row < a.n_rows) {
            float s = 0.f;
#pragma unroll 16
            for (int j = 0; j < kM; ++j)
              s += round_bf16(dp[dp_at(i, j)]) * round_bf16(a.W[dd * kM + j]);
            a.du[(size_t)row * 3 + dd] = s * kTwoPi;
          }
        }
      }
      named_barrier(bar_id, kWg);
    }
  }
  if (tid == 0) bulk_store_wait();
}

// ---- 4. weight gradients: dW = X^T dY over all rows ---------------------------------
//
// One launch for every weight of the field. The saved activations X and
// the cotangents dY lie in global memory as tile images whose rows are
// samples: exactly the MN-major wgmma operands of a product whose K runs
// over samples. An item is one product per consumer warpgroup w,
// P[64, n] = image(x, x_img[w])^T @ images(y, y_img[w] ...), n = 256 (four
// dY images shared by both warpgroups) or 64 (one image each). A block
// takes one chunk of an item's row tiles; the producer warp brings each
// tile's images by bulk copies; the partial products go to P in f32 and
// dw_reduce_kernel adds an item's chunks in order.

constexpr int kDwStages = 3;
constexpr int kDwStageBytes = 6 * kImgBytes64;

}  // namespace

// One product of dw_kernel; mirrors _DwItem in
// apnerf_tpu_torch/ops/cuda/field_train.py field by field.
struct DwItem {
  const __nv_bfloat16* x;  // X images, x_imgs a row tile
  const __nv_bfloat16* y;  // dY images, y_imgs a row tile
  int x_imgs, y_imgs;
  int x_img[2], y_img[2];  // per warpgroup: the X image and the first dY image
  int n;                   // 256 or 64
  int chunks, chunk_tiles;  // row chunks and row tiles a chunk
  int first_block;         // blocks first_block .. first_block + chunks - 1
  long long p_off;         // floats: this item's partials [chunks][2][64][n] in P
  long long out_off;       // floats: this item's sums [2][64][n] in the output
};

struct DwArgs {
  DwItem items[16];  // _MAX_ITEMS in field_train.py
  int n_items, n_tiles;
  float* P;
  float* out;
  long long out_total;
};

namespace {

struct DwSmem {
  int ring, bars, total;
};

__host__ __device__ inline DwSmem dw_smem() {
  DwSmem s;
  s.ring = 0;
  s.bars = kDwStages * kDwStageBytes;
  s.total = s.bars + 16 * kDwStages + kAlignSlack;
  return s;
}

template <int N>
__device__ __forceinline__ void dw_store(const float (&d)[N / 2], float* dst, int tid) {
  const int r_lo = 16 * (tid / 32) + (tid % 32) / 4, q = tid % 4;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int c = 8 * j + 2 * q;
    *reinterpret_cast<float2*>(dst + (size_t)r_lo * N + c) = make_float2(d[4 * j], d[4 * j + 1]);
    *reinterpret_cast<float2*>(dst + (size_t)(r_lo + 8) * N + c) =
        make_float2(d[4 * j + 2], d[4 * j + 3]);
  }
}

__global__ void __launch_bounds__(kFieldThreads, 1) dw_kernel(const __grid_constant__ DwArgs a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);
  const DwSmem L = dw_smem();
  const uint32_t full = smem_u32(smem + L.bars), empty = full + 8 * kDwStages;
  const uint32_t ring_base = smem_u32(smem + L.ring);
  if (threadIdx.x == 0) ring_init<kDwStages>(full, empty, 2);
  __syncthreads();
  int it = 0;
  while (it + 1 < a.n_items && (int)blockIdx.x >= a.items[it + 1].first_block) ++it;
  const DwItem& item = a.items[it];
  const int chunk = blockIdx.x - item.first_block;
  const int t0 = chunk * item.chunk_tiles;
  const int t1 = min(t0 + item.chunk_tiles, a.n_tiles);
  const bool wide = item.n == 256;
  // an image both warpgroups read is brought once
  const bool x_shared = item.x_img[0] == item.x_img[1];
  const bool y_shared = item.y_img[0] == item.y_img[1];
  Ring<kDwStages> ring;
  ring.full = full;
  ring.empty = empty;

  if (threadIdx.x >= 2 * kWg) {
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 2 * kWg) {
      const unsigned char* x = reinterpret_cast<const unsigned char*>(item.x);
      const unsigned char* y = reinterpret_cast<const unsigned char*>(item.y);
      const int nx = x_shared ? 1 : 2, ny = wide ? 4 : (y_shared ? 1 : 2);
      for (int t = t0; t < t1; ++t) {
        ring.wait_empty();
        const uint32_t dst = ring_base + ring.stage * kDwStageBytes;
        mbar_expect_tx(ring.full_bar(), (nx + ny) * kImgBytes64);
        for (int w = 0; w < nx; ++w)
          bulk_load(dst + w * kImgBytes64,
                    x + ((size_t)t * item.x_imgs + item.x_img[w]) * kImgBytes64, kImgBytes64,
                    ring.full_bar());
        if (wide) {
          bulk_load(dst + 2 * kImgBytes64, y + (size_t)t * 4 * kImgBytes64, 4 * kImgBytes64,
                    ring.full_bar());
        } else {
          for (int w = 0; w < ny; ++w)
            bulk_load(dst + (2 + w) * kImgBytes64,
                      y + ((size_t)t * item.y_imgs + item.y_img[w]) * kImgBytes64, kImgBytes64,
                      ring.full_bar());
        }
        ring.advance();
      }
    }
    return;
  }

  reg_alloc<kConsumerRegs>();
  const int wg = threadIdx.x / kWg, tid = threadIdx.x % kWg;
  const int xw = x_shared ? 0 : wg, yw = y_shared ? 0 : wg;
  float* dst = a.P + item.p_off + ((size_t)chunk * 2 + wg) * kTileRows * item.n;
  if (wide) {
    float d[128];
    for (int t = t0; t < t1; ++t) {
      const uint32_t st = slab_begin(ring, ring_base, kDwStageBytes);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_n256<1, 1>(d, mnmajor_desc(st + xw * kImgBytes64, ks, kImgBytes64),
                         mnmajor_desc(st + 2 * kImgBytes64, ks, kImgBytes64), (t != t0) | ks);
      slab_end(ring, tid);
    }
    dw_store<256>(d, dst, tid);
  } else {
    float d[32];
    for (int t = t0; t < t1; ++t) {
      const uint32_t st = slab_begin(ring, ring_base, kDwStageBytes);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_n64<1, 1>(d, mnmajor_desc(st + xw * kImgBytes64, ks, kImgBytes64),
                        mnmajor_desc(st + (2 + yw) * kImgBytes64, ks, kImgBytes64),
                        (t != t0) | ks);
      slab_end(ring, tid);
    }
    dw_store<64>(d, dst, tid);
  }
}

// out[j] = sum_t P[t, j] for j < cols, in a fixed order: thread (x, y) of a
// 32 x 32 block adds rows y, y + 32, ... of column x in turn, then row 0
// of the block adds the 32 partial sums in turn
__global__ void __launch_bounds__(1024)
    col_sums_kernel(const float* __restrict__ P, int n, long long ld, int cols,
                    float* __restrict__ out) {
  __shared__ float part[32][33];
  const int x = threadIdx.x % 32, y = threadIdx.x / 32;
  const int j = blockIdx.x * 32 + x;
  float s = 0.f;
  if (j < cols)
    for (int t = y; t < n; t += 32) s += P[(long long)t * ld + j];
  part[y][x] = s;
  __syncthreads();
  if (y == 0 && j < cols) {
    float total = 0.f;
    for (int k = 0; k < 32; ++k) total += part[k][x];
    out[j] = total;
  }
}

// out[item.out_off + j] = sum over the item's chunks, in order, of its partials
__global__ void dw_reduce_kernel(const __grid_constant__ DwArgs a) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= a.out_total) return;
  int it = 0;
  while (it + 1 < a.n_items && e >= a.items[it + 1].out_off) ++it;
  const DwItem& item = a.items[it];
  const long long j = e - item.out_off, ld = 2LL * kTileRows * item.n;
  const float* p = a.P + item.p_off + j;
  float s = 0.f;
  for (int c = 0; c < item.chunks; ++c) s += p[c * ld];
  a.out[e] = s;
}

}  // namespace

// What field_images.py mirrors, for a check on the card: shared memory
// (bytes) of the field forward (which = 0), the field backward (1) and the
// weight gradients (2), and the width of a tile_part row (3).
extern "C" int apnerf_field_layout(int which, int n_hidden) {
  return which == 0   ? fwd_smem(n_hidden).total
         : which == 1 ? bwd_smem().total
         : which == 2 ? dw_smem().total
                      : n_bias(n_hidden);
}

// Each entry launches on `stream` and returns cudaGetLastError(); none
// allocates. `grid` is the number of persistent blocks.
extern "C" int apnerf_fvr_field_fwd(const FvrArgs* a, int grid, void* stream) {
  const size_t smem = fwd_smem(a->n_hidden).total;
  int err = set_smem((const void*)fvr_field_fwd_kernel, smem);
  if (err) return err;
  fvr_field_fwd_kernel<<<grid, kFieldThreads, smem, static_cast<cudaStream_t>(stream)>>>(*a);
  return (int)cudaGetLastError();
}

// with_loss = 1: the train step's ray kernel; 0: the render's backward
// from given cotangents (a->g_acc, a->g_w)
extern "C" int apnerf_fvr_rays(const FvrArgs* a, int with_loss, void* stream) {
  const size_t smem = (size_t)kRayWarps * (2 * a->n_samples + 2 * kRayChan) * sizeof(float);
  const void* kernel =
      with_loss ? (const void*)fvr_ray_kernel<true> : (const void*)fvr_ray_kernel<false>;
  int err = set_smem(kernel, smem);
  if (err) return err;
  const int grid = (a->n_rays + kRayWarps - 1) / kRayWarps;
  if (with_loss)
    fvr_ray_kernel<true><<<grid, kRayWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(*a);
  else
    fvr_ray_kernel<false><<<grid, kRayWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(*a);
  return (int)cudaGetLastError();
}

extern "C" int apnerf_fvr_fwd_rays(const float* y, const float* dt, const float* tm, float* acc,
                                   float* w, int n_rays, int n_samples, int n_classes,
                                   void* stream) {
  const size_t smem = (size_t)kRayWarps * n_samples * sizeof(float);
  int err = set_smem((const void*)fvr_fwd_ray_kernel, smem);
  if (err) return err;
  fvr_fwd_ray_kernel<<<(n_rays + kRayWarps - 1) / kRayWarps, kRayWarps * 32, smem,
                       static_cast<cudaStream_t>(stream)>>>(y, dt, tm, acc, w, n_rays,
                                                            n_samples, n_classes);
  return (int)cudaGetLastError();
}

extern "C" int apnerf_fvr_field_bwd(const FvrArgs* a, int grid, void* stream) {
  const size_t smem = bwd_smem().total;
  int err = set_smem((const void*)fvr_field_bwd_kernel, smem);
  if (err) return err;
  fvr_field_bwd_kernel<<<grid, kFieldThreads, smem, static_cast<cudaStream_t>(stream)>>>(*a);
  return (int)cudaGetLastError();
}

extern "C" int apnerf_col_sums(const float* P, int n, long long ld, int cols, float* out,
                               void* stream) {
  col_sums_kernel<<<(cols + 31) / 32, 1024, 0, static_cast<cudaStream_t>(stream)>>>(P, n, ld, cols,
                                                                                 out);
  return (int)cudaGetLastError();
}

// The weight gradients: one block per (item, chunk), then the fixed-order sum.
extern "C" int apnerf_dw(const DwArgs* a, int n_blocks, void* stream) {
  const size_t smem = dw_smem().total;
  int err = set_smem((const void*)dw_kernel, smem);
  if (err) return err;
  dw_kernel<<<n_blocks, kFieldThreads, smem, static_cast<cudaStream_t>(stream)>>>(*a);
  err = (int)cudaGetLastError();
  if (err) return err;
  dw_reduce_kernel<<<(unsigned)((a->out_total + 255) / 256), 256, 0,
                     static_cast<cudaStream_t>(stream)>>>(*a);
  return (int)cudaGetLastError();
}
