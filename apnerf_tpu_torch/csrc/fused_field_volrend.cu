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
// field_tile.cuh), at each of the tile's five instances H in 64, 128, 256,
// 512, 1024 and each tier (T_out, C_pad) of the field's trunk output and
// semantic output, compiled in APNERF_PARTS parts in parallel (the first
// layer's width is a run-time count of k-blocks):
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
// Launches 1, 3 and 4 with heads = 0 are the backwards of the trunk
// kernels (fused_mlp.py: fused_spectral_field_bwd, replacing
// apnerf_tpu/ops/pallas/fused_mlp.py::_call_enc_bwd, and
// fused_mlp_apply_bwd, replacing ::_call_bwd): the forward stops after
// the trunk's hidden layers, the backward enters at the trunk output's
// cotangent g (any width, 64 columns a k-block, rounded to bf16 as the TPU
// kernels round it) and ends at the encode's backward or at dx = gh0 w0^T,
// and dW covers the bare trunk. The trunk kernels' input x enters as
// zero-padded first-layer k-blocks.
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

// this file is compiled once per part (field_tile.cuh)
#define APNERF_PARTS 8

#include "field_train_args.cuh"
#include "warp_reduce.cuh"

namespace {

constexpr int kRayWarps = 8;  // most rays a block of the ray kernels (one warp each)

// per-ray channel slots in shared memory, twice (3 + C of them): 128, or
// c_pad + 4 where that is more
__host__ __device__ inline int ray_chan(int c_pad) { return c_pad + 4 > 128 ? c_pad + 4 : 128; }

// bias layout of a tile_part row: trunk pre-activation sums (n_hidden x H),
// trunk output (t_pad: the tier's T_out, or the trunk alone's output padded to 64), rgb
// head (H/4, H/4), sem head (H/4, H/4), dphase (mp), dW_spec (3 x mp, scaled
// by 2 pi); mp = 32 n_kb with the encode, else 0
__host__ __device__ inline int n_bias(int n_hidden, int h, int t_pad, int mp) {
  return n_hidden * h + t_pad + h + 4 * mp;
}

// ---- 1. field forward -------------------------------------------------------

// per-sample outputs of the train step's field pass: each staged as the
// tile's contiguous run of its array (past 64 classes the semantics 64
// columns a chunk)
struct TrainEpilogue {
  static constexpr bool kTrunkOut = false;
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
  __device__ void flush_head(const float* st, int row0, int n_valid, int t, int nt) {
    copy_out(sigma + row0, st, n_valid, t, nt);
    copy_out(dsd + row0, st + kTileRows, n_valid, t, nt);
    copy_out(rgb_out + (size_t)row0 * 3, st + 2 * kTileRows, n_valid * 3, t, nt);
  }
  __device__ void flush(const float* st, int row0, int n_valid, int t, int nt) {
    flush_head(st, row0, n_valid, t, nt);
    copy_out(sem_out + (size_t)row0 * n_classes, st + 5 * kTileRows, n_valid * n_classes, t, nt);
  }
  // classes 64 ch .. 64 ch + 63 from ss [64, 64]
  __device__ void flush_sem(const float* ss, int row0, int n_valid, int ch, int t, int nt) {
    const int c0 = kSemChunk * ch, w = min(kSemChunk, n_classes - c0);
    for (int e = t; e < n_valid * kSemChunk; e += nt) {
      const int c = e % kSemChunk;
      if (c < w) sem_out[(size_t)(row0 + e / kSemChunk) * n_classes + c0 + c] = ss[e];
    }
  }
};

template <int H, bool kWhole, int kCP, int kTO>
__global__ void __launch_bounds__(kFieldThreads, 1)
    fvr_field_fwd_kernel(const __grid_constant__ FvrArgs a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  // the call's arguments are the field's weights and its save buffers
  field_forward<H, kWhole, kCP, kTO>(a, a, a.u, a.x, a.x_f32, a.din, a.heads != 0, a.sh,
                                     a.n_rows, a.n_samples, smem,
                                     TrainEpilogue{a.sigma, a.dsd, a.rgb, a.sem, a.n_classes});
}

// ---- 2. per-ray volume rendering, loss and cotangents -------------------------

// kLoss: the train step's kernel, which forms the loss and its per-ray
// cotangents itself. Otherwise the backward of the forward-only render:
// the per-ray cotangents are given (g_acc, rounded to bf16 as the TPU
// kernel rounds them, and g_w, which may be null), the weights are
// recomputed and nothing but the per-sample cotangents is written.
// blockDim.x / 32 rays a block (the wrapper's plan, 1 to kRayWarps), each
// warp's w and T [S] in shared memory, or where a warp's do not fit there,
// in `stage` ([N, 2] floats in device memory: a ray's w, then its T).
template <bool kLoss>
__global__ void __launch_bounds__(kRayWarps * 32) fvr_ray_kernel(FvrArgs a, float* stage) {
  extern __shared__ float rsm[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ray = blockIdx.x * (blockDim.x / 32) + warp;
  if (ray >= a.n_rays) return;  // uniform across the warp
  const int S = a.n_samples, C = a.n_classes, NC = 3 + C, n_ch = ray_chan(a.c_pad);
  // the warp's w and T [S] (here or in `stage`), then acc [NC] (the per-ray
  // sums: rgb, then semantics) and gch [NC] (their bf16-rounded cotangents)
  float* wb = stage == nullptr ? rsm + (size_t)warp * (2 * S + 2 * n_ch)
                               : stage + (size_t)ray * 2 * S;
  float* tb = wb + S;
  float* acc = stage == nullptr ? tb + S : rsm + (size_t)warp * 2 * n_ch;
  float* gch = acc + n_ch;
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
// chunked by 32 with a carry, so any S and any ray count go: blockDim.x /
// 32 rays a block (the wrapper's plan), each warp's weights [S] kept in
// shared memory (`in_smem`), or where they do not fit there read back from
// w_out. Memory-bound: it reads 4 (4 + C) + 8 bytes per sample once and
// writes 4.
#if APNERF_PART == 0
__global__ void __launch_bounds__(kRayWarps * 32)
    fvr_fwd_ray_kernel(const float* __restrict__ y, const float* __restrict__ dt,
                       const float* __restrict__ tm, float* __restrict__ acc,
                       float* w_out, int n_rays, int S, int C, int in_smem) {
  extern __shared__ float rsm[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ray = blockIdx.x * (blockDim.x / 32) + warp;
  if (ray >= n_rays) return;  // uniform across the warp
  const int ld = 4 + C;
  float* wb = in_smem ? rsm + (size_t)warp * S : w_out + (size_t)ray * S;
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
      if (in_smem) wb[i] = w;
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
#endif  // APNERF_PART == 0

// ---- 3. field backward ------------------------------------------------------------
//
// The forward's block design run backwards: per pass the producer warp
// streams the backward slabs (B[n][k] = w[n][k0 + k], so the product is
// dX = dY W^T) and, with the encode, after each first-layer slab the
// tiles' saved encoding of that k-block; each tile walks its 64 rows from
// the head outputs (or, for the trunk alone, from the trunk output's
// cotangent) down to the spectral phase or to dx, with its cotangent buffer
// as the A operand, at H = 512 both warpgroups on one tile, each forming
// one column half (at 1024 in two products of n = 256, the first's masked
// results held in registers until the second is formed). The ReLU masks come as bits in the accumulator's own
// order, two words a thread a layer. Image slots of a tile's buffer over
// time (kHI = images of a head's activation):
//   0 gout_rgb, 1 gout_sem -> g2 at 2 kHI .. 4 kHI -> g1 at 0 .. 2 kHI
//   -> gt at 2 kHI, its f32 copy (for its column sums) at 2 kHI + 1 (at
//   T_out = 48 and 64, [64, T_out] f32, at 0 .. 1)
// then the first H / 64 hold gh[l]. Past 64 classes the semantic
// cotangent enters image 1 64 columns at a time, each block's product
// (its own slab of the output layer's weights) done before the next. The
// trunk alone forms its output's cotangent 64 columns at a time in images
// 0 and 1. The first layer goes
// back in blocks of 64 columns: x's, for dx, or with the encode 32
// frequencies a block, each two groups of 16 as [cos 16 | sin 16] (the
// backward slabs' own order, not the forward's), so that a thread holds a
// frequency's cos and sin cotangents in its registers. Up to four blocks
// are one product, n = 64 kG (kG a template parameter: 1, 2 or 4), the
// producer bringing the tiles' saved encodings after its slabs, so that
// the f32 dproj [64, 32 kG] goes over the buffer (gh[0] is done with) and
// gives the dphase and dW_spec sums and du; more than four blocks go one at
// a time (kG = 0: one block a product, gh[0] kept, the saved cos and sin
// read from device memory and the block's dproj in a buffer of its own).

// bytes of a backward ring slot: a trunk slab, a first-layer slab [64 kG,
// 64], the heads' slabs, or a tile's saved encoding (up to four images)
__host__ __device__ inline int bwd_slot(int h) {
  return trunk_slab(h) > 4 * kImgBytes64 ? trunk_slab(h) : 4 * kImgBytes64;
}

// the instance of the backward for n_back first-layer blocks and n_gt
// blocks of the trunk output's cotangent: kG blocks in one product (all of
// them, up to four) with one trunk-output block, or 0: one block a product
// and any number of trunk-output blocks (the only instance at H = 1024)
inline int back_group(int n_back, int n_gt) {
  return n_gt > 1 ? 0 : n_back == 1 ? 1 : n_back == 2 ? 2 : n_back <= 4 ? 4 : 0;
}

constexpr int kDpBytes = kTileRows * kBlockFreqs * 4;  // a tile's dproj of one k-block

struct BwdSmem {
  int ring, act, u, dp, bars, total;
};

__host__ __device__ inline BwdSmem bwd_smem(int h) {
  BwdSmem s;
  s.ring = 0;
  s.act = fwd_stages(h) * bwd_slot(h);
  s.u = s.act + buf_bytes(h);
  s.dp = s.u + 2 * kUTileBytes;  // a tile's coordinates, then its dproj
  s.bars = s.dp + 2 * kDpBytes;
  s.total = s.bars + 16 * fwd_stages(h) + kAlignSlack;
  return s;
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

// the saved bf16 pair (i, col), (i, col + 1) of a tile's encoding images at enc
__device__ __forceinline__ float2 saved_pair(const unsigned char* enc, int i, int col) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
      enc + (col / 64) * kImgBytes64 + img_off(i, col % 64)));
}

// f32 dproj element (i, f) of a tile's swizzled [64, kW] buffer
template <int kW>
__device__ __forceinline__ int dp_at(int i, int f) { return i * kW + (f ^ ((i & 7) << 2)); }

// A group's dproj = cos * g_sin - sin * g_cos from the first layer's
// cotangent dg (a warpgroup's kBw columns: c = 8 j + 2 q + e holds g_cos for
// j % 4 < 2 and g_sin of the same frequency at j + 2) and the saved cos (at
// column f0 + f of the encoding images at enc) and sin (at m + f0 + f; kSin:
// m at compile time, or 0 for sin_rt), into dp [64, kGF]
template <int kBw, int kGF, int kSin>
__device__ __forceinline__ void group_dproj(const float (&dg)[kBw / 2], const unsigned char* enc,
                                            int sin_rt, float* dp, int cw, int q, int r_lo,
                                            int f0) {
  const int sin_off = kSin ? kSin : sin_rt;
#pragma unroll
  for (int j = 0; j < kBw / 8; ++j) {
    if (j % 4 >= 2) continue;
    const int bc = cw * kBw + 8 * j + 2 * q;  // the group's cos column
    const int fl = 16 * (bc / 32) + bc % 32;   // frequency in the group
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = r_lo + 8 * half;
      const float2 co = saved_pair(enc, i, f0 + fl), si = saved_pair(enc, i, sin_off + f0 + fl);
      const float gc0 = dg[4 * j + 2 * half], gc1 = dg[4 * j + 2 * half + 1];
      const float gs0 = dg[4 * (j + 2) + 2 * half], gs1 = dg[4 * (j + 2) + 2 * half + 1];
      *reinterpret_cast<float2*>(dp + dp_at<kGF>(i, fl)) =
          make_float2(co.x * gs0 - si.x * gc0, co.y * gs1 - si.y * gc1);
    }
  }
}

template <int H, int kG, int kCP, int kTO>
__global__ void __launch_bounds__(kFieldThreads, 1)
    fvr_field_bwd_kernel(const __grid_constant__ FvrArgs a) {
  using T = Tile<H>;
  constexpr int kHw = T::kHw, kHwn = T::kHwn, kHh = T::kHh, kHhw = T::kHhw, kHI = T::kHI;
  constexpr int kTT = T::kTT, kNh = T::kNh, kMhw = T::kMhw;
  constexpr int kSt = T::kStages;
  constexpr int kNsb = kCP / kSemChunk;  // blocks of the semantic cotangent
  constexpr int kGout = 1 + kNsb;      // gout images a tile: rgb, then the semantic blocks
  constexpr int kXw = kShw + kTO;      // the heads' input columns back: [SH | trunk output]
  constexpr int kOne = kG > 0;                        // every block in one product
  constexpr int kGB = kG > 0 ? kG : 1;                // blocks a product
  constexpr int kBw = 64 * kGB / T::kSplit;           // first-layer columns a warpgroup forms
  constexpr int kGF = kBlockFreqs * kGB;              // frequencies of a product
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);
  const BwdSmem L = bwd_smem(H);
  const int kSlot = bwd_slot(H);
  const int nh = a.n_hidden, nkb = a.n_kb;
  const bool heads = a.heads != 0, encode = a.x == nullptr;
  const uint32_t full = smem_u32(smem + L.bars), empty = full + 8 * kSt;
  const uint32_t ring_base = smem_u32(smem + L.ring);
  if (threadIdx.x == 0) ring_init<kSt>(full, empty, 2);
  __syncthreads();
  const int n_pass = (a.n_rows + T::kPassRows - 1) / T::kPassRows;
  const int n_gt = heads ? 1 : (a.out + 63) / 64;  // the trunk output's k-blocks
  // the first layer's blocks back (32 frequencies each, or x's 64 columns),
  // in groups of kG: one group where they fit, else one block a group
  const int n_back = encode ? (a.n_freq + kBlockFreqs - 1) / kBlockFreqs : nkb;
  const int n_groups = kOne ? 1 : n_back;
  Ring<kSt> ring;
  ring.full = full;
  ring.empty = empty;

  if (threadIdx.x >= 2 * kWg) {
    // ---- producer: the weight slabs
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 2 * kWg) {
      const unsigned char* w = reinterpret_cast<const unsigned char*>(a.wbwd);
      auto push = [&](const unsigned char* src, uint32_t bytes) {
        ring.wait_empty();
        mbar_expect_tx(ring.full_bar(), bytes);
        bulk_load(ring_base + ring.stage * kSlot, src, bytes, ring.full_bar());
        ring.advance();
      };
      for (int pass = blockIdx.x; pass < n_pass; pass += gridDim.x) {
        const unsigned char* src = w;
        if (heads) {
          // the outputs back (rgb with the first semantic block, then one
          // semantic block a slab), the second layers back, the first layers
          // back (at H = 1024 these two one image a slab)
          constexpr int kImg = T::kPerImage ? 2 * kHI : 1;
          for (int s = 0; s < kNsb + 2 * kImg; ++s) {
            const uint32_t size = s == 0             ? 2u * T::kHeadImg
                                  : s < kNsb         ? (uint32_t)T::kHeadImg
                                  : s < kNsb + kImg  ? 2u * kHI * T::kHeadImg / kImg
                                                     : 2u * kHI * kXw * kImgRowBytes / kImg;
            push(src, size);
            src += size;
          }
        }
        for (int s = 0; s < kNh * (n_gt + (nh - 1) * T::kHImgs); ++s, src += T::kTrunkSlab)
          push(src, T::kTrunkSlab);
        for (int s = 0; s < n_groups * T::kHImgs; ++s, src += 64 * kGB * kImgRowBytes)
          push(src, 64 * kGB * kImgRowBytes);
        if (encode && kOne) {
          for (int t = 0; t < T::kTiles; ++t)
            push(reinterpret_cast<const unsigned char*>(a.enc) +
                     (size_t)(pass * T::kTiles + t) * nkb * kImgBytes64,
                 nkb * kImgBytes64);
        }
      }
    }
    return;
  }

  // ---- consumers
  reg_alloc<kConsumerRegs>();
  const int wg = threadIdx.x / kWg, tid = threadIdx.x % kWg;
  const int tl = wg / T::kSplit, cw = wg % T::kSplit;
  const int tt = tid + cw * kWg;
  const int g = (tid % 32) / 4, q = tid % 4;
  const int r_lo = 16 * (tid / 32) + g;  // this thread's accumulator rows: r_lo, r_lo + 8
  const int bar_id = 1 + tl;
  unsigned char* act = smem + L.act + tl * T::kActBytes;
  const uint32_t act_a = smem_u32(act);
  const int G = a.geo, cp = a.c_pad;
  const int t_pad = heads ? kTO : 64 * n_gt, mp = encode ? kGF * n_groups : 0;
  const int mc = a.n_freq;  // the forward's encoding: [cos of m | sin of m]
  const int nb = n_bias(nh, H, t_pad, mp);
  const int off_gtr = nh * H;
  const int off_r1 = off_gtr + t_pad;
  const int off_r2 = off_r1 + kHh, off_s1 = off_r2 + kHh, off_s2 = off_s1 + kHh;
  const int off_dph = off_s2 + kHh;  // then dW_spec at off_dph + mp
  float* u_s = reinterpret_cast<float*>(smem + L.u) + tl * (kUTileBytes / 4);
  float* dp = reinterpret_cast<float*>(smem + L.dp) + tl * (kDpBytes / 4);
  const size_t mrow = (size_t)4 * T::kSplit * kNh;  // a trunk layer's mask words a row
  const size_t hrow = (size_t)4 * T::kSplit * kMhw;  // the heads' mask words a row

  auto tile_sync = [&]() { named_barrier(bar_id, kTT); };
  auto before_overwrite = [&]() {
    if (tt == 0) bulk_store_wait_read();
    tile_sync();
  };
  auto after_write = [&]() {
    fence_async_smem();
    tile_sync();
  };
  for (int pass = blockIdx.x; pass < n_pass; pass += gridDim.x) {
    const int row0 = pass * T::kPassRows + tl * kTileRows;
    const size_t tile = (size_t)(row0 / kTileRows);
    float* part = a.tile_part + tile * nb;
    // what the end of the pass reads from device memory is fetched now
    if (encode && cw == 0) stash_u(u_s, fetch_u(a.u, row0, a.n_rows, tid), tid);
    constexpr int gti = 2 * kHI;  // gt's image, its f32 copy [64, kTO] in the next or at 0
    unsigned char* gt = act + gti * kImgBytes64;
    float* gtf = reinterpret_cast<float*>(
        act + (kTO * kTileRows * 4 <= kImgBytes64 ? gti + 1 : 0) * kImgBytes64);
    if (heads) {
      // the heads' masks: one word, layer 1 the low 16 bits and layer 2 the
      // high, or (kMhw = 2) a word a layer
      uint2 mh_lo[kMhw], mh_hi[kMhw];
#pragma unroll
      for (int w = 0; w < kMhw; ++w) {
        mh_lo[w] = a.mask_h[(size_t)(row0 + r_lo) * hrow + (q * T::kSplit + cw) * kMhw + w];
        mh_hi[w] = a.mask_h[(size_t)(row0 + r_lo + 8) * hrow + (q * T::kSplit + cw) * kMhw + w];
      }
      float graw[2] = {0.f, 0.f};
      if (q == 0 && cw == 0) {
        if (row0 + r_lo < a.n_rows) graw[0] = a.graw[row0 + r_lo];
        if (row0 + r_lo + 8 < a.n_rows) graw[1] = a.graw[row0 + r_lo + 8];
      }

      // head output cotangents into images 0 (rgb) and 1 (sem), zero-padded
      // (rows past n_rows are zero), every load issued before the first store
      constexpr int kPer = 2 * kTileRows * 8 / kTT;
      uint4 gv[kPer];
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int e = tt + k * kTT;
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
      for (int k = 0; k < kPer; ++k) {
        const int e = tt + k * kTT;
        const int i = e / 16, ch = e % 8, which = (e / 8) % 2;
        *reinterpret_cast<uint4*>(act + which * kImgBytes64 + img_off(i, ch * 8)) = gv[k];
      }
      after_write();
      bf16* gout_t = a.gout + tile * kGout * (kImgBytes64 / 2);
      if (tt == 0) bulk_store(gout_t, act_a, 2 * kImgBytes64);

      // heads, from the top: layer 2's and layer 1's pre-activation cotangents
      // (columns past H/4 zero)
      for (int l = 1; l >= 0; --l) {
        float dr[kHhw / 2], ds[kHhw / 2];
        fresh(dr);
        fresh(ds);
        if (l == 0 && T::kPerImage) {
          // one image a slab: rgb's k-blocks, then sem's
          const uint32_t src = act_a + 2 * kHI * kImgBytes64;
#pragma unroll
          for (int hd = 0; hd < 2; ++hd) {
            float(&acc)[kHhw / 2] = hd ? ds : dr;
#pragma unroll
            for (int kb = 0; kb < kHI; ++kb) {
              const uint32_t slab = slab_begin(ring, ring_base, kSlot) + cw * kHhw * kImgRowBytes;
#pragma unroll
              for (int ks = 0; ks < 4; ++ks)
                wgmma<kHhw, 0, 0>(acc, kmajor_desc(src + (hd * kHI + kb) * kImgBytes64, ks),
                                  kmajor_desc(slab, ks), (kb | ks) != 0);
              slab_end(ring, tid);
            }
          }
        } else {
          const uint32_t slab = slab_begin(ring, ring_base, kSlot) + cw * kHhw * kImgRowBytes;
          if (l == 1) {
            wgmma<kHhw, 0, 0>(dr, kmajor_desc(act_a, 0), kmajor_desc(slab, 0), 0);
            for (int ks = 0; ks < min(cp, 64) / 16; ++ks)
              wgmma<kHhw, 0, 0>(ds, kmajor_desc(act_a + kImgBytes64, ks),
                                kmajor_desc(slab + T::kHeadImg, ks), ks != 0);
          } else {
            const uint32_t src = act_a + 2 * kHI * kImgBytes64;
#pragma unroll
            for (int ks = 0; ks < kHh / 16; ++ks) {
              const int kb = ks / 4;
              wgmma<kHhw, 0, 0>(dr, kmajor_desc(src + kb * kImgBytes64, ks % 4),
                                kmajor_desc(slab + kb * T::kHeadImg, ks % 4), ks != 0);
              wgmma<kHhw, 0, 0>(ds, kmajor_desc(src + (kHI + kb) * kImgBytes64, ks % 4),
                                kmajor_desc(slab + (kHI + kb) * T::kHeadImg, ks % 4), ks != 0);
            }
          }
          slab_end(ring, tid);
        }
        if (l == 1) {
          // the semantic cotangent's further blocks, each into image 1 (its
          // copy saved) and through its own slab
#pragma unroll
          for (int k = 1; k < kNsb; ++k) {
            constexpr int kPer1 = kTileRows * 8 / kTT;
            uint4 sv_[kPer1];
#pragma unroll
            for (int r = 0; r < kPer1; ++r) {
              const int e = tt + r * kTT, i = e / 8, col = 64 * k + (e % 8) * 8;
              sv_[r] = make_uint4(0u, 0u, 0u, 0u);
              if (row0 + i < a.n_rows && col < cp)
                sv_[r] =
                    *reinterpret_cast<const uint4*>(a.gout_sem + (size_t)(row0 + i) * cp + col);
            }
            before_overwrite();
#pragma unroll
            for (int r = 0; r < kPer1; ++r) {
              const int e = tt + r * kTT;
              *reinterpret_cast<uint4*>(act + kImgBytes64 + img_off(e / 8, (e % 8) * 8)) = sv_[r];
            }
            after_write();
            if (tt == 0)
              bulk_store(gout_t + (1 + k) * (kImgBytes64 / 2), act_a + kImgBytes64, kImgBytes64);
            const uint32_t slab = slab_begin(ring, ring_base, kSlot) + cw * kHhw * kImgRowBytes;
#pragma unroll
            for (int ks = 0; ks < 4; ++ks)
              wgmma<kHhw, 0, 0>(ds, kmajor_desc(act_a + kImgBytes64, ks), kmajor_desc(slab, ks),
                                1);
            slab_end(ring, tid);
          }
        }
        before_overwrite();
        unsigned char* dst = act + (l == 1 ? 2 * kHI * kImgBytes64 : 0);
        const int sft = kMhw == 1 ? 16 * l : 0;
        const uint2 m_lo = mh_lo[kMhw == 1 ? 0 : l], m_hi = mh_hi[kMhw == 1 ? 0 : l];
#pragma unroll
        for (int j = 0; j < kHhw / 8; ++j) {
          const int col = cw * kHhw + 8 * j + 2 * q, at = sft + 2 * j;
          unsigned char* ri = dst + (col / 64) * kImgBytes64;
          unsigned char* si = dst + (kHI + col / 64) * kImgBytes64;
          *reinterpret_cast<uint32_t*>(ri + img_off(r_lo, col % 64)) =
              masked_pack(dr[4 * j], dr[4 * j + 1], m_lo.x >> at);
          *reinterpret_cast<uint32_t*>(ri + img_off(r_lo + 8, col % 64)) =
              masked_pack(dr[4 * j + 2], dr[4 * j + 3], m_hi.x >> at);
          *reinterpret_cast<uint32_t*>(si + img_off(r_lo, col % 64)) =
              masked_pack(ds[4 * j], ds[4 * j + 1], m_lo.y >> at);
          *reinterpret_cast<uint32_t*>(si + img_off(r_lo + 8, col % 64)) =
              masked_pack(ds[4 * j + 2], ds[4 * j + 3], m_hi.y >> at);
        }
        if constexpr (kHh < 64) {
#pragma unroll
          for (int j = kHh / 8; j < 8; ++j) {
            const int c = 8 * j + 2 * q;
#pragma unroll
            for (int w = 0; w < 2; ++w) {
              *reinterpret_cast<uint32_t*>(dst + w * kImgBytes64 + img_off(r_lo, c)) = 0u;
              *reinterpret_cast<uint32_t*>(dst + w * kImgBytes64 + img_off(r_lo + 8, c)) = 0u;
            }
          }
        }
        after_write();
        if (tt == 0)
          bulk_store((l == 1 ? a.g2 : a.g1) + tile * (kHI * kImgBytes64),
                     act_a + (l == 1 ? 2 * kHI * kImgBytes64 : 0), 2 * kHI * kImgBytes64);
        for (int e = tt; e < 2 * kHh; e += kTT) {
          const int head = e / kHh, col = e % kHh;
          part[(l == 1 ? (head ? off_s2 : off_r2) : (head ? off_s1 : off_r1)) + col] =
              image_column_sum(dst + (head * kHI + col / 64) * kImgBytes64, col % 64);
        }
      }

      // heads' first layers back to their input: d[SH | geo] from both heads in
      // one accumulator (both column halves form it, the first writes it); the
      // trunk output's cotangent [graw | d geo | 0] as image gti (bf16) and in
      // the next image (f32, for its column sums)
      float dx[kXw / 2];
      fresh(dx);
      if constexpr (T::kPerImage) {
        // one image a slab: rgb's k-blocks, then sem's
#pragma unroll
        for (int kb = 0; kb < 2 * kHI; ++kb) {
          const uint32_t slab = slab_begin(ring, ring_base, kSlot);
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
            wgmma<kXw, 0, 0>(dx, kmajor_desc(act_a + kb * kImgBytes64, ks), kmajor_desc(slab, ks),
                             (kb | ks) != 0);
          slab_end(ring, tid);
        }
      } else {
        const uint32_t slab = slab_begin(ring, ring_base, kSlot);
#pragma unroll
        for (int ks = 0; ks < kHh / 16; ++ks)
          wgmma<kXw, 0, 0>(dx, kmajor_desc(act_a + (ks / 4) * kImgBytes64, ks % 4),
                           kmajor_desc(slab + (ks / 4) * kXw * kImgRowBytes, ks % 4), ks != 0);
#pragma unroll
        for (int ks = 0; ks < kHh / 16; ++ks)
          wgmma<kXw, 0, 0>(dx, kmajor_desc(act_a + (kHI + ks / 4) * kImgBytes64, ks % 4),
                           kmajor_desc(slab + (kHI + ks / 4) * kXw * kImgRowBytes, ks % 4), 1);
        slab_end(ring, tid);
      }
      before_overwrite();
      if (cw == 0) {
#pragma unroll
        for (int e = 8; e < kXw / 2; ++e) {
          const int c = 8 * (e / 4) + 2 * q + (e & 1);  // column of [SH | geo], 16..
          const int i = r_lo + 8 * ((e >> 1) & 1), k = c - kShw;
          if (k < kTO - 1) {
            const float v = k < G ? dx[e] : 0.f;
            gtf[i * kTO + 1 + k] = v;
            *reinterpret_cast<bf16*>(gt + img_off(i, 1 + k)) = __float2bfloat16(v);
          }
        }
        if (q == 0) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int i = r_lo + 8 * half;
            const float v = graw[half];
            gtf[i * kTO] = v;
            *reinterpret_cast<bf16*>(gt + img_off(i, 0)) = __float2bfloat16(v);
          }
        }
      }
      // the chunks past the trunk output's columns: zero
      constexpr int kGtCh = 8 - kTO / 8;
      for (int e = tt; e < kTileRows * kGtCh; e += kTT)
        *reinterpret_cast<uint4*>(gt + img_off(e / kGtCh, (kTO / 8 + e % kGtCh) * 8)) =
            make_uint4(0u, 0u, 0u, 0u);
      after_write();
      if (tt == 0)
        bulk_store(a.gt + tile * (kImgBytes64 / 2), act_a + gti * kImgBytes64, kImgBytes64);
      if (tt < kTO) {
        float s = 0.f;
#pragma unroll 16
        for (int i = 0; i < kTileRows; ++i) s += gtf[i * kTO + tt];
        part[off_gtr + tt] = s;
      }
    } else {
      // the trunk alone: its output's bias gradient, the column sums of g
      // (f32, from device memory); the blocks of g are formed below
      for (int c = tt; c < 64 * n_gt; c += kTT) {
        float s = 0.f;
        if (c < a.out)
          for (int i = 0; i < kTileRows && row0 + i < a.n_rows; ++i)
            s += a.g_trunk[(size_t)(row0 + i) * a.out + c];
        part[off_gtr + c] = s;
      }
    }

    // trunk: gh[l] = bf16((gh[l + 1] @ w[l + 1]^T) * (h[l] > 0)), from the top;
    // a warpgroup forms its columns in kNh products (two at H = 1024), the
    // first's masked bf16 results waiting in device memory (`keep`) until the
    // last is formed
    auto g_block = [&](int k, unsigned char* img) {
      // the trunk alone: columns 64 k .. of g [64, out] (zero past out and
      // past n_rows) as a bf16 image, saved
      for (int e = tt; e < kTileRows * 32; e += kTT) {
        const int i = e / 32, c = 64 * k + 2 * (e % 32);
        const int row = row0 + i;
        float v0 = 0.f, v1 = 0.f;
        if (row < a.n_rows) {
          const float* gr = a.g_trunk + (size_t)row * a.out;
          if (c < a.out) v0 = gr[c];
          if (c + 1 < a.out) v1 = gr[c + 1];
        }
        *reinterpret_cast<uint32_t*>(img + img_off(i, c % 64)) = pack_bf16(v0, v1);
      }
      after_write();
      if (tt == 0)
        bulk_store(a.gt + (tile * n_gt + k) * (kImgBytes64 / 2), smem_u32(img), kImgBytes64);
    };
    if (kNh > 1 && !heads) {
      // every block of g in place (the host keeps them to 16)
      for (int k = 0; k < n_gt; ++k) g_block(k, act + k * kImgBytes64);
    }
    // the first half's words [j][row half] of this thread (H = 1024), in device memory
    uint32_t* keep = kNh > 1 ? a.keep + (size_t)blockIdx.x * keep_words(H) + tt : nullptr;
    for (int l = nh - 1; l >= 0; --l) {
#pragma unroll
      for (int hf = 0; hf < kNh; ++hf) {
        const size_t mq = (size_t)(q * T::kSplit + cw) * kNh + hf;  // the mask's column quarter
        const uint2 m_lo = a.mask_t[l][(size_t)(row0 + r_lo) * mrow + mq];
        const uint2 m_hi = a.mask_t[l][(size_t)(row0 + r_lo + 8) * mrow + mq];
        float d[kHwn / 2];
        fresh(d);
        const uint32_t wrow = cw * kHwn * kImgRowBytes;  // the warpgroup's rows of a slab
        if (l == nh - 1 && heads) {
          // gh[nh - 1] = gt @ w_out^T: kTO / 16 k-steps
          const uint32_t slab = slab_begin(ring, ring_base, kSlot) + wrow;
#pragma unroll
          for (int ks = 0; ks < kTO / 16; ++ks)
            wgmma<kHwn, 0, 0>(d, kmajor_desc(act_a + gti * kImgBytes64, ks), kmajor_desc(slab, ks),
                              ks != 0);
          slab_end(ring, tid);
        } else if (l == nh - 1) {
          // the trunk alone: g 64 columns at a time as image k % 2 (or, at
          // H = 1024, image k, formed above); gh[nh - 1] = g @ w_out^T (one
          // block in the one-product instances: a compile-time count)
          for (int k = 0; k < (kOne ? 1 : n_gt); ++k) {
            if (kNh == 1) {
              if (k > 0) before_overwrite();
              g_block(k, act + (k & 1) * kImgBytes64);
            }
            const uint32_t img = act_a + (kNh > 1 ? k : k & 1) * kImgBytes64;
            const uint32_t slab = slab_begin(ring, ring_base, kSlot) + wrow;
#pragma unroll
            for (int ks = 0; ks < 4; ++ks)
              wgmma<kHwn, 0, 0>(d, kmajor_desc(img, ks), kmajor_desc(slab, ks), (k | ks) != 0);
            slab_end(ring, tid);
          }
        } else {
          for (int kb = 0; kb < T::kHImgs; ++kb) {
            const uint32_t slab = slab_begin(ring, ring_base, kSlot) + wrow;
#pragma unroll
            for (int ks = 0; ks < 4; ++ks)
              wgmma<kHwn, 0, 0>(d, kmajor_desc(act_a + kb * kImgBytes64, ks),
                                kmajor_desc(slab, ks), (kb | ks) != 0);
            slab_end(ring, tid);
          }
        }
        if (hf + 1 < kNh) {
#pragma unroll
          for (int j = 0; j < kHwn / 8; ++j) {
            const int at = 2 * (j % 16);
            keep[2 * j * kTT] =
                masked_pack(d[4 * j], d[4 * j + 1], (j < 16 ? m_lo.x : m_lo.y) >> at);
            keep[(2 * j + 1) * kTT] =
                masked_pack(d[4 * j + 2], d[4 * j + 3], (j < 16 ? m_hi.x : m_hi.y) >> at);
          }
          continue;
        }
        before_overwrite();
        // the masked bf16 cotangent over images 0 .. H / 64 - 1
#pragma unroll
        for (int h2 = 0; h2 < kNh; ++h2) {
#pragma unroll
          for (int j = 0; j < kHwn / 8; ++j) {
            const int c = h2 * kHwn + 8 * j + 2 * q, at = 2 * (j % 16);  // the warpgroup's column
            uint32_t lo, hi;
            if (h2 + 1 < kNh) {
              lo = keep[2 * j * kTT];
              hi = keep[(2 * j + 1) * kTT];
            } else {
              lo = masked_pack(d[4 * j], d[4 * j + 1], (j < 16 ? m_lo.x : m_lo.y) >> at);
              hi = masked_pack(d[4 * j + 2], d[4 * j + 3], (j < 16 ? m_hi.x : m_hi.y) >> at);
            }
            unsigned char* img = act + ((cw * kHw + c) / 64) * kImgBytes64;
            *reinterpret_cast<uint32_t*>(img + img_off(r_lo, c % 64)) = lo;
            *reinterpret_cast<uint32_t*>(img + img_off(r_lo + 8, c % 64)) = hi;
          }
        }
      }
      after_write();
      if (tt == 0) bulk_store(a.gh[l] + tile * (T::kHBytes / 2), act_a, T::kHBytes);
      for (int c = tt; c < H; c += kTT)
        part[l * H + c] = image_column_sum(act + (c / 64) * kImgBytes64, c % 64);
    }

    // the first layer back, a group of kG blocks at a time: g_x = gh[0] @
    // w0^T [64, 64 kG]. With the encode, dproj = cos * g_sin - sin * g_cos
    // of the group's 32 kG frequencies, their dphase and dW_spec sums, and
    // du where asked for (summed over the frequencies in order); for the
    // trunk alone, dx where asked for
    float du_acc[2] = {0.f, 0.f};  // (row, dim) pairs tt and tt + kTT of 192
    const bf16* enc_t = a.enc + tile * nkb * (kImgBytes64 / 2);  // the tile's saved encoding
    for (int gq = 0; gq < n_groups; ++gq) {
      float dg[kBw / 2];
      fresh(dg);
      for (int kb = 0; kb < T::kHImgs; ++kb) {
        const uint32_t slab = slab_begin(ring, ring_base, kSlot) + cw * kBw * kImgRowBytes;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          wgmma<kBw, 0, 0>(dg, kmajor_desc(act_a + kb * kImgBytes64, ks), kmajor_desc(slab, ks),
                           (kb | ks) != 0);
        slab_end(ring, tid);
      }
      if (!encode) {
        if (a.dx != nullptr) {
          const int din = a.din;
#pragma unroll
          for (int j = 0; j < kBw / 8; ++j) {
            const int c = 64 * kGB * gq + cw * kBw + 8 * j + 2 * q;
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int row = row0 + r_lo + 8 * half;
              if (c < din && row < a.n_rows) {
                const size_t at = (size_t)row * din + c;
                const float v0 = dg[4 * j + 2 * half], v1 = dg[4 * j + 2 * half + 1];
                if (a.x_f32)
                  *reinterpret_cast<float2*>(static_cast<float*>(a.dx) + at) = make_float2(v0, v1);
                else
                  *reinterpret_cast<uint32_t*>(static_cast<bf16*>(a.dx) + at) = pack_bf16(v0, v1);
              }
            }
          }
        }
        continue;
      }
      // the saved cos of frequency f sits at column f of the encoding, its
      // sin at m + f: in the ring (one product), or in device memory
      const unsigned char* enc_s = reinterpret_cast<const unsigned char*>(enc_t);
      uint32_t enc_bar[T::kTiles];
      float* dpp = dp;
      if constexpr (kOne) {
        int st = 0;
#pragma unroll
        for (int t = 0; t < T::kTiles; ++t) {
          ring.wait_full();
          if (t == tl) st = ring.stage;
          enc_bar[t] = ring.empty_bar();
          ring.advance();
        }
        enc_s = smem + L.ring + st * kSlot;
        before_overwrite();  // gh[0]'s store reads the buffer dproj goes over
        dpp = reinterpret_cast<float*>(act);
      }
      if (kOne && mc == kGF)  // m fills the product: the sin half at a compile-time offset
        group_dproj<kBw, kGF, kGF>(dg, enc_s, 0, dpp, cw, q, r_lo, kGF * gq);
      else
        group_dproj<kBw, kGF, 0>(dg, enc_s, mc, dpp, cw, q, r_lo, kGF * gq);
      tile_sync();
      if constexpr (kOne) {
        if (tid == 0) {
#pragma unroll
          for (int t = 0; t < T::kTiles; ++t) mbar_arrive(enc_bar[t]);
        }
      }
      if (tt < kGF) {
        // thread tt owns frequency kGF gq + tt: dphase and the three rows of dW_spec
        float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll 16
        for (int i = 0; i < kTileRows; ++i) {
          const int row = row0 + i;
          const float v = dpp[dp_at<kGF>(i, tt)];
          s0 += v;
          if (row < a.n_rows) {
            const float vb = round_bf16(v);
            s1 += round_bf16(u_s[i * 3 + 0]) * vb;
            s2 += round_bf16(u_s[i * 3 + 1]) * vb;
            s3 += round_bf16(u_s[i * 3 + 2]) * vb;
          }
        }
        const int f = kGF * gq + tt;
        part[off_dph + f] = s0;
        part[off_dph + mp + f] = s1 * kTwoPi;
        part[off_dph + 2 * mp + f] = s2 * kTwoPi;
        part[off_dph + 3 * mp + f] = s3 * kTwoPi;
      }
      if (a.du != nullptr) {
        const int nf = min(kGF, a.n_freq - kGF * gq);
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int e = tt + k * kTT;
          if (e < kTileRows * 3) {
            const int i = e / 3, dd = e % 3;
            const float* w = a.W + dd * a.n_freq + kGF * gq;
            float s = du_acc[k];
            for (int j = 0; j < nf; ++j) s += round_bf16(dpp[dp_at<kGF>(i, j)]) * round_bf16(w[j]);
            du_acc[k] = s;
          }
        }
      }
      tile_sync();
    }
    if (encode && a.du != nullptr) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int e = tt + k * kTT;
        if (e < kTileRows * 3 && row0 + e / 3 < a.n_rows)
          a.du[(size_t)(row0 + e / 3) * 3 + e % 3] = du_acc[k] * kTwoPi;
      }
    }
    // the next pass overwrites the buffer the last stores read
    before_overwrite();
  }
  if (tt == 0) bulk_store_wait();
}

// ---- 4. weight gradients: dW = X^T dY over all rows ---------------------------------
//
// One launch for up to kDwItems products of the field (or of the trunk
// alone; the host launches again for more). The saved activations X and
// the cotangents dY lie in global memory as tile images whose rows are
// samples: exactly the MN-major wgmma operands of a product whose K runs
// over samples. An item is one product per consumer warpgroup w, P[64, n]
// = image(x, x_img[w])^T @ images(y, y_img[w] ...), n = 64, 128 or 256
// (n / 64 dY images, shared by both warpgroups where y_img[0] ==
// y_img[1], else n <= 128 each). A block takes one chunk of an item's row
// tiles; the producer warp brings each tile's images by bulk copies; the
// partial products go to P in f32 and dw_reduce_kernel adds an item's
// chunks in order.

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
  int n;                   // 64, 128 or 256 (at most 128 where y_img[0] != y_img[1])
  int chunks, chunk_tiles;  // row chunks and row tiles a chunk
  int first_block;         // blocks first_block .. first_block + chunks - 1
  long long p_off;         // floats: this item's partials [chunks][2][64][n] in P
  long long out_off;       // floats: this item's sums [2][64][n] in the output
};

struct DwArgs {
  DwItem items[32];  // _MAX_ITEMS in field_train.py
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

#if APNERF_PART == 0
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

// a consumer warpgroup's product over row tiles t0 .. t1 - 1: its X image
// at xw, its dY images from 2 + yw in each ring stage
template <int N>
__device__ __forceinline__ void dw_product(Ring<kDwStages>& ring, uint32_t ring_base, int t0,
                                           int t1, int xw, int yw, float* dst, int tid) {
  float d[N / 2];
  fresh(d);
  for (int t = t0; t < t1; ++t) {
    const uint32_t st = slab_begin(ring, ring_base, kDwStageBytes);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma<N, 1, 1>(d, mnmajor_desc(st + xw * kImgBytes64, ks, kImgBytes64),
                     mnmajor_desc(st + (2 + yw) * kImgBytes64, ks, kImgBytes64),
                     (t != t0) | ks);
    slab_end(ring, tid);
  }
  dw_store<N>(d, dst, tid);
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
  // an image both warpgroups read is brought once
  const bool x_shared = item.x_img[0] == item.x_img[1];
  const bool y_shared = item.y_img[0] == item.y_img[1];
  const int ny = item.n / 64;  // dY images a warpgroup reads
  Ring<kDwStages> ring;
  ring.full = full;
  ring.empty = empty;

  if (threadIdx.x >= 2 * kWg) {
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 2 * kWg) {
      const unsigned char* x = reinterpret_cast<const unsigned char*>(item.x);
      const unsigned char* y = reinterpret_cast<const unsigned char*>(item.y);
      const int nx = x_shared ? 1 : 2, nyw = y_shared ? 1 : 2;
      for (int t = t0; t < t1; ++t) {
        ring.wait_empty();
        const uint32_t dst = ring_base + ring.stage * kDwStageBytes;
        mbar_expect_tx(ring.full_bar(), (nx + nyw * ny) * kImgBytes64);
        for (int w = 0; w < nx; ++w)
          bulk_load(dst + w * kImgBytes64,
                    x + ((size_t)t * item.x_imgs + item.x_img[w]) * kImgBytes64, kImgBytes64,
                    ring.full_bar());
        for (int w = 0; w < nyw; ++w)
          bulk_load(dst + (2 + w * ny) * kImgBytes64,
                    y + ((size_t)t * item.y_imgs + item.y_img[w]) * kImgBytes64, ny * kImgBytes64,
                    ring.full_bar());
        ring.advance();
      }
    }
    return;
  }

  reg_alloc<kConsumerRegs>();
  const int wg = threadIdx.x / kWg, tid = threadIdx.x % kWg;
  const int xw = x_shared ? 0 : wg, yw = y_shared ? 0 : wg * ny;
  float* dst = a.P + item.p_off + ((size_t)chunk * 2 + wg) * kTileRows * item.n;
  if (item.n == 256)
    dw_product<256>(ring, ring_base, t0, t1, xw, yw, dst, tid);
  else if (item.n == 128)
    dw_product<128>(ring, ring_base, t0, t1, xw, yw, dst, tid);
  else
    dw_product<64>(ring, ring_base, t0, t1, xw, yw, dst, tid);
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
#endif  // APNERF_PART == 0

template <int H, bool kWhole, int kCP, int kTO>
int launch_field_fwd(const FvrArgs* a, int grid, cudaStream_t stream) {
  const size_t smem = fwd_smem(H, a->n_hidden, kTO, kCP).total;
  int err = set_smem((const void*)fvr_field_fwd_kernel<H, kWhole, kCP, kTO>, smem);
  if (err) return err;
  fvr_field_fwd_kernel<H, kWhole, kCP, kTO><<<grid, kFieldThreads, smem, stream>>>(*a);
  return (int)cudaGetLastError();
}

template <int H, int kG, int kCP, int kTO>
int launch_field_bwd(const FvrArgs* a, int grid, cudaStream_t stream) {
  const size_t smem = bwd_smem(H).total;
  int err = set_smem((const void*)fvr_field_bwd_kernel<H, kG, kCP, kTO>, smem);
  if (err) return err;
  fvr_field_bwd_kernel<H, kG, kCP, kTO><<<grid, kFieldThreads, smem, stream>>>(*a);
  return (int)cudaGetLastError();
}

// instance (H, tier) where this part compiles it, else kElsewhere; the
// trunk alone (heads = 0) runs the first tier's
template <int H, int kTier, int kTO, int kCP>
int field_fwd_at(const FvrArgs* a, int grid, cudaStream_t stream) {
  if constexpr (part_of<APNERF_PARTS>(H, kTier) == APNERF_PART) {
    if constexpr (H > 512) {
      return launch_field_fwd<H, false, kCP, kTO>(a, grid, stream);  // no kWhole instance
    } else {
      return whole_enc(H, a->x == nullptr, a->n_kb)
                 ? launch_field_fwd<H, true, kCP, kTO>(a, grid, stream)
                 : launch_field_fwd<H, false, kCP, kTO>(a, grid, stream);
    }
  } else {
    return kElsewhere;
  }
}

template <int H, int kTier, int kTO, int kCP>
int field_bwd_at(const FvrArgs* a, int grid, cudaStream_t stream) {
  if constexpr (part_of<APNERF_PARTS>(H, kTier) == APNERF_PART) {
    const int n_back = a->x == nullptr ? (a->n_freq + kBlockFreqs - 1) / kBlockFreqs : a->n_kb;
    if constexpr (H > 512) {
      (void)n_back;
      return launch_field_bwd<H, 0, kCP, kTO>(a, grid, stream);
    } else {
      switch (back_group(n_back, a->heads ? 1 : (a->out + 63) / 64)) {
        case 4: return launch_field_bwd<H, 4, kCP, kTO>(a, grid, stream);
        case 2: return launch_field_bwd<H, 2, kCP, kTO>(a, grid, stream);
        case 1: return launch_field_bwd<H, 1, kCP, kTO>(a, grid, stream);
        default: return launch_field_bwd<H, 0, kCP, kTO>(a, grid, stream);
      }
    }
  } else {
    return kElsewhere;
  }
}

}  // namespace

// This part's instances of the field forward and backward: the instance
// (a->tile_h, the tier of a->t_out and a->c_tile; the first for the trunk
// alone), or kElsewhere where another part compiles it.
#define APNERF_PART_ENTRY(NAME, AT)                                                          \
  extern "C" int APNERF_IN_PART(NAME)(const FvrArgs* a, int grid, void* stream) {           \
    const int tier = a->heads ? tier_of(a->t_out, a->c_tile) : 0;                           \
    APNERF_FIELD_TIERS(APNERF_TIER_OF_##AT)                                                 \
    return (int)cudaErrorInvalidValue;                                                      \
  }
#define APNERF_CASE(AT, T_, TO_, CP_, H_) \
  if (a->tile_h == H_ && tier == T_) return AT<H_, T_, TO_, CP_>(a, grid, (cudaStream_t)stream);
#define APNERF_TIER_OF_field_fwd_at(T_, TO_, CP_)                                     \
  APNERF_CASE(field_fwd_at, T_, TO_, CP_, 64) APNERF_CASE(field_fwd_at, T_, TO_, CP_, 128) \
  APNERF_CASE(field_fwd_at, T_, TO_, CP_, 256) APNERF_CASE(field_fwd_at, T_, TO_, CP_, 512) \
  APNERF_CASE(field_fwd_at, T_, TO_, CP_, 1024)
#define APNERF_TIER_OF_field_bwd_at(T_, TO_, CP_)                                     \
  APNERF_CASE(field_bwd_at, T_, TO_, CP_, 64) APNERF_CASE(field_bwd_at, T_, TO_, CP_, 128) \
  APNERF_CASE(field_bwd_at, T_, TO_, CP_, 256) APNERF_CASE(field_bwd_at, T_, TO_, CP_, 512) \
  APNERF_CASE(field_bwd_at, T_, TO_, CP_, 1024)
APNERF_PART_ENTRY(apnerf_fvr_field_fwd, field_fwd_at)
APNERF_PART_ENTRY(apnerf_fvr_field_bwd, field_bwd_at)
#undef APNERF_TIER_OF_field_fwd_at
#undef APNERF_TIER_OF_field_bwd_at
#undef APNERF_CASE
#undef APNERF_PART_ENTRY

#if APNERF_PART == 0

#define APNERF_EACH_PART(X) X(0) X(1) X(2) X(3) X(4) X(5) X(6) X(7)
#define APNERF_DECLARE(P_)                                                    \
  extern "C" int apnerf_fvr_field_fwd_p##P_(const FvrArgs*, int, void*); \
  extern "C" int apnerf_fvr_field_bwd_p##P_(const FvrArgs*, int, void*);
APNERF_EACH_PART(APNERF_DECLARE)
#undef APNERF_DECLARE

// What field_images.py mirrors, for a check on the card: shared memory
// (bytes) of the field forward (which = 0) at the tier (t_pad, c_tile), the
// field backward (1) and the weight gradients (2), and the width of a
// tile_part row (3), at the instance h, a trunk output padded to t_pad
// and mp frequencies.
extern "C" int apnerf_field_layout(int which, int h, int n_hidden, int t_pad, int mp,
                                   int c_tile) {
  return which == 0   ? fwd_smem(h, n_hidden, t_pad, c_tile).total
         : which == 1 ? bwd_smem(h).total
         : which == 2 ? dw_smem().total
                      : n_bias(n_hidden, h, t_pad, mp);
}

// Each entry launches on `stream` and returns cudaGetLastError(); none
// allocates. `grid` is the number of persistent blocks. The field kernels
// run the instance (a->tile_h, the tier); another is cudaErrorInvalidValue.
extern "C" int apnerf_fvr_field_fwd(const FvrArgs* a, int grid, void* stream) {
  int err = kElsewhere;
#define APNERF_TRY(P_) \
  if (err == kElsewhere) err = apnerf_fvr_field_fwd_p##P_(a, grid, stream);
  APNERF_EACH_PART(APNERF_TRY)
#undef APNERF_TRY
  return err == kElsewhere ? (int)cudaErrorInvalidValue : err;
}

extern "C" int apnerf_fvr_field_bwd(const FvrArgs* a, int grid, void* stream) {
  int err = kElsewhere;
#define APNERF_TRY(P_) \
  if (err == kElsewhere) err = apnerf_fvr_field_bwd_p##P_(a, grid, stream);
  APNERF_EACH_PART(APNERF_TRY)
#undef APNERF_TRY
  return err == kElsewhere ? (int)cudaErrorInvalidValue : err;
}

// with_loss = 1: the train step's ray kernel; 0: the render's backward
// from given cotangents (a->g_acc, a->g_w). `rays` a block (1..kRayWarps)
// and `stage` as the wrapper planned them (fused_field_volrend.py::
// ray_plan): null, each warp's w and T in shared memory; else [N, 2]
// floats of device memory for them.
extern "C" int apnerf_fvr_rays(const FvrArgs* a, int with_loss, int rays, float* stage,
                               void* stream) {
  if (rays < 1 || rays > kRayWarps) return (int)cudaErrorInvalidValue;
  const size_t per_warp =
      (stage == nullptr ? 2 * (size_t)a->n_samples : 0) + 2 * (size_t)ray_chan(a->c_pad);
  const size_t smem = rays * per_warp * sizeof(float);
  const void* kernel =
      with_loss ? (const void*)fvr_ray_kernel<true> : (const void*)fvr_ray_kernel<false>;
  int err = set_smem(kernel, smem);
  if (err) return err;
  const int grid = (a->n_rays + rays - 1) / rays;
  if (with_loss)
    fvr_ray_kernel<true><<<grid, rays * 32, smem, static_cast<cudaStream_t>(stream)>>>(*a, stage);
  else
    fvr_ray_kernel<false><<<grid, rays * 32, smem, static_cast<cudaStream_t>(stream)>>>(*a, stage);
  return (int)cudaGetLastError();
}

// `rays` a block (1..kRayWarps) and `in_smem` (each warp's weights in
// shared memory, or 0: read back from w) as the wrapper planned them
// (fused_field_volrend.py::fwd_ray_plan).
extern "C" int apnerf_fvr_fwd_rays(const float* y, const float* dt, const float* tm, float* acc,
                                   float* w, int n_rays, int n_samples, int n_classes, int rays,
                                   int in_smem, void* stream) {
  if (rays < 1 || rays > kRayWarps) return (int)cudaErrorInvalidValue;
  const size_t smem = in_smem ? (size_t)rays * n_samples * sizeof(float) : 0;
  int err = set_smem((const void*)fvr_fwd_ray_kernel, smem);
  if (err) return err;
  fvr_fwd_ray_kernel<<<(n_rays + rays - 1) / rays, rays * 32, smem,
                       static_cast<cudaStream_t>(stream)>>>(y, dt, tm, acc, w, n_rays,
                                                            n_samples, n_classes, in_smem);
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

#endif  // APNERF_PART == 0
