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
// launches from one wrapper, all written here, no library product:
//   1. fvr_field_fwd_kernel: the whole field on a 64-row tile
//      (field_heads_tile.cuh); it writes the bf16 activations the
//      backward needs to a scratch buffer (~0.7 GB per call at the
//      shipping shape) and the per-sample sigma, rgb, sem;
//   2. fvr_ray_kernel: one warp per ray, so the exclusive and the
//      reverse scans are warp scans; weights, per-ray sums, loss rows and
//      the per-sample cotangents;
//   3. fvr_field_bwd_kernel: dX = dY W^T with the ReLU masks, 64 rows a
//      block, back to the spectral phase; per-block f32 column sums give
//      the bias, phase and spectrum gradients;
//   4. xt_dy_kernel: dW = X^T dY over all rows as f32 per-chunk partials,
//      and sum_rows_kernel: a second pass that adds the partials in a
//      fixed order, so the gradients are the same from run to run (float
//      atomics would not be).
// wgmma, TMA and tuning are later work.
//
// The file also holds the ray kernel of the forward-only render
// (fused_field_volrend's forward, section 2b below), which shares the
// per-ray scan with fvr_ray_kernel and stops after the sums.

#include <cfloat>

#include "field_heads_tile.cuh"

// Every pointer and size of one call; mirrors _FvrArgs in
// apnerf_tpu_torch/ops/cuda/fused_field_volrend.py field by field. At
// namespace scope, so the extern "C" entries that take it keep external
// linkage.
struct FvrArgs {
  static constexpr bool kSaves = true;  // field_forward_tile stores the activations below
  // inputs
  const float* u;      // [N, 3] unit-cube coordinates
  const float* sh;     // [R, 16] SH of the ray directions
  const float* dt;     // [N] t1 - t0, zero on rays that miss the box
  const float* tm;     // [N] interval midpoints
  const float* pix;    // [R, 3]
  const float* dgt;    // [R]
  const int* lab;      // [R]
  const float* bk;     // [3]
  const float* W;      // [3, M]
  const float* phase;  // [M]
  const bf16* tw[4];   // trunk weights [in, out] bf16; the last one [H, out_pad]
  const float* tb[4];  // trunk biases f32; the last one [out_pad]
  const bf16* rw[3];   // rgb head [32, hh], [hh, hh], [hh, 16] bf16, zero-padded
  const float* rb[3];  // [hh], [hh], [16]
  const bf16* sw[3];   // sem head [16, hh], [hh, hh], [hh, c_pad]
  const float* sb[3];  // [hh], [hh], [c_pad]
  // scratch, rows padded to n_rows_pad (a multiple of 64)
  bf16* enc;           // [Np, 2M]
  bf16* h[3];          // [Np, H] trunk hidden activations
  bf16* xr;            // [Np, 32] rgb-head input; its columns 16.. are the sem-head input
  bf16* hr1;           // [Np, hh] rgb-head hidden activations
  bf16* hr2;
  bf16* hs1;           // [Np, hh] sem-head hidden activations
  bf16* hs2;
  float* sigma;        // [N]
  float* dsd;          // [N] d sigma / d raw = exp(min(raw - 1, 15)) * in-cube
  float* rgb;          // [N, 3]
  float* sem;          // [N, C]
  float* graw;         // [N] loss cotangent of raw
  bf16* gout_rgb;      // [Np, 16] cotangent of the rgb-head output (pre-sigmoid)
  bf16* gout_sem;      // [Np, c_pad] cotangent of the semantic logits
  float* ray_part;     // [R, 16 + c_pad] per-ray f32 sums of those cotangents
  bf16* gtrb;          // [Np, trunk_out_pad] cotangent of the trunk output
  bf16* gh[3];         // [Np, H] cotangents of the trunk pre-activations
  bf16* gr1;           // [Np, hh] rgb-head pre-activation cotangents
  bf16* gr2;
  bf16* gs1;           // [Np, hh] sem-head pre-activation cotangents
  bf16* gs2;
  float* tile_part;    // [Np / 64, n_bias] per-block column sums (see bias layout)
  // outputs
  float* w;            // [N] weights
  float* lossrows;     // [3, R] per-ray huber rgb (summed over channels), huber depth, CE
  // sizes
  int n_rows, n_rows_pad, n_rays, n_samples;
  int m, hidden, n_layers, trunk_out_pad, geo;
  int head_hidden, n_classes, c_pad;
  float c_rgb, c_dep, c_sem;  // loss weight / mean norm of each term
};

namespace {

using namespace nvcuda;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRayWarps = 8;    // rays per block of fvr_ray_kernel
constexpr int kRayChan = 128;   // per-ray channel slots in shared memory (3 + C <= 64, twice)

// bias layout of a tile_part row: trunk pre-activation sums (n_hidden x H),
// trunk output (trunk_out_pad), rgb head (hh, hh), sem head (hh, hh),
// dphase (M), dW_spec (3 x M, scaled by 2 pi)
__host__ __device__ inline int n_bias(const FvrArgs& a) {
  return (a.n_layers - 1) * a.hidden + a.trunk_out_pad + 4 * a.head_hidden + 4 * a.m;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// s[i, :cols] = g[row0 + i, :cols], zero for rows at or past n_valid
__device__ void load_tile(const bf16* g, int cols, int row0, int n_valid, bf16* s, int ld_s) {
  const int vpr = cols / 8;
  for (int e = threadIdx.x; e < kTileRows * vpr; e += kThreads) {
    const int i = e / vpr, v = e % vpr;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + i < n_valid)
      val = *reinterpret_cast<const uint4*>(g + (size_t)(row0 + i) * cols + v * 8);
    *reinterpret_cast<uint4*>(s + i * ld_s + v * 8) = val;
  }
}

// part[col] = sum over the tile's 64 rows of s[i, col] (bf16 values, f32 sum)
__device__ void column_sums(const bf16* s, int ld_s, int cols, float* part) {
  for (int c = threadIdx.x; c < cols; c += kThreads) {
    float acc = 0.f;
    for (int i = 0; i < kTileRows; ++i) acc += bf(s[i * ld_s + c]);
    part[c] = acc;
  }
}

// dst[64, n_out] = bf16((src[64, k] @ w^T) * (mask[row0 + i, :] > 0)), where
// w is a native [n_out, ldw] weight read transposed (so this is dX = dY W^T
// through a ReLU) and mask is the saved forward activation [Np, ld_mask].
__device__ void bwd_layer(const bf16* src, int ld_src, int k, const bf16* w, int ldw,
                          int n_out, const bf16* mask, int ld_mask, int row0, bf16* dst,
                          int ld_dst, float* scratch) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int ct = warp; ct < n_out / 16; ct += kWarps) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kRowTiles];
#pragma unroll
    for (int r = 0; r < kRowTiles; ++r) wmma::fill_fragment(acc[r], 0.f);
    for (int kk = 0; kk < k; kk += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfrag;
      wmma::load_matrix_sync(bfrag, w + (size_t)ct * 16 * ldw + kk, ldw);
#pragma unroll
      for (int r = 0; r < kRowTiles; ++r) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> afrag;
        wmma::load_matrix_sync(afrag, src + r * 16 * ld_src + kk, ld_src);
        wmma::mma_sync(acc[r], afrag, bfrag, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRowTiles; ++r) {
      wmma::store_matrix_sync(scratch, acc[r], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int i = r * 16 + e / 16, col = ct * 16 + e % 16;
        const bool on = bf(mask[(size_t)(row0 + i) * ld_mask + col]) > 0.f;
        dst[i * ld_dst + col] = __float2bfloat16(on ? scratch[e] : 0.f);
      }
      __syncwarp();
    }
  }
}

// dst[64, n_out] = src[64, k] @ w^T in f32 (w native [n_out, ldw]); no mask
__device__ void bwd_linear_f32(const bf16* src, int ld_src, int k, const bf16* w, int ldw,
                               int n_out, float* dst, int ld_dst) {
  const int warp = threadIdx.x / 32;
  const int n_tiles = kRowTiles * (n_out / 16);
  for (int t = warp; t < n_tiles; t += kWarps) {
    const int r = t % kRowTiles, ct = t / kRowTiles;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
    for (int kk = 0; kk < k; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> afrag;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfrag;
      wmma::load_matrix_sync(afrag, src + r * 16 * ld_src + kk, ld_src);
      wmma::load_matrix_sync(bfrag, w + (size_t)ct * 16 * ldw + kk, ldw);
      wmma::mma_sync(acc, afrag, bfrag, acc);
    }
    wmma::store_matrix_sync(dst + r * 16 * ld_dst + ct * 16, acc, ld_dst, wmma::mem_row_major);
  }
}

// ---- 1. field forward -------------------------------------------------------

// per-sample outputs of the train step's field pass
struct TrainEpilogue {
  float* sigma;
  float* dsd;
  float* rgb_out;
  float* sem_out;
  int n_classes;
  __device__ void density(int, int row, bool in, float raw) {
    sigma[row] = in ? expf(raw - 1.f) : 0.f;
    dsd[row] = in ? expf(fminf(raw - 1.f, 15.f)) : 0.f;
  }
  __device__ void rgb(int, int row, int c, float v) { rgb_out[(size_t)row * 3 + c] = v; }
  __device__ void sem(int, int row, int c, float v) {
    sem_out[(size_t)row * n_classes + c] = v;
  }
};

__global__ void __launch_bounds__(kThreads) fvr_field_fwd_kernel(FvrArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  TrainEpilogue epi{a.sigma, a.dsd, a.rgb, a.sem, a.n_classes};
  // the call's arguments are the field's parameters and its save buffers
  field_forward_tile(a, a, a.u, a.sh, a.n_rows, a.n_samples, blockIdx.x * kTileRows, smem,
                     epi);
}

// ---- 2. per-ray volume rendering, loss and cotangents -------------------------

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
      a.w[base + i] = w;
      op += round_bf16(w);
      dn += round_bf16(w * a.tm[base + i]);
    }
    carry += __shfl_sync(kFull, incl, 31);
  }
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
  const float gop = round_bf16(g_op);
  const float gdn = round_bf16(a.c_dep * hubd / ope);
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

struct BwdSmem {
  int ld_go, ld_gs, ld_h, ld_gt, ld_b;
  size_t go, gs, r1, r2, s1, s2, fx, fs, gt, gtf, b1, b2, dp, scratch, total;
};

__host__ __device__ inline BwdSmem bwd_smem(const FvrArgs& p) {
  BwdSmem s;
  s.ld_go = kRgbPad + kPad;
  s.ld_gs = p.c_pad + kPad;
  s.ld_h = p.head_hidden + kPad;
  s.ld_gt = p.trunk_out_pad + kPad;
  s.ld_b = p.hidden + kPad;
  size_t o = 0;
  s.go = o; o += (size_t)kTileRows * s.ld_go * sizeof(bf16);
  s.gs = o; o += (size_t)kTileRows * s.ld_gs * sizeof(bf16);
  s.r1 = o; o += (size_t)kTileRows * s.ld_h * sizeof(bf16);
  s.r2 = o; o += (size_t)kTileRows * s.ld_h * sizeof(bf16);
  s.s1 = o; o += (size_t)kTileRows * s.ld_h * sizeof(bf16);
  s.s2 = o; o += (size_t)kTileRows * s.ld_h * sizeof(bf16);
  s.gt = o; o += (size_t)kTileRows * s.ld_gt * sizeof(bf16);
  s.b1 = o; o += (size_t)kTileRows * s.ld_b * sizeof(bf16);
  s.b2 = o; o += (size_t)kTileRows * s.ld_b * sizeof(bf16);
  s.fx = o; o += (size_t)kTileRows * kXr * sizeof(float);
  s.fs = o; o += (size_t)kTileRows * (kXr - kShw) * sizeof(float);
  s.gtf = o; o += (size_t)kTileRows * p.trunk_out_pad * sizeof(float);
  s.dp = o; o += (size_t)kTileRows * p.m * sizeof(float);
  s.scratch = o; o += (size_t)kWarps * 512 * sizeof(float);
  s.total = o;
  return s;
}

__global__ void __launch_bounds__(kThreads) fvr_field_bwd_kernel(FvrArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const BwdSmem L = bwd_smem(a);
  const int m = a.m, h = a.hidden, hh = a.head_hidden, nh = a.n_layers - 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  bf16* go = reinterpret_cast<bf16*>(smem + L.go);
  bf16* gs = reinterpret_cast<bf16*>(smem + L.gs);
  bf16* r1 = reinterpret_cast<bf16*>(smem + L.r1);
  bf16* r2 = reinterpret_cast<bf16*>(smem + L.r2);
  bf16* s1 = reinterpret_cast<bf16*>(smem + L.s1);
  bf16* s2 = reinterpret_cast<bf16*>(smem + L.s2);
  bf16* gt = reinterpret_cast<bf16*>(smem + L.gt);
  bf16* b1 = reinterpret_cast<bf16*>(smem + L.b1);
  bf16* b2 = reinterpret_cast<bf16*>(smem + L.b2);
  float* fx = reinterpret_cast<float*>(smem + L.fx);
  float* fs = reinterpret_cast<float*>(smem + L.fs);
  float* gtf = reinterpret_cast<float*>(smem + L.gtf);
  float* dp = reinterpret_cast<float*>(smem + L.dp);
  float* scratch = reinterpret_cast<float*>(smem + L.scratch) + warp * 512;
  const int row0 = blockIdx.x * kTileRows;
  float* part = a.tile_part + (size_t)blockIdx.x * n_bias(a);
  const int off_gtr = nh * h;
  const int off_r1 = off_gtr + a.trunk_out_pad;
  const int off_r2 = off_r1 + hh, off_s1 = off_r2 + hh, off_s2 = off_s1 + hh;
  const int off_dph = off_s2 + hh;  // then dW_spec at off_dph + m

  // heads: output cotangents back to their inputs (pad rows are zero)
  load_tile(a.gout_rgb, kRgbPad, row0, a.n_rows, go, L.ld_go);
  load_tile(a.gout_sem, a.c_pad, row0, a.n_rows, gs, L.ld_gs);
  __syncthreads();
  bwd_layer(go, L.ld_go, kRgbPad, a.rw[2], kRgbPad, hh, a.hr2, hh, row0, r2, L.ld_h, scratch);
  bwd_layer(gs, L.ld_gs, a.c_pad, a.sw[2], a.c_pad, hh, a.hs2, hh, row0, s2, L.ld_h, scratch);
  __syncthreads();
  bwd_layer(r2, L.ld_h, hh, a.rw[1], hh, hh, a.hr1, hh, row0, r1, L.ld_h, scratch);
  bwd_layer(s2, L.ld_h, hh, a.sw[1], hh, hh, a.hs1, hh, row0, s1, L.ld_h, scratch);
  __syncthreads();
  bwd_linear_f32(r1, L.ld_h, hh, a.rw[0], hh, kXr, fx, kXr);
  bwd_linear_f32(s1, L.ld_h, hh, a.sw[0], hh, kXr - kShw, fs, kXr - kShw);
  store_tile(r1, L.ld_h, hh, a.gr1, row0);
  store_tile(r2, L.ld_h, hh, a.gr2, row0);
  store_tile(s1, L.ld_h, hh, a.gs1, row0);
  store_tile(s2, L.ld_h, hh, a.gs2, row0);
  column_sums(r1, L.ld_h, hh, part + off_r1);
  column_sums(r2, L.ld_h, hh, part + off_r2);
  column_sums(s1, L.ld_h, hh, part + off_s1);
  column_sums(s2, L.ld_h, hh, part + off_s2);
  __syncthreads();

  // trunk output cotangent: [graw | d geo from both heads | 0]
  for (int e = threadIdx.x; e < kTileRows * a.trunk_out_pad; e += kThreads) {
    const int i = e / a.trunk_out_pad, j = e % a.trunk_out_pad;
    const int row = row0 + i;
    float v = 0.f;
    if (j == 0) {
      if (row < a.n_rows) v = a.graw[row];
    } else if (j - 1 < a.geo) {
      v = fx[i * kXr + kShw + (j - 1)] + fs[i * (kXr - kShw) + (j - 1)];
    }
    gtf[i * a.trunk_out_pad + j] = v;
    gt[i * L.ld_gt + j] = __float2bfloat16(v);
  }
  __syncthreads();
  store_tile(gt, L.ld_gt, a.trunk_out_pad, a.gtrb, row0);
  for (int c = threadIdx.x; c < a.trunk_out_pad; c += kThreads) {
    float s = 0.f;
    for (int i = 0; i < kTileRows; ++i) s += gtf[i * a.trunk_out_pad + c];
    part[off_gtr + c] = s;
  }

  // trunk: gh[l] = bf16((gh[l+1] @ w[l+1]^T) * (h[l] > 0)), from the top
  bwd_layer(gt, L.ld_gt, a.trunk_out_pad, a.tw[nh], a.trunk_out_pad, h, a.h[nh - 1], h, row0,
            b1, L.ld_b, scratch);
  __syncthreads();
  store_tile(b1, L.ld_b, h, a.gh[nh - 1], row0);
  column_sums(b1, L.ld_b, h, part + (nh - 1) * h);
  bf16* cur = b1;
  bf16* nxt = b2;
  for (int l = nh - 1; l >= 1; --l) {
    bwd_layer(cur, L.ld_b, h, a.tw[l], h, h, a.h[l - 1], h, row0, nxt, L.ld_b, scratch);
    __syncthreads();
    store_tile(nxt, L.ld_b, h, a.gh[l - 1], row0);
    column_sums(nxt, L.ld_b, h, part + (l - 1) * h);
    bf16* t = cur;
    cur = nxt;
    nxt = t;
  }

  // encode: g_enc = gh[0] @ w0^T; dproj = cos * g_sin - sin * g_cos. A warp
  // owns column strip ct of both halves, so each dproj element is local.
  for (int ct = warp; ct < m / 16; ct += kWarps) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> ac[kRowTiles], as[kRowTiles];
#pragma unroll
    for (int r = 0; r < kRowTiles; ++r) {
      wmma::fill_fragment(ac[r], 0.f);
      wmma::fill_fragment(as[r], 0.f);
    }
    for (int kk = 0; kk < h; kk += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bc, bs;
      wmma::load_matrix_sync(bc, a.tw[0] + (size_t)(ct * 16) * h + kk, h);
      wmma::load_matrix_sync(bs, a.tw[0] + (size_t)(m + ct * 16) * h + kk, h);
#pragma unroll
      for (int r = 0; r < kRowTiles; ++r) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
        wmma::load_matrix_sync(af, cur + r * 16 * L.ld_b + kk, L.ld_b);
        wmma::mma_sync(ac[r], af, bc, ac[r]);
        wmma::mma_sync(as[r], af, bs, as[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRowTiles; ++r) {
      wmma::store_matrix_sync(scratch, ac[r], 16, wmma::mem_row_major);
      wmma::store_matrix_sync(scratch + 256, as[r], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int i = r * 16 + e / 16, j = ct * 16 + e % 16;
        const bf16* er = a.enc + (size_t)(row0 + i) * (2 * m);
        dp[i * m + j] = bf(er[j]) * scratch[256 + e] - bf(er[m + j]) * scratch[e];
      }
      __syncwarp();
    }
  }
  __syncthreads();
  // dphase = sum dproj; dW_spec = 2 pi * bf16(u)^T bf16(dproj)
  for (int c = threadIdx.x; c < 4 * m; c += kThreads) {
    const int d = c / m - 1, j = c % m;
    float s = 0.f;
    for (int i = 0; i < kTileRows; ++i) {
      const int row = row0 + i;
      const float v = dp[i * m + j];
      if (d < 0) {
        s += v;
      } else if (row < a.n_rows) {
        s += round_bf16(a.u[(size_t)row * 3 + d]) * round_bf16(v);
      }
    }
    part[off_dph + c] = d < 0 ? s : s * kTwoPi;
  }
}

// ---- 4. weight gradients: dW = X^T dY over all rows ---------------------------------

constexpr int kGT = 64;  // output tile edge and rows staged per step
constexpr int kGLd = kGT + kPad;

// P[chunk, p_off + i * dout + j] = sum over the chunk's rows of X[row, i] * dY[row, j]
// for i < din, j < dout. X has x_cols readable columns, dY has ldy; both
// are read in 8-element vectors, so both widths are multiples of 8.
__global__ void __launch_bounds__(kThreads)
    xt_dy_kernel(const bf16* __restrict__ X, int ldx, int x_cols, int din,
                 const bf16* __restrict__ Y, int ldy, int dout, int n_rows_pad,
                 int rows_per_chunk, float* __restrict__ P, long long p_ld, long long p_off) {
  __shared__ __align__(128) bf16 xs[kGT * kGLd];
  __shared__ __align__(128) bf16 ys[kGT * kGLd];
  __shared__ __align__(128) float sc[kWarps * 256];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int i0 = blockIdx.x * kGT, j0 = blockIdx.y * kGT;
  const int r_begin = blockIdx.z * rows_per_chunk;
  const int r_end = min(r_begin + rows_per_chunk, n_rows_pad);
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);
  for (int rb = r_begin; rb < r_end; rb += kGT) {
    for (int e = threadIdx.x; e < kGT * (kGT / 8); e += kThreads) {
      const int r = e / (kGT / 8), v = (e % (kGT / 8)) * 8;
      uint4 xv = make_uint4(0, 0, 0, 0), yv = make_uint4(0, 0, 0, 0);
      if (i0 + v + 8 <= x_cols)
        xv = *reinterpret_cast<const uint4*>(X + (size_t)(rb + r) * ldx + i0 + v);
      if (j0 + v + 8 <= ldy)
        yv = *reinterpret_cast<const uint4*>(Y + (size_t)(rb + r) * ldy + j0 + v);
      *reinterpret_cast<uint4*>(xs + r * kGLd + v) = xv;
      *reinterpret_cast<uint4*>(ys + r * kGLd + v) = yv;
    }
    __syncthreads();
    for (int kk = 0; kk < kGT; kk += 16) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int f = warp * 2 + q, fi = f / 4, fj = f % 4;
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> af;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
        wmma::load_matrix_sync(af, xs + kk * kGLd + fi * 16, kGLd);
        wmma::load_matrix_sync(bfr, ys + kk * kGLd + fj * 16, kGLd);
        wmma::mma_sync(acc[q], af, bfr, acc[q]);
      }
    }
    __syncthreads();
  }
  float* s = sc + warp * 256;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int f = warp * 2 + q, fi = f / 4, fj = f % 4;
    wmma::store_matrix_sync(s, acc[q], 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int gi = i0 + fi * 16 + e / 16, gj = j0 + fj * 16 + e % 16;
      if (gi < din && gj < dout)
        P[(long long)blockIdx.z * p_ld + p_off + (long long)gi * dout + gj] = s[e];
    }
    __syncwarp();
  }
}

// out[j] = sum_t P[t, j] for j < cols, t in order
__global__ void sum_rows_kernel(const float* __restrict__ P, int n, long long ld, int cols,
                                float* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= cols) return;
  float s = 0.f;
  for (int t = 0; t < n; ++t) s += P[(long long)t * ld + j];
  out[j] = s;
}

int set_smem(const void* kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

}  // namespace

// Shared memory (bytes) of the field kernels: which = 0 forward, 1 backward.
extern "C" size_t apnerf_fvr_smem(const FvrArgs* a, int which) {
  return which == 0 ? fwd_smem(*a).total : bwd_smem(*a).total;
}

extern "C" int apnerf_fvr_n_bias(const FvrArgs* a) { return n_bias(*a); }

// Each entry launches on `stream` and returns cudaGetLastError(); none allocates.
extern "C" int apnerf_fvr_field_fwd(const FvrArgs* a, void* stream) {
  const size_t smem = fwd_smem(*a).total;
  int err = set_smem((const void*)fvr_field_fwd_kernel, smem);
  if (err) return err;
  fvr_field_fwd_kernel<<<a->n_rows_pad / kTileRows, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(*a);
  return (int)cudaGetLastError();
}

extern "C" int apnerf_fvr_rays(const FvrArgs* a, void* stream) {
  const size_t smem = (size_t)kRayWarps * (2 * a->n_samples + 2 * kRayChan) * sizeof(float);
  int err = set_smem((const void*)fvr_ray_kernel, smem);
  if (err) return err;
  fvr_ray_kernel<<<(a->n_rays + kRayWarps - 1) / kRayWarps, kRayWarps * 32, smem,
                   static_cast<cudaStream_t>(stream)>>>(*a);
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

extern "C" int apnerf_fvr_field_bwd(const FvrArgs* a, void* stream) {
  const size_t smem = bwd_smem(*a).total;
  int err = set_smem((const void*)fvr_field_bwd_kernel, smem);
  if (err) return err;
  fvr_field_bwd_kernel<<<a->n_rows_pad / kTileRows, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(*a);
  return (int)cudaGetLastError();
}

extern "C" int apnerf_xt_dy(const void* X, int ldx, int x_cols, int din, const void* Y, int ldy,
                            int dout, int n_rows_pad, int rows_per_chunk, int n_chunks,
                            float* P, long long p_ld, long long p_off, void* stream) {
  const dim3 grid((din + kGT - 1) / kGT, (dout + kGT - 1) / kGT, n_chunks);
  xt_dy_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(X), ldx, x_cols, din, static_cast<const bf16*>(Y), ldy, dout,
      n_rows_pad, rows_per_chunk, P, p_ld, p_off);
  return (int)cudaGetLastError();
}

extern "C" int apnerf_sum_rows(const float* P, int n, long long ld, int cols, float* out,
                               void* stream) {
  sum_rows_kernel<<<(cols + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      P, n, ld, cols, out);
  return (int)cudaGetLastError();
}
