// The whole main field on a 64-row tile, shared by the kernels that
// evaluate it (fused_field_heads.cu, fused_field_volrend.cu): the
// spectral_tile.cuh block design (encode, trunk) extended through the
// density, the rgb head on [bf16 SH(dir) | bf16 geo] and the semantic head
// on geo. Same math as apnerf_tpu/ops/pallas/fused_field_heads.py::
// _make_field_fwd_kernel, rows as samples, the two heads kept as two:
//
//   proj = 2*pi * (bf16(u) . bf16(W)) + phase;  enc = bf16[cos, sin]
//   trunk: bf16(relu(. @ w + b)) hidden layers, f32 last layer
//   raw = out[0], geo = bf16(out[1:]);  sigma = exp(raw - 1) * in-cube
//   rgb = sigmoid(head_rgb([bf16 SH, geo]));  sem = head_sem(geo)
//
// What a kernel does with a tile's values is its epilogue: a struct with
//   density(i, row, in_cube, raw)   once per valid row, after the trunk
//   rgb(i, row, c, value)           c < 3, after the sigmoid
//   sem(i, row, c, value)           c < n_classes
// and what it keeps of the activations is its save struct: one with
// kSaves = true and the buffers below, or NoSave for a kernel that has no
// backward. Both the parameters and the save struct are template types,
// so a kernel passes its own argument struct (read from the constant bank
// where it lies) and nothing is copied into local memory:
//   parameters  W, phase, tw[4], tb[4], rw[3], rb[3], sw[3], sb[3],
//               m, hidden, n_layers, trunk_out_pad, geo, head_hidden,
//               n_classes, c_pad (the members of FieldParams)
//   save        enc [Np, 2M], h[3] [Np, H], xr [Np, 32] (its columns 16..
//               are the sem-head input), hr1, hr2, hs1, hs2 [Np, hh],
//               bf16, rows padded to a multiple of 64

#pragma once

#include "spectral_tile.cuh"

// Weights and widths of the main field, as the kernels read them: bf16
// weights [in, out] zero-padded to the widths below, f32 biases. At
// namespace scope: extern "C" entries take structs that hold it.
struct FieldParams {
  const float* W;      // [3, M]
  const float* phase;  // [M]
  const bf16* tw[4];   // trunk weights; the last one [H, trunk_out_pad]
  const float* tb[4];  // trunk biases; the last one [trunk_out_pad]
  const bf16* rw[3];   // rgb head [32, hh], [hh, hh], [hh, 16]
  const float* rb[3];  // [hh], [hh], [16]
  const bf16* sw[3];   // sem head [16, hh], [hh, hh], [hh, c_pad]
  const float* sb[3];  // [hh], [hh], [c_pad]
  int m, hidden, n_layers, trunk_out_pad, geo;
  int head_hidden, n_classes, c_pad;
};

// The save struct of a kernel that keeps no activation.
struct NoSave {
  static constexpr bool kSaves = false;
};

namespace {

constexpr int kShw = 16;     // SH features of a ray direction
constexpr int kXr = 32;      // rgb-head input: SH (16) | geo (<= 16, zero-padded)
constexpr int kRgbPad = 16;  // rgb-head output width, padded

__device__ __forceinline__ float bf(const bf16 x) { return __bfloat162float(x); }

// g[row0 + i, :cols] = s[i, :cols] for the 64 rows of a tile (cols % 8 == 0)
__device__ void store_tile(const bf16* s, int ld_s, int cols, bf16* g, int row0) {
  const int vpr = cols / 8;
  for (int e = threadIdx.x; e < kTileRows * vpr; e += kThreads) {
    const int i = e / vpr, v = e % vpr;
    *reinterpret_cast<uint4*>(g + (size_t)(row0 + i) * cols + v * 8) =
        *reinterpret_cast<const uint4*>(s + i * ld_s + v * 8);
  }
}

struct FwdSmem {
  int ld_a, ld_b, ld_x, ld_h, out_w;
  size_t a, b, outf, scratch, x, r1, r2, s1, s2, total;
};

template <class P>
__host__ __device__ inline FwdSmem fwd_smem(const P& p) {
  FwdSmem s;
  s.ld_a = (2 * p.m > p.hidden ? 2 * p.m : p.hidden) + kPad;
  s.ld_b = p.hidden + kPad;
  s.ld_x = kXr + kPad;
  s.ld_h = p.head_hidden + kPad;
  s.out_w = p.c_pad > p.trunk_out_pad ? p.c_pad : p.trunk_out_pad;
  if (s.out_w < kRgbPad) s.out_w = kRgbPad;
  size_t o = 0;
  s.a = o; o += (size_t)kTileRows * s.ld_a * sizeof(bf16);
  s.b = o; o += (size_t)kTileRows * s.ld_b * sizeof(bf16);
  s.x = o; o += (size_t)kTileRows * s.ld_x * sizeof(bf16);
  s.r1 = o; o += (size_t)kTileRows * s.ld_h * sizeof(bf16);
  s.r2 = o; o += (size_t)kTileRows * s.ld_h * sizeof(bf16);
  s.s1 = o; o += (size_t)kTileRows * s.ld_h * sizeof(bf16);
  s.s2 = o; o += (size_t)kTileRows * s.ld_h * sizeof(bf16);
  s.outf = o; o += (size_t)kTileRows * s.out_w * sizeof(float);
  s.scratch = o; o += (size_t)kWarps * 256 * sizeof(float);
  s.total = o;
  return s;
}

// The field on rows row0 .. row0 + 63 of u [n_rows, 3]; row r belongs to
// ray r / n_samples, whose SH features are sh[ray, :16]. smem holds
// fwd_smem(p).total bytes. Every thread of the block calls it.
template <class P, class S, class Epilogue>
__device__ __forceinline__ void field_forward_tile(
    const P& a, const S& sv, const float* __restrict__ u, const float* __restrict__ sh,
    int n_rows, int n_samples, int row0, unsigned char* smem, Epilogue& epi) {
  const FwdSmem L = fwd_smem(a);
  const int m = a.m, h = a.hidden, hh = a.head_hidden, C = a.n_classes;
  bf16* buf_a = reinterpret_cast<bf16*>(smem + L.a);
  bf16* buf_b = reinterpret_cast<bf16*>(smem + L.b);
  bf16* xs = reinterpret_cast<bf16*>(smem + L.x);
  bf16* r1 = reinterpret_cast<bf16*>(smem + L.r1);
  bf16* r2 = reinterpret_cast<bf16*>(smem + L.r2);
  bf16* s1 = reinterpret_cast<bf16*>(smem + L.s1);
  bf16* s2 = reinterpret_cast<bf16*>(smem + L.s2);
  float* outf = reinterpret_cast<float*>(smem + L.outf);
  float* scratch = reinterpret_cast<float*>(smem + L.scratch) + (threadIdx.x / 32) * 256;

  encode_tile(u, a.W, a.phase, n_rows, m, row0, buf_a, L.ld_a);
  __syncthreads();
  if constexpr (S::kSaves) store_tile(buf_a, L.ld_a, 2 * m, sv.enc, row0);

  // trunk: hidden layers ping-pong between buf_a and buf_b
  const bf16* src = buf_a;
  int ld_src = L.ld_a, k = 2 * m;
  bf16* dst = buf_b;
  int ld_dst = L.ld_b;
  for (int l = 0; l < a.n_layers - 1; ++l) {
    hidden_layer(src, ld_src, k, a.tw[l], a.tb[l], h, dst, ld_dst, scratch);
    __syncthreads();
    if constexpr (S::kSaves) store_tile(dst, ld_dst, h, sv.h[l], row0);
    bf16* next = const_cast<bf16*>(src);
    const int ld_next = ld_src;
    src = dst;
    ld_src = ld_dst;
    dst = next;
    ld_dst = ld_next;
    k = h;
  }
  const int last = a.n_layers - 1;
  output_layer(src, ld_src, k, a.tw[last], a.tb[last], a.trunk_out_pad, a.trunk_out_pad,
               outf, 0, kTileRows, scratch);
  __syncthreads();

  // density, and the heads' input [bf16 SH | bf16 geo | 0]
  for (int i = threadIdx.x; i < kTileRows; i += kThreads) {
    const int row = row0 + i;
    if (row < n_rows) {
      const float* ur = u + (size_t)row * 3;
      const bool in = ur[0] > 0.f && ur[0] < 1.f && ur[1] > 0.f && ur[1] < 1.f &&
                      ur[2] > 0.f && ur[2] < 1.f;
      epi.density(i, row, in, outf[i * a.trunk_out_pad]);
    }
  }
  for (int e = threadIdx.x; e < kTileRows * kXr; e += kThreads) {
    const int i = e / kXr, j = e % kXr;
    const int row = row0 + i;
    float v = 0.f;
    if (j < kShw) {
      if (row < n_rows) v = sh[(size_t)(row / n_samples) * kShw + j];
    } else if (j - kShw < a.geo) {
      v = outf[i * a.trunk_out_pad + 1 + (j - kShw)];
    }
    xs[i * L.ld_x + j] = __float2bfloat16(v);
  }
  __syncthreads();
  if constexpr (S::kSaves) store_tile(xs, L.ld_x, kXr, sv.xr, row0);

  // rgb head on [SH | geo], sem head on geo (the columns from 16 on)
  hidden_layer(xs, L.ld_x, kXr, a.rw[0], a.rb[0], hh, r1, L.ld_h, scratch);
  hidden_layer(xs + kShw, L.ld_x, kXr - kShw, a.sw[0], a.sb[0], hh, s1, L.ld_h, scratch);
  __syncthreads();
  hidden_layer(r1, L.ld_h, hh, a.rw[1], a.rb[1], hh, r2, L.ld_h, scratch);
  hidden_layer(s1, L.ld_h, hh, a.sw[1], a.sb[1], hh, s2, L.ld_h, scratch);
  __syncthreads();
  if constexpr (S::kSaves) {
    store_tile(r1, L.ld_h, hh, sv.hr1, row0);
    store_tile(r2, L.ld_h, hh, sv.hr2, row0);
    store_tile(s1, L.ld_h, hh, sv.hs1, row0);
    store_tile(s2, L.ld_h, hh, sv.hs2, row0);
  }
  output_layer(r2, L.ld_h, hh, a.rw[2], a.rb[2], kRgbPad, kRgbPad, outf, 0, kTileRows, scratch);
  __syncthreads();
  for (int e = threadIdx.x; e < kTileRows * 3; e += kThreads) {
    const int i = e / 3, c = e % 3;
    const int row = row0 + i;
    if (row < n_rows) epi.rgb(i, row, c, 1.f / (1.f + expf(-outf[i * kRgbPad + c])));
  }
  __syncthreads();
  output_layer(s2, L.ld_h, hh, a.sw[2], a.sb[2], a.c_pad, a.c_pad, outf, 0, kTileRows, scratch);
  __syncthreads();
  for (int e = threadIdx.x; e < kTileRows * C; e += kThreads) {
    const int i = e / C, c = e % C;
    const int row = row0 + i;
    if (row < n_rows) epi.sem(i, row, c, outf[i * a.c_pad + c]);
  }
}

}  // namespace
