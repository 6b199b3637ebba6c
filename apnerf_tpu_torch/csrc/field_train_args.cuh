// The argument struct of the main field's train-side kernels: the field
// forward that saves its activations, the per-ray and per-sample kernels
// that turn cotangents of the outputs into cotangents of the field's
// per-sample values, and the field backward (fused_field_volrend.cu,
// fused_field_heads.cu).

#pragma once

#include "field_heads_tile.cuh"

// Every pointer and size of one call; mirrors _FvrArgs in
// apnerf_tpu_torch/ops/cuda/field_train.py field by field. At namespace
// scope, so the extern "C" entries that take it keep external linkage.
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
  // cotangents given from outside (the backwards of the render kernels), and
  // the position gradient they return; each may be null
  const float* g_acc;     // [R, 5 + C] cotangent of the per-ray sums
  const float* g_w;       // [N] cotangent of the weights
  const float* g_packed;  // [N, 4 + C] cotangent of the packed field output
  float* du;              // [N, 3] gradient of u
  // sizes
  int n_rows, n_rows_pad, n_rays, n_samples;
  int m, hidden, n_layers, trunk_out_pad, geo;
  int head_hidden, n_classes, c_pad;
  float c_rgb, c_dep, c_sem;  // loss weight / mean norm of each term
};
