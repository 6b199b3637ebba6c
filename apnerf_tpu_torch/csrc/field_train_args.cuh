// The argument struct of the main field's train-side kernels: the field
// forward that saves its activations, the per-ray and per-sample kernels
// that turn cotangents of the outputs into cotangents of the field's
// per-sample values, the field backward and the weight gradients
// (fused_field_volrend.cu, fused_field_heads.cu).

#pragma once

#include "field_tile.cuh"

// Every pointer and size of one call; mirrors _FvrArgs in
// apnerf_tpu_torch/ops/cuda/field_train.py field by field. At namespace
// scope, so the extern "C" entries that take it keep external linkage.
// "Images" are bf16 tile images (hopper_tile.cuh), so many per 64-row
// tile; Np is the row count padded to whole 128-row passes.
struct FvrArgs {
  static constexpr bool kSaves = true;  // field_forward stores the activations below
  // inputs
  const float* u;      // [N, 3] unit-cube coordinates
  const float* sh;     // [R, 16] SH of the ray directions
  const float* dt;     // [N] t1 - t0, zero on rays that miss the box
  const float* tm;     // [N] interval midpoints
  const float* pix;    // [R, 3]
  const float* dgt;    // [R]
  const int* lab;      // [R]
  const float* bk;     // [3]
  // the field (the members of FieldWeights)
  const float* W;      // [3, 128]
  const float* phase;  // [128]
  const __nv_bfloat16* wfwd;
  const __nv_bfloat16* wbwd;
  const float* bias;
  // saved activations
  __nv_bfloat16* enc;   // 4 images a tile: [cos | sin]
  __nv_bfloat16* h[3];  // 4 images a tile: trunk hidden activations
  __nv_bfloat16* xs;    // 1 image: the heads' input [SH | geo | 0]
  __nv_bfloat16* hid1;  // 2 images: first hidden layer of the rgb | the sem head
  __nv_bfloat16* hid2;  // 2 images: second hidden layer
  uint2* mask_t[3];     // [Np, 4] ReLU masks of h[l], in the accumulator's bit order
  uint2* mask_h;        // [Np, 4] x: rgb head, y: sem head; low 16 bits layer 1, high layer 2
  // per-sample values
  float* sigma;         // [N]
  float* dsd;           // [N] d sigma / d raw = exp(min(raw - 1, 15)) * in-cube
  float* rgb;           // [N, 3]
  float* sem;           // [N, C]
  float* graw;          // [N] loss cotangent of raw
  __nv_bfloat16* gout_rgb;  // [Np, 16] cotangent of the rgb-head output (pre-sigmoid)
  __nv_bfloat16* gout_sem;  // [Np, c_pad] cotangent of the semantic logits
  float* ray_part;      // [R, 16 + c_pad] per-ray f32 sums of those cotangents
  // cotangents as images, the dY operands of the weight gradients
  __nv_bfloat16* gout;   // 2 images: gout_rgb | gout_sem, zero-padded
  __nv_bfloat16* g2;     // 2 images: second hidden layer's pre-activation, rgb | sem
  __nv_bfloat16* g1;     // 2 images: first hidden layer's
  __nv_bfloat16* gt;     // 1 image: trunk output [graw | d geo | 0]
  __nv_bfloat16* gh[3];  // 4 images: trunk pre-activations
  float* tile_part;     // [Np / 64, n_bias] per-tile column sums (see bias layout)
  // outputs
  float* w;             // [N] weights
  float* lossrows;      // [3, R] per-ray huber rgb (summed over channels), huber depth, CE
  // cotangents given from outside (the backwards of the render kernels), and
  // the position gradient they return; each may be null
  const float* g_acc;     // [R, 5 + C] cotangent of the per-ray sums
  const float* g_w;       // [N] cotangent of the weights
  const float* g_packed;  // [N, 4 + C] cotangent of the packed field output
  float* du;              // [N, 3] gradient of u
  // sizes
  int n_rows, n_rays, n_samples;
  int n_hidden, geo, n_classes, c_pad;  // c_pad: classes padded to a multiple of 16
  float c_rgb, c_dep, c_sem;  // loss weight / mean norm of each term
};
