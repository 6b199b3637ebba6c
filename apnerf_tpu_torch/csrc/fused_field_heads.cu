// The whole main field per sample, packed: rgb, density and semantic
// logits of every sample in one launch.
//
// Replaces apnerf_tpu/ops/pallas/fused_field_heads.py::fused_field_heads
// (forward: kernel _make_field_fwd_kernel, launched by _call_field_fwd).
// Same math (field_tile.cuh), not the TPU's layout: the output is
// row-major y[N, 4 + C] f32 with columns 0:3 rgb (after the sigmoid),
// 3 sigma = exp(raw - 1) * in-cube and 4: the C logits, and the SH
// features arrive per ray [R, 16] (row r belongs to ray r / n_samples)
// instead of broadcast per sample.
//
// What bounds it on an H100: tensor-core math. A row costs ~0.45 MFLOP
// (the 3x256 trunk and both 64-wide heads) against 12 B read and 132 B
// written, ~3,300 FLOP/B, far above the card's ~295 FLOP/B balance. The
// design is field_tile.cuh's: persistent blocks of two wgmma consumer
// warpgroups and a producer warp that streams the weights' tile images
// through a shared-memory ring with cp.async.bulk; no activation is
// written back, and a tile's packed rows [64, 4 + C] are staged in shared
// memory and leave as one contiguous run of 16-byte stores. It reaches
// about a third of the bound (1.4 ms against 0.45 at 1,048,576 rows,
// PERF.md); field_tile.cuh says where the rest goes. The forward-only
// render kernel (fused_field_volrend.cu) runs this launch as its field
// pass.
//
// The backward (TPU counterpart: _make_field_bwd_kernel, launched by
// _call_field_bwd) is four launches from one wrapper: the field forward
// that saves its activations and the field backward of
// fused_field_volrend.cu, and between them ffh_bwd_pack_kernel below, which
// turns the packed cotangent g [N, 4 + C] into the cotangents of the
// field's per-sample values:
//   rgb head output (pre-sigmoid)   g_rgb * rgb * (1 - rgb)
//   raw density                     g_sigma * exp(min(raw - 1, 15)) * in-cube
//   semantic logits                 g_sem
// with the per-ray f32 sums that the last layers' bias gradients need.
// That pass is memory-bound: 4 (4 + C) + 16 + 4 C bytes read per sample.

#include "field_train_args.cuh"
#include "warp_reduce.cuh"

// Every pointer and size of one forward call; mirrors _FfhArgs in
// apnerf_tpu_torch/ops/cuda/fused_field_heads.py field by field.
struct FfhArgs {
  const float* u;   // [N, 3] unit-cube coordinates
  const float* sh;  // [R, 16] SH of the ray directions
  float* y;         // [N, 4 + C] packed output
  FieldWeights p;
  int n_rows, n_samples;
};

namespace {

// stages a tile's packed rows [64, 4 + C]; they are one contiguous run of y
struct PackedEpilogue {
  float* y;
  int ld;  // 4 + C
  __device__ void density(float* st, int i, float sigma, float) { st[i * ld + 3] = sigma; }
  __device__ void rgb(float* st, int i, int c, float v) { st[i * ld + c] = v; }
  __device__ void sem(float* st, int i, int c, float v) { st[i * ld + 4 + c] = v; }
  __device__ void flush(const float* st, int row0, int n_valid, int tid) {
    copy_out(y + (size_t)row0 * ld, st, n_valid * ld, tid);
  }
};

__global__ void __launch_bounds__(kFieldThreads, 1)
    ffh_fwd_kernel(const __grid_constant__ FfhArgs a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  field_forward(a.p, NoSave{}, a.u, a.sh, a.n_rows, a.n_samples, smem,
                PackedEpilogue{a.y, 4 + a.p.n_classes});
}

constexpr int kPackWarps = 8;  // rays per block of ffh_bwd_pack_kernel

// One warp per ray; reads a.g_packed and the forward's a.rgb, a.dsd, writes
// a.gout_rgb, a.gout_sem, a.graw and a.ray_part (the layout of the train
// step's ray kernel, so the field backward takes either).
__global__ void __launch_bounds__(kPackWarps * 32) ffh_bwd_pack_kernel(FvrArgs a) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ray = blockIdx.x * kPackWarps + warp;
  if (ray >= a.n_rays) return;  // uniform across the warp
  const int S = a.n_samples, C = a.n_classes, ld = 4 + C;
  const size_t base = (size_t)ray * S;
  float pr0 = 0.f, pr1 = 0.f, pr2 = 0.f;
  for (int i = lane; i < S; i += 32) {
    const size_t row = base + i;
    const float* g = a.g_packed + row * ld;
    const float* rg = a.rgb + row * 3;
    float gp[3];
    for (int c = 0; c < 3; ++c) gp[c] = g[c] * rg[c] * (1.f - rg[c]);
    pr0 += gp[0];
    pr1 += gp[1];
    pr2 += gp[2];
    a.graw[row] = g[3] * a.dsd[row];
    bf16* go = a.gout_rgb + row * kRgbPad;
    for (int c = 0; c < kRgbPad; ++c) go[c] = __float2bfloat16(c < 3 ? gp[c] : 0.f);
    bf16* gs = a.gout_sem + row * a.c_pad;
    for (int k = 0; k < a.c_pad; ++k) gs[k] = __float2bfloat16(k < C ? g[4 + k] : 0.f);
  }
  pr0 = warp_sum(pr0);
  pr1 = warp_sum(pr1);
  pr2 = warp_sum(pr2);
  float* part = a.ray_part + (size_t)ray * (kRgbPad + a.c_pad);
  for (int c = lane; c < kRgbPad + a.c_pad; c += 32) {
    float v = 0.f;
    if (c == 0) v = pr0;
    else if (c == 1) v = pr1;
    else if (c == 2) v = pr2;
    else if (c >= kRgbPad && c - kRgbPad < C) {
      for (int i = 0; i < S; ++i) v += a.g_packed[(base + i) * ld + 4 + (c - kRgbPad)];
    }
    part[c] = v;
  }
}

}  // namespace

// Launches `grid` persistent blocks on `stream` and returns
// cudaGetLastError(); allocates nothing.
extern "C" int apnerf_ffh_fwd(const FfhArgs* a, int grid, void* stream) {
  const size_t smem = fwd_smem(a->p.n_hidden).total;
  int err = set_smem((const void*)ffh_fwd_kernel, smem);
  if (err) return err;
  ffh_fwd_kernel<<<grid, kFieldThreads, smem, static_cast<cudaStream_t>(stream)>>>(*a);
  return (int)cudaGetLastError();
}

// The packed cotangent a->g_packed to the per-sample cotangents of the field
// backward; a->n_rays rays of a->n_samples rows.
extern "C" int apnerf_ffh_bwd_pack(const FvrArgs* a, void* stream) {
  ffh_bwd_pack_kernel<<<(a->n_rays + kPackWarps - 1) / kPackWarps, kPackWarps * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(*a);
  return (int)cudaGetLastError();
}
