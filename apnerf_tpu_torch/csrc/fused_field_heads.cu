// The whole main field per sample, packed: rgb, density and semantic
// logits of every sample in one launch.
//
// Replaces apnerf_tpu/ops/pallas/fused_field_heads.py::fused_field_heads
// (forward: kernel _make_field_fwd_kernel, launched by _call_field_fwd).
// Same math (field_heads_tile.cuh), not the TPU's layout: the output is
// row-major y[N, 4 + C] f32 with columns 0:3 rgb (after the sigmoid),
// 3 sigma = exp(raw - 1) * in-cube and 4: the C logits, and the SH
// features arrive per ray [R, 16] (row r belongs to ray r / n_samples)
// instead of broadcast per sample.
//
// What bounds it on an H100: tensor-core math. A row costs ~0.45 MFLOP
// (the 3x256 trunk and both 64-wide heads) against 12 B read and 132 B
// written, ~3,300 FLOP/B, far above the card's ~295 FLOP/B balance. The
// design is the 64-row wmma tile of spectral_tile.cuh with the weights
// read from L2 and no activation written back: only the packed rows
// leave the block. wgmma, TMA and a staged, vectorised epilogue are
// later work. The forward-only render kernel (fused_field_volrend.cu)
// runs this launch as its field pass.

#include "field_heads_tile.cuh"

// Every pointer and size of one call; mirrors _FfhArgs in
// apnerf_tpu_torch/ops/cuda/fused_field_heads.py field by field.
struct FfhArgs {
  const float* u;   // [N, 3] unit-cube coordinates
  const float* sh;  // [R, 16] SH of the ray directions
  float* y;         // [N, 4 + C] packed output
  FieldParams p;
  int n_rows, n_rows_pad, n_samples;
};

namespace {

struct PackedEpilogue {
  float* y;
  int ld;  // 4 + C
  __device__ void density(int, int row, bool in, float raw) {
    y[(size_t)row * ld + 3] = in ? expf(raw - 1.f) : 0.f;
  }
  __device__ void rgb(int, int row, int c, float v) { y[(size_t)row * ld + c] = v; }
  __device__ void sem(int, int row, int c, float v) { y[(size_t)row * ld + 4 + c] = v; }
};

__global__ void __launch_bounds__(kThreads) ffh_fwd_kernel(FfhArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  PackedEpilogue epi{a.y, 4 + a.p.n_classes};
  field_forward_tile(a.p, NoSave{}, a.u, a.sh, a.n_rows, a.n_samples, blockIdx.x * kTileRows,
                     smem, epi);
}

}  // namespace

// Shared memory (bytes) one block of the kernel needs.
extern "C" size_t apnerf_ffh_smem(const FfhArgs* a) { return fwd_smem(a->p).total; }

// Launches on `stream` and returns cudaGetLastError(); allocates nothing.
extern "C" int apnerf_ffh_fwd(const FfhArgs* a, void* stream) {
  const size_t smem = fwd_smem(a->p).total;
  int err = (int)cudaFuncSetAttribute((const void*)ffh_fwd_kernel,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  ffh_fwd_kernel<<<a->n_rows_pad / kTileRows, kThreads, smem,
                   static_cast<cudaStream_t>(stream)>>>(*a);
  return (int)cudaGetLastError();
}
