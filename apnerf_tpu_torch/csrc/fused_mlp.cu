// Spectral encode + ReLU trunk in one kernel, forward only.
//
// Replaces apnerf_tpu/ops/pallas/fused_mlp.py::fused_spectral_field
// (forward kernel _make_enc_fwd_kernel, launched by _call_enc_fwd):
//
//   proj = 2*pi * (bf16(u) . bf16(W)) + phase           f32, K = 3
//   enc  = [bf16(cos proj), bf16(sin proj)]              [T, 2M] bf16
//   h    = bf16(relu(h @ w_i + b_i))                     hidden layers
//   y    = h @ w_last + b_last                           f32 out
//
// What bounds it on an H100: tensor-core math. A row of the production
// trunk (256 -> 256 -> 256 -> 256 -> 16) costs ~4e5 FLOP against 12 B in
// and 64 B out, three orders of magnitude above the bf16 ridge point.
// The design keeps every intermediate on chip: one block owns a 64-row
// tile, computes the features straight into shared memory and ping-pongs
// the hidden activations between two shared buffers (2 x 64 x 264 bf16),
// so device memory sees only u and y. The matmuls are nvcuda::wmma
// bf16 16x16x16 fragments with f32 accumulators; each warp owns a strip
// of 16 output columns for all four 16-row sub-tiles, so every weight
// fragment it loads (from global memory, the trunk is 384 KB and stays
// in L2) feeds four MMAs. wgmma/TMA pipelines are later work.
//
// The encode, layer and constant definitions are shared with the
// train-step kernel through spectral_tile.cuh.

#include "spectral_tile.cuh"

namespace {

__global__ void __launch_bounds__(kThreads)
    spectral_field_fwd_kernel(const float* __restrict__ u, const float* __restrict__ W,
                              const float* __restrict__ phase, int n_rows, int m,
                              Trunk trunk, float* __restrict__ y) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int h = trunk.hidden;
  const int ld_a = max(2 * m, h) + kPad;
  const int ld_b = h + kPad;
  bf16* buf_a = reinterpret_cast<bf16*>(smem);
  bf16* buf_b = buf_a + kTileRows * ld_a;
  float* scratch = reinterpret_cast<float*>(buf_b + kTileRows * ld_b) + (threadIdx.x / 32) * 256;
  const int row0 = blockIdx.x * kTileRows;

  encode_tile(u, W, phase, n_rows, m, row0, buf_a, ld_a);
  __syncthreads();

  const bf16* src = buf_a;
  int ld_src = ld_a, k = 2 * m;
  bf16* dst = buf_b;
  int ld_dst = ld_b;
  for (int l = 0; l < trunk.n_layers - 1; ++l) {
    hidden_layer(src, ld_src, k, trunk.w[l], trunk.b[l], h, dst, ld_dst, scratch);
    __syncthreads();
    bf16* next = const_cast<bf16*>(src);
    const int ld_next = ld_src;
    src = dst;
    ld_src = ld_dst;
    dst = next;
    ld_dst = ld_next;
    k = h;
  }
  const int last = trunk.n_layers - 1;
  output_layer(src, ld_src, k, trunk.w[last], trunk.b[last], trunk.out_pad, trunk.out, y,
               row0, n_rows, scratch);
}

}  // namespace

extern "C" size_t apnerf_fused_spectral_field_smem(int m, int hidden) {
  const int ld_a = (2 * m > hidden ? 2 * m : hidden) + kPad;
  const int ld_b = hidden + kPad;
  return (size_t)kTileRows * (ld_a + ld_b) * sizeof(bf16) + kWarps * 256 * sizeof(float);
}

// Launches on `stream` and returns cudaGetLastError(); allocates nothing.
extern "C" int apnerf_fused_spectral_field_fwd(
    const float* u, const float* W, const float* phase, int n_rows, int m,
    const void* w0, const float* b0, const void* w1, const float* b1, const void* w2,
    const float* b2, const void* w3, const float* b3, int n_layers, int hidden,
    int out_pad, int out, float* y, void* stream) {
  Trunk t;
  t.w[0] = static_cast<const bf16*>(w0);
  t.w[1] = static_cast<const bf16*>(w1);
  t.w[2] = static_cast<const bf16*>(w2);
  t.w[3] = static_cast<const bf16*>(w3);
  t.b[0] = b0;
  t.b[1] = b1;
  t.b[2] = b2;
  t.b[3] = b3;
  t.n_layers = n_layers;
  t.hidden = hidden;
  t.out_pad = out_pad;
  t.out = out;
  const size_t smem = apnerf_fused_spectral_field_smem(m, hidden);
  cudaError_t err = cudaFuncSetAttribute(
      spectral_field_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (n_rows + kTileRows - 1) / kTileRows;
  spectral_field_fwd_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      u, W, phase, n_rows, m, t, y);
  return (int)cudaGetLastError();
}
