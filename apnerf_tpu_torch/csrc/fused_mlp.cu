// Spectral encode + ReLU trunk in one kernel, and the plain ReLU MLP in one
// kernel: the forwards of the trunk kernels.
//
// Replaces the forwards of apnerf_tpu/ops/pallas/fused_mlp.py::
// fused_spectral_field (kernel _make_enc_fwd_kernel, launched by
// _call_enc_fwd) and ::fused_mlp_apply (_make_fwd_kernel, _call_fwd):
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
// in L2) feeds four MMAs. It takes any width that is a multiple of 16.
// The backwards of both kernels run on the field's wgmma tile
// (field_tile.cuh, fused_field_volrend.cu with heads = 0), at the widths
// that tile takes; these forwards are to move onto its no-save instance.
//
// The encode, layer and constant definitions are in spectral_tile.cuh.
//
// fused_mlp_apply is the same tile without the encode: x [N, Din] arrives
// in bf16 or f32 and is rounded to bf16 on its way into shared memory (no
// f32 copy of a bf16 x is made anywhere).

#include "spectral_tile.cuh"

// Every pointer and size of one call of the kernel below; mirrors _MlpArgs
// in apnerf_tpu_torch/ops/cuda/fused_mlp.py field by field.
struct MlpArgs {
  // inputs: u, W, phase with the encode; x without it
  const float* u;      // [N, 3]
  const float* W;      // [3, M]
  const float* phase;  // [M]
  const void* x;       // [N, din] bf16 or f32
  const bf16* w[4];    // [in, out] bf16; the last one [H, out_pad]
  const float* b[4];   // f32; the last one [out_pad]
  float* y;            // [N, out]
  int n_rows, n_rows_pad, m, din, hidden, n_layers, out_pad, out;
  int x_f32;           // x is f32 (else bf16)
};

namespace {

__host__ __device__ inline size_t mlp_fwd_smem(const MlpArgs& a) {
  const int ld_a = (a.din > a.hidden ? a.din : a.hidden) + kPad;
  const int ld_b = a.hidden + kPad;
  return (size_t)kTileRows * (ld_a + ld_b) * sizeof(bf16) + kWarps * 256 * sizeof(float);
}

// dst[64, din] = bf16(x[row0.., :]), zero past n_rows
__device__ void load_x_tile(const MlpArgs& a, int row0, bf16* dst, int ld_dst) {
  const int din = a.din;
  for (int e = threadIdx.x; e < kTileRows * din; e += kThreads) {
    const int i = e / din, j = e % din;
    const size_t at = (size_t)(row0 + i) * din + j;
    bf16 v = __float2bfloat16(0.f);
    if (row0 + i < a.n_rows)
      v = a.x_f32 ? __float2bfloat16(static_cast<const float*>(a.x)[at])
                  : static_cast<const bf16*>(a.x)[at];
    dst[i * ld_dst + j] = v;
  }
}

// The forward on a tile: encode or load, hidden layers, output layer.
template <bool kEncode>
__global__ void __launch_bounds__(kThreads) mlp_fwd_kernel(MlpArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int h = a.hidden;
  const int ld_a = max(a.din, h) + kPad;
  const int ld_b = h + kPad;
  bf16* buf_a = reinterpret_cast<bf16*>(smem);
  bf16* buf_b = buf_a + kTileRows * ld_a;
  float* scratch = reinterpret_cast<float*>(buf_b + kTileRows * ld_b) + (threadIdx.x / 32) * 256;
  const int row0 = blockIdx.x * kTileRows;

  if constexpr (kEncode) {
    encode_tile(a.u, a.W, a.phase, a.n_rows, a.m, row0, buf_a, ld_a);
  } else {
    load_x_tile(a, row0, buf_a, ld_a);
  }
  __syncthreads();

  const bf16* src = buf_a;
  int ld_src = ld_a, k = a.din;
  bf16* dst = buf_b;
  int ld_dst = ld_b;
  for (int l = 0; l < a.n_layers - 1; ++l) {
    hidden_layer(src, ld_src, k, a.w[l], a.b[l], h, dst, ld_dst, scratch);
    __syncthreads();
    bf16* next = const_cast<bf16*>(src);
    const int ld_next = ld_src;
    src = dst;
    ld_src = ld_dst;
    dst = next;
    ld_dst = ld_next;
    k = h;
  }
  const int last = a.n_layers - 1;
  output_layer(src, ld_src, k, a.w[last], a.b[last], a.out_pad, a.out, a.y, row0, a.n_rows,
               scratch);
}

}  // namespace

// Shared memory (bytes) of the kernel for the call *a.
extern "C" size_t apnerf_mlp_smem(const MlpArgs* a) { return mlp_fwd_smem(*a); }

// The forward: encode = 1 from u, else from x. Launches on `stream` and
// returns cudaGetLastError(); allocates nothing.
extern "C" int apnerf_mlp_fwd(const MlpArgs* a, int encode, void* stream) {
  const size_t smem = mlp_fwd_smem(*a);
  const void* kernel =
      encode ? (const void*)mlp_fwd_kernel<true> : (const void*)mlp_fwd_kernel<false>;
  int err = set_smem(kernel, smem);
  if (err) return err;
  const int grid = a->n_rows_pad / kTileRows;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (encode) mlp_fwd_kernel<true><<<grid, kThreads, smem, st>>>(*a);
  else mlp_fwd_kernel<false><<<grid, kThreads, smem, st>>>(*a);
  return (int)cudaGetLastError();
}
