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
// The phase is formed exactly as the TPU kernel forms it: u and W rounded
// to bf16, their K=3 product summed in f32 (bf16 x bf16 products are
// exact in f32), then scaled and shifted with separate roundings. proj
// reaches ~4.5e4 rad at the production frequencies, so the precise
// sincosf is required: --use_fast_math and __sinf/__cosf are wrong there.
// Biases are added in f32 before the bf16 rounding, as Pallas does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int kTileRows = 64;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowTiles = kTileRows / 16;
constexpr int kPad = 8;  // bf16 elements of row padding against bank conflicts
constexpr float kTwoPi = 6.283185307179586f;

struct Trunk {
  const bf16* w[4];
  const float* b[4];
  int n_layers;  // weight matrices: 3 or 4
  int hidden;    // H, a multiple of 16
  int out_pad;   // output width rounded up to 16
  int out;       // output width
};

// dst[64, n_out] = bf16(relu(src[64, k] @ w[k, n_out] + b))
__device__ void hidden_layer(const bf16* src, int ld_src, int k, const bf16* w,
                             const float* b, int n_out, bf16* dst, int ld_dst,
                             float* scratch) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int ct = warp; ct < n_out / 16; ct += kWarps) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kRowTiles];
#pragma unroll
    for (int r = 0; r < kRowTiles; ++r) wmma::fill_fragment(acc[r], 0.f);
    for (int kk = 0; kk < k; kk += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfrag;
      wmma::load_matrix_sync(bfrag, w + (size_t)kk * n_out + ct * 16, n_out);
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
        const int i = e / 16, j = e % 16;
        const float v = fmaxf(scratch[e] + b[ct * 16 + j], 0.f);
        dst[(r * 16 + i) * ld_dst + ct * 16 + j] = __float2bfloat16(v);
      }
      __syncwarp();
    }
  }
}

// y[row0 + i, :out] = src[64, k] @ w[k, out_pad] + b   (f32, ragged rows masked)
__device__ void output_layer(const bf16* src, int ld_src, int k, const bf16* w,
                             const float* b, int out_pad, int out, float* y,
                             int row0, int n_rows, float* scratch) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_tiles = kRowTiles * (out_pad / 16);
  for (int t = warp; t < n_tiles; t += kWarps) {
    const int r = t % kRowTiles, ct = t / kRowTiles;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
    for (int kk = 0; kk < k; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> afrag;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfrag;
      wmma::load_matrix_sync(afrag, src + r * 16 * ld_src + kk, ld_src);
      wmma::load_matrix_sync(bfrag, w + (size_t)kk * out_pad + ct * 16, out_pad);
      wmma::mma_sync(acc, afrag, bfrag, acc);
    }
    wmma::store_matrix_sync(scratch, acc, 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int i = e / 16, j = e % 16;
      const int row = row0 + r * 16 + i, col = ct * 16 + j;
      if (row < n_rows && col < out) y[(size_t)row * out + col] = scratch[e] + b[col];
    }
    __syncwarp();
  }
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

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

  for (int e = threadIdx.x; e < kTileRows * m; e += kThreads) {
    const int i = e / m, j = e % m;
    const int row = row0 + i;
    float dot = 0.f;
    if (row < n_rows) {
      const float ux = round_bf16(u[(size_t)row * 3 + 0]);
      const float uy = round_bf16(u[(size_t)row * 3 + 1]);
      const float uz = round_bf16(u[(size_t)row * 3 + 2]);
      dot = ux * round_bf16(W[j]) + uy * round_bf16(W[m + j]) + uz * round_bf16(W[2 * m + j]);
    }
    const float proj = __fadd_rn(__fmul_rn(dot, kTwoPi), phase[j]);
    float s, c;
    sincosf(proj, &s, &c);
    buf_a[i * ld_a + j] = __float2bfloat16(c);
    buf_a[i * ld_a + m + j] = __float2bfloat16(s);
  }
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
