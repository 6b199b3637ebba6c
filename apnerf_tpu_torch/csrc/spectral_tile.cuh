// Device code of the spectral-field and MLP kernels (fused_mlp.cu): one
// block of 8 warps owns a 64-row tile, the
// layer is an nvcuda::wmma bf16 16x16x16 product with f32 accumulators in
// which a warp owns a strip of 16 output columns for all four 16-row
// sub-tiles, so every weight fragment it loads (from global memory; the
// weights stay in L2) feeds four MMAs.
//
// The phase is formed exactly as the TPU kernels form it: u and W rounded
// to bf16, their K=3 product summed in f32 (bf16 x bf16 products are
// exact in f32), then scaled and shifted with separate roundings. proj
// reaches ~4.5e4 rad at the production frequencies, so the precise
// sincosf is required: --use_fast_math and __sinf/__cosf are wrong there.
// Biases are added in f32 before the bf16 rounding, as Pallas does.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int kTileRows = 64;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowTiles = kTileRows / 16;
constexpr int kPad = 8;  // bf16 elements of row padding against bank conflicts
constexpr float kTwoPi = 6.283185307179586f;

// allow `kernel` that much dynamic shared memory -> the CUDA error code
inline int set_smem(const void* kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

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

// dst[64, 2m] = [bf16(cos proj), bf16(sin proj)] for rows row0.. of u
// (rows past n_rows see u = 0)
__device__ void encode_tile(const float* __restrict__ u, const float* __restrict__ W,
                            const float* __restrict__ phase, int n_rows, int m, int row0,
                            bf16* dst, int ld_dst) {
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
    dst[i * ld_dst + j] = __float2bfloat16(c);
    dst[i * ld_dst + m + j] = __float2bfloat16(s);
  }
}

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

}  // namespace
