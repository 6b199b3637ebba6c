// Backward pieces on a 64-row tile of the kernels that go back through the
// spectral trunk (fused_mlp.cu): the
// counterpart of spectral_tile.cuh's forward layers. dX = dY W^T reads the
// native [in, out] weight transposed, as a col_major wmma operand, and
// the ReLU mask comes from the saved bf16 forward activation. The encode's
// backward closes the chain: dproj, the per-tile sums for dphase and
// dW_spec and, where asked for, the position gradient du.

#pragma once

#include "spectral_tile.cuh"
#include "warp_reduce.cuh"

namespace {

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

// The encode's backward on a tile, from the first hidden layer's
// pre-activation cotangent gh0 [64, h] (shared memory):
//   g_enc = gh0 @ w0^T;  dproj = cos * g_sin - sin * g_cos   -> dp [64, m] f32
//   part[0:m]   = sum over rows of dproj                      (dphase)
//   part[m:4m]  = 2 pi * bf16(u)^T bf16(dproj)                (dW_spec, [3, m])
//   du[row, :]  = 2 pi * bf16(dproj) . bf16(W)^T              where du is not null
// enc is the saved [Np, 2m] bf16 encoding; scratch is this warp's 512
// floats. A warp owns column strip ct of both halves of g_enc, so each
// dproj element is local. Every thread of the block calls it.
__device__ __forceinline__ void encode_backward_tile(
    const bf16* gh0, int ld_g, const bf16* w0, int h, int m, const bf16* enc,
    const float* __restrict__ u, const float* __restrict__ W, int n_rows, int row0, float* dp,
    float* scratch, float* part, float* du) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int ct = warp; ct < m / 16; ct += kWarps) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> ac[kRowTiles], as[kRowTiles];
#pragma unroll
    for (int r = 0; r < kRowTiles; ++r) {
      wmma::fill_fragment(ac[r], 0.f);
      wmma::fill_fragment(as[r], 0.f);
    }
    for (int kk = 0; kk < h; kk += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bc, bs;
      wmma::load_matrix_sync(bc, w0 + (size_t)(ct * 16) * h + kk, h);
      wmma::load_matrix_sync(bs, w0 + (size_t)(m + ct * 16) * h + kk, h);
#pragma unroll
      for (int r = 0; r < kRowTiles; ++r) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
        wmma::load_matrix_sync(af, gh0 + r * 16 * ld_g + kk, ld_g);
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
        const bf16* er = enc + (size_t)(row0 + i) * (2 * m);
        dp[i * m + j] = bf(er[j]) * scratch[256 + e] - bf(er[m + j]) * scratch[e];
      }
      __syncwarp();
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < 4 * m; c += kThreads) {
    const int d = c / m - 1, j = c % m;
    float s = 0.f;
    for (int i = 0; i < kTileRows; ++i) {
      const int row = row0 + i;
      const float v = dp[i * m + j];
      if (d < 0) {
        s += v;
      } else if (row < n_rows) {
        s += round_bf16(u[(size_t)row * 3 + d]) * round_bf16(v);
      }
    }
    part[c] = d < 0 ? s : s * kTwoPi;
  }
  if (du != nullptr) {
    for (int e = threadIdx.x; e < kTileRows * 3; e += kThreads) {
      const int i = e / 3, d = e % 3;
      const int row = row0 + i;
      if (row < n_rows) {
        float s = 0.f;
        for (int j = 0; j < m; ++j) s += round_bf16(dp[i * m + j]) * round_bf16(W[d * m + j]);
        du[(size_t)row * 3 + d] = s * kTwoPi;
      }
    }
  }
}

}  // namespace
