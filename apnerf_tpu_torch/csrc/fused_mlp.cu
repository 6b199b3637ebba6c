// Spectral encode + ReLU trunk in one kernel, the plain ReLU MLP in one
// kernel, and the backward of both.
//
// Replaces apnerf_tpu/ops/pallas/fused_mlp.py::fused_spectral_field
// (forward kernel _make_enc_fwd_kernel, launched by _call_enc_fwd; backward
// _make_enc_bwd_kernel, _call_enc_bwd) and ::fused_mlp_apply (_make_fwd_kernel,
// _call_fwd; _make_bwd_kernel, _call_bwd). The forward of the first:
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
// in L2) feeds four MMAs. The main field's kernels run on a wgmma tile
// with the weights staged in shared memory (field_tile.cuh); this tile
// also serves the proposal field's 64-wide trunk, which that one does not.
//
// The encode, layer and constant definitions are in spectral_tile.cuh.
//
// fused_mlp_apply is the same tile without the encode: x [N, Din] arrives
// in bf16 or f32 and is rounded to bf16 on its way into shared memory (no
// f32 copy of a bf16 x is made anywhere).
//
// The backwards recompute, as the TPU kernels do. Blocks run in no order on
// this card, so nothing is accumulated across tiles inside a kernel:
//   1. mlp_fwd_kernel<., true>: the forward again, saving the bf16 input
//      (the encoding, or x) and the hidden activations;
//   2. mlp_bwd_kernel: per tile, g rounded to bf16, dX = dY W^T through the
//      ReLU masks down the trunk (mlp_bwd_tile.cuh), each layer's
//      pre-activation cotangent stored in bf16, per-tile f32 column sums
//      for the biases; then the encode's backward (dproj, the dphase and
//      dW_spec sums, du), or dx = gh0 w0^T in x's dtype;
//   3. xt_dy_kernel and sum_rows_kernel (below): dW = X^T
//      dY as per-chunk f32 partials added in a fixed order, so the
//      gradients repeat from run to run.
// Bounded by tensor-core math like the forward (the backward is the
// recompute plus two products per layer); the saved activations cost
// 2 (Din + n_hidden H) bytes per row each way on top.

#include "mlp_bwd_tile.cuh"

// Every pointer and size of one call of the kernels below; mirrors _MlpArgs
// in apnerf_tpu_torch/ops/cuda/fused_mlp.py field by field.
struct MlpArgs {
  // inputs: u, W, phase with the encode; x without it
  const float* u;      // [N, 3]
  const float* W;      // [3, M]
  const float* phase;  // [M]
  const void* x;       // [N, din] bf16 or f32
  const bf16* w[4];    // [in, out] bf16; the last one [H, out_pad]
  const float* b[4];   // f32; the last one [out_pad]
  const float* g;      // [N, out] cotangent of y
  // saved by the forward, rows padded to n_rows_pad (a multiple of 64)
  bf16* xs;            // [Np, din] the bf16 input: the encoding, or x
  bf16* h[3];          // [Np, H]
  // written by the backward
  bf16* gout;          // [Np, out_pad] bf16(g)
  bf16* gh[3];         // [Np, H] cotangents of the pre-activations
  float* tile_part;    // [Np / 64, n_bias] per-block column sums
  // outputs; each may be null
  float* y;            // [N, out]
  float* du;           // [N, 3]
  void* dx;            // [N, din] in x's dtype
  int n_rows, n_rows_pad, m, din, hidden, n_layers, out_pad, out;
  int x_f32;           // x and dx are f32 (else bf16)
};

namespace {

// bias layout of a tile_part row: hidden pre-activation sums (n_hidden x H),
// the output (out_pad), then with the encode dphase (M) and dW_spec (3 x M)
__host__ __device__ inline int mlp_n_bias(const MlpArgs& a, bool encode) {
  return (a.n_layers - 1) * a.hidden + a.out_pad + (encode ? 4 * a.m : 0);
}

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

// The forward on a tile: encode or load, hidden layers, output layer where
// a.y is given; with kSave the bf16 input and hidden activations go to
// a.xs and a.h.
template <bool kEncode, bool kSave>
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
  if constexpr (kSave) store_tile(buf_a, ld_a, a.din, a.xs, row0);

  const bf16* src = buf_a;
  int ld_src = ld_a, k = a.din;
  bf16* dst = buf_b;
  int ld_dst = ld_b;
  for (int l = 0; l < a.n_layers - 1; ++l) {
    hidden_layer(src, ld_src, k, a.w[l], a.b[l], h, dst, ld_dst, scratch);
    __syncthreads();
    if constexpr (kSave) store_tile(dst, ld_dst, h, a.h[l], row0);
    bf16* next = const_cast<bf16*>(src);
    const int ld_next = ld_src;
    src = dst;
    ld_src = ld_dst;
    dst = next;
    ld_dst = ld_next;
    k = h;
  }
  const int last = a.n_layers - 1;
  if (a.y != nullptr)
    output_layer(src, ld_src, k, a.w[last], a.b[last], a.out_pad, a.out, a.y, row0, a.n_rows,
                 scratch);
}

struct MlpBwdSmem {
  int ld_gt, ld_b;
  size_t gt, b1, b2, dp, scratch, total;
};

__host__ __device__ inline MlpBwdSmem mlp_bwd_smem(const MlpArgs& a, bool encode) {
  MlpBwdSmem s;
  s.ld_gt = a.out_pad + kPad;
  s.ld_b = a.hidden + kPad;
  size_t o = 0;
  s.gt = o; o += (size_t)kTileRows * s.ld_gt * sizeof(bf16);
  s.b1 = o; o += (size_t)kTileRows * s.ld_b * sizeof(bf16);
  s.b2 = o; o += (size_t)kTileRows * s.ld_b * sizeof(bf16);
  s.dp = o; o += encode ? (size_t)kTileRows * a.m * sizeof(float) : 0;
  s.scratch = o; o += (size_t)kWarps * 512 * sizeof(float);
  s.total = o;
  return s;
}

// dx[row0 + i, :n_out] = src[64, k] @ w^T (w native [n_out, ldw]), written
// in f32 or bf16, rows past n_rows left alone
__device__ void bwd_dx(const bf16* src, int ld_src, int k, const bf16* w, int ldw, int n_out,
                       void* dx, int dx_f32, int row0, int n_rows, float* scratch) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
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
    wmma::store_matrix_sync(scratch, acc, 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int row = row0 + r * 16 + e / 16, col = ct * 16 + e % 16;
      if (row < n_rows) {
        const size_t at = (size_t)row * n_out + col;
        if (dx_f32) static_cast<float*>(dx)[at] = scratch[e];
        else static_cast<bf16*>(dx)[at] = __float2bfloat16(scratch[e]);
      }
    }
    __syncwarp();
  }
}

// The backward on a tile, from g and the activations mlp_fwd_kernel saved.
template <bool kEncode>
__global__ void __launch_bounds__(kThreads) mlp_bwd_kernel(MlpArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const MlpBwdSmem L = mlp_bwd_smem(a, kEncode);
  const int h = a.hidden, nh = a.n_layers - 1;
  bf16* gt = reinterpret_cast<bf16*>(smem + L.gt);
  bf16* b1 = reinterpret_cast<bf16*>(smem + L.b1);
  bf16* b2 = reinterpret_cast<bf16*>(smem + L.b2);
  float* scratch = reinterpret_cast<float*>(smem + L.scratch) + (threadIdx.x / 32) * 512;
  const int row0 = blockIdx.x * kTileRows;
  float* part = a.tile_part + (size_t)blockIdx.x * mlp_n_bias(a, kEncode);

  // output cotangent, rounded to bf16 as the TPU kernels round it; pad rows
  // and columns are zero. Its column sums are the last bias's gradient.
  for (int e = threadIdx.x; e < kTileRows * a.out_pad; e += kThreads) {
    const int i = e / a.out_pad, j = e % a.out_pad;
    const int row = row0 + i;
    float v = 0.f;
    if (row < a.n_rows && j < a.out) v = a.g[(size_t)row * a.out + j];
    gt[i * L.ld_gt + j] = __float2bfloat16(v);
  }
  __syncthreads();
  store_tile(gt, L.ld_gt, a.out_pad, a.gout, row0);
  column_sums(gt, L.ld_gt, a.out_pad, part + nh * h);

  // gh[l] = bf16((gh[l+1] @ w[l+1]^T) * (h[l] > 0)), from the top
  bwd_layer(gt, L.ld_gt, a.out_pad, a.w[nh], a.out_pad, h, a.h[nh - 1], h, row0, b1, L.ld_b,
            scratch);
  __syncthreads();
  store_tile(b1, L.ld_b, h, a.gh[nh - 1], row0);
  column_sums(b1, L.ld_b, h, part + (nh - 1) * h);
  bf16* cur = b1;
  bf16* nxt = b2;
  for (int l = nh - 1; l >= 1; --l) {
    bwd_layer(cur, L.ld_b, h, a.w[l], h, h, a.h[l - 1], h, row0, nxt, L.ld_b, scratch);
    __syncthreads();
    store_tile(nxt, L.ld_b, h, a.gh[l - 1], row0);
    column_sums(nxt, L.ld_b, h, part + (l - 1) * h);
    bf16* t = cur;
    cur = nxt;
    nxt = t;
  }

  if constexpr (kEncode) {
    float* dp = reinterpret_cast<float*>(smem + L.dp);
    encode_backward_tile(cur, L.ld_b, a.w[0], h, a.m, a.xs, a.u, a.W, a.n_rows, row0, dp,
                         scratch, part + nh * h + a.out_pad, a.du);
  } else {
    if (a.dx != nullptr)
      bwd_dx(cur, L.ld_b, h, a.w[0], h, a.din, a.dx, a.x_f32, row0, a.n_rows, scratch);
  }
}

// ---- weight gradients of the trunk kernels: dW = X^T dY over all rows ----------------

constexpr int kGT = 64;  // output tile edge and rows staged per step
constexpr int kGLd = kGT + kPad;

// P[chunk, p_off + i * dout + j] = sum over the chunk's rows of X[row, i] * dY[row, j]
// for i < din, j < dout. X has x_cols readable columns, dY has ldy; both
// are read in 8-element vectors, so both widths are multiples of 8.
__global__ void __launch_bounds__(kThreads)
    xt_dy_kernel(const bf16* __restrict__ X, int ldx, int x_cols, int din,
                 const bf16* __restrict__ Y, int ldy, int dout, int n_rows_pad,
                 int rows_per_chunk, float* __restrict__ P, long long p_ld, long long p_off) {
  __shared__ __align__(128) bf16 xs[kGT * kGLd];
  __shared__ __align__(128) bf16 ys[kGT * kGLd];
  __shared__ __align__(128) float sc[kWarps * 256];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int i0 = blockIdx.x * kGT, j0 = blockIdx.y * kGT;
  const int r_begin = blockIdx.z * rows_per_chunk;
  const int r_end = min(r_begin + rows_per_chunk, n_rows_pad);
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);
  for (int rb = r_begin; rb < r_end; rb += kGT) {
    for (int e = threadIdx.x; e < kGT * (kGT / 8); e += kThreads) {
      const int r = e / (kGT / 8), v = (e % (kGT / 8)) * 8;
      uint4 xv = make_uint4(0, 0, 0, 0), yv = make_uint4(0, 0, 0, 0);
      if (i0 + v + 8 <= x_cols)
        xv = *reinterpret_cast<const uint4*>(X + (size_t)(rb + r) * ldx + i0 + v);
      if (j0 + v + 8 <= ldy)
        yv = *reinterpret_cast<const uint4*>(Y + (size_t)(rb + r) * ldy + j0 + v);
      *reinterpret_cast<uint4*>(xs + r * kGLd + v) = xv;
      *reinterpret_cast<uint4*>(ys + r * kGLd + v) = yv;
    }
    __syncthreads();
    for (int kk = 0; kk < kGT; kk += 16) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int f = warp * 2 + q, fi = f / 4, fj = f % 4;
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> af;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
        wmma::load_matrix_sync(af, xs + kk * kGLd + fi * 16, kGLd);
        wmma::load_matrix_sync(bfr, ys + kk * kGLd + fj * 16, kGLd);
        wmma::mma_sync(acc[q], af, bfr, acc[q]);
      }
    }
    __syncthreads();
  }
  float* s = sc + warp * 256;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int f = warp * 2 + q, fi = f / 4, fj = f % 4;
    wmma::store_matrix_sync(s, acc[q], 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int gi = i0 + fi * 16 + e / 16, gj = j0 + fj * 16 + e % 16;
      if (gi < din && gj < dout)
        P[(long long)blockIdx.z * p_ld + p_off + (long long)gi * dout + gj] = s[e];
    }
    __syncwarp();
  }
}

// out[j] = sum_t P[t, j] for j < cols, t in order
__global__ void sum_rows_kernel(const float* __restrict__ P, int n, long long ld, int cols,
                                float* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= cols) return;
  float s = 0.f;
  for (int t = 0; t < n; ++t) s += P[(long long)t * ld + j];
  out[j] = s;
}

}  // namespace

// Shared memory (bytes) of the kernels that take MlpArgs: which = 0 forward,
// 1 backward; encode = 1 with the spectral encode.
extern "C" size_t apnerf_mlp_smem(const MlpArgs* a, int which, int encode) {
  return which == 0 ? mlp_fwd_smem(*a) : mlp_bwd_smem(*a, encode != 0).total;
}

extern "C" int apnerf_mlp_n_bias(const MlpArgs* a, int encode) {
  return mlp_n_bias(*a, encode != 0);
}

// The forward: encode = 1 from u, else from x; save = 1 keeps the bf16 input
// and the hidden activations; y is written where a->y is given. Launches on
// `stream` and returns cudaGetLastError(); allocates nothing.
extern "C" int apnerf_mlp_fwd(const MlpArgs* a, int encode, int save, void* stream) {
  const size_t smem = mlp_fwd_smem(*a);
  const void* kernel = encode ? (save ? (const void*)mlp_fwd_kernel<true, true>
                                      : (const void*)mlp_fwd_kernel<true, false>)
                              : (save ? (const void*)mlp_fwd_kernel<false, true>
                                      : (const void*)mlp_fwd_kernel<false, false>);
  int err = set_smem(kernel, smem);
  if (err) return err;
  const int grid = a->n_rows_pad / kTileRows;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (encode && save) mlp_fwd_kernel<true, true><<<grid, kThreads, smem, st>>>(*a);
  else if (encode) mlp_fwd_kernel<true, false><<<grid, kThreads, smem, st>>>(*a);
  else if (save) mlp_fwd_kernel<false, true><<<grid, kThreads, smem, st>>>(*a);
  else mlp_fwd_kernel<false, false><<<grid, kThreads, smem, st>>>(*a);
  return (int)cudaGetLastError();
}

extern "C" int apnerf_mlp_bwd(const MlpArgs* a, int encode, void* stream) {
  const size_t smem = mlp_bwd_smem(*a, encode != 0).total;
  const void* kernel =
      encode ? (const void*)mlp_bwd_kernel<true> : (const void*)mlp_bwd_kernel<false>;
  int err = set_smem(kernel, smem);
  if (err) return err;
  const int grid = a->n_rows_pad / kTileRows;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (encode) mlp_bwd_kernel<true><<<grid, kThreads, smem, st>>>(*a);
  else mlp_bwd_kernel<false><<<grid, kThreads, smem, st>>>(*a);
  return (int)cudaGetLastError();
}

extern "C" int apnerf_xt_dy(const void* X, int ldx, int x_cols, int din, const void* Y, int ldy,
                            int dout, int n_rows_pad, int rows_per_chunk, int n_chunks,
                            float* P, long long p_ld, long long p_off, void* stream) {
  const dim3 grid((din + kGT - 1) / kGT, (dout + kGT - 1) / kGT, n_chunks);
  xt_dy_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(X), ldx, x_cols, din, static_cast<const bf16*>(Y), ldy, dout,
      n_rows_pad, rows_per_chunk, P, p_ld, p_off);
  return (int)cudaGetLastError();
}

extern "C" int apnerf_sum_rows(const float* P, int n, long long ld, int cols, float* out,
                               void* stream) {
  sum_rows_kernel<<<(cols + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      P, n, ld, cols, out);
  return (int)cudaGetLastError();
}
