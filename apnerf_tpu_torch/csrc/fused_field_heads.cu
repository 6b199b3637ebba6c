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
// What bounds it on an H100: tensor-core math. A row of the shipping field
// costs ~0.45 MFLOP (the 3x256 trunk and both 64-wide heads) against 12 B
// read and 132 B written, ~3,300 FLOP/B, far above the card's ~295 FLOP/B
// balance. The kernel is a template on the trunk width H and the tier
// (T_out, C_pad), one instance for each pair field_tile.cuh takes, compiled
// in APNERF_PARTS parts in parallel. The design is field_tile.cuh's:
// persistent blocks of two wgmma consumer
// warpgroups and a producer warp that streams the weights' tile images
// through a shared-memory ring with cp.async.bulk; no activation is
// written back, and a tile's packed rows [64, 4 + C] are staged in shared
// memory and leave as one contiguous run of 16-byte stores (past 64
// classes: the density and rgb columns, then 64 logits a chunk, strided
// 4-byte stores). It reaches
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
//
// The file also holds the forwards of the trunk kernels (trunk_fwd_kernel,
// fused_mlp.py: fused_spectral_field, replacing apnerf_tpu/ops/pallas/
// fused_mlp.py::_call_enc_fwd, and fused_mlp_apply, replacing ::_call_fwd):
// the same field_forward without saves and without the heads, y = the
// trunk's f32 output layer on the encode of u or on x (bf16, or f32
// rounded to bf16). What bounds them is the same tensor-core math (a row of
// the shipping trunk costs ~0.4 MFLOP against 12 B in and 64 B out); the
// output layer's product is formed 16 columns a slab, its f32 bias added
// to the accumulators, and a tile's 16 columns are staged in shared memory
// and leave as 16-byte stores where the row width allows (any width
// goes), rows past n_rows never written.

// this file is compiled once per part (field_tile.cuh)
#define APNERF_PARTS 4

#include "field_train_args.cuh"
#include "warp_reduce.cuh"

// Every pointer and size of one forward call; mirrors _FfhArgs in
// apnerf_tpu_torch/ops/cuda/fused_field_heads.py field by field.
struct FfhArgs {
  const float* u;   // [N, 3] unit-cube coordinates
  const float* sh;  // [R, 16] SH of the ray directions
  float* y;         // [N, 4 + C] packed output; the trunk alone [N, out]
  FieldWeights p;
  int n_rows, n_samples;
  // the trunk alone without the encode: its input [N, din], bf16 or f32
  const void* x;
  int x_f32, din;
};

namespace {

// stages a tile's packed rows [64, 4 + C], one contiguous run of y; past
// 64 classes their first four columns [64, 4], then a chunk of 64 logits
struct PackedEpilogue {
  static constexpr bool kTrunkOut = false;
  float* y;
  int ld;   // 4 + C
  int sld;  // a staged row: ld, or 4 past 64 classes
  __device__ void density(float* st, int i, float sigma, float) { st[i * sld + 3] = sigma; }
  __device__ void rgb(float* st, int i, int c, float v) { st[i * sld + c] = v; }
  __device__ void sem(float* st, int i, int c, float v) { st[i * sld + 4 + c] = v; }
  __device__ void flush(const float* st, int row0, int n_valid, int t, int nt) {
    copy_out(y + (size_t)row0 * ld, st, n_valid * ld, t, nt);
  }
  __device__ void flush_head(const float* st, int row0, int n_valid, int t, int nt) {
    for (int e = t; e < n_valid * 4; e += nt) y[(size_t)(row0 + e / 4) * ld + e % 4] = st[e];
  }
  // logits 64 ch .. 64 ch + 63 from ss [64, 64]
  __device__ void flush_sem(const float* ss, int row0, int n_valid, int ch, int t, int nt) {
    const int c0 = kSemChunk * ch, w = min(kSemChunk, ld - 4 - c0);
    for (int e = t; e < n_valid * kSemChunk; e += nt) {
      const int c = e % kSemChunk;
      if (c < w) y[(size_t)(row0 + e / kSemChunk) * ld + 4 + c0 + c] = ss[e];
    }
  }
};

// writes a tile's 16 staged output columns ch of the trunk alone, y [N, out]
struct TrunkEpilogue {
  static constexpr bool kTrunkOut = true;
  float* y;
  int out;
  __device__ void flush_chunk(const float* ys, int row0, int n_valid, int ch, int t, int nt) {
    if (out % 4 == 0) {
      for (int e = t; e < kTileRows * 4; e += nt) {
        const int i = e / 4, c = 4 * (e % 4);
        if (i < n_valid && 16 * ch + c < out)
          *reinterpret_cast<float4*>(y + (size_t)(row0 + i) * out + 16 * ch + c) =
              *reinterpret_cast<const float4*>(ys + i * 16 + c);
      }
    } else {
      for (int e = t; e < kTileRows * 16; e += nt) {
        const int i = e / 16, c = e % 16;
        if (i < n_valid && 16 * ch + c < out) y[(size_t)(row0 + i) * out + 16 * ch + c] = ys[e];
      }
    }
  }
  // the heads' epilogue, never reached with the heads off
  __device__ void density(float*, int, float, float) {}
  __device__ void rgb(float*, int, int, float) {}
  __device__ void sem(float*, int, int, float) {}
  __device__ void flush(const float*, int, int, int, int) {}
  __device__ void flush_head(const float*, int, int, int, int) {}
  __device__ void flush_sem(const float*, int, int, int, int, int) {}
};

template <int H, bool kWhole, int kCP, int kTO>
__global__ void __launch_bounds__(kFieldThreads, 1)
    ffh_fwd_kernel(const __grid_constant__ FfhArgs a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const int ld = 4 + a.p.n_classes;
  field_forward<H, kWhole, kCP, kTO>(a.p, NoSave{}, a.u, nullptr, 0, 0, true, a.sh, a.n_rows,
                                     a.n_samples, smem,
                                     PackedEpilogue{a.y, ld, kCP == kSemChunk ? ld : 4});
}

// the trunk alone: the first tier's instance (it has no heads)
template <int H, bool kWhole>
__global__ void __launch_bounds__(kFieldThreads, 1)
    trunk_fwd_kernel(const __grid_constant__ FfhArgs a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  field_forward<H, kWhole, 64, 16>(a.p, NoSave{}, a.u, a.x, a.x_f32, a.din, false, nullptr,
                                   a.n_rows, 1, smem, TrunkEpilogue{a.y, a.p.out});
}

template <int H, bool kWhole, int kCP, int kTO>
int launch_ffh_fwd(const FfhArgs* a, int grid, cudaStream_t stream) {
  const size_t smem = fwd_smem(H, a->p.n_hidden, kTO, kCP).total;
  int err = set_smem((const void*)ffh_fwd_kernel<H, kWhole, kCP, kTO>, smem);
  if (err) return err;
  ffh_fwd_kernel<H, kWhole, kCP, kTO><<<grid, kFieldThreads, smem, stream>>>(*a);
  return (int)cudaGetLastError();
}

template <int H, bool kWhole>
int launch_trunk_fwd(const FfhArgs* a, int grid, cudaStream_t stream) {
  const size_t smem = fwd_smem(H, a->p.n_hidden, 16, 64).total;
  int err = set_smem((const void*)trunk_fwd_kernel<H, kWhole>, smem);
  if (err) return err;
  trunk_fwd_kernel<H, kWhole><<<grid, kFieldThreads, smem, stream>>>(*a);
  return (int)cudaGetLastError();
}

// instance (H, tier) where this part compiles it, else kElsewhere
template <int H, int kTier, int kTO, int kCP>
int ffh_fwd_at(const FfhArgs* a, int grid, cudaStream_t stream) {
  if constexpr (part_of<APNERF_PARTS>(H, kTier) == APNERF_PART) {
    if constexpr (H > 512) {
      return launch_ffh_fwd<H, false, kCP, kTO>(a, grid, stream);  // no kWhole instance
    } else {
      return whole_enc(H, true, a->p.n_kb) ? launch_ffh_fwd<H, true, kCP, kTO>(a, grid, stream)
                                           : launch_ffh_fwd<H, false, kCP, kTO>(a, grid, stream);
    }
  } else {
    return kElsewhere;
  }
}

template <int H>
int trunk_fwd_at(const FfhArgs* a, int grid, cudaStream_t stream) {
  if constexpr (part_of<APNERF_PARTS>(H, 0) == APNERF_PART) {
    if constexpr (H > 512) {
      return launch_trunk_fwd<H, false>(a, grid, stream);  // no kWhole instance
    } else {
      return whole_enc(H, a->x == nullptr, a->p.n_kb)
                 ? launch_trunk_fwd<H, true>(a, grid, stream)
                 : launch_trunk_fwd<H, false>(a, grid, stream);
    }
  } else {
    return kElsewhere;
  }
}

#if APNERF_PART == 0
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
#endif  // APNERF_PART == 0

}  // namespace

// This part's instances: launch `grid` persistent blocks of the instance
// (a->p.tile_h, the tier) on `stream` and return cudaGetLastError(), or
// kElsewhere where another part compiles it; allocate nothing.
extern "C" int APNERF_IN_PART(apnerf_ffh_fwd)(const FfhArgs* a, int grid, void* stream) {
  const int tier = tier_of(a->p.t_out, a->p.c_tile);
#define APNERF_CASE(T_, TO_, CP_, H_) \
  if (a->p.tile_h == H_ && tier == T_) \
    return ffh_fwd_at<H_, T_, TO_, CP_>(a, grid, (cudaStream_t)stream);
#define APNERF_TIER(T_, TO_, CP_) \
  APNERF_CASE(T_, TO_, CP_, 64) APNERF_CASE(T_, TO_, CP_, 128) APNERF_CASE(T_, TO_, CP_, 256) \
  APNERF_CASE(T_, TO_, CP_, 512) APNERF_CASE(T_, TO_, CP_, 1024)
  APNERF_FIELD_TIERS(APNERF_TIER)
#undef APNERF_TIER
#undef APNERF_CASE
  return (int)cudaErrorInvalidValue;
}

extern "C" int APNERF_IN_PART(apnerf_trunk_fwd)(const FfhArgs* a, int grid, void* stream) {
#define APNERF_CASE(H_) \
  if (a->p.tile_h == H_) return trunk_fwd_at<H_>(a, grid, (cudaStream_t)stream);
  APNERF_TILE_WIDTHS(APNERF_CASE)
#undef APNERF_CASE
  return (int)cudaErrorInvalidValue;
}

#if APNERF_PART == 0

#define APNERF_EACH_PART(X) X(0) X(1) X(2) X(3)
#define APNERF_DECLARE(P_)                                                 \
  extern "C" int apnerf_ffh_fwd_p##P_(const FfhArgs*, int, void*); \
  extern "C" int apnerf_trunk_fwd_p##P_(const FfhArgs*, int, void*);
APNERF_EACH_PART(APNERF_DECLARE)
#undef APNERF_DECLARE

// Launch `grid` persistent blocks of the instance (a->p.tile_h, the tier
// of a->p.t_out and a->p.c_tile) on `stream` and return
// cudaGetLastError() (cudaErrorInvalidValue for another instance);
// allocate nothing. apnerf_ffh_fwd: the packed field; apnerf_trunk_fwd:
// the trunk alone, on the encode of a->u or, where a->x is given, on x.
extern "C" int apnerf_ffh_fwd(const FfhArgs* a, int grid, void* stream) {
  int err = kElsewhere;
#define APNERF_TRY(P_) \
  if (err == kElsewhere) err = apnerf_ffh_fwd_p##P_(a, grid, stream);
  APNERF_EACH_PART(APNERF_TRY)
#undef APNERF_TRY
  return err == kElsewhere ? (int)cudaErrorInvalidValue : err;
}

extern "C" int apnerf_trunk_fwd(const FfhArgs* a, int grid, void* stream) {
  int err = kElsewhere;
#define APNERF_TRY(P_) \
  if (err == kElsewhere) err = apnerf_trunk_fwd_p##P_(a, grid, stream);
  APNERF_EACH_PART(APNERF_TRY)
#undef APNERF_TRY
  return err == kElsewhere ? (int)cudaErrorInvalidValue : err;
}

// The packed cotangent a->g_packed to the per-sample cotangents of the field
// backward; a->n_rays rays of a->n_samples rows.
extern "C" int apnerf_ffh_bwd_pack(const FvrArgs* a, void* stream) {
  ffh_bwd_pack_kernel<<<(a->n_rays + kPackWarps - 1) / kPackWarps, kPackWarps * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(*a);
  return (int)cudaGetLastError();
}

#endif  // APNERF_PART == 0
