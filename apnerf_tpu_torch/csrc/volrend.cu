// Volume-rendering weights from densities, forward and backward.
//
// Replaces apnerf_tpu/ops/pallas/volrend_pallas.py::fused_render_weights
// (forward kernel _fwd_kernel, launched by _call_fwd; backward kernel
// _bwd_kernel, launched by _call_bwd):
//
//   s_k = sigma_k * (t1_k - t0_k)
//   T_k = exp(-sum_{i<k} s_i)      a_k = 1 - exp(-s_k)      w_k = T_k * a_k
//
// The forward returns w alone, as the JAX function does: no caller reads
// T or a, so they are not written.
//
// What bounds it on an H100: device memory. The forward reads three f32
// values a sample and writes one (16 B), the backward reads four and
// writes one, or three when dt0 and dt1 are asked for (20 or 28 B),
// against a handful of operations. The design keeps as many of those
// bytes in flight as it can and moves each exactly once:
//
// - One warp owns one ray, and each lane a span of V consecutive samples
//   (V a compile-time instance, 32 V >= S, picked by the wrapper). Every
//   load of the row is issued before the first shuffle, as 16-byte
//   vectors where the row is aligned to them (S a multiple of 4: every
//   shape of the port's paths), else as masked scalars.
// - Then a serial sum inside the lane, one 5-shuffle scan of the 32 lane
//   totals, and T, a and w in registers: 6 shuffles a ray, whatever S.
// - 4 rays (128 threads) a block: 2048 rays are 512 blocks, so every one
//   of the 132 SMs has work, each about 16 warps.
// - S in (512, 1024]: V = 32, still one warp a ray and no shared memory:
//   the forward needs ~3 V registers a lane and the backward ~4 V, under
//   the 255 a thread allows (ptxas -v: 142 and 166-206, no spill).
//
// Precise expf: transmittance feeds the weights directly.
//
// The backward is closed form. With g = dL/dw and e_k = exp(-s_k):
//   bracket_j = g_j T_j e_j - sum_{k>j} g_k w_k
//   dsigma_j = dt_j bracket_j     dt1_j = sigma_j bracket_j = -dt0_j
// It reads each input once and keeps T e and g w in registers: the
// forward's scan, then the suffix sum of g w, summed directly (a reverse
// serial sum inside the lane on top of a warp suffix scan of the lane
// totals), not as total minus prefix, so it keeps its relative
// precision. It writes dsigma, and dt0, dt1 only when the caller passes
// them (kDt): on the port's paths t0 and t1 carry no gradient.

#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

namespace {

constexpr int kRaysPerBlock = 4;
constexpr int kThreads = 32 * kRaysPerBlock;
constexpr unsigned kFull = 0xffffffffu;

// This lane's V samples of a row, from sample `first` on; zeros past `n`.
// kVec: the row is aligned to the vector width and n is a multiple of
// it, so each vector lies wholly inside the row or wholly past its end.
template <int V, bool kVec>
__device__ __forceinline__ void load_span(const float* __restrict__ row, int first, int n,
                                          float (&a)[V]) {
  if constexpr (kVec) {
    constexpr int W = V < 4 ? V : 4;  // floats a vector access moves
#pragma unroll
    for (int c = 0; c < V; c += W) {
      const int i = first + c;
      if constexpr (W == 4) {
        const float4 v = i < n ? *reinterpret_cast<const float4*>(row + i)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
        a[c] = v.x, a[c + 1] = v.y, a[c + 2] = v.z, a[c + 3] = v.w;
      } else if constexpr (W == 2) {
        const float2 v = i < n ? *reinterpret_cast<const float2*>(row + i) : make_float2(0.f, 0.f);
        a[c] = v.x, a[c + 1] = v.y;
      } else {
        a[c] = i < n ? row[i] : 0.f;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) a[j] = first + j < n ? row[first + j] : 0.f;
  }
}

// Stores this lane's V values (times `scale`), those before `n` only.
template <int V, bool kVec>
__device__ __forceinline__ void store_span(float* __restrict__ row, int first, int n,
                                           const float (&a)[V], float scale = 1.f) {
  if constexpr (kVec) {
    constexpr int W = V < 4 ? V : 4;  // floats a vector access moves
#pragma unroll
    for (int c = 0; c < V; c += W) {
      const int i = first + c;
      if (i >= n) break;
      if constexpr (W == 4) {
        *reinterpret_cast<float4*>(row + i) =
            make_float4(scale * a[c], scale * a[c + 1], scale * a[c + 2], scale * a[c + 3]);
      } else if constexpr (W == 2) {
        *reinterpret_cast<float2*>(row + i) = make_float2(scale * a[c], scale * a[c + 1]);
      } else {
        row[i] = scale * a[c];
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j)
      if (first + j < n) row[first + j] = scale * a[j];
  }
}

// The sum of v over the lanes before this one (an exclusive warp scan).
__device__ __forceinline__ float lanes_before(float v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v += u;
  }
  const float before = __shfl_up_sync(kFull, v, 1);
  return lane == 0 ? 0.f : before;
}

// The sum of v over the lanes after this one (an exclusive suffix scan).
__device__ __forceinline__ float lanes_after(float v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_down_sync(kFull, v, off);
    if (lane + off < 32) v += u;
  }
  const float after = __shfl_down_sync(kFull, v, 1);
  return lane == 31 ? 0.f : after;
}

template <int V, bool kVec>
__global__ void __launch_bounds__(kThreads)
    render_weights_fwd_kernel(const float* __restrict__ t0, const float* __restrict__ t1,
                              const float* __restrict__ sigma, int n_rays, int n_samples,
                              float* __restrict__ w) {
  const int ray = blockIdx.x * kRaysPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (ray >= n_rays) return;  // uniform across the warp
  const size_t base = (size_t)ray * n_samples;
  const int first = lane * V;
  float a[V], b[V], s[V];
  load_span<V, kVec>(t0 + base, first, n_samples, a);
  load_span<V, kVec>(t1 + base, first, n_samples, b);
  load_span<V, kVec>(sigma + base, first, n_samples, s);
  float total = 0.f;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    s[j] *= b[j] - a[j];
    total += s[j];
  }
  float excl = lanes_before(total, lane);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float tr = expf(-excl);
    excl += s[j];
    s[j] = tr * (1.f - expf(-s[j]));
  }
  store_span<V, kVec>(w + base, first, n_samples, s);
}

template <int V, bool kVec, bool kDt>
__global__ void __launch_bounds__(kThreads)
    render_weights_bwd_kernel(const float* __restrict__ t0, const float* __restrict__ t1,
                              const float* __restrict__ sigma, const float* __restrict__ g,
                              int n_rays, int n_samples, float* __restrict__ dsigma,
                              float* __restrict__ dt0, float* __restrict__ dt1) {
  const int ray = blockIdx.x * kRaysPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (ray >= n_rays) return;  // uniform across the warp
  const size_t base = (size_t)ray * n_samples;
  const int first = lane * V;
  // x: t0, then s, then g w, then dsigma; gg: g, then g T e, then dt1
  float x[V], dt[V], sg[V], gg[V];
  load_span<V, kVec>(t0 + base, first, n_samples, x);
  load_span<V, kVec>(t1 + base, first, n_samples, dt);
  load_span<V, kVec>(sigma + base, first, n_samples, sg);
  load_span<V, kVec>(g + base, first, n_samples, gg);
  float total = 0.f;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    dt[j] -= x[j];
    x[j] = sg[j] * dt[j];
    total += x[j];
  }
  float excl = lanes_before(total, lane);
  float gw_total = 0.f;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float tr = expf(-excl);
    const float e = expf(-x[j]);
    excl += x[j];
    x[j] = gg[j] * (tr * (1.f - e));
    gg[j] *= tr * e;
  }
#pragma unroll
  for (int j = V - 1; j >= 0; --j) gw_total += x[j];
  float suffix = lanes_after(gw_total, lane);  // sum of g w over the later samples
#pragma unroll
  for (int j = V - 1; j >= 0; --j) {
    const float bracket = gg[j] - suffix;
    suffix += x[j];
    x[j] = dt[j] * bracket;
    if constexpr (kDt) gg[j] = sg[j] * bracket;
  }
  store_span<V, kVec>(dsigma + base, first, n_samples, x);
  if constexpr (kDt) {
    store_span<V, kVec>(dt1 + base, first, n_samples, gg);
    store_span<V, kVec>(dt0 + base, first, n_samples, gg, -1.f);
  }
}

__global__ void __launch_bounds__(kThreads) empty_kernel() {}

int grid_of(int n_rays) { return (n_rays + kRaysPerBlock - 1) / kRaysPerBlock; }

// Whether `span` is an instance that covers n_samples, and the vector
// path's promise (row and pointers aligned to the vector width) holds.
bool valid_call(int n_rays, int n_samples, int span, int vec,
                std::initializer_list<const void*> ptrs) {
  if (n_rays <= 0 || n_samples <= 0 || 32 * span < n_samples) return false;
  if (span != 1 && span != 2 && span != 4 && span != 8 && span != 16 && span != 32) return false;
  if (vec) {
    const int wbytes = 4 * (span < 4 ? span : 4);
    if (n_samples % (wbytes / 4) != 0) return false;
    for (const void* p : ptrs)
      if (reinterpret_cast<std::uintptr_t>(p) % wbytes != 0) return false;
  }
  return true;
}

template <int V>
void launch_fwd(bool vec, const float* t0, const float* t1, const float* sigma, int n_rays,
                int n_samples, float* w, cudaStream_t stream) {
  if (vec)
    render_weights_fwd_kernel<V, true>
        <<<grid_of(n_rays), kThreads, 0, stream>>>(t0, t1, sigma, n_rays, n_samples, w);
  else
    render_weights_fwd_kernel<V, false>
        <<<grid_of(n_rays), kThreads, 0, stream>>>(t0, t1, sigma, n_rays, n_samples, w);
}

template <int V, bool kDt>
void launch_bwd_dt(bool vec, const float* t0, const float* t1, const float* sigma, const float* g,
                   int n_rays, int n_samples, float* dsigma, float* dt0, float* dt1,
                   cudaStream_t stream) {
  if (vec)
    render_weights_bwd_kernel<V, true, kDt><<<grid_of(n_rays), kThreads, 0, stream>>>(
        t0, t1, sigma, g, n_rays, n_samples, dsigma, dt0, dt1);
  else
    render_weights_bwd_kernel<V, false, kDt><<<grid_of(n_rays), kThreads, 0, stream>>>(
        t0, t1, sigma, g, n_rays, n_samples, dsigma, dt0, dt1);
}

template <int V>
void launch_bwd(bool vec, const float* t0, const float* t1, const float* sigma, const float* g,
                int n_rays, int n_samples, float* dsigma, float* dt0, float* dt1,
                cudaStream_t stream) {
  if (dt0 != nullptr)
    launch_bwd_dt<V, true>(vec, t0, t1, sigma, g, n_rays, n_samples, dsigma, dt0, dt1, stream);
  else
    launch_bwd_dt<V, false>(vec, t0, t1, sigma, g, n_rays, n_samples, dsigma, dt0, dt1, stream);
}

}  // namespace

// An empty kernel launched as the weights kernels are (the grid of n_rays,
// kThreads threads, on `stream`): the launch floor that their device times
// are read against. No path runs it.
extern "C" int apnerf_empty_launch(int n_rays, void* stream) {
  empty_kernel<<<grid_of(n_rays), kThreads, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

#define APNERF_SPAN_SWITCH(span, CALL) \
  switch (span) {                      \
    case 1: CALL(1); break;            \
    case 2: CALL(2); break;            \
    case 4: CALL(4); break;            \
    case 8: CALL(8); break;            \
    case 16: CALL(16); break;          \
    default: CALL(32); break;          \
  }

// w [n_rays, n_samples] from t0, t1, sigma, on `stream`, at lane span
// `span` (1, 2, 4, 8, 16 or 32 with 32 span >= n_samples) and with vector
// accesses where `vec` is set (n_samples a multiple of min(span, 4), every
// pointer aligned to it). Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a call outside those terms; allocates nothing.
extern "C" int apnerf_fused_render_weights_fwd(const float* t0, const float* t1,
                                                const float* sigma, int n_rays, int n_samples,
                                                int span, int vec, float* w, void* stream) {
  if (!valid_call(n_rays, n_samples, span, vec, {t0, t1, sigma, w}))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define APNERF_FWD(V) launch_fwd<V>(vec != 0, t0, t1, sigma, n_rays, n_samples, w, st)
  APNERF_SPAN_SWITCH(span, APNERF_FWD)
#undef APNERF_FWD
  return (int)cudaGetLastError();
}

// dsigma, and dt0 and dt1 where both are given (else both null), from t0,
// t1, sigma and g = dL/dw, on `stream`, on the terms of the forward.
// Returns cudaGetLastError() or cudaErrorInvalidValue; allocates nothing.
extern "C" int apnerf_fused_render_weights_bwd(const float* t0, const float* t1,
                                                const float* sigma, const float* g, int n_rays,
                                                int n_samples, int span, int vec, float* dsigma,
                                                float* dt0, float* dt1, void* stream) {
  if ((dt0 == nullptr) != (dt1 == nullptr) ||
      !valid_call(n_rays, n_samples, span, vec,
                  {t0, t1, sigma, g, dsigma, dt0 ? dt0 : dsigma, dt1 ? dt1 : dsigma}))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define APNERF_BWD(V) \
  launch_bwd<V>(vec != 0, t0, t1, sigma, g, n_rays, n_samples, dsigma, dt0, dt1, st)
  APNERF_SPAN_SWITCH(span, APNERF_BWD)
#undef APNERF_BWD
  return (int)cudaGetLastError();
}
