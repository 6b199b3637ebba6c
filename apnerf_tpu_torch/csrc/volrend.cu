// Volume-rendering weights from densities, forward only.
//
// Replaces apnerf_tpu/ops/pallas/volrend_pallas.py::fused_render_weights
// (forward kernel _fwd_kernel, launched by _call_fwd):
//
//   s_k = sigma_k * (t1_k - t0_k)
//   T_k = exp(-sum_{i<k} s_i)      a_k = 1 - exp(-s_k)      w_k = T_k * a_k
//
// What bounds it on an H100: device memory. Each sample reads three f32
// values and writes three, against a handful of flops, so the kernel can
// at best stream 24 B per sample at the card's bandwidth. The design
// reads and writes each value exactly once, coalesced: one warp owns one
// ray and walks it in 32-sample chunks; the exclusive sum is a
// __shfl_up_sync scan inside the chunk with the running total carried
// from chunk to chunk in a register. The TPU kernel's lane-roll
// Hillis-Steele scan over whole rows has no reason to exist here.
// Precise expf: transmittance feeds the weights directly.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRaysPerBlock = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
    render_weights_fwd_kernel(const float* __restrict__ t0, const float* __restrict__ t1,
                              const float* __restrict__ sigma, int n_rays, int n_samples,
                              float* __restrict__ w, float* __restrict__ trans,
                              float* __restrict__ alpha) {
  const int ray = blockIdx.x * kRaysPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (ray >= n_rays) return;  // uniform across the warp
  const size_t base = (size_t)ray * n_samples;
  float carry = 0.f;
  for (int c = 0; c < n_samples; c += 32) {
    const int i = c + lane;
    float s = 0.f;
    if (i < n_samples) s = sigma[base + i] * (t1[base + i] - t0[base + i]);
    float incl = s;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += v;
    }
    if (i < n_samples) {
      const float excl = (carry + incl) - s;
      const float tr = expf(-excl);
      const float a = 1.f - expf(-s);
      w[base + i] = tr * a;
      trans[base + i] = tr;
      alpha[base + i] = a;
    }
    carry += __shfl_sync(kFull, incl, 31);
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(); allocates nothing.
extern "C" int apnerf_fused_render_weights_fwd(const float* t0, const float* t1,
                                                const float* sigma, int n_rays, int n_samples,
                                                float* w, float* trans, float* alpha,
                                                void* stream) {
  const int grid = (n_rays + kRaysPerBlock - 1) / kRaysPerBlock;
  render_weights_fwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      t0, t1, sigma, n_rays, n_samples, w, trans, alpha);
  return (int)cudaGetLastError();
}
