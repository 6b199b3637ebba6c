// Volume-rendering weights from densities, forward and backward.
//
// Replaces apnerf_tpu/ops/pallas/volrend_pallas.py::fused_render_weights
// (forward kernel _fwd_kernel, launched by _call_fwd; backward kernel
// _bwd_kernel, launched by _call_bwd):
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
//
// The backward is closed form. With g = dL/dw and w_k = T_k (1 - e_k),
// e_k = exp(-s_k):
//   bracket_j = g_j T_j e_j - sum_{k>j} g_k w_k
//   dsigma_j = dt_j bracket_j     dt1_j = sigma_j bracket_j = -dt0_j
// One warp per ray again: the forward scan is recomputed chunk by chunk
// (T_j and w_j land in shared memory), then a second pass walks the
// chunks from the end with a __shfl_down_sync suffix scan of g*w whose
// running total is carried in a register. The suffix is summed directly,
// not as total minus prefix, so it keeps its relative precision.

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

__global__ void __launch_bounds__(kThreads)
    render_weights_bwd_kernel(const float* __restrict__ t0, const float* __restrict__ t1,
                              const float* __restrict__ sigma, const float* __restrict__ g,
                              int n_rays, int n_samples, float* __restrict__ dsigma,
                              float* __restrict__ dt0, float* __restrict__ dt1) {
  extern __shared__ float bsm[];  // per warp: T[n_samples], w[n_samples]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ray = blockIdx.x * kRaysPerBlock + warp;
  if (ray >= n_rays) return;  // uniform across the warp
  float* tr = bsm + warp * 2 * n_samples;
  float* wb = tr + n_samples;
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
      const float t = expf(-((carry + incl) - s));
      tr[i] = t;
      wb[i] = t * (1.f - expf(-s));
    }
    carry += __shfl_sync(kFull, incl, 31);
  }
  __syncwarp();
  carry = 0.f;  // sum of g*w over the chunks already walked (the later samples)
  for (int c = ((n_samples - 1) / 32) * 32; c >= 0; c -= 32) {
    const int i = c + lane;
    float gw = 0.f, gi = 0.f, dt = 0.f, sg = 0.f;
    if (i < n_samples) {
      gi = g[base + i];
      gw = gi * wb[i];
      sg = sigma[base + i];
      dt = t1[base + i] - t0[base + i];
    }
    float incl = gw;  // sum over lanes >= lane of this chunk
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_down_sync(kFull, incl, off);
      if (lane + off < 32) incl += v;
    }
    if (i < n_samples) {
      const float suffix = (carry + incl) - gw;
      const float bracket = gi * tr[i] * expf(-sg * dt) - suffix;
      dsigma[base + i] = dt * bracket;
      const float ddt = sg * bracket;
      dt0[base + i] = -ddt;
      dt1[base + i] = ddt;
    }
    carry += __shfl_sync(kFull, incl, 0);
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

// Launches on `stream` and returns cudaGetLastError(); allocates nothing.
// Needs 2 * n_samples floats of shared memory per warp (64 KB at 1024).
extern "C" int apnerf_fused_render_weights_bwd(const float* t0, const float* t1,
                                                const float* sigma, const float* g,
                                                int n_rays, int n_samples, float* dsigma,
                                                float* dt0, float* dt1, void* stream) {
  const size_t smem = (size_t)kRaysPerBlock * 2 * n_samples * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      render_weights_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (n_rays + kRaysPerBlock - 1) / kRaysPerBlock;
  render_weights_bwd_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      t0, t1, sigma, g, n_rays, n_samples, dsigma, dt0, dt1);
  return (int)cudaGetLastError();
}
