// Posterior epilogue of one ancestral sampling step, with its Gaussian noise
// drawn inside the kernel.
//
// Replaces: hicdiff_tpu/kernels/sample_step.py:fused_posterior_step, the
// Pallas TPU kernel that computes, elementwise over the flattened batch,
//   x0     = clip(a * x - b * eps, -1, 1)
//   mean   = c1 * x0 + c2 * x
//   x_next = mean + sigma * gate * z,   z ~ N(0, 1)
// and returns (x_next, x0). The TPU kernel draws z from the TPU's own PRNG;
// this one uses a counter-based Philox4x32-10 keyed on (seed, element group),
// so the stream is reproducible for a seed and independent of the launch
// shape, but never equal to the TPU's bits.
//
// What bounds it on the H100: device-memory bandwidth and launch latency.
// It moves 16 bytes per element (x, eps in; x_next, x0 out) and does a few
// dozen operations each; at the main path's 8 x 4096 elements that is 0.5 MB,
// which the card moves in well under the launch overhead.
//
// What the design does about it: one pass, no noise tensor in device memory
// (z lives in registers), one Philox call per thread feeding four elements
// through two Box-Muller pairs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint4 philox4x32_10(uint4 ctr, uint2 key) {
  const unsigned kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
  const unsigned kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const unsigned hi0 = __umulhi(kM0, ctr.x), lo0 = kM0 * ctr.x;
    const unsigned hi1 = __umulhi(kM1, ctr.z), lo1 = kM1 * ctr.z;
    ctr = make_uint4(hi1 ^ ctr.y ^ key.x, lo1, hi0 ^ ctr.w ^ key.y, lo0);
    key.x += kW0;
    key.y += kW1;
  }
  return ctr;
}

// Two standard normals from two 32-bit draws. u1 is in (0, 1], so log(u1)
// is finite (the TPU kernel adds 1e-7 for the same reason).
__device__ __forceinline__ void box_muller(unsigned r1, unsigned r2, float* z1,
                                           float* z2) {
  const float kInv24 = 1.0f / 16777216.0f;
  const float u1 = static_cast<float>((r1 >> 8) + 1u) * kInv24;
  const float u2 = static_cast<float>(r2 >> 8) * kInv24;
  const float radius = sqrtf(-2.0f * logf(u1));
  float s, c;
  sincospif(2.0f * u2, &s, &c);
  *z1 = radius * c;
  *z2 = radius * s;
}

__global__ void __launch_bounds__(kThreads)
    posterior_step_kernel(const float* __restrict__ x, const float* __restrict__ eps,
                          float* __restrict__ x_next, float* __restrict__ x0,
                          long long n, float a, float b, float c1, float c2,
                          float noise_scale, unsigned long long seed) {
  const long long group = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long base = group * 4;
  if (base >= n) return;
  const uint4 bits = philox4x32_10(
      make_uint4(static_cast<unsigned>(group), static_cast<unsigned>(group >> 32), 0u, 0u),
      make_uint2(static_cast<unsigned>(seed), static_cast<unsigned>(seed >> 32)));
  float z[4];
  box_muller(bits.x, bits.y, &z[0], &z[1]);
  box_muller(bits.z, bits.w, &z[2], &z[3]);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const long long i = base + j;
    if (i >= n) break;
    const float xv = x[i];
    const float x0v = fminf(fmaxf(a * xv - b * eps[i], -1.0f), 1.0f);
    x0[i] = x0v;
    x_next[i] = (c1 * x0v + c2 * xv) + noise_scale * z[j];
  }
}

}  // namespace

// C interface, loaded with ctypes by hicdiff_tpu_torch/kernels/sample_step.py.
// noise_scale = sigma * gate. Returns cudaGetLastError() after the launch.
extern "C" int hicdiff_posterior_step(const void* x, const void* eps, void* x_next,
                                      void* x0, long long n, float a, float b, float c1,
                                      float c2, float noise_scale,
                                      unsigned long long seed, void* stream) {
  const long long groups = (n + 3) / 4;
  const unsigned blocks = static_cast<unsigned>((groups + kThreads - 1) / kThreads);
  posterior_step_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(eps),
      static_cast<float*>(x_next), static_cast<float*>(x0), n, a, b, c1, c2, noise_scale,
      seed);
  return static_cast<int>(cudaGetLastError());
}
