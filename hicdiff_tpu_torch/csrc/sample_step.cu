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
// shape, but never equal to the TPU's bits. The group counts from
// `group_offset`: a shard of a batch that passes its first element over 4
// draws the noise the whole batch draws at those elements, as the JAX chain's
// noise does not depend on how the batch is sharded.
//
// What bounds it on the H100: launch latency. It moves 16 bytes per element
// (x, eps in; x_next, x0 out) and does a few dozen operations each; at the
// main path's 8 x 4096 elements that is 0.5 MB, 0.16 us at 3.35 TB/s, below
// what any launch takes. So the kernel's time is its launch, the latency of
// one round of loads and stores, and the longest thread's arithmetic.
//
// What the design does about it: one pass, no noise tensor in device memory
// (z lives in registers), one Philox call per thread feeding its group of
// four elements through two Box-Muller pairs. A thread moves its group as
// one 16-byte load of x and one of eps and one 16-byte store of each output
// (a scalar tail covers n % 4), and issues the loads before the Philox
// rounds so that their latency overlaps the arithmetic. 64-thread blocks
// spread the main shape over 128 blocks, about one per SM, instead of 32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;

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

// x0 and x_next of one element, with its draw z.
__device__ __forceinline__ void step(float xv, float ev, float z, float a, float b, float c1,
                                     float c2, float noise_scale, float* x_next, float* x0) {
  const float x0v = fminf(fmaxf(a * xv - b * ev, -1.0f), 1.0f);
  *x0 = x0v;
  *x_next = (c1 * x0v + c2 * xv) + noise_scale * z;
}

__global__ void __launch_bounds__(kThreads)
    posterior_step_kernel(const float* __restrict__ x, const float* __restrict__ eps,
                          float* __restrict__ x_next, float* __restrict__ x0,
                          long long n, float a, float b, float c1, float c2,
                          float noise_scale, unsigned long long seed,
                          unsigned long long group_offset) {
  const long long group = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long base = group * 4;
  if (base >= n) return;
  const bool whole = base + 4 <= n;
  float4 xv = make_float4(0.f, 0.f, 0.f, 0.f), ev = xv;
  if (whole) {  // the pointers are 16-byte aligned (the wrapper checks)
    xv = *reinterpret_cast<const float4*>(x + base);
    ev = *reinterpret_cast<const float4*>(eps + base);
  }
  const unsigned long long counter = static_cast<unsigned long long>(group) + group_offset;
  const uint4 bits = philox4x32_10(
      make_uint4(static_cast<unsigned>(counter), static_cast<unsigned>(counter >> 32), 0u, 0u),
      make_uint2(static_cast<unsigned>(seed), static_cast<unsigned>(seed >> 32)));
  float z[4];
  box_muller(bits.x, bits.y, &z[0], &z[1]);
  box_muller(bits.z, bits.w, &z[2], &z[3]);
  if (whole) {
    float4 xn, x0v;
    step(xv.x, ev.x, z[0], a, b, c1, c2, noise_scale, &xn.x, &x0v.x);
    step(xv.y, ev.y, z[1], a, b, c1, c2, noise_scale, &xn.y, &x0v.y);
    step(xv.z, ev.z, z[2], a, b, c1, c2, noise_scale, &xn.z, &x0v.z);
    step(xv.w, ev.w, z[3], a, b, c1, c2, noise_scale, &xn.w, &x0v.w);
    *reinterpret_cast<float4*>(x0 + base) = x0v;
    *reinterpret_cast<float4*>(x_next + base) = xn;
    return;
  }
  for (int j = 0; j < n - base; ++j)  // the tail: n % 4 elements
    step(x[base + j], eps[base + j], z[j], a, b, c1, c2, noise_scale, &x_next[base + j],
         &x0[base + j]);
}

}  // namespace

// C interface, loaded with ctypes by hicdiff_tpu_torch/kernels/sample_step.py.
// noise_scale = sigma * gate; x, eps, x_next and x0 are 16-byte aligned;
// group_offset: the Philox counter of the first group of four elements.
// Returns cudaGetLastError() after the launch.
extern "C" int hicdiff_posterior_step(const void* x, const void* eps, void* x_next,
                                      void* x0, long long n, float a, float b, float c1,
                                      float c2, float noise_scale,
                                      unsigned long long seed,
                                      unsigned long long group_offset, void* stream) {
  const long long groups = (n + 3) / 4;
  const unsigned blocks = static_cast<unsigned>((groups + kThreads - 1) / kThreads);
  posterior_step_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(eps),
      static_cast<float*>(x_next), static_cast<float*>(x0), n, a, b, c1, c2, noise_scale,
      seed, group_offset);
  return static_cast<int>(cudaGetLastError());
}
