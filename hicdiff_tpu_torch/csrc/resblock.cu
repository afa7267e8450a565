// One 3x3 convolution of the hicedrn residual block as an implicit GEMM with
// a fused epilogue, NHWC, C_in == C_out == C.
//
// Replaces: hicdiff_tpu/kernels/resblock.py:fused_resblock, the Pallas TPU
// kernel that computes y = conv(silu(conv(x) * (scale + 1) + shift)) * 0.1 + x
// with ONE shared conv applied twice. Here the block is two launches of the
// kernel below (hicdiff_tpu_torch/kernels/resblock.py drives them):
//   mode 1: h = cast(silu((conv(x) + bias) * (scale[b] + 1) + shift[b]))
//   mode 2: y = cast((conv(h) + bias) * 0.1 + x)
// Two launches give conv #2 its SAME zero padding for free: h is complete in
// device memory before conv #2 reads its halo, so the TPU kernel's halo
// recompute and its padding mask have no counterpart here.
//
// What bounds it on the H100: compute. Per conv, M = B*H*W output pixels,
// N = C output channels, K = 9*C, so at B=8, 64x64, C=256 one conv is
// 38.7 GFLOP against 2 * 16.8 MB of activations and 1.2 MB of bf16 weights:
// ~1100 FLOP per byte, far above the card's ~295 FLOP/byte ridge.
//
// What the design does about it:
//   * bf16: tensor cores through WMMA (16x16x16 bf16 -> fp32). A block owns
//     a 128-pixel x 128-channel output tile; 8 warps each hold a 32 x 64
//     fp32 accumulator tile in registers.
//   * fp32: CUDA-core FMAs (no TF32: the port holds fp32 to the plain
//     version at 1e-4), 64 x 64 tiles, 4 x 4 outputs per thread.
//   * K is walked tap by tap (dy, dx) in BK-channel slices; the A tile is
//     gathered straight from x (im2col on the fly) with 16-byte cp.async,
//     whose zero-fill form supplies the SAME padding and the ragged M edge.
//     Two shared-memory stages overlap the next slice's loads with the
//     current slice's math.
//   * The weights arrive pre-reordered as a K x N row-major matrix
//     ((3,3,C,C) HWIO, cast to x's dtype once by the caller and cached).
//   * The epilogue (bias, scale/shift, SiLU, x0.1, residual, cast) runs on
//     the fp32 accumulators before the single store of the output tile.
// wgmma/TMA and a single-launch block are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kModeConv1 = 1;  // bias, scale/shift, SiLU
constexpr int kModeConv2 = 2;  // bias, x0.1, residual

__device__ __forceinline__ void cp_async16(void* smem_ptr, const void* gmem_ptr,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem_ptr));
  const int src_bytes = valid ? 16 : 0;  // 0 bytes read -> 16 zero bytes written
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem_ptr), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// The fp32 epilogue shared by both element types; mirrors the plain version
// in hicdiff_tpu_torch/kernels/resblock.py operation for operation.
template <int MODE>
__device__ __forceinline__ float epilogue(float acc, float bias, float scale,
                                          float shift, float res) {
  float v = acc + bias;
  if (MODE == kModeConv1) {
    v = v * (scale + 1.0f) + shift;
    return v / (1.0f + expf(-v));  // SiLU
  }
  return v * 0.1f + res;
}

// Source row of the implicit GEMM's A operand: output pixel m shifted by the
// tap (dy, dx) in {-1, 0, 1}^2. Returns false where the tap falls into the
// zero padding or m is past the end.
struct PixelRow {
  long long offset;  // m * C
  int h, w;
  bool in_range;
};

__device__ __forceinline__ PixelRow pixel_row(int m, int M, int H, int W, int C) {
  PixelRow r;
  r.in_range = m < M;
  const int mm = r.in_range ? m : 0;
  const int hw = mm % (H * W);
  r.h = hw / W;
  r.w = hw % W;
  r.offset = static_cast<long long>(mm) * C;
  return r;
}

template <typename T>
__device__ __forceinline__ const T* tap_source(const T* x, const PixelRow& r, int dy,
                                               int dx, int H, int W, int C, int col,
                                               bool* valid) {
  const int hs = r.h + dy, ws = r.w + dx;
  *valid = r.in_range && hs >= 0 && hs < H && ws >= 0 && ws < W;
  return *valid ? x + r.offset + (static_cast<long long>(dy) * W + dx) * C + col : x;
}

// ------------------------------------------------------------------ bf16 path
namespace bf16cfg {
constexpr int BM = 128, BN = 128, BK = 32;
constexpr int LDA = BK + 8;   // 80-byte rows: 16-byte aligned, WMMA ldm % 8 == 0
constexpr int LDB = BN + 8;   // 272-byte rows
constexpr int LDC = BN + 4;   // fp32 epilogue staging, 528-byte rows
constexpr int kSmemAB = 2 * (BM * LDA + BK * LDB) * 2;
constexpr int kSmemC = BM * LDC * 4;
constexpr int kSmem = kSmemAB > kSmemC ? kSmemAB : kSmemC;
}  // namespace bf16cfg

template <int MODE>
__global__ void __launch_bounds__(kThreads)
    conv3x3_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                        const __nv_bfloat16* __restrict__ wt,
                        const __nv_bfloat16* __restrict__ bias,
                        const __nv_bfloat16* __restrict__ scale,
                        const __nv_bfloat16* __restrict__ shift, long long ss_stride,
                        const __nv_bfloat16* __restrict__ res,
                        __nv_bfloat16* __restrict__ out, int B, int H, int W, int C) {
  using namespace bf16cfg;
  namespace wmma = nvcuda::wmma;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);  // [2][BM][LDA]
  __nv_bfloat16* Bs = As + 2 * BM * LDA;                         // [2][BK][LDB]
  float* Cs = reinterpret_cast<float*>(smem);                    // [BM][LDC], after the K loop

  const int tid = threadIdx.x;
  const int M = B * H * W;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int kslices = C / BK;
  const int ksteps = 9 * kslices;

  // A tile: BM rows x BK bf16 = 4 16-byte chunks per row, 2 chunks per thread.
  const int a_col = (tid & 3) * 8;
  int a_row[2];
  PixelRow a_src[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    a_row[i] = (tid + i * kThreads) >> 2;
    a_src[i] = pixel_row(m0 + a_row[i], M, H, W, C);
  }

  auto load_stage = [&](int stage, int ks) {
    const int tap = ks / kslices;
    const int ci0 = (ks - tap * kslices) * BK;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    __nv_bfloat16* as = As + stage * BM * LDA;
    __nv_bfloat16* bs = Bs + stage * BK * LDB;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      bool valid;
      const __nv_bfloat16* src =
          tap_source(x, a_src[i], dy, dx, H, W, C, ci0 + a_col, &valid);
      cp_async16(as + a_row[i] * LDA + a_col, src, valid);
    }
    // B tile: BK rows x BN bf16 = 16 chunks per row, 2 chunks per thread.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kThreads;
      const int br = c >> 4, bc = (c & 15) * 8;
      const __nv_bfloat16* src =
          wt + static_cast<long long>(tap * C + ci0 + br) * C + n0 + bc;
      cp_async16(bs + br * LDB + bc, src, true);
    }
  };

  const int warp = tid >> 5;
  const int wm = warp >> 1;  // 4 warps along M, 32 rows each
  const int wn = warp & 1;   // 2 warps along N, 64 columns each
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  load_stage(0, 0);
  cp_async_commit();
  for (int ks = 0; ks < ksteps; ++ks) {
    if (ks + 1 < ksteps) load_stage((ks + 1) & 1, ks + 1);
    cp_async_commit();  // possibly empty: keeps the group count uniform
    cp_async_wait_one();
    __syncthreads();
    const __nv_bfloat16* as = As + (ks & 1) * BM * LDA;
    const __nv_bfloat16* bs = Bs + (ks & 1) * BK * LDB;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], as + (wm * 32 + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(fb[j], bs + kk * LDB + wn * 64 + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }
  cp_async_wait_all();
  __syncthreads();

  // Stage the fp32 accumulators through shared memory (WMMA's register
  // layout is opaque), then apply the epilogue 8 channels per thread-step.
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * LDC + wn * 64 + j * 16,
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();

  const int HW = H * W;
  for (int v = tid; v < BM * BN / 8; v += kThreads) {
    const int row = v >> 4;
    const int col = (v & 15) * 8;
    const int m = m0 + row;
    if (m >= M) continue;
    const int n = n0 + col;
    const int b = m / HW;
    const float* cs = Cs + row * LDC + col;
    const uint4 bias8 = *reinterpret_cast<const uint4*>(bias + n);
    const __nv_bfloat16* bias_h = reinterpret_cast<const __nv_bfloat16*>(&bias8);
    uint4 out8;
    __nv_bfloat16* out_h = reinterpret_cast<__nv_bfloat16*>(&out8);
    if (MODE == kModeConv1) {
      const uint4 sc8 = *reinterpret_cast<const uint4*>(scale + b * ss_stride + n);
      const uint4 sh8 = *reinterpret_cast<const uint4*>(shift + b * ss_stride + n);
      const __nv_bfloat16* sc_h = reinterpret_cast<const __nv_bfloat16*>(&sc8);
      const __nv_bfloat16* sh_h = reinterpret_cast<const __nv_bfloat16*>(&sh8);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        out_h[e] = __float2bfloat16(epilogue<MODE>(cs[e], __bfloat162float(bias_h[e]),
                                                   __bfloat162float(sc_h[e]),
                                                   __bfloat162float(sh_h[e]), 0.0f));
    } else {
      const uint4 r8 =
          *reinterpret_cast<const uint4*>(res + static_cast<long long>(m) * C + n);
      const __nv_bfloat16* r_h = reinterpret_cast<const __nv_bfloat16*>(&r8);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        out_h[e] = __float2bfloat16(epilogue<MODE>(cs[e], __bfloat162float(bias_h[e]),
                                                   0.0f, 0.0f, __bfloat162float(r_h[e])));
    }
    *reinterpret_cast<uint4*>(out + static_cast<long long>(m) * C + n) = out8;
  }
}

// ------------------------------------------------------------------ fp32 path
namespace f32cfg {
constexpr int BM = 64, BN = 64, BK = 16;
constexpr int LDA = BK + 4;  // 80-byte rows
constexpr int LDB = BN + 4;  // 272-byte rows
}  // namespace f32cfg

template <int MODE>
__global__ void __launch_bounds__(kThreads)
    conv3x3_f32_kernel(const float* __restrict__ x, const float* __restrict__ wt,
                       const float* __restrict__ bias, const float* __restrict__ scale,
                       const float* __restrict__ shift, long long ss_stride,
                       const float* __restrict__ res, float* __restrict__ out, int B,
                       int H, int W, int C) {
  using namespace f32cfg;
  __shared__ __align__(16) float As[2][BM * LDA];
  __shared__ __align__(16) float Bs[2][BK * LDB];

  const int tid = threadIdx.x;
  const int M = B * H * W;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int kslices = C / BK;
  const int ksteps = 9 * kslices;

  // A tile: BM rows x BK floats = 4 chunks per row, one chunk per thread.
  const int a_row = tid >> 2, a_col = (tid & 3) * 4;
  const PixelRow a_src = pixel_row(m0 + a_row, M, H, W, C);
  // B tile: BK rows x BN floats = 16 chunks per row, one chunk per thread.
  const int b_row = tid >> 4, b_col = (tid & 15) * 4;

  auto load_stage = [&](int stage, int ks) {
    const int tap = ks / kslices;
    const int ci0 = (ks - tap * kslices) * BK;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    bool valid;
    const float* src = tap_source(x, a_src, dy, dx, H, W, C, ci0 + a_col, &valid);
    cp_async16(&As[stage][a_row * LDA + a_col], src, valid);
    cp_async16(&Bs[stage][b_row * LDB + b_col],
               wt + static_cast<long long>(tap * C + ci0 + b_row) * C + n0 + b_col, true);
  };

  // Thread (ty, tx) owns rows ty + 16 i and columns 4 tx .. 4 tx + 3.
  const int tx = tid & 15, ty = tid >> 4;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  load_stage(0, 0);
  cp_async_commit();
  for (int ks = 0; ks < ksteps; ++ks) {
    if (ks + 1 < ksteps) load_stage((ks + 1) & 1, ks + 1);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const float* as = As[ks & 1];
    const float* bs = Bs[ks & 1];
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 b4 = *reinterpret_cast<const float4*>(bs + k * LDB + tx * 4);
      const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = as[(ty + 16 * i) * LDA + k];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a, bv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
  cp_async_wait_all();

  const int HW = H * W;
  const int n = n0 + tx * 4;
  const float4 bias4 = *reinterpret_cast<const float4*>(bias + n);
  const float bias_v[4] = {bias4.x, bias4.y, bias4.z, bias4.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
    const int b = m / HW;
    float sc[4] = {0.f, 0.f, 0.f, 0.f}, sh[4] = {0.f, 0.f, 0.f, 0.f},
          r[4] = {0.f, 0.f, 0.f, 0.f};
    if (MODE == kModeConv1) {
      const float4 s4 = *reinterpret_cast<const float4*>(scale + b * ss_stride + n);
      const float4 h4 = *reinterpret_cast<const float4*>(shift + b * ss_stride + n);
      sc[0] = s4.x; sc[1] = s4.y; sc[2] = s4.z; sc[3] = s4.w;
      sh[0] = h4.x; sh[1] = h4.y; sh[2] = h4.z; sh[3] = h4.w;
    } else {
      const float4 r4 =
          *reinterpret_cast<const float4*>(res + static_cast<long long>(m) * C + n);
      r[0] = r4.x; r[1] = r4.y; r[2] = r4.z; r[3] = r4.w;
    }
    float o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) o[j] = epilogue<MODE>(acc[i][j], bias_v[j], sc[j], sh[j], r[j]);
    *reinterpret_cast<float4*>(out + static_cast<long long>(m) * C + n) =
        make_float4(o[0], o[1], o[2], o[3]);
  }
}

}  // namespace

// C interface, loaded with ctypes by hicdiff_tpu_torch/kernels/resblock.py.
// The caller has checked shapes (C % 128 == 0), dtypes, contiguity and
// 16-byte alignment. Returns cudaGetLastError() after the launch.
extern "C" int hicdiff_conv3x3_bf16(const void* x, const void* wt, const void* bias,
                                    const void* scale, const void* shift,
                                    long long ss_stride, const void* res, void* out,
                                    int B, int H, int W, int C, int mode,
                                    void* stream) {
  using namespace bf16cfg;
  const int M = B * H * W;
  const dim3 grid((M + BM - 1) / BM, C / BN);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto kernel) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return e;
    kernel<<<grid, kThreads, kSmem, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(wt),
        static_cast<const __nv_bfloat16*>(bias), static_cast<const __nv_bfloat16*>(scale),
        static_cast<const __nv_bfloat16*>(shift), ss_stride,
        static_cast<const __nv_bfloat16*>(res), static_cast<__nv_bfloat16*>(out), B, H, W,
        C);
    return cudaGetLastError();
  };
  if (mode == kModeConv1) return static_cast<int>(launch(conv3x3_bf16_kernel<kModeConv1>));
  if (mode == kModeConv2) return static_cast<int>(launch(conv3x3_bf16_kernel<kModeConv2>));
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int hicdiff_conv3x3_f32(const void* x, const void* wt, const void* bias,
                                   const void* scale, const void* shift,
                                   long long ss_stride, const void* res, void* out, int B,
                                   int H, int W, int C, int mode, void* stream) {
  using namespace f32cfg;
  const int M = B * H * W;
  const dim3 grid((M + BM - 1) / BM, C / BN);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto kernel) {
    kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(wt),
        static_cast<const float*>(bias), static_cast<const float*>(scale),
        static_cast<const float*>(shift), ss_stride, static_cast<const float*>(res),
        static_cast<float*>(out), B, H, W, C);
    return cudaGetLastError();
  };
  if (mode == kModeConv1) return static_cast<int>(launch(conv3x3_f32_kernel<kModeConv1>));
  if (mode == kModeConv2) return static_cast<int>(launch(conv3x3_f32_kernel<kModeConv2>));
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* hicdiff_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
