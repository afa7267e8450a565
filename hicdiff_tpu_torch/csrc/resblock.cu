// One 3x3 convolution of the hicedrn residual block as an implicit GEMM with
// a fused epilogue, NHWC, C_in == C_out == C.
//
// Replaces: hicdiff_tpu/kernels/resblock.py:fused_resblock, the Pallas TPU
// kernel that computes y = conv(silu(conv(x) * (scale + 1) + shift)) * 0.1 + x
// with ONE shared conv applied twice. Here the block is two launches of the
// kernels below (hicdiff_tpu_torch/kernels/resblock.py drives them):
//   mode 1: h = cast(silu((conv(x) + bias) * (scale[b] + 1) + shift[b]))
//   mode 2: y = cast((conv(h) + bias) * 0.1 + x)
// Two launches give conv #2 its SAME zero padding for free: h is complete in
// device memory before conv #2 reads its halo, so the TPU kernel's halo
// recompute and its padding mask have no counterpart here. One launch would
// have to recompute conv #1 on a halo, which doubles its FLOPs at the 2-row
// tiles that fit in shared memory; h's round trip (2 x 16.8 MB at the main
// shape, mostly served by the 50 MB L2) costs ~0.01 ms against a 0.078 ms
// compute bound.
//
// What bounds it on the H100: compute. Per conv, M = B*H*W output pixels,
// N = C output channels, K = 9*C, so at B=8, 64x64, C=256 one conv is
// 38.7 GFLOP against 2 * 16.8 MB of activations and 1.2 MB of bf16 weights:
// ~1100 FLOP per byte, far above the card's ~295 FLOP/byte ridge.
//
// What the design does about it:
//   * bf16 (the served path): TMA, an mbarrier ring and wgmma.
//     - A block owns 2 output rows x 64 columns of one image (128 pixels) x
//       256 output channels. Where C % 256 != 0 the last channel tile runs
//       half empty: TMA zero-fills the weight rows past C, and the epilogue
//       neither reads nor stores channels past C. One tile shape serves
//       every C that is a multiple of 128.
//     - A operand without im2col: per k-block (one tap (dy, dx), 64 input
//       channels) ONE 4-D TMA box (64 c, 64 w, 2 h, 1 b) of the input. TMA
//       zero-fills coordinates outside the tensor, negative ones included:
//       that is the SAME padding, and the ragged H and W edges. The box lands
//       as [h][w][c] in 128-byte rows, the tile's M order, 128B-swizzled as
//       wgmma reads it. K = 9 taps x C / 64 slices: 36 k-blocks at C = 256.
//     - B operand: the weight packed once per weight update into an N x K,
//       K-major matrix [co][ky][kx][ci] (kernels/resblock.py:
//       pack_conv_weight), one 2-D TMA box (64 k, 256 n) per k-block.
//     - A ring of 3 stages with full and empty mbarriers (48 KB each).
//       One producer warp issues the TMA loads; two consumer warpgroups, one
//       per output row, run wgmma m64 x n256 x k16 (bf16 -> fp32 registers),
//       keeping one k-block of products in flight while the next lands.
//     - 288 threads (no third full warpgroup), so every thread may hold 224
//       registers without setmaxnreg: room for the 128 fp32 accumulators.
//     - The epilogue runs on the accumulator registers, writes bf16 into a
//       swizzled shared tile (mode 2 first reads the residual there, loaded
//       by TMA during the main loop) and leaves by TMA stores, which write
//       only the in-bounds part of a box.
//   * fp32: CUDA-core FMAs (no TF32: the port holds fp32 to the plain
//     version at 1e-4), 64 x 64 tiles, 4 x 4 outputs per thread. K is walked
//     tap by tap in 16-channel slices; the A tile is gathered straight from
//     x (im2col on the fly) with 16-byte cp.async, whose zero-fill form
//     supplies the SAME padding and the ragged M edge, into two stages. The
//     weights are the HWIO kernel as a K x N row-major matrix.
//   * Both epilogues (bias, scale/shift, SiLU, x0.1, residual, cast) run on
//     the fp32 accumulators, the same operations in the same order as the
//     plain version, before the single store of the output tile.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include <atomic>

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
constexpr int kBK = 64;      // K per k-block: one tap x 64 channels = one 128-byte row
constexpr int kBN = 256;     // output channels per tile = wgmma N
constexpr int kTileW = 64;   // output columns per tile = wgmma M of one warpgroup
constexpr int kTileH = 2;    // output rows per tile, one per consumer warpgroup
constexpr int kConsumerWarps = 4 * kTileH;
constexpr int kBlockThreads = 32 * kConsumerWarps + 32;  // + the producer warp
constexpr int kBoxBytes = kTileW * kBK * 2;              // one (64 c, 64 w) box: 8 KB
constexpr int kABytes = kTileH * kBoxBytes;              // the A tile [h][w][c]: 16 KB

constexpr int kStages = 3;
// Byte offsets into the 1024-aligned dynamic shared memory. Every tile that
// wgmma or TMA reads with the 128-byte swizzle starts on a 1024-byte boundary.
constexpr int kStageBytes = kABytes + kBN * kBK * 2;  // A tile + B tile [n][k]
constexpr int kRowBytes = kTileW * kBN * 2;           // one output row of the tile
constexpr int kEpi = kStages * kStageBytes;           // [row][kBN / 64][64 w][64 c]
constexpr int kParams = kEpi + kTileH * kRowBytes;    // bias, scale, shift: fp32
constexpr int kBars = kParams + 3 * kBN * 4;          // full[S], empty[S], res[rows]
constexpr int kSmemBytes = kBars + (2 * kStages + kTileH) * 8 + 1024;  // + align slack
}  // namespace bf16cfg

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Arrive and announce `bytes` of TMA transfers that complete the phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::
          "l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma descriptor of a K-major tile with the 128-byte swizzle: 128-byte rows
// in 8-row (1024-byte) swizzle atoms, atoms 1024 bytes apart (SBO = 64 x 16
// bytes); LBO is unused for this layout. A k16 step inside the 64-wide row is
// a +32-byte start address: the swizzle is a function of the address bits.
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  return (static_cast<uint64_t>(smem_u32(p) & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator accesses across the async wgmma.
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D(64 x 256, fp32 registers) += A(64 x 16, smem) * B(16 x 256, smem), both K-major.
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t desc_a,
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// One block: output rows h0, h0 + 1, columns w0 .. w0 + 63 of image b,
// channels n0 .. min(n0 + 256, C) - 1. Warps 0-7 are two consumer warpgroups
// (row h0 + warp / 4 each); warp 8 is the producer.
template <int MODE>
__global__ void __launch_bounds__(bf16cfg::kBlockThreads, 1)
    conv3x3_bf16_kernel(__grid_constant__ const CUtensorMap map_in,   // A: x or h, box (64,64,2,1)
                        __grid_constant__ const CUtensorMap map_w,    // B: (C, 9C), box (64, 256)
                        __grid_constant__ const CUtensorMap map_res,  // residual, box (64,64,1,1)
                        __grid_constant__ const CUtensorMap map_out,  // out, box (64,64,1,1)
                        const __nv_bfloat16* __restrict__ bias,
                        const __nv_bfloat16* __restrict__ scale,
                        const __nv_bfloat16* __restrict__ shift, long long ss_stride, int H,
                        int W, int C) {
  using namespace bf16cfg;
  constexpr int BN = kBN;
  constexpr int S = kStages;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* s_bias = reinterpret_cast<float*>(smem + kParams);
  float* s_scale = s_bias + BN;
  float* s_shift = s_scale + BN;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kBars);
  uint64_t* empty = full + S;
  uint64_t* res_ready = empty + S;

  const int tiles_w = (W + kTileW - 1) / kTileW;
  const int tiles_h = (H + kTileH - 1) / kTileH;
  const int w0 = (blockIdx.x % tiles_w) * kTileW;
  const int h0 = (blockIdx.x / tiles_w % tiles_h) * kTileH;
  const int b = blockIdx.x / (tiles_w * tiles_h);
  const int n0 = blockIdx.y * BN;
  const int boxes = min(BN, C - n0) / 64;  // 64-channel boxes of the tile inside C
  const int kslices = C / kBK;
  const int kblocks = 9 * kslices;

  // b is uniform in the tile: its bias, scale and shift are loaded once;
  // channels past C get zeros and are never stored
  for (int i = threadIdx.x; i < BN; i += kBlockThreads) {
    const bool in_c = n0 + i < C;
    s_bias[i] = in_c ? __bfloat162float(bias[n0 + i]) : 0.0f;
    if (MODE == kModeConv1) {
      s_scale[i] = in_c ? __bfloat162float(scale[b * ss_stride + n0 + i]) : 0.0f;
      s_shift[i] = in_c ? __bfloat162float(shift[b * ss_stride + n0 + i]) : 0.0f;
    }
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);                // the producer's arrive + the stage's bytes
      mbar_init(&empty[s], kConsumerWarps);  // one arrive per consumer warp
    }
    for (int r = 0; r < kTileH; ++r) mbar_init(&res_ready[r], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == kConsumerWarps) {
    // producer: one thread keeps the ring full. k-block kb is tap kb / kslices
    // (dy, dx) = (tap / 3 - 1, tap % 3 - 1) and input channels c0 .. c0 + 63;
    // the A box at (c0, w0 + dx, h0 + dy, b) is zero-filled outside the
    // tensor, which is the SAME padding and the ragged edge; so are the
    // weight rows past C. The zero fill counts toward the stage's bytes.
    if (lane == 0) {
      for (int kb = 0; kb < kblocks; ++kb) {
        const int s = kb % S;
        mbar_wait(&empty[s], ((kb / S) & 1) ^ 1);
        unsigned char* stage = smem + s * kStageBytes;
        const int tap = kb / kslices;
        mbar_arrive_expect_tx(&full[s], kStageBytes);
        tma_load_4d(stage, &map_in, &full[s], (kb - tap * kslices) * kBK, w0 + tap % 3 - 1,
                    h0 + tap / 3 - 1, b);
        tma_load_2d(stage + kABytes, &map_w, &full[s], kb * kBK, n0);
      }
    }
  } else {
    const int row = warp / 4;  // this warpgroup's output row: h0 + row
    unsigned char* epi = smem + kEpi + row * kRowBytes;
    if (MODE == kModeConv2 && threadIdx.x % 128 == 0) {
      // the residual tile lands while the main loop runs
      mbar_arrive_expect_tx(&res_ready[row], boxes * kBoxBytes);
      for (int j = 0; j < boxes; ++j)
        tma_load_4d(epi + j * kBoxBytes, &map_res, &res_ready[row], n0 + j * 64, w0, h0 + row,
                    b);
    }

    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
    for (int kb = 0; kb < kblocks; ++kb) {
      const int s = kb % S;
      mbar_wait(&full[s], (kb / S) & 1);
      const unsigned char* a = smem + s * kStageBytes + row * kBoxBytes;
      const unsigned char* bt = smem + s * kStageBytes + kABytes;
      fence_operands(acc);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < kBK / 16; ++k)
        wgmma_m64n256k16(acc, smem_desc(a + 32 * k), smem_desc(bt + 32 * k));
      wgmma_commit();
      wgmma_wait<1>();  // k-block kb - 1 is done with its stage; kb stays in flight
      fence_operands(acc);
      if (kb > 0 && lane == 0) mbar_arrive(&empty[(kb - 1) % S]);
    }
    wgmma_wait<0>();
    fence_operands(acc);

    // Epilogue. Accumulator acc[4j + 2 half + e] of thread (warp, lane) is
    // tile row 16 (warp % 4) + lane / 4 + 8 half, channel 8 j + 2 (lane % 4) + e.
    // It goes, as bf16, into the (64 w, 64 c) box j / 8 of this row at
    // 128-byte line w, 16-byte chunk (j % 8) ^ (w % 8): TMA's 128-byte swizzle.
    const int r8 = lane / 4;
    const int q = lane % 4;
    const int w_lo = (warp % 4) * 16 + r8;
    if (MODE == kModeConv2) mbar_wait(&res_ready[row], 0);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = j * 8 + q * 2;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int w = w_lo + 8 * half;
        __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(
            epi + (j / 8) * kBoxBytes + w * 128 + (((j % 8) ^ r8) * 16) + q * 4);
        float v0 = acc[4 * j + 2 * half], v1 = acc[4 * j + 2 * half + 1];
        if (MODE == kModeConv1) {
          v0 = epilogue<MODE>(v0, s_bias[n], s_scale[n], s_shift[n], 0.0f);
          v1 = epilogue<MODE>(v1, s_bias[n + 1], s_scale[n + 1], s_shift[n + 1], 0.0f);
        } else {
          const float2 r = __bfloat1622float2(*p);
          v0 = epilogue<MODE>(v0, s_bias[n], 0.0f, 0.0f, r.x);
          v1 = epilogue<MODE>(v1, s_bias[n + 1], 0.0f, 0.0f, r.y);
        }
        *p = __floats2bfloat162_rn(v0, v1);
      }
    }
    // make the generic-proxy writes visible to TMA, then one thread stores
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + row) : "memory");
    if (threadIdx.x % 128 == 0) {
      for (int j = 0; j < boxes; ++j)
        tma_store_4d(&map_out, epi + j * kBoxBytes, n0 + j * 64, w0, h0 + row, b);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
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

// ------------------------------------------------------------------ host side
namespace {

constexpr int kErrNoEncoder = -1;  // returned codes below 0 are this file's own
constexpr int kErrEncode = -2;

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's tensor-map encoder, looked up in the driver library that the
// CUDA runtime has loaded already, so the kernels need not link libcuda.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib == nullptr ? nullptr
                          : reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

bool encode(CUtensorMap* map, const void* ptr, cuuint32_t rank, const cuuint64_t* dims,
            const cuuint64_t* strides, const cuuint32_t* box) {
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr),
                        dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// (B, H, W, C) bf16 as the 4-D map (C, W, H, B), box (64 c, 64 w, rows h, 1 b).
// Out-of-bounds elements load as zeros and are not stored.
bool encode_nhwc(CUtensorMap* map, const void* ptr, int B, int H, int W, int C, int rows) {
  const cuuint64_t dims[4] = {cuuint64_t(C), cuuint64_t(W), cuuint64_t(H), cuuint64_t(B)};
  const cuuint64_t row = 2ull * C;
  const cuuint64_t strides[3] = {row, row * W, row * W * H};
  const cuuint32_t box[4] = {bf16cfg::kBK, bf16cfg::kTileW, cuuint32_t(rows), 1};
  return encode(map, ptr, 4, dims, strides, box);
}

// The packed weight (C, 9C) as the 2-D map (9C, C), box (64 k, 256 n).
bool encode_weight(CUtensorMap* map, const void* ptr, int C) {
  const cuuint64_t dims[2] = {9ull * C, cuuint64_t(C)};
  const cuuint64_t strides[1] = {18ull * C};
  const cuuint32_t box[2] = {bf16cfg::kBK, bf16cfg::kBN};
  return encode(map, ptr, 2, dims, strides, box);
}

// The kernel needs more than 48 KB of dynamic shared memory, which each
// device allows once per kernel: the first launch on a device sets it.
template <int MODE>
cudaError_t launch_bf16(const CUtensorMap& in, const CUtensorMap& wt, const CUtensorMap& res,
                        const CUtensorMap& out, const void* bias, const void* scale,
                        const void* shift, long long ss_stride, int B, int H, int W, int C,
                        cudaStream_t stream) {
  using namespace bf16cfg;
  auto kernel = conv3x3_bf16_kernel<MODE>;
  static std::atomic<uint64_t> smem_set{0};  // bit d: done on device d (d < 64)
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  const uint64_t bit = device < 64 ? 1ull << device : 0;
  if (!(smem_set.load(std::memory_order_relaxed) & bit)) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (e != cudaSuccess) return e;
    smem_set.fetch_or(bit, std::memory_order_relaxed);
  }
  const dim3 grid(B * ((H + kTileH - 1) / kTileH) * ((W + kTileW - 1) / kTileW),
                  (C + kBN - 1) / kBN);
  kernel<<<grid, kBlockThreads, kSmemBytes, stream>>>(
      in, wt, res, out, static_cast<const __nv_bfloat16*>(bias),
      static_cast<const __nv_bfloat16*>(scale), static_cast<const __nv_bfloat16*>(shift),
      ss_stride, H, W, C);
  return cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes by hicdiff_tpu_torch/kernels/resblock.py.
// The caller has checked shapes (C % 128 == 0, B, H, W >= 1), dtypes,
// contiguity and 16-byte alignment. `wt` is the packed weight (C, 9C),
// rows co, columns [ky][kx][ci]. Returns cudaGetLastError() after the
// launch, or a negative code of this file (hicdiff_cuda_error_string).
extern "C" int hicdiff_conv3x3_bf16(const void* x, const void* wt, const void* bias,
                                    const void* scale, const void* shift,
                                    long long ss_stride, const void* res, void* out,
                                    int B, int H, int W, int C, int mode,
                                    void* stream) {
  if (mode != kModeConv1 && mode != kModeConv2) return static_cast<int>(cudaErrorInvalidValue);
  if (encode_tiled() == nullptr) return kErrNoEncoder;
  CUtensorMap m_in, m_wt, m_res, m_out;
  if (!encode_nhwc(&m_in, x, B, H, W, C, bf16cfg::kTileH) || !encode_weight(&m_wt, wt, C) ||
      !encode_nhwc(&m_out, out, B, H, W, C, 1))
    return kErrEncode;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == kModeConv1)  // conv #1 reads no residual: its map goes unused
    return static_cast<int>(launch_bf16<kModeConv1>(m_in, m_wt, m_out, m_out, bias, scale,
                                                    shift, ss_stride, B, H, W, C, s));
  if (!encode_nhwc(&m_res, res, B, H, W, C, 1)) return kErrEncode;
  return static_cast<int>(launch_bf16<kModeConv2>(m_in, m_wt, m_res, m_out, bias, scale, shift,
                                                  ss_stride, B, H, W, C, s));
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
  if (code == kErrNoEncoder) return "cuTensorMapEncodeTiled not found in libcuda.so.1";
  if (code == kErrEncode) return "cuTensorMapEncodeTiled rejected a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
