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
// What bounds it on the H100: tensor-core operations. Per conv, M = B*H*W
// output pixels, N = C output channels, K = 9*C, so at B=8, 64x64, C=256 one
// conv is 38.7 GFLOP against 2 * 16.8 MB of bf16 activations and 1.2 MB of
// weights: ~1100 FLOP per byte, far above the card's ~295 FLOP/byte ridge.
// fp32 runs each product three times (3xTF32, below): 3 x 77.3 GFLOP per
// block at 495 TFLOP/s is 0.469 ms, against 1.154 ms for the same block in
// CUDA-core FMAs at 67 TFLOP/s, which is why fp32 runs on the tensor cores.
//
// What the design does about it. Both element types share one skeleton:
//   * A block owns 2 output rows x 64 columns of one image (128 pixels) x
//     BN output channels (256 in bf16, 128 in fp32). Where C % BN != 0 the
//     last channel tile runs half empty: TMA zero-fills the weight rows past
//     C, and the epilogue neither reads nor stores channels past C. One tile
//     shape per element type serves every C that is a multiple of 128.
//   * A operand without im2col: per k-block (one tap (dy, dx) and one
//     128-byte row of input channels: 64 bf16 or 32 fp32) ONE 4-D TMA box
//     (128 B of c, 64 w, 2 h, 1 b) of the input. TMA zero-fills coordinates
//     outside the tensor, negative ones included: that is the SAME padding,
//     and the ragged H and W edges. The box lands as [h][w][c] in 128-byte
//     rows, the tile's M order, 128B-swizzled as wgmma reads it.
//   * B operand: the weight packed once per weight update into an N x K,
//     K-major matrix [co][ky][kx][ci] (kernels/resblock.py: pack_conv_weight,
//     prepare_weight), one 3-D TMA box (128 B of k, BN n, 1 plane) per
//     k-block and plane.
//   * A ring of stages with full and empty mbarriers. One producer warp
//     issues the TMA loads; two consumer warpgroups, one per output row, run
//     wgmma m64 x nBN into fp32 accumulators, keeping one k-block of
//     products in flight while the next lands.
//   * 288 threads (no third full warpgroup), so every thread may hold 224
//     registers without setmaxnreg.
//   * Both epilogues (bias, scale/shift, SiLU, x0.1, residual, cast) run on
//     the fp32 accumulators, the same operations in the same order as the
//     plain version, before the single store of the output tile.
// bf16 (conv3x3_bf16_kernel): k16 steps of bf16 products, 3 stages of 48 KB;
//   the epilogue writes a swizzled shared tile (mode 2 first reads the
//   residual there, loaded by TMA during the main loop) and leaves by TMA
//   stores, which write only the in-bounds part of a box.
// fp32 (conv3x3_3xtf32_kernel): one TF32 product keeps ~3 decimal digits,
//   short of the 1e-4 the port holds fp32 to. Three products do:
//     a * b ~= a_lo * b_hi + a_hi * b_lo + a_hi * b_hi,
//     hi = tf32(v), lo = tf32(v - hi), tf32 = round to nearest, ties away.
//   The dropped a_lo * b_lo and the rounding of lo are each below
//   2^-22 |a||b|. Both halves are made explicitly (the low 13 bits of every
//   operand word are zero), so nothing depends on how the tensor core reads
//   an fp32 word. The weight's hi and lo are packed once per weight update
//   as two planes (2, C, 9C). The A box is split inside the kernel: after
//   the full barrier each consumer warpgroup rounds its own 64-row half in
//   place to hi and writes lo to a second buffer at the same offsets (the
//   split is elementwise, so the swizzle does not matter), then fences the
//   writes to the async proxy and meets its 128 threads at a named barrier
//   before its wgmmas. So conv #2 reads conv #1's fp32 output as it is: no
//   split pre-pass and no third launch. Per k8 step (32 bytes, the same
//   descriptor step as bf16's k16) three wgmma m64n128k8.tf32, small terms
//   first, into one set of accumulators. A stage is A 16 KB + A_lo 16 KB +
//   B_hi 16 KB + B_lo 16 KB = 64 KB, so 3 stages fit. A 256-channel tile
//   (96 KB stages, so only 2) reads 17 % fewer bytes per FLOP from L2 but
//   measured 14 % slower on the H100 at the main shape: with two stages the
//   next k-block's loads are not in flight long enough to land. The
//   epilogue stores from registers straight to device memory (mode 2 reads
//   its residual the same way), so the ring never has to hold an fp32
//   output tile.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kModeConv1 = 1;  // bias, scale/shift, SiLU
constexpr int kModeConv2 = 2;  // bias, x0.1, residual

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

// The tile both kernels share (see the note at the top); the number of
// output channels per tile (wgmma N) is each kernel's own.
constexpr int kTileW = 64;   // output columns per tile = wgmma M of one warpgroup
constexpr int kTileH = 2;    // output rows per tile, one per consumer warpgroup
constexpr int kConsumerWarps = 4 * kTileH;
constexpr int kBlockThreads = 32 * kConsumerWarps + 32;  // + the producer warp
constexpr int kRowBytes = 128;  // K per k-block: one 128-byte swizzle row of channels
constexpr int kBoxBytes = kTileW * kRowBytes;  // one (128 B c, 64 w) box: 8 KB
constexpr int kABytes = kTileH * kBoxBytes;    // the A tile [h][w][c]: 16 KB

// ------------------------------------------------------------------ bf16 path
namespace bf16cfg {
constexpr int kBN = 256;                  // output channels per tile
constexpr int kBBytes = kBN * kRowBytes;  // one B tile [n][k]: 32 KB
constexpr int kBK = kRowBytes / 2;        // 64 channels per k-block
constexpr int kStages = 3;
// Byte offsets into the 1024-aligned dynamic shared memory. Every tile that
// wgmma or TMA reads with the 128-byte swizzle starts on a 1024-byte boundary.
constexpr int kStageBytes = kABytes + kBBytes;        // A tile + B tile [n][k]
constexpr int kOutRowBytes = kTileW * kBN * 2;        // one output row of the tile
constexpr int kEpi = kStages * kStageBytes;           // [row][kBN / 64][64 w][64 c]
constexpr int kParams = kEpi + kTileH * kOutRowBytes;  // bias, scale, shift: fp32
constexpr int kBars = kParams + 3 * kBN * 4;          // full[S], empty[S], res[rows]
constexpr int kSmemBytes = kBars + (2 * kStages + kTileH) * 8 + 1024;  // + align slack
}  // namespace bf16cfg

// ------------------------------------------------------------------ fp32 path
namespace f32cfg {
constexpr int kBN = 128;                  // output channels per tile
constexpr int kBBytes = kBN * kRowBytes;  // one B tile [n][k] of one plane: 16 KB
constexpr int kBK = kRowBytes / 4;        // 32 channels per k-block
constexpr int kStages = 3;
// A stage: A (split in place to its hi part), A_lo, B_hi, B_lo.
constexpr int kALo = kABytes;
constexpr int kBHi = 2 * kABytes;
constexpr int kBLo = kBHi + kBBytes;
constexpr int kStageBytes = kBLo + kBBytes;       // 64 KB
constexpr int kParams = kStages * kStageBytes;    // bias, scale, shift: fp32
constexpr int kBars = kParams + 3 * kBN * 4;      // full[S], empty[S]
constexpr int kSmemBytes = kBars + 2 * kStages * 8 + 1024;  // + align slack
}  // namespace f32cfg

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

// Initialise the ring's full (one producer arrive + the stage's bytes) and
// empty (one arrive per consumer warp) barriers and `extra` single-arrive
// barriers after them, then make them visible to every thread and to TMA.
__device__ __forceinline__ void init_ring(uint64_t* full, int stages, int extra) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&full[stages + s], kConsumerWarps);
    }
    for (int r = 0; r < extra; ++r) mbar_init(&full[2 * stages + r], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
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

// The producer: one thread keeps the ring full. k-block kb is tap
// kb / kslices, (dy, dx) = (tap / 3 - 1, tap % 3 - 1), and input channels
// (kb % kslices) * bk onward; the A box at (c0, w0 + dx, h0 + dy, b) is
// zero-filled outside the tensor, which is the SAME padding and the ragged
// edge; so are the weight rows past C. The zero fill counts toward the
// stage's bytes. Plane p of the weight (b_bytes each) lands at
// b_off + p * b_bytes.
__device__ __forceinline__ void produce(unsigned char* smem, uint64_t* full, uint64_t* empty,
                                        const CUtensorMap* map_in, const CUtensorMap* map_w,
                                        int stages, int stage_bytes, int b_off, int b_bytes,
                                        int planes, int bk, int kslices, int w0, int h0, int b,
                                        int n0) {
  for (int kb = 0; kb < 9 * kslices; ++kb) {
    const int s = kb % stages;
    mbar_wait(&empty[s], ((kb / stages) & 1) ^ 1);
    unsigned char* stage = smem + s * stage_bytes;
    const int tap = kb / kslices;
    mbar_arrive_expect_tx(&full[s], kABytes + planes * b_bytes);
    tma_load_4d(stage, map_in, &full[s], (kb - tap * kslices) * bk, w0 + tap % 3 - 1,
                h0 + tap / 3 - 1, b);
    for (int p = 0; p < planes; ++p)
      tma_load_3d(stage + b_off + p * b_bytes, map_w, &full[s], kb * bk, n0, p);
  }
}

// wgmma descriptor of a K-major tile with the 128-byte swizzle: 128-byte rows
// in 8-row (1024-byte) swizzle atoms, atoms 1024 bytes apart (SBO = 64 x 16
// bytes); LBO is unused for this layout. A 32-byte k step inside the row
// (k16 bf16, k8 tf32) is a +32-byte start address: the swizzle is a function
// of the address bits.
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

// D(64 x 256, fp32 registers) += A(64 x 16, smem) * B(16 x 256, smem), bf16, both K-major.
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

// D(64 x 128, fp32 registers) += A(64 x 8, smem) * B(8 x 128, smem), tf32, both
// K-major (tf32 takes no transpose).
__device__ __forceinline__ void wgmma_m64n128k8_tf32(float (&d)[64], uint64_t desc_a,
                                                     uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// Load bias (and for conv #1 the image's scale and shift) of the tile's
// channels into shared memory as fp32; channels past C get zeros and are
// never stored.
template <int MODE, int BN, typename T>
__device__ __forceinline__ void load_params(float* s_bias, const T* bias, const T* scale,
                                            const T* shift, long long ss_offset, int n0,
                                            int C) {
  float* s_scale = s_bias + BN;
  float* s_shift = s_scale + BN;
  for (int i = threadIdx.x; i < BN; i += kBlockThreads) {
    const bool in_c = n0 + i < C;
    s_bias[i] = in_c ? to_float(bias[n0 + i]) : 0.0f;
    if (MODE == kModeConv1) {
      s_scale[i] = in_c ? to_float(scale[ss_offset + n0 + i]) : 0.0f;
      s_shift[i] = in_c ? to_float(shift[ss_offset + n0 + i]) : 0.0f;
    }
  }
}

// One block: output rows h0, h0 + 1, columns w0 .. w0 + 63 of image b,
// channels n0 .. min(n0 + bn, C) - 1. Warps 0-7 are two consumer warpgroups
// (row h0 + warp / 4 each); warp 8 is the producer.
struct TileCoords {
  int w0, h0, b, n0;
};

__device__ __forceinline__ TileCoords tile_coords(int H, int W, int bn) {
  const int tiles_w = (W + kTileW - 1) / kTileW;
  const int tiles_h = (H + kTileH - 1) / kTileH;
  return {(static_cast<int>(blockIdx.x) % tiles_w) * kTileW,
          (static_cast<int>(blockIdx.x) / tiles_w % tiles_h) * kTileH,
          static_cast<int>(blockIdx.x) / (tiles_w * tiles_h),
          static_cast<int>(blockIdx.y) * bn};
}

template <int MODE>
__global__ void __launch_bounds__(kBlockThreads, 1)
    conv3x3_bf16_kernel(__grid_constant__ const CUtensorMap map_in,   // A: x or h, box (64,64,2,1)
                        __grid_constant__ const CUtensorMap map_w,    // B: (1, C, 9C), box (64,256,1)
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

  const TileCoords tc = tile_coords(H, W, BN);
  const int w0 = tc.w0, h0 = tc.h0, b = tc.b, n0 = tc.n0;
  const int boxes = min(BN, C - n0) / 64;  // 64-channel boxes of the tile inside C
  const int kslices = C / kBK;
  const int kblocks = 9 * kslices;

  // b is uniform in the tile: its bias, scale and shift are loaded once
  load_params<MODE, BN>(s_bias, bias, scale, shift, b * ss_stride, n0, C);
  init_ring(full, S, kTileH);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == kConsumerWarps) {
    if (lane == 0)
      produce(smem, full, empty, &map_in, &map_w, S, kStageBytes, kABytes, kBBytes, 1, kBK,
              kslices, w0, h0, b, n0);
  } else {
    const int row = warp / 4;  // this warpgroup's output row: h0 + row
    unsigned char* epi = smem + kEpi + row * kOutRowBytes;
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

// v rounded to TF32 (10 explicit mantissa bits), to nearest with ties away
// from zero, as cvt.rna.tf32.f32 rounds: add half of the dropped 13 bits'
// range to the magnitude, then clear them. inf and NaN pass through.
__device__ __forceinline__ float tf32_round(float v) {
  const uint32_t bits = __float_as_uint(v);
  if ((bits & 0x7F800000u) == 0x7F800000u) return v;
  return __uint_as_float((bits + 0x1000u) & 0xFFFFE000u);
}

// v -> (hi, lo) with hi = tf32(v) in v, lo = tf32(v - hi).
__device__ __forceinline__ float4 tf32_split(float4& v) {
  const float4 hi = make_float4(tf32_round(v.x), tf32_round(v.y), tf32_round(v.z),
                                tf32_round(v.w));
  const float4 lo = make_float4(tf32_round(v.x - hi.x), tf32_round(v.y - hi.y),
                                tf32_round(v.z - hi.z), tf32_round(v.w - hi.w));
  v = hi;
  return lo;
}

template <int MODE>
__global__ void __launch_bounds__(kBlockThreads, 1)
    conv3x3_3xtf32_kernel(__grid_constant__ const CUtensorMap map_in,  // A: x or h, box (32,64,2,1)
                          __grid_constant__ const CUtensorMap map_w,   // B: (2, C, 9C), box (32,128,1)
                          const float* __restrict__ bias, const float* __restrict__ scale,
                          const float* __restrict__ shift, long long ss_stride,
                          const float* __restrict__ res, float* __restrict__ out, int H, int W,
                          int C) {
  using namespace f32cfg;
  constexpr int BN = kBN;
  constexpr int S = kStages;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* s_bias = reinterpret_cast<float*>(smem + kParams);
  float* s_scale = s_bias + BN;
  float* s_shift = s_scale + BN;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kBars);
  uint64_t* empty = full + S;

  const TileCoords tc = tile_coords(H, W, BN);
  const int w0 = tc.w0, h0 = tc.h0, b = tc.b, n0 = tc.n0;
  const int kslices = C / kBK;
  const int kblocks = 9 * kslices;

  load_params<MODE, BN>(s_bias, bias, scale, shift, b * ss_stride, n0, C);
  init_ring(full, S, 0);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == kConsumerWarps) {
    if (lane == 0)
      produce(smem, full, empty, &map_in, &map_w, S, kStageBytes, kBHi, kBBytes, 2, kBK,
              kslices, w0, h0, b, n0);
    return;
  }

  const int row = warp / 4;  // this warpgroup's output row: h0 + row
  const int t = threadIdx.x % 128;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  for (int kb = 0; kb < kblocks; ++kb) {
    const int s = kb % S;
    mbar_wait(&full[s], (kb / S) & 1);
    unsigned char* stage = smem + s * kStageBytes;
    unsigned char* a = stage + row * kBoxBytes;
    unsigned char* a_lo = stage + kALo + row * kBoxBytes;
    // split this warpgroup's (32 c, 64 w) box: hi in place, lo beside it
    float4* a4 = reinterpret_cast<float4*>(a);
    float4* lo4 = reinterpret_cast<float4*>(a_lo);
#pragma unroll
    for (int j = 0; j < kBoxBytes / 16 / 128; ++j) {
      float4 v = a4[t + 128 * j];
      lo4[t + 128 * j] = tf32_split(v);
      a4[t + 128 * j] = v;
    }
    // the generic-proxy writes must be visible to wgmma (async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + row) : "memory");
    const unsigned char* b_hi = stage + kBHi;
    const unsigned char* b_lo = stage + kBLo;
    fence_operands(acc);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < kBK / 8; ++k) {
      const uint64_t da_hi = smem_desc(a + 32 * k), db_hi = smem_desc(b_hi + 32 * k);
      wgmma_m64n128k8_tf32(acc, smem_desc(a_lo + 32 * k), db_hi);
      wgmma_m64n128k8_tf32(acc, da_hi, smem_desc(b_lo + 32 * k));
      wgmma_m64n128k8_tf32(acc, da_hi, db_hi);
    }
    wgmma_commit();
    wgmma_wait<1>();  // k-block kb - 1 is done with its stage; kb stays in flight
    fence_operands(acc);
    if (kb > 0 && lane == 0) mbar_arrive(&empty[(kb - 1) % S]);
  }
  wgmma_wait<0>();
  fence_operands(acc);

  // Epilogue, straight from the registers (layout as in the bf16 kernel):
  // acc[4j + 2 half + e] is pixel (h0 + row, w0 + 16 (warp % 4) + lane / 4 +
  // 8 half), channel n0 + 8 j + 2 (lane % 4) + e. Each quad of lanes writes
  // 32 contiguous bytes; pixels and channels outside the tensor are skipped.
  const int h = h0 + row;
  if (h >= H) return;
  const int q = lane % 4;
  const int w_lo = w0 + (warp % 4) * 16 + lane / 4;
  const long long row_base = (static_cast<long long>(b) * H + h) * W;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int w = w_lo + 8 * half;
    if (w >= W) continue;
    const long long pix = (row_base + w) * C + n0;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = j * 8 + q * 2;
      if (n0 + n >= C) continue;
      float v0 = acc[4 * j + 2 * half], v1 = acc[4 * j + 2 * half + 1];
      if (MODE == kModeConv1) {
        v0 = epilogue<MODE>(v0, s_bias[n], s_scale[n], s_shift[n], 0.0f);
        v1 = epilogue<MODE>(v1, s_bias[n + 1], s_scale[n + 1], s_shift[n + 1], 0.0f);
      } else {
        const float2 r = __ldg(reinterpret_cast<const float2*>(res + pix + n));
        v0 = epilogue<MODE>(v0, s_bias[n], 0.0f, 0.0f, r.x);
        v1 = epilogue<MODE>(v1, s_bias[n + 1], 0.0f, 0.0f, r.y);
      }
      *reinterpret_cast<float2*>(out + pix + n) = make_float2(v0, v1);
    }
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

// An element type as TMA sees it.
struct Elem {
  CUtensorMapDataType type;
  int bytes;
};
constexpr Elem kBf16{CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2};
constexpr Elem kF32{CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4};

bool encode(CUtensorMap* map, Elem elem, const void* ptr, cuuint32_t rank,
            const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box) {
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode_tiled()(map, elem.type, rank, const_cast<void*>(ptr), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// (B, H, W, C) as the 4-D map (C, W, H, B), box (128 bytes of c, 64 w,
// rows h, 1 b). Out-of-bounds elements load as zeros and are not stored.
bool encode_nhwc(CUtensorMap* map, Elem elem, const void* ptr, int B, int H, int W, int C,
                 int rows) {
  const cuuint64_t dims[4] = {cuuint64_t(C), cuuint64_t(W), cuuint64_t(H), cuuint64_t(B)};
  const cuuint64_t row = cuuint64_t(elem.bytes) * C;
  const cuuint64_t strides[3] = {row, row * W, row * W * H};
  const cuuint32_t box[4] = {cuuint32_t(kRowBytes / elem.bytes), kTileW, cuuint32_t(rows), 1};
  return encode(map, elem, ptr, 4, dims, strides, box);
}

// The packed weight (planes, C, 9C) as the 3-D map (9C, C, planes), box
// (128 bytes of k, bn n, 1 plane). Rows past C load as zeros in each plane.
bool encode_weight(CUtensorMap* map, Elem elem, const void* ptr, int C, int planes, int bn) {
  const cuuint64_t dims[3] = {9ull * C, cuuint64_t(C), cuuint64_t(planes)};
  const cuuint64_t row = 9ull * elem.bytes * C;
  const cuuint64_t strides[2] = {row, row * C};
  const cuuint32_t box[3] = {cuuint32_t(kRowBytes / elem.bytes), cuuint32_t(bn), 1};
  return encode(map, elem, ptr, 3, dims, strides, box);
}

// A kernel may use more than 48 KB of dynamic shared memory only after it
// asks, once per device: bit d of `done` records device d (d < 64).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, std::atomic<uint64_t>& done) {
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  const uint64_t bit = device < 64 ? 1ull << device : 0;
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return e;
}

dim3 grid_of(int B, int H, int W, int C, int bn) {
  return dim3(B * ((H + kTileH - 1) / kTileH) * ((W + kTileW - 1) / kTileW),
              (C + bn - 1) / bn);
}

template <int MODE>
cudaError_t launch_bf16(const CUtensorMap& in, const CUtensorMap& wt, const CUtensorMap& res,
                        const CUtensorMap& out, const void* bias, const void* scale,
                        const void* shift, long long ss_stride, int B, int H, int W, int C,
                        cudaStream_t stream) {
  auto kernel = conv3x3_bf16_kernel<MODE>;
  static std::atomic<uint64_t> smem_set{0};
  const cudaError_t e = allow_smem(kernel, bf16cfg::kSmemBytes, smem_set);
  if (e != cudaSuccess) return e;
  kernel<<<grid_of(B, H, W, C, bf16cfg::kBN), kBlockThreads, bf16cfg::kSmemBytes, stream>>>(
      in, wt, res, out, static_cast<const __nv_bfloat16*>(bias),
      static_cast<const __nv_bfloat16*>(scale), static_cast<const __nv_bfloat16*>(shift),
      ss_stride, H, W, C);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_f32(const CUtensorMap& in, const CUtensorMap& wt, const void* bias,
                       const void* scale, const void* shift, long long ss_stride,
                       const void* res, void* out, int B, int H, int W, int C,
                       cudaStream_t stream) {
  auto kernel = conv3x3_3xtf32_kernel<MODE>;
  static std::atomic<uint64_t> smem_set{0};
  const cudaError_t e = allow_smem(kernel, f32cfg::kSmemBytes, smem_set);
  if (e != cudaSuccess) return e;
  kernel<<<grid_of(B, H, W, C, f32cfg::kBN), kBlockThreads, f32cfg::kSmemBytes, stream>>>(
      in, wt, static_cast<const float*>(bias), static_cast<const float*>(scale),
      static_cast<const float*>(shift), ss_stride, static_cast<const float*>(res),
      static_cast<float*>(out), H, W, C);
  return cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes by hicdiff_tpu_torch/kernels/resblock.py.
// The caller has checked shapes (C % 128 == 0, B, H, W >= 1), dtypes,
// contiguity and 16-byte alignment. `wt` is the packed weight: bf16 (C, 9C),
// rows co, columns [ky][kx][ci]; fp32 the planes (tf32 hi, tf32 lo) of the
// same matrix, (2, C, 9C). Each returns cudaGetLastError() after the launch,
// or a negative code of this file (hicdiff_cuda_error_string).
extern "C" int hicdiff_conv3x3_bf16(const void* x, const void* wt, const void* bias,
                                    const void* scale, const void* shift,
                                    long long ss_stride, const void* res, void* out,
                                    int B, int H, int W, int C, int mode,
                                    void* stream) {
  if (mode != kModeConv1 && mode != kModeConv2) return static_cast<int>(cudaErrorInvalidValue);
  if (encode_tiled() == nullptr) return kErrNoEncoder;
  CUtensorMap m_in, m_wt, m_res, m_out;
  if (!encode_nhwc(&m_in, kBf16, x, B, H, W, C, kTileH) ||
      !encode_weight(&m_wt, kBf16, wt, C, 1, bf16cfg::kBN) ||
      !encode_nhwc(&m_out, kBf16, out, B, H, W, C, 1))
    return kErrEncode;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == kModeConv1)  // conv #1 reads no residual: its map goes unused
    return static_cast<int>(launch_bf16<kModeConv1>(m_in, m_wt, m_out, m_out, bias, scale,
                                                    shift, ss_stride, B, H, W, C, s));
  if (!encode_nhwc(&m_res, kBf16, res, B, H, W, C, 1)) return kErrEncode;
  return static_cast<int>(launch_bf16<kModeConv2>(m_in, m_wt, m_res, m_out, bias, scale, shift,
                                                  ss_stride, B, H, W, C, s));
}

extern "C" int hicdiff_conv3x3_f32(const void* x, const void* wt, const void* bias,
                                   const void* scale, const void* shift,
                                   long long ss_stride, const void* res, void* out, int B,
                                   int H, int W, int C, int mode, void* stream) {
  if (mode != kModeConv1 && mode != kModeConv2) return static_cast<int>(cudaErrorInvalidValue);
  if (encode_tiled() == nullptr) return kErrNoEncoder;
  CUtensorMap m_in, m_wt;
  if (!encode_nhwc(&m_in, kF32, x, B, H, W, C, kTileH) ||
      !encode_weight(&m_wt, kF32, wt, C, 2, f32cfg::kBN))
    return kErrEncode;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* launch = mode == kModeConv1 ? &launch_f32<kModeConv1> : &launch_f32<kModeConv2>;
  return static_cast<int>(
      launch(m_in, m_wt, bias, scale, shift, ss_stride, res, out, B, H, W, C, s));
}

extern "C" const char* hicdiff_cuda_error_string(int code) {
  if (code == kErrNoEncoder) return "cuTensorMapEncodeTiled not found in libcuda.so.1";
  if (code == kErrEncode) return "cuTensorMapEncodeTiled rejected a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
