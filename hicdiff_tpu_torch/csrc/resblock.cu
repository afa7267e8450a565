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
// bf16 (conv3x3_bf16_kernel, modes 1, 2 and 5 only, one block a tile): k16
//   steps of bf16 products, 3 stages of 48 KB; the epilogue writes a
//   swizzled shared tile (mode 2 first reads the residual there, loaded by
//   TMA during the main loop) and leaves by TMA stores, which write only the
//   in-bounds part of a box. Modes 3, 4, 6 and 7 run the persistent form
//   below.
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
//
// Training runs the same skeletons in three more epilogue modes, in both
// element types. The block's backward for g = dL/dy is, with convT the 3x3
// SAME conv whose weight is flipped in space with C_in and C_out swapped (its
// own packed weight, kernels/resblock.py: transpose_kernel):
//   mode 3: mode 1, and z = conv(x) + bias stored beside h (the forward
//           that keeps what the backward reads: x, z, h);
//   mode 4: conv #2's dgrad. d_h = 0.1 convT(g); u = z (scale + 1) + shift;
//           du = d_h silu'(u) is stored, and dz = du (scale + 1). du is
//           written out rather than recovered later from dz, since
//           scale + 1 can be near 0. No bias.
//   mode 5: conv #1's dgrad, dx = convT(dz) + g: the residual read as mode
//           2 reads it, scale 1, no bias.
// In bf16 every tensor the modes read or write is bf16 (x, z, h, g, dz, du,
// dx: the dtype flow of JAX's cotangents) and every epilogue operation runs
// on the fp32 accumulators, in the order of the plain twin; mode 4 reads z
// where mode 2 reads its residual, and mode 5 is mode 2 without bias and x0.1.
//
// bf16 modes 3 and 4 (conv3x3_bf16_persistent_kernel). What bounds them is
// what bounds every bf16 mode: a 128-pixel x 256-channel tile takes 48 KB
// from L2 per k-block for 4.2 MFLOP (85 FLOP a byte), so at the 0.52 ms of
// mode 2 at batch 64 each SM takes in ~55 GB/s and the tensor cores wait on
// the loads. On top of that, a one-tile-a-block grid with 212 KB blocks
// (one an SM) pays each tile's pipeline fill, its epilogue and its store
// waits with no load in flight, and modes 3 and 4 have the longest
// epilogues: two 64 KB tiles out, and a sigmoid per element. What this
// kernel does (each choice timed against its alternative by
// tools/conv_bf16_variants.py):
//   * Persistent: min(tiles, SMs) blocks (the device's SM count), each
//     walking tiles blockIdx.x + k gridDim.x. The producer runs straight on
//     into the next tile's k-blocks, its full/empty phases counted over all
//     the block's k-blocks, so while the consumers run an epilogue the ring
//     fills (3 stages, ~2.7 us of loads at that intake) and the next main
//     loop starts on landed stages. The consumers release a tile's last
//     stage after wgmma_wait<0>.
//   * The second tile leaves through the output tile, not the ring, and
//     each warpgroup runs its epilogue alone, with its own 64-pixel row of
//     the output tile, its own parameter slots and its own named barrier:
//     first tile (mode 3 z, mode 4 dz with du kept in the accumulators),
//     TMA store, the leader's wait until that store has READ the row
//     (cp.async.bulk.wait_group.read), a warpgroup barrier, second tile (h
//     or du), TMA store. Mode 3 computes h while its z store reads. Staging
//     from shared memory keeps the stores to 128-byte lines; stored from
//     the registers, each warp's store touches 8 lines for 128 bytes, and
//     modes 3 and 4 ran 19 and 9 % slower.
//   * Store waits: the second store is waited for only before the row is
//     written again, one tile later: mode 3 at the start of the next
//     epilogue; mode 4 before it loads the next z into the row, at k-block
//     2 of the next main loop (the leader waits, then issues the z boxes on
//     res_ready[row], which the epilogue waits on with the phase flipping
//     each tile). So z never lands on data a store has not read, and the
//     epilogue's first read of z follows both. Every generic write to the
//     row is fenced to the async proxy and met at the warpgroup barrier
//     before the leader stores it.
//   * The sigmoid of mode 3's SiLU and of mode 4's silu' is one ex2.approx
//     (__expf) and one rcp.approx (__fdividef), in the plain twin's order
//     otherwise. __expf is within 2 + 1.173 |x| ulp, __fdividef within 2:
//     at |u| <= 16 the sigmoid is within ~2.6e-6 relative of expf's, under
//     a thousandth of a bf16 ulp, so an output moves at most one bf16 ulp and
//     only next to a rounding boundary (the bar is 0.016 of max(1, the
//     largest value)).
//   * Shared memory: the 3 x 48 KB ring, the 64 KB output tile, 6 KB of
//     parameters (two warpgroups' bias, scale + 1, shift) and the barriers:
//     215 KB of 227. A fourth stage (48 KB) does not fit beside the output
//     tile.
//   * Registers: 384 threads, a whole producer warpgroup, and setmaxnreg
//     (232 a consumer thread, 40 a producer one). At 288 threads ptxas
//     grants 168 a thread, and mode 4, which keeps du in the accumulators,
//     spills 232 bytes and runs 17 % slower.
// The bf16 attention variant's residual stream is fp32 (its post-norm's fp32
// scale promotes it), so its blocks read the stream cast to bf16 and take
// two modes of the bf16 kernel whose epilogues read and write fp32:
//   mode 6: conv #2 on that stream, y = fp32(bf16((conv(h) + bias) 0.1)) + x;
//   mode 7: conv #1's dgrad there, dx = fp32(bf16(convT(dz))) + g, g fp32:
// the bf16 branch is rounded, then added in fp32, as the JAX package adds
// its bf16 block output (and the cast's cotangent) to the fp32 stream.
//
// bf16 modes 6 and 7 (the persistent kernel, its skeleton as above). They
// move the most bytes of any mode, 10 an element (bf16 in, fp32 stream in,
// fp32 out), so their epilogue is the longest. A warpgroup's fp32 row (64
// pixels x 256 channels, 64 KB) is twice its 32 KB row of the output tile,
// so the stream passes through that row in parts of 64 channels (16 KB, two
// 128-byte-swizzled (32 c, 64 w) fp32 boxes), two slots at a time: TMA loads
// the first two parts at k-block kResLoadKb, as mode 4 loads z; the epilogue
// adds the rounded branch to a part in place, the leader stores it by TMA,
// waits until the store has read the slot and loads the part after next
// into it while the other slot's part is added. Each choice timed against
// its alternative by tools/conv_bf16_variants.py (H100, batch 64, modes 6 /
// 7; the one-tile kernel this replaced: 0.624 / 0.608 ms):
//   * Staged through shared memory by TMA, 0.538 / 0.534 ms, against the
//     same persistent loop reading the stream with __ldg and storing float2
//     from the registers (4 stages, no output tile, the stream asked for in
//     L2 half a main loop ahead): 0.805 / 0.802. A quad of lanes covers one
//     pixel's whole 32-byte sector, but every warp's load or store still
//     touches 8 pixels' lines, 128 instructions a thread a tile, and the
//     load latency sits in each epilogue.
//   * Parts of 64 channels in two slots, against two parts of 128 channels
//     (the whole row, so the second part's load waits for the first part's
//     store): 0.555 / 0.548; parts of 32 in four slots tie (0.539 / 0.533).
//   * No L2 prefetch: asking for the later parts in L2 by TMA when the first
//     two are loaded costs 0.035 ms (0.573 / 0.561).
//   * Persistent, against one block a tile on the same code: 0.561 / 0.551.
// The weight gradient and the channel sums are csrc/resblock_bwd.cu's.
// A dgrad is one conv's FLOPs, so it runs at the forward's rate.

#include <cuda_bf16.h>
#include <stdio.h>

#include <algorithm>

#include "hopper.cuh"

using namespace hicdiff_hopper;

namespace {

constexpr int kModeConv1 = 1;      // bias, scale/shift, SiLU
constexpr int kModeConv2 = 2;      // bias, x0.1, residual
constexpr int kModeConv1Z = 3;     // mode 1, and z = acc + bias stored
constexpr int kModeDgrad2 = 4;     // conv #2's dgrad: dz and du from z, scale, shift
constexpr int kModeDgrad1 = 5;     // conv #1's dgrad: acc + residual
constexpr int kModeConv2F32 = 6;   // mode 2 onto an fp32 residual stream (bf16 only)
constexpr int kModeDgrad1F32 = 7;  // mode 5 onto an fp32 residual stream (bf16 only)

__host__ __device__ constexpr bool reads_bias(int mode) {
  return mode == kModeConv1 || mode == kModeConv2 || mode == kModeConv1Z ||
         mode == kModeConv2F32;
}
__host__ __device__ constexpr bool reads_scale_shift(int mode) {
  return mode == kModeConv1 || mode == kModeConv1Z || mode == kModeDgrad2;
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

// Mode 4 per element: du = 0.1 acc * silu'(u), u = z (scale + 1) + shift,
// silu'(u) = s (1 + u (1 - s)) with s = sigmoid(u); mirrors
// kernels/resblock.py: _dgrad_reference.
__device__ __forceinline__ float dgrad2_du(float acc, float z, float scale, float shift) {
  const float u = z * (scale + 1.0f) + shift;
  const float s = 1.0f / (1.0f + expf(-u));
  return (acc * 0.1f) * (s * (1.0f + u * (1.0f - s)));
}

// The persistent kernel's SiLU and mode 4 (see the note at the top): the same
// operations in the same order, with 1 / (1 + e^-v) as one ex2.approx
// (__expf) and one rcp.approx (__fdividef) in place of expf and an IEEE
// divide. `scale1` is scale + 1, added once per channel as above.
__device__ __forceinline__ float silu_fast(float v) {
  return __fdividef(v, 1.0f + __expf(-v));
}
__device__ __forceinline__ float dgrad2_du_fast(float acc, float z, float scale1, float shift) {
  const float u = z * scale1 + shift;
  const float s = __fdividef(1.0f, 1.0f + __expf(-u));
  return (acc * 0.1f) * (s * (1.0f + u * (1.0f - s)));
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
// The fp32 stream of modes 6 and 7 passes through a warpgroup's 32 KB row of
// the output tile in parts of kStreamCh channels (64 w x 64 c x 4 B = 16 KB,
// two (32 c, 64 w) fp32 boxes), kStreamSlots parts at a time.
constexpr int kStreamCh = 64;
constexpr int kStreamBoxes = kStreamCh / 32;
constexpr int kStreamSlots = kOutRowBytes / (kStreamBoxes * kBoxBytes);
// The persistent kernel of modes 3, 4, 6 and 7: the same ring and output
// tile, each consumer warpgroup's own parameters (bias, scale + 1, shift),
// which it rewrites for every tile while the other warpgroup may still read
// its own, and the barriers: the ring's, then a row's, one a slot of the
// stream (mode 4's z takes the first).
constexpr int kPParams = kEpi + kTileH * kOutRowBytes;     // [row][bias, scale + 1, shift][kBN]
constexpr int kPBars = kPParams + kTileH * 3 * kBN * 4;    // full[S], empty[S], [row][slot]
constexpr int kPSmemBytes = kPBars + (2 * kStages + kTileH * kStreamSlots) * 8 + 1024;
static_assert(kPSmemBytes <= 232448, "227 KB of shared memory a block");
// Two consumer warpgroups and a whole producer warpgroup: ptxas budgets
// registers per warpgroup (168 a thread for 288 or 384 threads), and
// setmaxnreg moves them to the consumers, 2 x 128 x 232 + 128 x 40 of 65,536.
constexpr int kPThreads = 32 * kConsumerWarps + 128;
constexpr int kConsumerRegs = 232, kProducerRegs = 40;
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
    mbar_init_fence();
  }
  __syncthreads();
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

// v rounded to bf16, to nearest even, and back: the bf16 branch the fp32
// stream modes add.
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

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
    s_bias[i] = in_c && reads_bias(MODE) ? to_float(bias[n0 + i]) : 0.0f;
    if (reads_scale_shift(MODE)) {
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

// The bf16 modes whose residual (x, z or g) lands in the epilogue tile by TMA.
__host__ __device__ constexpr bool reads_res_tile(int mode) {
  return mode == kModeConv2 || mode == kModeDgrad2 || mode == kModeDgrad1;
}
// The bf16 modes that store a second tile (z, du): the persistent kernel's.
__host__ __device__ constexpr bool writes_aux_tile(int mode) {
  return mode == kModeConv1Z || mode == kModeDgrad2;
}
// The bf16 modes on the att variant's fp32 stream: the persistent kernel's.
__host__ __device__ constexpr bool on_f32_stream(int mode) {
  return mode == kModeConv2F32 || mode == kModeDgrad1F32;
}

// Modes 1, 2 and 5: one block a tile.
template <int MODE>
__global__ void __launch_bounds__(kBlockThreads, 1)
    conv3x3_bf16_kernel(__grid_constant__ const CUtensorMap map_in,   // A: x, h or dz, box (64,64,2,1)
                        __grid_constant__ const CUtensorMap map_w,    // B: (1, C, 9C), box (64,256,1)
                        __grid_constant__ const CUtensorMap map_res,  // modes 2, 5, box (64,64,1,1)
                        __grid_constant__ const CUtensorMap map_out,  // box (64,64,1,1)
                        const __nv_bfloat16* __restrict__ bias,
                        const __nv_bfloat16* __restrict__ scale,
                        const __nv_bfloat16* __restrict__ shift, long long ss_stride,
                        int H, int W, int C) {
  static_assert(!writes_aux_tile(MODE) && !on_f32_stream(MODE),
                "modes 3, 4, 6 and 7 run conv3x3_bf16_persistent_kernel");
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
    if (reads_res_tile(MODE) && threadIdx.x % 128 == 0) {
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
    const int r8 = lane / 4;
    const int q = lane % 4;
    const int w_lo = (warp % 4) * 16 + r8;
    // Each value goes, as bf16, into the (64 w, 64 c) box j / 8 of this
    // row at 128-byte line w, 16-byte chunk (j % 8) ^ (w % 8): TMA's
    // 128-byte swizzle.
    if (reads_res_tile(MODE)) mbar_wait(&res_ready[row], 0);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = j * 8 + q * 2;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int w = w_lo + 8 * half;
        const int off = (j / 8) * kBoxBytes + w * 128 + (((j % 8) ^ r8) * 16) + q * 4;
        __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(epi + off);
        float v0 = acc[4 * j + 2 * half], v1 = acc[4 * j + 2 * half + 1];
        if constexpr (MODE == kModeConv1) {
          v0 = epilogue<kModeConv1>(v0, s_bias[n], s_scale[n], s_shift[n], 0.0f);
          v1 = epilogue<kModeConv1>(v1, s_bias[n + 1], s_scale[n + 1], s_shift[n + 1], 0.0f);
        } else if constexpr (MODE == kModeConv2) {
          const float2 r = __bfloat1622float2(*p);
          v0 = epilogue<kModeConv2>(v0, s_bias[n], 0.0f, 0.0f, r.x);
          v1 = epilogue<kModeConv2>(v1, s_bias[n + 1], 0.0f, 0.0f, r.y);
        } else {  // kModeDgrad1
          const float2 r = __bfloat1622float2(*p);
          v0 += r.x;
          v1 += r.y;
        }
        *p = __floats2bfloat162_rn(v0, v1);
      }
    }
    // make the generic-proxy writes visible to TMA, then one thread stores
    fence_proxy_async();
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + row) : "memory");
    if (threadIdx.x % 128 == 0) {
      for (int j = 0; j < boxes; ++j)
        tma_store_4d(&map_out, epi + j * kBoxBytes, n0 + j * 64, w0, h0 + row, b);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  }
}

// ------------------------------------ bf16 modes 3, 4, 6 and 7: persistent

// Tile `tile` of the persistent grid: the spatial tiles of every image, then
// the next channel tile, in the order of the one-tile-a-block grid.
__device__ __forceinline__ TileCoords tile_at(int tile, int B, int H, int W, int bn) {
  const int tiles_w = (W + kTileW - 1) / kTileW;
  const int tiles_h = (H + kTileH - 1) / kTileH;
  const int spatial = tiles_w * tiles_h * B;
  const int s = tile % spatial;
  return {(s % tiles_w) * kTileW, (s / tiles_w % tiles_h) * kTileH, s / (tiles_w * tiles_h),
          (tile / spatial) * bn};
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// This thread's committed TMA stores have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// The 128 threads of warpgroup `row` meet (named barriers 1 and 2).
__device__ __forceinline__ void warpgroup_sync(int row) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + row) : "memory");
}

// The k-block at which mode 4 starts the TMA load of the tile's z into the
// output tile: by then the last tile's stores have long read it.
constexpr int kResLoadKb = 2;

// Modes 3, 4, 6 and 7 (see the note at the top): min(tiles, SMs) blocks,
// each walking the tiles blockIdx.x, blockIdx.x + gridDim.x, ... with the
// ring's barrier phases carried from tile to tile.
template <int MODE>
__global__ void __launch_bounds__(bf16cfg::kPThreads, 1)
    conv3x3_bf16_persistent_kernel(__grid_constant__ const CUtensorMap map_in,   // x, g or dz
                                   __grid_constant__ const CUtensorMap map_w,
                                   __grid_constant__ const CUtensorMap map_res,  // z; 6, 7: fp32
                                   __grid_constant__ const CUtensorMap map_out,  // h or dz
                                   __grid_constant__ const CUtensorMap map_aux,  // z or du
                                   const __nv_bfloat16* __restrict__ bias,
                                   const __nv_bfloat16* __restrict__ scale,
                                   const __nv_bfloat16* __restrict__ shift, long long ss_stride,
                                   const float* __restrict__ res_f32,  // 6, 7: the stream, g
                                   float* __restrict__ out_f32,        // 6, 7: y, dx
                                   int B, int H, int W, int C) {
  static_assert(writes_aux_tile(MODE) || on_f32_stream(MODE),
                "the second-tile and fp32-stream modes");
  using namespace bf16cfg;
  constexpr int BN = kBN;
  constexpr int S = kStages;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kPBars);
  uint64_t* empty = full + S;
  uint64_t* row_bars = empty + S;

  const int tiles = B * ((H + kTileH - 1) / kTileH) * ((W + kTileW - 1) / kTileW) *
                    ((C + BN - 1) / BN);
  const int kslices = C / kBK;
  const int kblocks = 9 * kslices;
  init_ring(full, S, kTileH * kStreamSlots);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= kConsumerWarps) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    // the producer runs on into the next tile while the consumers finish one
    if (threadIdx.x == 32 * kConsumerWarps) {
      int it = 0;  // k-blocks issued by this block, all tiles
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const TileCoords tc = tile_at(tile, B, H, W, BN);
        for (int kb = 0; kb < kblocks; ++kb, ++it) {
          const int s = it % S;
          mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
          unsigned char* stage = smem + s * kStageBytes;
          const int tap = kb / kslices;
          mbar_arrive_expect_tx(&full[s], kStageBytes);
          tma_load_4d(stage, &map_in, &full[s], (kb - tap * kslices) * kBK,
                      tc.w0 + tap % 3 - 1, tc.h0 + tap / 3 - 1, tc.b);
          tma_load_3d(stage + kABytes, &map_w, &full[s], kb * kBK, tc.n0, 0);
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));

  const int row = warp / 4;  // this warpgroup's output row: h0 + row
  const int t = threadIdx.x % 128;
  const bool leader = t == 0;  // issues this warpgroup's TMA loads and stores
  unsigned char* epi = smem + kEpi + row * kOutRowBytes;
  uint64_t* res_ready = row_bars + row * kStreamSlots;  // z; the stream's slots
  float* p_bias = reinterpret_cast<float*>(smem + kPParams) + row * 3 * BN;
  float* p_scale1 = p_bias + BN;
  float* p_shift = p_scale1 + BN;
  const int r8 = lane / 4;
  const int q = lane % 4;
  const int w_lo = (warp % 4) * 16 + r8;
  int it = 0;  // k-blocks consumed by this block, all tiles
  int phases = 0;  // bit i: the phase of res_ready[i]
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const TileCoords tc = tile_at(tile, B, H, W, BN);
    const int w0 = tc.w0, h0 = tc.h0, b = tc.b, n0 = tc.n0;
    const int boxes = min(BN, C - n0) / 64;  // 64-channel boxes of the tile inside C
    const int parts = min(BN, C - n0) / kStreamCh;  // modes 6 and 7
    // the tile's bias, scale + 1 and shift, read now and written to this
    // warpgroup's slots after the main loop
    float pv[3][BN / 128];
#pragma unroll
    for (int i = 0; i < BN / 128; ++i) {
      const int n = n0 + t + 128 * i;
      const bool in_c = n < C;
      const long long ss = b * ss_stride + n;
      pv[0][i] = in_c && reads_bias(MODE) ? __bfloat162float(bias[n]) : 0.0f;
      pv[1][i] = in_c && reads_scale_shift(MODE) ? __bfloat162float(scale[ss]) + 1.0f : 0.0f;
      pv[2][i] = in_c && reads_scale_shift(MODE) ? __bfloat162float(shift[ss]) : 0.0f;
    }

    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
    for (int kb = 0; kb < kblocks; ++kb, ++it) {
      const int s = it % S;
      mbar_wait(&full[s], (it / S) & 1);
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
      if (kb > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % S]);
      if (MODE == kModeDgrad2 && kb == kResLoadKb && leader) {
        // z into the output tile, once the last tile's stores have read it
        bulk_wait_read();
        mbar_arrive_expect_tx(&res_ready[0], boxes * kBoxBytes);
        for (int j = 0; j < boxes; ++j)
          tma_load_4d(epi + j * kBoxBytes, &map_res, &res_ready[0], n0 + j * 64, w0, h0 + row, b);
      }
      if (on_f32_stream(MODE) && kb == kResLoadKb && leader) {
        // the stream's first parts into the row's slots, once the last
        // tile's stores have read them
        bulk_wait_read();
        for (int p = 0; p < min(parts, kStreamSlots); ++p) {
          unsigned char* slot = epi + p * kStreamBoxes * kBoxBytes;
          mbar_arrive_expect_tx(&res_ready[p], kStreamBoxes * kBoxBytes);
          for (int i = 0; i < kStreamBoxes; ++i)
            tma_load_4d(slot + i * kBoxBytes, &map_res, &res_ready[p],
                        n0 + p * kStreamCh + i * 32, w0, h0 + row, b);
        }
      }
    }
    wgmma_wait<0>();
    fence_operands(acc);
    if (lane == 0) mbar_arrive(&empty[(it - 1) % S]);  // the tile's last stage

    // Epilogue, this warpgroup alone; layout as in conv3x3_bf16_kernel.
    // Every thread of the warpgroup is past the last tile's reads of its
    // parameters: they come before that tile's last two barriers.
#pragma unroll
    for (int i = 0; i < BN / 128; ++i) {
      p_bias[t + 128 * i] = pv[0][i];
      p_scale1[t + 128 * i] = pv[1][i];
      p_shift[t + 128 * i] = pv[2][i];
    }
    if (MODE == kModeConv1Z && leader) bulk_wait_read();  // the last tile's h has left
    warpgroup_sync(row);
    if constexpr (on_f32_stream(MODE)) {
      // y = fp32(bf16((acc + bias) 0.1)) + x or dx = fp32(bf16(acc)) + g, a
      // part at a time in its slot of the row: wait for the stream's part,
      // add the branch to it in place, store it by TMA; the leader then
      // waits until that store has read the slot and loads the part after
      // next into it, which lands while the next part is added.
#pragma unroll
      for (int p = 0; p < BN / kStreamCh; ++p) {
        if (p < parts) {
          const int si = p % kStreamSlots;
          unsigned char* slot = epi + si * kStreamBoxes * kBoxBytes;
          mbar_wait(&res_ready[si], (phases >> si) & 1);
          phases ^= 1 << si;
          // channel p kStreamCh + n: box n / 32 of the slot, 128-byte line
          // w, 16-byte chunk (n % 32) / 4 ^ (w % 8)
#pragma unroll
          for (int jj = 0; jj < kStreamCh / 8; ++jj) {
            const int j = p * (kStreamCh / 8) + jj;
            const int n = jj * 8 + q * 2;
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int w = w_lo + 8 * half;
              float2* e = reinterpret_cast<float2*>(
                  slot + (n / 32) * kBoxBytes + w * 128 + ((((n % 32) / 4) ^ r8) * 16) +
                  (n % 4) * 4);
              float v0 = acc[4 * j + 2 * half], v1 = acc[4 * j + 2 * half + 1];
              if constexpr (MODE == kModeConv2F32) {
                v0 = (v0 + p_bias[p * kStreamCh + n]) * 0.1f;
                v1 = (v1 + p_bias[p * kStreamCh + n + 1]) * 0.1f;
              }
              const float2 r = *e;
              *e = make_float2(round_bf16(v0) + r.x, round_bf16(v1) + r.y);
            }
          }
          fence_proxy_async();
          warpgroup_sync(row);
          if (leader) {
            for (int i = 0; i < kStreamBoxes; ++i)
              tma_store_4d(&map_out, slot + i * kBoxBytes, n0 + p * kStreamCh + i * 32, w0,
                           h0 + row, b);
            bulk_commit();
            if (p + kStreamSlots < parts) {
              bulk_wait_read();
              mbar_arrive_expect_tx(&res_ready[si], kStreamBoxes * kBoxBytes);
              for (int i = 0; i < kStreamBoxes; ++i)
                tma_load_4d(slot + i * kBoxBytes, &map_res, &res_ready[si],
                            n0 + (p + kStreamSlots) * kStreamCh + i * 32, w0, h0 + row, b);
            }
          }
        }
      }
      continue;
    }
    if (MODE == kModeDgrad2) {
      mbar_wait(&res_ready[0], phases & 1);
      phases ^= 1;
    }
    // first tile: mode 3 z = acc + bias; mode 4 dz = du (scale + 1), and du
    // kept in acc
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = j * 8 + q * 2;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int w = w_lo + 8 * half;
        const int off = (j / 8) * kBoxBytes + w * 128 + (((j % 8) ^ r8) * 16) + q * 4;
        __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(epi + off);
        float& v0 = acc[4 * j + 2 * half];
        float& v1 = acc[4 * j + 2 * half + 1];
        if constexpr (MODE == kModeConv1Z) {
          *p = __floats2bfloat162_rn(v0 + p_bias[n], v1 + p_bias[n + 1]);
        } else {
          const float2 z = __bfloat1622float2(*p);
          v0 = dgrad2_du_fast(v0, z.x, p_scale1[n], p_shift[n]);
          v1 = dgrad2_du_fast(v1, z.y, p_scale1[n + 1], p_shift[n + 1]);
          *p = __floats2bfloat162_rn(v0 * p_scale1[n], v1 * p_scale1[n + 1]);
        }
      }
    }
    // make the generic-proxy writes visible to TMA, then the leader stores
    fence_proxy_async();
    warpgroup_sync(row);
    const CUtensorMap* first = MODE == kModeConv1Z ? &map_aux : &map_out;
    const CUtensorMap* second = MODE == kModeConv1Z ? &map_out : &map_aux;
    if (leader) {
      for (int j = 0; j < boxes; ++j)
        tma_store_4d(first, epi + j * kBoxBytes, n0 + j * 64, w0, h0 + row, b);
      bulk_commit();
    }
    if constexpr (MODE == kModeConv1Z) {
      // h = silu((acc + bias) (scale + 1) + shift) while that store reads
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int n = j * 8 + q * 2;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = n + (e & 1);
          const float v = acc[4 * j + e] + p_bias[c];
          acc[4 * j + e] = silu_fast(v * p_scale1[c] + p_shift[c]);
        }
      }
    }
    // second tile: h or du, from acc into the same buffer
    if (leader) bulk_wait_read();
    warpgroup_sync(row);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int w = w_lo + 8 * half;
        const int off = (j / 8) * kBoxBytes + w * 128 + (((j % 8) ^ r8) * 16) + q * 4;
        *reinterpret_cast<__nv_bfloat162*>(epi + off) =
            __floats2bfloat162_rn(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
      }
    }
    fence_proxy_async();
    warpgroup_sync(row);
    if (leader) {
      for (int j = 0; j < boxes; ++j)
        tma_store_4d(second, epi + j * kBoxBytes, n0 + j * 64, w0, h0 + row, b);
      bulk_commit();
    }
  }
  if (leader) bulk_wait_read();  // shared memory outlives the last stores' reads
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
                          const float* __restrict__ res,  // mode 2: x; 4: z; 5: g
                          float* __restrict__ out,
                          float* __restrict__ aux,  // mode 3: z; 4: du
                          int H, int W, int C) {
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
    fence_proxy_async();
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
      if constexpr (MODE == kModeConv1 || MODE == kModeConv1Z) {
        if constexpr (MODE == kModeConv1Z)
          *reinterpret_cast<float2*>(aux + pix + n) =
              make_float2(v0 + s_bias[n], v1 + s_bias[n + 1]);
        v0 = epilogue<kModeConv1>(v0, s_bias[n], s_scale[n], s_shift[n], 0.0f);
        v1 = epilogue<kModeConv1>(v1, s_bias[n + 1], s_scale[n + 1], s_shift[n + 1], 0.0f);
      } else if constexpr (MODE == kModeConv2) {
        const float2 r = __ldg(reinterpret_cast<const float2*>(res + pix + n));
        v0 = epilogue<kModeConv2>(v0, s_bias[n], 0.0f, 0.0f, r.x);
        v1 = epilogue<kModeConv2>(v1, s_bias[n + 1], 0.0f, 0.0f, r.y);
      } else if constexpr (MODE == kModeDgrad2) {
        const float2 z = __ldg(reinterpret_cast<const float2*>(res + pix + n));
        const float du0 = dgrad2_du(v0, z.x, s_scale[n], s_shift[n]);
        const float du1 = dgrad2_du(v1, z.y, s_scale[n + 1], s_shift[n + 1]);
        *reinterpret_cast<float2*>(aux + pix + n) = make_float2(du0, du1);
        v0 = du0 * (s_scale[n] + 1.0f);
        v1 = du1 * (s_scale[n + 1] + 1.0f);
      } else {  // kModeDgrad1
        const float2 r = __ldg(reinterpret_cast<const float2*>(res + pix + n));
        v0 += r.x;
        v1 += r.y;
      }
      *reinterpret_cast<float2*>(out + pix + n) = make_float2(v0, v1);
    }
  }
}

}  // namespace

// ------------------------------------------------------------------ host side
namespace {

// The packed weight (planes, C, 9C) as the 3-D map (9C, C, planes), box
// (128 bytes of k, bn n, 1 plane). Rows past C load as zeros in each plane.
bool encode_weight(CUtensorMap* map, Elem elem, const void* ptr, int C, int planes, int bn) {
  const cuuint64_t dims[3] = {9ull * C, cuuint64_t(C), cuuint64_t(planes)};
  const cuuint64_t row = 9ull * elem.bytes * C;
  const cuuint64_t strides[2] = {row, row * C};
  const cuuint32_t box[3] = {cuuint32_t(kRowBytes / elem.bytes), cuuint32_t(bn), 1};
  return encode(map, elem, ptr, 3, dims, strides, box);
}

dim3 grid_of(int B, int H, int W, int C, int bn) {
  return dim3(B * ((H + kTileH - 1) / kTileH) * ((W + kTileW - 1) / kTileW),
              (C + bn - 1) / bn);
}

template <int MODE>
cudaError_t launch_bf16(const CUtensorMap& in, const CUtensorMap& wt, const CUtensorMap& res,
                        const CUtensorMap& out, const CUtensorMap&, const void* bias,
                        const void* scale, const void* shift, long long ss_stride,
                        const void*, void*, int B, int H, int W, int C, cudaStream_t stream) {
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

// Modes 3, 4, 6 and 7: min(tiles, SMs) persistent blocks, the SM count the
// device's.
template <int MODE>
cudaError_t launch_bf16_persistent(const CUtensorMap& in, const CUtensorMap& wt,
                                   const CUtensorMap& res, const CUtensorMap& out,
                                   const CUtensorMap& aux, const void* bias, const void* scale,
                                   const void* shift, long long ss_stride, const void* res_f32,
                                   void* out_f32, int B, int H, int W, int C,
                                   cudaStream_t stream) {
  auto kernel = conv3x3_bf16_persistent_kernel<MODE>;
  static std::atomic<uint64_t> smem_set{0};
  cudaError_t e = allow_smem(kernel, bf16cfg::kPSmemBytes, smem_set);
  if (e != cudaSuccess) return e;
  int device = 0, sms = 0;
  if ((e = cudaGetDevice(&device)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return e;
  const dim3 tiles = grid_of(B, H, W, C, bf16cfg::kBN);
  kernel<<<std::min(static_cast<int>(tiles.x * tiles.y), sms), bf16cfg::kPThreads,
           bf16cfg::kPSmemBytes, stream>>>(
      in, wt, res, out, aux, static_cast<const __nv_bfloat16*>(bias),
      static_cast<const __nv_bfloat16*>(scale), static_cast<const __nv_bfloat16*>(shift),
      ss_stride, static_cast<const float*>(res_f32), static_cast<float*>(out_f32), B, H, W, C);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_f32(const CUtensorMap& in, const CUtensorMap& wt, const void* bias,
                       const void* scale, const void* shift, long long ss_stride,
                       const void* res, void* out, void* aux, int B, int H, int W, int C,
                       cudaStream_t stream) {
  auto kernel = conv3x3_3xtf32_kernel<MODE>;
  static std::atomic<uint64_t> smem_set{0};
  const cudaError_t e = allow_smem(kernel, f32cfg::kSmemBytes, smem_set);
  if (e != cudaSuccess) return e;
  kernel<<<grid_of(B, H, W, C, f32cfg::kBN), kBlockThreads, f32cfg::kSmemBytes, stream>>>(
      in, wt, static_cast<const float*>(bias), static_cast<const float*>(scale),
      static_cast<const float*>(shift), ss_stride, static_cast<const float*>(res),
      static_cast<float*>(out), static_cast<float*>(aux), H, W, C);
  return cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes by hicdiff_tpu_torch/kernels/resblock.py.
// The caller has checked shapes (C % 128 == 0, B, H, W >= 1), dtypes,
// contiguity and 16-byte alignment. `wt` is the packed weight: bf16 (C, 9C),
// rows co, columns [ky][kx][ci]; fp32 the planes (tf32 hi, tf32 lo) of the
// same matrix, (2, C, 9C) (modes 4, 5 and 7: the pack of the transposed
// kernel). `res` is read by modes 2, 4, 5, 6 and 7, `aux` written by modes 3
// and 4 (see the note at the top). The bf16 entry takes modes 1-7, where
// `res` and `out` of modes 6 and 7 are fp32 and every other tensor is bf16;
// the fp32 entry takes modes 1-5. Each returns cudaGetLastError() after the
// launch, or a negative code of this file (hicdiff_cuda_error_string).
extern "C" int hicdiff_conv3x3_bf16(const void* x, const void* wt, const void* bias,
                                    const void* scale, const void* shift,
                                    long long ss_stride, const void* res, void* out, void* aux,
                                    int B, int H, int W, int C, int mode, void* stream) {
  using Launch = cudaError_t (*)(const CUtensorMap&, const CUtensorMap&, const CUtensorMap&,
                                 const CUtensorMap&, const CUtensorMap&, const void*,
                                 const void*, const void*, long long, const void*, void*, int,
                                 int, int, int, cudaStream_t);
  static const Launch kLaunch[] = {nullptr,
                                   &launch_bf16<kModeConv1>,
                                   &launch_bf16<kModeConv2>,
                                   &launch_bf16_persistent<kModeConv1Z>,
                                   &launch_bf16_persistent<kModeDgrad2>,
                                   &launch_bf16<kModeDgrad1>,
                                   &launch_bf16_persistent<kModeConv2F32>,
                                   &launch_bf16_persistent<kModeDgrad1F32>};
  if (mode < kModeConv1 || mode > kModeDgrad1F32) return static_cast<int>(cudaErrorInvalidValue);
  if (encode_tiled() == nullptr) return kErrNoEncoder;
  const bool f32_stream = on_f32_stream(mode);
  CUtensorMap m_in, m_wt;
  if (!encode_nhwc(&m_in, kBf16, x, B, H, W, C, kTileW, kTileH) ||
      !encode_weight(&m_wt, kBf16, wt, C, 1, bf16cfg::kBN))
    return kErrEncode;
  // the maps a mode does not read are passed unused, as copies of m_in; the
  // fp32-stream modes' maps of the stream and the output are fp32, box (32,
  // 64, 1, 1)
  CUtensorMap m_res = m_in, m_out = m_in, m_aux = m_in;
  const Elem out_elem = f32_stream ? kF32 : kBf16;
  if (!encode_nhwc(&m_out, out_elem, out, B, H, W, C, kTileW, 1) ||
      ((reads_res_tile(mode) || f32_stream) &&
       !encode_nhwc(&m_res, out_elem, res, B, H, W, C, kTileW, 1)) ||
      (writes_aux_tile(mode) && !encode_nhwc(&m_aux, kBf16, aux, B, H, W, C, kTileW, 1)))
    return kErrEncode;
  return static_cast<int>(kLaunch[mode](m_in, m_wt, m_res, m_out, m_aux, bias, scale, shift,
                                        ss_stride, f32_stream ? res : nullptr,
                                        f32_stream ? out : nullptr, B, H, W, C,
                                        static_cast<cudaStream_t>(stream)));
}

extern "C" int hicdiff_conv3x3_f32(const void* x, const void* wt, const void* bias,
                                   const void* scale, const void* shift,
                                   long long ss_stride, const void* res, void* out, void* aux,
                                   int B, int H, int W, int C, int mode, void* stream) {
  using Launch = cudaError_t (*)(const CUtensorMap&, const CUtensorMap&, const void*,
                                 const void*, const void*, long long, const void*, void*,
                                 void*, int, int, int, int, cudaStream_t);
  static const Launch kLaunch[] = {nullptr,
                                   &launch_f32<kModeConv1>,
                                   &launch_f32<kModeConv2>,
                                   &launch_f32<kModeConv1Z>,
                                   &launch_f32<kModeDgrad2>,
                                   &launch_f32<kModeDgrad1>};
  if (mode < kModeConv1 || mode > kModeDgrad1) return static_cast<int>(cudaErrorInvalidValue);
  if (encode_tiled() == nullptr) return kErrNoEncoder;
  CUtensorMap m_in, m_wt;
  if (!encode_nhwc(&m_in, kF32, x, B, H, W, C, kTileW, kTileH) ||
      !encode_weight(&m_wt, kF32, wt, C, 2, f32cfg::kBN))
    return kErrEncode;
  return static_cast<int>(kLaunch[mode](m_in, m_wt, bias, scale, shift, ss_stride, res, out,
                                        aux, B, H, W, C, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* hicdiff_cuda_error_string(int code) {
  if (code == kErrNoEncoder) return "cuTensorMapEncodeTiled not found in libcuda.so.1";
  if (code == kErrEncode) {
    thread_local char msg[96];
    snprintf(msg, sizeof(msg), "cuTensorMapEncodeTiled rejected a tensor map: CUresult %d",
             static_cast<int>(last_encode_error));
    return msg;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
