#!/usr/bin/env python
"""Variants of the bf16 conv's persistent modes 3, 4, 6 and 7, timed beside them on one card.

    python tools/conv_bf16_variants.py [--reps 3]

Compiles patched copies of `hicdiff_tpu_torch/csrc/resblock.cu` (with its
`hopper.cuh`) into `build/conv_bf16_variants/`, one `nvcc` each, all started
together, loads each with ctypes, and calls its `hicdiff_conv3x3_bf16` in
modes 3 and 4 or 6 and 7 at (64,64,64,256) and (8,64,64,256) on the same
inputs: CUDA-event ms (chip_smoke.py's `cuda_ms`), the variants interleaved
over `--reps` rounds with the committed kernel, which is also timed in
modes 1, 2 and 5 (one block a tile; the same GEMMs). Each loop starts after
0.3 s of idle card, and each round starts one variant later than the last:
timed back to back, the later loops of a round ran slower on the H100 under
its power cap, the same code included. Beside each variant, its largest
difference from the committed kernel's outputs in the same modes (h and z,
dz and du; y and dx; h, y and dx) and the share of them that are not
bit-equal. Prints the card's name and power limit, then one JSON line per
shape. It needs a CUDA device and fails without one, and fails if a patch
no longer applies to the sources.

Each variant undoes one choice of the design (see the note at the top of
resblock.cu):
- `one_tile_a_block`: a block for every tile (grid = tiles, not
  min(tiles, SMs)), so no epilogue overlaps the next tile's loads (modes
  3, 4, 6 and 7);
- `exact_sigmoid`: expf and an IEEE divide in the SiLU and silu';
- `threads_288`: one producer warp and no setmaxnreg (168 registers a
  thread);
- `z_load_at_kblock_0`: mode 4 loads z right after the first k-block;
- `aux_from_registers`: the second tile (mode 3's z, mode 4's du) stored
  from the registers straight to device memory, bf16 pairs, with no second
  pass through the output tile and no wait for the first store's read;
- `stream_registers` (modes 6 and 7): the other design of the fp32
  stream, with no pass through shared memory: a 4-stage ring (no output
  tile), the row's stream asked for in L2 by TMA half a main loop ahead,
  then read with `__ldg` and the sum stored straight from the registers
  (float2 a lane, one pixel's 32 bytes a quad of lanes);
- `stream_halves` (modes 6 and 7): the stream in two parts of 128 channels
  (32 KB), one at a time in the row, so the second part's load waits for
  the first part's store;
- `stream_eighths` (modes 6 and 7): parts of 32 channels (8 KB), four in
  the row at a time;
- `stream_prefetch_l2` (modes 6 and 7): the parts after the first two are
  asked for in L2 by TMA (`cp.async.bulk.prefetch.tensor`) when the first
  two are loaded.

One more variant measures the skeleton for the modes it does not run:
`persistent_125` launches modes 1, 2 and 5 on the persistent kernel too,
each with one pass through its row of the output tile and one store (mode
1 with the one-tile kernel's exact SiLU, modes 2 and 5 loading their
residual where mode 4 loads z); it is timed in those modes beside the
one-tile kernel.
"""
import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "hicdiff_tpu_torch", "csrc")
OUT = os.path.join(REPO, "build", "conv_bf16_variants")
SHAPES = ((64, 64, 64, 256), (8, 64, 64, 256))
VARIANTS = ("one_tile_a_block", "exact_sigmoid", "threads_288", "z_load_at_kblock_0",
            "aux_from_registers")
STREAM_VARIANTS = ("stream_registers", "stream_halves", "stream_eighths", "stream_prefetch_l2")
MODES_125 = "persistent_125"

EPILOGUE_FIRST = "    // first tile: mode 3 z = acc + bias; mode 4 dz = du (scale + 1), and du\n"
EPILOGUE_LAST = "  if (leader) bulk_wait_read();  // shared memory outlives the last stores' reads\n"
REGISTERS_EPILOGUE = r'''    // the second tile from the registers; the first through the output tile
    __nv_bfloat16* aux_ptr = reinterpret_cast<__nv_bfloat16*>(out_f32);
    const int h = h0 + row;
    const long long row_base = (static_cast<long long>(b) * H + h) * W;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = j * 8 + q * 2;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int w = w_lo + 8 * half;
        const int off = (j / 8) * kBoxBytes + w * 128 + (((j % 8) ^ r8) * 16) + q * 4;
        __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(epi + off);
        const float v0 = acc[4 * j + 2 * half], v1 = acc[4 * j + 2 * half + 1];
        __nv_bfloat162 second;
        if constexpr (MODE == kModeConv1Z) {
          const float z0 = v0 + p_bias[n], z1 = v1 + p_bias[n + 1];
          second = __floats2bfloat162_rn(z0, z1);
          *p = __floats2bfloat162_rn(silu_fast(z0 * p_scale1[n] + p_shift[n]),
                                     silu_fast(z1 * p_scale1[n + 1] + p_shift[n + 1]));
        } else {
          const float2 z = __bfloat1622float2(*p);
          const float du0 = dgrad2_du_fast(v0, z.x, p_scale1[n], p_shift[n]);
          const float du1 = dgrad2_du_fast(v1, z.y, p_scale1[n + 1], p_shift[n + 1]);
          second = __floats2bfloat162_rn(du0, du1);
          *p = __floats2bfloat162_rn(du0 * p_scale1[n], du1 * p_scale1[n + 1]);
        }
        if (h < H && w0 + w < W && n0 + n < C)
          *reinterpret_cast<__nv_bfloat162*>(aux_ptr + (row_base + w0 + w) * C + n0 + n) = second;
      }
    }
    fence_proxy_async();
    warpgroup_sync(row);
    if (leader) {
      for (int j = 0; j < boxes; ++j)
        tma_store_4d(&map_out, epi + j * kBoxBytes, n0 + j * 64, w0, h0 + row, b);
      bulk_commit();
    }
  }
'''


ONE_PASS_EPILOGUE = r'''    if constexpr (!writes_aux_tile(MODE)) {  // modes 1, 2, 5: one pass, one store
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
            v0 = (v0 + p_bias[n]) * p_scale1[n] + p_shift[n];
            v1 = (v1 + p_bias[n + 1]) * p_scale1[n + 1] + p_shift[n + 1];
            v0 = v0 / (1.0f + expf(-v0));
            v1 = v1 / (1.0f + expf(-v1));
          } else {
            const float2 r = __bfloat1622float2(*p);
            if constexpr (MODE == kModeConv2) {
              v0 = (v0 + p_bias[n]) * 0.1f + r.x;
              v1 = (v1 + p_bias[n + 1]) * 0.1f + r.y;
            } else {
              v0 += r.x;
              v1 += r.y;
            }
          }
          *p = __floats2bfloat162_rn(v0, v1);
        }
      }
      fence_proxy_async();
      warpgroup_sync(row);
      if (leader) {
        for (int j = 0; j < boxes; ++j)
          tma_store_4d(&map_out, epi + j * kBoxBytes, n0 + j * 64, w0, h0 + row, b);
        bulk_commit();
      }
      continue;
    }
'''


STREAM_PRELOAD = r"""      if (on_f32_stream(MODE) && kb == kResLoadKb && leader) {
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
"""
PREFETCH_HELPER = r"""// This thread asks for the (32 fp32 c, 64 w, 1 h, 1 b) box at (c0, c1, c2,
// c3) of `map` in L2, without waiting and without shared memory.
__device__ __forceinline__ void tma_prefetch_l2_4d(const CUtensorMap* map, int c0, int c1, int c2,
                                                   int c3) {
  asm volatile(
      "cp.async.bulk.prefetch.tensor.4d.L2.global.tile [%0, {%1, %2, %3, %4}];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

"""
SMEM_BASE = """  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
"""
PREFETCH_AT = "// The k-block at which mode 4 starts the TMA load"
PRELOAD_PREFETCH = r"""        for (int p = kStreamSlots; p < parts; ++p)
          for (int i = 0; i < kStreamBoxes; ++i)
            tma_prefetch_l2_4d(&map_res, n0 + p * kStreamCh + i * 32, w0, h0 + row, b);
      }
"""
STREAM_FIRST = "    if constexpr (on_f32_stream(MODE)) {\n      // y = fp32(bf16((acc + bias) 0.1))"
STREAM_LAST = "      continue;\n    }\n"
REGISTERS_PREFETCH = r"""      if (on_f32_stream(MODE) && kb == kblocks / 2 && leader) {
        // this row's fp32 stream into L2, half a main loop before the
        // epilogue reads it
        for (int j = 0; j < min(BN, C - n0) / 32; ++j)
          tma_prefetch_l2_4d(&map_res, n0 + j * 32, w0, h0 + row, b);
      }
"""
REGISTERS_STREAM_EPILOGUE = r"""    if constexpr (on_f32_stream(MODE)) {
      // y = fp32(bf16((acc + bias) 0.1)) + x or dx = fp32(bf16(acc)) + g:
      // the fp32 stream from L2 and the sum straight from the registers to
      // device memory. A quad of lanes reads and writes one pixel's 32
      // contiguous bytes, a whole sector; pixels and channels outside the
      // tensor are skipped.
      const int h = h0 + row;
      if (h < H) {
        const long long row_base = (static_cast<long long>(b) * H + h) * W;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int w = w0 + w_lo + 8 * half;
          if (w >= W) continue;
          const long long pix = (row_base + w) * C + n0;
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
            const int n = j * 8 + q * 2;
            if (n0 + n >= C) continue;
            float v0 = acc[4 * j + 2 * half], v1 = acc[4 * j + 2 * half + 1];
            if constexpr (MODE == kModeConv2F32) {
              v0 = (v0 + p_bias[n]) * 0.1f;
              v1 = (v1 + p_bias[n + 1]) * 0.1f;
            }
            const float2 r = __ldg(reinterpret_cast<const float2*>(res_f32 + pix + n));
            *reinterpret_cast<float2*>(out_f32 + pix + n) =
                make_float2(round_bf16(v0) + r.x, round_bf16(v1) + r.y);
          }
        }
      }
      warpgroup_sync(row);  // every read of the bias slots before the next tile's writes
      continue;
    }
"""


def _replace(text, old, new, what):
    if old not in text:
        raise SystemExit(f"conv_bf16_variants.py: the patch '{what}' no longer applies")
    return text.replace(old, new)


def patched(name, cu):
    """resblock.cu of variant `name`."""
    if name == "one_tile_a_block":
        return _replace(cu, "kernel<<<std::min(static_cast<int>(tiles.x * tiles.y), sms),",
                        "kernel<<<static_cast<int>(tiles.x * tiles.y) + 0 * sms,", name)
    if name == "exact_sigmoid":
        cu = _replace(cu, "  return __fdividef(v, 1.0f + __expf(-v));",
                      "  return v / (1.0f + expf(-v));", name)
        return _replace(cu, "  const float s = __fdividef(1.0f, 1.0f + __expf(-u));",
                        "  const float s = 1.0f / (1.0f + expf(-u));", name)
    if name == "threads_288":
        cu = _replace(cu, "constexpr int kPThreads = 32 * kConsumerWarps + 128;",
                      "constexpr int kPThreads = 32 * kConsumerWarps + 32;", name)
        cu = _replace(cu, '    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\\n" '
                          '::"n"(kProducerRegs));\n', "", name)
        return _replace(cu, '  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\\n" '
                            '::"n"(kConsumerRegs));\n', "", name)
    if name == "z_load_at_kblock_0":
        return _replace(cu, "constexpr int kResLoadKb = 2;", "constexpr int kResLoadKb = 0;",
                        name)
    if name == MODES_125:
        cu = _replace(cu, "  static_assert(writes_aux_tile(MODE) || on_f32_stream(MODE),\n"
                          '                "the second-tile and fp32-stream modes");\n', "", name)
        cu = _replace(cu, "if (MODE == kModeDgrad2 && kb == kResLoadKb && leader) {",
                      "if (reads_res_tile(MODE) && kb == kResLoadKb && leader) {", name)
        cu = _replace(cu, "if (MODE == kModeConv1Z && leader) bulk_wait_read();",
                      "if (!reads_res_tile(MODE) && leader) bulk_wait_read();", name)
        cu = _replace(cu, "    if (MODE == kModeDgrad2) {\n      mbar_wait(&res_ready[0],",
                      "    if (reads_res_tile(MODE)) {\n      mbar_wait(&res_ready[0],", name)
        cu = _replace(cu, EPILOGUE_FIRST, ONE_PASS_EPILOGUE + EPILOGUE_FIRST, name)
        for mode in ("kModeConv1", "kModeConv2", "kModeDgrad1"):
            cu = _replace(cu, f"&launch_bf16<{mode}>,", f"&launch_bf16_persistent<{mode}>,", name)
        return cu
    if name == "aux_from_registers":
        # modes 3 and 4 get aux where the fp32-stream modes get their output
        cu = _replace(cu, "f32_stream ? out : nullptr, B, H, W, C,",
                      "f32_stream ? out : aux, B, H, W, C,", name)
        i0 = cu.index(EPILOGUE_FIRST)
        i1 = cu.index(EPILOGUE_LAST, i0)
        return cu[:i0] + REGISTERS_EPILOGUE + cu[i1:]
    if name == "stream_prefetch_l2":
        cu = _replace(cu, PREFETCH_AT, PREFETCH_HELPER + PREFETCH_AT, name)
        return _replace(cu, STREAM_PRELOAD, STREAM_PRELOAD[:-len("      }\n")] + PRELOAD_PREFETCH,
                        name)
    if name in ("stream_halves", "stream_eighths"):
        return _replace(cu, "constexpr int kStreamCh = 64;",
                        f"constexpr int kStreamCh = {128 if name == 'stream_halves' else 32};",
                        name)
    if name == "stream_registers":
        # 4 stages in modes 6 and 7, over the output tile they no longer use
        cu = _replace(cu, "  constexpr int S = kStages;\n" + SMEM_BASE + "  uint64_t* full = "
                      "reinterpret_cast<uint64_t*>(smem + kPBars);",
                      "  constexpr int S = on_f32_stream(MODE) ? 4 : kStages;\n" + SMEM_BASE +
                      "  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kPBars);", name)
        cu = _replace(cu, "kPBars + (2 * kStages + kTileH * kStreamSlots) * 8",
                      "kPBars + (2 * 4 + kTileH * kStreamSlots) * 8", name)
        cu = _replace(cu, PREFETCH_AT, PREFETCH_HELPER + PREFETCH_AT, name)
        cu = _replace(cu, STREAM_PRELOAD, REGISTERS_PREFETCH, name)
        i0 = cu.index(STREAM_FIRST)
        i1 = cu.index(STREAM_LAST, i0) + len(STREAM_LAST)
        return cu[:i0] + REGISTERS_STREAM_EPILOGUE + cu[i1:]
    raise ValueError(name)


def build(names):
    """name -> the variant's library; "kernel" is the committed one."""
    from hicdiff_tpu_torch.kernels import _build

    cu = open(os.path.join(CSRC, "resblock.cu")).read()
    cuh = open(os.path.join(CSRC, "hopper.cuh")).read()
    procs = {}
    for name in names:
        d = os.path.join(OUT, name)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "resblock.cu"), "w") as f:
            f.write(patched(name, cu))
        with open(os.path.join(d, "hopper.cuh"), "w") as f:
            f.write(cuh)
        so = os.path.join(d, "lib.so")
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", so,
               os.path.join(d, "resblock.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so)
    libs = {"kernel": _build.load_library()}
    ptxas = {}
    for name, (proc, so) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on variant {name}:\n{log[-3000:]}")
        ptxas[name] = [ln.strip() for ln in log.splitlines()
                       if "persistent" in ln or "spill" in ln or "Used" in ln][-6:]
        libs[name] = ctypes.CDLL(so)
    return libs, ptxas


def entry(lib):
    p = ctypes.c_void_p
    fn = lib.hicdiff_conv3x3_bf16
    fn.argtypes = [p, p, p, p, p, ctypes.c_longlong, p, p, p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, p]
    fn.restype = ctypes.c_int
    return fn


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3, help="interleaved rounds of timing")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("conv_bf16_variants.py needs a CUDA device")
    sys.path.insert(0, REPO)
    from hicdiff_tpu_torch.kernels import _build
    from hicdiff_tpu_torch.kernels.resblock import prepare_weight, transpose_kernel

    spec = importlib.util.spec_from_file_location("_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    libs, ptxas = build((*VARIANTS, *STREAM_VARIANTS, MODES_125))
    fns = {name: entry(lib) for name, lib in libs.items()}
    print(json.dumps({"card": card, "ptxas": ptxas}), flush=True)
    dev = torch.device("cuda")
    bf = torch.bfloat16
    stream = torch.cuda.current_stream().cuda_stream
    for shape in SHAPES:
        b, h, w, c = shape
        g = torch.Generator(device=dev).manual_seed(4)
        x, gy, z, hid, dz, du, out = ((torch.randn(shape, generator=g, device=dev) * 0.5).to(bf)
                                      for _ in range(7))
        kernel = (torch.randn(3, 3, c, c, generator=g, device=dev) / (9 * c) ** 0.5).to(bf)
        bias = (torch.randn(c, generator=g, device=dev) * 0.05).to(bf)
        scale, shift = (torch.randn(b, 2 * c, generator=g, device=dev) * 0.5).to(bf).chunk(2, -1)
        wp, wt = prepare_weight(kernel), prepare_weight(transpose_kernel(kernel))
        y2, dx5 = torch.empty_like(x), torch.empty_like(x)
        res32 = torch.randn(shape, generator=g, device=dev) * 0.5  # the fp32 stream
        y6, dx7 = torch.empty_like(res32), torch.empty_like(res32)
        # mode: (src, weight, bias, res, out, aux)
        args_of = {1: (x, wp, bias, None, hid, None), 2: (hid, wp, bias, x, y2, None),
                   3: (x, wp, bias, None, hid, z), 4: (gy, wt, scale, z, dz, du),
                   5: (dz, wt, scale, gy, dx5, None), 6: (hid, wp, bias, res32, y6, None),
                   7: (dz, wt, scale, res32, dx7, None)}
        modes_of = {"kernel": (1, 2, 3, 4, 5, 6, 7), **{v: (3, 4) for v in VARIANTS},
                    "one_tile_a_block": (3, 4, 6, 7), **{v: (6, 7) for v in STREAM_VARIANTS},
                    MODES_125: (1, 2, 5)}

        def call(lib, mode):
            src, wgt, bia, res, dst, aux = args_of[mode]
            _build.check_status(libs[lib], fns[lib](
                src.data_ptr(), wgt.data_ptr(), bia.data_ptr(), scale.data_ptr(),
                shift.data_ptr(), scale.stride(0), None if res is None else res.data_ptr(),
                dst.data_ptr(), None if aux is None else aux.data_ptr(), *shape, mode, stream),
                f"{lib} mode {mode}")

        def outputs(lib, modes):
            """The outputs of `modes` in order, from fixed z, dz and h."""
            z.copy_(z0)
            dz.copy_(dz0)
            hid.copy_(hid0)
            got = {}
            for mode in modes:
                call(lib, mode)
                got.update({1: {"h": hid}, 2: {"y": y2}, 3: {"h": hid, "z": z},
                            4: {"dz": dz, "du": du}, 5: {"dx": dx5}, 6: {"y6": y6},
                            7: {"dx7": dx7}}[mode])
                got = {k: t.clone() for k, t in got.items()}
            return got

        z0, dz0, hid0 = z.clone(), dz.clone(), hid.clone()
        want = {m: outputs("kernel", m) for m in set(modes_of.values())}
        row = {"shape": shape, "card": card, "kernel": {}}
        for lib, modes in modes_of.items():
            if lib != "kernel":
                got, ref = outputs(lib, modes), want[modes]
                row[lib] = {"against_kernel": {
                    n: {"max_abs": (a.float() - ref[n].float()).abs().max().item(),
                        "share_not_bit_equal": (a != ref[n]).float().mean().item()}
                    for n, a in got.items()}}
            for mode in modes:
                row[lib][f"mode{mode}_ms"] = []

        def timed(lib, mode):
            time.sleep(0.3)  # an idle card before every loop
            return smoke.cuda_ms(lambda: call(lib, mode), iters=10)

        order = list(modes_of)
        for rep in range(args.reps):
            for lib in order[rep % len(order):] + order[:rep % len(order)]:
                for mode in modes_of[lib]:
                    row[lib][f"mode{mode}_ms"].append(timed(lib, mode))
        print(json.dumps(row), flush=True)
        del x, gy, z, hid, dz, du, out, y2, dx5, kernel, bias, scale, shift, wp, wt, want
        del res32, y6, dx7


if __name__ == "__main__":
    main()
