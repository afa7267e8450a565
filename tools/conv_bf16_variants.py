#!/usr/bin/env python
"""Variants of the bf16 conv's persistent modes 3 and 4, timed beside them on one card.

    python tools/conv_bf16_variants.py [--reps 3]

Compiles patched copies of `hicdiff_tpu_torch/csrc/resblock.cu` (with its
`hopper.cuh`) into `build/conv_bf16_variants/`, one `nvcc` each, all started
together, loads each with ctypes, and calls its `hicdiff_conv3x3_bf16` in
modes 3 and 4 at (64,64,64,256) and (8,64,64,256) on the same bf16 inputs:
CUDA-event ms (chip_smoke.py's `cuda_ms`), the variants interleaved over
`--reps` rounds with the committed kernel, which is also timed in modes 1,
2 and 5 (one block a tile; the same GEMMs). Each loop starts after 0.3 s
of idle card, and each round starts one variant later than the last: timed
back to back, the later loops of a round ran slower on the H100 under its
power cap, the same code included. Beside each variant, its largest
difference from the committed kernel's outputs in the same modes (h and z,
dz and du; h, y and dx) and the share of them that are not bit-equal.
Prints the card's name and power limit, then one JSON line per shape. It
needs a CUDA device and fails without one, and fails if a patch no longer
applies to the sources.

Each variant undoes one choice of the design (see the note at the top of
resblock.cu):
- `one_tile_a_block`: a block for every tile (grid = tiles, not
  min(tiles, SMs)), so no epilogue overlaps the next tile's loads;
- `exact_sigmoid`: expf and an IEEE divide in the SiLU and silu';
- `threads_288`: one producer warp and no setmaxnreg (168 registers a
  thread);
- `z_load_at_kblock_0`: mode 4 loads z right after the first k-block;
- `aux_from_registers`: the second tile (mode 3's z, mode 4's du) stored
  from the registers straight to device memory, bf16 pairs, with no second
  pass through the output tile and no wait for the first store's read.

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
MODES_125 = "persistent_125"

EPILOGUE_FIRST = "    // first tile: mode 3 z = acc + bias; mode 4 dz = du (scale + 1), and du\n"
EPILOGUE_LAST = "  if (leader) bulk_wait_read();  // shared memory outlives the last stores' reads\n"
REGISTERS_EPILOGUE = r'''    // the second tile from the registers; the first through the output tile
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
        cu = _replace(cu, '  static_assert(MODE == kModeConv1Z || MODE == kModeDgrad2, '
                          '"the second-tile modes");\n', "", name)
        cu = _replace(cu, "pv[0][i] = in_c && MODE == kModeConv1Z ?",
                      "pv[0][i] = in_c && reads_bias(MODE) ?", name)
        cu = _replace(cu, "if (MODE == kModeDgrad2 && kb == kResLoadKb && leader) {",
                      "if (reads_res_tile(MODE) && kb == kResLoadKb && leader) {", name)
        cu = _replace(cu, "if (MODE == kModeConv1Z && leader) bulk_wait_read();",
                      "if (!reads_res_tile(MODE) && leader) bulk_wait_read();", name)
        cu = _replace(cu, "    if (MODE == kModeDgrad2) {\n      mbar_wait(&res_ready[row], phase);",
                      "    if (reads_res_tile(MODE)) {\n      mbar_wait(&res_ready[row], phase);",
                      name)
        cu = _replace(cu, EPILOGUE_FIRST, ONE_PASS_EPILOGUE + EPILOGUE_FIRST, name)
        for mode in ("kModeConv1", "kModeConv2", "kModeDgrad1"):
            cu = _replace(cu, f"&launch_bf16<{mode}>,", f"&launch_bf16_persistent<{mode}>,", name)
        return cu
    if name == "aux_from_registers":
        cu = _replace(cu, "                                   const __nv_bfloat16* __restrict__ "
                          "shift, long long ss_stride,\n                                   int B,",
                      "                                   const __nv_bfloat16* __restrict__ "
                      "shift, long long ss_stride,\n                                   "
                      "__nv_bfloat16* __restrict__ aux_ptr, int B,", name)
        cu = _replace(cu, "const void* shift, long long ss_stride, const void*, void*,",
                      "const void* shift, long long ss_stride, const void*, void* aux_ptr,", name)
        cu = _replace(cu, "static_cast<const __nv_bfloat16*>(shift), ss_stride, B, H, W, C);",
                      "static_cast<const __nv_bfloat16*>(shift), ss_stride,\n"
                      "                     static_cast<__nv_bfloat16*>(aux_ptr), B, H, W, C);",
                      name)
        # modes 3 and 4 get aux where the fp32-stream modes get their output
        cu = _replace(cu, "f32_stream ? out : nullptr, B, H, W, C,",
                      "f32_stream ? out : aux, B, H, W, C,", name)
        i0 = cu.index(EPILOGUE_FIRST)
        i1 = cu.index(EPILOGUE_LAST, i0)
        return cu[:i0] + REGISTERS_EPILOGUE + cu[i1:]
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
    libs, ptxas = build((*VARIANTS, MODES_125))
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
        # mode: (src, weight, bias, res, out, aux)
        args_of = {1: (x, wp, bias, None, hid, None), 2: (hid, wp, bias, x, y2, None),
                   3: (x, wp, bias, None, hid, z), 4: (gy, wt, scale, z, dz, du),
                   5: (dz, wt, scale, gy, dx5, None)}
        modes_of = {"kernel": (1, 2, 3, 4, 5), **{v: (3, 4) for v in VARIANTS},
                    MODES_125: (1, 2, 5)}

        def call(lib, mode):
            src, wgt, bia, res, dst, aux = args_of[mode]
            _build.check_status(libs[lib], fns[lib](
                src.data_ptr(), wgt.data_ptr(), bia.data_ptr(), scale.data_ptr(),
                shift.data_ptr(), scale.stride(0), None if res is None else res.data_ptr(),
                dst.data_ptr(), None if aux is None else aux.data_ptr(), *shape, mode, stream),
                f"{lib} mode {mode}")

        def outputs(lib, modes):
            """The outputs of `modes` in order, from fixed z and dz."""
            z.copy_(z0)
            dz.copy_(dz0)
            got = {}
            for mode in modes:
                call(lib, mode)
                got.update({1: {"h": hid}, 2: {"y": y2}, 3: {"h": hid, "z": z},
                            4: {"dz": dz, "du": du}, 5: {"dx": dx5}}[mode])
                got = {k: t.clone() for k, t in got.items()}
            return got

        z0, dz0 = z.clone(), dz.clone()
        want = {m: outputs("kernel", m) for m in ((3, 4), (1, 2, 5))}
        row = {"shape": shape, "card": card, "kernel": {}}
        for lib, modes in modes_of.items():
            if lib != "kernel":
                got, ref = outputs(lib, modes), want[(3, 4) if 3 in modes else (1, 2, 5)]
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


if __name__ == "__main__":
    main()
