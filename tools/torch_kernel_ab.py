#!/usr/bin/env python
"""Time the port's kernels of one checkout, to compare two commits on one card.

    python tools/torch_kernel_ab.py --root DIR [--label NAME]

imports `hicdiff_tpu_torch` from the checkout at DIR (which builds its own
kernels into DIR/build/) and prints one JSON line with the card's name and
power limit and, at the main path's shapes:

- the fp32 `fused_resblock` block (8,64,64,256) on a weight prepared once:
  CUDA-event ms of 20 back-to-back calls and the torch.profiler device ms;
- `fused_posterior_step` (8,64,64,1): host µs per wrapper call (the calls
  only enqueue work; the median of 7 runs of 200 calls), CUDA-event ms,
  profiler device ms, and the device ms of a 1-element fill beside it, the
  floor of one launch.

Only the packages' public calls are used, so any commit of the port runs. To
compare a parent with a change, unpack the parent into an ignored directory
(`git archive`) and run parent, change, change, parent in one session on one
card. It needs a CUDA device and fails without one.
"""
import argparse
import importlib.util
import json
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _timers():
    """cuda_ms, profiled_ms and host_us of this repo's chip_smoke.py, loaded
    by path so that --root's own chip_smoke.py is not the one imported."""
    spec = importlib.util.spec_from_file_location("_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke.cuda_ms, smoke.profiled_ms, smoke.host_us


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True, help="checkout to import hicdiff_tpu_torch from")
    ap.add_argument("--label", default=None, help="name printed with the results")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_ab.py needs a CUDA device")
    sys.path.insert(0, os.path.abspath(args.root))
    from hicdiff_tpu_torch.kernels.resblock import fused_resblock_prepared, prepare_weight
    from hicdiff_tpu_torch.kernels.sample_step import fused_posterior_step

    cuda_ms, device_ms, host_us = _timers()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    b, h, w, c = 8, 64, 64, 256
    bound = 1.0 / (9 * c) ** 0.5
    x = (torch.randn(b, h, w, c, generator=g) * 0.5).to(dev)
    kernel = ((torch.rand(3, 3, c, c, generator=g) * 2 - 1) * bound).to(dev)
    bias = ((torch.rand(c, generator=g) * 2 - 1) * bound).to(dev)
    scale, shift = (torch.randn(b, 2 * c, generator=g) * 0.5).to(dev).chunk(2, dim=-1)
    weight = prepare_weight(kernel)

    def block():
        return fused_resblock_prepared(x, weight, bias, scale, shift)

    xs = torch.randn(b, h, w, 1, generator=g).to(dev)
    es = torch.randn(b, h, w, 1, generator=g).to(dev)

    def step():
        return fused_posterior_step(xs, es, 1.1, 0.5, 0.7, 0.3, -2.0, 1.0, 5)

    one = torch.zeros(1, device=dev)
    print(json.dumps({
        "label": args.label or os.path.abspath(args.root), "card": card,
        "resblock_fp32_ms": cuda_ms(block), "resblock_fp32_device_ms": device_ms(block),
        "step_host_us": host_us(step, iters=200, reps=7), "step_ms": cuda_ms(step),
        "step_device_ms": device_ms(step), "floor_device_ms": device_ms(lambda: one.fill_(1.0)),
    }), flush=True)


if __name__ == "__main__":
    main()
