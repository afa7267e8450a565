#!/usr/bin/env python
"""Time the port's kernels of one checkout, to compare two commits on one card.

    python tools/torch_kernel_ab.py --root DIR [--label NAME]

imports `hicdiff_tpu_torch` from the checkout at DIR (which builds its own
kernels into DIR/build/) and prints one JSON line with the card's name and
power limit and, at the main path's shapes:

- the fp32 `fused_resblock` block (8,64,64,256) on a weight prepared once:
  CUDA-event ms (chip_smoke.py's `cuda_ms`: the median of three runs of 20
  back-to-back calls) and the torch.profiler device ms;
- `fused_posterior_step` (8,64,64,1): host µs per wrapper call (the calls
  only enqueue work; the median of 7 runs of 200 calls), CUDA-event ms,
  profiler device ms, and the device ms of a 1-element fill beside it, the
  floor of one launch;
- the bf16 `resblock_wgrad` at (8,64,64,256) and at the training batch
  (64,64,64,256): CUDA-event ms and profiler device ms, and beside it
  cuDNN's bf16 weight gradient of the same inputs (chip_smoke.py's
  `library_wgrad`), which the port never calls;
- the bf16 conv's epilogue modes 1-7 alone at the training batch
  (64,64,64,256), each through the C entry `hicdiff_conv3x3_bf16` as
  chip_smoke.py's `conv_modes_bf16` calls it, in two passes (modes 1 to 7,
  then 7 to 1), each mode's loop beside nvidia-smi's SM clock readings
  (chip_smoke.py's `card_clocks`): CUDA-event ms of each pass, their mean,
  and its share of the 0.3127 ms bound of one conv (2 B H W C 9C FLOPs at
  989 TFLOP/s); modes 6 and 7 read the fp32 stream and write fp32;
- one bf16 `-u 0` training step of the full-width backbone (32 blocks, 256
  features, batch 64) through the port's Trainer: the loss's forward, the
  backward and the update by the trainer's CUDA events (the median of 5
  steps after 2, beside the SM clock, power and power-cap readings of
  `card_clocks`), then 3 steps under torch.profiler: the device time of
  each kernel (name and template argument) and its share of the steps'
  device time;
- the same step of bf16 `hicedrn_att` (its 30 blocks after the first
  attention on the fp32 stream: modes 6 and 7), and its forward alone at
  batch 64 under no_grad (CUDA-event ms, median of 3 runs of 3);
- a served bf16 `-u 0` request: a bf16 DenoiseService at full width (the
  30-step truncated chain at sigma 0.1, batch 8), the host-clock latency of
  `denoise_patches` on 8 patches, one request untimed, then 3 timed. It runs
  modes 1 and 2 only, so it shows what the host's enqueue costs.

It calls only functions that every commit of the port with bf16 training
has, so any such commit runs. To
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


def _smoke():
    """This repo's chip_smoke.py (its timers and launch helpers), loaded by
    path so that --root's own chip_smoke.py is not the one imported; what it
    imports of the port comes from --root."""
    spec = importlib.util.spec_from_file_location("_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def conv_modes(smoke, dev):
    """Modes 1-7 of the bf16 conv at (64,64,64,256) through the C entry (not
    counted: no main-path launch): ms and share of one conv's bound."""
    from hicdiff_tpu_torch.kernels.resblock import prepare_weight, transpose_kernel

    bf = torch.bfloat16
    shape = b, h, w, c = (64, 64, 64, 256)
    g = torch.Generator(device=dev).manual_seed(12)
    x, gy, z, hid, dz, out, du = (torch.randn(shape, generator=g, device=dev).to(bf)
                                  for _ in range(7))
    stream, out32 = (torch.randn(shape, generator=g, device=dev) for _ in range(2))
    kernel = (torch.randn(3, 3, c, c, generator=g, device=dev) / (9 * c) ** 0.5).to(bf)
    bias = (torch.randn(c, generator=g, device=dev) * 0.05).to(bf)
    scale, shift = (torch.randn(b, 2 * c, generator=g, device=dev) * 0.5).to(bf).chunk(2, dim=-1)
    wp, wt = prepare_weight(kernel), prepare_weight(transpose_kernel(kernel))
    bound_ms = 2 * b * h * w * c * 9 * c / 989e12 * 1e3
    # mode: (src, weight, bias, res, out, aux)
    launches = {1: (x, wp, bias, None, hid, None), 2: (hid, wp, bias, x, out, None),
                3: (x, wp, bias, None, hid, z), 4: (gy, wt, scale, z, dz, du),
                5: (dz, wt, scale, gy, out, None), 6: (hid, wp, bias, stream, out32, None),
                7: (dz, wt, scale, stream, out32, None)}
    rows = {f"mode{m}": {"ms_passes": [], "sm_clock_mhz": []} for m in launches}
    for order in ((1, 2, 3, 4, 5, 6, 7), (7, 6, 5, 4, 3, 2, 1)):
        for mode in order:
            src, wgt, bia, res, dst, aux = launches[mode]
            clocks = {}
            with smoke.card_clocks(clocks):
                rows[f"mode{mode}"]["ms_passes"].append(smoke.cuda_ms(
                    lambda: smoke.conv_mode(mode, src, wgt, bia, scale, shift, res, dst, aux),
                    iters=10))
            rows[f"mode{mode}"]["sm_clock_mhz"].append(clocks.get("sm_clock_mhz"))
    for row in rows.values():
        row["ms"] = sum(row["ms_passes"]) / 2
        row["share_of_bound"] = bound_ms / row["ms"]
    rows["bound_ms"] = bound_ms
    return rows


def serve_bf16(dev):
    """Latencies (s) of 3 served bf16 requests of 8 patches after one."""
    import time

    import numpy as np

    from hicdiff_tpu_torch.serve import DenoiseService

    service = DenoiseService(None, device=dev, sigma=0.1, schedule="sigmoid", timesteps=1000,
                             t_start="auto", batch=8, bf16=True, blocks=32, features=256, seed=0)
    noisy = np.clip(np.random.default_rng(0).normal(0, 0.3, (8, 64, 64, 1)), -1, 1)
    service.denoise_patches(noisy)
    latencies = []
    for _ in range(3):
        t = time.perf_counter()
        service.denoise_patches(noisy)
        latencies.append(time.perf_counter() - t)
    return latencies


def train_step_bf16(smoke, dev, variant="base"):
    """One bf16 -u 0 step of the backbone `variant` (base or att) at full
    width and batch 64: its split by the trainer's CUDA events, and the
    device time of each kernel over 3 profiled steps."""
    from hicdiff_tpu_torch.diffusion.gaussian import GaussianDiffusion
    from hicdiff_tpu_torch.models.hicedrn import HicedrnDiff
    from hicdiff_tpu_torch.train.trainer import Trainer, step_generator

    model = HicedrnDiff(self_condition=True, number_resnet=32, features=256, variant=variant,
                        dtype=torch.bfloat16, device=dev,
                        generator=torch.Generator().manual_seed(0))
    engine = GaussianDiffusion.create(model, device=dev, timesteps=1000,
                                      beta_schedule="linear", mode="cond")
    trainer = Trainer(engine, lr=2e-5)
    g = torch.Generator().manual_seed(1)
    target = torch.rand(64, 64, 64, 1, generator=g) * 2 - 1
    data = (target + 0.1 * torch.randn(target.shape, generator=g)).clamp(-1, 1)
    data, target = data.to(dev), target.to(dev)
    for i in range(2):
        trainer.train_step(data, target, generator=step_generator(0, i))
    trainer.time_steps = True
    clocks = {}
    with smoke.card_clocks(clocks):
        for i in range(5):
            trainer.train_step(data, target, generator=step_generator(0, 2 + i))
        times = trainer.step_times_ms()
    trainer.time_steps = False
    split = {k: sorted(t[j] for t in times)[2] for j, k in
             enumerate(("forward_ms", "backward_ms", "update_ms"))}
    split["step_ms"] = sorted(sum(t) for t in times)[2]
    split.update(clocks)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for i in range(3):
            trainer.train_step(data, target, generator=step_generator(0, 7 + i))
        torch.cuda.synchronize()
    by_kernel = {}
    for name, _, dur in smoke.device_ops(prof):
        key = name.replace("(anonymous namespace)::", "").split("(")[0][:60]
        entry = by_kernel.setdefault(key, {"launches": 0, "ms": 0.0})
        entry["launches"] += 1
        entry["ms"] += dur / 1e3
    busy = sum(e["ms"] for e in by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1]["ms"])[:12]
    split["profiled_3_steps"] = {
        "device_ms": busy,
        "by_kernel": {k: {**v, "share": v["ms"] / busy} for k, v in top}}
    return split


def att_forward_bf16(smoke, dev):
    """CUDA-event ms of one bf16 hicedrn_att forward at full width and batch
    64 under no_grad."""
    from hicdiff_tpu_torch.models.hicedrn import HicedrnDiff

    model = HicedrnDiff(self_condition=True, number_resnet=32, features=256, variant="att",
                        dtype=torch.bfloat16, device=dev,
                        generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(2)
    x, cond = (torch.randn(64, 64, 64, 1, generator=g).mul(0.3).to(dev) for _ in range(2))
    t_in = torch.randint(0, 1000, (64,), generator=g).to(dev)
    with torch.no_grad():
        return smoke.cuda_ms(lambda: model(x, t_in, cond), iters=3)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True, help="checkout to import hicdiff_tpu_torch from")
    ap.add_argument("--label", default=None, help="name printed with the results")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_ab.py needs a CUDA device")
    sys.path.insert(0, os.path.abspath(args.root))
    from hicdiff_tpu_torch.kernels.resblock import fused_resblock_prepared, prepare_weight
    from hicdiff_tpu_torch.kernels.resblock_bwd import resblock_wgrad
    from hicdiff_tpu_torch.kernels.sample_step import fused_posterior_step

    smoke = _smoke()
    cuda_ms, device_ms = smoke.cuda_ms, smoke.profiled_ms
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
    row = {
        "label": args.label or os.path.abspath(args.root), "card": card,
        "resblock_fp32_ms": cuda_ms(block), "resblock_fp32_device_ms": device_ms(block),
        "step_host_us": smoke.host_us(step, iters=200, reps=7), "step_ms": cuda_ms(step),
        "step_device_ms": device_ms(step), "floor_device_ms": device_ms(lambda: one.fill_(1.0)),
    }
    gd = torch.Generator(device=dev).manual_seed(1)
    for batch in (8, 64):
        xw, dz, hw, gw = (torch.randn(batch, h, w, c, generator=gd, device=dev)
                          .to(torch.bfloat16) for _ in range(4))

        def wgrad():
            return resblock_wgrad(xw, dz, hw, gw)

        row[f"wgrad_bf16_b{batch}_ms"] = cuda_ms(wgrad, iters=10)
        row[f"wgrad_bf16_b{batch}_device_ms"] = device_ms(wgrad, iters=10)
        row[f"library_wgrad_bf16_b{batch}_ms"] = cuda_ms(
            lambda: smoke.library_wgrad(xw, dz, hw, gw), iters=10)
        del xw, dz, hw, gw
    row["conv_bf16_modes_b64"] = conv_modes(smoke, dev)
    row["train_bf16_step"] = train_step_bf16(smoke, dev)
    row["train_bf16_att_step"] = train_step_bf16(smoke, dev, variant="att")
    row["att_bf16_forward_b64_ms"] = att_forward_bf16(smoke, dev)
    row["serve_bf16_latency_s"] = serve_bf16(dev)
    print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
