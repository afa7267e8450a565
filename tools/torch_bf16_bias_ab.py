"""What adding each bf16 bias after its product costs the bf16 backbone on
the card, for one checkout: the device launches and the time of one bf16
forward of the full-width self-conditioned `HicedrnDiff` at a service batch,
the host's enqueue time of that forward, and the request latencies of a bf16
`DenoiseService` served on a Unix socket as `chip_smoke.py`'s `serve` phase
serves it (its `serve_and_profile`, the checkout's own). Run it once per
checkout in one call, alternating the two (each run imports the package and
`chip_smoke.py` from `--root`):

  git archive <parent> | tar -x -C build/parent
  for tag in parent change change parent; do
    root=$([ $tag = parent ] && echo build/parent || echo .)
    python tools/torch_bf16_bias_ab.py --root $root --tag $tag --out chiprun_out/bias_ab.jsonl
  done

Each run appends one JSON line to `--out` and prints it.
"""
import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def forward_launches(model, args):
    """Device activities of one forward under torch.profiler: their count,
    summed device ms, and the count by kernel name (the 12 most)."""
    import torch
    from torch.autograd import DeviceType

    with torch.no_grad():
        model(*args)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            model(*args)
            torch.cuda.synchronize()
    ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = {}
    for e in ops:
        by_name[e.name[:80]] = by_name.get(e.name[:80], 0) + 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return len(ops), sum(e.time_range.elapsed_us() for e in ops) / 1e3, dict(top)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=REPO, help="the checkout to measure")
    ap.add_argument("--tag", required=True)
    ap.add_argument("--requests", type=int, default=5)
    ap.add_argument("--out", default="chiprun_out/bias_ab.jsonl")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    import chip_smoke as smoke
    from hicdiff_tpu_torch.kernels.resblock import fused_resblock
    from hicdiff_tpu_torch.models.hicedrn import HicedrnDiff
    from hicdiff_tpu_torch.serve import DenoiseService

    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    for mod in (smoke, sys.modules["hicdiff_tpu_torch"]):
        assert os.path.abspath(mod.__file__).startswith(root + os.sep), mod.__file__
    dev = torch.device("cuda")
    # as chip_smoke.py's main sets them before its serve phase
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=30).stdout.strip()
    model = HicedrnDiff(self_condition=True, number_resnet=smoke.BLOCKS,
                        features=smoke.FEATURES, dtype=torch.bfloat16, device=dev,
                        generator=torch.Generator().manual_seed(1))
    g = torch.Generator().manual_seed(0)
    fargs = [(torch.randn(smoke.STEP_SHAPE, generator=g) * 0.3).to(dev),
             torch.tensor([3, 29, 100, 250, 500, 700, 900, 999], device=dev),
             (torch.randn(smoke.STEP_SHAPE, generator=g) * 0.3).to(dev)]
    fused_resblock.launches = 0
    n_ops, device_ms, top = forward_launches(model, fargs)
    resblock_launches = fused_resblock.launches // 2  # the warm-up forward, then the profiled
    with torch.no_grad():
        fwd_ms = smoke.cuda_ms(lambda: model(*fargs), iters=10)
        fwd_host_us = smoke.host_us(lambda: model(*fargs), iters=10, reps=5)
    del model
    torch.cuda.empty_cache()
    t0 = time.time()
    service = DenoiseService(None, device=dev, sigma=smoke.SIGMA, schedule="sigmoid",
                             timesteps=1000, t_start="auto", batch=smoke.BATCH, bf16=True,
                             blocks=smoke.BLOCKS, features=smoke.FEATURES, seed=0)
    startup_s = time.time() - t0
    served = smoke.serve_and_profile(service, args.requests, "bfloat16", card)
    rec = {"tag": args.tag, "root": os.path.relpath(root, REPO), "card": card,
           "forward": {"shape": list(smoke.STEP_SHAPE), "dtype": "bfloat16",
                       "device_activities": n_ops, "device_ms": device_ms,
                       "resblock_launches": resblock_launches, "event_ms": fwd_ms,
                       "host_enqueue_ms": fwd_host_us / 1e3, "by_name": top},
           "serve": {"startup_s": startup_s, "steps": served["steps"],
                     "latency_s": served["latencies"], "profiled_s": served["profiled_s"],
                     "device_busy_ms": served["busy_ms"],
                     "idle_share_of_wall": served["idle_share_of_wall"]}}
    print(json.dumps(rec), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "a") as f:
        f.write(json.dumps(rec) + "\n")


if __name__ == "__main__":
    main()
