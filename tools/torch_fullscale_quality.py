"""Train the flagship on the full-scale synthetic cell and score it against
the latent ground truth, through the port's entry points: the JAX package's
full-scale protocol (artifacts/fullscale_runs.txt) on the card.

  1. the fixture: tools/torch_make_fullscale_fixture.py (seed 7, band 257,
     hg19's bins), contact lists in the trainer's `_p99.99` cache, latents
     and weights in ROOT/latent;
  2. training: train_torch.py's HiCDiff at `-u 0 -b 64 -e 150 -s 0.1
     --schedule sigmoid --timestep 1000 --bf16 --ema-decay 0.999`, each
     step timed by the trainer's CUDA events;
  3. inference: inference_torch.py's Inference on the best checkpoint
     (`-u 0 -b 64 -s 0.1 --bf16 --t-start auto --chro all`), the truncated
     chain and again with `--sampling-steps 1`;
  4. scoring: tools/torch_latent_target.py at percentile 99.99, then
     tools/torch_quartet_metrics.py for the prediction, the identity (noisy)
     row and the realized target (the speckle floor), against the latent and
     against the realized target.

It writes one JSON summary (--out) with the val curve, the epoch and step
times, peak memory, the inference walls and every score, beside the card's
name and power limit. Run it on the card:

  python tools/torch_fullscale_quality.py --root build/fullscale \\
      --out chiprun_out/fullscale_quality_bf16.json

`--fp32` trains and samples in fp32; `--train-only` stops after training
(an epoch-time measurement); `--bins`, `--blocks`, `--features` and
`--device cpu` shrink it for a check on the host.
"""
import argparse
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import inference_torch  # noqa: E402
import train_torch  # noqa: E402
from tools.torch_latent_target import build_latent_npy  # noqa: E402
from tools.torch_make_fullscale_fixture import HG19_BINS_40KB, constraints_dir  # noqa: E402
from tools.torch_make_fullscale_fixture import make_fullscale  # noqa: E402
from tools.torch_quartet_metrics import score_quartet  # noqa: E402

SIGMA, PERCENTILE, TIMESTEP, SCHEDULE = 0.1, 99.99, 1000, "sigmoid"


def card_name_and_limit() -> str:
    """nvidia-smi's `name, power.limit` of the card, or why there is none."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "no nvidia-smi"
    except (OSError, IndexError, subprocess.TimeoutExpired):
        return "no nvidia-smi"


def _percentiles(a, qs=(50, 90, 99)):
    a = np.asarray(a, np.float64)
    return {f"p{q}": float(np.percentile(a, q)) for q in qs} | {"mean": float(a.mean())}


def make_fixture(root: str, bins, seed: int) -> dict:
    t0 = time.time()
    cdir = constraints_dir(root, SIGMA, PERCENTILE)
    nb, npx = make_fullscale(cdir, seed=seed, bins_per_chrom=bins,
                             latent_dir=os.path.join(root, "latent"))
    return {"bins": nb, "pixels": npx, "wall_s": time.time() - t0, "constraints": cdir}


def train(root: str, args, dev: torch.device) -> dict:
    """One train_torch.py run; returns its curve, times and peak memory."""
    if args.fp32:  # as train_torch.main: fp32 around the fused blocks, not TF32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.time()
    run = train_torch.HiCDiff(
        epoch=args.epochs, timestep=TIMESTEP, batch_size=64, sigma=SIGMA, condition=False,
        root=root, seed=0, bf16=not args.fp32, schedule=SCHEDULE, blocks=args.blocks,
        features=args.features, ema_decay=0.999, device=str(dev))
    setup_s = time.time() - t0
    run.trainer.time_steps = dev.type == "cuda"
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    best = run.fit_model()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    fit_s = time.time() - t0
    run.logger.close()
    hist = run.trainer.history
    best_epoch = min(hist, key=lambda r: r["valid/loss"])["Epoch"]
    out = {
        "setup_s": setup_s, "fit_s": fit_s, "best_val": best, "best_epoch": best_epoch,
        "train_patches": len(run.train_loader.dataset),
        "val_patches": len(run.val_loader.dataset),
        "epochs": [{"epoch": r["Epoch"], "train": r["train/loss"], "val": r["valid/loss"],
                    "s": r["epoch_seconds"]} for r in hist],
        "epoch_s": _percentiles([r["epoch_seconds"] for r in hist[1:] or hist]),
        "first_epoch_s": hist[0]["epoch_seconds"],
        "log": run.logger.out_path,
    }
    if dev.type == "cuda":
        steps = run.trainer.step_times_ms()
        run.trainer.step_events.clear()
        out["peak_memory_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        out["steps"] = len(steps)
        tail = steps[len(steps) // 10:]  # past the first tenth: warm
        out["step_ms"] = _percentiles([sum(s) for s in tail])
        out["step_split_ms_median"] = {
            k: float(np.median([s[i] for s in tail]))
            for i, k in enumerate(("loss_forward", "backward", "update"))}
    return out


def infer(root: str, args, dev: torch.device, sampling_steps, tag: str) -> dict:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    res = inference_torch.Inference(
        batch_size=64, sigma_t=SIGMA, condition=False, root=root, schedule=SCHEDULE,
        timestep=TIMESTEP, bf16=not args.fp32, sampling_steps=sampling_steps, chro="all",
        t_start="auto", blocks=args.blocks, features=args.features, compute_metrics=False,
        out_tag=tag, device=str(dev))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.time() - t0
    n = len(res["inds"])
    out = {"outdir": res["outdir"], "patches": n, "wall_s": wall, "patches_per_s": n / wall,
           "timing": res.get("timing")}
    if dev.type == "cuda":
        out["peak_memory_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    return out, res["data_dir"]


def score(qdir: str, data_dir: str, latent_dir: str, rows) -> dict:
    """The latent of the quartet, then each (prediction, target) row."""
    out = {"latent": build_latent_npy(qdir, data_dir, latent_dir, percentile=PERCENTILE)}
    for pred, target in rows:
        out[f"{pred}_vs_{target.split('.')[0]}"] = score_quartet(qdir, pred, target_file=target)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default="build/fullscale")
    ap.add_argument("--out", default="chiprun_out/fullscale_quality_bf16.json")
    ap.add_argument("--epochs", type=int, default=150)
    ap.add_argument("--seed", type=int, default=7, help="the fixture's seed")
    ap.add_argument("--fp32", action="store_true", help="train and sample in fp32")
    ap.add_argument("--train-only", action="store_true")
    ap.add_argument("--bins", type=int, default=None,
                    help="bins of every chromosome (default: hg19's at 40 kb)")
    ap.add_argument("--blocks", type=int, default=32)
    ap.add_argument("--features", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        sys.exit("no CUDA device; pass --device cpu for a check on the host")
    root = os.path.abspath(args.root)
    if os.path.exists(root):
        shutil.rmtree(root)
    summary = {"card": card_name_and_limit(), "torch": torch.__version__,
               "precision": "float32" if args.fp32 else "bfloat16",
               "protocol": dict(u=0, b=64, e=args.epochs, s=SIGMA, schedule=SCHEDULE,
                                timestep=TIMESTEP, ema_decay=0.999, seed=0,
                                fixture_seed=args.seed, band=257, percentile=PERCENTILE,
                                blocks=args.blocks, features=args.features)}
    t_all = time.time()
    bins = [args.bins] * len(HG19_BINS_40KB) if args.bins else None
    summary["fixture"] = make_fixture(root, bins, args.seed)
    summary["train"] = train(root, args, dev)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    if not args.train_only:
        latent_dir = os.path.join(root, "latent")
        for name, steps, tag in (("t29", None, ""), ("k1", 1, "_k1")):
            run, data_dir = infer(root, args, dev, steps, tag)
            rows = [("predict", "latent.npy"), ("predict", "target.npy")]
            if name == "t29":  # identity and floor: the same arrays in both quartets
                rows += [("noisy", "latent.npy"), ("noisy", "target.npy"),
                         ("target", "latent.npy")]
            t0 = time.time()
            run["scores"] = score(run["outdir"], data_dir, latent_dir, rows)
            run["score_s"] = time.time() - t0
            summary[name] = run
    summary["wall_s"] = time.time() - t_all
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=1)
    log = summary["train"].get("log")
    if log and os.path.exists(log):
        shutil.copy(log, os.path.splitext(args.out)[0] + "_train.jsonl")
    brief = {k: summary[k] for k in ("card", "precision", "wall_s")}
    brief["best_val"] = summary["train"]["best_val"]
    brief["best_epoch"] = summary["train"]["best_epoch"]
    for name in ("t29", "k1"):
        if name in summary:
            brief[name] = {k: {m: v[m] for m in ("pas_ssim", "pas_psnr", "pas_pcc")}
                           for k, v in summary[name]["scores"].items() if k != "latent"}
    print(json.dumps(brief))


if __name__ == "__main__":
    main()
