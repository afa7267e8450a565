"""Train a model on the full-scale synthetic cell and score it against the
latent ground truth, through the port's entry points: the JAX package's
full-scale protocols (artifacts/fullscale_runs.txt,
tools/round5_eval_queue.sh) on the card.

  1. the fixture: tools/torch_make_fullscale_fixture.py (seed 7, band 257,
     hg19's bins), contact lists in the trainer's `_p99.99` cache, latents
     and weights in ROOT/latent;
  2. training: train_torch.py's HiCDiff at `-b 64 -e 150 -s 0.1 --timestep
     1000 --bf16 --ema-decay 0.999` and `--seed` the train seed, with
     `-u 0 --schedule sigmoid` (the conditional flagship) or `-u 1
     --schedule linear` (the unconditional prior); each step timed by the
     trainer's CUDA events; every best checkpoint written (no throttle);
  3. inference: inference_torch.py's Inference on the best checkpoint (not
     the EMA, as the JAX runs), `-b 64 -s 0.1 --bf16 --t-start auto`:
     `-u 0 --chro all` runs the truncated chain (t*=29) and again with
     `--sampling-steps 1`; `-u 1 --chro test` runs DDRM deno (t*=27);
  4. scoring: tools/torch_latent_target.py at percentile 99.99, then
     tools/torch_quartet_metrics.py for the prediction, the identity (noisy)
     row and the realized target (the speckle floor), against the latent and
     against the realized target.

It writes one JSON summary (--out) with the val curve, the best val (also
over epochs 1-145, where JAX's -u 1 run stopped), the epoch and step times, peak memory, the inference walls, the kernels' launch counts and
every score, beside the card's name and power limit. Run it on the card:

  python tools/torch_fullscale_quality.py --root build/fullscale \\
      --out chiprun_out/fullscale_quality_bf16.json
  python tools/torch_fullscale_quality.py -u 1 --root build/fullscale_u1 \\
      --out chiprun_out/fullscale_quality_uncond_bf16.json
  python tools/torch_fullscale_quality.py --train-seed 1 ...

`--fp32` trains and samples in fp32; `--train-only` stops after training
(an epoch-time measurement); `--bins`, `--blocks`, `--features` and
`--device cpu` shrink it for a check on the host.

`--spread SUMMARY.json ...` trains nothing: it reads the summaries of runs
at several train seeds and prints, for each protocol's rows (`-u 0`: t*=29
and K=1; `-u 1`: DDRM; runs of another `--epochs` in rows of their own)
and each of the seven metrics against the latent,
and for the best val and its epoch, the port's mean, sample sd and range
beside JAX's value (artifacts/r5_fullscale_tables.txt; the best vals from
VALIDATION.md and the DDRM table's header) and the verdict: a gap is
systematic when JAX's value lies outside the port's range and more than
2 sample sd from the port's mean, else within the port's seed spread.
"""
import argparse
import json
import os
import re
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
from hicdiff_tpu_torch.kernels.resblock import fused_resblock  # noqa: E402
from hicdiff_tpu_torch.kernels.sample_step import fused_posterior_step  # noqa: E402
from tools.torch_latent_target import build_latent_npy  # noqa: E402
from tools.torch_make_fullscale_fixture import HG19_BINS_40KB, constraints_dir  # noqa: E402
from tools.torch_make_fullscale_fixture import make_fullscale  # noqa: E402
from tools.torch_quartet_metrics import score_quartet  # noqa: E402

SIGMA, PERCENTILE, TIMESTEP = 0.1, 99.99, 1000
# the JAX queue's per-mode flags (tools/round5_eval_queue.sh:40-66)
PROTOCOL = {0: dict(schedule="sigmoid", chro="all"), 1: dict(schedule="linear", chro="test")}
JAX_STOP_EPOCH = 145  # JAX's -u 1 run stopped there, on its epoch-117 best (VALIDATION.md)
METRICS = ("pas_ssim", "pas_psnr", "pas_mse", "pas_snr", "pas_pcc", "pas_spc", "pas_gds")
# the JAX tables' section of each row (artifacts/r5_fullscale_tables.txt)
SPREAD_ROWS = {"t29": "sigma=0.1 truncated t*=29", "k1": "sigma=0.1 DDIM K=1",
               "ddrm": "DDRM t*=27"}
ROWS = [("predict", "latent.npy"), ("predict", "target.npy"), ("noisy", "latent.npy"),
        ("noisy", "target.npy"), ("target", "latent.npy")]


def card_name_and_limit() -> str:
    """nvidia-smi's `name, power.limit` of the card, or why there is none."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "no nvidia-smi"
    except (OSError, IndexError, subprocess.TimeoutExpired):
        return "no nvidia-smi"


def jax_rows(tables: str, validation: str) -> dict:
    """JAX's full-scale values: each row's predict-vs-latent scores
    (tables), and each protocol's best val and epoch."""
    text = open(tables).read()
    out = {}
    for row, header in SPREAD_ROWS.items():
        section = text.split(f"## {header}", 1)[1].split("\n## ", 1)[0]
        line = section.split("--- predict vs latent:\n", 1)[1].splitlines()[0]
        out[row] = {m: json.loads(line)[m] for m in METRICS}
    val, epoch = re.search(r"val ([\d.]+)@e(\d+)", text.split(f"## {SPREAD_ROWS['ddrm']}")[1]
                           .splitlines()[0]).groups()
    out["best_val_u1"] = {"best_val": float(val), "best_epoch": int(epoch)}
    val, epoch = re.search(r"val ([\d.]+) best at epoch (\d+)/", open(validation).read()).groups()
    out["best_val_u0"] = {"best_val": float(val), "best_epoch": int(epoch)}
    return out


def verdict(values, jax_value) -> dict:
    """The port's mean, sample sd and range over seeds, and whether JAX's
    value lies outside the range and over 2 sd from the mean."""
    v = np.asarray(values, np.float64)
    mean, sd = float(v.mean()), float(v.std(ddof=1)) if len(v) > 1 else float("nan")
    if len(v) < 2:
        said = "one seed: no spread"
    elif not v.min() <= jax_value <= v.max() and abs(jax_value - mean) > 2 * sd:
        said = "systematic"
    else:
        said = "within the port's seed spread"
    return {"n": len(v), "mean": mean, "sd": sd, "min": float(v.min()), "max": float(v.max()),
            "jax": jax_value, "gap": jax_value - mean, "verdict": said}


def spread(paths, tables: str, validation: str) -> dict:
    """The verdict of every metric of every row over the summaries. Runs
    of another length than the protocol's 150 epochs form rows of their
    own, named with `_e{epochs}`."""
    runs = [json.load(open(p)) for p in paths]
    jax = jax_rows(tables, validation)
    out = {}
    for u, rows in ((0, ("t29", "k1")), (1, ("ddrm",))):
        for epochs in sorted({r["protocol"].get("e", 150) for r in runs
                              if r["protocol"]["u"] == u}):
            mine = sorted((r for r in runs if r["protocol"]["u"] == u
                           and r["protocol"].get("e", 150) == epochs),
                          key=lambda r: r["train"]["seed"])
            seeds = [r["train"]["seed"] for r in mine]
            tag = "" if epochs == 150 else f"_e{epochs}"
            for row in rows:
                out[row + tag] = {"seeds": seeds} | {
                    m: verdict([r[row]["scores"]["predict_vs_latent"][m] for r in mine],
                               jax[row][m])
                    for m in METRICS}
            # JAX's -u 1 run stopped at epoch JAX_STOP_EPOCH, so the port's
            # best over the same epochs
            suffix = f"_epochs_1_{JAX_STOP_EPOCH}" if u else ""
            want = jax[f"best_val_u{u}"]
            out[f"best_val_u{u}{tag}"] = {"seeds": seeds} | {
                k: verdict([r["train"][k + suffix] for r in mine], want[k])
                for k in ("best_val", "best_epoch")}
    return out


def print_spread(table: dict) -> None:
    for row, cols in table.items():
        print(f"| {row} (seeds {', '.join(map(str, cols['seeds']))}) | port mean | sd | "
              "range | JAX | verdict |")
        print("| --- | --- | --- | --- | --- | --- |")
        for k, v in cols.items():
            if k != "seeds":
                print(f"| {k} | {v['mean']:.6g} | {v['sd']:.3g} | {v['min']:.6g} - "
                      f"{v['max']:.6g} | {v['jax']:.6g} | {v['verdict']} |")
        print()
    print(json.dumps(table))


def _percentiles(a, qs=(50, 90, 99)):
    a = np.asarray(a, np.float64)
    return {f"p{q}": float(np.percentile(a, q)) for q in qs} | {"mean": float(a.mean())}


def make_fixture(root: str, bins, seed: int) -> dict:
    t0 = time.time()
    cdir = constraints_dir(root, SIGMA, PERCENTILE)
    nb, npx = make_fullscale(cdir, seed=seed, bins_per_chrom=bins,
                             latent_dir=os.path.join(root, "latent"))
    return {"bins": nb, "pixels": npx, "wall_s": time.time() - t0, "constraints": cdir}


def _zero_launches():
    fused_resblock.launches = fused_posterior_step.launches = 0
    fused_resblock.mode_launches.clear()


def _launches() -> dict:
    return {"fused_resblock": fused_resblock.launches,
            "fused_resblock_modes": {str(k): v for k, v in
                                     sorted(fused_resblock.mode_launches.items())},
            "fused_posterior_step": fused_posterior_step.launches}


def train(root: str, args, dev: torch.device) -> dict:
    """One train_torch.py run; returns its curve, times, peak memory and
    launch counts."""
    if args.fp32:  # as train_torch.main: fp32 around the fused blocks, not TF32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.time()
    run = train_torch.HiCDiff(
        epoch=args.epochs, timestep=TIMESTEP, batch_size=64, sigma=SIGMA,
        condition=bool(args.u), root=root, seed=args.train_seed, bf16=not args.fp32,
        schedule=PROTOCOL[args.u]["schedule"], blocks=args.blocks, features=args.features,
        ema_decay=0.999, device=str(dev))
    setup_s = time.time() - t0
    run.trainer.time_steps = dev.type == "cuda"
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    _zero_launches()
    t0 = time.time()
    best = run.fit_model()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    fit_s = time.time() - t0
    run.logger.close()
    hist = run.trainer.history
    best_epoch = min(hist, key=lambda r: r["valid/loss"])["Epoch"]
    early = min(hist[:JAX_STOP_EPOCH], key=lambda r: r["valid/loss"])
    out = {
        "seed": run.seed, "mode": run.mode, "ckpt_throttle_s": run.ckpt_throttle,
        "setup_s": setup_s, "fit_s": fit_s, "best_val": best, "best_epoch": best_epoch,
        f"best_val_epochs_1_{JAX_STOP_EPOCH}": early["valid/loss"],
        f"best_epoch_epochs_1_{JAX_STOP_EPOCH}": early["Epoch"],
        "launches": _launches(),
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
        out["step_split_ms_p99"] = {
            k: float(np.percentile([s[i] for s in tail], 99))
            for i, k in enumerate(("loss_forward", "backward", "update"))}
    return out


def infer(root: str, args, dev: torch.device, sampling_steps, tag: str) -> dict:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    _zero_launches()
    t0 = time.time()
    res = inference_torch.Inference(
        batch_size=64, sigma_t=SIGMA, condition=bool(args.u), root=root,
        schedule=PROTOCOL[args.u]["schedule"], timestep=TIMESTEP, bf16=not args.fp32,
        sampling_steps=sampling_steps, chro=PROTOCOL[args.u]["chro"], t_start="auto",
        use_ema=False, blocks=args.blocks, features=args.features, compute_metrics=False,
        out_tag=tag, device=str(dev))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.time() - t0
    n = len(res["inds"])
    out = {"outdir": res["outdir"], "patches": n, "batches": -(-n // 64), "wall_s": wall,
           "patches_per_s": n / wall, "timing": res.get("timing"), "launches": _launches()}
    if args.u:  # DDRM's truncation start, in the run's directory name
        out["t_start"] = int(re.search(r"_ts(\d+)", res["outdir"]).group(1))
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
    ap.add_argument("-u", dest="u", type=int, choices=(0, 1), default=0,
                    help="0: the conditional flagship; 1: the unconditional prior under DDRM")
    ap.add_argument("--uncond", dest="u", action="store_const", const=1, help="as -u 1")
    ap.add_argument("--out", default=None,
                    help="default chiprun_out/fullscale_quality[_uncond]_{bf16,fp32}.json")
    ap.add_argument("--epochs", type=int, default=150)
    ap.add_argument("--seed", type=int, default=7, help="the fixture's seed")
    ap.add_argument("--train-seed", type=int, default=0, help="train_torch.py's --seed")
    ap.add_argument("--fp32", action="store_true", help="train and sample in fp32")
    ap.add_argument("--train-only", action="store_true")
    ap.add_argument("--bins", type=int, default=None,
                    help="bins of every chromosome (default: hg19's at 40 kb)")
    ap.add_argument("--blocks", type=int, default=32)
    ap.add_argument("--features", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--spread", nargs="+", metavar="SUMMARY",
                    help="print the seed spread of these summaries against JAX's rows")
    args = ap.parse_args(argv)
    if args.spread:
        return print_spread(spread(args.spread, os.path.join(ROOT, "artifacts",
                                                             "r5_fullscale_tables.txt"),
                                   os.path.join(ROOT, "VALIDATION.md")))
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        sys.exit("no CUDA device; pass --device cpu for a check on the host")
    if args.out is None:
        args.out = (f"chiprun_out/fullscale_quality{'_uncond' if args.u else ''}_"
                    f"{'fp32' if args.fp32 else 'bf16'}.json")
    root = os.path.abspath(args.root)
    if os.path.exists(root):
        shutil.rmtree(root)
    summary = {"card": card_name_and_limit(), "torch": torch.__version__,
               "precision": "float32" if args.fp32 else "bfloat16",
               "protocol": dict(u=args.u, b=64, e=args.epochs, s=SIGMA, **PROTOCOL[args.u],
                                timestep=TIMESTEP, ema_decay=0.999, seed=args.train_seed,
                                ckpt_throttle_s=0.0, use_ema=False, t_start="auto",
                                fixture_seed=args.seed, band=257, percentile=PERCENTILE,
                                blocks=args.blocks, features=args.features)}
    t_all = time.time()
    bins = [args.bins] * len(HG19_BINS_40KB) if args.bins else None
    summary["fixture"] = make_fixture(root, bins, args.seed)
    summary["train"] = train(root, args, dev)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    if not args.train_only:
        latent_dir = os.path.join(root, "latent")
        runs = (("ddrm", None, ""),) if args.u else (("t29", None, ""), ("k1", 1, "_k1"))
        for name, steps, tag in runs:
            run, data_dir = infer(root, args, dev, steps, tag)
            # identity and floor: the same arrays in both -u 0 quartets
            rows = ROWS[:2] if name == "k1" else ROWS
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
    brief["train_seed"] = summary["train"]["seed"]
    for name in ("t29", "k1", "ddrm"):
        if name in summary:
            brief[name] = {k: {m: v[m] for m in ("pas_ssim", "pas_psnr", "pas_pcc")}
                           for k, v in summary[name]["scores"].items() if k != "latent"}
    print(json.dumps(brief))


if __name__ == "__main__":
    main()
