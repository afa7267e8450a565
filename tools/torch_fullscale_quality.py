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

`--keep-every N` writes the live params of every N-th epoch as a
checkpoint of their own (ROOT/kept) and, once the call's training is done,
runs each through the protocol's own inference (`-u 1`: DDRM at t*=27 over
the test split; `-u 0`: K=1 over the full cell, and from epoch 50 on also
the truncated chain at t*=29), deletes it and scores each run in a worker
process while the card runs the next (`-u 1` against the latent and the
realized target, `-u 0` against the latent): the summary's `kept`, one
entry an epoch with its val, the best val so far, and each row's scores
(`scores`) and inference wall, scoring wall and launches (`runs`).

The summary (--out) is written after training, after each kept checkpoint
is scored and at the end, each time whole (a temporary file, then a
rename), with `"partial": true` until the last: a call cut short leaves
every checkpoint it scored.

`--stop-after E` stops after epoch E and runs no inference; `--continue`
goes on from the piece under --root in a later process: its finalg
checkpoint (params, Adam's moments, the step, so the step draws go on),
the history, the lowest best val and a copy of its bestg file (ROOT/piece).
The loader's shuffle goes on at the epoch reached, so the pieces add up to
the uninterrupted run. The protocol's inference runs once, in the call
that ends with every epoch trained and no --stop-after, after the lowest
best of all pieces is put back as the bestg file. The EMA restarts at each
piece, as the JAX trainer's does on a resume; no row reads it (the
protocol scores the best checkpoint's params):

  python tools/torch_fullscale_quality.py --fp32 --keep-every 10 \\
      --stop-after 50 --root build/fs_u0_fp32 --out chiprun_out/p1.json
  python tools/torch_fullscale_quality.py --fp32 --keep-every 10 \\
      --stop-after 100 --continue --root build/fs_u0_fp32 --out ...
  python tools/torch_fullscale_quality.py --fp32 --continue \\
      --root build/fs_u0_fp32 --out chiprun_out/u0_fp32_seed0.json

`--spread SUMMARY.json ...` trains nothing: it reads the summaries of runs
at several train seeds and prints, for each protocol's rows (`-u 0`: t*=29
and K=1; `-u 1`: DDRM; runs of another `--epochs` in rows of their own)
and each of the seven metrics against the latent,
and for the best val and its epoch, the port's mean, sample sd and range
beside JAX's value (artifacts/r5_fullscale_tables.txt; the best vals from
VALIDATION.md and the DDRM table's header) and the verdict: a gap is
systematic when JAX's value lies outside the port's range and more than
2 sample sd from the port's mean, else within the port's seed spread.
fp32 runs stand in rows of their own (`_fp32`), and a bf16 run that keeps
checkpoints in rows of its own (`_sweep`): it repeats a seed of the seed
rows. Each fp32 value also carries whether bf16 training is implicated:
it is when the value lies outside the bf16 seeds' range of its row, on
the side of JAX's value (which lies outside it too); else not implicated.
The kept checkpoints of epochs 50-150 of a run form a row of their own
for each protocol row they were scored in (`{ddrm,t29,k1}..._kept_seed{N}`):
each metric's min, median and max over them, the epochs of the min and
the max, and whether JAX's value lies within that range (within one run's
checkpoint spread) or not. SSIM and PSNR, which have PERF.md's quality
limits (0.02; 0.5 dB), get a three-way rule: JAX's value within the range;
every checkpoint farther from JAX's than the limit: systematic; else within
the limit at some checkpoints, which are named.
"""
import argparse
import concurrent.futures
import json
import multiprocessing
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
from hicdiff_tpu_torch.train.checkpoint import checkpoint_name  # noqa: E402
from tools.torch_latent_target import build_latent_npy  # noqa: E402
from tools.torch_make_fullscale_fixture import HG19_BINS_40KB, constraints_dir  # noqa: E402
from tools.torch_make_fullscale_fixture import make_fullscale  # noqa: E402
from tools.torch_quartet_metrics import score_quartet  # noqa: E402

SIGMA, PERCENTILE, TIMESTEP = 0.1, 99.99, 1000
# the JAX queue's per-mode flags (tools/round5_eval_queue.sh:40-66)
PROTOCOL = {0: dict(schedule="sigmoid", chro="all"), 1: dict(schedule="linear", chro="test")}
JAX_STOP_EPOCH = 145  # JAX's -u 1 run stopped there, on its epoch-117 best (VALIDATION.md)
KEPT_FROM = 50  # the kept checkpoints' rows read epochs 50 onwards
LIMITS = {"pas_ssim": 0.02, "pas_psnr": 0.5}  # PERF.md's quality limits (PSNR in dB)
METRICS = ("pas_ssim", "pas_psnr", "pas_mse", "pas_snr", "pas_pcc", "pas_spc", "pas_gds")
# the JAX tables' section of each row (artifacts/r5_fullscale_tables.txt)
SPREAD_ROWS = {"t29": "sigma=0.1 truncated t*=29", "k1": "sigma=0.1 DDIM K=1",
               "ddrm": "DDRM t*=27"}
# each protocol's inference runs: row, sampling steps, the output's tag
RUNS = {0: (("t29", None, ""), ("k1", 1, "_k1")), 1: (("ddrm", None, ""),)}
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


def implicated(value: float, bf16: dict, jax_value: float) -> str:
    """Whether an fp32 value implicates bf16 training: it lies outside the
    bf16 seeds' range, on the side where JAX's value lies outside it."""
    lo, hi = bf16["min"], bf16["max"]
    if (value > hi and jax_value > hi) or (value < lo and jax_value < lo):
        return "bf16 training implicated"
    return "bf16 training not implicated"


def kept_scores(k: dict, row: str):
    """A kept checkpoint's scores in one protocol row, or None. Sweeps
    written before `-u 0` kept two rows hold DDRM's scores unnested."""
    scores = k["scores"]
    return scores if "predict_vs_latent" in scores else scores.get(row)


def kept_row(kept: list, jax_row: dict) -> dict:
    """One run's kept checkpoints of one row, (epoch, scores) pairs of
    epochs KEPT_FROM onwards: each metric's min, median and max, their
    epochs, and where JAX's value lies; SSIM and PSNR also by their
    limits' three-way rule."""
    kept = sorted(kept, key=lambda k: k[0])
    epochs = [e for e, _ in kept]
    out = {"epochs": epochs}
    for m in METRICS:
        v = np.asarray([s["predict_vs_latent"][m] for _, s in kept], np.float64)
        j = jax_row[m]
        inside = v.min() <= j <= v.max()
        said = ("within one run's checkpoint spread" if inside
                else "outside one run's checkpoint spread")
        if m in LIMITS and not inside:
            near = [e for e, x in zip(epochs, v) if abs(x - j) <= LIMITS[m]]
            said = ("systematic" if not near else
                    "within the limit at epochs " + ", ".join(map(str, near)))
        out[m] = {"n": len(v), "min": float(v.min()), "median": float(np.median(v)),
                  "max": float(v.max()), "min_epoch": epochs[int(v.argmin())],
                  "max_epoch": epochs[int(v.argmax())], "jax": j,
                  "gap": j - float(np.median(v)), "verdict": said}
    return out


def spread(paths, tables: str, validation: str) -> dict:
    """The verdict of every metric of every row over the summaries. Runs
    of another length than the protocol's 150 epochs form rows of their
    own, named with `_e{epochs}`; fp32 runs with `_fp32`, bf16 runs that
    keep checkpoints with `_sweep`; a run's kept checkpoints a row for each
    protocol row they were scored in, `{ddrm,k1,t29}..._kept_seed{seed}`."""
    runs = [json.load(open(p)) for p in paths]
    jax = jax_rows(tables, validation)

    def group(r):
        fp32 = r.get("precision") == "float32"
        return (r["protocol"]["u"], r["protocol"].get("e", 150), fp32,
                "kept" in r and not fp32)

    out = {}
    for key in sorted({group(r) for r in runs}):
        u, epochs, fp32, sweep = key
        rows = ("ddrm",) if u else ("t29", "k1")
        mine = sorted((r for r in runs if group(r) == key), key=lambda r: r["train"]["seed"])
        seeds = [r["train"]["seed"] for r in mine]
        tag = ("" if epochs == 150 else f"_e{epochs}") + ("_fp32" if fp32 else "") + (
            "_sweep" if sweep else "")
        for row in rows:
            out[row + tag] = {"seeds": seeds} | {
                m: verdict([r[row]["scores"]["predict_vs_latent"][m] for r in mine],
                           jax[row][m])
                for m in METRICS}
            base = row + tag.replace("_fp32", "")
            if fp32 and base in out:  # beside the bf16 seeds of the same row
                for m in METRICS:
                    out[row + tag][m]["bf16"] = implicated(out[row + tag][m]["mean"],
                                                           out[base][m], jax[row][m])
        # JAX's -u 1 run stopped at epoch JAX_STOP_EPOCH, so the port's
        # best over the same epochs
        suffix = f"_epochs_1_{JAX_STOP_EPOCH}" if u else ""
        want = jax[f"best_val_u{u}"]
        out[f"best_val_u{u}{tag}"] = {"seeds": seeds} | {
            k: verdict([r["train"][k + suffix] for r in mine], want[k])
            for k in ("best_val", "best_epoch")}
        for r in mine:
            for row in rows:
                kept = [(k["epoch"], kept_scores(k, row)) for k in r.get("kept", ())
                        if k["epoch"] >= KEPT_FROM and kept_scores(k, row)]
                if kept:
                    out[f"{row}{tag}_kept_seed{r['train']['seed']}"] = {
                        "seeds": [r["train"]["seed"]]} | kept_row(kept, jax[row])
    return out


def print_spread(table: dict) -> None:
    for row, cols in table.items():
        seeds = f"{row} (seed{'s' if len(cols['seeds']) > 1 else ''} " \
                f"{', '.join(map(str, cols['seeds']))})"
        if "epochs" in cols:  # kept checkpoints
            print(f"| {seeds}, epochs {cols['epochs'][0]}-{cols['epochs'][-1]} | min (epoch) "
                  "| median | max (epoch) | JAX | verdict |")
            print("| --- | --- | --- | --- | --- | --- |")
            for k, v in cols.items():
                if k not in ("seeds", "epochs"):
                    print(f"| {k} | {v['min']:.6g} ({v['min_epoch']}) | {v['median']:.6g} | "
                          f"{v['max']:.6g} ({v['max_epoch']}) | {v['jax']:.6g} | "
                          f"{v['verdict']} |")
            print()
            continue
        print(f"| {seeds} | port mean | sd | range | JAX | verdict |")
        print("| --- | --- | --- | --- | --- | --- |")
        for k, v in cols.items():
            if k != "seeds":
                said = v["verdict"] + (f"; {v['bf16']}" if "bf16" in v else "")
                print(f"| {k} | {v['mean']:.6g} | {v['sd']:.3g} | {v['min']:.6g} - "
                      f"{v['max']:.6g} | {v['jax']:.6g} | {said} |")
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


class EpochHook:
    """The logger that `fit` calls once an epoch, wrapped: it numbers the
    epoch as the uninterrupted run does (the epochs of earlier pieces
    added) and writes the live params of every `every`-th epoch as a
    checkpoint of their own."""

    def __init__(self, run, every: int, done: int, kept_dir: str):
        self.run, self.inner, self.every, self.done = run, run.logger, every, done
        self.kept_dir = kept_dir
        self.kept = []

    def log(self, record: dict) -> None:
        if "Epoch" in record:
            # the trainer's history holds this same record: both get the run's epoch
            record["Epoch"] += self.done
            epoch = record["Epoch"]
            if self.every and epoch % self.every == 0:
                t0 = time.time()
                path = os.path.join(self.kept_dir, f"kept_e{epoch}.msgpack")
                run = self.run
                run.trainer.save(path, run.trainer.live_state(epoch * len(run.train_loader)),
                                 dict(mode=run.mode, **run.run_config))
                self.kept.append({"epoch": epoch, "val": record["valid/loss"], "path": path,
                                  "write_s": time.time() - t0})
        self.inner.log(record)

    def close(self) -> None:
        self.inner.close()


def _weights(run, kind: str) -> str:
    """The path of the run's bestg or finalg checkpoint."""
    return os.path.join(run.out_dir, checkpoint_name(kind, run.res, run.chunk, run.cell_line,
                                                     run.cell_no, tag=run.tag))


def train(root: str, args, dev: torch.device, state: dict, stop: int) -> list:
    """Epochs state["done"] + 1 to `stop` of one train_torch.py run: from
    its seeded init, or from the last piece's finalg checkpoint. Adds to
    `state` the epochs, this piece's walls, peak memory, launch counts and
    warm step times, and the lowest best with a copy of its bestg file;
    returns the checkpoints kept in this piece."""
    if args.fp32:  # as train_torch.main: fp32 around the fused blocks, not TF32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    done = state["done"]
    t0 = time.time()
    run = train_torch.HiCDiff(
        epoch=stop - done, timestep=TIMESTEP, batch_size=64, sigma=SIGMA,
        condition=bool(args.u), root=root, seed=args.train_seed, bf16=not args.fp32,
        schedule=PROTOCOL[args.u]["schedule"], blocks=args.blocks, features=args.features,
        ema_decay=0.999, device=str(dev))
    setup_s = time.time() - t0
    run.trainer.time_steps = dev.type == "cuda"
    run.train_loader._epoch = done  # each epoch shuffled as in the uninterrupted run
    kept_dir = os.path.join(root, "kept")
    os.makedirs(kept_dir, exist_ok=True)
    run.logger = hook = EpochHook(run, args.keep_every, done, kept_dir)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    _zero_launches()
    t0 = time.time()
    best = run.fit_model(resume=_weights(run, "finalg") if done else None)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    fit_s = time.time() - t0
    run.logger.close()
    hist = run.trainer.history
    state["history"] += [{"epoch": r["Epoch"], "train": r["train/loss"], "val": r["valid/loss"],
                          "s": r["epoch_seconds"]} for r in hist]
    if state["best"] is None or best < state["best"]["val"]:
        shutil.copy(_weights(run, "bestg"), os.path.join(root, "piece", "bestg.msgpack"))
        state["best"] = {"val": best, "epoch": min(hist, key=lambda r: r["valid/loss"])["Epoch"],
                         "bestg": os.path.relpath(_weights(run, "bestg"), root)}
    state["done"] = stop
    state["meta"] = {"seed": run.seed, "mode": run.mode, "ckpt_throttle_s": run.ckpt_throttle,
                     "train_patches": len(run.train_loader.dataset),
                     "val_patches": len(run.val_loader.dataset), "log": run.logger.inner.out_path}
    piece = {"epochs": [done + 1, stop], "card": card_name_and_limit(), "setup_s": setup_s,
             "fit_s": fit_s, "launches": _launches()}
    if dev.type == "cuda":
        steps = run.trainer.step_times_ms()
        run.trainer.step_events.clear()
        piece["peak_memory_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        piece["steps"] = len(steps)
        state["warm_steps_ms"] += steps[len(steps) // 10:]  # past the first tenth: warm
    state["pieces"].append(piece)
    return hook.kept


def train_summary(state: dict) -> dict:
    """The run's training over all its pieces: the val curve and its best
    (also over epochs 1-145), walls, launch counts, epoch and step times."""
    hist, pieces = state["history"], state["pieces"]
    early = min(hist[:JAX_STOP_EPOCH], key=lambda r: r["val"])
    firsts = {p["epochs"][0] for p in pieces}  # each piece's first epoch warms it up
    warm = [r["s"] for r in hist if r["epoch"] not in firsts]
    launches = {"fused_resblock": 0, "fused_resblock_modes": {}, "fused_posterior_step": 0}
    for p in pieces:
        for k, v in p["launches"].items():
            if isinstance(v, dict):
                for mode, n in v.items():
                    launches[k][mode] = launches[k].get(mode, 0) + n
            else:
                launches[k] += v
    launches["fused_resblock_modes"] = dict(sorted(launches["fused_resblock_modes"].items()))
    out = state["meta"] | {
        "setup_s": sum(p["setup_s"] for p in pieces), "fit_s": sum(p["fit_s"] for p in pieces),
        "best_val": state["best"]["val"], "best_epoch": state["best"]["epoch"],
        f"best_val_epochs_1_{JAX_STOP_EPOCH}": early["val"],
        f"best_epoch_epochs_1_{JAX_STOP_EPOCH}": early["epoch"],
        "launches": launches, "epochs": hist, "epoch_s": _percentiles(warm or [hist[0]["s"]]),
        "first_epoch_s": hist[0]["s"], "pieces": pieces,
    }
    steps = state["warm_steps_ms"]
    if steps:
        out["peak_memory_gib"] = max(p["peak_memory_gib"] for p in pieces)
        out["steps"] = sum(p["steps"] for p in pieces)
        out["step_ms"] = _percentiles([sum(s) for s in steps])
        out["step_split_ms_median"] = {
            k: float(np.median([s[i] for s in steps]))
            for i, k in enumerate(("loss_forward", "backward", "update"))}
        out["step_split_ms_p99"] = {
            k: float(np.percentile([s[i] for s in steps], 99))
            for i, k in enumerate(("loss_forward", "backward", "update"))}
    return out


def infer(root: str, args, dev: torch.device, sampling_steps, tag: str,
          weights: str = None) -> dict:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    _zero_launches()
    t0 = time.time()
    res = inference_torch.Inference(
        batch_size=64, sigma_t=SIGMA, condition=bool(args.u), root=root,
        schedule=PROTOCOL[args.u]["schedule"], timestep=TIMESTEP, bf16=not args.fp32,
        sampling_steps=sampling_steps, chro=PROTOCOL[args.u]["chro"], t_start="auto",
        use_ema=False, blocks=args.blocks, features=args.features, compute_metrics=False,
        out_tag=tag, weights=weights, device=str(dev))
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


def _timed_score(qdir: str, data_dir: str, latent_dir: str, rows) -> tuple:
    """score() and its wall, in the worker process."""
    t0 = time.time()
    return score(qdir, data_dir, latent_dir, rows), time.time() - t0


def score_kept(root: str, args, dev: torch.device, state: dict, kept: list, saved) -> None:
    """Each kept checkpoint through the protocol's own inference runs
    (`-u 1`: DDRM; `-u 0`: K=1, and t*=29 from epoch KEPT_FROM on), the
    file deleted once they ran. A worker process scores each run (`-u 1`:
    the prediction against the latent and the realized target; `-u 0`:
    against the latent) while the card runs the next. Once a checkpoint's
    runs are scored their outputs are deleted, its entry joins
    state["kept"] and `saved()` is called; one whose inference failed is
    left out."""
    latent_dir = os.path.join(root, "latent")
    rows = ROWS[:2] if args.u else ROWS[:1]
    queue = []  # (entry, {row: (run, future)}), inferred, in epoch order

    def collect(wait: bool) -> None:
        while queue and (wait or all(f.done() for _, f in queue[0][1].values())):
            k, runs = queue.pop(0)
            k["scores"], k["runs"] = {}, {}
            for name, (run, future) in runs.items():
                k["scores"][name], run["score_s"] = future.result()
                shutil.rmtree(run["outdir"])
                k["runs"][name] = {key: run[key] for key in ("patches", "wall_s", "score_s",
                                                            "launches")}
            k["best_so_far"] = min(r["val"] for r in state["history"] if r["epoch"] <= k["epoch"])
            state["kept"].append(k)
            saved()

    spawn = multiprocessing.get_context("spawn")  # the parent holds the card
    with concurrent.futures.ProcessPoolExecutor(1, mp_context=spawn) as pool:
        try:
            for k in kept:
                path, runs = k.pop("path"), {}
                for name, steps, tag in RUNS[args.u]:
                    if name == "t29" and k["epoch"] < KEPT_FROM:
                        continue
                    run, data_dir = infer(root, args, dev, steps, f"_kept{k['epoch']}{tag}",
                                          weights=path)
                    runs[name] = run, pool.submit(_timed_score, run["outdir"], data_dir,
                                                  latent_dir, rows)
                    collect(wait=False)
                os.remove(path)
                queue.append((k, runs))
        finally:
            collect(wait=True)


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
    ap.add_argument("--keep-every", type=int, default=0, metavar="N",
                    help="keep the params of every N-th epoch and score them after training")
    ap.add_argument("--stop-after", type=int, default=None, metavar="E",
                    help="stop after epoch E, with no inference; --continue goes on")
    ap.add_argument("--continue", dest="cont", action="store_true",
                    help="go on from the piece under --root")
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
    state_path = os.path.join(root, "piece", "state.json")
    protocol = dict(u=args.u, b=64, e=args.epochs, s=SIGMA, **PROTOCOL[args.u],
                    timestep=TIMESTEP, ema_decay=0.999, seed=args.train_seed,
                    ckpt_throttle_s=0.0, use_ema=False, t_start="auto", fixture_seed=args.seed,
                    band=257, percentile=PERCENTILE, blocks=args.blocks,
                    features=args.features)
    summary = {"card": card_name_and_limit(), "torch": torch.__version__,
               "precision": "float32" if args.fp32 else "bfloat16", "protocol": protocol}
    t_all = time.time()
    if args.cont:
        if not os.path.exists(state_path):
            sys.exit(f"no piece to continue under {root}")
        with open(state_path) as f:
            state = json.load(f)
        if state["protocol"] != protocol or state["precision"] != summary["precision"]:
            sys.exit(f"the piece under {root} runs another protocol: {state['protocol']} "
                     f"({state['precision']})")
    else:
        if os.path.exists(root):
            shutil.rmtree(root)
        bins = [args.bins] * len(HG19_BINS_40KB) if args.bins else None
        state = {"protocol": protocol, "precision": summary["precision"],
                 "fixture": make_fixture(root, bins, args.seed), "done": 0, "history": [],
                 "best": None, "pieces": [], "warm_steps_ms": [], "kept": []}
        os.makedirs(os.path.dirname(state_path))
    summary["fixture"] = state["fixture"]
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)

    def save(partial: bool) -> None:
        """--out as it stands, whole: a temporary file, then a rename."""
        summary["train"] = train_summary(state)
        if state["kept"]:
            summary["kept"] = state["kept"]
        summary["partial"] = partial
        summary["wall_s"] = time.time() - t_all  # this call's
        with open(args.out + ".tmp", "w") as f:
            json.dump(summary, f, indent=1)
        os.replace(args.out + ".tmp", args.out)

    stop = min(args.stop_after or args.epochs, args.epochs)
    if state["done"] < stop:
        kept = train(root, args, dev, state, stop)
        save(partial=True)
        score_kept(root, args, dev, state, kept, lambda: save(partial=True))
    with open(state_path, "w") as f:
        json.dump(state, f)
    finished = state["done"] == args.epochs and args.stop_after is None
    if finished:  # the lowest best of all pieces is the run's bestg
        shutil.copy(os.path.join(root, "piece", "bestg.msgpack"),
                    os.path.join(root, state["best"]["bestg"]))
    if finished and not args.train_only:
        latent_dir = os.path.join(root, "latent")
        for name, steps, tag in RUNS[args.u]:
            run, data_dir = infer(root, args, dev, steps, tag)
            # identity and floor: the same arrays in both -u 0 quartets
            rows = ROWS[:2] if name == "k1" else ROWS
            t0 = time.time()
            run["scores"] = score(run["outdir"], data_dir, latent_dir, rows)
            run["score_s"] = time.time() - t0
            summary[name] = run
    save(partial=False)
    log = summary["train"].get("log")
    if log and os.path.exists(log):
        shutil.copy(log, os.path.splitext(args.out)[0] + "_train.jsonl")
    brief = {k: summary[k] for k in ("card", "precision", "wall_s")}
    brief["epochs_done"] = state["done"]
    brief["best_val"] = summary["train"]["best_val"]
    brief["best_epoch"] = summary["train"]["best_epoch"]
    brief["train_seed"] = summary["train"]["seed"]
    for name in ("t29", "k1", "ddrm"):
        if name in summary:
            brief[name] = {k: {m: v[m] for m in ("pas_ssim", "pas_psnr", "pas_pcc")}
                           for k, v in summary[name]["scores"].items() if k != "latent"}
    if state["kept"]:
        brief["kept"] = [(k["epoch"], k["val"], {row: [v["predict_vs_latent"][m] for m in (
            "pas_psnr", "pas_ssim")] for row, v in k["scores"].items()}) for k in state["kept"]]
    print(json.dumps(brief))


if __name__ == "__main__":
    main()
