"""Data parallelism across processes, run and checked (port of
hicdiff_tpu/parallel/multihost.py).

A launcher starts N worker processes, one a rank, over torch.distributed
(gloo on the CPU or for ranks that share one card, NCCL for a GPU a rank),
and a single-process run of the same workload; each run trains two steps of
the data-parallel Trainer (a full batch, then a ragged last batch padded
to the world size), samples the truncated conditional chain (t_start = 1:
one noisy step, the posterior kernel at the rank's offset) and restores a
DDRM deno batch, every batch sharded by rows and gathered. The launcher
holds the N-rank run to the one-rank run: losses and parameters after the
two steps, the chain's and DDRM's outputs. Parameters are held by the rule
of chip_smoke.py's train_step_vs_plain: two Adam steps move a weight by
about lr each, so the runs' weights agree far inside lr / 10 except where a
gradient that sums to about 0 flips its sign between the two summation
orders; those weights are counted (at most one in 100,000), each at most
4 lr apart.

`prep` writes a 3-chromosome synthetic cell as the contact lists the data
module reads (`Constraints/chrom_{i}_{40000,count}.txt`) and runs the
production prep path on it.
Widths are parameters: 2 blocks x 32 features for the CPU, 32 x 256 on the
card.

The launcher stops every worker that still runs when one exits with an
error, when the run outlasts its timeout, and on any other exception, so
no rank is left waiting in a collective.

Usage:
  python -m hicdiff_tpu_torch.parallel.multihost [--nprocs 2] [--device cuda]
      [--backend gloo] [--blocks 2 --features 32] [--batch 8 --ragged 5] [--bf16]
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from typing import Optional, Sequence

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TIMESTEPS, SIGMA, BAND = 8, 0.1, 64
N_CHROMS = 3
LR = 2e-5
# the JAX harness's bars, fp32: losses, chain and DDRM outputs; parameters
# after two Adam steps as the port's trainer tests hold them; the share of
# weights whose updates may lie over lr / 10 apart (None: counted, not held)
FP32_TOL = {"loss": 1e-5, "params": 1e-6, "sample": 1e-4, "ddrm": 1e-4,
            "update_outliers": 1e-5}
UPDATE_TOL, FLIP_TOL = 0.1 * LR, 4 * LR * 1.01

__all__ = ["prep", "worker", "launch", "run_ranks", "main", "free_port", "FP32_TOL"]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# --------------------------------------------------------------------- prep
def _cell_bins(need: int) -> int:
    """The fewest bins (a multiple of 64) whose N_CHROMS chromosomes give
    `need` band patches."""
    from hicdiff_tpu_torch.data.preprocess import split_pieces

    bins = 128
    while N_CHROMS * split_pieces(np.zeros((bins, bins), np.float32), 64, 64,
                                  resol=40000).shape[0] < need:
        bins += 64
    return bins


def prep(workdir: str, patches: int, seed: int = 0) -> str:
    """Write a synthetic Human cell 1 (N_CHROMS chromosomes with at least
    `patches` band patches in all) as contact lists, prepare its caches
    with the data module, and write a manifest of its Splits files.
    Returns the manifest's path."""
    from hicdiff_tpu_torch.data.datamodule import GSE130711Module
    from hicdiff_tpu_torch.data.fastio import save_coo_txt

    dm = GSE130711Module(batch_size=patches, deg="deno", sigma_0=SIGMA, root=workdir,
                         n_chroms=N_CHROMS)
    constraints = os.path.join(dm.dirname, "Constraints")
    os.makedirs(constraints, exist_ok=True)
    rng = np.random.default_rng(seed)
    n = _cell_bins(patches)
    for c in range(1, N_CHROMS + 1):
        i, j = np.triu_indices(n)
        near = (j - i) < BAND
        i, j = i[near], j[near]
        counts = rng.poisson(np.maximum(40.0 - 0.6 * (j - i), 1.0))
        counts[i == j] = np.maximum(counts[i == j], 1)  # no bin is dropped
        nz = counts > 0
        w = rng.uniform(0.5, 1.5, n)
        start1, start2 = i[nz] * 40000.0, j[nz] * 40000.0
        save_coo_txt(os.path.join(constraints, f"chrom_{c}_40000.txt"),
                     np.stack([start1, start2, counts[nz] * w[i[nz]] * w[j[nz]]], axis=1))
        save_coo_txt(os.path.join(constraints, f"chrom_{c}_count.txt"),
                     np.stack([start1, start2, counts[nz]], axis=1), int_value=True)
    dm.prepare_data()
    base = os.path.join(dm.dirname, "Splits", "GSE131811_%s_chr_{}_40000_piece_64.npy")
    manifest = {kind: [base.format(c) % kind for c in range(1, N_CHROMS + 1)]
                for kind in ("noisy", "full")}
    path = os.path.join(workdir, "manifest.json")
    with open(path, "w") as f:
        json.dump(manifest, f)
    return path


def _load(manifest_path: str, kind: str) -> np.ndarray:
    with open(manifest_path) as f:
        files = json.load(f)[kind]
    return np.transpose(np.concatenate([np.load(p) for p in files]), (0, 2, 3, 1))  # NHWC


# ------------------------------------------------------------------- worker
def _launch_counts() -> dict:
    from hicdiff_tpu_torch.kernels.resblock import fused_resblock, resblock_dgrad
    from hicdiff_tpu_torch.kernels.resblock_bwd import resblock_channel_sums, resblock_wgrad
    from hicdiff_tpu_torch.kernels.sample_step import fused_posterior_step

    return {"fused_resblock": fused_resblock.launches,
            "fused_resblock_modes": dict(fused_resblock.mode_launches),
            "fused_resblock_dgrad": resblock_dgrad.launches,
            "resblock_wgrad": resblock_wgrad.launches,
            "resblock_channel_sums": resblock_channel_sums.launches,
            "fused_posterior_step": fused_posterior_step.launches}


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def worker(rank: int, nprocs: int, port: int, manifest_path: str, out_path: str, *,
           device: str = "cuda", backend: Optional[str] = None, blocks: int = 2,
           features: int = 32, batch: int = 8, ragged: int = 5, bf16: bool = False) -> None:
    """One rank of the run: two train steps (rows [0, batch), then the ragged
    [batch, batch + ragged)), the truncated chain on the first batch and a
    DDRM deno restoration of the ragged one. Rank 0 writes the results."""
    import dataclasses

    import torch

    from hicdiff_tpu_torch.diffusion.gaussian import GaussianDiffusion
    from hicdiff_tpu_torch.models.hicedrn import HicedrnDiff
    from hicdiff_tpu_torch.parallel.mesh import is_main, make_mesh, run_sharded
    from hicdiff_tpu_torch.sampling.ddrm import DDRMRestorer
    from hicdiff_tpu_torch.train.trainer import Trainer, step_generator

    if torch.device(device).type == "cpu":
        torch.set_num_threads(max(1, min(4, (os.cpu_count() or 1) // nprocs)))
    else:  # fp32 compares must not run in TF32
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(device, backend=backend, init_method=f"tcp://localhost:{port}",
                     rank=rank, world_size=nprocs)
    try:
        dtype = torch.bfloat16 if bf16 else None
        model = HicedrnDiff(self_condition=True, number_resnet=blocks, features=features,
                            dtype=dtype, device=mesh.device,
                            generator=torch.Generator().manual_seed(0))
        engine = GaussianDiffusion.create(model, device=mesh.device, timesteps=TIMESTEPS,
                                          beta_schedule="cosine", mode="cond")
        trainer = Trainer(engine, lr=LR, mesh=mesh)
        noisy, full = _load(manifest_path, "noisy"), _load(manifest_path, "full")
        assert noisy.shape[0] >= batch + ragged, (noisy.shape, batch, ragged)
        losses, step_ms = [], []
        for step, (lo, hi) in enumerate(((0, batch), (batch, batch + ragged))):
            _sync(mesh.device)
            t0 = time.perf_counter()
            loss = trainer.train_step(noisy[lo:hi], full[lo:hi],
                                      generator=step_generator(0, step))
            losses.append(float(loss))
            _sync(mesh.device)
            step_ms.append((time.perf_counter() - t0) * 1e3)

        model.eval()
        chain = dataclasses.replace(engine, t_start=1)
        sample = run_sharded(mesh, lambda x, rows: chain.super_resolution(
            x, torch.Generator().manual_seed(0), rows=rows), noisy[:batch])

        prior = HicedrnDiff(self_condition=False, number_resnet=blocks, features=features,
                            dtype=dtype, device=mesh.device,
                            generator=torch.Generator().manual_seed(1)).eval()
        restorer = DDRMRestorer(lambda x, t: prior(x, t, None), "deno", SIGMA,
                                device=mesh.device, t_start="auto")
        y = noisy[batch:batch + ragged].reshape(ragged, -1)
        restored = run_sharded(mesh, lambda y_rows, rows: restorer(
            y_rows, None, noise=_shard_noise(mesh.device, rows)), y)
        _sync(mesh.device)
        assert sample.shape == (batch, *noisy.shape[1:]), sample.shape
        assert restored.shape == (ragged, 64, 64, 1), restored.shape
        assert torch.isfinite(sample).all() and torch.isfinite(restored).all()
        if is_main(mesh):
            params = {f"param/{k}": v.detach().float().cpu().numpy()
                      for k, v in model.state_dict().items()}
            np.savez(out_path, losses=np.asarray(losses, np.float64),
                     sample=sample.float().cpu().numpy(), ddrm=restored.float().cpu().numpy(),
                     step_ms=np.asarray(step_ms), ddrm_forwards=restorer.forwards,
                     launches=json.dumps(_launch_counts()), world_size=nprocs, **params)
        print(f"multihost worker rank={rank}/{nprocs} on {mesh.device} ({mesh.backend}): "
              f"losses={losses}, step_ms={[round(t, 3) for t in step_ms]}", flush=True)
    finally:
        mesh.close()


def _shard_noise(device, rows):
    """DDRM's draws for a shard at rows: the whole batch's normal draws from
    a generator seeded 0 on `device`, the shard's rows kept."""
    import torch

    from hicdiff_tpu_torch.sampling.ddrm import generator_noise

    return generator_noise(torch.Generator(device=device).manual_seed(0), device, rows)


# ------------------------------------------------------------------ launcher
def run_ranks(cmds: Sequence[Sequence[str]], *, logdir: str, timeout: float,
              env: Optional[dict] = None, tag: str = "run") -> list:
    """Run one process per command to the end and return their logs.

    Raises when a process exits with an error (RuntimeError) or the run
    outlasts `timeout` seconds (subprocess.TimeoutExpired); in either case,
    and on any other exception, every process still running is killed and
    reaped before the exception leaves."""
    procs, logs = [], []
    try:
        for i, cmd in enumerate(cmds):
            log = os.path.join(logdir, f"{tag}_rank{i}.log")
            logs.append(log)
            with open(log, "w") as fh:
                procs.append(subprocess.Popen(list(cmd), cwd=REPO, env=env, stdout=fh,
                                              stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        while True:
            codes = [p.poll() for p in procs]
            failed = [(i, c) for i, c in enumerate(codes) if c not in (None, 0)]
            if failed:
                raise RuntimeError(f"{tag}: rank {failed[0][0]} exited with {failed[0][1]}:\n"
                                   + _tails(logs))
            if all(c == 0 for c in codes):
                return [open(p).read() for p in logs]
            if time.monotonic() > deadline:
                raise subprocess.TimeoutExpired([" ".join(c) for c in cmds], timeout,
                                                output=_tails(logs))
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()


def _tails(logs: list, n: int = 3000) -> str:
    out = []
    for path in logs:
        with open(path) as f:
            out.append(f"--- {os.path.basename(path)}\n{f.read()[-n:]}")
    return "\n".join(out)


def launch(nprocs: int = 2, *, workdir: Optional[str] = None, device: str = "cuda",
           backend: Optional[str] = None, blocks: int = 2, features: int = 32,
           batch: int = 8, ragged: int = 5, bf16: bool = False, tol: Optional[dict] = None,
           timeout: float = 1200.0) -> dict:
    """Run the workload on one rank and on `nprocs` ranks, compare, and
    return the record: the losses, the largest differences of losses,
    parameters and outputs, each run's step ms and launch counts. Raises
    AssertionError when a difference passes its bar in `tol` (default the
    fp32 bars, FP32_TOL; a bar of None is reported, not held). The
    parameters' update rule (module docstring) holds whatever `tol` says:
    each weight within FLIP_TOL, and with tol["update_outliers"] at most
    that share of them over UPDATE_TOL."""
    tol = dict(FP32_TOL if tol is None else tol)
    own = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix="hicdiff_torch_multihost_")
    os.makedirs(workdir, exist_ok=True)
    try:
        manifest = prep(workdir, batch + ragged)
        runs = {}
        for tag, n in (("ref_1rank", 1), (f"dp_{nprocs}rank", nprocs)):
            out = os.path.join(workdir, f"out_{tag}.npz")
            port = free_port()
            cmds = [[sys.executable, "-m", "hicdiff_tpu_torch.parallel.multihost",
                     "--worker", str(r), "--nprocs", str(n), "--port", str(port),
                     "--manifest", manifest, "--out", out, "--device", device,
                     "--blocks", str(blocks), "--features", str(features),
                     "--batch", str(batch), "--ragged", str(ragged)]
                    + (["--backend", backend] if backend else []) + (["--bf16"] if bf16 else [])
                    for r in range(n)]
            sys.stdout.write("".join(run_ranks(cmds, logdir=workdir, timeout=timeout, tag=tag)))
            with np.load(out) as z:
                runs[tag] = {k: z[k] for k in z.files}
        ref, dp = runs["ref_1rank"], runs[f"dp_{nprocs}rank"]
        names = [k for k in ref if k.startswith("param/")]
        diffs = {
            "loss": float(np.max(np.abs(ref["losses"] - dp["losses"]))),
            "params": max(float(np.max(np.abs(ref[k] - dp[k]))) for k in names),
            "sample": float(np.max(np.abs(ref["sample"] - dp["sample"]))),
            "ddrm": float(np.max(np.abs(ref["ddrm"] - dp["ddrm"]))),
        }
        # both runs start from the same weights, so the weights' difference
        # is the difference of their updates over the two steps
        n_params = sum(ref[k].size for k in names)
        outliers = sum(int(np.sum(np.abs(ref[k] - dp[k]) > UPDATE_TOL)) for k in names)
        share = tol.get("update_outliers")
        allowed = None if share is None else int(n_params * share)
        record = {
            "config": f"{nprocs} ranks vs 1 on {device} ({backend or 'default backend'}), "
                      f"{blocks} blocks x {features} features, "
                      f"{'bfloat16' if bf16 else 'float32'}, batch {batch} then {ragged}",
            "ref_losses": ref["losses"].tolist(), "dp_losses": dp["losses"].tolist(),
            "max_diff": diffs, "tol": tol,
            "update": {"params": n_params, "tol": UPDATE_TOL, "outliers": outliers,
                       "outliers_allowed": allowed, "max_abs": diffs["params"],
                       "max_abs_tol": FLIP_TOL},
            "largest": {"sample": float(np.abs(ref["sample"]).max()),
                        "ddrm": float(np.abs(ref["ddrm"]).max())},
            "step_ms": {"ref_1rank": ref["step_ms"].tolist(), "dp": dp["step_ms"].tolist()},
            "launches": {"ref_1rank": json.loads(str(ref["launches"])),
                         "dp_rank0": json.loads(str(dp["launches"]))},
            "ddrm_forwards": int(ref["ddrm_forwards"]),
        }
        record["ok"] = (all(diffs[k] < tol[k] for k in diffs if tol.get(k) is not None)
                        and diffs["params"] <= FLIP_TOL
                        and (allowed is None or outliers <= allowed))
        print(json.dumps(record), flush=True)
        if not record["ok"]:
            raise AssertionError(f"the {nprocs}-rank run diverged from the one-rank run: {record}")
        return record
    finally:
        if own:
            shutil.rmtree(workdir, ignore_errors=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--worker", type=int, default=None, metavar="RANK")
    ap.add_argument("--nprocs", type=int, default=2)
    ap.add_argument("--port", type=int, default=None)
    ap.add_argument("--manifest", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="each rank's device: cpu, cuda (cuda:RANK, a GPU a rank) or cuda:0 "
                         "(ranks sharing one card, with --backend gloo)")
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"))
    ap.add_argument("--blocks", type=int, default=2)
    ap.add_argument("--features", type=int, default=32)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ragged", type=int, default=5)
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--workdir", default=None,
                    help="keep intermediate files here instead of a temporary directory")
    args = ap.parse_args(argv)
    kw = dict(device=args.device, backend=args.backend, blocks=args.blocks,
              features=args.features, batch=args.batch, ragged=args.ragged, bf16=args.bf16)
    if args.worker is not None:
        worker(args.worker, args.nprocs, args.port, args.manifest, args.out, **kw)
    else:
        launch(args.nprocs, workdir=args.workdir, **kw)


if __name__ == "__main__":
    main()
