"""The evaluation harness over the test split (port of
hicdiff_tpu/metrics/harness.py).

It keeps the Outputs_diff npy-quartet contract {target, noisy, predict,
inds} (saved NCHW, as the reference caches) and the output directory name,
and computes the full metric suite (SSIM/PSNR/MSE/SNR/PCC/SPC/GenomeDISCO)
with the reference's running-average bookkeeping.

`model_fn` returns its prediction as a tensor on its device. The harness
queues the prediction's copy to pinned host memory right behind the work
that makes it and waits for that copy only after the next batch has been
enqueued, so the host scores batch N while the device runs batch N+1.
"""
from __future__ import annotations

import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from hicdiff_tpu_torch.data.datamodule import GSE130711Module, GSE131811Module
from hicdiff_tpu_torch.metrics.genomedisco import compute_reproducibility
from hicdiff_tpu_torch.metrics.image import mse, pearson, snr, spearman, ssim
from hicdiff_tpu_torch.parallel.mesh import Mesh, barrier, is_main

__all__ = ["build_test_module", "evaluate_model", "MetricAccumulator"]


def build_test_module(cell_line: str, cellN: int, deg: str, sigma: float, *, root=None,
                      batch_size=64, percentile=None):
    """Module choice by cell number: cells {1,22} population percentile,
    {2..6} single-cell (metrics_cond.py:67-77). `percentile` overrides it:
    callers that know the training percentile (the CLI reads it from the
    checkpoint's run_config) pass it, as the reference's train/eval pair
    otherwise normalizes cells 1/22 at two different clip values."""
    factory = GSE130711Module if cell_line == "Human" else GSE131811Module
    single = cellN in (2, 3, 4, 5, 6)
    kw = {} if percentile is None else {"percentile": float(percentile)}
    return factory(single_cell=single, batch_size=batch_size, deg=deg, sigma_0=sigma,
                   cell_No=cellN, root=root, **kw)


class MetricAccumulator:
    """The reference's running metric bookkeeping (stard_metrics.py:105-235).

    quirk_compat=True replicates the reference: batch_{ssims,psnrs,pccs,spcs,
    snrs} append the RUNNING averages (the final mean is a mean of running
    means) and 'snr' accumulates unnormalized. quirk_compat=False reports
    plain sample-weighted means. GenomeDISCO skips a batch whose target is
    all zeros, as the reference does (stard_metrics.py:175).

    gds_skip_empty=True instead skips GenomeDISCO on each patch whose target
    is all zeros: the reference's batch-level guard lets an empty far-band
    patch score a hard -1 against any prediction that is not exactly zero,
    which dominates the mean on sparse cells. The default False is the
    reference's (and the JAX package's) behaviour.
    """

    def __init__(self, quirk_compat: bool = True, gds_skip_empty: bool = False):
        self.quirk = quirk_compat
        self.gds_skip_empty = gds_skip_empty
        self.n = 0
        self.sums = {k: 0.0 for k in ["mse", "ssims", "pccs", "spcs", "snrs"]}
        self.batch_lists = {k: [] for k in ["ssim", "psnr", "mse", "snr", "pcc", "spc", "gds"]}

    def update(self, out01: np.ndarray, hr01: np.ndarray):
        """out01/hr01: NHWC numpy batches already in [0,1]. The metrics are
        many small ops on small arrays, so they run on the host on purpose
        (device="cpu"), as the JAX harness pins them to its CPU backend."""
        out_t = torch.as_tensor(out01, device="cpu")
        hr_t = torch.as_tensor(hr01, device="cpu")
        bsz = out01.shape[0]
        self.n += bsz
        batch_mse = float(mse(out_t, hr_t))
        self.sums["mse"] += batch_mse * bsz
        self.sums["ssims"] += float(ssim(out_t, hr_t)) * bsz
        self.sums["snrs"] += float(snr(hr_t, out_t)) * bsz
        self.sums["pccs"] += float(pearson(out_t, hr_t)) * bsz
        self.sums["spcs"] += spearman(out01, hr01) * bsz

        self.batch_lists["ssim"].append(self.sums["ssims"] / self.n)
        self.batch_lists["psnr"].append(10 * np.log10(1.0 / (self.sums["mse"] / self.n)))
        self.batch_lists["mse"].append(batch_mse)
        self.batch_lists["snr"].append(
            self.sums["snrs"] if self.quirk else self.sums["snrs"] / self.n)
        self.batch_lists["pcc"].append(self.sums["pccs"] / self.n)
        self.batch_lists["spc"].append(self.sums["spcs"] / self.n)

        if not self.gds_skip_empty and hr01.sum() == 0:  # the reference's batch-level guard
            return
        for i in range(bsz):
            if self.gds_skip_empty and hr01[i].sum() == 0:  # no signal in this patch
                continue
            self.batch_lists["gds"].append(compute_reproducibility(
                np.asarray(out01[i, :, :, 0]), np.asarray(hr01[i, :, :, 0]), transition=True))

    def result(self) -> Dict[str, float]:
        return {f"pas_{k}": float(np.mean(v)) if v else float("nan")
                for k, v in self.batch_lists.items()}


def _start_fetch(out: torch.Tensor) -> Callable[[], np.ndarray]:
    """Queue `out`'s copy to the host and return the wait for it. A CUDA
    tensor is copied into pinned memory on its stream, right behind the
    work that makes it; the wait then covers that work and the copy only,
    not whatever was enqueued after them."""
    if out.is_cuda:
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(out.device))

        def wait() -> np.ndarray:
            done.synchronize()
            return host.numpy()

        return wait
    return out.numpy


def evaluate_model(
    model_fn: Callable[[np.ndarray], torch.Tensor],
    *,
    model_name: str = "HiCdiff",
    chro="test",
    deg: str = "deno",
    sigma: float = 0.1,
    cellN: int = 1,
    cell_line: str = "Human",
    root: Optional[str] = None,
    result_tag: str = "",
    batch_size: int = 64,
    compute_metrics: bool = True,
    input_kind: str = "noisy",
    percentile=None,  # the training-time clip percentile (see build_test_module)
    mesh: Optional[Mesh] = None,
) -> Dict:
    """Iterate the test split, run `model_fn` per batch, save the
    Outputs_diff quartet, and return {'predict', 'inds', 'metrics',
    'outdir', 'data_dir', 'res', 'timing'}.

    model_fn maps a numpy input batch, the last one padded with zero rows
    to `batch_size`, to an NHWC prediction tensor. input_kind 'noisy' feeds
    the NHWC [-1,1] noisy patches (the conditional path); 'sample' the
    measurements y, (B, M) with M the operator's measurement width (the
    DDRM path, metrics_diff.py:172-180). `timing` holds the phase split in
    seconds (data setup; the batches' dispatch, fetch and metrics, totals
    and the fetch and metrics of each batch; the save), printed when
    HICDIFF_EVAL_TIMING=1.

    With a mesh (a sampler sharded over ranks: each call of `model_fn` is
    a collective), every rank goes through the same batches and calls;
    the main rank prepares the cache first (the others wait at a barrier),
    and only it computes the metrics and writes the quartet. The other
    ranks return the same dict with `metrics` set to None and write
    nothing.
    """
    if input_kind not in ("noisy", "sample"):
        raise ValueError(f"input_kind must be 'noisy' or 'sample', got {input_kind!r}")
    show = bool(int(os.environ.get("HICDIFF_EVAL_TIMING", "0") or "0"))
    t0 = time.perf_counter()
    dm = build_test_module(cell_line, cellN, deg, sigma, root=root, batch_size=batch_size,
                           percentile=percentile)
    main = is_main(mesh)
    if main:
        dm.prepare_data()
    barrier(mesh)
    compute_metrics = compute_metrics and main
    dm.setup(stage=chro)
    loader = dm.test_dataloader()
    spent = {"setup": time.perf_counter() - t0, "dispatch": 0.0, "fetch": 0.0,
             "metrics": 0.0, "save": 0.0, "batches": 0,
             "fetch_per_batch": [], "metrics_per_batch": []}
    if show:
        print(f"[eval-timing] data setup: {spent['setup']:.3f}s", flush=True)

    outdir = os.path.join(root or os.getcwd(), "Outputs_diff",
                          f"{model_name}{cell_line}{cellN}_{deg}_{sigma}{result_tag}")
    if main:
        os.makedirs(outdir, exist_ok=True)

    acc = MetricAccumulator()
    prs, hrs, lrs, inds_all = [], [], [], []

    def dispatch(lr, hr, samp, inds):
        """Enqueue the model on a batch padded by rows to `batch_size`, and
        its copy to the host. The conditional path reads the noisy patches,
        the DDRM path the measurements `samp`."""
        bsz = lr.shape[0]
        x_in = lr if input_kind == "noisy" else samp
        x_in = np.pad(x_in, [(0, batch_size - bsz)] + [(0, 0)] * (x_in.ndim - 1))
        t = time.perf_counter()
        fetch = _start_fetch(model_fn(x_in))
        spent["dispatch"] += time.perf_counter() - t
        spent["batches"] += 1
        return fetch, bsz, hr, lr, inds

    def consume(pending):
        fetch, bsz, hr, lr, inds = pending
        t = time.perf_counter()
        out = fetch()[:bsz]
        spent["fetch_per_batch"].append(time.perf_counter() - t)
        spent["fetch"] += spent["fetch_per_batch"][-1]
        prs.append(out)
        hrs.append(hr)
        lrs.append(lr)
        inds_all.append(inds)
        if compute_metrics:
            t = time.perf_counter()
            out01 = np.clip((out + 1.0) / 2.0, 0.0, 1.0)
            hr01 = np.clip((np.asarray(hr) + 1.0) / 2.0, 0.0, 1.0)
            acc.update(out01, hr01)
            spent["metrics_per_batch"].append(time.perf_counter() - t)
            spent["metrics"] += spent["metrics_per_batch"][-1]

    pending = None
    for batch in loader:
        nxt = dispatch(*batch)
        if pending is not None:
            consume(pending)
        pending = nxt
    if pending is not None:
        consume(pending)
    if show:
        print("[eval-timing] {batches} batches: dispatch {dispatch:.3f}s, "
              "fetch {fetch:.3f}s, metrics {metrics:.3f}s".format(**spent), flush=True)

    t = time.perf_counter()
    predict = np.concatenate(prs)
    index = np.concatenate(inds_all)
    if main:
        # persist in the reference's NCHW layout (metrics_cond.py:126-134)
        def to_nchw(a):
            return np.transpose(a, (0, 3, 1, 2)) if a.ndim == 4 else a

        np.save(os.path.join(outdir, "target"), to_nchw(np.concatenate(hrs)))
        np.save(os.path.join(outdir, "noisy"), to_nchw(np.concatenate(lrs)))
        np.save(os.path.join(outdir, "predict"), to_nchw(predict))
        np.save(os.path.join(outdir, "inds"), index)
    spent["save"] = time.perf_counter() - t
    if show:
        print(f"[eval-timing] concat+save: {spent['save']:.3f}s", flush=True)

    return {
        "predict": predict,
        "inds": index,
        "metrics": (acc.result() if compute_metrics else {}) if main else None,
        "outdir": outdir,
        "data_dir": dm.dirname,
        "res": dm.res,
        "timing": spent,
    }
