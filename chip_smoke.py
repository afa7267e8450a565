#!/usr/bin/env python
"""On-card check of the PyTorch/CUDA port (hicdiff_tpu_torch): run it from the
root of a checkout on a machine with an NVIDIA H100,

    python3 chip_smoke.py

It builds the port's CUDA kernels from hicdiff_tpu_torch/csrc/, holds each
against its plain PyTorch version at the main path's shapes, runs the full
32-block backbone through the kernels against the plain path, then serves
three `denoise` requests of 8 full-width patches through the port's
DenoiseService on a Unix socket and checks, by the kernels' launch counters,
that every residual block and every sampling step went through the kernels.
Each phase prints one line with its wall time; the first failure ends the run
with a non-zero exit. Without CUDA it fails before printing any result.
The last line is {"ok": true, "device": {...}}.
"""
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

RESBLOCK_SHAPE = (8, 64, 64, 256)  # one service batch at full width
STEP_SHAPE = (8, 64, 64, 1)        # the chain state of one service batch
NOISE_SHAPE = (64, 4096)           # 262,144 draws for the noise statistics
BLOCKS, FEATURES, SIGMA, BATCH, REQUESTS = 32, 256, 0.1, 8, 3


def phase(name, t0, **fields):
    print(json.dumps({"phase": name, "wall_s": round(time.time() - t0, 3), **fields}),
          flush=True)


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def cuda_ms(fn, iters=20):
    """Mean device time of fn() over `iters` calls, by CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False")
    sys.path.insert(0, ROOT)
    from hicdiff_tpu_torch.kernels import _build
    from hicdiff_tpu_torch.kernels.resblock import fused_resblock, fused_resblock_reference
    from hicdiff_tpu_torch.kernels.sample_step import (
        fused_posterior_step,
        fused_posterior_step_reference,
    )
    from hicdiff_tpu_torch.models.hicedrn import HicedrnDiff
    from hicdiff_tpu_torch.serve import DenoiseService, request, serve_forever

    dev = torch.device("cuda")
    # the plain fp32 versions must not quietly run in TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # ---- 1. environment and build
    t0 = time.time()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    t_build = time.time()
    _build.load_library()
    build_s = time.time() - t_build
    ptxas = open(os.path.splitext(_build.library_path())[0] + ".log").read()
    phase("environment", t0, card=card, kind=kind, torch=torch.__version__,
          cuda=torch.version.cuda, python=sys.version.split()[0], build_s=round(build_s, 3),
          ptxas=[ln.strip() for ln in ptxas.splitlines() if "Used" in ln or "spill" in ln])

    # ---- 2. fused_resblock kernel vs plain
    t0 = time.time()
    g = torch.Generator().manual_seed(0)
    b, h, w, c = RESBLOCK_SHAPE
    bound = 1.0 / (9 * c) ** 0.5  # PyTorch's default conv init
    x = torch.randn(RESBLOCK_SHAPE, generator=g) * 0.5
    kernel = (torch.rand(3, 3, c, c, generator=g) * 2 - 1) * bound
    bias = (torch.rand(c, generator=g) * 2 - 1) * bound
    te = torch.randn(b, 2 * c, generator=g) * 0.5
    resblock = {}
    for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 0.016)):
        xd, kd, bd, ted = (t.to(dev, dt) for t in (x, kernel, bias, te))
        scale, shift = ted.chunk(2, dim=-1)
        got = fused_resblock(xd, kd, bd, scale, shift)
        want = fused_resblock_reference(xd, kd, bd, scale, shift)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        check(err <= tol, f"fused_resblock {dt}: max-abs {err} > {tol}")
        ms = cuda_ms(lambda: fused_resblock(xd, kd, bd, scale, shift))
        plain_ms = cuda_ms(lambda: fused_resblock_reference(xd, kd, bd, scale, shift))
        resblock[dt] = (err, ms, plain_ms)
        phase("fused_resblock", t0, dtype=str(dt), shape=RESBLOCK_SHAPE, max_abs_err=err,
              tol=tol, ms=ms, plain_ms=plain_ms,
              tflops=2 * 2 * b * h * w * c * c * 9 / ms / 1e9, card=card)

    # ---- 3. fused_posterior_step kernel vs plain
    t0 = time.time()
    a_, b_, c1, c2, logvar = 1.1, 0.5, 0.7, 0.3, -2.0
    xs = torch.randn(STEP_SHAPE, generator=g).to(dev)
    es = torch.randn(STEP_SHAPE, generator=g).to(dev)
    out, x0 = fused_posterior_step(xs, es, a_, b_, c1, c2, logvar, 0.0, 123)
    want_out, want_x0 = fused_posterior_step_reference(xs, es, a_, b_, c1, c2, logvar, 0.0, 123)
    step_err = max((out - want_out).abs().max().item(), (x0 - want_x0).abs().max().item())
    check(step_err <= 1e-6, f"fused_posterior_step gate=0: max-abs {step_err} > 1e-6")
    xn = torch.randn(NOISE_SHAPE, generator=g).to(dev)
    zn = torch.zeros_like(xn)
    sig_logvar = 2 * float(np.log(0.5))  # sigma = 0.5; mean = 0, so x_next is the noise
    n1, _ = fused_posterior_step(xn, zn, 1.0, 0.0, 0.0, 0.0, sig_logvar, 1.0, 7)
    n2, _ = fused_posterior_step(xn, zn, 1.0, 0.0, 0.0, 0.0, sig_logvar, 1.0, 7)
    n3, _ = fused_posterior_step(xn, zn, 1.0, 0.0, 0.0, 0.0, sig_logvar, 1.0, 8)
    noise_mean, noise_std = n1.mean().item(), n1.std().item()
    check(abs(noise_mean) < 0.01, f"noise mean {noise_mean}")
    check(abs(noise_std - 0.5) <= 0.01, f"noise std {noise_std} vs sigma 0.5")
    check(torch.equal(n1, n2), "the same seed must reproduce bitwise")
    check(not torch.equal(n1, n3), "different seeds must differ")
    step_ms = cuda_ms(lambda: fused_posterior_step(xs, es, a_, b_, c1, c2, logvar, 1.0, 5))
    step_plain_ms = cuda_ms(
        lambda: fused_posterior_step_reference(xs, es, a_, b_, c1, c2, logvar, 1.0, 5))
    phase("fused_posterior_step", t0, shape=STEP_SHAPE, max_abs_err_gate0=step_err,
          noise_elements=xn.numel(), noise_mean=noise_mean, noise_std=noise_std,
          ms=step_ms, plain_ms=step_plain_ms, card=card)

    # ---- 4. full backbone forward: kernel path (CUDA) vs plain path (CPU)
    t0 = time.time()
    kw = dict(self_condition=True, number_resnet=BLOCKS, features=FEATURES)
    model_gpu = HicedrnDiff(device=dev, generator=torch.Generator().manual_seed(1), **kw)
    model_cpu = HicedrnDiff(device="cpu", generator=torch.Generator().manual_seed(1), **kw)
    xb = torch.randn(STEP_SHAPE, generator=g) * 0.3
    cb = torch.randn(STEP_SHAPE, generator=g) * 0.3
    tb = torch.tensor([3, 29, 100, 250, 500, 700, 900, 999])
    xd, td, cd = xb.to(dev), tb.to(dev), cb.to(dev)
    with torch.no_grad():
        got = model_gpu(xd, td, cd).cpu()
        tc = time.time()
        want = model_cpu(xb, tb, cb)
        cpu_s = time.time() - tc
    fwd_err = (got - want).abs().max().item()
    check(got.shape == STEP_SHAPE and torch.isfinite(got).all().item(), "backbone output")
    check(fwd_err <= 1e-3, f"backbone forward: max-abs {fwd_err} > 1e-3")
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: model_gpu(xd, td, cd), iters=5)
    phase("backbone_forward", t0, blocks=BLOCKS, features=FEATURES, shape=STEP_SHAPE,
          dtype="float32", max_abs_err=fwd_err, tol=1e-3, kernel_path_ms=fwd_ms,
          plain_path_cpu_s=cpu_s, card=card)
    del model_gpu, model_cpu

    # ---- 5. serve 3 denoise requests through the port's DenoiseService
    t0 = time.time()
    service = DenoiseService(
        None, device=dev, sigma=SIGMA, schedule="sigmoid", timesteps=1000,
        t_start="auto", batch=BATCH, bf16=True, blocks=BLOCKS, features=FEATURES, seed=0,
    )
    startup_s = time.time() - t0
    steps = service.t_start + 1
    check(service.t_start == 29, f"t* at sigma=0.1 on sigmoid T=1000: {service.t_start}")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="smoke_", dir=os.path.join(ROOT, "build"))
    sock = min(os.path.join(work, "s.sock"), os.path.relpath(os.path.join(work, "s.sock")),
               key=len)
    server = threading.Thread(target=serve_forever, args=(service, sock), daemon=True)
    server.start()
    try:
        for _ in range(200):
            if os.path.exists(sock):
                break
            time.sleep(0.05)
        ping = request(sock, {"id": 0, "op": "ping"})
        check(ping.get("ok") and ping["t_start"] == 29, f"ping: {ping}")
        fused_resblock.launches = 0
        fused_posterior_step.launches = 0
        rng = np.random.default_rng(0)
        latencies = []
        for i in range(1, REQUESTS + 1):
            noisy = np.clip(rng.normal(0, 0.3, (BATCH, 1, 64, 64)), -1, 1).astype(np.float32)
            src = os.path.join(work, f"noisy_{i}.npy")
            np.save(src, noisy)
            tr = time.time()
            resp = request(sock, {"id": i, "op": "denoise", "npy": src})
            latency = time.time() - tr
            check(resp.get("ok"), f"denoise request {i}: {resp}")
            out = np.load(resp["out"])
            check(out.shape == noisy.shape, f"request {i}: shape {out.shape}")
            check(np.isfinite(out).all(), f"request {i}: non-finite output")
            # the last step (t = 0) returns the clipped x0 prediction
            check(np.abs(out).max() <= 1.0, f"request {i}: output outside [-1, 1]")
            latencies.append(latency)
            phase("denoise_request", tr, request=i, patches=BATCH, steps=steps,
                  latency_s=latency, patches_per_s=BATCH / latency, card=card)
        resblock_launches = fused_resblock.launches
        step_launches = fused_posterior_step.launches
        want_resblock = REQUESTS * steps * BLOCKS * 2  # two launches per block
        want_step = REQUESTS * steps
        check(resblock_launches == want_resblock,
              f"resblock launches {resblock_launches} != {want_resblock}")
        check(step_launches == want_step, f"posterior-step launches {step_launches} != {want_step}")
        bye = request(sock, {"id": REQUESTS + 1, "op": "shutdown"})
        check(bye.get("ok"), f"shutdown: {bye}")
        server.join(timeout=30)
        check(not server.is_alive(), "server thread did not stop")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    phase("serve", t0, startup_s=startup_s, requests=REQUESTS, patches_per_request=BATCH,
          blocks=BLOCKS, features=FEATURES, dtype="bfloat16", sigma=SIGMA, steps=steps,
          latency_s=latencies, resblock_launches=resblock_launches,
          posterior_step_launches=step_launches, card=card)

    err32, ms32, plain32 = resblock[torch.float32]
    err16, ms16, plain16 = resblock[torch.bfloat16]
    kernels = [
        {"name": "fused_resblock", "route": "cuda",
         "source": "hicdiff_tpu_torch/csrc/resblock.cu",
         "replaces": "hicdiff_tpu/kernels/resblock.py:101",
         "launches": resblock_launches, "max_abs_err": err16, "ms": ms16, "plain_ms": plain16,
         "dtype": "bfloat16", "max_abs_err_fp32": err32, "ms_fp32": ms32,
         "plain_ms_fp32": plain32},
        {"name": "fused_posterior_step", "route": "cuda",
         "source": "hicdiff_tpu_torch/csrc/sample_step.cu",
         "replaces": "hicdiff_tpu/kernels/sample_step.py:65",
         "launches": step_launches, "max_abs_err": step_err, "ms": step_ms,
         "plain_ms": step_plain_ms},
    ]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
