#!/usr/bin/env python
"""On-card check of the PyTorch/CUDA port (hicdiff_tpu_torch): run it from the
root of a checkout on a machine with an NVIDIA H100,

    python3 chip_smoke.py

It builds the port's CUDA kernels from hicdiff_tpu_torch/csrc/, holds each
against its plain PyTorch version at the main path's shapes (the conv in
bf16 and fp32, each also at two ragged shapes), times each beside its bound
and, where one exists, the PyTorch library calls that compute the same
function, runs the full 32-block backbone through the kernels against the
plain path, then serves `denoise` requests of 8 full-width patches through
the port's DenoiseService on a Unix socket, twice: three requests of a bf16
service (`bf16=True`), then two of an fp32 service (`bf16=False`, the
default of `serve_torch.py` and of the `-u 0` CLI). For each service it
checks, by the kernels' launch counters, that every residual block and every
sampling step went through the kernels, and runs one more request under
torch.profiler for the device-time breakdown. The host's enqueue time of one
bf16 sampling step is split into the conv wrapper's share and the rest.

Times: `ms`, `plain_ms` and `library_ms` are CUDA-event times of back-to-back
calls (device time plus any gaps where the device waits for the host);
`device_ms` and its kin are the summed device durations from torch.profiler.
Bounds: the fp32 conv keeps `bound_ms` (as `bound_ms_fp32` in the kernels
line), its FLOPs at the 67 TFLOP/s of CUDA-core FMAs, and adds
`bound_ms_3xtf32`, three times its FLOPs at the 495 TFLOP/s of TF32 on the
tensor cores: the kernel runs each product as three TF32 products there, so
that is the least time its design could take, and its share of bound is read
against it. The posterior step moves less than a launch takes, so its phase
prints `floor_device_ms`, the device time of a launch that does almost
nothing (a 1-element fill), beside its own device time.
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
from collections import defaultdict

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))

RESBLOCK_SHAPE = (8, 64, 64, 256)  # one service batch at full width
STEP_SHAPE = (8, 64, 64, 1)        # the chain state of one service batch
NOISE_SHAPE = (64, 4096)           # 262,144 draws for the noise statistics
RAGGED_SHAPES = ((2, 10, 13, 256), (1, 6, 80, 256))  # ragged H/W tiles, two column tiles
BLOCKS, FEATURES, SIGMA, BATCH, REQUESTS = 32, 256, 0.1, 8, 3
FP32_REQUESTS = 2
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 and TF32 on the tensor
# cores, fp32 outside them, and the HBM3 rate
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12, "tf32": 495e12}
HBM_BYTES_PER_S = 3.35e12
CONV_KERNELS = ("conv3x3_bf16_kernel", "conv3x3_3xtf32_kernel")


def phase(name, t0, **fields):
    print(json.dumps({"phase": name, "wall_s": round(time.time() - t0, 3), **fields}),
          flush=True)


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def cuda_ms(fn, iters=20):
    """Mean time of fn() over `iters` back-to-back calls, by CUDA events, after
    a warm-up: device time plus any gaps where the device waits for the host."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(flops, nbytes, dtype):
    """The least time the card could take: operations over the peak rate of
    their type, or bytes over the memory rate, whichever is larger."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def resblock_inputs(shape, g):
    """x, kernel (HWIO), bias and the (B, 2C) time projection, seeded, on the CPU."""
    b, h, w, c = shape
    bound = 1.0 / (9 * c) ** 0.5  # PyTorch's default conv init
    x = torch.randn(shape, generator=g) * 0.5
    kernel = (torch.rand(3, 3, c, c, generator=g) * 2 - 1) * bound
    bias = (torch.rand(c, generator=g) * 2 - 1) * bound
    te = torch.randn(b, 2 * c, generator=g) * 0.5
    return x, kernel, bias, te


def library_resblock(x, w_oihw, bias, scale, shift):
    """The yardstick: two cuDNN convs on channels_last views in x's dtype with
    the eager epilogue. Timed here only; the port never calls it."""
    xc = x.permute(0, 3, 1, 2)
    h = F.conv2d(xc, w_oihw, bias, padding=1)
    h = F.silu(h * (scale[:, :, None, None] + 1) + shift[:, :, None, None])
    return (F.conv2d(h, w_oihw, bias, padding=1) * 0.1 + xc).permute(0, 2, 3, 1)


def device_ops(prof):
    """(name, start us, duration us) of every device activity in a profile."""
    from torch.autograd import DeviceType

    return [(e.name, e.time_range.start, e.time_range.elapsed_us())
            for e in prof.events() if e.device_type == DeviceType.CUDA]


def profiled_ms(fn, iters=20):
    """Mean device time of fn() over `iters` calls, after a warm-up: the summed
    durations of the device work they launch, from torch.profiler. Unlike
    cuda_ms it leaves out the gaps where the device waits for the host, which
    bound a call that launches little work."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ops = device_ops(prof)
    check(ops, "the profiler saw no device activity")
    return sum(d for _, _, d in ops) / 1e3 / iters


def host_us(fn, iters=50, reps=5):
    """Mean host time of fn() in microseconds over `iters` calls, the median
    of `reps` such runs (the host is shared and spreads): the calls only
    enqueue work, and the device never makes the host wait."""
    runs = []
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(iters):
            fn()
        runs.append((time.perf_counter() - t) / iters * 1e6)
        torch.cuda.synchronize()
    return sorted(runs)[reps // 2]


def serve_and_profile(service, requests, dtype, card):
    """Serve `requests` denoise requests of BATCH patches through `service` on
    a Unix socket, check every output and, by the launch counters (set to 0
    just before the requests and read just after), that each block and step
    went through the kernels; then one more request under the profiler, and
    shut the server down. Returns what was measured."""
    from hicdiff_tpu_torch.kernels.resblock import fused_resblock
    from hicdiff_tpu_torch.kernels.sample_step import fused_posterior_step
    from hicdiff_tpu_torch.serve import request, serve_forever

    steps = service.t_start + 1
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
        check(ping.get("ok") and ping["t_start"] == service.t_start, f"ping: {ping}")
        fused_resblock.launches = 0
        fused_posterior_step.launches = 0
        rng = np.random.default_rng(0)
        latencies = []
        for i in range(1, requests + 1):
            noisy = np.clip(rng.normal(0, 0.3, (BATCH, 1, 64, 64)), -1, 1).astype(np.float32)
            src = os.path.join(work, f"noisy_{i}.npy")
            np.save(src, noisy)
            tr = time.time()
            resp = request(sock, {"id": i, "op": "denoise", "npy": src})
            latency = time.time() - tr
            check(resp.get("ok"), f"{dtype} denoise request {i}: {resp}")
            out = np.load(resp["out"])
            check(out.shape == noisy.shape, f"{dtype} request {i}: shape {out.shape}")
            check(np.isfinite(out).all(), f"{dtype} request {i}: non-finite output")
            # the last step (t = 0) returns the clipped x0 prediction
            check(np.abs(out).max() <= 1.0, f"{dtype} request {i}: output outside [-1, 1]")
            latencies.append(latency)
            phase("denoise_request", tr, request=i, dtype=dtype, patches=BATCH, steps=steps,
                  latency_s=latency, patches_per_s=BATCH / latency, card=card)
        resblock_launches = fused_resblock.launches
        step_launches = fused_posterior_step.launches
        want_resblock = requests * steps * BLOCKS * 2  # two launches per block
        want_step = requests * steps
        check(resblock_launches == want_resblock,
              f"{dtype} resblock launches {resblock_launches} != {want_resblock}")
        check(step_launches == want_step,
              f"{dtype} posterior-step launches {step_launches} != {want_step}")
        # one more request under the profiler: where the device time goes. It
        # traces device activity only, since tracing every host op would slow
        # the host, which may bound the request
        src = os.path.join(work, "noisy_profile.npy")
        np.save(src, np.clip(rng.normal(0, 0.3, (BATCH, 1, 64, 64)), -1, 1).astype(np.float32))
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            # let the tracer settle before the request and drain after it: a
            # device-bound request once lost a step's records without this
            time.sleep(0.2)
            tr = time.time()
            resp = request(sock, {"id": requests + 1, "op": "denoise", "npy": src})
            profiled_s = time.time() - tr
            torch.cuda.synchronize()
            time.sleep(0.2)
        check(resp.get("ok"), f"{dtype} profiled request: {resp}")
        ops = device_ops(prof)
        check(ops, "the profiler saw no device activity")
        busy_us = sum(d for _, _, d in ops)
        span_us = max(s + d for _, s, d in ops) - min(s for _, s, d in ops)
        by_name = defaultdict(lambda: [0, 0.0])
        for name, _, d in ops:
            by_name[name][0] += 1
            by_name[name][1] += d
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
        ours = {}  # the port's kernels, device time only
        for key in (*CONV_KERNELS, "posterior_step_kernel"):
            hits = [(k, t) for n, (k, t) in by_name.items() if key in n]
            ours[key] = {"launches": sum(k for k, _ in hits),
                         "ms": sum(t for _, t in hits) / 1e3}
        idle_wall = 1 - busy_us / 1e3 / (profiled_s * 1e3)
        phase("profile", tr, request=requests + 1, dtype=dtype, latency_s=profiled_s,
              device_busy_ms=busy_us / 1e3, device_span_ms=span_us / 1e3,
              idle_share_of_wall=idle_wall, idle_share_of_span=1 - busy_us / span_us,
              kernels=ours,
              top=[{"name": n[:90], "launches": k, "ms": t / 1e3, "share": t / busy_us}
                   for n, (k, t) in top], card=card)
        bye = request(sock, {"id": requests + 2, "op": "shutdown"})
        check(bye.get("ok"), f"shutdown: {bye}")
        server.join(timeout=30)
        check(not server.is_alive(), "server thread did not stop")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return dict(latencies=latencies, resblock_launches=resblock_launches,
                step_launches=step_launches, profiled_s=profiled_s, busy_ms=busy_us / 1e3,
                idle_share_of_wall=idle_wall, kernels=ours)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False")
    sys.path.insert(0, ROOT)
    from hicdiff_tpu_torch.kernels import _build
    from hicdiff_tpu_torch.kernels.resblock import (
        _conv3x3,
        fused_resblock,
        fused_resblock_prepared,
        fused_resblock_reference,
        prepare_weight,
    )
    from hicdiff_tpu_torch.kernels.sample_step import (
        fused_posterior_step,
        fused_posterior_step_reference,
    )
    from hicdiff_tpu_torch.models.hicedrn import HicedrnDiff
    from hicdiff_tpu_torch.serve import DenoiseService

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
          ptxas=[ln.strip() for ln in ptxas.splitlines()
                 if any(k in ln for k in ("Used", "spill", "arning", "Compiling entry"))])

    # ---- 2. fused_resblock kernel vs plain, beside its bound and the library pair;
    # timed as the main path calls it, on a weight prepared once
    t0 = time.time()
    g = torch.Generator().manual_seed(0)
    b, h, w, c = RESBLOCK_SHAPE
    x, kernel, bias, te = resblock_inputs(RESBLOCK_SHAPE, g)
    resblock = {}
    for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 0.016)):
        xd, kd, bd, ted = (t.to(dev, dt) for t in (x, kernel, bias, te))
        scale, shift = ted.chunk(2, dim=-1)
        wd = prepare_weight(kd)
        got = fused_resblock_prepared(xd, wd, bd, scale, shift)
        want = fused_resblock_reference(xd, kd, bd, scale, shift)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        check(err <= tol, f"fused_resblock {dt}: max-abs {err} > {tol}")
        w_lib = kd.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        lib_err = (library_resblock(xd, w_lib, bd, scale, shift).float()
                   - want.float()).abs().max().item()

        def kernel_call():
            return fused_resblock_prepared(xd, wd, bd, scale, shift)

        def plain_call():
            return fused_resblock_reference(xd, kd, bd, scale, shift)

        def library_call():
            return library_resblock(xd, w_lib, bd, scale, shift)

        ms, plain_ms, library_ms = cuda_ms(kernel_call), cuda_ms(plain_call), cuda_ms(library_call)
        dev_ms, plain_dev_ms, library_dev_ms = (
            profiled_ms(kernel_call), profiled_ms(plain_call), profiled_ms(library_call))
        # host time of the wrapper (two launches), and of one bare launch
        # through the C entry (ctypes, tensor-map encoding, launch)
        call_host_us = host_us(kernel_call)
        lib, fn = _conv3x3(dt)
        hidden = torch.empty_like(xd)
        stream = torch.cuda.current_stream().cuda_stream

        def bare_launch():  # conv #1 alone; not counted, as it is no main-path launch
            _build.check_status(lib, fn(
                xd.data_ptr(), wd.data_ptr(), bd.data_ptr(), scale.data_ptr(),
                shift.data_ptr(), scale.stride(0), None, hidden.data_ptr(), b, h, w, c, 1,
                stream), "conv3x3")

        launch_host_us = host_us(bare_launch)
        flops = 2 * 2 * b * h * w * c * c * 9  # two convs
        nbytes = sum(t.numel() * t.element_size() for t in (xd, kd, bd, scale, shift, got))
        bound, bound_by = bound_ms(flops, nbytes, dt)
        resblock[dt] = dict(err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                            bound_ms=bound, bound_by=bound_by, device_ms=dev_ms,
                            host_us=call_host_us)
        extra = {}
        if dt == torch.float32:  # three TF32 products per product, on the tensor cores
            bound3, bound3_by = bound_ms(3 * flops, nbytes, "tf32")
            resblock[dt].update(bound_ms_3xtf32=bound3, share_of_bound_3xtf32=bound3 / ms)
            extra = dict(bound_ms_3xtf32=bound3, bound_by_3xtf32=bound3_by,
                         share_of_bound_3xtf32=bound3 / ms,
                         share_of_bound_3xtf32_device=bound3 / dev_ms)
        phase("fused_resblock", t0, dtype=str(dt), shape=RESBLOCK_SHAPE, max_abs_err=err,
              tol=tol, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
              device_ms=dev_ms, plain_device_ms=plain_dev_ms,
              library_device_ms=library_dev_ms, library_max_abs_err=lib_err,
              bound_ms=bound, bound_by=bound_by, share_of_bound=bound / ms,
              share_of_bound_device=bound / dev_ms, tflops=flops / ms / 1e9,
              host_us=call_host_us, launch_host_us=launch_host_us, **extra, card=card)
    for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 0.016)):
        ragged_errs = []
        for shape in RAGGED_SHAPES:
            xr, kr, br, ter = (t.to(dev, dt) for t in resblock_inputs(shape, g))
            sr, hr = ter.chunk(2, dim=-1)
            got = fused_resblock(xr, kr, br, sr, hr)
            want = fused_resblock_reference(xr, kr, br, sr, hr)
            torch.cuda.synchronize()
            check(got.shape == shape, f"fused_resblock {dt} {shape}: shape {tuple(got.shape)}")
            err = (got.float() - want.float()).abs().max().item()
            check(err <= tol, f"fused_resblock {dt} {shape}: max-abs {err} > {tol}")
            ragged_errs.append(err)
        phase("fused_resblock_ragged", t0, dtype=str(dt), shapes=RAGGED_SHAPES,
              max_abs_err=ragged_errs, tol=tol, card=card)

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
    def step_call():
        return fused_posterior_step(xs, es, a_, b_, c1, c2, logvar, 1.0, 5)

    def step_plain_call():
        return fused_posterior_step_reference(xs, es, a_, b_, c1, c2, logvar, 1.0, 5)

    step_ms, step_plain_ms = cuda_ms(step_call), cuda_ms(step_plain_call)
    step_dev_ms, step_plain_dev_ms = profiled_ms(step_call), profiled_ms(step_plain_call)
    post_host_us = host_us(step_call)
    one = torch.zeros(1, device=dev)
    floor_dev_ms = profiled_ms(lambda: one.fill_(1.0))  # the device time of a bare launch
    # x and eps read, x_next and x0 written, fp32; a handful of FLOPs a byte
    step_bound, step_bound_by = bound_ms(0, 4 * xs.numel() * xs.element_size(), torch.float32)
    phase("fused_posterior_step", t0, shape=STEP_SHAPE, max_abs_err_gate0=step_err,
          noise_elements=xn.numel(), noise_mean=noise_mean, noise_std=noise_std,
          ms=step_ms, plain_ms=step_plain_ms, device_ms=step_dev_ms,
          plain_device_ms=step_plain_dev_ms, bound_ms=step_bound, bound_by=step_bound_by,
          share_of_bound=step_bound / step_ms, share_of_bound_device=step_bound / step_dev_ms,
          floor_device_ms=floor_dev_ms, host_us=post_host_us, card=card)

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

    # ---- 5. serve 3 denoise requests through a bf16 DenoiseService
    t0 = time.time()
    service = DenoiseService(
        None, device=dev, sigma=SIGMA, schedule="sigmoid", timesteps=1000,
        t_start="auto", batch=BATCH, bf16=True, blocks=BLOCKS, features=FEATURES, seed=0,
    )
    startup_s = time.time() - t0
    steps = service.t_start + 1
    check(service.t_start == 29, f"t* at sigma=0.1 on sigmoid T=1000: {service.t_start}")
    served = serve_and_profile(service, REQUESTS, "bfloat16", card)
    # the host's enqueue time of one sampling step of this service, and
    # the conv wrapper's share of it (BLOCKS calls, from phase 2)
    th = time.time()
    xh = torch.zeros(STEP_SHAPE, device=dev)
    ch = torch.zeros(STEP_SHAPE, device=dev)
    gh = torch.Generator().manual_seed(0)
    step_host_us = host_us(lambda: service.engine.p_sample_step(xh, 10, ch, gh), iters=5,
                           reps=3)
    wrapper_us = BLOCKS * resblock[torch.bfloat16]["host_us"]
    phase("host_split", th, step_host_ms=step_host_us / 1e3,
          resblock_wrappers_ms=wrapper_us / 1e3,
          resblock_wrappers_share=wrapper_us / step_host_us,
          step_device_ms=served["busy_ms"] / steps, card=card)
    resblock_launches, step_launches = served["resblock_launches"], served["step_launches"]
    phase("serve", t0, startup_s=startup_s, requests=REQUESTS, patches_per_request=BATCH,
          blocks=BLOCKS, features=FEATURES, dtype="bfloat16", sigma=SIGMA, steps=steps,
          latency_s=served["latencies"], resblock_launches=resblock_launches,
          posterior_step_launches=step_launches, card=card)
    del service

    # ---- 6. serve 2 denoise requests through an fp32 DenoiseService, the
    # default of serve_torch.py and of the -u 0 CLI
    t0 = time.time()
    service = DenoiseService(
        None, device=dev, sigma=SIGMA, schedule="sigmoid", timesteps=1000,
        t_start="auto", batch=BATCH, bf16=False, blocks=BLOCKS, features=FEATURES, seed=0,
    )
    startup_s = time.time() - t0
    check(service.t_start == 29, f"t* at sigma=0.1 on sigmoid T=1000: {service.t_start}")
    served32 = serve_and_profile(service, FP32_REQUESTS, "float32", card)
    check(served32["kernels"]["conv3x3_3xtf32_kernel"]["launches"] == steps * BLOCKS * 2,
          f"profiled fp32 request: {served32['kernels']}")
    phase("serve_fp32", t0, startup_s=startup_s, requests=FP32_REQUESTS,
          patches_per_request=BATCH, blocks=BLOCKS, features=FEATURES, dtype="float32",
          sigma=SIGMA, steps=steps, latency_s=served32["latencies"],
          resblock_launches=served32["resblock_launches"],
          posterior_step_launches=served32["step_launches"],
          profiled_latency_s=served32["profiled_s"], device_busy_ms=served32["busy_ms"],
          idle_share_of_wall=served32["idle_share_of_wall"], card=card)
    del service

    r32, r16 = resblock[torch.float32], resblock[torch.bfloat16]
    kernels = [
        {"name": "fused_resblock", "route": "cuda",
         "source": "hicdiff_tpu_torch/csrc/resblock.cu",
         "replaces": "hicdiff_tpu/kernels/resblock.py:101",
         "launches": resblock_launches, "max_abs_err": r16["err"], "ms": r16["ms"],
         "plain_ms": r16["plain_ms"], "bound_ms": r16["bound_ms"],
         "bound_by": r16["bound_by"], "library_ms": r16["library_ms"], "dtype": "bfloat16",
         "device_ms": r16["device_ms"], "max_abs_err_fp32": r32["err"], "ms_fp32": r32["ms"],
         "plain_ms_fp32": r32["plain_ms"], "bound_ms_fp32": r32["bound_ms"],
         "library_ms_fp32": r32["library_ms"], "device_ms_fp32": r32["device_ms"],
         "bound_ms_3xtf32": r32["bound_ms_3xtf32"],
         "share_of_bound_3xtf32": r32["share_of_bound_3xtf32"],
         "launches_fp32": served32["resblock_launches"]},
        {"name": "fused_posterior_step", "route": "cuda",
         "source": "hicdiff_tpu_torch/csrc/sample_step.cu",
         "replaces": "hicdiff_tpu/kernels/sample_step.py:65",
         "launches": step_launches, "max_abs_err": step_err, "ms": step_ms,
         "plain_ms": step_plain_ms, "bound_ms": step_bound, "bound_by": step_bound_by,
         "library_ms": None, "device_ms": step_dev_ms, "floor_device_ms": floor_dev_ms,
         "host_us": post_host_us, "launches_fp32": served32["step_launches"]},
    ]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
