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
Last, the phase `inference_cli` drives the port's `-u 0` CLI
(`inference_torch.Inference`) on a synthetic Human cell whose contact lists
it writes as text: the data module prepares the caches,
seeded random weights go through the port's checkpoint writer and reader,
and the full-width fp32 model denoises the test split (120 patches in two
batches of 64), timed with the harness's phase split, with the quartet, the
metrics and the launch counters checked; then a deterministic DDIM run is
held to the plain path on the CPU on its first 8 patches and 8 more spread
over both batches. Both kernels are also held to their plain versions at the
CLI's batch of 64 (phases 2 and 3).

Training (fp32, `-u 0`): phase `fused_resblock_backward` holds the block's
backward on the card (the dgrad modes 4 and 5 of the conv kernel, the
weight gradient and the channel sums of csrc/resblock_bwd.cu) to the plain
twin at (8,64,64,256), (2,10,13,256) and the train phase's batches of 64
and 18 at (64,64,256), and times each kernel beside its
plain version, its library yardstick (cuDNN transposed convs, cuDNN's
weight gradient; the whole backward against autograd through the plain
forward) and its bound. Phase `train` runs `train_torch.py`'s entry class
for one epoch of the full-width model at batch 64 on a synthetic cell
written as text (three full batches and a ragged one), checks by the launch
counters that every block's forward and backward went through the kernels,
splits each step's time into loss, backward and update by CUDA events,
reads the peak device memory and the checkpoints, and denoises the test
split from the final checkpoint with the port's inference (DDIM, 2 steps). Phase `train_step_vs_plain`
holds two full-width steps on the card to the same steps on the CPU (batch
2): both losses, every gradient of the second step, each weight's update,
and the conv packs the second step read.

The -u 1 path (DDRM restoration with the unconditional backbone, whose
blocks run the same forward kernel; the posterior step is not on it):
phase `ddrm_operators` builds all nine operator classes at 64x64 on the
card and on the CPU and holds every map to the CPU's within 1e-5 (and the
FWHT's matmul form to its butterfly); `ddrm_chain_vs_plain` runs a
zero-noise chain of the full-width backbone at batch 2 on the card and on
the CPU (deno truncated at t* = 27, inp_mask with 10 steps) within 1e-3;
`inference_cli_ddrm` drives the -u 1 CLI over the 120-patch cell in fp32
(deno --t-start auto, inp_mask --sampling-steps 10) with the quartet,
metrics and launch counters; `serve_ddrm` serves 2+1
requests from ddrm services in fp32 and bf16, then an inp_mask service
answers a (8, 2048) measurement request and refuses a (8, 4096) one;
`train_uncond` trains `train_torch.py -u 1` for one epoch and restores the
test split with the -u 1 CLI from the checkpoint it finds by its tag.

The diffusion-backbone zoo (`models/zoo.py`: the att and sr3 variants, whose
blocks run the same conv kernel, the sr3 block with scale 0, and the
U-Nets, plain PyTorch): `zoo_forward` holds each backbone's full-width
forward on the card to the same weights' plain forward on the CPU (fp32,
and bf16 for hicedrn_sr3), counts its conv-kernel launches and times it at
batch 8 and 64; `inference_cli_zoo` drives `inference_torch.py --model`
over the 120-patch cell from checkpoints the port's codec writes under
pretrain.py's tags (-u 0 hicedrn_sr3: the sr3 engine's ancestral chain,
one posterior step a forward; -u 0 unet; -u 1 hicedrn_att through DDRM),
each chain cut to ZOO_CLI_FORWARDS forwards, and holds a DDIM sr3 run to
the CPU on 16 patches;
`pretrain_zoo` runs `pretrain_torch.py` for one epoch three times (sr3,
uncond on pure_noise data, cond) with step splits and peak memory; and
`zoo_step_vs_plain` takes two sr3 and two att steps card against CPU.

bf16 training (the bf16 conv kernel's training modes 3-5, the bf16 weight
gradient and channel sums, and the modes 6 and 7 that carry the bf16 att
variant's fp32 residual stream): phase `fused_resblock_backward` holds the
bf16 block's forward and backward (FusedResblockFn) to the plain twin in the
same dtype flow at the main, ragged and train shapes, and on the fp32 stream,
then each bf16 kernel to its plain version on the same bf16 inputs (mode 3's
z and h, the dgrad's dx, dz and du, modes 6 and 7 at the bf16 forward bar;
the wgrad and the channel sums within 1e-3 of their largest value), and
times each beside its bf16 bound and library call; the bf16 wgrad alone
also where its thread-block clusters differ (C = 128 and 384, a ragged W,
batch 64: within 1e-3, bit-equal twice), timed at batch 64 beside cuDNN's.
The bf16 training forward (mode 3, then 2) is timed the same way beside its
bound and cuDNN's pair that also keeps z. Phase `conv_modes_bf16` holds the
persistent kernel's modes 3 and 4, and 6 and 7 on the fp32 stream (after
modes 1 and 4), through the C entry, to their plain versions at the bf16
bar at MODES_34_SHAPES (main, ragged, training batches, C = 128, 384, 512,
batch 1, tile counts no multiple of the SM count), each bit-equal over two
calls, then times modes 1-7 alone at batch 8, 64 and 66 with each one's
share of one conv's bound, and modes 3, 4, 6 and 7 beside cuDNN's time for
the same function; the fp32-stream rows of the kernels line carry mode 6's
or 7's batch-64 row. The train phases check by the
wrappers' per-mode counts that each step launches modes 3 and 4 once a
block. `train_bf16` and
`train_uncond_bf16` run train_torch.py --bf16 for an epoch (launch counters,
step split, peak memory); `train_step_vs_plain` and
`zoo_step_vs_plain` in bf16 hold two steps of base, sr3 and att card against
CPU (losses within 1e-2 relative; each gradient no farther from the CPU's
bf16 gradient, or from its fp32 one, than those two lie from each other,
and all gradients together no farther from the CPU's bf16 ones than
those lie from the fp32 ones); `pretrain_zoo` runs
sr3, att and unet with --bf16; `zoo_forward` holds bf16 hicedrn_att to the
CPU; and the -u 0 and -u 1 CLI phases repeat their default run with --bf16.

The reference's weight format: phase `reference_weights` exports the
inference_cli phase's full-width checkpoint with
tools/torch_export_checkpoint.py --diffusion-prefix, converts it back with
tools/torch_convert_checkpoint.py, and runs the -u 0 bf16 CLI on the result:
its quartet equals the bf16 run's, byte for byte, with the same launches.

The baselines (plain PyTorch: the JAX package runs them through no Pallas
kernel, so no port kernel may launch): `baselines_forward` holds each of
the six table baselines, hiedsrgan's generator, the three critics and the
perceptual VGG19, at their published sizes, to the CPU within 1e-3 of its
largest value at batch 8 and times it at batch 64; on one synthetic cell
(210 train patches, 12 val, the 120 test patches), `pretrain_baselines` runs
pretrain_baselines_torch.py for one epoch of the six, then of hiedsrgan at
32 blocks (step ms by CUDA events, epoch s, peak memory),
`baseline_step_vs_plain` takes one step of each on card and CPU from the
same weights (losses 1e-4 relative, BatchNorm statistics 1e-5), and
`stard_metric_normal` scores the six checkpoints over the test split with
sample/stard_metric_normal_torch.py.

The analysis tail (phase 13; no Pallas kernel is on the 3D path, the JAX
package's stress fit being plain jnp): `threed_comp` runs
threed_comp_torch.py on the card over the inference_cli phase's quartet
(120 patches x 3 sources) at the published defaults (every block, --num 3,
--max-iter 2000): block and PDB counts, the TM table, TM means in [0, 1],
each source's fit time; the target's fit profiled at 100 and 200
iterations for launches, device and host time an iteration and the idle
share; four blocks' fits on the card held to the CPU's from the same start
(after 100 iterations and after 2000) and to the run's PDBs; the helix of
tests/test_reconstruct.py recovered on the card. `threed_comp_baselines`
runs its --baselines mode on a synthetic cell of the same size (eight
sources). `insulation` holds the insulation vectors, InsulationLoss and
computeInsulation on the card to the CPU. `stard_metric_cond` and
`stard_metric_diff` run the two metric scripts at full width in fp32 with their
chain cut to --timestep 20, with the launch counters checked.

Phase 14, `fullscale_fixture`: the full-scale quality protocols' tools at
reduced bins. tools/torch_make_fullscale_fixture.py (seed 7, band 257, 22
chromosomes of 512 bins) writes the contact lists, latents and weights;
the bf16 -u 0 CLI runs `--sampling-steps 1` on a seeded full-width
checkpoint over the 120 test patches (one conv pair a block a batch, no
posterior step), and the bf16 -u 1 CLI (`--schedule linear --t-start
auto`, DDRM deno at t*=27) on a seeded full-width unconditional checkpoint
at the linear schedule (28 forwards a batch, no posterior step);
tools/torch_latent_target.py builds each run's `latent.npy` (the target's
shape, correlation with it above 0.9) and tools/torch_quartet_metrics.py
scores prediction, identity and realized target against it (every metric
finite). Phase 15, `engine_options`: on a full-width hicedrn of 2 blocks at batch 8, each objective (pred_noise l2,
pred_x0 and pred_v l1, p2 gamma 0.5) holds its loss (1e-5 relative) and
gradients (BWD_TOL) to the CPU, a truncated DDIM chain with the x0 clip
off returns every state (1e-4 of the largest), and the 30-step ancestral
chain launches the posterior step once a step under pred_noise and never
under pred_x0 or pred_v; then Unet1D, VAEModel and a learned-embedding Unet
forward on the card within 1e-3 of the CPU's largest value, with no port
kernel launched. Phase 16 (`data_parallel`, `distill`, `serve_concurrency`)
trains and samples over two ranks sharing the card, distills, and serves
two clients at once. Phase 17, `data_parallel_sampling`: the bf16 -u 0 and
fp32 -u 1 CLIs (10 DDRM forwards) as two rank processes on the card (gloo)
against one rank, within DP_TOL, every rank's launches counted; a bf16
daemon of two ranks (rank 0 on the socket) against one, latency and idle
share (each rank process profiles its daemon), shutdown ending both. Phase
18, `mcool`:
the full-scale cell (72,031 bins) written and read back through the port's
HDF5 module, every chromosome fetched and timed; stage 1 from an .mcool
byte-equal to the fixture tool's text; `denoise_mcool` and
`--export-mcool` files read back equal to what they were made from.

Times: `ms`, `plain_ms` and `library_ms` are CUDA-event times of back-to-back
calls (device time plus any gaps where the device waits for the host);
`device_ms` and its kin are the summed device durations from torch.profiler.
Each event time is the median of three runs after three warm-up calls, and
each run enqueues one call before its start event, so that the host's
enqueue of the first timed call is not in it. The backward rows add
`timeline` (the profiled calls' event time, the lead from the start event
to the first launch, and each launch's device time and the idle gap before
it), `host_us`, the host's enqueue time of one call, and the SM clock's
range, the largest power draw and the share of readings under the power
cap, read by nvidia-smi beside the row's loops.
Bounds: the fp32 conv keeps `bound_ms` (as `bound_ms_fp32` in the kernels
line), its FLOPs at the 67 TFLOP/s of CUDA-core FMAs, and adds
`bound_ms_3xtf32`, three times its FLOPs at the 495 TFLOP/s of TF32 on the
tensor cores: the kernel runs each product as three TF32 products there, so
that is the least time its design could take, and its share of bound is read
against it. The backward's fp32 dgrad and wgrad rows take that 3xTF32
figure as `bound_ms` and keep the FMA one as `bound_ms_fma`: cuDNN's fp32
weight gradient beats the FMA figure. The posterior step moves less than a
launch takes, so its phase prints `floor_device_ms`, the device time of a
launch that does almost nothing (a 1-element fill), beside its own device
time.
Each phase prints one line with its wall time; the first failure ends the run
with a non-zero exit. Without CUDA it fails before printing any result.
The last line is {"ok": true, "device": {...}}.
"""
import contextlib
import copy
import dataclasses
import gc
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
DDRM_REQUESTS = 2  # each ddrm service: 2 requests and a profiled one
# the inference_cli phase's synthetic cell: the test split's four chromosomes
# give 30 band patches each at 512 bins, about two batches of the CLI's 64
CLI_TEST_CHROMS, CLI_TEST_BINS, CLI_OTHER_BINS, CLI_BAND, CLI_BATCH = (2, 6, 10, 12), 512, 64, 64, 64
CLI_RESBLOCK_SHAPE = (CLI_BATCH, 64, 64, 256)  # one CLI batch at full width, fp32
CLI_STEP_SHAPE = (CLI_BATCH, 64, 64, 1)        # the chain state of one CLI batch
CLI_COMPARED = 16  # patches of the deterministic CLI run held to the CPU plain path
# the train phase: full width, batch 64, on a synthetic cell of the single-cell
# module (its _p99.99 cache). 14 train chromosomes of 320 bins give 15 band
# patches each, 210 in all: three full batches and a ragged one of 18; the 4 val
# chromosomes of 128 bins give 12 patches, the 4 test ones of 64 bins one each
TRAIN_BINS, TRAIN_BATCH = {"train": 320, "val": 128, "test": 64}, 64
TRAIN_RESBLOCK_SHAPES = ((TRAIN_BATCH, 64, 64, 256), (18, 64, 64, 256))  # its full and ragged batch
STEP_VS_PLAIN_BATCH = 2  # the plain path runs this step on the host's CPU
BWD_TOL = 1e-4  # backward kernels vs the plain twin, of each gradient's largest value
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 and TF32 on the tensor
# cores, fp32 outside them, and the HBM3 rate
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12, "tf32": 495e12}
HBM_BYTES_PER_S = 3.35e12
CONV_KERNELS = ("conv3x3_bf16_kernel", "conv3x3_bf16_persistent_kernel", "conv3x3_3xtf32_kernel")
FULLSCALE_BINS, FULLSCALE_BAND = 512, 257  # the fullscale_fixture phase: 22 chromosomes of 512 bins
ENGINE_BLOCKS, ENGINE_BATCH = 2, 8          # engine_options: a full-width hicedrn of 2 blocks
ZOO_CLI_FORWARDS = 10  # inference_cli_zoo's three --model chains, cut to this depth


def phase(name, t0, **fields):
    print(json.dumps({"phase": name, "wall_s": round(time.time() - t0, 3), **fields}),
          flush=True)


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def cuda_ms(fn, iters=20, reps=3, warmup=3):
    """Time of fn() by CUDA events: the median over `reps` runs of the mean
    time of `iters` back-to-back calls, after `warmup` warm-up calls. Each run
    enqueues one more call before its start event, so that the host prepares
    the first timed call while the device works: else that call's enqueue
    time lies between the start event and its first launch. What is left is
    device time plus any gaps where the device waits for the host."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        fn()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end) / iters)
    return sorted(runs)[reps // 2]


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


def library_resblock(x, w_oihw, bias, scale, shift, residual=None):
    """The yardstick: two cuDNN convs on channels_last views in x's dtype with
    the eager epilogue; with `residual`, the fp32 stream that the branch is
    added to in fp32. Timed here only; the port never calls it."""
    xc = x.permute(0, 3, 1, 2)
    h = F.conv2d(xc, w_oihw, bias, padding=1)
    h = F.silu(h * (scale[:, :, None, None] + 1) + shift[:, :, None, None])
    out = F.conv2d(h, w_oihw, bias, padding=1) * 0.1
    out = out + xc if residual is None else out.float() + residual.permute(0, 3, 1, 2)
    return out.permute(0, 2, 3, 1)


def library_train_forward(x, w_oihw, bias, scale, shift):
    """The training forward's yardstick: library_resblock that also returns
    z = conv(x) + bias and h. Timed here only; the port never calls it."""
    z, h = library_mode3(x, w_oihw, bias, scale, shift)
    out = F.conv2d(h.permute(0, 3, 1, 2), w_oihw, bias, padding=1) * 0.1 + x.permute(0, 3, 1, 2)
    return out.permute(0, 2, 3, 1), z, h


def device_ops(prof):
    """(name, start us, duration us) of every device activity in a profile."""
    from torch.autograd import DeviceType

    return [(e.name, e.time_range.start, e.time_range.elapsed_us())
            for e in prof.events() if e.device_type == DeviceType.CUDA]


def device_breakdown(ops):
    """From a profile's device activities: busy us, span us, the port's
    kernels' launches and device ms, and the eight largest items by device
    time with their share of busy time."""
    check(ops, "the profiler saw no device activity")
    busy_us = sum(d for _, _, d in ops)
    span_us = max(s + d for _, s, d in ops) - min(s for _, s, d in ops)
    by_name = defaultdict(lambda: [0, 0.0])
    for name, _, d in ops:
        by_name[name][0] += 1
        by_name[name][1] += d
    ours = {}  # the port's kernels, device time only
    for key in (*CONV_KERNELS, "posterior_step_kernel"):
        hits = [(k, t) for n, (k, t) in by_name.items() if key in n]
        ours[key] = {"launches": sum(k for k, _ in hits), "ms": sum(t for _, t in hits) / 1e3}
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    return busy_us, span_us, ours, [
        {"name": n[:90], "launches": k, "ms": t / 1e3, "share": t / busy_us} for n, (k, t) in top]


@contextlib.contextmanager
def timed_run(out):
    """Time the CLI run in the block to the end of its device work:
    out["wall_s"] is its wall."""
    tr = time.time()
    yield out
    torch.cuda.synchronize()
    out["wall_s"] = time.time() - tr


def profiled_ms(fn, iters=20, reps=1, timeline=False):
    """Device time of fn() after a warm-up: the summed durations of the device
    work of `iters` calls, from torch.profiler, over `iters`; the median of
    `reps` such loops. Unlike cuda_ms it leaves out the gaps where the device
    waits for the host, which bound a call that launches little work.

    With timeline=True, returns (ms, timeline), which lays each loop's calls
    out on the device: per loop, its `device_ms`, its `event_ms` by CUDA
    events around it, started from an idle device (cuda_ms's loop without
    its lead-in call), and its `lead_ms`, from the start event to the first
    launch, which is the host's enqueue of the first call; and for each
    launch of a call in order, its mean duration `ms` and the mean idle
    `gap_ms` before it (for the first launch, after the call before). None
    where the profiler dropped records. A loop in which the profiler
    recorded no device activity at all is profiled again, up to three
    times: the profiler drops a whole loop's records now and then."""
    fn()
    torch.cuda.synchronize()
    loops = []
    for _ in range(reps):
        for _attempt in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                start.record()
                for _ in range(iters):
                    fn()
                end.record()
                torch.cuda.synchronize()
            ops = sorted(device_ops(prof), key=lambda op: op[1])
            if ops:
                break
        check(ops, "the profiler saw no device activity")
        loops.append((start.elapsed_time(end), ops))
    device = [sum(d for _, _, d in ops) / 1e3 / iters for _, ops in loops]
    ms = sorted(device)[reps // 2]
    if not timeline:
        return ms
    per_call = len(loops[0][1]) // iters
    if any(len(ops) != per_call * iters for _, ops in loops):
        return ms, None
    line = {"device_ms": device, "event_ms": [], "lead_ms": [],
            "launches": [{"name": loops[0][1][k][0][:40], "ms": 0.0, "gap_ms": 0.0}
                         for k in range(per_call)]}
    for event_ms, ops in loops:
        line["event_ms"].append(event_ms / iters)
        line["lead_ms"].append(event_ms - (ops[-1][1] + ops[-1][2] - ops[0][1]) / 1e3)
        gaps = [0.0] + [s - (ops[i][1] + ops[i][2]) for i, (_, s, _) in enumerate(ops[1:])]
        for k, launch in enumerate(line["launches"]):
            launch["ms"] += sum(d for _, _, d in ops[k::per_call]) / 1e3 / iters / reps
            launch["gap_ms"] += (sum(gaps[k or per_call::per_call]) / 1e3
                                 / (iters - (k == 0)) / reps)
    return ms, line


POWER_CAP_REASON = 0x4  # nvidia-smi's clocks_event_reasons bit: software power cap


@contextlib.contextmanager
def card_clocks(into):
    """Reads the card's SM clock (MHz), power draw (W) and clock event reasons
    by nvidia-smi every 10 ms while the block runs; on leaving, stops
    nvidia-smi and puts into `into` the clock's least and largest reading,
    the largest draw and the share of readings with the power cap active."""
    with tempfile.TemporaryFile(mode="w+") as out:
        proc = subprocess.Popen(
            ["nvidia-smi", "-i", "0", "--format=csv,noheader,nounits", "-lms", "10",
             "--query-gpu=clocks.sm,power.draw,clocks_event_reasons.active"],
            stdout=out, stderr=subprocess.DEVNULL, text=True)
        try:
            time.sleep(0.3)  # its first reading
            yield
        finally:
            proc.terminate()
            proc.wait(timeout=30)
        out.seek(0)
        readings = []
        for line in out:
            try:
                clock, power, reasons = (f.strip() for f in line.split(","))
                readings.append((float(clock), float(power), int(reasons, 16)))
            except ValueError:
                continue
    if readings:
        into.update(sm_clock_mhz=[min(r[0] for r in readings), max(r[0] for r in readings)],
                    power_w_max=max(r[1] for r in readings),
                    power_capped_share=sum(bool(r[2] & POWER_CAP_REASON) for r in readings)
                    / len(readings))
    else:
        into.update(sm_clock_mhz=None)


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
    shut the server down. A cond service runs the truncated ancestral chain
    (a posterior-step launch a step, outputs in [-1, 1]); a ddrm service the
    DDRM chain (no posterior step), its deno measurements image-shaped.
    Returns what was measured."""
    from hicdiff_tpu_torch.kernels.resblock import fused_resblock
    from hicdiff_tpu_torch.kernels.sample_step import fused_posterior_step
    from hicdiff_tpu_torch.serve import request, serve_forever

    ddrm = service.mode == "ddrm"
    steps = service.restorer.forwards if ddrm else service.t_start + 1
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
        check(ping.get("ok") and ping["t_start"] == service.t_start
              and ping["mode"] == service.mode, f"ping: {ping}")
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
            # the cond chain's last step (t = 0) returns the clipped x0
            check(ddrm or np.abs(out).max() <= 1.0,
                  f"{dtype} request {i}: output outside [-1, 1]")
            latencies.append(latency)
            phase("denoise_request", tr, mode=service.mode, request=i, dtype=dtype,
                  patches=BATCH, steps=steps, latency_s=latency, patches_per_s=BATCH / latency,
                  card=card)
        resblock_launches = fused_resblock.launches
        step_launches = fused_posterior_step.launches
        want_resblock = requests * steps * BLOCKS * 2  # two launches per block
        want_step = 0 if ddrm else requests * steps
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
        busy_us, span_us, ours, top = device_breakdown(ops)
        idle_wall = 1 - busy_us / 1e3 / (profiled_s * 1e3)
        phase("profile", tr, mode=service.mode, request=requests + 1, dtype=dtype,
              latency_s=profiled_s, device_busy_ms=busy_us / 1e3, device_span_ms=span_us / 1e3,
              idle_share_of_wall=idle_wall, idle_share_of_span=1 - busy_us / span_us,
              kernels=ours, top=top, card=card)
        bye = request(sock, {"id": requests + 2, "op": "shutdown"})
        check(bye.get("ok"), f"shutdown: {bye}")
        server.join(timeout=30)
        check(not server.is_alive(), "server thread did not stop")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return dict(latencies=latencies, resblock_launches=resblock_launches,
                step_launches=step_launches, profiled_s=profiled_s, busy_ms=busy_us / 1e3,
                idle_share_of_wall=idle_wall, kernels=ours, steps=steps)


def write_synthetic_cell(root, bins, marker="", seed=0, deg="deno"):
    """The contact lists of a synthetic Human cell 1 at sigma 0.1, as the data
    module writes them from an .mcool: Constraints/chrom_{i}_{40000,count}.txt
    for 22 chromosomes, chromosome c with bins(c) bins, in the cache
    directory of degradation `deg` whose name ends in `marker` (the data
    module's percentile marker). Each holds a band of Poisson counts
    CLI_BAND bins wide on the diagonal, balanced by weights in [0.5, 1.5]."""
    from hicdiff_tpu_torch.data.fastio import save_coo_txt

    d = os.path.join(root, "DataFull", f"DataFull_Human_cell1_40000_{deg}_{SIGMA}{marker}",
                     "Constraints")
    os.makedirs(d)
    rng = np.random.default_rng(seed)
    for c in range(1, 23):
        n = bins(c)
        i, j = np.triu_indices(n)
        near = (j - i) < CLI_BAND
        i, j = i[near], j[near]
        counts = rng.poisson(np.maximum(40.0 - 0.6 * (j - i), 1.0))
        counts[i == j] = np.maximum(counts[i == j], 1)  # no bin is dropped
        nz = counts > 0
        w = rng.uniform(0.5, 1.5, n)
        start1, start2 = i[nz] * 40000.0, j[nz] * 40000.0
        save_coo_txt(os.path.join(d, f"chrom_{c}_40000.txt"),
                     np.stack([start1, start2, counts[nz] * w[i[nz]] * w[j[nz]]], axis=1))
        save_coo_txt(os.path.join(d, f"chrom_{c}_count.txt"),
                     np.stack([start1, start2, counts[nz]], axis=1), int_value=True)


def cli_bf16_run(phase_name, run, dev, card, kw, want_launches):
    """The CLI run of `kw` again with --bf16 (`inference_torch.Inference(bf16=
    True)`): launch counters (`want_launches`, those of the fp32 run: the
    same kernels a step), the quartet's prediction finite, the metrics,
    wall time and patches/s with the harness's split. Returns the run's
    result."""
    import inference_torch
    from hicdiff_tpu_torch.kernels.resblock import fused_resblock
    from hicdiff_tpu_torch.kernels.sample_step import fused_posterior_step

    fused_resblock.launches = 0
    fused_posterior_step.launches = 0
    tr = time.time()
    with timed_run({}) as run_p:
        res = inference_torch.Inference(device=dev, bf16=True, out_tag="_bf16", **kw)
    wall_s = run_p["wall_s"]
    launches = dict(resblock_launches=fused_resblock.launches,
                    step_launches=fused_posterior_step.launches)
    check(launches == want_launches, f"{phase_name} {run} bf16 launches {launches} != "
                                     f"{want_launches}")
    pred = np.load(os.path.join(res["outdir"], "predict.npy"))
    n = len(res["inds"])
    check(pred.shape == (n, 1, 64, 64) and np.isfinite(pred).all(),
          f"{phase_name} {run} bf16: predict {pred.shape} not finite")
    metrics = res["metrics"]
    check(len(metrics) == 7 and all(np.isfinite(v) for v in metrics.values()),
          f"{phase_name} {run} bf16 metrics: {metrics}")
    tm = res["timing"]
    phase(phase_name, tr, run=f"{run}_bf16", dtype="bfloat16", sigma=SIGMA, blocks=BLOCKS,
          features=FEATURES, batch=CLI_BATCH, patches=n, run_wall_s=wall_s,
          patches_per_s=n / wall_s, setup_s=tm["setup"], dispatch_s=tm["dispatch"],
          fetch_s=tm["fetch"], metrics_s=tm["metrics"], save_s=tm["save"], **launches,
          metrics=metrics, predict_abs_max=float(np.abs(pred).max()), card=card)
    return res


def inference_cli(dev, card):
    """Drive the port's -u 0 CLI (`inference_torch.Inference`) on the card:
    data prepared from text, seeded random weights written with the port's
    checkpoint writer and read back through `weights`, the full-width model
    in fp32 (the CLI's default) over the test split, then a deterministic
    DDIM run held to the plain path on the CPU. Returns the launch counts of
    the default run."""
    import inference_torch
    from hicdiff_tpu_torch.convert import params_from_jax, params_to_jax
    from hicdiff_tpu_torch.diffusion.gaussian import GaussianDiffusion
    from hicdiff_tpu_torch.kernels.resblock import fused_resblock
    from hicdiff_tpu_torch.kernels.sample_step import fused_posterior_step
    from hicdiff_tpu_torch.models.hicedrn import HicedrnDiff
    from hicdiff_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint

    t0 = time.time()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="smoke_cli_", dir=os.path.join(ROOT, "build"))
    try:
        write_synthetic_cell(
            root, lambda c: CLI_TEST_BINS if c in CLI_TEST_CHROMS else CLI_OTHER_BINS)
        model = HicedrnDiff(self_condition=True, number_resnet=BLOCKS, features=FEATURES,
                            device="cpu", generator=torch.Generator().manual_seed(2))
        ckpt = os.path.join(root, "Model_Weights", "random.msgpack")
        save_checkpoint(ckpt, params_to_jax(model.state_dict()), run_config=dict(
            sigma=SIGMA, schedule="sigmoid", mode="cond", timestep=1000, percentile=99.0))
        del model
        prep_s = time.time() - t0
        kw = dict(batch_size=CLI_BATCH, cellNo=1, cell_Line="Human", sigma_t=SIGMA,
                  condition=False, root=root, schedule="sigmoid", timestep=1000,
                  weights=ckpt, t_start="auto", blocks=BLOCKS, features=FEATURES)

        # run 1: the CLI's default path, fp32 ancestral chain, counted and timed
        os.environ["HICDIFF_EVAL_TIMING"] = "1"
        fused_resblock.launches = 0
        fused_posterior_step.launches = 0
        with timed_run({}) as run_p:
            res = inference_torch.Inference(device=dev, **kw)
        wall_s = run_p["wall_s"]
        resblock_launches, step_launches = fused_resblock.launches, fused_posterior_step.launches
        n = len(res["inds"])
        batches = -(-n // CLI_BATCH)
        steps = 30  # t* = 29 at sigma 0.1 on the sigmoid T=1000 schedule (phase 5)
        check(n == len(CLI_TEST_CHROMS) * 30, f"inference_cli: {n} test patches")
        check(resblock_launches == batches * steps * BLOCKS * 2,
              f"inference_cli resblock launches {resblock_launches} != {batches * steps * BLOCKS * 2}")
        check(step_launches == batches * steps,
              f"inference_cli posterior-step launches {step_launches} != {batches * steps}")
        for what in ("target", "noisy", "predict", "inds"):
            check(os.path.exists(os.path.join(res["outdir"], f"{what}.npy")),
                  f"inference_cli: no {what}.npy")
        pred = np.load(os.path.join(res["outdir"], "predict.npy"))
        check(pred.shape == (n, 1, 64, 64), f"inference_cli: predict shape {pred.shape}")
        check(np.isfinite(pred).all() and np.abs(pred).max() <= 1.0,
              "inference_cli: predict not finite or outside [-1, 1]")
        metrics = res["metrics"]
        check(len(metrics) == 7 and all(np.isfinite(v) for v in metrics.values()),
              f"inference_cli metrics: {metrics}")
        tm = res["timing"]
        phase("inference_cli", t0, run="default", dtype="float32", sigma=SIGMA, steps=steps,
              blocks=BLOCKS, features=FEATURES, batch=CLI_BATCH, patches=n, batches=batches,
              cut=f"data scale only: {len(CLI_TEST_CHROMS)} test chromosomes of "
                  f"{CLI_TEST_BINS} bins (hg19's have 3,300-6,100 at 40 kb), the rest "
                  f"{CLI_OTHER_BINS}; the model runs at full width and depth",
              prep_s=prep_s, run_wall_s=wall_s, patches_per_s=n / wall_s,
              setup_s=tm["setup"], dispatch_s=tm["dispatch"], fetch_s=tm["fetch"],
              metrics_s=tm["metrics"], save_s=tm["save"],
              fetch_s_per_batch=tm["fetch_per_batch"],
              metrics_s_per_batch=tm["metrics_per_batch"],
              resblock_launches=resblock_launches, posterior_step_launches=step_launches,
              metrics=metrics, card=card)

        # run 2: deterministic (DDIM, eta 0), held to the plain path on the CPU on
        # the first 8 patches and 8 more spread over both batches' M-tiles
        tr = time.time()
        res2 = inference_torch.Inference(device=dev, sampling_steps=2, out_tag="_ddim2", **kw)
        picked = np.r_[np.arange(8), np.linspace(8, n - 1, CLI_COMPARED - 8).round().astype(int)]
        got = np.load(os.path.join(res2["outdir"], "predict.npy"))[picked]
        noisy = np.load(os.path.join(res2["outdir"], "noisy.npy"))[picked]
        card_s = time.time() - tr
        cpu = HicedrnDiff(self_condition=True, number_resnet=BLOCKS, features=FEATURES,
                          device="cpu")
        cpu.load_state_dict(params_from_jax(load_checkpoint(ckpt, only={"params"})["params"]))
        cpu.eval()
        engine = GaussianDiffusion.create(cpu, device="cpu", timesteps=1000,
                                          beta_schedule="sigmoid", sampling_timesteps=2)
        engine = dataclasses.replace(engine, t_start=engine.truncation_timestep(SIGMA))
        tc = time.time()
        want = engine.super_resolution(torch.from_numpy(noisy.transpose(0, 2, 3, 1)),
                                       torch.Generator().manual_seed(0))
        cpu_s = time.time() - tc
        err = float(np.abs(got - want.numpy().transpose(0, 3, 1, 2)).max())
        check(err <= 1e-3, f"inference_cli deterministic run: max-abs {err} > 1e-3")
        phase("inference_cli", tr, run="ddim2_deterministic", patches=len(res2["inds"]),
              card_run_s=card_s, compared_patches=picked.tolist(), max_abs_err=err, tol=1e-3,
              plain_path_cpu_s=cpu_s, card=card)

        # the default run's quartet, which phase 13 reconstructs in 3D
        quartet = {what: np.load(os.path.join(res["outdir"], f"{what}.npy"))
                   for what in ("target", "noisy", "predict", "inds")}
        quartet_name = os.path.basename(res["outdir"])

        # run 3: the default run with --bf16
        want = dict(resblock_launches=resblock_launches, step_launches=step_launches)
        res_bf16 = cli_bf16_run("inference_cli", "default", dev, card, kw, want)

        # the same weights through the reference's .pytorch format and back
        refw = reference_weights(dev, card, root, ckpt, kw, res_bf16, want)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return dict(resblock_launches=resblock_launches, step_launches=step_launches,
                refw_resblock_launches=refw["resblock_launches"],
                refw_step_launches=refw["step_launches"], quartet=quartet,
                quartet_name=quartet_name)


def reference_weights(dev, card, root, ckpt, kw, res_bf16, want_launches):
    """Phase `reference_weights`: the inference_cli phase's full-width
    checkpoint exported by tools/torch_export_checkpoint.py
    --diffusion-prefix (the reference's GaussianDiffusion state-dict
    layout), converted back by tools/torch_convert_checkpoint.py (params
    bit-equal to the original), then the -u 0 bf16 CLI on the converted file
    with the same seed: its Outputs quartet must equal the bf16 run's
    byte for byte (same weights, seeds and kernels), and the launch counters
    show both kernels ran as there. Returns the launch counts."""
    import inference_torch
    from hicdiff_tpu_torch.kernels.resblock import fused_resblock
    from hicdiff_tpu_torch.kernels.sample_step import fused_posterior_step
    from hicdiff_tpu_torch.train.checkpoint import load_checkpoint
    from tools import torch_convert_checkpoint, torch_export_checkpoint

    t0 = time.time()
    exported = os.path.join(root, "Model_Weights", "reference.pytorch")
    back = os.path.join(root, "Model_Weights", "from_reference.msgpack")
    torch_export_checkpoint.main([ckpt, "--out", exported, "--diffusion-prefix"])
    export_s = time.time() - t0
    tc = time.time()
    torch_convert_checkpoint.main([exported, "--out", back])
    convert_s = time.time() - tc
    keys = torch.load(exported, map_location="cpu", weights_only=True).keys()
    check(all(k.startswith("model.") for k in keys), "reference_weights: unprefixed keys")
    leaves = []

    def walk(a, b):
        if isinstance(a, dict):
            check(a.keys() == b.keys(), f"reference_weights: keys {sorted(a)} != {sorted(b)}")
            for k in a:
                walk(a[k], b[k])
        else:
            leaves.append(np.array_equal(a, b) and a.dtype == b.dtype)

    walk(load_checkpoint(back, only={"params"})["params"],
         load_checkpoint(ckpt, only={"params"})["params"])
    check(all(leaves), "reference_weights: params changed in the round trip")

    fused_resblock.launches = 0
    fused_posterior_step.launches = 0
    tr = time.time()
    res = inference_torch.Inference(device=dev, bf16=True, out_tag="_bf16_refw",
                                    **{**kw, "weights": back})
    torch.cuda.synchronize()
    run_s = time.time() - tr
    launches = dict(resblock_launches=fused_resblock.launches,
                    step_launches=fused_posterior_step.launches)
    check(launches == want_launches,
          f"reference_weights launches {launches} != the bf16 run's {want_launches}")
    equal = {}
    for what in ("target", "noisy", "predict", "inds"):
        a = np.load(os.path.join(res["outdir"], f"{what}.npy"))
        b = np.load(os.path.join(res_bf16["outdir"], f"{what}.npy"))
        equal[what] = bool(a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b))
    check(all(equal.values()), f"reference_weights: quartet differs from the bf16 run {equal}")
    phase("reference_weights", t0, export_s=export_s, convert_s=convert_s,
          pytorch_bytes=os.path.getsize(exported), keys=len(keys), run_wall_s=run_s,
          patches=len(res["inds"]), quartet_bit_equal=equal, **launches, card=card)
    return launches


def library_dgrad(gy, z, w_oihw, scale, shift, stream=None):
    """The dgrad yardstick: two cuDNN transposed convs on channels_last views
    with the eager epilogue; with `stream`, the fp32 g added in fp32. Timed
    here only; the port never calls it."""
    gc, zc = gy.permute(0, 3, 1, 2), z.permute(0, 3, 1, 2)
    sc, sh = scale[:, :, None, None], shift[:, :, None, None]
    u = zc * (sc + 1) + sh
    s = torch.sigmoid(u)
    dz = F.conv_transpose2d(gc, w_oihw, padding=1) * 0.1 * (s * (1 + u * (1 - s))) * (sc + 1)
    dx = F.conv_transpose2d(dz, w_oihw, padding=1)
    dx = dx + gc if stream is None else dx.float() + stream.permute(0, 3, 1, 2)
    return dx.permute(0, 2, 3, 1)


def library_wgrad(x, dz, h, gy):
    """The wgrad yardstick: cuDNN's weight gradient of both uses of the conv."""
    c = x.shape[-1]

    def wgrad(inp, grad):
        return torch.nn.grad.conv2d_weight(inp.permute(0, 3, 1, 2), (c, c, 3, 3),
                                           grad.permute(0, 3, 1, 2), padding=1)

    return wgrad(x, dz) + 0.1 * wgrad(h, gy)


def backward_row(name, t0, card, dtype, kernel_call, plain_call, library_call, nflops, nbytes,
                 err, **extra):
    """One backward kernel at RESBLOCK_SHAPE timed beside its plain version,
    its library yardstick and its bound; prints and returns its row. Beside
    the profiler's device time: the same calls' timeline (where an event
    time above it goes), the host's enqueue of one call and the SM clock the
    power cap left the loops. bf16 products are bounded by the bf16 tensor
    cores; fp32 products by three TF32 products each on the tensor cores, as
    the port's convs run them (cuDNN's fp32 wgrad beats the CUDA-core FMA
    figure, so that one is no bound; it is kept as bound_ms_fma)."""
    clocks = {}
    with card_clocks(clocks):
        ms, plain_ms = cuda_ms(kernel_call, iters=10), cuda_ms(plain_call, iters=10)
        dev_ms, timeline = profiled_ms(kernel_call, iters=10, reps=3, timeline=True)
        plain_dev_ms = profiled_ms(plain_call, iters=10)
        library_ms = cuda_ms(library_call, iters=10) if library_call else None
    fp32 = dtype == torch.float32
    bound, bound_by = bound_ms(3 * nflops if fp32 else nflops, nbytes, "tf32" if fp32 else dtype)
    row = dict(ms=ms, device_ms=dev_ms, timeline=timeline, host_us=host_us(kernel_call),
               plain_ms=plain_ms, plain_device_ms=plain_dev_ms,
               library_ms=library_ms, bound_ms=bound, bound_by=bound_by,
               share_of_bound=bound / ms, max_abs_err=err, **clocks, **extra)
    if nflops and fp32:
        bound_fma, _ = bound_ms(nflops, nbytes, dtype)
        row.update(bound_ms_fma=bound_fma, share_of_bound_fma=bound_fma / ms)
    phase("fused_resblock_backward", t0, kernel=name, shape=RESBLOCK_SHAPE,
          dtype=str(dtype).split(".")[-1], **row, card=card)
    return row


def resblock_backward(dev, card, g):
    """The block's backward on the card against the plain twin at the main
    and a ragged shape, then each backward kernel timed at the main shape
    beside its plain version, its library yardstick and its bound. Returns
    the kernels' rows for the kernels line (without launches)."""
    from hicdiff_tpu_torch.kernels.resblock import (
        FusedResblockFn,
        _dgrad_reference,
        _fused_resblock_cuda,
        fused_resblock_backward_reference,
        fused_resblock_prepared,
        fused_resblock_reference,
        prepare_weight,
        resblock_dgrad,
        transpose_kernel,
    )
    from hicdiff_tpu_torch.kernels.resblock_bwd import (
        resblock_channel_sums,
        resblock_channel_sums_reference,
        resblock_wgrad,
        resblock_wgrad_reference,
    )

    t0 = time.time()
    names = ("dx", "dW", "db", "dscale", "dshift")
    errs = {}
    # the main and a ragged shape, then the train phase's full and ragged batch
    for shape in (RESBLOCK_SHAPE, RAGGED_SHAPES[0], *TRAIN_RESBLOCK_SHAPES):
        x, kernel, bias, te = (t.to(dev) for t in resblock_inputs(shape, g))
        gy = torch.randn(shape, generator=g).to(dev)
        weight = kernel.permute(3, 2, 0, 1).contiguous()
        leaves = [t.clone().requires_grad_() for t in (x, weight, bias, te)]
        y = FusedResblockFn.apply(leaves[0], leaves[1], leaves[2], *leaves[3].chunk(2, dim=-1),
                                  None)
        y.backward(gy)
        scale, shift = te.chunk(2, dim=-1)
        y_err = (y.detach() - fused_resblock_reference(x, kernel, bias, scale, shift)).abs().max()
        dx, dk, db, dscale, dshift = fused_resblock_backward_reference(gy, x, kernel, bias,
                                                                       scale, shift)
        torch.cuda.synchronize()
        check(y_err.item() <= 1e-4, f"training forward {shape}: max-abs {y_err.item()} > 1e-4")
        got = (leaves[0].grad, leaves[1].grad, leaves[2].grad, *leaves[3].grad.chunk(2, dim=-1))
        want = (dx, dk.permute(3, 2, 0, 1), db, dscale, dshift)
        rel = {n: ((a - w).abs().max() / w.abs().max()).item() for n, a, w in zip(names, got, want)}
        for n, r in rel.items():
            check(r <= BWD_TOL, f"backward {shape} {n}: {r} of its largest value > {BWD_TOL}")
        errs[str(shape)] = {n: (a - w).abs().max().item() for n, a, w in zip(names, got, want)}
        errs[str(shape)].update(relative=rel, y=y_err.item())
        del x, kernel, bias, te, gy, weight, leaves, y, dx, dk, db, dscale, dshift, got, want

    # each kernel at the main shape, on the main path's inputs
    b, h, w, c = RESBLOCK_SHAPE
    x, kernel, bias, te = (t.to(dev) for t in resblock_inputs(RESBLOCK_SHAPE, g))
    gy = torch.randn(RESBLOCK_SHAPE, generator=g).to(dev)
    scale, shift = te.chunk(2, dim=-1)
    kernel_t = transpose_kernel(kernel)
    wp, wt = prepare_weight(kernel), prepare_weight(kernel_t)
    y, z, hid = _fused_resblock_cuda(x, wp, bias, scale, shift, saving=True)
    dxk, dz, du = resblock_dgrad(gy, z, scale, shift, wt)
    w_lib = kernel.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    flops = 2 * 2 * b * h * w * c * c * 9  # a pair of convs' worth: each of dgrad and wgrad
    act = x.numel() * x.element_size()  # one (B, H, W, C) fp32 tensor
    rows = {}

    def measure(name, *args, **extra):
        rows[name] = backward_row(name, t0, card, torch.float32, *args, **extra)

    # the training forward (mode 3 then mode 2) beside the inference pair
    fwd_ms = cuda_ms(lambda: _fused_resblock_cuda(x, wp, bias, scale, shift, saving=True),
                     iters=10)
    inf_ms = cuda_ms(lambda: fused_resblock_prepared(x, wp, bias, scale, shift), iters=10)
    want_dx, want_dz, want_du = _dgrad_reference(gy, z, scale, shift, kernel_t)
    dgrad_err = max((a - w_).abs().max().item()
                    for a, w_ in ((dxk, want_dx), (dz, want_dz), (du, want_du)))
    measure("fused_resblock_dgrad", lambda: resblock_dgrad(gy, z, scale, shift, wt),
            lambda: _dgrad_reference(gy, z, scale, shift, kernel_t),
            lambda: library_dgrad(gy, z, w_lib, scale, shift), flops,
            act * 5 + 2 * wt[0].numel() * 4 + 2 * scale.numel() * 4, dgrad_err,
            forward_train_ms=fwd_ms, forward_inference_ms=inf_ms)
    wg = resblock_wgrad(x, dz, hid, gy)
    wg_err = (wg - resblock_wgrad_reference(x, dz, hid, gy)).abs().max().item()
    # split-K adds its partial sums in a fixed order: a second call gives the same bits
    check(torch.equal(wg, resblock_wgrad(x, dz, hid, gy)), "resblock_wgrad: two calls differ")
    measure("resblock_wgrad", lambda: resblock_wgrad(x, dz, hid, gy),
            lambda: resblock_wgrad_reference(x, dz, hid, gy),
            lambda: library_wgrad(x, dz, hid, gy), flops, act * 4 + wg.numel() * 4, wg_err,
            bit_equal_repeat=True)
    sums = resblock_channel_sums(du, z, dz, gy)
    sums_err = max((a - w_).abs().max().item()
                   for a, w_ in zip(sums, resblock_channel_sums_reference(du, z, dz, gy)))
    measure("resblock_channel_sums", lambda: resblock_channel_sums(du, z, dz, gy),
            lambda: resblock_channel_sums_reference(du, z, dz, gy), None, 0,
            act * 4 + (2 * b * c + c) * 4, sums_err)

    # the whole backward: the Function's (two dgrads, sums, wgrad) against the
    # plain twin and against autograd through the plain forward (cuDNN fp32)
    leaves = [t.clone().requires_grad_() for t in (x, kernel.permute(3, 2, 0, 1), bias, te)]
    yk = FusedResblockFn.apply(leaves[0], leaves[1], leaves[2], *leaves[3].chunk(2, dim=-1), None)
    lib_leaves = [t.clone().requires_grad_() for t in (x, kernel, bias, te)]
    yl = fused_resblock_reference(lib_leaves[0], lib_leaves[1], lib_leaves[2],
                                  *lib_leaves[3].chunk(2, dim=-1))
    whole = dict(
        ms=cuda_ms(lambda: torch.autograd.grad(yk, leaves, gy, retain_graph=True), iters=10),
        plain_ms=cuda_ms(lambda: fused_resblock_backward_reference(gy, x, kernel, bias, scale,
                                                                   shift), iters=10),
        library_ms=cuda_ms(lambda: torch.autograd.grad(yl, lib_leaves, gy, retain_graph=True),
                           iters=10),
    )
    whole["device_ms"] = profiled_ms(lambda: torch.autograd.grad(yk, leaves, gy,
                                                                 retain_graph=True), iters=10)
    bound3, _ = bound_ms(3 * 2 * flops, 0, "tf32")
    whole.update(bound_ms_3xtf32_dgrad_and_wgrad=bound3)
    phase("fused_resblock_backward", t0, kernel="whole_backward", shape=RESBLOCK_SHAPE,
          dtype="float32", tol_of_largest=BWD_TOL, errors=errs, **whole,
          note="plain_ms recomputes z and h; library_ms is autograd through "
               "fused_resblock_reference (cuDNN fp32, TF32 off)", card=card)
    return rows


BF16_TOL = 0.016  # the bf16 forward bar: max-abs of max(1, the largest value)
SUMS_TOL = 1e-3   # the wgrad and channel sums, of the largest value


def bar_share(got, want, kind):
    """(max-abs error, its share of the bar) of a bf16-path output: `bf16`,
    the bf16 forward bar, BF16_TOL of max(1, want's largest); `sums`,
    SUMS_TOL of want's largest, and for sums stored in bf16 one bf16 ulp of
    each value besides (two paths that add in other orders may round a sum
    to neighbouring bf16 numbers). A share above 1 fails."""
    ulp = 2.0**-7 if got.dtype == torch.bfloat16 else 0.0
    got, want = got.float(), want.float()
    diff, largest = (got - want).abs(), want.abs().max()
    if kind == "bf16":
        bar = BF16_TOL * torch.clamp(largest, min=1.0)
    else:
        bar = SUMS_TOL * largest + ulp * want.abs()
    return diff.max().item(), (diff / bar).max().item()


def wgrad_bf16_shapes(dev, card, t0, resblock_wgrad, resblock_wgrad_reference):
    """The bf16 weight gradient alone against its plain version, within
    SUMS_TOL and bit-equal over two calls, where its clusters differ: C =
    128 (one cluster of 3 a row tile) and 384 (three row tiles, clusters of
    3), a ragged W, and the training batch (64, 64, 64, 256), clusters of 2
    and the longest splits; then timed at the training batch beside its
    plain version, cuDNN's bf16 weight gradient and its bound. Returns the
    keys the kernel's row gains."""
    bf = torch.bfloat16
    gd = torch.Generator(device=dev).manual_seed(11)
    checks = {}
    for shape in ((2, 10, 13, 128), (1, 5, 70, 384), RAGGED_SHAPES[0], TRAIN_RESBLOCK_SHAPES[0]):
        x, dz, h, gy = (torch.randn(shape, generator=gd, device=dev).to(bf) for _ in range(4))
        got = resblock_wgrad(x, dz, h, gy)
        err, share = bar_share(got, resblock_wgrad_reference(x, dz, h, gy), "sums")
        again = torch.equal(got, resblock_wgrad(x, dz, h, gy))
        check(share <= 1, f"bf16 resblock_wgrad {shape}: max-abs {err}, {share} of its bar")
        check(again, f"bf16 resblock_wgrad {shape}: two calls differ")
        checks[str(shape)] = dict(max_abs_err=err, share_of_error_bar=share,
                                  bit_equal_repeat=again)
    b, hh, w, c = shape  # the training batch's tensors stay for the timing
    clocks = {}
    with card_clocks(clocks):
        ms = cuda_ms(lambda: resblock_wgrad(x, dz, h, gy), iters=10)
        library_ms = cuda_ms(lambda: library_wgrad(x, dz, h, gy), iters=10)
        plain_ms = cuda_ms(lambda: resblock_wgrad_reference(x, dz, h, gy), iters=3)
        dev_ms = profiled_ms(lambda: resblock_wgrad(x, dz, h, gy), iters=10)
    bound, bound_by = bound_ms(2 * 2 * b * hh * w * c * c * 9,
                               4 * x.numel() * 2 + 9 * c * c * 4, bf)
    train = dict(shape=shape, ms=ms, device_ms=dev_ms, plain_ms=plain_ms, library_ms=library_ms,
                 bound_ms=bound, bound_by=bound_by, share_of_bound=bound / ms,
                 **checks[str(shape)], **clocks)
    phase("fused_resblock_backward", t0, kernel="resblock_wgrad_bf16_shapes", dtype="bfloat16",
          tol_sums_of_largest=SUMS_TOL, checks=checks, train_batch=train, card=card)
    return dict(checks_by_shape=checks, train_batch=train)


# the shapes at which the bf16 conv's modes 3 and 4 are held to their plain
# versions through the C entry: the main, both ragged, the training batches,
# half-empty channel tiles (C = 128, 384, 512), batch 1 (32 tiles, fewer than
# SMs) and tile counts that are no multiple of the SM count (160, 384)
MODES_34_SHAPES = (RESBLOCK_SHAPE, *RAGGED_SHAPES, *TRAIN_RESBLOCK_SHAPES, (2, 10, 13, 128),
                   (1, 5, 70, 384), (1, 3, 9, 512), (1, 64, 64, 256), (5, 64, 64, 256),
                   (6, 64, 64, 512))


def conv_mode(mode, src, wgt, bias, scale, shift, res, out, aux):
    """One launch of the bf16 conv in epilogue `mode` through its C entry
    (hicdiff_conv3x3_bf16), uncounted: no main-path launch."""
    from hicdiff_tpu_torch.kernels import _build
    from hicdiff_tpu_torch.kernels.resblock import _conv3x3

    lib, fn = _conv3x3(torch.bfloat16)
    _build.check_status(lib, fn(
        src.data_ptr(), wgt.data_ptr(), bias.data_ptr(), scale.data_ptr(), shift.data_ptr(),
        scale.stride(0), None if res is None else res.data_ptr(), out.data_ptr(),
        None if aux is None else aux.data_ptr(), *src.shape, mode,
        torch.cuda.current_stream().cuda_stream), "conv3x3")


def library_mode3(x, w_oihw, bias, scale, shift):
    """Mode 3's yardstick: the cuDNN bf16 conv on a channels_last view and
    the eager epilogue, z and h stored. Timed here only."""
    z = F.conv2d(x.permute(0, 3, 1, 2), w_oihw, bias, padding=1)
    h = F.silu(z * (scale[:, :, None, None] + 1) + shift[:, :, None, None])
    return z.permute(0, 2, 3, 1), h.permute(0, 2, 3, 1)


def library_mode4(gy, z, w_oihw, scale, shift):
    """Mode 4's yardstick: the cuDNN bf16 transposed conv and the eager
    du/dz epilogue (library_dgrad's first half). Timed here only."""
    sc, sh = scale[:, :, None, None], shift[:, :, None, None]
    u = z.permute(0, 3, 1, 2) * (sc + 1) + sh
    s = torch.sigmoid(u)
    du = F.conv_transpose2d(gy.permute(0, 3, 1, 2), w_oihw, padding=1) * 0.1 * (
        s * (1 + u * (1 - s)))
    return (du * (sc + 1)).permute(0, 2, 3, 1), du.permute(0, 2, 3, 1)


def library_mode6(h, w_oihw, bias, stream):
    """Mode 6's yardstick: the cuDNN bf16 conv on a channels_last view and
    the eager epilogue, the bf16 branch added to the fp32 stream in fp32.
    Timed here only."""
    y = F.conv2d(h.permute(0, 3, 1, 2), w_oihw, bias, padding=1) * 0.1
    return (y.float() + stream.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def library_mode7(dz, w_oihw, stream):
    """Mode 7's yardstick: the cuDNN bf16 transposed conv, its bf16 output
    added to the fp32 g in fp32 (library_dgrad's second half). Timed here
    only."""
    dx = F.conv_transpose2d(dz.permute(0, 3, 1, 2), w_oihw, padding=1)
    return (dx.float() + stream.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def modes_34_checks(dev):
    """Modes 3 and 4 through the C entry against their plain versions on the
    same bf16 inputs at MODES_34_SHAPES, at the bf16 bar; each twice, bit
    for bit."""
    from hicdiff_tpu_torch.kernels.resblock import (
        _conv_f32,
        _dgrad_reference,
        prepare_weight,
        transpose_kernel,
    )

    bf = torch.bfloat16
    gd = torch.Generator(device=dev).manual_seed(13)
    checks = {}
    for shape in MODES_34_SHAPES:
        b, _, _, c = shape
        x, gy, z = ((torch.randn(shape, generator=gd, device=dev) * 0.5).to(bf) for _ in range(3))
        kernel = (torch.randn(3, 3, c, c, generator=gd, device=dev) / (9 * c) ** 0.5).to(bf)
        bias = (torch.randn(c, generator=gd, device=dev) * 0.05).to(bf)
        scale, shift = (torch.randn(b, 2 * c, generator=gd, device=dev) * 0.5).to(bf).chunk(2, -1)
        kernel_t = transpose_kernel(kernel)
        wp, wt = prepare_weight(kernel), prepare_weight(kernel_t)
        runs = []
        for _ in range(2):
            h3, z3, dz4, du4 = (torch.empty(shape, device=dev, dtype=bf) for _ in range(4))
            conv_mode(3, x, wp, bias, scale, shift, None, h3, z3)
            conv_mode(4, gy, wt, scale, scale, shift, z, dz4, du4)
            runs.append((h3, z3, dz4, du4))
        v = _conv_f32(x.float(), kernel.float(), bias.float())
        h_want = F.silu(v * (scale.float()[:, None, None] + 1) + shift.float()[:, None, None])
        _, dz_want, du_want = _dgrad_reference(gy, z, scale, shift, kernel_t)
        torch.cuda.synchronize()
        row = {n: bar_share(got, want, "bf16") for n, got, want in
               zip(("h", "z", "dz", "du"), runs[0], (h_want.to(bf), v.to(bf), dz_want, du_want))}
        for n, (err, share) in row.items():
            check(share <= 1, f"bf16 conv mode {3 if n in 'hz' else 4} {shape} {n}: "
                              f"max-abs {err}, {share} of its bar")
        again = all(torch.equal(a, b_) for a, b_ in zip(*runs))
        check(again, f"bf16 conv modes 3 and 4 {shape}: two calls differ")
        checks[str(shape)] = dict(max_abs_err_and_share_of_bar=row, bit_equal_repeat=again)
        del x, gy, z, kernel, bias, scale, shift, kernel_t, wp, wt, runs, v, h_want
    return checks


def modes_67_checks(dev):
    """The fp32-stream modes through the C entry against their plain
    versions at MODES_34_SHAPES, at the bf16 bar: mode 1 then mode 6 from
    the bf16 cast of an fp32 stream against fused_resblock_reference(...,
    residual=), mode 4 then mode 7 against _dgrad_reference(..., stream=)
    (dx fp32, dz and du); each pair twice, bit for bit."""
    from hicdiff_tpu_torch.kernels.resblock import (
        _dgrad_reference,
        fused_resblock_reference,
        prepare_weight,
        transpose_kernel,
    )

    bf = torch.bfloat16
    gd = torch.Generator(device=dev).manual_seed(14)
    checks = {}
    for shape in MODES_34_SHAPES:
        b, _, _, c = shape
        xs, gs = (torch.randn(shape, generator=gd, device=dev) * 0.5 for _ in range(2))
        z = (torch.randn(shape, generator=gd, device=dev) * 0.5).to(bf)
        kernel = (torch.randn(3, 3, c, c, generator=gd, device=dev) / (9 * c) ** 0.5).to(bf)
        bias = (torch.randn(c, generator=gd, device=dev) * 0.05).to(bf)
        scale, shift = (torch.randn(b, 2 * c, generator=gd, device=dev) * 0.5).to(bf).chunk(2, -1)
        xb, gb = xs.to(bf), gs.to(bf)
        kernel_t = transpose_kernel(kernel)
        wp, wt = prepare_weight(kernel), prepare_weight(kernel_t)
        runs = []
        for _ in range(2):
            h1, dz4, du4 = (torch.empty(shape, device=dev, dtype=bf) for _ in range(3))
            y6, dx7 = (torch.empty(shape, device=dev) for _ in range(2))
            conv_mode(1, xb, wp, bias, scale, shift, None, h1, None)
            conv_mode(6, h1, wp, bias, scale, shift, xs, y6, None)
            conv_mode(4, gb, wt, scale, scale, shift, z, dz4, du4)
            conv_mode(7, dz4, wt, scale, scale, shift, gs, dx7, None)
            runs.append((y6, dx7, dz4, du4))
        y_want = fused_resblock_reference(xb, kernel, bias, scale, shift, residual=xs)
        dx_want, dz_want, du_want = _dgrad_reference(gb, z, scale, shift, kernel_t, stream=gs)
        torch.cuda.synchronize()
        row = {n: bar_share(got, want, "bf16") for n, got, want in
               zip(("y", "dx", "dz", "du"), runs[0], (y_want, dx_want, dz_want, du_want))}
        for n, (err, share) in row.items():
            check(share <= 1, f"bf16 conv mode {6 if n == 'y' else 7} {shape} {n}: "
                              f"max-abs {err}, {share} of its bar")
        check(runs[0][0].dtype == runs[0][1].dtype == torch.float32,
              "the fp32-stream modes write fp32")
        again = all(torch.equal(a, b_) for a, b_ in zip(*runs))
        check(again, f"bf16 conv modes 6 and 7 {shape}: two calls differ")
        checks[str(shape)] = dict(max_abs_err_and_share_of_bar=row, bit_equal_repeat=again)
        del xs, gs, z, kernel, bias, scale, shift, xb, gb, kernel_t, wp, wt, runs
    return checks


def conv_modes_bf16(dev, card):
    """The bf16 conv's epilogue modes through the C entry (not counted: no
    main-path launches). First the persistent kernel's modes 3 and 4, and 6
    and 7, against their plain versions at MODES_34_SHAPES
    (modes_34_checks, modes_67_checks). Then each of modes 1-7 timed alone
    by CUDA events at batch 8, 64 and 66, with its share of one conv's
    bound (2 B H W C 9C FLOPs at 989 TFLOP/s), and modes 3, 4, 6 and 7
    beside cuDNN's time for the same function (library_mode3,
    library_mode4, library_mode6, library_mode7), which the port never
    calls. Modes 6 and 7 read bf16 and the fp32 stream and write fp32: 10
    bytes an element. Mode 1 against mode 3 is
    the same conv and epilogue, less the store of z; mode 5 against mode 4
    the same conv with a residual read and one store, against z read by
    TMA, the silu derivative and the stores of dz and du. Batch 66 fills
    whole waves of 132 SMs (2112 tiles of 2 rows x 64 pixels x 256
    channels, one 212 KB block an SM) where 64 leaves the last of 16 waves
    half empty. Beside each mode, the bytes it moves to and from device
    memory over 3.35 TB/s."""
    from hicdiff_tpu_torch.kernels.resblock import prepare_weight, transpose_kernel

    t0 = time.time()
    checks = modes_34_checks(dev)
    checks_67 = modes_67_checks(dev)
    bf = torch.bfloat16
    gd = torch.Generator(device=dev).manual_seed(12)
    rows = {}
    for b in (8, TRAIN_BATCH, 66):
        shape = (b, 64, 64, 256)
        x, kernel, bias, te = (t.to(dev, bf) for t in
                               resblock_inputs(shape, torch.Generator().manual_seed(b)))
        scale, shift = te.chunk(2, dim=-1)
        wp, wt = prepare_weight(kernel), prepare_weight(transpose_kernel(kernel))
        w_lib = kernel.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        gy, z, hid, dz, out, du = (torch.randn(shape, generator=gd, device=dev).to(bf)
                                   for _ in range(6))
        stream, out32 = (torch.randn(shape, generator=gd, device=dev) for _ in range(2))
        bound, _ = bound_ms(2 * x.numel() * 9 * shape[-1], 0, bf)
        # mode: (src, weight, bias, res, out, aux, bf16-sized tensors moved)
        launches = {1: (x, wp, bias, None, hid, None, 2), 3: (x, wp, bias, None, hid, z, 3),
                    2: (hid, wp, bias, x, out, None, 3), 4: (gy, wt, scale, z, dz, du, 4),
                    5: (dz, wt, scale, gy, out, None, 3),
                    6: (hid, wp, bias, stream, out32, None, 5),
                    7: (dz, wt, scale, stream, out32, None, 5)}
        library = {3: lambda: library_mode3(x, w_lib, bias, scale, shift),
                   4: lambda: library_mode4(gy, z, w_lib, scale, shift),
                   6: lambda: library_mode6(hid, w_lib, bias, stream),
                   7: lambda: library_mode7(dz, w_lib, stream)}
        row = {"bound_ms": bound}
        for mode, (src, wgt, bia, res, dst, aux, moved) in launches.items():
            ms = cuda_ms(lambda: conv_mode(mode, src, wgt, bia, scale, shift, res, dst, aux),
                         iters=10)
            row[f"mode{mode}"] = dict(ms=ms, ms_per_image=ms / b, share_of_bound=bound / ms,
                                      bytes_ms=moved * x.numel() * 2 / HBM_BYTES_PER_S * 1e3)
            if mode in library:
                row[f"mode{mode}"]["library_ms"] = cuda_ms(library[mode], iters=10)
        row["mode3_minus_mode1_ms"] = row["mode3"]["ms"] - row["mode1"]["ms"]
        row["mode4_minus_mode5_ms"] = row["mode4"]["ms"] - row["mode5"]["ms"]
        row["mode6_minus_mode2_ms"] = row["mode6"]["ms"] - row["mode2"]["ms"]
        row["mode7_minus_mode5_ms"] = row["mode7"]["ms"] - row["mode5"]["ms"]
        rows[b] = row
        del x, kernel, bias, te, scale, shift, wp, wt, w_lib, gy, z, hid, dz, out, du
        del stream, out32
    per_image = {f"mode{m}": rows[TRAIN_BATCH][f"mode{m}"]["ms_per_image"]
                 / rows[8][f"mode{m}"]["ms_per_image"] for m in range(1, 8)}
    waves = {f"mode{m}": rows[TRAIN_BATCH][f"mode{m}"]["ms"]
             / (rows[66][f"mode{m}"]["ms"] * TRAIN_BATCH / 66) for m in range(1, 8)}
    torch.cuda.synchronize()
    phase("conv_modes_bf16", t0, shape_hwc=(64, 64, 256), tol_bf16_of_max1_largest=BF16_TOL,
          modes_34_checks=checks, modes_67_checks=checks_67, by_batch=rows,
          per_image_ratio_64_to_8=per_image,
          ratio_64_to_66_scaled=waves, card=card)
    return rows


def resblock_backward_bf16(dev, card, g):
    """bf16 training's kernels: the block's training forward (mode 3, then 2
    or, onto the att variant's fp32 stream, 6) and backward (modes 4 and 5
    or 7, the bf16 weight gradient and channel sums) through
    FusedResblockFn against the plain twin in the same dtype flow, at the
    main, a ragged and the train phase's shapes, and on the fp32 stream at
    the first two; each kernel against its plain version on the same bf16
    inputs at the main shape (mode 3's z and h, the dgrad's dx, dz and du,
    mode 6's y, mode 7's dx at the bf16 forward bar; the wgrad and the sums
    within SUMS_TOL); then each timed there beside its bound (bf16 FLOPs at
    989 TFLOP/s; bytes at 3.35 TB/s for the sums), plain version and library
    call (cuDNN bf16 transposed convs with the eager epilogue, cuDNN's bf16
    weight gradient). Returns the rows for the kernels line."""
    from hicdiff_tpu_torch.kernels.resblock import (
        FusedResblockFn,
        _conv_f32,
        _dgrad_reference,
        _fused_resblock_cuda,
        fused_resblock_backward_reference,
        fused_resblock_prepared,
        fused_resblock_reference,
        prepare_weight,
        resblock_dgrad,
        transpose_kernel,
    )
    from hicdiff_tpu_torch.kernels.resblock_bwd import (
        resblock_channel_sums,
        resblock_channel_sums_reference,
        resblock_wgrad,
        resblock_wgrad_reference,
    )

    t0 = time.time()
    bf = torch.bfloat16
    names = ("dx", "dW", "db", "dscale", "dshift")
    kinds = ("bf16", "sums", "sums", "sums", "sums")
    errs = {}
    cases = [(s_, False) for s_ in (RESBLOCK_SHAPE, RAGGED_SHAPES[0], *TRAIN_RESBLOCK_SHAPES)]
    for shape, stream in cases + [(RESBLOCK_SHAPE, True), (RAGGED_SHAPES[0], True)]:
        x, kernel, bias, te = resblock_inputs(shape, g)
        x = x.to(dev) if stream else x.to(dev, bf)  # the att variant's stream is fp32
        weight = kernel.permute(3, 2, 0, 1).contiguous().to(dev)
        bias, te = bias.to(dev), te.to(dev, bf)
        gy = torch.randn(shape, generator=g).to(dev, x.dtype)
        leaves = [t.clone().requires_grad_() for t in (x, weight, bias, te)]
        y = FusedResblockFn.apply(leaves[0], leaves[1], leaves[2], *leaves[3].chunk(2, dim=-1),
                                  None)
        y.backward(gy)
        scale, shift = te.chunk(2, dim=-1)
        kb, bb = weight.permute(2, 3, 1, 0).to(bf), bias.to(bf)
        want_y = fused_resblock_reference(x.to(bf), kb, bb, scale, shift, x if stream else None)
        dx, dk, db, dscale, dshift = fused_resblock_backward_reference(gy, x, kb, bb, scale,
                                                                       shift)
        torch.cuda.synchronize()
        got = (leaves[0].grad, leaves[1].grad, leaves[2].grad, *leaves[3].grad.chunk(2, dim=-1))
        want = (dx, dk.permute(3, 2, 0, 1), db, dscale, dshift)
        key = f"{shape}{' fp32 stream' if stream else ''}"
        errs[key] = {"y": bar_share(y.detach(), want_y, "bf16")}
        errs[key].update({n: bar_share(a, w_, k) for n, a, w_, k in zip(names, got, want, kinds)})
        for n, (err, share) in errs[key].items():
            check(share <= 1, f"bf16 backward {key} {n}: max-abs {err}, {share} of its bar")
        del x, weight, bias, te, gy, leaves, y, want_y, dx, dk, db, dscale, dshift, got, want

    # each kernel on the same bf16 inputs at the main shape, then timed
    b, h, w, c = RESBLOCK_SHAPE
    x, kernel, bias, te = (t.to(dev, bf) for t in resblock_inputs(RESBLOCK_SHAPE, g))
    gy = torch.randn(RESBLOCK_SHAPE, generator=g).to(dev, bf)
    xs, gs = (torch.randn(RESBLOCK_SHAPE, generator=g).to(dev) for _ in range(2))  # fp32 stream
    xsb, gsb = xs.to(bf), gs.to(bf)
    scale, shift = te.chunk(2, dim=-1)
    kernel_t = transpose_kernel(kernel)
    wp, wt = prepare_weight(kernel), prepare_weight(kernel_t)
    y, z, hid = _fused_resblock_cuda(x, wp, bias, scale, shift, saving=True)
    v = _conv_f32(x.float(), kernel.float(), bias.float())
    h_want = F.silu(v * (scale.float()[:, None, None] + 1) + shift.float()[:, None, None])
    mode3 = {"z": bar_share(z, v.to(bf), "bf16"), "h": bar_share(hid, h_want.to(bf), "bf16")}
    dxk, dz, du = resblock_dgrad(gy, z, scale, shift, wt)
    dgrad = {n: bar_share(a, w_, "bf16") for n, a, w_ in
             zip(("dx", "dz", "du"), (dxk, dz, du), _dgrad_reference(gy, z, scale, shift, kernel_t))}
    wg = resblock_wgrad(x, dz, hid, gy)
    wgrad = bar_share(wg, resblock_wgrad_reference(x, dz, hid, gy), "sums")
    check(torch.equal(wg, resblock_wgrad(x, dz, hid, gy)), "bf16 resblock_wgrad: two calls differ")
    sums_fp32 = resblock_channel_sums_reference(*(t.float() for t in (du, z, dz, gy)))
    sums = {n: bar_share(a, w_, "sums") for n, a, w_ in
            zip(("dscale", "dshift", "db"), resblock_channel_sums(du, z, dz, gy), sums_fp32)}
    y6 = fused_resblock_prepared(xsb, wp, bias, scale, shift, residual=xs)
    mode6 = bar_share(y6, fused_resblock_reference(xsb, kernel, bias, scale, shift, xs), "bf16")
    dx7 = resblock_dgrad(gsb, z, scale, shift, wt, gs)[0]
    mode7 = bar_share(dx7, _dgrad_reference(gsb, z, scale, shift, kernel_t, gs)[0], "bf16")
    torch.cuda.synchronize()
    for what, results in (("mode 3", mode3), ("dgrad", dgrad), ("wgrad", {"dW": wgrad}),
                          ("channel sums", sums), ("mode 6", {"y": mode6}),
                          ("mode 7", {"dx": mode7})):
        for n, (err, share) in results.items():
            check(share <= 1, f"bf16 {what} {n}: max-abs {err}, {share} of its bar")
    check(y6.dtype == dx7.dtype == torch.float32, "the fp32-stream modes write fp32")

    w_lib = kernel.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    flops = 2 * 2 * b * h * w * c * c * 9  # a pair of convs' worth
    act = x.numel() * x.element_size()  # one (B, H, W, C) bf16 tensor
    params = wt.numel() * 2 + 2 * scale.numel() * 2
    rows = {}

    def measure(name, *args, **extra):
        rows[name] = backward_row(name, t0, card, bf, *args, **extra)

    fwd_ms = cuda_ms(lambda: _fused_resblock_cuda(x, wp, bias, scale, shift, saving=True),
                     iters=10)
    inf_ms = cuda_ms(lambda: fused_resblock_prepared(x, wp, bias, scale, shift), iters=10)
    y_err = bar_share(y, fused_resblock_reference(x, kernel, bias, scale, shift), "bf16")
    check(y_err[1] <= 1, f"bf16 training forward y: max-abs {y_err[0]}, {y_err[1]} of its bar")

    def train_forward_plain():  # y, z and h as the plain versions compute them
        v = _conv_f32(x.float(), kernel.float(), bias.float())
        return fused_resblock_reference(x, kernel, bias, scale, shift), v.to(bf), F.silu(
            v * (scale.float()[:, None, None] + 1) + shift.float()[:, None, None]).to(bf)

    # the training forward: mode 3 (z and h), then mode 2; x read, z, h, y written
    measure("fused_resblock_train",
            lambda: _fused_resblock_cuda(x, wp, bias, scale, shift, saving=True),
            train_forward_plain, lambda: library_train_forward(x, w_lib, bias, scale, shift),
            flops, act * 4 + wp.numel() * 2 + (c + 2 * b * c) * 2,
            max(e for e, _ in (*mode3.values(), y_err)),
            errors={**mode3, "y": y_err}, modes=[3, 2], forward_inference_ms=inf_ms)
    measure("fused_resblock_dgrad", lambda: resblock_dgrad(gy, z, scale, shift, wt),
            lambda: _dgrad_reference(gy, z, scale, shift, kernel_t),
            lambda: library_dgrad(gy, z, w_lib, scale, shift), flops, act * 5 + params,
            max(e for e, _ in dgrad.values()), errors=dgrad, mode3_errors=mode3,
            forward_train_ms=fwd_ms, forward_inference_ms=inf_ms)
    measure("resblock_wgrad", lambda: resblock_wgrad(x, dz, hid, gy),
            lambda: resblock_wgrad_reference(x, dz, hid, gy),
            lambda: library_wgrad(x, dz, hid, gy), flops, act * 4 + wg.numel() * 4, wgrad[0],
            share_of_error_bar=wgrad[1], bit_equal_repeat=True,
            **wgrad_bf16_shapes(dev, card, t0, resblock_wgrad, resblock_wgrad_reference))
    measure("resblock_channel_sums", lambda: resblock_channel_sums(du, z, dz, gy),
            lambda: resblock_channel_sums_reference(du, z, dz, gy), None, 0,
            act * 4 + (2 * b * c) * 2 + c * 4, max(e for e, _ in sums.values()), errors=sums)
    measure("fused_resblock_f32_stream",
            lambda: fused_resblock_prepared(xsb, wp, bias, scale, shift, residual=xs),
            lambda: fused_resblock_reference(xsb, kernel, bias, scale, shift, xs),
            lambda: library_resblock(xsb, w_lib, bias, scale, shift, residual=xs), flops,
            # x in bf16 and the fp32 stream read, the fp32 y written
            act + 2 * act + 2 * act + wp.numel() * 2 + (c + 2 * b * c) * 2, mode6[0],
            modes=[1, 6],
            kernels=["conv3x3_bf16_kernel<1>", "conv3x3_bf16_persistent_kernel<6>"])
    measure("fused_resblock_dgrad_f32_stream",
            lambda: resblock_dgrad(gsb, z, scale, shift, wt, gs),
            lambda: _dgrad_reference(gsb, z, scale, shift, kernel_t, gs),
            lambda: library_dgrad(gsb, z, w_lib, scale, shift, stream=gs), flops,
            # g in bf16, the fp32 g, z read; dz, du and the fp32 dx written
            act + 2 * act + act + 2 * act + 2 * act + params, mode7[0], modes=[4, 7],
            kernels=["conv3x3_bf16_persistent_kernel<4>", "conv3x3_bf16_persistent_kernel<7>"])
    phase("fused_resblock_backward", t0, kernel="bf16_checks", dtype="bfloat16",
          tol_bf16_of_max1_largest=BF16_TOL, tol_sums_of_largest=SUMS_TOL,
          errors_max_abs_and_share_of_bar=errs, card=card)
    return rows


def _launch_counts():
    from hicdiff_tpu_torch.kernels.resblock import fused_resblock, resblock_dgrad
    from hicdiff_tpu_torch.kernels.resblock_bwd import resblock_channel_sums, resblock_wgrad

    return {"fused_resblock": fused_resblock, "fused_resblock_dgrad": resblock_dgrad,
            "resblock_wgrad": resblock_wgrad, "resblock_channel_sums": resblock_channel_sums}


def train(dev, card, condition=False, bf16=False):
    """Drive `train_torch.py`'s entry class on the card: one epoch of the
    full-width model at batch 64 on a synthetic cell written as text, the
    launch counters, step times split by CUDA events, peak memory, the
    checkpoints. condition=False (-u 0, phase `train`): then the -u 0
    inference on the final checkpoint (DDIM, 2 steps). condition=True (-u
    1, phase `train_uncond`): the unconditional model on the clean patches,
    then the -u 1 CLI restores the test split through DDRM (deno, t* = 27,
    2 sampling steps: 3 forwards) from the checkpoint it finds by its tag,
    with no --weights (bestg: after one epoch, the final step's weights).
    bf16 (phases `train_bf16`, `train_uncond_bf16`): train_torch.py --bf16,
    every block through the bf16 kernels, and the inference in bf16.
    Returns the epoch's launch counts."""
    import inference_torch
    import train_torch
    from hicdiff_tpu_torch.data.datamodule import HUMAN_SPLITS
    from hicdiff_tpu_torch.sampling.ddrm import _build_seq
    from hicdiff_tpu_torch.train.checkpoint import checkpoint_name

    name = ("train_uncond" if condition else "train") + ("_bf16" if bf16 else "")
    t0 = time.time()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="smoke_train_", dir=os.path.join(ROOT, "build"))
    counters = _launch_counts()
    try:
        split_of = {c: k for k, cs in HUMAN_SPLITS.items() for c in cs}
        write_synthetic_cell(root, lambda c: TRAIN_BINS[split_of[c]], marker="_p99.99")
        run = train_torch.HiCDiff(epoch=1, batch_size=TRAIN_BATCH, cellNo=1, cell_Line="Human",
                                  sigma=SIGMA, condition=condition, root=root, seed=0,
                                  schedule="linear", blocks=BLOCKS, features=FEATURES,
                                  bf16=bf16, device=dev)
        check(run.mode == ("uncond" if condition else "cond"), f"{name}: mode {run.mode}")
        check(run.engine.model.dtype == (torch.bfloat16 if bf16 else None), f"{name}: dtype")
        check(run.engine.model.self_condition is not condition, f"{name}: self-conditioning")
        n_train, n_val = len(run.train_loader.dataset), len(run.val_loader.dataset)
        steps, val_batches = -(-n_train // TRAIN_BATCH), -(-n_val // TRAIN_BATCH)
        check(n_train >= 3 * TRAIN_BATCH and n_train % TRAIN_BATCH == TRAIN_RESBLOCK_SHAPES[1][0],
              f"train patches {n_train}")
        check(n_val > 0, "no val patches")
        setup_s = time.time() - t0
        run.trainer.time_steps = True
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for counter in counters.values():
            counter.launches = 0
        for counter in (counters["fused_resblock"], counters["fused_resblock_dgrad"]):
            counter.mode_launches.clear()
        tr = time.time()
        best = run.fit_model()
        torch.cuda.synchronize()
        fit_s = time.time() - tr
        launches = {k: v.launches for k, v in counters.items()}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        want = {"fused_resblock": (steps + val_batches) * BLOCKS * 2,
                "fused_resblock_dgrad": steps * BLOCKS * 2,
                "resblock_wgrad": steps * BLOCKS, "resblock_channel_sums": steps * BLOCKS}
        check(launches == want, f"{name} launches {launches} != {want}")
        # each step: BLOCKS training forwards (mode 3, then 2) and BLOCKS of
        # conv #2's dgrad (mode 4, then 5)
        modes_34 = (counters["fused_resblock"].mode_launches[3],
                    counters["fused_resblock_dgrad"].mode_launches[4])
        check(modes_34 == (steps * BLOCKS, steps * BLOCKS),
              f"{name}: modes 3 and 4 launched {modes_34} times in {steps} steps")
        launches["fused_resblock_train"] = 2 * modes_34[0]
        times = run.trainer.step_times_ms()
        check(len(times) == steps, f"{len(times)} timed steps of {steps}")
        record = run.trainer.history[0]
        check(np.isfinite([best, record["train/loss"], record["valid/loss"]]).all(),
              f"{name} losses {record}, best {best}")
        meta = dict(res=40000, chunk=64, cell_line="Human", cell_no=1, tag=run.tag)
        ckpts = {k: os.path.join(run.out_dir, checkpoint_name(k, **meta))
                 for k in ("bestg", "finalg")}
        check(all(os.path.exists(p) for p in ckpts.values()), f"checkpoints: {ckpts}")
        ckpt_mb = {k: os.path.getsize(p) / 1e6 for k, p in ckpts.items()}
        full = times[:-1]  # the last step is the ragged batch
        phase(name, t0, run="epoch", blocks=BLOCKS, features=FEATURES, batch=TRAIN_BATCH,
              dtype="bfloat16" if bf16 else "float32", mode=run.mode, tag=run.tag, train_patches=n_train,
              val_patches=n_val, steps=steps, ragged_batch=n_train % TRAIN_BATCH,
              setup_s=setup_s, fit_s=fit_s, epoch_s=record["epoch_seconds"],
              train_loss=record["train/loss"], valid_loss=record["valid/loss"], best_loss=best,
              step_ms=[sum(t) for t in times], forward_ms=[t[0] for t in times],
              backward_ms=[t[1] for t in times], update_ms=[t[2] for t in times],
              full_step_ms_mean=float(np.mean([sum(t) for t in full])),
              peak_memory_gb=peak_gb, launches=launches,
              mode_launches_per_step={"mode3": modes_34[0] / steps, "mode4": modes_34[1] / steps},
              checkpoint_mb=ckpt_mb,
              cut="data scale only: 14 train chromosomes of 320 bins (hg19's have "
                  "1,200-6,200 at 40 kb); full width and depth", card=card)
        run.trainer.time_steps = False

        # the port's inference on the trained checkpoint
        tr = time.time()
        counters["fused_resblock"].launches = 0
        common = dict(device=dev, batch_size=TRAIN_BATCH, cellNo=1, cell_Line="Human",
                      sigma_t=SIGMA, condition=condition, root=root, schedule="linear",
                      timestep=1000, sampling_steps=2, t_start="auto", blocks=BLOCKS,
                      features=FEATURES, compute_metrics=False, out_tag="_trained", bf16=bf16)
        if condition:  # the -u 1 CLI finds the checkpoint by its tag
            res = inference_torch.Inference(**common)
            forwards = len(_build_seq(1000, 2, 27))  # the chain's seq: 0, 14, 27
        else:
            res = inference_torch.Inference(weights=ckpts["finalg"], **common)
            forwards = 2
        torch.cuda.synchronize()
        pred = np.asarray(res["predict"])
        check(pred.shape == (len(HUMAN_SPLITS["test"]), 64, 64, 1), f"predict {pred.shape}")
        check(np.isfinite(pred).all() and (condition or np.abs(pred).max() <= 1.0),
              "trained checkpoint's output not finite or outside [-1, 1]")
        infer_launches = counters["fused_resblock"].launches
        check(infer_launches == forwards * BLOCKS * 2, f"inference launches {infer_launches}")
        phase(name, tr, run="inference_on_final_checkpoint", patches=len(pred),
              sampling_steps=2, forwards=forwards, outdir=os.path.basename(res["outdir"]),
              resblock_launches=infer_launches, predict_abs_max=float(np.abs(pred).max()),
              card=card)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches


def train_step_vs_plain(dev, card, name="hicedrn", mode="cond", phase_name="train_step_vs_plain",
                        bf16=False):
    """Two training steps of the full-width model on the card (kernels)
    against the same steps on the CPU (the plain twin), from the same
    weights, batches, timesteps (sr3: levels) and noise: both losses, the
    second step's gradients, and each weight's update over the two steps.
    The second step's forward and backward read the blocks' conv packs,
    which must have been rebuilt after the first update: a stale pack shows
    in that step's loss and gradients, and is checked directly on the packs
    it read. `name` is a hicedrn backbone of the registry, `mode` the
    engine's. bf16: both sides compute in bf16; the CPU also takes the
    second step's gradient in fp32 at the CPU's weights after its first
    step. Each gradient of the card's second step must lie no farther (L2)
    from the CPU's bf16 gradient, or no farther from the fp32 one, than
    those two lie from each other (tests/test_torch_bf16.py's
    `assert_bf16_bar`): the card and the twin round at the same points, so
    on a leaf bf16 barely rounds (a bias gradient summed in fp32) both
    distances are sum-order noise and either may win. Over all gradients
    concatenated the card must lie no farther from the CPU's bf16 gradient
    than that lies from the fp32 one. A kernel fault lies far from both and
    fails both. The losses within 1e-2 relative. The updates are reported,
    not held: a bf16 gradient's sign flips where it is small."""
    import copy

    from hicdiff_tpu_torch.diffusion.gaussian import GaussianDiffusion
    from hicdiff_tpu_torch.kernels.resblock import prepare_weight, transpose_kernel
    from hicdiff_tpu_torch.models.zoo import DIFFUSION_BACKBONES
    from hicdiff_tpu_torch.train.trainer import Trainer

    t0 = time.time()
    lr = 2e-5
    model_name = name
    dt = torch.bfloat16 if bf16 else torch.float32
    cpu = DIFFUSION_BACKBONES[name](True, dt if bf16 else None, device="cpu",
                                    generator=torch.Generator().manual_seed(3))
    initial = [p.detach().clone() for p in cpu.parameters()]
    card_model = copy.deepcopy(cpu).to(dev)

    def engine(m):
        return GaussianDiffusion.create(m, device=m.head.weight.device, mode=mode,
                                        timesteps=1000, beta_schedule="linear")

    trainers = [Trainer(engine(m), lr=lr) for m in (card_model, cpu)]
    prev = trainers[1].engine.host_schedule.sqrt_alphas_cumprod_prev
    rng = np.random.default_rng(4)
    batches = []
    for t in ((17, 612), (240, 955)):
        target = np.clip(rng.normal(0, 0.3, (STEP_VS_PLAIN_BATCH, 64, 64, 1)), -1, 1).astype(
            np.float32)
        data = np.clip(target + SIGMA * rng.normal(size=target.shape), -1, 1).astype(np.float32)
        noise = torch.from_numpy(rng.normal(size=target.shape).astype(np.float32))
        draws = dict(level=prev[torch.tensor(t)]) if mode == "sr3" else dict(t=torch.tensor(t))
        batches.append((data, target, draws, noise))
    losses, step_s = {}, {}
    for side, trainer in zip(("card", "cpu"), trainers):
        tc = time.time()
        losses[side] = []
        for i, (data, target, draws, noise) in enumerate(batches):
            if side == "cpu" and i == 1 and bf16:
                # the second step's gradient in fp32, at the CPU's weights
                fp32 = copy.deepcopy(cpu)
                fp32.dtype = None
                fp32.zero_grad(set_to_none=True)
                loss32 = engine(fp32).p_losses(torch.from_numpy(data), torch.from_numpy(target),
                                               noise=noise, **draws)
                loss32.backward()
                grads32 = [p.grad for p in fp32.parameters()]
            losses[side].append(float(trainer.train_step(data, target, noise=noise, **draws)))
            if side == "card" and i == 0:  # the conv weights the second step reads
                after_first = [blk.conv["proj"].weight.detach().clone() for blk in card_model.body]
        step_s[side] = (time.time() - tc) / len(batches)
    # the packs the second step read, still in each block's cache (the next
    # lookup would rebuild them from the second update), against packs made
    # afresh from the weights after the first update
    stale = []
    for i, (blk, w) in enumerate(zip(card_model.body, after_first)):
        kernel = w.permute(2, 3, 1, 0).to(dt)
        used = (blk._cache[dt][1][2], blk._cache[("transposed", dt)][1])
        if not all(torch.equal(u, prepare_weight(k))
                   for u, k in zip(used, (kernel, transpose_kernel(kernel)))):
            stale.append(i)
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(losses["card"], losses["cpu"])]
    grad_rel, update_err, outliers, outliers_of = {}, 0.0, 0, {}
    # tolerances: the losses and the gradients as fp32 sums in other orders
    # (the card's 3xTF32 convs within ~2^-22 a product). An Adam step moves a
    # weight by at most about lr, the first by lr * sign(g), so the two
    # updates agree far inside lr / 10 except where a tiny gradient's sign
    # flips between the two paths; those are counted, each at most 4 lr off
    loss_tol, grad_tol, update_tol, flip_tol = 1e-4, 1e-3, 0.1 * lr, 4 * lr * 1.01
    if bf16:
        loss_tol = 1e-2
        dists = {}  # per gradient, L2: card - cpu bf16, cpu bf16 - cpu fp32
    for j, ((pname, pk), pc, p0) in enumerate(zip(card_model.named_parameters(),
                                                  cpu.parameters(), initial)):
        gk, gc = pk.grad.cpu(), pc.grad
        grad_rel[pname] = ((gk - gc).abs().max() / gc.abs().max()).item()
        if bf16:
            dists[pname] = ((gk - gc).norm().item(), (gc - grads32[j]).norm().item(),
                            (gk - grads32[j]).norm().item())
        diff = ((pk.detach().cpu() - p0) - (pc.detach() - p0)).abs()
        update_err = max(update_err, diff.max().item())
        outliers_of[pname] = int((diff > update_tol).sum())
        outliers += outliers_of[pname]
    n_params = sum(p.numel() for p in initial)
    max_outliers = n_params // 100_000
    worst = max(grad_rel, key=grad_rel.get)
    check(not stale, f"blocks {stale} read conv packs of stale weights in the second step")
    check(max(loss_rel) <= loss_tol, f"step losses: card {losses['card']}, cpu {losses['cpu']}")
    extra = {}
    if bf16:
        ratio = {k: d[0] / d[1] for k, d in dists.items()}  # card to twin, of the gap
        bar = {k: min(d[0], d[2]) / d[1] for k, d in dists.items()}
        far = max(bar, key=bar.get)
        check(bar[far] <= 1, f"grad {far}: card - cpu bf16 {dists[far][0]} and card - cpu "
                             f"fp32 {dists[far][2]} > cpu bf16 - cpu fp32 {dists[far][1]}")
        tree = [float(np.sqrt(sum(d[i] ** 2 for d in dists.values()))) for i in range(3)]
        check(tree[0] <= tree[1], f"all gradients: card - cpu bf16 {tree[0]} > "
                                  f"cpu bf16 - cpu fp32 {tree[1]}")
        extra = dict(grad_l2_worst=far, grad_l2_worst_card_vs_cpu_bf16=dists[far][0],
                     grad_l2_worst_cpu_bf16_vs_fp32=dists[far][1],
                     grad_l2_worst_card_vs_cpu_fp32=dists[far][2],
                     grad_l2_bar_max=bar[far],
                     grad_l2_ratio_max=max(ratio.values()),
                     grad_l2_ratio_worst=max(ratio, key=ratio.get),
                     grad_l2_ratio_median=float(np.median(list(ratio.values()))),
                     grad_l2_tree=tree, grad_l2_tree_ratio=tree[0] / tree[1],
                     grad_l2_distances={k: [float(f"{v:.4g}") for v in d]
                                        for k, d in dists.items()})
    else:
        check(grad_rel[worst] <= grad_tol, f"grad {worst}: {grad_rel[worst]} > {grad_tol}")
        check(outliers <= max_outliers,
              f"{outliers} weights' updates differ by over {update_tol} (at most {max_outliers})")
    check(update_err <= flip_tol, f"updates: max-abs difference {update_err} > {flip_tol}")
    most = sorted(outliers_of.items(), key=lambda kv: -kv[1])[:5]
    phase(phase_name, t0, model=model_name, mode=mode, dtype=str(dt).split(".")[-1],
          blocks=BLOCKS, features=FEATURES,
          batch=STEP_VS_PLAIN_BATCH, steps=len(batches), loss_card=losses["card"],
          loss_cpu=losses["cpu"],
          loss_rel_err=loss_rel, loss_tol=loss_tol, grad_step=2, grad_worst=worst,
          grad_worst_rel_err=grad_rel[worst], grad_tol_of_largest=None if bf16 else grad_tol,
          grad_median_rel_err=float(np.median(list(grad_rel.values()))),
          update_tol=update_tol, update_outliers=outliers,
          update_outliers_allowed=None if bf16 else max_outliers,
          update_outliers_most=[kv for kv in most if kv[1]],
          update_max_abs_err=update_err, update_max_abs_tol=flip_tol, stale_pack_blocks=stale,
          params=n_params, card_step_s=step_s["card"], cpu_step_s=step_s["cpu"], **extra,
          card=card)


# ---- the -u 1 path: DDRM restoration with the unconditional backbone

DDRM_OPERATORS = ("deno", "inp_mask", "sr2", "sr_bicubic4", "deblur_uni", "deblur_gauss",
                  "deblur_aniso", "cs4", "color", "general")
DDRM_OP_BATCH = 64  # the CLI's batch
DDRM_CHAIN_BATCH = 2  # the plain path runs this chain on the host's CPU
DDRM_TOL = 1e-3  # the zero-noise chain, card vs CPU, of the CPU's largest value


def _ddrm_operator(name, device):
    """One degradation operator at 64x64 on `device`, from fixed numpy draws
    (Colorization has three channels; GeneralH is a seeded dense 512 x 4096 H)."""
    from hicdiff_tpu_torch.degrade import operators as ops

    if name == "color":
        return ops.Colorization(64, device=device)
    if name == "general":
        return ops.GeneralH(np.random.default_rng(5).normal(size=(512, 64 * 64)), device=device)
    return ops.make_operator(name, 1, 64, rng=np.random.default_rng(42), device=device)


def ddrm_operators(dev, card):
    """Every operator class, built on the card and on the CPU from the same
    draws: each map (V, Vt, U, Ut, H, Ht, H_pinv) on the card within 1e-5 of
    the CPU's largest value, Vt(V(x)) = x within 1e-5, and the card's time
    of one step's transforms (two Vt and a V) at the CLI's batch; then
    fwht_matmul against the butterfly twin on the card."""
    from hicdiff_tpu_torch.kernels.fwht import fwht_butterfly, fwht_matmul

    t0 = time.time()
    rng = np.random.default_rng(11)
    rows = {}
    for name in DDRM_OPERATORS:
        tb = time.time()
        card_op, cpu_op = _ddrm_operator(name, dev), _ddrm_operator(name, "cpu")
        build_s = time.time() - tb
        dim = 3 * 64 * 64 if name == "color" else 64 * 64
        m, s = cpu_op.H(torch.zeros(1, dim)).shape[1], cpu_op.singulars().shape[0]
        errs = {}
        for fn, width in (("V", dim), ("Vt", dim), ("U", s), ("Ut", m), ("H", dim), ("Ht", m),
                          ("H_pinv", m)):
            x = torch.from_numpy(rng.normal(size=(DDRM_OP_BATCH, width)).astype(np.float32))
            want = getattr(cpu_op, fn)(x)
            got = getattr(card_op, fn)(x.to(dev)).cpu()
            errs[fn] = ((got - want).abs().max() / want.abs().max()).item()
        x = torch.from_numpy(rng.normal(size=(DDRM_OP_BATCH, dim)).astype(np.float32)).to(dev)
        errs["Vt_of_V"] = ((card_op.Vt(card_op.V(x)) - x).abs().max() / x.abs().max()).item()
        worst = max(errs, key=errs.get)
        check(errs[worst] <= 1e-5, f"operator {name} {worst}: {errs[worst]} > 1e-5")
        transforms_ms = cuda_ms(lambda: (card_op.Vt(x), card_op.Vt(x), card_op.V(x)), iters=10)
        rows[name] = dict(cls=type(card_op).__name__, measurement_width=m, singulars=s,
                          build_s=build_s, rel_errs=errs, step_transforms_ms=transforms_ms)
    x = torch.from_numpy(rng.normal(size=(DDRM_OP_BATCH, 64 * 64)).astype(np.float32)).to(dev)
    twin = fwht_butterfly(x, 64)
    fwht_err = ((fwht_matmul(x, 64) - twin).abs().max() / twin.abs().max()).item()
    check(fwht_err <= 1e-5, f"fwht_matmul vs butterfly on the card: {fwht_err} > 1e-5")
    phase("ddrm_operators", t0, image=64, batch=DDRM_OP_BATCH, tol_of_largest=1e-5,
          operators=rows, fwht_rel_err=fwht_err, card=card)


def ddrm_chain_vs_plain(dev, card):
    """A zero-noise DDRM chain of the full-width unconditional backbone at
    batch 2, on the card (the kernels) and on the CPU (the plain blocks),
    from the same weights, measurements and init: deno truncated at its
    auto t* and inp_mask with 10 steps. Outputs within DDRM_TOL of the CPU's
    largest value; every forward's blocks through the kernel."""
    import copy

    from hicdiff_tpu_torch.diffusion.schedules import get_beta_schedule
    from hicdiff_tpu_torch.kernels.resblock import fused_resblock
    from hicdiff_tpu_torch.models.hicedrn import HicedrnDiff
    from hicdiff_tpu_torch.sampling.ddrm import (
        _build_seq,
        ddrm_auto_t_start,
        efficient_generalized_steps,
    )

    t0 = time.time()
    cpu = HicedrnDiff(self_condition=False, number_resnet=BLOCKS, features=FEATURES,
                      device="cpu", generator=torch.Generator().manual_seed(6))
    cpu.eval()
    card_model = copy.deepcopy(cpu).to(dev)
    betas = get_beta_schedule("linear", beta_start=1e-4, beta_end=0.02,
                              num_diffusion_timesteps=1000).astype(np.float32)
    rng = np.random.default_rng(12)
    runs = {}
    for deg, sampling_steps in (("deno", None), ("inp_mask", 10)):
        card_op, cpu_op = _ddrm_operator(deg, dev), _ddrm_operator(deg, "cpu")
        t_start = ddrm_auto_t_start(cpu_op, betas, SIGMA, 64 * 64)
        check(t_start == (27 if deg == "deno" else None), f"{deg}: t_start {t_start}")
        seq = _build_seq(1000, sampling_steps or 1000, t_start)
        clean = torch.from_numpy(
            np.clip(rng.normal(0, 0.3, (DDRM_CHAIN_BATCH, 64 * 64)), -1, 1).astype(np.float32))
        y = cpu_op.H(clean)
        y = y + SIGMA * torch.from_numpy(rng.normal(size=tuple(y.shape)).astype(np.float32))
        x = torch.from_numpy(rng.normal(size=(DDRM_CHAIN_BATCH, 64, 64, 1)).astype(np.float32))
        kw = dict(exact_init=t_start is not None)
        fused_resblock.launches = 0
        tc = time.time()
        with torch.no_grad():
            got = efficient_generalized_steps(
                x.to(dev), seq, lambda a, t: card_model(a, t, None), betas, card_op, y.to(dev),
                SIGMA, noise=lambda shape: torch.zeros(shape, device=dev), **kw)[0].cpu()
        card_s = time.time() - tc
        launches = fused_resblock.launches
        tc = time.time()
        with torch.no_grad():
            want = efficient_generalized_steps(
                x, seq, lambda a, t: cpu(a, t, None), betas, cpu_op, y, SIGMA,
                noise=lambda shape: torch.zeros(shape), **kw)[0]
        cpu_s = time.time() - tc
        err = ((got - want).abs().max() / want.abs().max()).item()
        check(torch.isfinite(got).all().item(), f"{deg} chain: non-finite output")
        check(err <= DDRM_TOL, f"{deg} chain card vs CPU: {err} > {DDRM_TOL}")
        check(launches == len(seq) * BLOCKS * 2,
              f"{deg} chain resblock launches {launches} != {len(seq) * BLOCKS * 2}")
        runs[deg] = dict(t_start=t_start, forwards=len(seq), rel_err=err, card_s=card_s,
                         plain_path_cpu_s=cpu_s, resblock_launches=launches)
    phase("ddrm_chain_vs_plain", t0, blocks=BLOCKS, features=FEATURES, batch=DDRM_CHAIN_BATCH,
          dtype="float32", sigma=SIGMA, tol_of_largest=DDRM_TOL, runs=runs, card=card)


def inference_cli_ddrm(dev, card):
    """Drive the port's -u 1 CLI (`inference_torch.Inference`, condition=True)
    on the card over the 120-patch synthetic cell, fp32, batch 64: deno with
    --t-start auto (28 forwards a batch) and inp_mask with --sampling-steps
    10 (a null space: the full grid of 10), seeded random unconditional
    weights through the port's checkpoint writer. Checks the quartet, finite
    predictions, the metrics and the launch counters. Returns the deno run's
    launch counts."""
    import inference_torch
    from hicdiff_tpu_torch.convert import params_to_jax
    from hicdiff_tpu_torch.kernels.resblock import fused_resblock
    from hicdiff_tpu_torch.kernels.sample_step import fused_posterior_step
    from hicdiff_tpu_torch.models.hicedrn import HicedrnDiff
    from hicdiff_tpu_torch.train.checkpoint import save_checkpoint

    t0 = time.time()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="smoke_ddrm_", dir=os.path.join(ROOT, "build"))
    counts = {}
    try:
        for deg in ("deno", "inp_mask"):
            write_synthetic_cell(
                root, lambda c: CLI_TEST_BINS if c in CLI_TEST_CHROMS else CLI_OTHER_BINS,
                deg=deg)
        model = HicedrnDiff(self_condition=False, number_resnet=BLOCKS, features=FEATURES,
                            device="cpu", generator=torch.Generator().manual_seed(7))
        ckpt = os.path.join(root, "Model_Weights", "uncond.msgpack")
        save_checkpoint(ckpt, params_to_jax(model.state_dict()), run_config=dict(
            sigma=SIGMA, schedule="linear", mode="uncond", timestep=1000, percentile=99.0))
        del model
        prep_s = time.time() - t0
        kw = dict(batch_size=CLI_BATCH, cellNo=1, cell_Line="Human", sigma_t=SIGMA,
                  condition=True, root=root, schedule="linear", timestep=1000, weights=ckpt,
                  blocks=BLOCKS, features=FEATURES)
        os.environ["HICDIFF_EVAL_TIMING"] = "1"
        for deg, extra, forwards, tag in (
                ("deno", dict(t_start="auto"), 28, "_trans2_1000_ts27"),
                ("inp_mask", dict(sampling_steps=10), 10, "_trans2_1000")):
            fused_resblock.launches = 0
            fused_posterior_step.launches = 0
            tr = time.time()
            with timed_run({}) as run_p:
                res = inference_torch.Inference(device=dev, deg=deg, **kw, **extra)
            wall_s = run_p["wall_s"]
            resblock_launches = fused_resblock.launches
            step_launches = fused_posterior_step.launches
            n = len(res["inds"])
            batches = -(-n // CLI_BATCH)
            want = batches * forwards * BLOCKS * 2
            check(n == len(CLI_TEST_CHROMS) * 30, f"inference_cli_ddrm {deg}: {n} test patches")
            check(resblock_launches == want,
                  f"inference_cli_ddrm {deg} resblock launches {resblock_launches} != {want}")
            check(step_launches == 0, f"inference_cli_ddrm {deg}: {step_launches} posterior steps")
            check(os.path.basename(res["outdir"]) == f"hicedrn_l2_linHuman1_{deg}_{SIGMA}{tag}",
                  f"inference_cli_ddrm {deg}: outdir {res['outdir']}")
            for what in ("target", "noisy", "predict", "inds"):
                check(os.path.exists(os.path.join(res["outdir"], f"{what}.npy")),
                      f"inference_cli_ddrm {deg}: no {what}.npy")
            pred = np.load(os.path.join(res["outdir"], "predict.npy"))
            check(pred.shape == (n, 1, 64, 64) and np.isfinite(pred).all(),
                  f"inference_cli_ddrm {deg}: predict {pred.shape} not finite")
            metrics = res["metrics"]
            check(len(metrics) == 7 and all(np.isfinite(v) for v in metrics.values()),
                  f"inference_cli_ddrm {deg} metrics: {metrics}")
            tm = res["timing"]
            phase("inference_cli_ddrm", t0 if deg == "deno" else tr, run=deg, dtype="float32",
                  sigma=SIGMA, forwards=forwards, blocks=BLOCKS, features=FEATURES,
                  batch=CLI_BATCH, patches=n, batches=batches,
                  cut=f"data scale only: {len(CLI_TEST_CHROMS)} test chromosomes of "
                      f"{CLI_TEST_BINS} bins, the rest {CLI_OTHER_BINS}; full width and depth",
                  prep_s=prep_s, run_wall_s=wall_s, patches_per_s=n / wall_s,
                  setup_s=tm["setup"], dispatch_s=tm["dispatch"], fetch_s=tm["fetch"],
                  metrics_s=tm["metrics"], save_s=tm["save"],
                  fetch_s_per_batch=tm["fetch_per_batch"],
                  resblock_launches=resblock_launches, posterior_step_launches=step_launches,
                  metrics=metrics, predict_abs_max=float(np.abs(pred).max()), card=card)
            counts[deg] = dict(resblock_launches=resblock_launches, step_launches=step_launches)
            if deg == "deno":  # the -u 1 default with --bf16
                cli_bf16_run("inference_cli_ddrm", deg, dev, card, dict(deg=deg, **kw, **extra),
                             counts[deg])
    finally:
        os.environ.pop("HICDIFF_EVAL_TIMING", None)
        shutil.rmtree(root, ignore_errors=True)
    return counts["deno"]


def serve_ddrm(dev, card):
    """DenoiseService(mode='ddrm'), deno with t_start 'auto' (t* = 27, 28
    forwards a request): ping, 2 requests of BATCH patches and a profiled
    one, in fp32 and in bf16 (serve_and_profile). Then an inp_mask service
    answers one 2-D (BATCH, 2048) measurement request and refuses a
    (BATCH, 4096) one. Returns {dtype: what serve_and_profile measured}."""
    from hicdiff_tpu_torch.serve import DenoiseService

    served = {}
    for dtype, bf16 in (("float32", False), ("bfloat16", True)):
        t0 = time.time()
        service = DenoiseService(None, device=dev, mode="ddrm", deg="deno", sigma=SIGMA,
                                 t_start="auto", batch=BATCH, bf16=bf16, blocks=BLOCKS,
                                 features=FEATURES, seed=0)
        startup_s = time.time() - t0
        check(service.t_start == 27, f"ddrm t* at sigma=0.1: {service.t_start}")
        out = serve_and_profile(service, DDRM_REQUESTS, dtype, card)
        phase("serve_ddrm", t0, deg="deno", startup_s=startup_s, requests=DDRM_REQUESTS,
              patches_per_request=BATCH, blocks=BLOCKS, features=FEATURES, dtype=dtype,
              sigma=SIGMA, forwards=out["steps"], latency_s=out["latencies"],
              resblock_launches=out["resblock_launches"],
              posterior_step_launches=out["step_launches"],
              profiled_latency_s=out["profiled_s"], device_busy_ms=out["busy_ms"],
              idle_share_of_wall=out["idle_share_of_wall"], card=card)
        served[dtype] = out
        del service

    t0 = time.time()
    service = DenoiseService(None, device=dev, mode="ddrm", deg="inp_mask", sigma=SIGMA,
                             t_start="auto", sampling_steps=10, batch=BATCH, bf16=False,
                             blocks=BLOCKS, features=FEATURES, seed=0)
    check(service.t_start is None and service._meas_dim == 2048,
          f"inp_mask service: t_start {service.t_start}, width {service._meas_dim}")
    work = tempfile.mkdtemp(prefix="smoke_", dir=os.path.join(ROOT, "build"))
    try:
        src = os.path.join(work, "y.npy")
        rng = np.random.default_rng(3)
        np.save(src, rng.normal(0, 0.3, (BATCH, 2048)).astype(np.float32))
        tr = time.time()
        resp = service.handle({"id": 1, "op": "denoise", "npy": src})
        latency = time.time() - tr
        check(resp.get("ok"), f"inp_mask measurement request: {resp}")
        out = np.load(resp["out"])
        check(out.shape == (BATCH, 64, 64, 1) and np.isfinite(out).all(),
              f"inp_mask measurement request: {out.shape}")
        np.save(src, np.zeros((BATCH, 4096), np.float32))
        refused = service.handle({"id": 2, "op": "denoise", "npy": src})
        check(not refused.get("ok") and "dimension 2048, got 4096" in refused.get("error", ""),
              f"a (n, 4096) request to an inp_mask service: {refused}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    phase("serve_ddrm", t0, deg="inp_mask", forwards=10, request_shape=(BATCH, 2048),
          latency_s=latency, refused=refused["error"], card=card)
    return served


# ---- the diffusion-backbone zoo: the att and sr3 variants, the U-Nets, the
# sr3 engine, inference_torch.py --model and pretrain_torch.py

ZOO = ("hicedrn_att", "hicedrn_sr3", "unet", "unet_sr3")
ZOO_BF16_TOL = 2e-2  # bf16 hicedrn_sr3, card vs the plain bf16 forward, of its largest value


def _zoo_model(name, dev, seed, self_condition=True, dtype=None):
    from hicdiff_tpu_torch.models.zoo import DIFFUSION_BACKBONES

    return DIFFUSION_BACKBONES[name](self_condition, dtype, device=dev,
                                     generator=torch.Generator().manual_seed(seed))


def _zoo_inputs(name, b, g):
    """x, the self-conditioning patch and the time input (integer
    timesteps, or sr3 levels in (0, 1)) of a batch of b, on the CPU."""
    x = torch.randn(b, 64, 64, 1, generator=g) * 0.3
    cond = torch.randn(b, 64, 64, 1, generator=g) * 0.3
    time_in = (torch.rand(b, generator=g) * 0.98 + 0.01 if name.endswith("sr3")
               else torch.randint(0, 1000, (b,), generator=g))
    return x, time_in, cond


def _zoo_launches(name):
    """Conv-kernel launches of one forward: two a residual block."""
    return 2 * BLOCKS if name.startswith("hicedrn") else 0


def zoo_forward(dev, card):
    """Each backbone of the zoo at full width, self-conditioned, fp32:
    the card's forward against the same model's plain forward on the CPU
    (same weights, batch 8) within 1e-3 of the CPU's largest value; the
    conv-kernel launches of one forward by the counter; event ms at batch 8
    and 64. hicedrn_sr3 and hicedrn_att also in bf16 against the plain bf16
    forward on the CPU, within ZOO_BF16_TOL of its largest value (bf16 att:
    its 30 blocks after the first attention on the fp32 stream, mode 6 by
    the counter). Returns each model's launches a forward, and the bf16
    forwards' fp32-stream launches."""
    from hicdiff_tpu_torch.kernels.resblock import fused_resblock

    g = torch.Generator().manual_seed(11)
    launches, stream_launches = {}, {}
    for i, name in enumerate(ZOO):
        t0 = time.time()
        dtypes = (None, torch.bfloat16) if name in ("hicedrn_sr3", "hicedrn_att") else (None,)
        row = {}
        x, t_in, c = _zoo_inputs(name, BATCH, g)
        big = [a.to(dev) for a in _zoo_inputs(name, CLI_BATCH, g)]
        for dt in dtypes:
            tag = "" if dt is None else "_bf16"
            gpu = _zoo_model(name, dev, 20 + i, dtype=dt)
            cpu = _zoo_model(name, "cpu", 20 + i, dtype=dt)
            args = [a.to(dev) for a in (x, t_in, c)]
            with torch.no_grad():
                fused_resblock.launches = fused_resblock.stream_launches = 0
                got = gpu(*args)
                torch.cuda.synchronize()
                count, stream = fused_resblock.launches, fused_resblock.stream_launches
                tc = time.time()
                want = cpu(x, t_in, c)
                cpu_s = time.time() - tc
                got = got.cpu()
                err, scale = (got - want).abs().max().item(), want.abs().max().item()
                tol = 1e-3 if dt is None else ZOO_BF16_TOL
                check(got.shape == STEP_SHAPE and torch.isfinite(got).all().item(),
                      f"zoo_forward {name}{tag}: output {tuple(got.shape)} not finite")
                check(err <= tol * scale,
                      f"zoo_forward {name}{tag}: max-abs {err} > {tol} * {scale}")
                check(count == _zoo_launches(name),
                      f"zoo_forward {name}{tag}: {count} conv-kernel launches a forward")
                want_stream = BLOCKS - 2 if dt is not None and name == "hicedrn_att" else 0
                check(stream == want_stream,
                      f"zoo_forward {name}{tag}: {stream} fp32-stream launches a forward")
                ms8 = cuda_ms(lambda: gpu(*args), iters=3, reps=1, warmup=1)
                ms64 = cuda_ms(lambda: gpu(*big), iters=1, reps=1, warmup=1)
                # the host's enqueue of one batch-8 forward: above ms8 = host-bound
                host8 = host_us(lambda: gpu(*args), iters=3, reps=1) / 1e3
                if dt is None:
                    want32 = want
                else:  # how far bf16 lies from fp32 here, beside the bar
                    row["plain_bf16_vs_fp32_max_abs"] = (want - want32).abs().max().item()
            if dt is None:
                row["params"] = sum(p.numel() for p in cpu.parameters())
            row.update({f"max_abs_err{tag}": err, f"plain_abs_max{tag}": scale,
                        f"tol_of_largest{tag}": tol, f"conv_launches_per_forward{tag}": count,
                        f"conv_f32_stream_launches_per_forward{tag}": stream,
                        f"ms_batch8{tag}": ms8, f"ms_batch64{tag}": ms64,
                        f"host_enqueue_ms_batch8{tag}": host8,
                        f"plain_path_cpu_s{tag}": cpu_s})
            del gpu, cpu
        launches[name] = row["conv_launches_per_forward"]
        if "conv_f32_stream_launches_per_forward_bf16" in row:
            stream_launches[name] = row["conv_f32_stream_launches_per_forward_bf16"]
        phase("zoo_forward", t0, model=name, self_condition=True, shape=STEP_SHAPE,
              batch_64=CLI_BATCH, dtype="float32" + (" and bfloat16" if len(dtypes) > 1 else ""),
              **row, card=card)
    return launches, stream_launches


def inference_cli_zoo(dev, card):
    """Drive `inference_torch.Inference` with --model on the card over the
    inference_cli phase's 120-patch synthetic cell, fp32, batch 64, each
    backbone's seeded random weights written by the port's codec in the JAX
    layout under the tag the CLI looks for (no --weights), each chain cut to
    ZOO_CLI_FORWARDS forwards: -u 0 hicedrn_sr3 (the sr3 engine's truncated
    ancestral chain), -u 0 unet (the cond engine's chain), -u 1 hicedrn_att
    (DDRM deno, t* auto on the cut grid). Each: the quartet, the metrics,
    the launch counters and the wall. Last, a deterministic -u 0 hicedrn_sr3 run
    (DDIM, 2 steps) held to the CPU plain path on 16 patches. Returns the
    launch counts of each run."""
    import inference_torch
    from hicdiff_tpu_torch.convert import params_to_jax
    from hicdiff_tpu_torch.diffusion.gaussian import GaussianDiffusion
    from hicdiff_tpu_torch.kernels.resblock import fused_resblock
    from hicdiff_tpu_torch.kernels.sample_step import fused_posterior_step
    from hicdiff_tpu_torch.train.checkpoint import checkpoint_name, save_checkpoint

    t0 = time.time()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="smoke_zoo_", dir=os.path.join(ROOT, "build"))
    counts = {}
    # (model, -u, mode, schedule, extra, forwards a batch): each chain cut to
    # ZOO_CLI_FORWARDS (depth): -u 0 from t = ZOO_CLI_FORWARDS - 1, -u 1 DDRM
    # deno at t* auto on a grid of ZOO_CLI_FORWARDS
    runs = (
        ("hicedrn_sr3", 0, "sr3", "sigmoid", dict(t_start=ZOO_CLI_FORWARDS - 1),
         ZOO_CLI_FORWARDS),
        ("unet", 0, "cond", "sigmoid", dict(t_start=ZOO_CLI_FORWARDS - 1), ZOO_CLI_FORWARDS),
        ("hicedrn_att", 1, "uncond", "linear",
         dict(deg="deno", t_start="auto", sampling_steps=ZOO_CLI_FORWARDS), ZOO_CLI_FORWARDS),
    )
    # the registry's other --model paths, each once at 2 sampling steps
    short = (("hicedrn_att", 0, "cond", "sigmoid"), ("unet_sr3", 0, "sr3", "sigmoid"),
             ("unet", 1, "uncond", "linear"))
    try:
        write_synthetic_cell(
            root, lambda c: CLI_TEST_BINS if c in CLI_TEST_CHROMS else CLI_OTHER_BINS)
        for i, (name, u, mode, schedule) in enumerate([r[:4] for r in runs] + list(short)):
            model = _zoo_model(name, "cpu", 30 + i, self_condition=mode != "uncond")
            ckpt = os.path.join(root, "Model_Weights", checkpoint_name(
                "bestg", 40000, 64, "Human", 1, f"{name}_{mode}_linear_l2_{schedule[:3]}"))
            save_checkpoint(ckpt, params_to_jax(model.state_dict()), run_config=dict(
                sigma=SIGMA, schedule=schedule, mode=mode, timestep=1000, percentile=99.0))
            del model
        prep_s = time.time() - t0
        os.environ["HICDIFF_EVAL_TIMING"] = "1"
        for name, u, mode, schedule, extra, forwards in runs:
            tr = time.time()
            kw = dict(batch_size=CLI_BATCH, cellNo=1, cell_Line="Human", sigma_t=SIGMA,
                      condition=bool(u), root=root, schedule=schedule, timestep=1000,
                      model_name=name, **extra)
            fused_resblock.launches = 0
            fused_posterior_step.launches = 0
            with timed_run({}) as run_p:
                res = inference_torch.Inference(device=dev, **kw)
            wall_s = run_p["wall_s"]
            resblock_launches, step_launches = (fused_resblock.launches,
                                                fused_posterior_step.launches)
            n = len(res["inds"])
            batches = -(-n // CLI_BATCH)
            want_conv = batches * forwards * _zoo_launches(name)
            want_steps = 0 if u else batches * forwards
            run = f"u{u}_{name}"
            check(n == len(CLI_TEST_CHROMS) * 30, f"inference_cli_zoo {run}: {n} test patches")
            check(resblock_launches == want_conv,
                  f"inference_cli_zoo {run}: resblock launches {resblock_launches} != {want_conv}")
            check(step_launches == want_steps,
                  f"inference_cli_zoo {run}: posterior-step launches {step_launches} != "
                  f"{want_steps}")
            pred = np.load(os.path.join(res["outdir"], "predict.npy"))
            check(pred.shape == (n, 1, 64, 64) and np.isfinite(pred).all()
                  and (u or np.abs(pred).max() <= 1.0),
                  f"inference_cli_zoo {run}: predict {pred.shape} not finite or out of range")
            metrics = res["metrics"]
            check(len(metrics) == 7 and all(np.isfinite(v) for v in metrics.values()),
                  f"inference_cli_zoo {run} metrics: {metrics}")
            tm = res["timing"]
            phase("inference_cli_zoo", tr if counts else t0, run=run, model=name, mode=mode,
                  dtype="float32", sigma=SIGMA, forwards=forwards, batch=CLI_BATCH, patches=n,
                  batches=batches, outdir=os.path.basename(res["outdir"]),
                  cut=f"{len(CLI_TEST_CHROMS)} test chromosomes of {CLI_TEST_BINS} bins, the "
                      f"rest {CLI_OTHER_BINS}; the registry's widths; the chain's depth "
                      f"{ZOO_CLI_FORWARDS} forwards",
                  prep_s=prep_s, run_wall_s=wall_s, patches_per_s=n / wall_s,
                  setup_s=tm["setup"], dispatch_s=tm["dispatch"], fetch_s=tm["fetch"],
                  metrics_s=tm["metrics"], save_s=tm["save"],
                  resblock_launches=resblock_launches, posterior_step_launches=step_launches,
                  metrics=metrics, card=card)
            counts[run] = dict(resblock_launches=resblock_launches, step_launches=step_launches)

        # deterministic: -u 0 hicedrn_sr3, DDIM eta 0, 2 steps, against the CPU plain path
        tr = time.time()
        res2 = inference_torch.Inference(
            device=dev, batch_size=CLI_BATCH, cellNo=1, cell_Line="Human", sigma_t=SIGMA,
            condition=False, root=root, schedule="sigmoid", timestep=1000, t_start="auto",
            model_name="hicedrn_sr3", sampling_steps=2, out_tag="_ddim2")
        n = len(res2["inds"])
        picked = np.r_[np.arange(8), np.linspace(8, n - 1, CLI_COMPARED - 8).round().astype(int)]
        got = np.load(os.path.join(res2["outdir"], "predict.npy"))[picked]
        noisy = np.load(os.path.join(res2["outdir"], "noisy.npy"))[picked]
        card_s = time.time() - tr
        cpu = _zoo_model("hicedrn_sr3", "cpu", 30)  # the checkpoint's weights
        cpu.eval()
        engine = GaussianDiffusion.create(cpu, device="cpu", timesteps=1000, mode="sr3",
                                          beta_schedule="sigmoid", sampling_timesteps=2)
        engine = dataclasses.replace(engine, t_start=engine.truncation_timestep(SIGMA))
        tc = time.time()
        want = engine.super_resolution(torch.from_numpy(noisy.transpose(0, 2, 3, 1)),
                                       torch.Generator().manual_seed(0))
        cpu_s = time.time() - tc
        err = float(np.abs(got - want.numpy().transpose(0, 3, 1, 2)).max())
        check(err <= 1e-3, f"inference_cli_zoo deterministic sr3 run: max-abs {err} > 1e-3")
        phase("inference_cli_zoo", tr, run="u0_hicedrn_sr3_ddim2_deterministic", patches=n,
              card_run_s=card_s, compared_patches=picked.tolist(), max_abs_err=err, tol=1e-3,
              plain_path_cpu_s=cpu_s, card=card)

        # every other (model, -u) the registry offers: 2 sampling steps (DDIM on
        # -u 0, DDRM's 0, 14, 27 on -u 1); the sr3 backbones exit on -u 1
        tr = time.time()
        short_runs = {}
        for name, u, _, schedule in short:
            fused_resblock.launches = 0
            res = inference_torch.Inference(
                device=dev, batch_size=CLI_BATCH, cellNo=1, cell_Line="Human", sigma_t=SIGMA,
                condition=bool(u), root=root, schedule=schedule, timestep=1000,
                t_start="auto", model_name=name, sampling_steps=2, compute_metrics=False,
                out_tag="_short")
            torch.cuda.synchronize()
            pred = np.asarray(res["predict"])
            forwards = 3 if u else 2
            want_conv = -(-len(pred) // CLI_BATCH) * forwards * _zoo_launches(name)
            check(pred.shape == (n, 64, 64, 1) and np.isfinite(pred).all(),
                  f"inference_cli_zoo u{u}_{name}: predict {pred.shape} not finite")
            check(fused_resblock.launches == want_conv,
                  f"inference_cli_zoo u{u}_{name}: {fused_resblock.launches} conv launches")
            short_runs[f"u{u}_{name}"] = dict(forwards=forwards, conv_launches=want_conv,
                                              predict_abs_max=float(np.abs(pred).max()))
        for name in ("hicedrn_sr3", "unet_sr3"):
            try:
                inference_torch.Inference(device=dev, condition=True, root=root,
                                          model_name=name)
                check(False, f"inference_cli_zoo u1_{name} ran; it must exit as inference.py")
            except SystemExit as exc:
                short_runs[f"u1_{name}"] = dict(exit=str(exc.code))
        phase("inference_cli_zoo", tr, run="other_models_2_steps", runs=short_runs, card=card)
    finally:
        os.environ.pop("HICDIFF_EVAL_TIMING", None)
        shutil.rmtree(root, ignore_errors=True)
    return counts


def pretrain_zoo(dev, card, bf16=False):
    """`pretrain_torch.py` for one epoch at batch 64 on the train phase's
    synthetic cell (population module, 99.0 percentile: 210 train patches, 12
    val), fp32 or (bf16) with --bf16: --model hicedrn_sr3 --engine sr3,
    --model hicedrn_att --engine uncond --data pure_noise, --model unet
    --engine cond. Each run: the launch counters (bf16 hicedrn_att: its 30
    blocks after the first attention in the fp32-stream modes 6 and 7), each
    step's time split by CUDA events, peak memory, the checkpoints by
    pretrain.py's names. Returns each run's launches."""
    import pretrain_torch
    from hicdiff_tpu_torch.data.datamodule import HUMAN_SPLITS
    from hicdiff_tpu_torch.train.trainer import Trainer

    class TimedTrainer(Trainer):  # the trainer pretrain_torch builds, its steps timed
        runs = []

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.time_steps = True
            TimedTrainer.runs.append(self)

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="smoke_pretrain_", dir=os.path.join(ROOT, "build"))
    counters = _launch_counts()
    out = {}
    split_of = {c: k for k, cs in HUMAN_SPLITS.items() for c in cs}
    pretrain_torch.Trainer = TimedTrainer
    try:
        for marker in ("", "_pure_noise"):
            write_synthetic_cell(root, lambda c: TRAIN_BINS[split_of[c]], marker=marker)
        for name, engine, data in (("hicedrn_sr3", "sr3", "linear"),
                                   ("hicedrn_att", "uncond", "pure_noise"),
                                   ("unet", "cond", "linear")):
            t0 = time.time()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for counter in counters.values():
                counter.launches = 0
            for counter in (counters["fused_resblock"], counters["fused_resblock_dgrad"]):
                counter.stream_launches = 0
                counter.mode_launches.clear()
            trainer = pretrain_torch.main([
                "--model", name, "--engine", engine, "--data", data, "-e", "1",
                "-b", str(TRAIN_BATCH), "-s", str(SIGMA), "--root", root, "--ckpt-throttle", "0",
                *(["--bf16"] if bf16 else []), "--device", str(dev)])
            torch.cuda.synchronize()
            wall_s = time.time() - t0
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            launches = {k: v.launches for k, v in counters.items()}
            launches["fused_resblock_f32_stream"] = counters["fused_resblock"].stream_launches
            launches["fused_resblock_dgrad_f32_stream"] = (
                counters["fused_resblock_dgrad"].stream_launches)
            check(trainer is TimedTrainer.runs[-1], "pretrain_zoo: the run's trainer")
            check(trainer.model.dtype == (torch.bfloat16 if bf16 else None),
                  f"pretrain_zoo {name}: dtype {trainer.model.dtype}")
            steps = len(trainer.step_events)
            val_batches = 1  # 12 val patches
            per_block = BLOCKS if name.startswith("hicedrn") else 0
            # bf16 att: every block after the first attention is on the fp32 stream
            stream = BLOCKS - 2 if bf16 and name == "hicedrn_att" else 0
            want = {"fused_resblock": (steps + val_batches) * 2 * per_block,
                    "fused_resblock_dgrad": steps * 2 * per_block,
                    "resblock_wgrad": steps * per_block,
                    "resblock_channel_sums": steps * per_block,
                    "fused_resblock_f32_stream": (steps + val_batches) * stream,
                    "fused_resblock_dgrad_f32_stream": steps * stream}
            run = f"{name}_{engine}_{data}" + ("_bf16" if bf16 else "")
            check(steps == 4, f"pretrain_zoo {run}: {steps} steps")
            check(launches == want, f"pretrain_zoo {run} launches {launches} != {want}")
            launches["fused_resblock_train"] = 2 * counters["fused_resblock"].mode_launches[3]
            record = trainer.history[0]
            check(np.isfinite([record["train/loss"], record["valid/loss"]]).all(),
                  f"pretrain_zoo {run} losses {record}")
            tag = f"{name}_{engine}_{data}_l2_lin"
            names = sorted(os.listdir(os.path.join(root, "Model_Weights")))
            check(all(f"{k}_40000_c64_s64_Human1_{tag}.msgpack" in names
                      for k in ("bestg", "finalg")), f"pretrain_zoo {run} checkpoints {names}")
            times = trainer.step_times_ms()
            full = times[:-1]  # the last step is the ragged batch
            phase("pretrain_zoo", t0, run=run, model=name, engine=engine, data=data,
                  dtype="bfloat16" if bf16 else "float32", batch=TRAIN_BATCH, steps=steps, tag=tag, wall_s=wall_s,
                  epoch_s=record["epoch_seconds"], train_loss=record["train/loss"],
                  valid_loss=record["valid/loss"], step_ms=[sum(t) for t in times],
                  forward_ms=[t[0] for t in times], backward_ms=[t[1] for t in times],
                  update_ms=[t[2] for t in times],
                  full_step_ms_mean=float(np.mean([sum(t) for t in full])),
                  steady_step_ms_mean=float(np.mean([sum(t) for t in full[1:]])),
                  peak_memory_gb=peak_gb, launches=launches,
                  cut="data scale only: 14 train chromosomes of 320 bins; the registry's "
                      "widths", card=card)
            out[run] = launches
            del trainer
            TimedTrainer.runs.clear()
    finally:
        pretrain_torch.Trainer = Trainer
        shutil.rmtree(root, ignore_errors=True)
    return out


def zoo(dev, card):
    """The zoo's phases, in order; returns what the kernels line reads."""
    forward, forward_stream = zoo_forward(dev, card)
    cli = inference_cli_zoo(dev, card)
    pretrain = pretrain_zoo(dev, card)
    train_step_vs_plain(dev, card, "hicedrn_sr3", "sr3", "zoo_step_vs_plain")
    train_step_vs_plain(dev, card, "hicedrn_att", "cond", "zoo_step_vs_plain")
    # bf16 training of the zoo: pretrain_torch.py --bf16, and sr3 and att
    # steps card against CPU in bf16
    pretrain_bf16 = pretrain_zoo(dev, card, bf16=True)
    train_step_vs_plain(dev, card, "hicedrn_sr3", "sr3", "zoo_step_vs_plain", bf16=True)
    train_step_vs_plain(dev, card, "hicedrn_att", "cond", "zoo_step_vs_plain", bf16=True)
    return dict(forward=forward, forward_stream=forward_stream, cli=cli, pretrain=pretrain,
                pretrain_bf16=pretrain_bf16)


# the baselines' synthetic cell: the train phase's train and val
# chromosomes (210 train patches, 12 val) and the CLI cell's test ones (120)
BASELINE_BINS = {"train": TRAIN_BINS["train"], "val": TRAIN_BINS["val"], "test": CLI_TEST_BINS}
BASELINE_TOL = 1e-3  # card vs CPU, of the CPU's largest value (TF32 off)
BASELINE_STEP_BATCH = 3  # two real samples and a wrap-padded repeat, on card and CPU


def _baseline_rows():
    """(row, ctor(device=, generator=), input size) of every baseline module
    at the size the JAX registry builds it: the six table baselines,
    hiedsrgan's generator, the three critics and the perceptual VGG19."""
    from hicdiff_tpu_torch.metrics.losses import VGGFeatures
    from hicdiff_tpu_torch.models import baselines
    from hicdiff_tpu_torch.models.zoo import BASELINES, TABLE_BASELINES

    rows = [(n, BASELINES[n][0], 76 if BASELINES[n][1] else 64)
            for n in (*TABLE_BASELINES, "hiedsrgan")]
    rows += [(n, getattr(baselines, n), 64)
             for n in ("DeepHiCDiscriminator", "HiCSRDiscriminator", "HiedsrDiscriminator")]
    return rows + [("VGGFeatures", VGGFeatures, 64)]


def _port_kernel_launches():
    """Every launch counter of the port's kernels, summed."""
    from hicdiff_tpu_torch.kernels.sample_step import fused_posterior_step

    return sum(c.launches for c in (*_launch_counts().values(), fused_posterior_step))


def baselines_forward(dev, card):
    """Phase `baselines_forward`: each baseline module at its published
    width and depth, seeded on the CPU and copied to the card, eval mode:
    the card's forward at batch 8 against the CPU's within BASELINE_TOL of
    the CPU's largest value, then CUDA-event ms at batch 64. They are plain
    PyTorch (cuDNN convs): no port kernel launches. Returns ms by row."""
    g = torch.Generator().manual_seed(21)
    out = {}
    for i, (name, ctor, size) in enumerate(_baseline_rows()):
        t0 = time.time()
        launched = _port_kernel_launches()
        cpu = ctor(device="cpu", generator=torch.Generator().manual_seed(100 + i))
        gpu = copy.deepcopy(cpu).to(dev)
        x8 = torch.rand(8, size, size, 1, generator=g) * 2 - 1
        x64 = (torch.rand(64, size, size, 1, generator=g) * 2 - 1).to(dev)
        with torch.no_grad():
            tc = time.time()
            want = cpu(x8)
            cpu_s = time.time() - tc
            got = gpu(x8.to(dev)).cpu()
            check(got.shape == want.shape and torch.isfinite(got).all().item(),
                  f"baselines_forward {name}: output {tuple(got.shape)}")
            err, scale = (got - want).abs().max().item(), want.abs().max().item()
            check(err <= BASELINE_TOL * scale,
                  f"baselines_forward {name}: max-abs {err} > {BASELINE_TOL} x {scale}")
            heavy = type(cpu).__name__ == "HicedrnGenerator"  # 66 convs at 256 channels
            ms = cuda_ms(lambda: gpu(x64), iters=1 if heavy else 5, reps=1, warmup=1)
        check(_port_kernel_launches() == launched, f"baselines_forward {name}: a port kernel ran")
        phase("baselines_forward", t0, model=name, cls=type(cpu).__name__,
              params=sum(p.numel() for p in cpu.parameters()), shape_batch8=tuple(x8.shape),
              out_shape=tuple(want.shape), max_abs_err=err, cpu_largest=scale,
              tol_of_largest=BASELINE_TOL, plain_cpu_s_batch8=cpu_s, ms_batch64=ms,
              dtype="float32", card=card)
        out[name] = ms
        del cpu, gpu, x64
    return out


def pretrain_baselines(dev, card, root):
    """Phase `pretrain_baselines`: pretrain_baselines_torch.py on the card,
    `--models hiedsr hicarn deephic hicsr unet hicplus -e 1`, then
    `--models hiedsrgan -e 1` at 32 blocks, batch 16 (the default) on the
    baselines' cell: each step timed by CUDA events (its l2_step or
    gan_step), the epoch's seconds and losses from the JSONL log, peak
    memory per model, the checkpoints by their names, no port kernel."""
    import pretrain_baselines_torch as pt
    from hicdiff_tpu_torch.models.zoo import TABLE_BASELINES

    steps, peaks, train_s, current = defaultdict(list), {}, {}, {}
    originals = {k: getattr(pt, k) for k in ("l2_step", "gan_step", "train_one",
                                              "train_hiedsrgan")}

    def timed_step(fn):
        def step(*args, **kwargs):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            result = fn(*args, **kwargs)
            end.record()
            steps[current["name"]].append((start, end))
            return result
        return step

    def peak_of(fn, name_of):
        def run(*args, **kwargs):
            current["name"] = name_of(args)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t = time.time()
            result = fn(*args, **kwargs)
            torch.cuda.synchronize()
            train_s[current["name"]] = time.time() - t
            peaks[current["name"]] = torch.cuda.max_memory_allocated() / 1e9
            return result
        return run

    pt.l2_step = timed_step(originals["l2_step"])
    pt.gan_step = timed_step(originals["gan_step"])
    pt.train_one = peak_of(originals["train_one"], lambda args: args[0])
    pt.train_hiedsrgan = peak_of(originals["train_hiedsrgan"], lambda args: "hiedsrgan")
    t0 = time.time()
    launched = _port_kernel_launches()
    common = ["-e", "1", "-s", str(SIGMA), "--root", root, "--device", str(dev)]
    try:
        results = pt.main(["--models", *TABLE_BASELINES, *common])
        results.update(pt.main(["--models", "hiedsrgan", *common]))
    finally:
        for k, fn in originals.items():
            setattr(pt, k, fn)
    torch.cuda.synchronize()
    check(_port_kernel_launches() == launched, "pretrain_baselines: a port kernel ran")
    records = [json.loads(line) for line in
               open(os.path.join(root, "logs", "pretrain_baselines_cell1.jsonl"))]
    for name in (*TABLE_BASELINES, "hiedsrgan"):
        path, best = results[name]
        check(os.path.exists(path) and np.isfinite(best), f"pretrain_baselines {name}: {path}")
        epoch = next(r for r in records if r["model"] == name and r["Epoch"] == 1)
        losses = {k: v for k, v in epoch.items() if "loss" in k}
        check(all(np.isfinite(v) for v in losses.values()), f"pretrain_baselines {name} {losses}")
        recal = [r["valid/loss"] for r in records if r["model"] == name
                 and r["Epoch"] == "recalibrated"]
        step_ms = [a.elapsed_time(b) for a, b in steps[name]]
        check(len(step_ms) == 14, f"pretrain_baselines {name}: {len(step_ms)} steps")
        phase("pretrain_baselines", t0, model=name, batch=16, steps=len(step_ms),
              step_ms=step_ms, steady_step_ms_mean=float(np.mean(step_ms[1:-1])),
              epoch_s=epoch["epoch_seconds"], train_s=train_s[name],
              peak_memory_gb=peaks[name], **losses,
              recalibrated_valid_loss=recal[0] if recal else None, best_valid_loss=best,
              checkpoint_bytes=os.path.getsize(path),
              cut="data scale only: 14 train chromosomes of 320 bins; the registry's widths",
              card=card)
    return results


def baseline_step_vs_plain(dev, card):
    """Phase `baseline_step_vs_plain`: one pretrain_baselines_torch step of
    each table baseline (l2_step) and of hiedsrgan (gan_step, srgan critic)
    on the card and on the CPU, from the same seeded weights and the same
    wrap-padded batch of BASELINE_STEP_BATCH: the losses within 1e-4
    relative, every BatchNorm running statistic within 1e-5 of its tensor's
    largest value."""
    import pretrain_baselines_torch as pt
    from hicdiff_tpu_torch.metrics.losses import VGGFeatures
    from hicdiff_tpu_torch.models.baselines import HiedsrDiscriminator
    from hicdiff_tpu_torch.models.hicedrn import HicedrnGenerator
    from hicdiff_tpu_torch.models.zoo import BASELINES, TABLE_BASELINES

    def stats(model):
        return {k: v.cpu() for k, v in model.state_dict().items()
                if k.endswith(("running_mean", "running_var"))}

    g = torch.Generator().manual_seed(31)
    for i, name in enumerate((*TABLE_BASELINES, "hiedsrgan")):
        t0 = time.time()
        x = (torch.rand(2, 64, 64, 1, generator=g) * 2 - 1).numpy()
        y = np.clip(x + 0.1 * torch.randn(x.shape, generator=g).numpy(), -1, 1)
        (x, y), w = pt.wrap_pad((x, y), BASELINE_STEP_BATCH)
        seed = torch.Generator().manual_seed(200 + i)
        if name == "hiedsrgan":
            cpu_models = (HicedrnGenerator(device="cpu", generator=seed),
                          HiedsrDiscriminator(device="cpu", generator=seed),
                          VGGFeatures(device="cpu", generator=seed))
        else:
            cpu_models = (BASELINES[name][0](device="cpu", generator=seed),)
        card_models = tuple(copy.deepcopy(m).to(dev) for m in cpu_models)
        out, seconds = [], []
        for models, d in ((card_models, dev), (cpu_models, "cpu")):
            xs, ys, ws = (torch.from_numpy(np.ascontiguousarray(a)).to(d) for a in (x, y, w))
            tc = time.time()
            if name == "hiedsrgan":
                gen, disc, vgg = models
                vgg.requires_grad_(False)
                g_loss, d_loss, parts = pt.gan_step(
                    gen, disc, vgg, pt.adam(gen.parameters(), 1e-4),
                    pt.adam(disc.parameters(), 1e-4), xs, ys, ws)
                losses = [g_loss.item(), d_loss.item(), *(p.item() for p in parts)]
                bn = stats(disc)
            else:
                model = models[0]
                prep, prep_target = pt.prep_fns(name)
                losses = [pt.l2_step(model, pt.adam(model.parameters(), 1e-4), prep(xs),
                                     prep_target(ys), ws, pt.HAS_BN[name]).item()]
                bn = stats(model)
            seconds.append(time.time() - tc)
            out.append((losses, bn))
        (card_losses, card_bn), (cpu_losses, cpu_bn) = out
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(card_losses, cpu_losses))
        check(loss_rel <= 1e-4, f"baseline_step_vs_plain {name}: losses {card_losses} vs "
                                f"{cpu_losses}")
        stats_err = max([(card_bn[k] - v).abs().max().item() / v.abs().max().item()
                         for k, v in cpu_bn.items()], default=0.0)
        check(stats_err <= 1e-5, f"baseline_step_vs_plain {name}: running stats {stats_err}")
        phase("baseline_step_vs_plain", t0, model=name, batch=BASELINE_STEP_BATCH,
              mask=w.tolist(), losses_card=card_losses, losses_cpu=cpu_losses,
              loss_rel_err=loss_rel, loss_tol_rel=1e-4, bn_tensors=len(cpu_bn),
              bn_stats_err_of_largest=stats_err, bn_tol=1e-5, card_step_s=seconds[0],
              plain_cpu_step_s=seconds[1], card=card)


def stard_metric_normal(dev, card, root):
    """Phase `stard_metric_normal`: sample/stard_metric_normal_torch.py on
    the card over the baselines' cell's 120-patch test split with the
    checkpoints pretrain_baselines wrote: each model's checkpoint found,
    its prediction quartet finite, its seven metrics finite, the table
    written; the wall time and the harness's split."""
    import sample.stard_metric_normal_torch as smn
    from hicdiff_tpu_torch.models.zoo import TABLE_BASELINES

    t0 = time.time()
    launched = _port_kernel_launches()
    results = smn.main(["-n", "1", "-l", "Human", "-s", str(SIGMA), "--root", root,
                        "--device", str(dev)])
    torch.cuda.synchronize()
    wall_s = time.time() - t0
    check(_port_kernel_launches() == launched, "stard_metric_normal: a port kernel ran")
    per_model = {}
    for name in TABLE_BASELINES:
        res, had = results[name]
        pred = np.load(os.path.join(res["outdir"], "predict.npy"))
        check(had, f"stard_metric_normal {name}: no checkpoint")
        check(pred.shape == (len(CLI_TEST_CHROMS) * 30, 1, 64, 64) and np.isfinite(pred).all(),
              f"stard_metric_normal {name}: predict {pred.shape}")
        check(len(res["metrics"]) == 7 and all(np.isfinite(v) for v in res["metrics"].values()),
              f"stard_metric_normal {name}: metrics {res['metrics']}")
        tm = res["timing"]
        per_model[name] = dict(metrics=res["metrics"], setup_s=tm["setup"],
                               dispatch_s=tm["dispatch"], fetch_s=tm["fetch"],
                               metrics_s=tm["metrics"], save_s=tm["save"])
    table = open(os.path.join(root, "Metrics", f"Human1_deno_{SIGMA}_normal.txt")).read()
    check(all(f"\n{n}\n" in table for n in TABLE_BASELINES) and table.count("gds:") == 6,
          "stard_metric_normal: the Metrics table")
    phase("stard_metric_normal", t0, wall_s=wall_s, patches=len(CLI_TEST_CHROMS) * 30,
          batch=64, models=per_model, card=card)
    return wall_s


def baselines(dev, card):
    """The baselines' phases, in order, on one synthetic cell."""
    from hicdiff_tpu_torch.data.datamodule import HUMAN_SPLITS

    forward = baselines_forward(dev, card)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="smoke_baselines_", dir=os.path.join(ROOT, "build"))
    split_of = {c: k for k, cs in HUMAN_SPLITS.items() for c in cs}
    try:
        write_synthetic_cell(root, lambda c: BASELINE_BINS[split_of[c]])
        pretrain_baselines(dev, card, root)
        baseline_step_vs_plain(dev, card)
        stard_metric_normal(dev, card, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return forward


# ---- 13. the analysis tail: 3D reconstruction (threed_comp_torch.py, quartet
# and baseline modes), the insulation metrics and the stard_metric_{cond,diff}
# scripts. No Pallas kernel is on the 3D path: the stress fit is plain torch.
ANALYSIS_TIMESTEP = 20  # the metric scripts' --timestep: a 20-step chain (default 1000)
FIT_ITERS, FIT_NUM = 2000, 3  # threed_comp.py's published --max-iter and --num
FIT_PROFILED_ITERS = (100, 200)  # the target's fit under the profiler, twice: per-iteration counts
# card vs CPU from the same start, coordinates at unit scale (the mean wish
# distance is 1). The fit amplifies rounding along its flat directions, the
# more the longer it runs, so the bar is tight after FIT_SHORT_ITERS
# iterations (TF32 Gram products would miss it) and looser after the
# published 2000: coordinates FIT_COORD_TOL, each structure's stress
# FIT_STRESS_TOL relative. Each keeps a margin of 3x or more over the
# largest difference seen on the card.
FIT_SHORT_ITERS, FIT_SHORT_TOL = 100, 1e-3
FIT_COORD_TOL, FIT_STRESS_TOL = 3e-2, 2e-3
INSULATION_TOL = 1e-5  # card vs CPU, absolute, where the CPU's value is finite


def _helix(n=48, seed=0):
    """tests/test_reconstruct.py's helix walk and its contacts under the
    3DMax distance model (f = d^(-1/0.6))."""
    t = np.linspace(0, 4 * np.pi, n)
    pts = np.stack([np.cos(t), np.sin(t), t / (2 * np.pi)], axis=1)
    pts = pts + 0.02 * np.random.default_rng(seed).normal(size=pts.shape)
    d = np.sqrt(((pts[:, None] - pts[None, :]) ** 2).sum(-1))
    f = np.zeros_like(d)
    iu = np.triu_indices(n, 1)
    f[iu] = d[iu] ** (-1.0 / 0.6)
    return pts, f + f.T


def _profiled_fit(rec, mats, iters, dev):
    """reconstruct_batch of `mats` for `iters` iterations under the profiler:
    (wall s, device activities, device busy us)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        time.sleep(0.2)  # as in serve_and_profile: let the tracer settle
        tp = time.time()
        rec.reconstruct_batch(mats, num=FIT_NUM, max_iter=iters, device=dev)
        torch.cuda.synchronize()
        wall_s = time.time() - tp
        time.sleep(0.2)
    ops = device_ops(prof)
    check(ops, "threed_comp: the profiler saw no device activity")
    return wall_s, len(ops), sum(d for _, _, d in ops)


def threed_comp(dev, card, root, qdir):
    """Phase `threed_comp`: threed_comp_torch.py in quartet mode on the card
    over the inference_cli phase's quartet (120 patches x 3 sources), native
    engine at the published defaults (--num 3 --max-iter 2000, every block):
    the block and PDB counts, the TM table, TM means finite in [0, 1], each
    source's fit time and iterations/s. Then the target's 120 blocks fitted
    for 100 and for 200 iterations under the profiler (launches and device
    time an iteration from the difference, the idle share of the longer
    fit); four blocks' fits (two target, two predict) on the card held to
    the CPU's from the same start (FIT_SHORT_TOL after FIT_SHORT_ITERS
    iterations; FIT_COORD_TOL and FIT_STRESS_TOL after 2000), and to the
    same blocks in the run's 120-block fit (its PDBs); the helix of
    tests/test_reconstruct.py recovered on the card."""
    import threed_comp_torch
    from hicdiff_tpu_torch.analysis import reconstruct as rec
    from hicdiff_tpu_torch.analysis.structure3d import parse_pdb_ca, tm_score

    t0 = time.time()
    launched = _port_kernel_launches()
    workdir = os.path.join(root, "3D_Mod")
    out = threed_comp_torch.main([qdir, "--workdir", workdir, "--root", root,
                                  "--device", str(dev)])
    wall_s = time.time() - t0
    check(_port_kernel_launches() == launched, "threed_comp: a port kernel ran")
    n = len(np.load(os.path.join(qdir, "inds.npy")))
    pdbs = len(os.listdir(os.path.join(workdir, "output")))
    check(out["n_blocks"] == 3 * n and pdbs == 3 * n * FIT_NUM,
          f"threed_comp: {out['n_blocks']} blocks, {pdbs} PDBs for {n} patches x 3 sources")
    check(out["table"] is not None and os.path.exists(out["table"]), "threed_comp: no TM table")
    means = {k: float(np.mean(v)) for k, v in out["per_source"].items()}
    check(sorted(means) == ["noisy", "predict"]
          and all(len(v) == n * FIT_NUM ** 2 for v in out["per_source"].values())
          and all(np.isfinite(m) and 0.0 <= m <= 1.0 for m in means.values()),
          f"threed_comp: TM means {means}")
    fit_s = out["fit_s"]
    phase("threed_comp", t0, mode="quartet", engine="native", patches=n, sources=3,
          num=FIT_NUM, max_iter=FIT_ITERS, run_wall_s=wall_s, fit_s=fit_s,
          iterations_per_s={k: FIT_ITERS / v for k, v in fit_s.items()},
          fit_share_of_wall=sum(fit_s.values()) / wall_s, pdbs=pdbs, tm_mean=means,
          tm_table=open(out["table"]).read().splitlines(), card=card)

    # the target's fit under the profiler, at two lengths
    tr = time.time()
    blocks = {}
    for name in ("target", "predict"):
        _, _, got = threed_comp_torch.export_blocks(
            name, np.load(os.path.join(qdir, f"{name}.npy")),
            np.load(os.path.join(qdir, "inds.npy")), os.path.join(root, "profiled_constraints"),
            threshold=0.3, max_blocks=0, diagonal_only=False)
        blocks[name] = got
    mats = [m for _, m in blocks["target"]]
    (s1, ops1, busy1), (s2, ops2, busy2) = (_profiled_fit(rec, mats, it, dev)
                                            for it in FIT_PROFILED_ITERS)
    extra = FIT_PROFILED_ITERS[1] - FIT_PROFILED_ITERS[0]
    phase("threed_comp", tr, run="fit_profiled", blocks=len(mats), num=FIT_NUM,
          iterations=FIT_PROFILED_ITERS, wall_s=[s1, s2],
          launches_per_iteration=(ops2 - ops1) / extra,
          device_us_per_iteration=(busy2 - busy1) / extra,
          host_us_per_iteration=(s2 - s1) * 1e6 / extra,
          idle_share_of_wall=1 - busy2 / 1e6 / s2, card=card)

    # four blocks on the card and on the CPU from the same start, and against
    # the same blocks' PDBs from the run's 120-block fit
    tr = time.time()
    picked = [blocks["target"][0], blocks["target"][n // 2], blocks["predict"][1],
              blocks["predict"][n - 1]]
    sel = [m for _, m in picked]
    short_c, _ = rec.reconstruct_batch(sel, num=FIT_NUM, max_iter=FIT_SHORT_ITERS, device=dev)
    short_cpu, _ = rec.reconstruct_batch(sel, num=FIT_NUM, max_iter=FIT_SHORT_ITERS,
                                         device="cpu")
    short_err = [float(np.abs(a - b).max()) for a, b in zip(short_c, short_cpu)]
    check(max(short_err) <= FIT_SHORT_TOL,
          f"threed_comp card vs CPU after {FIT_SHORT_ITERS} iterations: coords {short_err} "
          f"(tol {FIT_SHORT_TOL})")
    tc = time.time()
    card_c, card_l = rec.reconstruct_batch(sel, num=FIT_NUM, max_iter=FIT_ITERS, device=dev)
    card_s = time.time() - tc
    tc = time.time()
    cpu_c, cpu_l = rec.reconstruct_batch(sel, num=FIT_NUM, max_iter=FIT_ITERS, device="cpu")
    cpu_s = time.time() - tc
    coord_err = [float(np.abs(a - b).max()) for a, b in zip(card_c, cpu_c)]
    stress_err = [float((np.abs(a - b) / np.maximum(b, 1e-30)).max())
                  for a, b in zip(card_l, cpu_l)]
    run_err = [float(np.abs(np.stack([parse_pdb_ca(os.path.join(
        workdir, "output", f"{base}_{k}.pdb")) for k in range(FIT_NUM)]) / 10.0 - c).max())
        for (base, _), c in zip(picked, card_c)]
    check(max(coord_err) <= FIT_COORD_TOL and max(stress_err) <= FIT_STRESS_TOL,
          f"threed_comp card vs CPU: coords {coord_err} (tol {FIT_COORD_TOL}), stress "
          f"{stress_err} (tol {FIT_STRESS_TOL})")
    check(max(run_err) <= FIT_COORD_TOL,
          f"threed_comp: 4-block fit vs the 120-block run's PDBs {run_err}")

    pts, f = _helix()
    th = time.time()
    hc, hl = rec.reconstruct(f, num=2, max_iter=1500, lr=0.05, seed=1, device=dev)
    helix_s = time.time() - th
    sp = rec.reconstruction_spearman(hc[0], f)
    scale = np.linalg.norm(pts - pts.mean(0)) / np.linalg.norm(hc[0] - hc[0].mean(0))
    tm = max(tm_score(hc[0] * scale, pts), tm_score(hc[0] * [1.0, 1.0, -1.0] * scale, pts))
    check(np.isfinite(hl).all() and (hl < 1e-3).all() and sp > 0.98 and tm > 0.5,
          f"threed_comp helix on the card: stress {hl}, spearman {sp}, TM {tm}")
    phase("threed_comp", tr, run="card_vs_cpu", blocks=[b for b, _ in picked], num=FIT_NUM,
          short_iters=FIT_SHORT_ITERS, short_coord_max_abs_err=short_err,
          short_coord_tol=FIT_SHORT_TOL, max_iter=FIT_ITERS, coord_max_abs_err=coord_err,
          coord_tol=FIT_COORD_TOL,
          stress_rel_err=stress_err, stress_tol_rel=FIT_STRESS_TOL,
          stress_card=[l.tolist() for l in card_l], vs_run_pdbs_max_abs_err=run_err,
          card_fit_s=card_s, cpu_fit_s=cpu_s, helix_stress=hl.tolist(), helix_spearman=sp,
          helix_tm=tm, helix_fit_s=helix_s, card=card)


def threed_comp_baselines(dev, card, root):
    """Phase `threed_comp_baselines`: threed_comp_torch.py --baselines on the
    card over the same cell's 120 test patches: the six baselines (no
    checkpoints here: their seeded fresh init) run on the card, then eight
    sources of 120 blocks are fitted at the published defaults; block and
    PDB counts, the TM table of seven sources, TM means finite in [0, 1]."""
    import threed_comp_torch
    from hicdiff_tpu_torch.models.zoo import TABLE_BASELINES

    t0 = time.time()
    launched = _port_kernel_launches()
    workdir = os.path.join(root, "3D_Mod_baselines")
    out = threed_comp_torch.main(["--baselines", "--root", root, "--workdir", workdir,
                                  "--device", str(dev)])
    wall_s = time.time() - t0
    check(_port_kernel_launches() == launched, "threed_comp_baselines: a port kernel ran")
    n = len(CLI_TEST_CHROMS) * 30
    sources = len(TABLE_BASELINES) + 2
    pdbs = len(os.listdir(os.path.join(workdir, "output")))
    check(out["n_blocks"] == sources * n and pdbs == sources * n * FIT_NUM,
          f"threed_comp_baselines: {out['n_blocks']} blocks, {pdbs} PDBs")
    means = {k: float(np.mean(v)) for k, v in out["per_source"].items()}
    check(sorted(means) == sorted([*TABLE_BASELINES, "noisy"])
          and all(np.isfinite(m) and 0.0 <= m <= 1.0 for m in means.values()),
          f"threed_comp_baselines: TM means {means}")
    fit_s = out["fit_s"]
    phase("threed_comp_baselines", t0, patches=n, sources=sources, num=FIT_NUM,
          max_iter=FIT_ITERS, run_wall_s=wall_s, fit_s=fit_s,
          iterations_per_s={k: FIT_ITERS / v for k, v in fit_s.items()},
          fit_share_of_wall=sum(fit_s.values()) / wall_s, pdbs=pdbs, tm_mean=means, card=card)


def insulation(dev, card, qdir):
    """Phase `insulation`: the insulation vectors (r 4, k 4) and
    computeInsulation (r 8, k 8) of the quartet's 120 target patches in
    [0, 1], and InsulationLoss of predict against target over the patches
    whose vectors are finite, on the card against the CPU within
    INSULATION_TOL. A patch whose pooled diagonal is empty (the synthetic
    cell's far-band patches) has log2(0) = -inf in its vector, as in the
    JAX package: card and CPU must agree on which entries are not finite.
    The boundaries are compared as lists."""
    from hicdiff_tpu_torch.metrics.insulation import (
        compute_insulation,
        insulation_loss,
        insulation_vectors,
    )

    t0 = time.time()

    def unit(name):  # NCHW [-1, 1] -> NHWC [0, 1]
        a = np.load(os.path.join(qdir, f"{name}.npy")).transpose(0, 2, 3, 1)
        return torch.from_numpy(np.clip((a + 1.0) / 2.0, 0.0, 1.0).astype(np.float32))

    target, predict = unit("target"), unit("predict")
    _, dv_t = insulation_vectors(target, 4, 4)
    _, dv_p = insulation_vectors(predict, 4, 4)
    keep = (torch.isfinite(dv_t) & torch.isfinite(dv_p)).flatten(1).all(1)
    got, want = {}, {}
    for into, d in ((got, dev), (want, torch.device("cpu"))):
        t, p = target.to(d), predict.to(d)
        into["iv"], into["dv"] = insulation_vectors(t, 4, 4)
        into["loss"] = insulation_loss(p[keep.to(d)], t[keep.to(d)])
        into["civ"], into["cdv"], into["bounds"] = compute_insulation(t, 8, 8)
    errs, same_mask = {}, True
    for k in ("iv", "dv", "loss", "civ", "cdv"):
        a, b = got[k].cpu(), want[k]
        fin = torch.isfinite(b)
        same_mask &= bool(torch.equal(torch.isfinite(a), fin)
                          and torch.equal(a[~fin].nan_to_num(), b[~fin].nan_to_num()))
        errs[k] = float((a[fin] - b[fin]).abs().max()) if fin.any() else float("nan")
    check(same_mask and torch.isfinite(want["loss"]).item()
          and max(errs.values()) <= INSULATION_TOL,
          f"insulation card vs CPU: {errs} (tol {INSULATION_TOL}), same non-finite entries "
          f"{same_mask}")
    same = sum(np.array_equal(a, b) for a, b in zip(got["bounds"], want["bounds"]))
    ms = cuda_ms(lambda: compute_insulation(target.to(dev), 8, 8), iters=5)
    phase("insulation", t0, patches=target.shape[0], max_abs_err=errs, tol=INSULATION_TOL,
          finite_patches=int(keep.sum()),
          nonfinite_share_dv=float(1 - torch.isfinite(want["dv"]).float().mean()),
          loss=float(want["loss"]), boundary_lists_equal=same,
          boundaries=sum(len(b) for b in want["bounds"]), compute_insulation_ms=ms, card=card)


def stard_metric_scripts(dev, card, root, cond_ckpt, uncond_ckpt):
    """Phases `stard_metric_cond` and `stard_metric_diff`: the two scripts on
    the card over the cell's 120 test patches at full width in fp32, their
    chains cut to --timestep ANALYSIS_TIMESTEP (cond: the full sigmoid chain
    of that many ancestral steps; diff: DDRM on the linear betas with that
    many steps of the 1000): the launch counters as the inference_cli phase
    checks them, the quartet and the metrics, wall s and chain steps/s.
    Returns their launch counts."""
    import sample.stard_metric_cond_torch as smc
    import sample.stard_metric_diff_torch as smd
    from hicdiff_tpu_torch.kernels.resblock import fused_resblock
    from hicdiff_tpu_torch.kernels.sample_step import fused_posterior_step
    from hicdiff_tpu_torch.sampling.ddrm import DDRMRestorer

    ddrm_forwards = DDRMRestorer(None, "deno", SIGMA, device="cpu",
                                 sampling_steps=ANALYSIS_TIMESTEP).forwards
    counts = {}
    for name, mod, ckpt, forwards, posterior, outname in (
            ("stard_metric_cond", smc, cond_ckpt, ANALYSIS_TIMESTEP, ANALYSIS_TIMESTEP,
             f"hicedrn_l2_sigHuman1_deno_{SIGMA}_test_cond"),
            ("stard_metric_diff", smd, uncond_ckpt, ddrm_forwards, 0,
             f"hicedrn_l2_linHuman1_deno_{SIGMA}_trans2_{ANALYSIS_TIMESTEP}")):
        t0 = time.time()
        fused_resblock.launches = 0
        fused_posterior_step.launches = 0
        with timed_run({}) as run_p:
            res = mod.main(["-n", "1", "-l", "Human", "-s", str(SIGMA), "--root", root,
                            "--timestep", str(ANALYSIS_TIMESTEP), "--weights", ckpt,
                            "--device", str(dev)])
        wall_s = run_p["wall_s"]
        launches = dict(resblock_launches=fused_resblock.launches,
                        step_launches=fused_posterior_step.launches)
        n = len(res["inds"])
        batches = -(-n // CLI_BATCH)
        want = dict(resblock_launches=batches * forwards * BLOCKS * 2,
                    step_launches=batches * posterior)
        check(n == len(CLI_TEST_CHROMS) * 30, f"{name}: {n} test patches")
        check(launches == want, f"{name} launches {launches} != {want}")
        check(os.path.basename(res["outdir"]) == outname, f"{name}: outdir {res['outdir']}")
        pred = np.load(os.path.join(res["outdir"], "predict.npy"))
        check(pred.shape == (n, 1, 64, 64) and np.isfinite(pred).all(),
              f"{name}: predict {pred.shape} not finite")
        metrics = res["metrics"]
        check(len(metrics) == 7 and all(np.isfinite(v) for v in metrics.values()),
              f"{name} metrics: {metrics}")
        phase(name, t0, dtype="float32", sigma=SIGMA, timestep=ANALYSIS_TIMESTEP,
              forwards=forwards, blocks=BLOCKS, features=FEATURES, batch=CLI_BATCH, patches=n,
              batches=batches, cut=f"chain: --timestep {ANALYSIS_TIMESTEP} (default 1000); "
                                   "data scale as inference_cli; full width and depth",
              run_wall_s=wall_s, steps_per_s=batches * forwards / wall_s,
              patches_per_s=n / wall_s, **launches, metrics=metrics, card=card)
        counts[name] = launches
    return counts


def analysis_tail(dev, card, quartet, quartet_name):
    """Phase 13, on one synthetic cell (the inference_cli phase's sizes):
    the inference_cli phase's quartet reconstructed in 3D, the baseline
    mode, the insulation metrics, and the two stard_metric scripts on seeded
    full-width cond and uncond weights (those of the inference_cli and
    inference_cli_ddrm phases). Returns the scripts' launch counts."""
    from hicdiff_tpu_torch.convert import params_to_jax
    from hicdiff_tpu_torch.models.hicedrn import HicedrnDiff
    from hicdiff_tpu_torch.train.checkpoint import save_checkpoint

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="smoke_analysis_", dir=os.path.join(ROOT, "build"))
    try:
        qdir = os.path.join(root, "Outputs_diff", quartet_name)
        os.makedirs(qdir)
        for what, a in quartet.items():
            np.save(os.path.join(qdir, what), a)
        threed_comp(dev, card, root, qdir)
        write_synthetic_cell(
            root, lambda c: CLI_TEST_BINS if c in CLI_TEST_CHROMS else CLI_OTHER_BINS)
        threed_comp_baselines(dev, card, root)
        insulation(dev, card, qdir)
        ckpts = {}
        for cond, seed, schedule in ((True, 2, "sigmoid"), (False, 7, "linear")):
            model = HicedrnDiff(self_condition=cond, number_resnet=BLOCKS, features=FEATURES,
                                device="cpu", generator=torch.Generator().manual_seed(seed))
            ckpts[cond] = os.path.join(root, "Model_Weights", f"{schedule}.msgpack")
            save_checkpoint(ckpts[cond], params_to_jax(model.state_dict()), run_config=dict(
                sigma=SIGMA, schedule=schedule, mode="cond" if cond else "uncond",
                timestep=ANALYSIS_TIMESTEP, percentile=99.0))
            del model
        return stard_metric_scripts(dev, card, root, ckpts[True], ckpts[False])
    finally:
        shutil.rmtree(root, ignore_errors=True)


def fullscale_fixture(dev, card):
    """Phase 14: the full-scale protocols' tools at reduced bins. The port's
    fixture generator (tools/torch_make_fullscale_fixture.py: seed 7, band
    257, 22 chromosomes of 512 bins) writes the contact lists into the
    trainer's `_p99.99` cache with the latents and weights; the data module
    prepares from them; the bf16 -u 0 CLI runs `--sampling-steps 1` over the
    test split on a seeded full-width checkpoint trained at 99.99, and the
    bf16 -u 1 CLI (DDRM deno, `--t-start auto`) on a seeded full-width
    unconditional one at the linear schedule; then
    tools/torch_latent_target.py and tools/torch_quartet_metrics.py score
    each run's prediction, identity row and realized target against the
    latent. Returns each CLI's launch counts."""
    import inference_torch
    from hicdiff_tpu_torch.convert import params_to_jax
    from hicdiff_tpu_torch.kernels.resblock import fused_resblock
    from hicdiff_tpu_torch.kernels.sample_step import fused_posterior_step
    from hicdiff_tpu_torch.models.hicedrn import HicedrnDiff
    from hicdiff_tpu_torch.train.checkpoint import save_checkpoint
    from tools.torch_latent_target import build_latent_npy
    from tools.torch_make_fullscale_fixture import constraints_dir, make_fullscale
    from tools.torch_quartet_metrics import score_quartet

    t0 = time.time()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="smoke_fullscale_", dir=os.path.join(ROOT, "build"))
    try:
        latent_dir = os.path.join(root, "latent")
        n_bins, n_pixels = make_fullscale(constraints_dir(root, SIGMA, 99.99), seed=7,
                                          bins_per_chrom=[FULLSCALE_BINS] * 22,
                                          latent_dir=latent_dir, band=FULLSCALE_BAND)
        fixture_s = time.time() - t0
        runs = {}
        # -u 0 at K=1 (one forward a batch), -u 1 DDRM deno at t*=27 (28 forwards)
        for name, uncond, schedule, seed, steps, forwards in (
                ("cond_k1", False, "sigmoid", 5, 1, 1), ("ddrm", True, "linear", 6, None, 28)):
            model = HicedrnDiff(self_condition=not uncond, number_resnet=BLOCKS,
                                features=FEATURES, device="cpu",
                                generator=torch.Generator().manual_seed(seed))
            ckpt = os.path.join(root, "Model_Weights", f"random_{name}.msgpack")
            save_checkpoint(ckpt, params_to_jax(model.state_dict()), run_config=dict(
                sigma=SIGMA, schedule=schedule, mode="uncond" if uncond else "cond",
                timestep=1000, percentile=99.99))
            del model
            fused_resblock.launches = 0
            fused_posterior_step.launches = 0
            tr = time.time()
            res = inference_torch.Inference(
                batch_size=CLI_BATCH, sigma_t=SIGMA, condition=uncond, root=root,
                schedule=schedule, timestep=1000, bf16=True, weights=ckpt,
                sampling_steps=steps, t_start="auto", use_ema=False, blocks=BLOCKS,
                features=FEATURES, compute_metrics=False, device=dev)
            torch.cuda.synchronize()
            cli_s = time.time() - tr
            launches = dict(resblock_launches=fused_resblock.launches,
                            step_launches=fused_posterior_step.launches)
            n = len(res["inds"])
            batches = -(-n // CLI_BATCH)
            check(res["data_dir"].endswith("_p99.99"),
                  f"fullscale_fixture {name}: cache {res['data_dir']}")
            check(n == len(CLI_TEST_CHROMS) * 30, f"fullscale_fixture {name}: {n} test patches")
            check(not uncond or res["outdir"].endswith("_trans2_1000_ts27"),
                  f"fullscale_fixture {name}: {res['outdir']}")
            # no ancestral step on either path: DDIM K=1 and DDRM have their own updates
            check(launches == dict(resblock_launches=batches * forwards * BLOCKS * 2,
                                   step_launches=0),
                  f"fullscale_fixture {name} launches {launches}")
            tr = time.time()
            info = build_latent_npy(res["outdir"], res["data_dir"], latent_dir,
                                    percentile=99.99)
            target = np.load(os.path.join(res["outdir"], "target.npy"))
            latent = np.load(os.path.join(res["outdir"], "latent.npy"))
            check(latent.shape == target.shape == (n, 1, 64, 64),
                  f"fullscale_fixture {name}: latent {latent.shape} vs target {target.shape}")
            check(info["corr_latent_target"] > 0.9, f"fullscale_fixture {name}: {info}")
            scores = {f"{p}_vs_latent": score_quartet(res["outdir"], p, target_file="latent.npy")
                      for p in ("predict", "noisy", "target")}
            check(all(np.isfinite(v) for s in scores.values() for v in s.values()),
                  f"fullscale_fixture {name} scores: {scores}")
            runs[name] = dict(
                cli_s=cli_s, score_s=time.time() - tr, patches=n, batches=batches,
                schedule=schedule, sampling_steps=steps, forwards_per_batch=forwards,
                **launches, corr_latent_target=info["corr_latent_target"],
                speckle_rms=info["speckle_rms"],
                scores={k: {m: v[m] for m in ("pas_ssim", "pas_psnr", "pas_pcc")}
                        for k, v in scores.items()})
        phase("fullscale_fixture", t0, bins=n_bins, pixels=n_pixels, band=FULLSCALE_BAND,
              seed=7, fixture_s=fixture_s, dtype="bfloat16", t_start_ddrm=27, **runs,
              cut=f"data scale only: {FULLSCALE_BINS} bins a chromosome of hg19's 1,203-6,232",
              card=card)
        return {name: {k: r[k] for k in ("resblock_launches", "step_launches")}
                for name, r in runs.items()}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def engine_options(dev, card):
    """Phase 15: the engine's options on the card against the plain run on
    the CPU, on one full-width (256-feature) HicedrnDiff of ENGINE_BLOCKS
    blocks at batch ENGINE_BATCH: each objective's p_losses (l2 for
    pred_noise, l1 for the others; p2 gamma 0.5, k 2) with its backward (the
    loss 1e-5 relative, each gradient within BWD_TOL of its largest value),
    a truncated DDIM chain (K = 3) with the x0 clip off returning every
    state, the truncated ancestral chain's launches (the posterior step
    once a step under pred_noise only, as gaussian.py:312 fuses it), then
    the Unet1D, VAEModel and learned-embedding Unet forwards (no port
    kernel may launch in them) within 1e-3 of the largest value. Returns
    the ancestral chains' launch counts by objective."""
    from hicdiff_tpu_torch.diffusion.gaussian import GaussianDiffusion
    from hicdiff_tpu_torch.kernels.resblock import fused_resblock
    from hicdiff_tpu_torch.kernels.sample_step import fused_posterior_step
    from hicdiff_tpu_torch.models.hicedrn import HicedrnDiff
    from hicdiff_tpu_torch.models.unet import Unet
    from hicdiff_tpu_torch.models.unet1d import Unet1D
    from hicdiff_tpu_torch.models.vae import VAEModel

    t0 = time.time()
    cpu_model = HicedrnDiff(self_condition=True, number_resnet=ENGINE_BLOCKS, features=FEATURES,
                            device="cpu", generator=torch.Generator().manual_seed(9))
    card_model = copy.deepcopy(cpu_model).to(dev)
    g = torch.Generator().manual_seed(10)
    shape = (ENGINE_BATCH, 64, 64, 1)
    cond = torch.randn(shape, generator=g).clamp(-1, 1)
    target = torch.randn(shape, generator=g).clamp(-1, 1)
    t = torch.randint(0, 1000, (ENGINE_BATCH,), generator=g)
    noise = torch.randn(shape, generator=g)
    t_start = 29
    rows, launches = {}, {}
    for objective in ("pred_noise", "pred_x0", "pred_v"):
        kw = dict(timesteps=1000, beta_schedule="sigmoid", mode="cond", objective=objective,
                  loss_type="l2" if objective == "pred_noise" else "l1",
                  p2_loss_weight_gamma=0.5, p2_loss_weight_k=2.0)
        engines = {d: GaussianDiffusion.create(m, device=d, **kw)
                   for d, m in (("cpu", cpu_model), (dev, card_model))}
        losses, grads = {}, {}
        for d, eng in engines.items():
            eng.model.zero_grad(set_to_none=True)
            loss = eng.p_losses(cond.to(d), target.to(d), t=t, noise=noise)
            loss.backward()
            losses[d] = loss.item()
            grads[d] = {n: p.grad.detach().cpu() for n, p in eng.model.named_parameters()}
        loss_err = abs(losses[dev] - losses["cpu"]) / abs(losses["cpu"])
        check(loss_err <= 1e-5, f"engine_options {objective}: loss {losses}")
        grad_err = max(((grads[dev][n] - w).abs().max() / w.abs().max()).item()
                       for n, w in grads["cpu"].items())
        check(grad_err <= BWD_TOL, f"engine_options {objective}: gradient error {grad_err}")
        with torch.no_grad():
            states = {}
            for d, eng in engines.items():
                eng = dataclasses.replace(eng, t_start=t_start, sampling_timesteps=3,
                                          ddim_clip_x_start=False)
                states[d] = eng.super_resolution(cond.to(d), torch.Generator().manual_seed(0),
                                                 return_all_timesteps=True).cpu()
            check(states["cpu"].shape == (4, *shape), f"engine_options: {states['cpu'].shape}")
            ddim_err = ((states[dev] - states["cpu"]).abs().max()
                        / states["cpu"].abs().max()).item()
            check(ddim_err <= 1e-4, f"engine_options {objective}: DDIM states error {ddim_err}")
            fused_resblock.launches = 0
            fused_posterior_step.launches = 0
            tr = time.time()
            out = dataclasses.replace(engines[dev], t_start=t_start).p_sample_loop(
                cond.to(dev), torch.Generator().manual_seed(1))
            torch.cuda.synchronize()
            chain_s = time.time() - tr
        steps = t_start + 1
        launches[objective] = dict(resblock_launches=fused_resblock.launches,
                                   step_launches=fused_posterior_step.launches)
        want = dict(resblock_launches=steps * ENGINE_BLOCKS * 2,
                    step_launches=steps if objective == "pred_noise" else 0)
        check(launches[objective] == want,
              f"engine_options {objective} chain launches {launches[objective]} != {want}")
        check(bool(torch.isfinite(out).all()), f"engine_options {objective}: chain not finite")
        rows[objective] = dict(loss_type=kw["loss_type"], loss_rel_err=loss_err,
                               grad_err_of_largest=grad_err, ddim_states_err_of_largest=ddim_err,
                               chain_s=chain_s, **launches[objective])
    del card_model
    forwards = {}
    before = _port_kernel_launches()
    g = torch.Generator().manual_seed(11)
    for name, make, inputs in (
        ("Unet1D", lambda d, gen: Unet1D(dim=64, device=d, generator=gen),
         (torch.randn(ENGINE_BATCH, 256, 1, generator=g), torch.randint(0, 1000, (ENGINE_BATCH,),
                                                                       generator=g))),
        ("VAEModel", lambda d, gen: VAEModel(device=d, generator=gen),
         (torch.randn(shape, generator=g).tanh(), None, torch.randn(ENGINE_BATCH, 128,
                                                                    generator=g))),
        ("Unet_learned_sinusoidal", lambda d, gen: Unet(
            dim=64, self_condition=True, learned_sinusoidal_cond=True, device=d, generator=gen),
         (torch.randn(shape, generator=g), torch.randint(0, 1000, (ENGINE_BATCH,), generator=g),
          cond)),
    ):
        cpu = make("cpu", torch.Generator().manual_seed(12))
        card_m = copy.deepcopy(cpu).to(dev)
        with torch.no_grad():
            want = cpu(*inputs)
            got = card_m(*(a.to(dev) if isinstance(a, torch.Tensor) else a for a in inputs))
            want = want[0] if isinstance(want, tuple) else want
            got = (got[0] if isinstance(got, tuple) else got).cpu()
        err = ((got - want).abs().max() / want.abs().max()).item()
        check(err <= 1e-3, f"engine_options {name}: forward error {err}")
        forwards[name] = dict(shape=list(got.shape), err_of_largest=err)
        del card_m
    check(_port_kernel_launches() == before, "engine_options: a port kernel ran in the zoo forwards")
    phase("engine_options", t0, blocks=ENGINE_BLOCKS, features=FEATURES, batch=ENGINE_BATCH,
          t_start=t_start, tol_grad_of_largest=BWD_TOL, objectives=rows, forwards=forwards,
          card=card)
    return launches


# ---- phase 16: data parallelism, progressive distillation, serve concurrency
DP_RANKS, DP_RAGGED = 2, 18  # two ranks sharing the card; the train phase's ragged batch
# the two-rank run against the one-rank run: fp32 at the JAX harness's bars
# (losses 1e-5, chain and DDRM outputs 1e-4) and the parameters by
# train_step_vs_plain's rule (multihost.launch: each weight within 4 lr, at
# most one in 100,000 over lr / 10 apart, where a gradient that sums to
# about 0 flips its Adam step's sign); bf16 at about 6-10x what a measured
# run gave (losses 1.7e-6, the chain 1.6e-3 and DDRM 2.1e-4 of outputs whose
# largest is 1.0 and 1.5, 1871 weights updated over lr / 10 apart; PERF.md
# §6), inside the conv's 0.016 and the bf16 chains' 2e-2 of the largest value
DP_TOL = {False: {"loss": 1e-5, "params": None, "sample": 1e-4, "ddrm": 1e-4,
                  "update_outliers": 1e-5},
          True: {"loss": 1e-4, "params": None, "sample": 1e-2, "ddrm": 2e-3,
                 "update_outliers": 5e-4}}
DISTILL_STAGES, DISTILL_STEPS = "2,1", 4  # distill_torch.py --stages, --steps-per-stage
DISTILL_LR = 1e-5  # distill_torch.py's --lr


def release_device_memory():
    """Free this process's cached device memory for the phases whose work
    runs in other processes (the multihost ranks, the daemons); returns the
    GB still allocated here."""
    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated() / 1e9


def one_rank_nccl(dev, card):
    """A one-rank NCCL world on the card: a Trainer step with the mesh equals
    the step without one, bit for bit (cuDNN held deterministic for the
    comparison), in fp32 and bf16, at the train batch of 64."""
    from hicdiff_tpu_torch.diffusion.gaussian import GaussianDiffusion
    from hicdiff_tpu_torch.models.hicedrn import HicedrnDiff
    from hicdiff_tpu_torch.parallel.mesh import make_mesh
    from hicdiff_tpu_torch.parallel.multihost import free_port
    from hicdiff_tpu_torch.train.trainer import Trainer, step_generator

    t0 = time.time()
    mesh = make_mesh(torch.device("cuda", 0), backend="nccl",
                     init_method=f"tcp://localhost:{free_port()}", rank=0, world_size=1)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    rng = np.random.default_rng(16)
    target = np.clip(rng.normal(0, 0.3, (TRAIN_BATCH, 64, 64, 1)), -1, 1).astype(np.float32)
    data = np.clip(target + SIGMA * rng.normal(size=target.shape), -1, 1).astype(np.float32)
    rows = {}
    try:
        for bf16 in (False, True):
            trainers = []
            for m in (mesh, None):
                model = HicedrnDiff(self_condition=True, number_resnet=BLOCKS, features=FEATURES,
                                    dtype=torch.bfloat16 if bf16 else None, device=mesh.device,
                                    generator=torch.Generator().manual_seed(5))
                engine = GaussianDiffusion.create(model, device=mesh.device, timesteps=1000,
                                                  beta_schedule="linear")
                trainers.append(Trainer(engine, lr=2e-5, mesh=m))
            losses = [[float(tr.train_step(data, target, generator=step_generator(0, s)))
                       for s in range(2)] for tr in trainers]
            torch.cuda.synchronize()
            same = [n for (n, a), b in zip(trainers[0].model.named_parameters(),
                                           trainers[1].model.parameters())
                    if not torch.equal(a, b)]
            check(losses[0] == losses[1] and not same,
                  f"one-rank nccl step bf16={bf16}: losses {losses}, params differ: {same[:5]}")
            rows["bfloat16" if bf16 else "float32"] = losses[0]
            del trainers
    finally:
        torch.backends.cudnn.deterministic = deterministic
        mesh.close()
    phase("data_parallel", t0, run="one_rank_nccl_equals_no_mesh", backend="nccl",
          batch=TRAIN_BATCH, steps=2, losses=rows, bit_equal=True, card=card)


def data_parallel(dev, card):
    """Phase `data_parallel`: hicdiff_tpu_torch/parallel/multihost.py's
    launcher on the card, full width, fp32 and bf16: a one-rank run and a
    two-rank run (gloo, both ranks on cuda:0), each two Trainer steps (the
    global batch of 64, then the ragged 18), the truncated chain (one noisy
    step through the posterior kernel at the rank's offset) on the 64 and a
    DDRM deno restoration (28 forwards) of the 18; the two-rank run held to
    the one-rank run at DP_TOL; the workers' launch counts; each step's ms
    (the two ranks share one GPU, so their step time is a record of the
    harness, not a speed-up). Then the one-rank NCCL world. Returns the
    two-rank runs' rank-0 launch counts by dtype."""
    from hicdiff_tpu_torch.parallel import multihost

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    held_gb = release_device_memory()
    counts = {}
    for bf16 in (False, True):
        t0 = time.time()
        workdir = tempfile.mkdtemp(prefix="smoke_dp_", dir=os.path.join(ROOT, "build"))
        try:
            rec = multihost.launch(DP_RANKS, workdir=workdir, device="cuda:0", backend="gloo",
                                   blocks=BLOCKS, features=FEATURES, batch=TRAIN_BATCH,
                                   ragged=DP_RAGGED, bf16=bf16, tol=DP_TOL[bf16], timeout=900)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        dtype = "bfloat16" if bf16 else "float32"
        for run, launches in rec["launches"].items():
            for name in ("fused_resblock", "fused_resblock_dgrad", "resblock_wgrad",
                         "resblock_channel_sums", "fused_posterior_step"):
                check(launches[name] > 0, f"data_parallel {dtype} {run}: {name} never launched")
        counts[dtype] = rec["launches"]["dp_rank0"]
        phase("data_parallel", t0, run="multihost_launch", dtype=dtype, ranks=DP_RANKS,
              backend="gloo", device="cuda:0 (both ranks)", blocks=BLOCKS, features=FEATURES,
              batches=[TRAIN_BATCH, DP_RAGGED], ddrm_forwards=rec["ddrm_forwards"],
              ref_losses=rec["ref_losses"], dp_losses=rec["dp_losses"],
              max_diff=rec["max_diff"], tol=rec["tol"], update=rec["update"],
              largest=rec["largest"],
              step_ms=rec["step_ms"], launches=rec["launches"],
              step_ms_note="two ranks share one GPU: a record of the harness, not a speed-up",
              smoke_process_allocated_gb=held_gb, card=card)
    one_rank_nccl(dev, card)
    return counts


def distill_step_vs_plain(dev, card):
    """One bf16 distillation step (loss, backward, Adam) of the full-width
    student on the card against the same step on the CPU, from the same
    weights, batch and draws (i, noise), at the bf16 bars of
    `train_step_vs_plain`, each held against the CPU's own bf16-fp32 gap: the
    card's loss and each gradient no farther (L2) from the CPU's bf16 value
    than that lies from the CPU's fp32 value at the same weights; the
    updates within 2 lr (a first Adam step moves a weight by at most lr),
    and no more of them over lr / 10 from the CPU's bf16 updates than the
    CPU's bf16 updates have from its fp32 ones (a sign flip of a small
    gradient). The loss is the squared distance of two nearly equal states
    (the student is the teacher plus a seeded perturbation, 5 % of each
    weight's spread), so bf16's rounding moves it by percents: the 1e-2
    relative bar that train_step_vs_plain holds a noise-prediction loss to
    failed here on the card (1.58 %, PERF.md §6) while the CPU's bf16 and
    fp32 losses lay 6.0 % apart."""
    import copy

    from hicdiff_tpu_torch.diffusion.gaussian import GaussianDiffusion
    from hicdiff_tpu_torch.models.hicedrn import HicedrnDiff
    from hicdiff_tpu_torch.train.distill import ProgressiveDistiller

    t0 = time.time()
    lr = DISTILL_LR
    cpu = HicedrnDiff(self_condition=True, number_resnet=BLOCKS, features=FEATURES,
                      dtype=torch.bfloat16, device="cpu",
                      generator=torch.Generator().manual_seed(6))
    fp32 = copy.deepcopy(cpu)
    fp32.dtype = None
    models = {"card": copy.deepcopy(cpu).to(dev), "cpu": cpu, "cpu_fp32": fp32}
    gen = torch.Generator().manual_seed(13)
    perturb = [0.05 * p.detach().std(correction=0) * torch.randn(p.shape, generator=gen)
               for p in cpu.parameters()]
    rng = np.random.default_rng(7)
    b = STEP_VS_PLAIN_BATCH
    x0 = np.clip(rng.normal(0, 0.3, (b, 64, 64, 1)), -1, 1).astype(np.float32)
    y = np.clip(x0 + SIGMA * rng.normal(size=x0.shape), -1, 1).astype(np.float32)
    i = torch.tensor([0, 1])  # the deployment init and a marginal state
    noise = torch.from_numpy(rng.normal(size=x0.shape).astype(np.float32))
    losses, grads, updates, step_s = {}, {}, {}, {}
    for side, m in models.items():
        d = next(m.parameters()).device
        eng = GaussianDiffusion.create(m, device=d, timesteps=1000, beta_schedule="sigmoid")
        eng = dataclasses.replace(eng, t_start=eng.truncation_timestep(SIGMA))
        dist = ProgressiveDistiller(eng, student_steps=2, lr=lr)
        dist.freeze_teacher()
        with torch.no_grad():
            for p, delta in zip(m.parameters(), perturb):
                p += delta.to(d)
        before = [p.detach().clone() for p in m.parameters()]
        tc = time.time()
        loss = dist.step(y, x0, i=i, noise=noise)
        if d.type == "cuda":
            torch.cuda.synchronize()
        step_s[side] = time.time() - tc
        losses[side] = float(loss)
        grads[side] = {n: p.grad.float().cpu() for n, p in m.named_parameters()}
        updates[side] = {n: (p.detach() - p0).cpu() for (n, p), p0 in
                         zip(m.named_parameters(), before)}
    loss_rel = abs(losses["card"] - losses["cpu"]) / abs(losses["cpu"])
    loss_gap_bf16 = abs(losses["cpu"] - losses["cpu_fp32"]) / abs(losses["cpu"])
    check(loss_rel <= loss_gap_bf16, f"distill step losses: {losses}")
    ratio = {}
    update_tol, flip_tol = 0.1 * lr, 2 * lr * 1.01
    outliers = {"card_vs_cpu_bf16": 0, "cpu_bf16_vs_cpu_fp32": 0}
    update_err = 0.0
    for n, gc in grads["cpu"].items():
        gk, g32 = grads["card"][n], grads["cpu_fp32"][n]
        ratio[n] = ((gk - gc).norm() / max((gc - g32).norm(), 1e-30)).item()
        uk, uc, u32 = updates["card"][n], updates["cpu"][n], updates["cpu_fp32"][n]
        update_err = max(update_err, (uk - uc).abs().max().item())
        outliers["card_vs_cpu_bf16"] += int(((uk - uc).abs() > update_tol).sum())
        outliers["cpu_bf16_vs_cpu_fp32"] += int(((uc - u32).abs() > update_tol).sum())
    far = max(ratio, key=ratio.get)
    check(ratio[far] <= 1, f"distill grad {far}: card - cpu bf16 is {ratio[far]} x "
                           "cpu bf16 - cpu fp32")
    check(update_err <= flip_tol, f"distill updates: max-abs difference {update_err} > "
                                  f"{flip_tol}")
    check(outliers["card_vs_cpu_bf16"] <= outliers["cpu_bf16_vs_cpu_fp32"],
          f"distill updates over {update_tol} apart: {outliers}")
    phase("distill", t0, run="step_vs_plain", dtype="bfloat16", blocks=BLOCKS,
          features=FEATURES, batch=b, student_steps=2, lr=lr, i=i.tolist(), losses=losses,
          loss_rel_err=loss_rel, loss_tol_cpu_bf16_vs_fp32=loss_gap_bf16, grad_l2_worst=far,
          grad_l2_ratio_max=ratio[far], grad_l2_ratio_median=float(np.median(list(
              ratio.values()))), update_tol=update_tol, update_outliers=outliers,
          params=sum(p.numel() for p in cpu.parameters()), update_max_abs_err=update_err,
          update_max_abs_tol=flip_tol, card_s=step_s["card"], cpu_s=step_s["cpu"], card=card)


def distill(dev, card):
    """Phase `distill`, bf16: distill_torch.py (--stages 2,1
    --steps-per-stage 4, batch 64) from a random full-width teacher written
    by the port's checkpoint writer, on a synthetic cell written as text;
    the launch counters show the teacher's forwards (no_grad: modes 1 and 2)
    and the student's (training: mode 3, then 2) take fused_resblock, and
    the student's backward the dgrad, wgrad and channel sums; then the -u 0
    CLI runs `--t-start auto --sampling-steps 1` on the `_dist1` checkpoint;
    then the distill step's ms at batch 64 and one step against the CPU.
    Returns the CLI run's launch counts."""
    import distill_torch
    import inference_torch
    from hicdiff_tpu_torch.convert import params_to_jax
    from hicdiff_tpu_torch.data.datamodule import HUMAN_SPLITS
    from hicdiff_tpu_torch.diffusion.gaussian import GaussianDiffusion
    from hicdiff_tpu_torch.kernels.resblock import fused_resblock
    from hicdiff_tpu_torch.kernels.sample_step import fused_posterior_step
    from hicdiff_tpu_torch.models.hicedrn import HicedrnDiff
    from hicdiff_tpu_torch.train.checkpoint import checkpoint_name, load_checkpoint, save_checkpoint
    from hicdiff_tpu_torch.train.distill import ProgressiveDistiller
    from hicdiff_tpu_torch.train.trainer import step_generator

    t0 = time.time()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="smoke_distill_", dir=os.path.join(ROOT, "build"))
    counters = _launch_counts()
    try:
        split_of = {c: k for k, cs in HUMAN_SPLITS.items() for c in cs}
        for marker in ("_p99.99", ""):  # distill_torch.py's cache, the CLI's (cell 1: 99.0)
            write_synthetic_cell(root, lambda c: TRAIN_BINS[split_of[c]], marker=marker)
        teacher = HicedrnDiff(self_condition=True, number_resnet=BLOCKS, features=FEATURES,
                              device="cpu", generator=torch.Generator().manual_seed(8))
        meta = dict(res=40000, chunk=64, cell_line="Human", cell_no=1)
        path = os.path.join(root, "Model_Weights",
                            checkpoint_name("bestg", tag="HiCedrn_cond_l2_sig", **meta))
        save_checkpoint(path, params_to_jax(teacher.state_dict()), run_config=dict(
            sigma=SIGMA, schedule="sigmoid", mode="cond", timestep=1000, percentile=99.99))
        del teacher
        for c in (*counters.values(), fused_posterior_step):
            c.launches = 0
        fused_resblock.mode_launches.clear()
        tr = time.time()
        distill_torch.main(["--root", root, "--stages", DISTILL_STAGES, "--steps-per-stage",
                            str(DISTILL_STEPS), "-b", str(TRAIN_BATCH), "-s", str(SIGMA),
                            "--blocks", str(BLOCKS), "--features", str(FEATURES), "--bf16",
                            "--device", str(dev)])
        torch.cuda.synchronize()
        cli_s = time.time() - tr
        modes = dict(fused_resblock.mode_launches)
        launches = {k: c.launches for k, c in counters.items()}
        stages = len(DISTILL_STAGES.split(","))
        steps = stages * DISTILL_STEPS
        val_batches = stages * 1  # 12 val patches: one batch an epoch, one epoch a stage
        # teacher: two forwards a step and a val batch; student: one training
        # forward a step (mode 3, then 2), one no_grad forward a val batch
        want = {1: BLOCKS * (2 * steps + 3 * val_batches), 3: BLOCKS * steps}
        check(modes.get(1) == want[1] and modes.get(3) == want[3],
              f"distill: conv modes {modes}, want modes 1 and 3 {want}")
        # the student's backward: modes 4 and 5, the wgrad and the sums a block a step
        want_bwd = {"fused_resblock_dgrad": 2 * BLOCKS * steps,
                    "resblock_wgrad": BLOCKS * steps, "resblock_channel_sums": BLOCKS * steps}
        check(all(launches[k] == v for k, v in want_bwd.items()),
              f"distill: backward launches {launches} != {want_bwd}")
        check(fused_posterior_step.launches == 0, "distill: the posterior step launched")
        outs = {}
        for k in DISTILL_STAGES.split(","):
            out = os.path.join(root, "Model_Weights", checkpoint_name(
                "bestg", tag=f"HiCedrn_cond_l2_sig_dist{k}", **meta))
            ck = load_checkpoint(out, only={"run_config", "step"})
            check(ck["run_config"]["distilled_steps"] == int(k) and ck["step"] == DISTILL_STEPS,
                  f"distill: {out} run_config {ck['run_config']}")
            outs[k] = out
        phase("distill", t0, run="distill_torch", dtype="bfloat16", blocks=BLOCKS,
              features=FEATURES, batch=TRAIN_BATCH, stages=DISTILL_STAGES,
              steps_per_stage=DISTILL_STEPS, cli_s=cli_s, conv_modes=modes, launches=launches,
              want_conv_modes_1_3=want, card=card)

        # the K=1 student through the -u 0 CLI, no new sampler code
        fused_resblock.launches = fused_posterior_step.launches = 0
        tr = time.time()
        res = inference_torch.Inference(
            device=dev, batch_size=CLI_BATCH, cellNo=1, cell_Line="Human", sigma_t=SIGMA,
            condition=False, root=root, schedule="sigmoid", timestep=1000, weights=outs["1"],
            t_start="auto", sampling_steps=1, bf16=True, blocks=BLOCKS, features=FEATURES)
        torch.cuda.synchronize()
        wall_s = time.time() - tr
        n = len(res["inds"])
        pred = np.load(os.path.join(res["outdir"], "predict.npy"))
        cli_launches = dict(resblock_launches=fused_resblock.launches,
                            step_launches=fused_posterior_step.launches)
        check(pred.shape == (n, 1, 64, 64) and np.isfinite(pred).all(),
              f"distill K=1 CLI: predict {pred.shape}")
        check(cli_launches == dict(resblock_launches=-(-n // CLI_BATCH) * BLOCKS * 2,
                                   step_launches=0), f"distill K=1 CLI: {cli_launches}")
        phase("distill", tr, run="inference_k1", patches=n, wall_s=wall_s,
              metrics=res["metrics"], **cli_launches, card=card)

        # the distill step's time at batch 64, bf16
        tr = time.time()
        student = HicedrnDiff(self_condition=True, number_resnet=BLOCKS, features=FEATURES,
                              dtype=torch.bfloat16, device=dev,
                              generator=torch.Generator().manual_seed(9))
        eng = GaussianDiffusion.create(student, device=dev, timesteps=1000,
                                       beta_schedule="sigmoid")
        dist = ProgressiveDistiller(dataclasses.replace(eng, t_start=29), student_steps=15)
        dist.freeze_teacher()
        rng = np.random.default_rng(10)
        x0 = np.clip(rng.normal(0, 0.3, (TRAIN_BATCH, 64, 64, 1)), -1, 1).astype(np.float32)
        y = np.clip(x0 + SIGMA * rng.normal(size=x0.shape), -1, 1).astype(np.float32)
        ms = []
        for s_ in range(5):
            torch.cuda.synchronize()
            tc = time.perf_counter()
            dist.step(y, x0, step_generator(0, s_))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - tc) * 1e3)
        phase("distill", tr, run="step_ms", dtype="bfloat16", batch=TRAIN_BATCH,
              step_ms=ms, step_ms_median_last4=float(np.median(ms[1:])), card=card)
        del student, eng, dist
    finally:
        shutil.rmtree(root, ignore_errors=True)
    distill_step_vs_plain(dev, card)
    return cli_launches


def serve_concurrency(dev, card):
    """Phase `serve_concurrency`: tools/torch_serve_concurrency_smoke.py at
    batch 64 in bf16 on random full-width checkpoints written by the port's
    writer: the -u 1 DDRM daemon, then the -u 0 daemon (--sampling-steps 4),
    two clients with two requests each, every concurrent output byte-equal to
    a fresh daemon's serial replay; the daemons' launch counters; solo and
    concurrent request walls."""
    from hicdiff_tpu_torch.convert import params_to_jax
    from hicdiff_tpu_torch.models.hicedrn import HicedrnDiff
    from hicdiff_tpu_torch.train.checkpoint import save_checkpoint
    from tools.torch_serve_concurrency_smoke import main as smoke_main

    t0 = time.time()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    release_device_memory()
    root = tempfile.mkdtemp(prefix="smoke_serve_conc_", dir=os.path.join(ROOT, "build"))
    try:
        paths = {}
        for mode, schedule, seed in (("uncond", "linear", 11), ("cond", "sigmoid", 12)):
            model = HicedrnDiff(self_condition=mode == "cond", number_resnet=BLOCKS,
                                features=FEATURES, device="cpu",
                                generator=torch.Generator().manual_seed(seed))
            paths[mode] = os.path.join(root, f"{mode}.msgpack")
            save_checkpoint(paths[mode], params_to_jax(model.state_dict()), run_config=dict(
                sigma=SIGMA, schedule=schedule, mode=mode, timestep=1000))
        rec = smoke_main(["--ddrm-weights", paths["uncond"], "--cond-weights", paths["cond"],
                          "--sigma", str(SIGMA), "--batch", str(TRAIN_BATCH), "--device",
                          str(dev), "--workdir", os.path.join(root, "work")])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for name in ("ddrm", "cond"):
        for run in ("launches_concurrent", "launches_serial"):
            check(rec[name][run]["fused_resblock"] > 0, f"serve_concurrency {name}: {rec[name]}")
    phase("serve_concurrency", t0, batch=rec["batch"], dtype=rec["dtype"],
          clients=2, requests_per_client=rec["requests_per_client"],
          ddrm=rec["ddrm"], cond=rec["cond"], byte_equal=True, card=card)
    return {name: rec[name]["launches_concurrent"] for name in ("ddrm", "cond")}

# ---- phase 17: the CLIs' and the daemon's sampling over ranks; phase 18: .mcool files
DPS_REQUESTS = 2  # the daemons' timed requests of TRAIN_BATCH patches each
DPS_DDRM_STEPS = 10  # the -u 1 CLIs' DDRM forwards: the auto t* grid cut to 10 (depth)
_LAUNCH_LINE = "kernel launches, rank "


def _eval_timing(log):
    """[(dispatch s, fetch s)] of each rank's '[eval-timing] N batches' line."""
    out = []
    for line in log.splitlines():
        if "[eval-timing]" in line and "batches:" in line:
            parts = dict(p.strip().split(" ")[:2]
                         for p in line.split("batches:", 1)[1].split(","))
            out.append((float(parts["dispatch"][:-1]), float(parts["fetch"][:-1])))
    return out


@contextlib.contextmanager
def _entry_tf32(bf16):
    """TF32 as inference_torch.py's and serve_torch.py's main set it (cuDNN's
    TF32 on only under --bf16, matmuls' off), so that a run in this process
    is the entry point's run."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = bf16, False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _rank_env(rank, world):
    """torchrun's environment of a rank (the rendezvous port set by the rank)."""
    return dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="localhost")


def _union_us(intervals, lo, hi):
    """The time in [lo, hi) that the union of (start, end) intervals covers."""
    total, reach = 0.0, lo
    for a, b in sorted(intervals):
        a, b = max(a, reach), min(b, hi)
        if b > a:
            total += b - a
            reach = b
    return total


def _daemon_requests(sock, work, tag):
    """DPS_REQUESTS denoise requests of TRAIN_BATCH seeded patches on `sock`:
    (latencies, outputs, the requests' window in Unix time, µs)."""
    from hicdiff_tpu_torch.serve import request

    rng = np.random.default_rng(17)
    latencies, outs = [], []
    window = [time.time() * 1e6, None]
    for i in range(DPS_REQUESTS):
        src = os.path.join(work, f"req_{i}.npy")
        if not os.path.exists(src):
            np.save(src, np.clip(rng.normal(0, 0.3, (TRAIN_BATCH, 64, 64, 1)), -1, 1)
                    .astype(np.float32))
        dst = os.path.join(work, f"{tag}_out_{i}.npy")
        tr = time.time()
        resp = request(sock, {"id": i + 1, "op": "denoise", "npy": src, "out": dst})
        latencies.append(time.time() - tr)
        check(resp.get("ok"), f"data_parallel_sampling {tag} request {i}: {resp}")
        outs.append(np.load(dst))
    window[1] = time.time() * 1e6
    return latencies, outs, window


# one rank process of data_parallel_sampling: each entry point's main in turn,
# as torchrun would start it (its own rendezvous port, TF32 at torch's
# defaults as a fresh process finds them, the launch counters from 0); the
# daemon runs under torch.profiler (device activity only), and the rank
# writes its kernels' (start, end, name) on the host's clock (Unix time, µs)
# to argv[2].rank{RANK}.json
_DPS_RANK = """
import json, os, sys
import torch
from torch.autograd import DeviceType
import inference_torch, serve_torch
from hicdiff_tpu_torch.kernels.resblock import fused_resblock
from hicdiff_tpu_torch.kernels.sample_step import fused_posterior_step

for port, entry, argv in json.loads(sys.argv[1]):
    os.environ["MASTER_PORT"] = str(port)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    fused_resblock.launches = fused_posterior_step.launches = 0
    if entry == "inference":
        inference_torch.main(argv)
        continue
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        serve_torch.main(argv)
    base = prof.profiler.kineto_results.trace_start_ns() / 1e3
    with open(f"{sys.argv[2]}.rank{os.environ['RANK']}.json", "w") as f:
        json.dump([(base + e.time_range.start, base + e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA], f)
"""


def data_parallel_sampling(dev, card):
    """Phase 17 `data_parallel_sampling`: the CLIs and the daemon over two
    ranks sharing the card (gloo), full width, on the 120-patch synthetic
    cell. One rank, in this process: the -u 0 CLI in bf16 at --t-start auto
    and the -u 1 CLI (DDRM deno, t* auto on a grid of DPS_DDRM_STEPS) in fp32
    (`inference_torch.Inference`), and a bf16 -u 0 daemon at batch 64
    answering DPS_REQUESTS requests of 64 patches. Two ranks: one pair of
    processes started with torchrun's environment runs inference_torch.py's
    and serve_torch.py's main in turn (the same flags; the daemon under
    torch.profiler, rank 0 on the socket). The CLIs' predictions and the daemon's outputs within DP_TOL; the quartet
    written once (by rank 0); every rank's blocks and steps through the
    kernels by its launch counters; latency, and the idle share of the
    requests' wall (for two ranks, the union of both ranks' busy intervals
    from their traces: a profiler sees one process, and the card
    time-slices two processes' kernels, whose durations then overlap);
    `shutdown` ends both ranks with exit code 0. Returns the launch counts
    by run and rank."""
    import inference_torch
    from hicdiff_tpu_torch.convert import params_to_jax
    from hicdiff_tpu_torch.kernels.resblock import fused_resblock
    from hicdiff_tpu_torch.kernels.sample_step import fused_posterior_step
    from hicdiff_tpu_torch.models.hicedrn import HicedrnDiff
    from hicdiff_tpu_torch.parallel.multihost import free_port
    from hicdiff_tpu_torch.serve import DenoiseService, request, serve_forever
    from hicdiff_tpu_torch.train.checkpoint import save_checkpoint

    t0 = time.time()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="smoke_dps_", dir=os.path.join(ROOT, "build"))
    # both ranks on this process's card, over gloo
    rank_dev = f"cuda:{torch.cuda.current_device()}" if dev.type == "cuda" else str(dev)
    width = ["--blocks", str(BLOCKS), "--features", str(FEATURES)]
    counts = {}
    try:
        write_synthetic_cell(
            root, lambda c: CLI_TEST_BINS if c in CLI_TEST_CHROMS else CLI_OTHER_BINS)
        ckpts = {}
        for mode, schedule, seed in (("cond", "sigmoid", 2), ("uncond", "linear", 7)):
            model = HicedrnDiff(self_condition=mode == "cond", number_resnet=BLOCKS,
                                features=FEATURES, device="cpu",
                                generator=torch.Generator().manual_seed(seed))
            ckpts[mode] = os.path.join(root, "Model_Weights", f"{mode}.msgpack")
            save_checkpoint(ckpts[mode], params_to_jax(model.state_dict()), run_config=dict(
                sigma=SIGMA, schedule=schedule, mode=mode, timestep=1000, percentile=99.0))
            del model
        cli_runs = (("u0_bf16", False, True, "sigmoid", [], DP_TOL[True]["sample"], 30),
                    ("u1_deno_fp32", True, False, "linear",
                     ["--deg", "deno", "--sampling-steps", str(DPS_DDRM_STEPS)],
                     DP_TOL[False]["ddrm"], DPS_DDRM_STEPS))

        # one rank, in this process: the two CLIs, then the daemon
        one = {}
        for run, condition, bf16, schedule, _, _, steps in cli_runs:
            tr = time.time()
            fused_resblock.launches = 0
            fused_posterior_step.launches = 0
            with _entry_tf32(bf16):
                res = inference_torch.Inference(
                    batch_size=CLI_BATCH, sigma_t=SIGMA, condition=condition, root=root,
                    schedule=schedule, timestep=1000, bf16=bf16,
                    weights=ckpts["uncond" if condition else "cond"], t_start="auto",
                    blocks=BLOCKS, features=FEATURES, compute_metrics=False, out_tag="_r1",
                    device=dev, deg="deno", sampling_steps=steps if condition else None)
                torch.cuda.synchronize()
            one[run] = dict(res=res, wall_s=time.time() - tr, launches={
                "fused_resblock": fused_resblock.launches,
                "fused_posterior_step": fused_posterior_step.launches})
        work = os.path.join(root, "serve")
        os.makedirs(work)
        with _entry_tf32(True):
            service = DenoiseService(ckpts["cond"], device=dev, mode="cond", sigma=SIGMA,
                                     batch=TRAIN_BATCH, bf16=True, blocks=BLOCKS,
                                     features=FEATURES)
            sock = os.path.relpath(os.path.join(work, "one.sock"))
            server = threading.Thread(target=serve_forever, args=(service, sock), daemon=True)
            server.start()
            for _ in range(200):
                if os.path.exists(sock):
                    break
                time.sleep(0.05)
            check(request(sock, {"id": 0, "op": "ping"}).get("ok"), "one-rank daemon ping")
            fused_resblock.launches = 0
            fused_posterior_step.launches = 0
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                lat1, out1, _ = _daemon_requests(sock, work, "one")
                torch.cuda.synchronize()
        daemon_one = {"fused_resblock": fused_resblock.launches,
                      "fused_posterior_step": fused_posterior_step.launches}
        busy1 = sum(d for _, _, d in device_ops(prof)) / 1e6
        check(request(sock, {"id": 9, "op": "shutdown"}).get("ok"), "one-rank daemon shutdown")
        server.join(timeout=60)
        del service
        held_gb = release_device_memory()

        # two ranks: one pair of processes runs the two CLIs, then the daemon
        sock2 = os.path.relpath(os.path.join(work, "two.sock"))
        trace = os.path.join(work, "trace")
        entries = [(free_port(), "inference",
                    ["-u", "1" if condition else "0", "-s", str(SIGMA), "--schedule", schedule,
                     "--t-start", "auto", "-b", str(CLI_BATCH), "--root", root,
                     "--weights", ckpts["uncond" if condition else "cond"], "--no-metrics",
                     "--out-tag", "_r2", "--device", rank_dev, "--dist-backend", "gloo",
                     *width, *extra, *(["--bf16"] if bf16 else [])])
                   for _, condition, bf16, schedule, extra, _, _ in cli_runs]
        entries.append((free_port(), "serve",
                        ["--socket", sock2, "--weights", ckpts["cond"], "-u", "0", "-s",
                         str(SIGMA), "--t-start", "auto", "--batch", str(TRAIN_BATCH), "--bf16",
                         "--device", rank_dev, "--dist-backend", "gloo", *width]))
        logs = [os.path.join(work, f"rank{r}.log") for r in range(DP_RANKS)]
        tp = time.time()
        procs = []
        for r in range(DP_RANKS):
            with open(logs[r], "w") as fh:
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", _DPS_RANK, json.dumps(entries), trace], cwd=ROOT,
                    env=dict(_rank_env(r, DP_RANKS), HICDIFF_EVAL_TIMING="1"), stdout=fh,
                    stderr=subprocess.STDOUT))
        try:
            while not os.path.exists(sock2):
                check(time.time() - tp < 600 and all(p.poll() is None for p in procs),
                      "two ranks: the CLIs or the daemon did not start: " + " | ".join(
                          open(log).read()[-1500:] for log in logs))
                time.sleep(0.1)
            clis_s = time.time() - tp
            ping = request(sock2, {"id": 0, "op": "ping"})
            check(ping.get("ok") and ping["world_size"] == DP_RANKS
                  and ping["batch"] == TRAIN_BATCH, f"two-rank daemon ping: {ping}")
            lat2, out2, window = _daemon_requests(sock2, work, "two")
            check(request(sock2, {"id": 9, "op": "shutdown"}).get("ok"), "two-rank shutdown")
            codes = [p.wait(timeout=120) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        pair_s = time.time() - tp
        check(codes == [0] * DP_RANKS, f"two ranks' exit codes {codes}")
        texts = [open(log).read() for log in logs]
        # per rank: the launch lines of the -u 0 CLI, the -u 1 CLI and the daemon
        ranks = [[json.loads(line.split(": ", 1)[1]) for line in text.splitlines()
                  if _LAUNCH_LINE in line] for text in texts]
        timing = [_eval_timing(text) for text in texts]
        cli_s = [float(line.split(" in ")[1].split("s,")[0]) for line in texts[0].splitlines()
                 if line.startswith("inference is done in ")]
        check(all(len(r) == 3 for r in ranks) and len(cli_s) == 2
              and all(len(t) == 2 for t in timing),
              f"two ranks' logs: launches {ranks}, cli_s {cli_s}, timing {timing}")

        for i, (run, condition, bf16, _, _, bar, steps) in enumerate(cli_runs):
            res = one[run]["res"]
            n = len(res["inds"])
            batches = -(-n // CLI_BATCH)
            want = {"fused_resblock": batches * steps * BLOCKS * 2,
                    "fused_posterior_step": 0 if condition else batches * steps}
            by_rank = {f"rank{r}": ranks[r][i] for r in range(DP_RANKS)}
            check(one[run]["launches"] == want and all(c == want for c in by_rank.values()),
                  f"data_parallel_sampling {run}: one rank {one[run]['launches']}, two "
                  f"{by_rank}, want {want} each")
            p1 = np.load(os.path.join(res["outdir"], "predict.npy"))
            p2 = np.load(os.path.join(res["outdir"][:-len("_r1")] + "_r2", "predict.npy"))
            err = float(np.abs(p1 - p2).max())
            check(p1.shape == p2.shape == (n, 1, 64, 64) and np.isfinite(p2).all()
                  and err <= bar, f"data_parallel_sampling {run}: max diff {err} > {bar}")
            check(texts[0].count("outputs:") == 2 and "outputs:" not in texts[1],
                  f"data_parallel_sampling {run}: the quartet not written by rank 0 alone")
            counts[run] = {"one_rank": one[run]["launches"], **by_rank}
            phase("data_parallel_sampling", t0 if i == 0 else tp, run=run, ranks=DP_RANKS,
                  backend="gloo", device=f"{rank_dev} (both ranks)",
                  dtype="bfloat16" if bf16 else "float32", blocks=BLOCKS, features=FEATURES,
                  batch=CLI_BATCH, patches=n, steps=steps, max_abs_diff=err, tol=bar,
                  largest=float(np.abs(p1).max()), launches=counts[run],
                  one_rank_in_process_s=one[run]["wall_s"],
                  one_rank_sampling_s=res["timing"]["dispatch"] + res["timing"]["fetch"],
                  two_rank_cli_s=cli_s[i], two_rank_sampling_s=[t[i][0] + t[i][1]
                                                                for t in timing],
                  card=card)

        # each rank's kernels inside the requests' window (its warm-up and
        # idle keepalives lie outside it)
        spans = [[(max(a, window[0]), min(b, window[1]), name)
                  for a, b, name in json.load(open(f"{trace}.rank{r}.json"))
                  if b > window[0] and a < window[1]] for r in range(DP_RANKS)]
        # the ranks' kernels are time-sliced on the card: their durations
        # overlap, so the busy time is the union of both ranks' intervals
        busy2 = _union_us([(a, b) for ss in spans for a, b, _ in ss], *window) / 1e6
        per_rank = [_union_us([(a, b) for a, b, _ in ss], *window) / 1e6 for ss in spans]
        # the ranks' clocks are the host's: each rank's work lies inside the window
        check(all(b > 0 for b in per_rank) and busy2 * 1e6 <= window[1] - window[0],
              f"data_parallel_sampling daemon: busy by rank {per_rank}, union {busy2} s")
        tops = []
        for ss in spans:
            by_name = {}
            for a, b, name in ss:
                count, us = by_name.get(name, (0, 0.0))
                by_name[name] = (count + 1, us + b - a)
            tops.append([{"name": k[:90], "count": c, "us": us} for k, (c, us)
                         in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:4]])
        # each rank's daemon counts: its launch line less the warm-up's chunk
        chunk = {"fused_resblock": 30 * BLOCKS * 2, "fused_posterior_step": 30}
        rank_counts = {f"rank{r}": {k: ranks[r][2][k] - chunk[k] for k in chunk}
                       for r in range(DP_RANKS)}
        want = {k: DPS_REQUESTS * chunk[k] for k in chunk}
        check(daemon_one == want and all(c == want for c in rank_counts.values()),
              f"data_parallel_sampling daemon launches: one {daemon_one}, two {rank_counts}")
        bar = DP_TOL[True]["sample"]
        errs = [float(np.abs(a - b).max()) for a, b in zip(out1, out2)]
        check(max(errs) <= bar, f"data_parallel_sampling daemon: max diff {errs} > {bar}")
        counts["daemon_bf16"] = {"one_rank": daemon_one, **rank_counts}
        phase("data_parallel_sampling", tp, run="daemon_bf16", ranks=DP_RANKS,
              backend="gloo", batch=TRAIN_BATCH, steps=30, requests=DPS_REQUESTS,
              max_abs_diff=errs, tol=bar, latency_s_one_rank=lat1, latency_s_two_ranks=lat2,
              device_busy_s_one_rank=busy1, device_busy_s_two_ranks=busy2,
              idle_share_one_rank=1 - busy1 / sum(lat1),
              idle_share_two_ranks=1 - busy2 * 1e6 / (window[1] - window[0]),
              two_rank_window_s=(window[1] - window[0]) / 1e6,
              device_busy_s_by_rank=per_rank,
              device_time_s_by_rank=[sum(b - a for a, b, _ in ss) / 1e6 for ss in spans],
              two_rank_start_to_socket_s=clis_s, two_rank_pair_s=pair_s, exit_codes=codes,
              launches=counts["daemon_bf16"], smoke_process_allocated_gb=held_gb,
              top_two_ranks=tops, card=card)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return counts


def mcool_phase(dev, card):
    """Phase 18 `mcool`: .mcool files through the port's HDF5 module on the
    card's machine (no h5py). The full-scale fixture's cell (hg19's 22
    chromosomes, 72,031 bins at 40 kb, tools/torch_make_fullscale_fixture.py
    seed 7) written with write_cooler, read back by McoolFile, every
    chromosome fetched (timed) and held equal to the arrays written. At 512
    bins a chromosome: stage 1 (`extract_constraint_mats`) from the tool's
    .mcool writes Constraints/ text byte-equal to the tool's direct text; a
    `denoise_mcool` request to a bf16 DenoiseService (DDIM K=1, so the same
    patches give the same output) writes an .mcool that reads back equal to
    `assemble_chromosome` of `denoise_patches` through `to_unit`; the bf16
    -u 0 CLI (K=1) from the .mcool's cache with --export-mcool writes a file
    the reader opens, equal to its dense export. Returns launch counts."""
    import filecmp

    import inference_torch
    from hicdiff_tpu_torch.convert import params_to_jax
    from hicdiff_tpu_torch.data.assemble import assemble_chromosome, to_unit
    from hicdiff_tpu_torch.data.datamodule import GSE130711Module
    from hicdiff_tpu_torch.data.mcool import McoolFile, write_cooler
    from hicdiff_tpu_torch.data.preprocess import coo_to_dense, normalize_matrix, split_pieces
    from hicdiff_tpu_torch.kernels.resblock import fused_resblock
    from hicdiff_tpu_torch.kernels.sample_step import fused_posterior_step
    from hicdiff_tpu_torch.models.hicedrn import HicedrnDiff
    from hicdiff_tpu_torch.serve import DenoiseService
    from hicdiff_tpu_torch.train.checkpoint import save_checkpoint
    from tools.torch_make_fullscale_fixture import (
        HG19_BINS_40KB,
        cell_pixels,
        constraints_dir,
        make_fullscale,
        make_fullscale_mcool,
    )

    t0 = time.time()
    res = 40000
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="smoke_mcool_", dir=os.path.join(ROOT, "build"))
    launches = {}
    try:
        # 1. the full-scale cell: write, open, fetch every chromosome
        weights, chroms = cell_pixels(seed=7)
        pixels = [(r, c, v) for r, c, v, _ in chroms]
        offsets = np.concatenate([[0], np.cumsum(HG19_BINS_40KB)])
        bin1 = np.concatenate([r + o for (r, _, _), o in zip(pixels, offsets)])
        bin2 = np.concatenate([c + o for (_, c, _), o in zip(pixels, offsets)])
        count = np.concatenate([v for _, _, v in pixels])
        gen_s = time.time() - t0
        path = os.path.join(root, "fullscale.mcool")
        tw = time.time()
        write_cooler(path, res, [f"chr{i + 1}" for i in range(22)], HG19_BINS_40KB,
                     bin1, bin2, count, weights)
        write_s = time.time() - tw
        to = time.time()
        mc = McoolFile(path, res)
        open_s = time.time() - to
        check(mc.chromnames == [f"chr{i + 1}" for i in range(22)]
              and mc.chromsizes.tolist() == [n * res for n in HG19_BINS_40KB],
              f"mcool: chromosomes {mc.chromnames}")
        fetch_s = []
        for ci, (r, c, v) in enumerate(pixels):
            tf = time.time()
            px = mc.fetch(f"chr{ci + 1}")
            fetch_s.append(time.time() - tf)
            w = weights[offsets[ci]:offsets[ci + 1]]
            want = np.nan_to_num(v.astype(np.float64) * w[r] * w[c], nan=0.0)
            check(np.array_equal(px.start1, r * res) and np.array_equal(px.start2, c * res)
                  and np.array_equal(px.count, v.astype(np.float64))
                  and np.array_equal(px.balanced, want), f"mcool: chr{ci + 1} differs")
        n_full = len(bin1)
        del pixels, bin1, bin2, count
        phase("mcool", t0, run="fullscale_write_read", bins=int(offsets[-1]),
              pixels=n_full, file_bytes=os.path.getsize(path),
              generate_s=gen_s, write_s=write_s, open_s=open_s, fetch_s=fetch_s,
              fetch_total_s=sum(fetch_s), equal=True, card=card)

        # 2. stage 1 at 512 bins a chromosome: byte-equal to the tool's text
        tr = time.time()
        bins = [FULLSCALE_BINS] * 22
        text = constraints_dir(os.path.join(root, "text"), SIGMA, 99.99)
        make_fullscale(text, seed=7, bins_per_chrom=bins)
        mroot = os.path.join(root, "cell")
        mpath = os.path.join(mroot, "Datasets", "Human", "cell1_fixture.mcool")
        n_bins, n_pixels = make_fullscale_mcool(mpath, seed=7, bins_per_chrom=bins)
        ts = time.time()
        dm = GSE130711Module(root=mroot, sigma_0=SIGMA, percentile=99.99, cell_No=1, res=res,
                             deg="deno")
        dm.extract_constraint_mats()
        stage1_s = time.time() - ts
        names = sorted(os.listdir(text))
        match, mismatch, errors = filecmp.cmpfiles(text, os.path.join(dm.dirname, "Constraints"),
                                                   names, shallow=False)
        check(len(names) == 44 and not mismatch and not errors,
              f"mcool stage 1: {mismatch + errors} differ from the tool's text")
        phase("mcool", tr, run="stage1_byte_equal", bins=n_bins, pixels=n_pixels,
              files=len(match), stage1_s=stage1_s, card=card)

        # 3. denoise_mcool through a bf16 service, against its own patches
        tr = time.time()
        model = HicedrnDiff(self_condition=True, number_resnet=BLOCKS, features=FEATURES,
                            device="cpu", generator=torch.Generator().manual_seed(5))
        ckpt = os.path.join(root, "cond.msgpack")
        save_checkpoint(ckpt, params_to_jax(model.state_dict()), run_config=dict(
            sigma=SIGMA, schedule="sigmoid", mode="cond", timestep=1000, percentile=99.99))
        del model
        service = DenoiseService(ckpt, device=dev, mode="cond", sigma=SIGMA, batch=CLI_BATCH,
                                 bf16=True, blocks=BLOCKS, features=FEATURES, sampling_steps=1)
        out_path = os.path.join(root, "denoised.mcool")
        fused_resblock.launches = 0
        fused_posterior_step.launches = 0
        td = time.time()
        resp = service.handle({"id": 1, "op": "denoise_mcool", "mcool": mpath,
                               "out_mcool": out_path, "res": res})
        torch.cuda.synchronize()
        request_s = time.time() - td
        launches["denoise_mcool"] = {"fused_resblock": fused_resblock.launches,
                                     "fused_posterior_step": fused_posterior_step.launches}
        check(resp.get("ok") and len(resp["chromosomes"]) == 22, f"denoise_mcool: {resp}")
        src, got = McoolFile(mpath, res), McoolFile(out_path, res)
        worst = 0.0
        for name in src.chromnames:
            px = src.fetch(name)
            dense, _, _ = coo_to_dense(px.start1, px.start2, px.balanced, res)
            norm = normalize_matrix(dense, service.percentile)
            out = service.denoise_patches(split_pieces(norm, piece_size=64, step=64, resol=res))
            want = to_unit(assemble_chromosome(out, norm.shape[0], resol=res))
            back = got.fetch(name)
            mat = np.zeros_like(want)
            mat[back.start1 // res, back.start2 // res] = back.count
            iu = np.triu_indices(want.shape[0])
            worst = max(worst, float(np.abs(mat[iu] - want[iu]).max()))
        check(worst == 0.0, f"denoise_mcool: read back {worst} from denoise_patches")
        want_launches = 22 * BLOCKS * 2  # one chunk a chromosome, K=1: one forward
        check(launches["denoise_mcool"] == {"fused_resblock": want_launches,
                                            "fused_posterior_step": 0},
              f"denoise_mcool launches {launches['denoise_mcool']}")
        del service
        phase("mcool", tr, run="denoise_mcool_bf16", chromosomes=22, sampling_steps=1,
              request_s=request_s, max_abs_diff=worst, launches=launches["denoise_mcool"],
              card=card)

        # 4. the CLI from the .mcool's cache, --export-mcool
        tr = time.time()
        export = os.path.join(root, "export.mcool")
        fused_resblock.launches = 0
        fused_posterior_step.launches = 0
        out = inference_torch.Inference(
            batch_size=CLI_BATCH, sigma_t=SIGMA, condition=False, root=mroot, schedule="sigmoid",
            timestep=1000, bf16=True, weights=ckpt, sampling_steps=1, t_start="auto",
            blocks=BLOCKS, features=FEATURES, compute_metrics=False, export_mcool=export,
            device=dev)
        torch.cuda.synchronize()
        cli_s = time.time() - tr
        launches["export_cli_k1"] = {"fused_resblock": fused_resblock.launches,
                                     "fused_posterior_step": fused_posterior_step.launches}
        exported = McoolFile(export, res)
        check(exported.chromnames == [f"chr{c}" for c in CLI_TEST_CHROMS],
              f"--export-mcool chromosomes {exported.chromnames}")
        for c in CLI_TEST_CHROMS:
            want = to_unit(np.load(os.path.join(out["outdir"], f"dense_chr_{c}.npy")))
            back = exported.fetch(f"chr{c}")
            mat = np.zeros_like(want)
            mat[back.start1 // res, back.start2 // res] = back.count
            iu = np.triu_indices(want.shape[0])
            check(np.array_equal(mat[iu], want[iu].astype(np.float32)),
                  f"--export-mcool chr{c} differs from its dense export")
        check(launches["export_cli_k1"] == {"fused_resblock": 2 * BLOCKS * 2,
                                            "fused_posterior_step": 0},
              f"--export-mcool CLI launches {launches['export_cli_k1']}")
        phase("mcool", tr, run="export_mcool_cli_k1", patches=len(out["inds"]), cli_s=cli_s,
              file_bytes=os.path.getsize(export), launches=launches["export_cli_k1"],
              card=card)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches


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
                shift.data_ptr(), scale.stride(0), None, hidden.data_ptr(), None, b, h, w, c,
                1, stream), "conv3x3")

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
    # the CLI's fp32 batch of 64, as its blocks call the kernel (weight prepared once)
    t0 = time.time()
    xc, kc, bc, tec = (t.to(dev) for t in resblock_inputs(CLI_RESBLOCK_SHAPE, g))
    sc, hc = tec.chunk(2, dim=-1)
    wc = prepare_weight(kc)
    got = fused_resblock_prepared(xc, wc, bc, sc, hc)
    want = fused_resblock_reference(xc, kc, bc, sc, hc)
    torch.cuda.synchronize()
    cli_conv_err = (got - want).abs().max().item()
    check(cli_conv_err <= 1e-4,
          f"fused_resblock float32 {CLI_RESBLOCK_SHAPE}: max-abs {cli_conv_err} > 1e-4")
    cli_conv_ms = cuda_ms(lambda: fused_resblock_prepared(xc, wc, bc, sc, hc), iters=10)
    cli_conv_plain_ms = cuda_ms(lambda: fused_resblock_reference(xc, kc, bc, sc, hc), iters=10)
    phase("fused_resblock_cli_shape", t0, dtype=str(torch.float32), shape=CLI_RESBLOCK_SHAPE,
          max_abs_err=cli_conv_err, tol=1e-4, ms=cli_conv_ms, plain_ms=cli_conv_plain_ms,
          card=card)
    del xc, kc, bc, tec, sc, hc, wc, got, want

    # ---- 3. fused_posterior_step kernel vs plain
    t0 = time.time()
    a_, b_, c1, c2, logvar = 1.1, 0.5, 0.7, 0.3, -2.0
    xs = torch.randn(STEP_SHAPE, generator=g).to(dev)
    es = torch.randn(STEP_SHAPE, generator=g).to(dev)
    out, x0 = fused_posterior_step(xs, es, a_, b_, c1, c2, logvar, 0.0, 123)
    want_out, want_x0 = fused_posterior_step_reference(xs, es, a_, b_, c1, c2, logvar, 0.0, 123)
    step_err = max((out - want_out).abs().max().item(), (x0 - want_x0).abs().max().item())
    check(step_err <= 1e-6, f"fused_posterior_step gate=0: max-abs {step_err} > 1e-6")
    xs64 = torch.randn(CLI_STEP_SHAPE, generator=g).to(dev)
    es64 = torch.randn(CLI_STEP_SHAPE, generator=g).to(dev)
    out64, x064 = fused_posterior_step(xs64, es64, a_, b_, c1, c2, logvar, 0.0, 321)
    want_out64, want_x064 = fused_posterior_step_reference(xs64, es64, a_, b_, c1, c2, logvar,
                                                           0.0, 321)
    step_err_cli = max((out64 - want_out64).abs().max().item(),
                       (x064 - want_x064).abs().max().item())
    check(step_err_cli <= 1e-6,
          f"fused_posterior_step gate=0 {CLI_STEP_SHAPE}: max-abs {step_err_cli} > 1e-6")
    # a shard at offset k (its first element over 4) draws the whole batch's
    # noise at its elements: rows [r, r + n) of one launch over the batch
    whole, whole_x0 = fused_posterior_step(xs64, es64, a_, b_, c1, c2, logvar, 1.0, 11)
    row = xs64[0].numel()
    offset_equal = {}
    for r, n in ((32, 32), (7, 18), (63, 1)):
        part, part_x0 = fused_posterior_step(xs64[r:r + n].contiguous(),
                                             es64[r:r + n].contiguous(), a_, b_, c1, c2,
                                             logvar, 1.0, 11, offset=r * row // 4)
        offset_equal[f"rows {r}-{r + n}"] = (torch.equal(part, whole[r:r + n])
                                             and torch.equal(part_x0, whole_x0[r:r + n]))
    check(all(offset_equal.values()), f"fused_posterior_step offset: {offset_equal}")
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
          cli_shape=CLI_STEP_SHAPE, max_abs_err_gate0_cli_shape=step_err_cli,
          noise_elements=xn.numel(), noise_mean=noise_mean, noise_std=noise_std,
          ms=step_ms, plain_ms=step_plain_ms, device_ms=step_dev_ms,
          plain_device_ms=step_plain_dev_ms, bound_ms=step_bound, bound_by=step_bound_by,
          share_of_bound=step_bound / step_ms, share_of_bound_device=step_bound / step_dev_ms,
          floor_device_ms=floor_dev_ms, host_us=post_host_us,
          offset_bit_equal_to_whole_batch=offset_equal, card=card)

    # ---- 3b. the block's backward kernels vs the plain twin, timed beside their bounds
    bwd_rows = resblock_backward(dev, card, g)
    bwd_rows_bf16 = resblock_backward_bf16(dev, card, g)
    modes_bf16 = conv_modes_bf16(dev, card)

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

    # ---- 7. the -u 0 inference CLI, fp32, on a synthetic cell prepared from text
    cli = inference_cli(dev, card)

    # ---- 8. the -u 0 trainer through train_torch.py's entry class, full width, batch 64
    train_launches = train(dev, card)

    # ---- 9. one training step, kernel path (CUDA) vs plain path (CPU)
    train_step_vs_plain(dev, card)

    # ---- 9b. bf16 training: train_torch.py --bf16, and its steps against the CPU's
    train_bf16 = train(dev, card, bf16=True)
    train_step_vs_plain(dev, card, bf16=True)

    # ---- 10. the -u 1 path: the operators, a DDRM chain held to the plain path,
    # the -u 1 CLI, the daemon's mode="ddrm" and unconditional training
    ddrm_operators(dev, card)
    ddrm_chain_vs_plain(dev, card)
    cli_ddrm = inference_cli_ddrm(dev, card)
    served_ddrm = serve_ddrm(dev, card)
    train_uncond = train(dev, card, condition=True)
    train_uncond_bf16 = train(dev, card, condition=True, bf16=True)

    # ---- 11. the zoo: every backbone's forward against its plain path, the
    # --model CLI runs, pretrain_torch.py and two zoo training steps vs plain
    zoo_counts = zoo(dev, card)
    zoo_cli, zoo_pre = zoo_counts["cli"], zoo_counts["pretrain"]
    zoo_pre_bf16 = zoo_counts["pretrain_bf16"]

    # ---- 12. the baselines: every module's forward against its plain CPU run,
    # pretrain_baselines_torch.py, one step of each vs the CPU, their metrics
    baselines(dev, card)

    # ---- 13. the analysis tail: threed_comp_torch.py over the inference_cli
    # phase's quartet and in baseline mode, insulation, the stard_metric scripts
    scripts = analysis_tail(dev, card, cli["quartet"], cli["quartet_name"])

    # ---- 14. the full-scale protocol's fixture, latent target and scoring at
    # reduced bins; 15. the engine's objectives, DDIM options and the 7b models
    fullscale = fullscale_fixture(dev, card)
    options = engine_options(dev, card)

    # ---- 16. data parallelism (multihost.py's launcher: 1 vs 2 ranks on the
    # card, a one-rank NCCL world), progressive distillation, serve concurrency
    dp = data_parallel(dev, card)
    distilled = distill(dev, card)
    concurrency = serve_concurrency(dev, card)

    # ---- 17. the CLIs and the daemon over two ranks sharing the card; 18. .mcool
    # files read and written through the port's HDF5 module
    dps = data_parallel_sampling(dev, card)
    mcool = mcool_phase(dev, card)

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
         "launches_fp32": served32["resblock_launches"],
         "launches_cli": cli["resblock_launches"],
         "launches_reference_weights_cli": cli["refw_resblock_launches"],
         "launches_train": train_launches["fused_resblock"],
         "launches_train_bf16": train_bf16["fused_resblock"],
         "launches_ddrm_cli": cli_ddrm["resblock_launches"],
         "launches_ddrm_serve_fp32": served_ddrm["float32"]["resblock_launches"],
         "launches_ddrm_serve_bf16": served_ddrm["bfloat16"]["resblock_launches"],
         "launches_train_uncond": train_uncond["fused_resblock"],
         "launches_per_forward_zoo": zoo_counts["forward"],
         "launches_cli_zoo": {k: v["resblock_launches"] for k, v in zoo_cli.items()},
         "launches_pretrain_zoo": {k: v["fused_resblock"] for k, v in zoo_pre.items()},
         "launches_stard_metric": {k: v["resblock_launches"] for k, v in scripts.items()},
         "launches_fullscale_cli_k1": fullscale["cond_k1"]["resblock_launches"],
         "launches_fullscale_cli_ddrm": fullscale["ddrm"]["resblock_launches"],
         "launches_engine_options_chain": {k: v["resblock_launches"]
                                           for k, v in options.items()},
         "launches_data_parallel_rank0": {k: v["fused_resblock"] for k, v in dp.items()},
         "launches_distill_k1_cli": distilled["resblock_launches"],
         "launches_serve_concurrency": {k: v["fused_resblock"]
                                        for k, v in concurrency.items()},
         "launches_data_parallel_sampling": {
             run: {rank: c["fused_resblock"] for rank, c in by_rank.items()}
             for run, by_rank in dps.items()},
         "launches_mcool": {k: v["fused_resblock"] for k, v in mcool.items()}},
        {"name": "fused_posterior_step", "route": "cuda",
         "source": "hicdiff_tpu_torch/csrc/sample_step.cu",
         "replaces": "hicdiff_tpu/kernels/sample_step.py:65",
         "launches": step_launches, "max_abs_err": step_err, "ms": step_ms,
         "plain_ms": step_plain_ms, "bound_ms": step_bound, "bound_by": step_bound_by,
         "library_ms": None, "device_ms": step_dev_ms, "floor_device_ms": floor_dev_ms,
         "host_us": post_host_us, "launches_fp32": served32["step_launches"],
         "launches_cli": cli["step_launches"],
         "launches_reference_weights_cli": cli["refw_step_launches"],
         "launches_ddrm_cli": cli_ddrm["step_launches"],
         "launches_cli_zoo": {k: v["step_launches"] for k, v in zoo_cli.items()},
         "launches_stard_metric": {k: v["step_launches"] for k, v in scripts.items()},
         "launches_fullscale_cli_k1": fullscale["cond_k1"]["step_launches"],
         "launches_fullscale_cli_ddrm": fullscale["ddrm"]["step_launches"],
         "launches_engine_options_chain": {k: v["step_launches"] for k, v in options.items()},
         "launches_data_parallel_rank0": {k: v["fused_posterior_step"] for k, v in dp.items()},
         "launches_data_parallel_sampling": {
             run: {rank: c["fused_posterior_step"] for rank, c in by_rank.items()}
             for run, by_rank in dps.items()},
         "offset_bit_equal_to_whole_batch": offset_equal},
    ]
    # the backward (and the training forward): port-only kernels, no Pallas kernel to replace
    sources = {"fused_resblock_dgrad": "hicdiff_tpu_torch/csrc/resblock.cu",
               "resblock_wgrad": "hicdiff_tpu_torch/csrc/resblock_bwd.cu",
               "resblock_channel_sums": "hicdiff_tpu_torch/csrc/resblock_bwd.cu"}
    for name, row in bwd_rows.items():
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name],
            "replaces": "none: the autodiff of hicdiff_tpu/models/hicedrn.py:55-64 "
                        "(the JAX package has no Pallas backward)",
            "launches": train_launches[name], "launches_train_uncond": train_uncond[name],
            "launches_pretrain_zoo": {k: v[name] for k, v in zoo_pre.items()},
            "dtype": "float32", **row})
    # bf16 training's rows, and the bf16 kernel's modes onto the att variant's
    # fp32 stream, whose launches are bf16 hicedrn_att's pretrain_torch.py run
    att = "hicedrn_att_uncond_pure_noise_bf16"
    for name, row in bwd_rows_bf16.items():
        stream = name.endswith("_f32_stream")
        base = name[:-len("_f32_stream")] if stream else name
        entry = {"name": name if stream else f"{name}_bf16", "route": "cuda",
                 "source": sources.get(base, "hicdiff_tpu_torch/csrc/resblock.cu"),
                 "replaces": "none: the autodiff of hicdiff_tpu/models/hicedrn.py:55-64 "
                             "(the JAX package has no Pallas backward)",
                 "dtype": "bfloat16"}
        if name == "fused_resblock_train":
            entry["replaces"] = ("hicdiff_tpu/kernels/resblock.py:101, keeping z and h (the "
                                 "JAX package trains through hicdiff_tpu/models/hicedrn.py:55-64)")
        if stream:
            entry["launches"] = zoo_pre_bf16[att][name]
            # the fp32-stream mode alone at the training batch (conv_modes_bf16)
            alone = 6 if base == "fused_resblock" else 7
            entry[f"mode{alone}_alone_batch64"] = {
                **modes_bf16[TRAIN_BATCH][f"mode{alone}"],
                "bound_ms": modes_bf16[TRAIN_BATCH]["bound_ms"]}
            if base == "fused_resblock":
                entry["replaces"] = ("hicdiff_tpu/kernels/resblock.py:101, on the att "
                                     "variant's fp32 stream (the JAX package runs those "
                                     "blocks through hicdiff_tpu/models/hicedrn.py:55-64)")
                entry["launches_per_forward_zoo_bf16"] = zoo_counts["forward_stream"]
        else:
            entry.update(launches=train_bf16[name],
                         launches_train_uncond_bf16=train_uncond_bf16[name],
                         launches_pretrain_zoo_bf16={k: v[name] for k, v in zoo_pre_bf16.items()})
        kernels.append({**entry, **row})
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
