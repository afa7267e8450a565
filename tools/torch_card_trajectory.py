"""A full-width training trajectory of the card's kernels against their plain
twins: the link between tests/test_torch_trajectory.py (the twins against
JAX over 100 steps, small, on the CPU) and chip_smoke.py's
`train_step_vs_plain` (the kernels against the twins at full width, two
steps). A rounding difference that compounds over many steps (the
persistent conv modes, the bf16 wgrad's split-K flushes, the channel sums)
passes both of those and shows here.

Per mode (`u0`: the conditional engine on the self-conditioned backbone at
the sigmoid schedule; `u1`: the unconditional engine on the plain backbone
at the linear schedule; T = 1000, the full-scale protocols' engines), one
seeded init of the base `HicedrnDiff` (32 blocks of 256 features by
default) is copied to four sides, each a `Trainer` at lr 2e-5 and EMA
0.999: the card in bf16 (the bf16 kernels) and in fp32 (the 3xTF32
kernels), the CPU in bf16 and in fp32 (the plain twins). Every side takes
the same `--steps` steps of `Trainer.train_step(data, target, t=, noise=)`
on one numpy stream of batches (2 patches) and draws. TF32 as the
entry points set it: cuDNN's on in bf16 only, the matmuls' off.

Bars, fixed before the first card run:

- bf16 (the rule of tests/test_torch_bf16.py's `assert_bf16_bar`, which
  tests/test_torch_trajectory.py applies): after the last step the card's
  bf16 params lie no farther (L2 over all params) from the CPU's bf16
  params, or no farther from the CPU's fp32 params, than those two lie
  from each other: min(card - cpu_bf16, card - cpu_fp32) <= cpu_bf16 -
  cpu_fp32. Both distances are reported. The card and the twin round at
  the same points, so the card's distance to fp32 is the twin's give or
  take their sums' order, a tie that neither side of an AND should hinge
  on; a kernel fault lies far from both. The mean relative gap of the
  card's bf16 losses to the CPU's bf16 losses is at most 1e-2.
- fp32, card against CPU. The CPU test's 1e-5 of each leaf's largest
  magnitude cannot hold for every tensor over 100 steps at full width:
  `train_step_vs_plain`'s two-step readings already put the card's fp32
  gradients 5.05e-5 of their leaf's largest value from the twin's, and
  Adam turns such gaps on near-zero gradients into update gaps of up to
  2 lr a step. So the bars are those readings' own bars, carried over:
  every step's loss within 1e-4 relative (its `loss_tol`; read: 9.6e-7);
  Adam's mu and nu within 1e-3 of their leaf's largest magnitude (its
  gradient bar; read: 5.05e-5); params and EMA within 1e-5 of max(their
  leaf's largest magnitude, 1), as the CPU test, for all but 1e-5 of the
  weights every two steps (its outlier share, scaled by the steps: at 100
  steps 5e-4 of them).

Each mode also records the first step's gradients leaf by leaf (card
against CPU in each dtype, and each bf16 side against the CPU's fp32).
`--diagnose` adds, for the first step, the head conv's output, each
block's output and the model's, with their gradients, in forward order:
the first whose card-to-fp32 distance exceeds the CPU bf16's names where
the card leaves the twin. It also runs a fifth side (the card in bf16
with cuBLAS's reduced-precision bf16 reductions off) and checks where a
bf16 conv or Dense with a bias rounds on either device (`bias_rounding`).

Run on the card (the CPU sides take most of the time: 5-7 s a step in
fp32 and 7-8 s in bf16 at full width and batch 2, about 27 min a mode on
6 threads):

  python tools/torch_card_trajectory.py --modes u0 --out chiprun_out/traj_u0.json

On the CPU (both "card" sides then run the twins, so the bars hold
trivially):

  python tools/torch_card_trajectory.py --device cpu --blocks 2 --features 16 \\
      --size 16 --steps 3

It prints one JSON line per mode (distances, per-step loss gaps, the bars
and each side's wall time), writes every leaf's numbers to `--out`, and
exits 1 when a bar fails.
"""
import argparse
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from hicdiff_tpu_torch.diffusion.gaussian import GaussianDiffusion  # noqa: E402
from hicdiff_tpu_torch.models.hicedrn import HicedrnDiff  # noqa: E402
from hicdiff_tpu_torch.train.trainer import Trainer  # noqa: E402
from tools.torch_fullscale_quality import card_name_and_limit  # noqa: E402

T, LR, EMA = 1000, 2e-5, 0.999
BATCH, SEED = 2, 0  # train_step_vs_plain's batch; the init's seed (the batches': SEED + 1)
MODES = {"u0": dict(self_condition=True, schedule="sigmoid", mode="cond"),
         "u1": dict(self_condition=False, schedule="linear", mode="uncond")}
SIDES = (("card", "bf16"), ("card", "fp32"), ("cpu", "bf16"), ("cpu", "fp32"))
BF16_LOSS_GAP = 1e-2     # mean relative loss gap, card bf16 to CPU bf16
FP32_LOSS_TOL = 1e-4     # each step's relative loss gap, card fp32 to CPU fp32
FP32_MOMENT_TOL = 1e-3   # mu and nu, of their leaf's largest magnitude
FP32_PARAM_TOL = 1e-5    # params and EMA, of max(their leaf's largest magnitude, 1)
FP32_OUTLIER_SHARE = 1e-5  # of the weights, every two steps


def make_batches(steps: int, batch: int, size: int, seed: int) -> list:
    """Each step's (data, target, t, noise), from one numpy stream."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        target = np.clip(rng.normal(0, 0.3, (batch, size, size, 1)), -1, 1).astype(np.float32)
        data = np.clip(target + 0.1 * rng.normal(size=target.shape), -1, 1).astype(np.float32)
        t = torch.from_numpy(rng.integers(0, T, batch))
        noise = torch.from_numpy(rng.standard_normal(target.shape).astype(np.float32))
        out.append((data, target, t, noise))
    return out


def _model(mode: str, blocks: int, features: int, dtype, device, generator=None) -> HicedrnDiff:
    return HicedrnDiff(self_condition=MODES[mode]["self_condition"], number_resnet=blocks,
                       features=features, dtype=dtype, device=device, generator=generator)


def _host(tensors: dict) -> dict:
    return {n: t.detach().float().cpu().clone() for n, t in tensors.items()}


def _capture_blocks(model, acts: dict, grads: dict) -> list:
    """Hooks that keep the head conv's output (the first block's input),
    each block's output and the model's, with their gradients, on the
    host, in forward order."""
    def keep(name, out):
        acts[name] = out.detach().float().cpu()
        out.register_hook(lambda g: grads.__setitem__(name, g.detach().float().cpu()))

    hooks = [model.body[0].register_forward_pre_hook(lambda m, args: keep("head", args[0]))]
    hooks += [blk.register_forward_hook(lambda m, args, out, i=i: keep(f"body.{i}", out))
              for i, blk in enumerate(model.body)]
    return hooks + [model.register_forward_hook(lambda m, args, out: keep("output", out))]


def bias_rounding(device: torch.device, init: dict, seed: int) -> dict:
    """Where a bf16 layer with a bias rounds, on `device` and on the CPU:
    the head's, the body tail's and the tail's conv, the first block's
    Dense and the sr3 variant's noise-level Dense (`noise_level_mlp.1`,
    weights drawn from `seed` at the model's width) on seeded bf16 inputs,
    through PyTorch's call with the bias (`torch`) and through the model's
    path (`port`: `conv_nhwc`, the block's `_scale_shift`, `dense`), each
    output against the layer computed in fp32 from the same bf16 values
    and rounded once (`single`), and against it without its bias rounded,
    then the bias added in bf16 (`double`, as flax's Conv and Dense add
    it): the share of elements equal to each."""
    from hicdiff_tpu_torch.models.common import conv_nhwc, dense
    from hicdiff_tpu_torch.models.hicedrn import HicedrnResBlock

    F = torch.nn.functional
    rng = np.random.default_rng(seed)
    features = init["head.weight"].shape[0]
    layers = {name: (init[f"{name}.weight"], init[f"{name}.bias"])
              for name in ("head", "body_tail", "tail", "body.0.mlp.1")}
    layers["noise_level_mlp.1"] = tuple(  # PyTorch's default init of Linear(F, 4F)
        torch.from_numpy(rng.uniform(-1, 1, shape).astype(np.float32)) / features ** 0.5
        for shape in ((4 * features, features), (4 * features,)))
    out = {}
    for name, (w, b) in layers.items():
        shape = (2, w.shape[1]) if w.dim() == 2 else (2, 64, 64, w.shape[1])
        x = torch.from_numpy(rng.normal(0, 0.5, shape).astype(np.float32)).to(torch.bfloat16)
        wb, bb = w.to(torch.bfloat16), b.to(torch.bfloat16)
        if w.dim() == 2:
            plain = F.linear(x.float(), wb.float())
            paths = {"torch": lambda xd, wd, bd: F.linear(xd, wd, bd),
                     "port": dense if name.startswith("noise_level") else (
                         lambda xd, wd, bd: torch.cat(
                             HicedrnResBlock._scale_shift(None, xd, wd, bd), -1))}
        else:
            plain = conv_nhwc(x.float(), wb.float(), None)
            paths = {"torch": lambda xd, wd, bd: F.conv2d(
                         xd.permute(0, 3, 1, 2), wd, bd, padding=1).permute(0, 2, 3, 1),
                     "port": lambda xd, wd, bd: conv_nhwc(xd, wd, bd, torch.bfloat16)}
        single = (plain + bb.float()).to(torch.bfloat16)
        double = (plain.to(torch.bfloat16).float() + bb.float()).to(torch.bfloat16)
        row = {"single_vs_double_equal": float((single == double).float().mean())}
        for where, dev in (("card", device), ("cpu", torch.device("cpu"))):
            for how, f in paths.items():
                y = f(x.to(dev), wb.to(dev), bb.to(dev)).cpu()
                row[f"{where}_{how}_equal_single"] = float((y == single).float().mean())
                row[f"{where}_{how}_equal_double"] = float((y == double).float().mean())
        out[name] = row
    return out


def run_side(mode: str, device: torch.device, bf16: bool, init: dict, batches: list, *,
             blocks: int, features: int, size: int, after_first_step=None,
             capture: bool = False, bf16_reduced_reduction: bool = True) -> dict:
    """STEPS Trainer steps from `init`: losses, the first step's gradients
    and the final params, EMA and Adam moments, all on the host. capture:
    also the head's, each block's and the model's output, with their
    gradients, in the first step.
    bf16_reduced_reduction: cuBLAS's `allow_bf16_reduced_precision_reduction`
    on the card (PyTorch's default, True)."""
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = bf16
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            bf16_reduced_reduction
    model = _model(mode, blocks, features, torch.bfloat16 if bf16 else None, device)
    model.load_state_dict(init)
    acts, act_grads = {}, {}
    hooks = _capture_blocks(model, acts, act_grads) if capture else []
    engine = GaussianDiffusion.create(model, device=device, timesteps=T, image_size=size,
                                      beta_schedule=MODES[mode]["schedule"],
                                      mode=MODES[mode]["mode"])
    trainer = Trainer(engine, lr=LR, ema_decay=EMA)
    losses, step_s, grads = [], [], None
    t0 = time.time()
    for i, (data, target, t, noise) in enumerate(batches):
        ts = time.time()
        losses.append(float(trainer.train_step(data, target, t=t, noise=noise)))
        step_s.append(time.time() - ts)
        if i == 0:
            grads = _host({n: p.grad for n, p in model.named_parameters()})
            for h in hooks:
                h.remove()
            if after_first_step is not None:
                after_first_step(model)
    wall = time.time() - t0
    mu, nu, count = trainer._adam_moments()
    return dict(losses=np.array(losses), grads=grads, acts=acts, act_grads=act_grads,
                params=_host(dict(model.named_parameters())),
                ema=_host(trainer.ema), mu=_host(mu), nu=_host(nu), count=count, wall_s=wall,
                step_s_median=float(np.median(step_s)), first_step_s=step_s[0])


def l2(a: dict, b: dict) -> float:
    """The L2 distance of two trees, their leaves concatenated."""
    return float(np.sqrt(sum(float(((a[n].double() - b[n].double()) ** 2).sum()) for n in a)))


def leaf_distances(a: dict, b: dict) -> dict:
    return {n: float((a[n].double() - b[n].double()).norm()) for n in a}


def tree_gap(got: dict, want: dict, tol: float, floor_one: bool) -> dict:
    """Per leaf, |got - want| against tol x the leaf's largest magnitude
    (or x max(it, 1)): the largest gap in those units, and the weights
    beyond the bar."""
    worst, worst_leaf, outliers = 0.0, None, 0
    for n, w in want.items():
        scale = float(w.abs().max())
        scale = max(scale, 1.0) if floor_one else (scale or 1.0)
        gap = (got[n].double() - w.double()).abs() / scale
        if float(gap.max()) > worst:
            worst, worst_leaf = float(gap.max()), n
        outliers += int((gap > tol).sum())
    return dict(worst=worst, worst_leaf=worst_leaf, outliers=outliers)


def first_step_grads(sides: dict) -> dict:
    """The first step's gradients leaf by leaf, in model order: card
    against CPU in each dtype, and each bf16 side against the CPU's fp32
    (and so the captured outputs, as [card to twin, card to fp32] over the
    twin's bf16-to-fp32 distance). A tensor whose card-to-fp32 distance
    exceeds the twin's is where the card leaves the twin."""
    g = {k: v["grads"] for k, v in sides.items()}
    bf16 = leaf_distances(g["card_bf16"], g["cpu_bf16"])
    gap = leaf_distances(g["cpu_bf16"], g["cpu_fp32"])
    to_fp32 = leaf_distances(g["card_bf16"], g["cpu_fp32"])
    fp32 = {n: float((g["card_fp32"][n].double() - w.double()).abs().max()
                     / (float(w.abs().max()) or 1.0)) for n, w in g["cpu_fp32"].items()}
    ratio = {n: bf16[n] / gap[n] if gap[n] else (0.0 if bf16[n] == 0 else float("inf"))
             for n in bf16}
    beyond = [n for n in ratio if ratio[n] > 1]
    excess = {n: to_fp32[n] / gap[n] if gap[n] else 1.0 for n in gap}
    out = dict(bf16_card_vs_cpu=bf16, bf16_cpu_vs_fp32=gap, bf16_card_vs_fp32=to_fp32,
               bf16_excess_median=float(np.median(list(excess.values()))),
               bf16_excess_max=max(excess.values()), bf16_excess_worst=max(excess, key=excess.get))
    # the captured outputs (forward order) and their gradients
    for key in ("acts", "act_grads"):
        a = {k: v[key] for k, v in sides.items()}
        if a["card_bf16"]:
            d_twin, d_gap, d_fp32 = (leaf_distances(a[x], a[y]) for x, y in (
                ("card_bf16", "cpu_bf16"), ("cpu_bf16", "cpu_fp32"), ("card_bf16", "cpu_fp32")))
            out[key] = {n: [d_twin[n] / d_gap[n], d_fp32[n] / d_gap[n]] for n in d_gap}
    return out | dict(fp32_rel_of_largest=fp32,
                bf16_ratio_max=max(ratio.values()), bf16_ratio_worst=max(ratio, key=ratio.get),
                bf16_ratio_median=float(np.median(list(ratio.values()))),
                bf16_first_leaf_beyond=beyond[0] if beyond else None,
                fp32_worst=max(fp32, key=fp32.get), fp32_max=max(fp32.values()))


def judge(sides: dict, steps: int) -> tuple[dict, dict]:
    """The bars on the four sides' results: (summary, per-leaf detail)."""
    cb, cf, pb, pf = (sides[k] for k in ("card_bf16", "card_fp32", "cpu_bf16", "cpu_fp32"))
    loss_bf16 = np.abs(cb["losses"] - pb["losses"]) / np.abs(pb["losses"])
    loss_fp32 = np.abs(cf["losses"] - pf["losses"]) / np.abs(pf["losses"])
    d_bf16, d_f32, gap = l2(cb["params"], pb["params"]), l2(cb["params"], pf["params"]), \
        l2(pb["params"], pf["params"])
    n_weights = sum(p.numel() for p in pf["params"].values())
    allowed = int(n_weights * FP32_OUTLIER_SHARE * steps / 2)
    trees = {k: tree_gap(cf[k], pf[k], FP32_PARAM_TOL, True) for k in ("params", "ema")}
    trees |= {k: tree_gap(cf[k], pf[k], FP32_MOMENT_TOL, False) for k in ("mu", "nu")}
    first = first_step_grads(sides)
    finite = all(np.isfinite(s["losses"]).all() for s in sides.values())
    bars = {
        "finite": finite,
        "counts": all(s["count"] == steps for s in sides.values()),
        "bf16_loss": float(loss_bf16.mean()) <= BF16_LOSS_GAP,
        "bf16_params": min(d_bf16, d_f32) <= gap,
        "fp32_loss": float(loss_fp32.max()) <= FP32_LOSS_TOL,
        "fp32_params": trees["params"]["outliers"] <= allowed,
        "fp32_ema": trees["ema"]["outliers"] <= allowed,
        "fp32_mu": trees["mu"]["outliers"] == 0,
        "fp32_nu": trees["nu"]["outliers"] == 0,
    }
    summary = {
        "ok": all(bars.values()), "bars": bars,
        "bf16": {"params_l2_card_vs_cpu_bf16": d_bf16, "params_l2_card_vs_cpu_fp32": d_f32,
                 "params_l2_cpu_bf16_vs_cpu_fp32": gap,
                 "params_l2_card_fp32_vs_cpu_fp32": l2(cf["params"], pf["params"]),
                 "loss_gap_mean": float(loss_bf16.mean()), "loss_gap_max": float(loss_bf16.max()),
                 "loss_gap_per_step": [float(f"{x:.4g}") for x in loss_bf16]},
        "fp32": {"loss_gap_max": float(loss_fp32.max()),
                 "loss_gap_per_step": [float(f"{x:.4g}") for x in loss_fp32],
                 "outliers_allowed": allowed, "weights": n_weights, **trees},
        "first_step": {k: v for k, v in first.items() if not isinstance(v, dict)},
        "losses_final": {k: float(s["losses"][-1]) for k, s in sides.items()},
        "wall_s": {k: s["wall_s"] for k, s in sides.items()},
        "step_s_median": {k: s["step_s_median"] for k, s in sides.items()},
        "first_step_s": {k: s["first_step_s"] for k, s in sides.items()},
    }
    detail = {"first_step_grads": first,
              "params_l2_by_leaf": {
                  "card_bf16_vs_cpu_bf16": leaf_distances(cb["params"], pb["params"]),
                  "cpu_bf16_vs_cpu_fp32": leaf_distances(pb["params"], pf["params"]),
                  "card_bf16_vs_cpu_fp32": leaf_distances(cb["params"], pf["params"])},
              "losses": {k: s["losses"].tolist() for k, s in sides.items()}}
    return summary, detail


def run_mode(mode: str, *, device: torch.device, steps: int, batch: int, blocks: int,
             features: int, size: int, seed: int, after_first_step=None,
             diagnose: bool = False) -> tuple[dict, dict]:
    """The four sides of one mode and their bars. after_first_step(side,
    model) runs on every side after its first step (a test's hook).
    diagnose: keep each block's output and gradient in the first step, and
    run a fifth side, the card in bf16 with cuBLAS's reduced-precision bf16
    reductions off, held to the same two distances (not a bar)."""
    init = _model(mode, blocks, features, None, "cpu",
                  torch.Generator().manual_seed(seed)).state_dict()
    batches = make_batches(steps, batch, size, seed + 1)
    sides = {}
    for where, prec in SIDES + ((("card", "bf16_fp32_reduction"),) if diagnose else ()):
        name = f"{where}_{prec}"
        hook = after_first_step and (lambda m, name=name: after_first_step(name, m))
        sides[name] = run_side(mode, device if where == "card" else torch.device("cpu"),
                               prec.startswith("bf16"), init, batches, blocks=blocks,
                               features=features, size=size, after_first_step=hook,
                               capture=diagnose, bf16_reduced_reduction=prec == "bf16")
        print(json.dumps({"mode": mode, "side": name, "wall_s": sides[name]["wall_s"]}),
              flush=True)
    variant = sides.pop("card_bf16_fp32_reduction", None)
    summary, detail = judge(sides, steps)
    if variant is not None:
        pb, pf = sides["cpu_bf16"]["params"], sides["cpu_fp32"]["params"]
        summary["diagnose"] = {
            "bias_rounding": bias_rounding(device, init, seed + 2),
            "card_bf16_fp32_reduction": {
                "params_l2_to_cpu_bf16": l2(variant["params"], pb),
                "params_l2_to_cpu_fp32": l2(variant["params"], pf),
                "params_l2_to_card_bf16": l2(variant["params"], sides["card_bf16"]["params"]),
                "loss_gap_mean": float(np.mean(np.abs(variant["losses"] - sides["cpu_bf16"][
                    "losses"]) / np.abs(sides["cpu_bf16"]["losses"]))),
                # the first step: each leaf's gradient and each block's output
                # and gradient, its distance to the CPU's fp32 over the CPU's
                # bf16-to-fp32 distance
                **{f"first_step_{key}_excess": {n: leaf_distances(variant[key], sides[
                    "cpu_fp32"][key])[n] / d for n, d in leaf_distances(sides["cpu_bf16"][key], sides[
                        "cpu_fp32"][key]).items() if d}
                   for key in ("grads", "acts", "act_grads")}}}
    head = {"mode": mode, "steps": steps, "batch": batch, "blocks": blocks,
            "features": features, "size": size, "seed": seed, "device": str(device)}
    return head | summary, detail


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--modes", default="u0,u1", help="comma-separated: u0, u1")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--blocks", type=int, default=32)
    ap.add_argument("--features", type=int, default=256)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--threads", type=int, default=None, help="torch's CPU threads")
    ap.add_argument("--device", default="cuda", help="the card's side; cpu runs the twins")
    ap.add_argument("--out", default="chiprun_out/card_trajectory.json")
    ap.add_argument("--diagnose", action="store_true",
                    help="the first step's blocks, and a card bf16 side with cuBLAS's "
                         "reduced-precision bf16 reductions off")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        sys.exit("no CUDA device; pass --device cpu for a check on the host")
    if args.threads:
        torch.set_num_threads(args.threads)
    card = card_name_and_limit()
    records, ok = {}, True
    for mode in args.modes.split(","):
        summary, detail = run_mode(mode, device=device, steps=args.steps, batch=BATCH,
                                   blocks=args.blocks, features=args.features, size=args.size,
                                   seed=SEED, diagnose=args.diagnose)
        summary["card"] = card
        summary["torch_threads"] = torch.get_num_threads()
        records[mode] = summary | {"detail": detail}
        ok &= summary["ok"]
        print(json.dumps(summary), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(records, f)
    if not ok:
        sys.exit(1)


if __name__ == "__main__":
    main()
