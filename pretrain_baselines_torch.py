#!/usr/bin/env python
"""Supervised (L2) training of the six baseline generators, and the
adversarial hiedsr, on PyTorch/CUDA: the port of pretrain_baselines.py, with
its flags and defaults plus --device (default cuda; there is no fallback to
the CPU when the device is absent):

    python pretrain_baselines_torch.py [--models hiedsr hicarn deephic hicsr unet hicplus]
        [-e 100] [-b 16] [-l Human] [-n 1] [-s 0.1] [--lr 1e-4] [--root DIR] [--seed 0]
        [--models hiedsrgan [--gen-blocks 32] [--vgg-weights VGG.msgpack]
         [--disc-loss srgan|bce]] [--device cpu]

Each baseline fits the (noisy -> clean) patch pairs of the cell's data
module with a per-sample masked L2 and Adam (optax's defaults); the '01'
models (deephic, unet, hicplus) train in their native [0, 1] range; the
best-validation snapshot is kept, and a BatchNorm model's running
statistics are recalibrated around it (600 train-mode updates), kept only
when they score better. Ragged batches are wrap-padded to the batch size
(`wrap_pad`): the repeats feed BatchNorm's statistics, the mask keeps them
out of every loss. `--models hiedsrgan` trains the hiedsr generator against
HiedsrDiscriminator with Hiedsrgan_loss's composite objective (mse + 0.001
perception + 2e-8 tv + 2e-3 (1 - D(out)), the perceptual network the random
VGG19 stand-in unless --vgg-weights) and the critic objective of
`--disc-loss`: 'srgan', 1 - D(real) + D(fake), or 'bce', the sigmoid
cross-entropy (checkpoint suffix _bce). The critic's BatchNorm statistics
move on its real and its fake batch; its call on the generator's output,
after its update, leaves them, as the JAX step discards that update.

fp32 with TF32 off. Checkpoints are Model_Weights/finalg_40000_c64_s64_
{cell}{n}_deno_{sigma}_{model}.msgpack in the JAX package's layout
(`models/zoo.py` baseline_checkpoint_path: bare params, or {"params",
"batch_stats"} for a BatchNorm model), which either package's
load_baseline reads; the JSONL log is logs/pretrain_baselines_cell{n}.jsonl.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from hicdiff_tpu_torch.convert import params_to_jax  # noqa: E402
from hicdiff_tpu_torch.metrics.harness import build_test_module  # noqa: E402
from hicdiff_tpu_torch.metrics.losses import (  # noqa: E402
    VGGFeatures,
    hiedsr_gan_generator_loss,
    load_vgg_params,
)
from hicdiff_tpu_torch.models.baselines import HiedsrDiscriminator  # noqa: E402
from hicdiff_tpu_torch.models.common import frozen_batch_stats  # noqa: E402
from hicdiff_tpu_torch.models.hicedrn import HicedrnGenerator  # noqa: E402
from hicdiff_tpu_torch.models.zoo import BASELINES, baseline_checkpoint_path  # noqa: E402
from hicdiff_tpu_torch.train.checkpoint import save_checkpoint  # noqa: E402
from hicdiff_tpu_torch.train.logging import MetricLogger  # noqa: E402

# train-mode batches that recalibrate a BatchNorm model's running statistics
# after training (pretrain_baselines.py's target_updates)
RECAL_UPDATES = 600

# name -> has BatchNorm (trains with train=True, its running stats move)
HAS_BN = {"hiedsr": False, "hicarn": False, "deephic": True, "hicsr": True,
          "unet": True, "hicplus": False}


def wrap_pad(arrays, pad_to):
    """Pad the batch dim to `pad_to` by wrapping (repeating) real samples;
    returns the padded arrays and a (pad_to,) loss mask (1 real / 0 repeat).
    Repeats keep BatchNorm's batch statistics on real data, where zero rows
    would shift them; the mask keeps them out of losses, gradients and the
    best-checkpoint choice."""
    b = arrays[0].shape[0]
    if b == pad_to:
        return tuple(arrays), np.ones(b, np.float32)
    idx = np.arange(pad_to) % b
    mask = np.concatenate([np.ones(b, np.float32), np.zeros(pad_to - b, np.float32)])
    return tuple(np.asarray(a)[idx] for a in arrays), mask


def masked_l2(out, y, w):
    """Per-sample-masked mean squared error over a (b, h, w, c) batch."""
    per = (out - y).square().mean(dim=(1, 2, 3))
    return (per * w).sum() / w.sum()


def adam(params, lr):
    """optax.adam(lr)'s defaults."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def prep_fns(name):
    """(prep(x), prep_target(y)) of a baseline: '01' models train in their
    native range, hicplus and hicsr see their input padded by 6 pixels."""
    _, needs_pad, out_range = BASELINES[name]

    def prep(x):
        if out_range == "01":
            x = (x + 1.0) / 2.0
        if needs_pad:
            x = torch.nn.functional.pad(x, (0, 0, 6, 6, 6, 6))
        return x

    def prep_target(y):
        return (y + 1.0) / 2.0 if out_range == "01" else y

    return prep, prep_target


def _batches(loader, pad_to, device):
    """(x, y, w) of each wrap-padded batch, on `device`."""
    for data, target, _, _ in loader:
        (data, target), w = wrap_pad((data, target), pad_to)
        yield (torch.from_numpy(np.ascontiguousarray(data)).to(device),
               torch.from_numpy(np.ascontiguousarray(target)).to(device),
               torch.from_numpy(w).to(device))


def l2_step(model, opt, x, y, w, has_bn):
    """One Adam step of the masked L2 on a prepared batch; BatchNorm models
    run in train mode. Returns the loss, detached, on the device."""
    opt.zero_grad(set_to_none=True)
    out = model(x, train=True) if has_bn else model(x)
    loss = masked_l2(out, y, w)
    loss.backward()
    opt.step()
    return loss.detach()


@torch.no_grad()
def _val_loss(model, dm, prep, prep_target, device):
    """The validation split's per-sample L2 mean (eval mode, masked)."""
    tot = cnt = 0.0
    for x, y, w in _batches(dm.val_dataloader(), dm.batch_size, device):
        per = (model(prep(x)) - prep_target(y)).square().mean(dim=(1, 2, 3))
        tot, cnt = tot + float((per * w).sum()), cnt + float(w.sum())
    return tot / cnt if cnt else float("nan")


def _snapshot(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def train_one(name, dm, *, epochs, lr, device, generator=None, logger=None):
    """Fit baseline `name`; returns (the model, holding the kept weights and
    statistics, and their val L2)."""
    model = BASELINES[name][0](device=device, generator=generator)
    has_bn = HAS_BN[name]
    prep, prep_target = prep_fns(name)
    opt = adam(model.parameters(), lr)
    best, best_state = float("inf"), None
    for epoch in range(1, epochs + 1):
        t0 = time.time()
        losses = [l2_step(model, opt, prep(x), prep_target(y), w, has_bn)
                  for x, y, w in _batches(dm.train_dataloader(), dm.batch_size, device)]
        vl = _val_loss(model, dm, prep, prep_target, device)
        if vl < best:
            best, best_state = vl, _snapshot(model)
        if logger:
            logger.log({"model": name, "Epoch": epoch,
                        "train/loss": float(torch.stack(losses).mean()), "valid/loss": vl,
                        "epoch_seconds": time.time() - t0})
    if best_state is None:
        best_state = _snapshot(model)
    if has_bn:
        # the 0.99-momentum running stats lag the final weights by ~500
        # updates, which a small split never reaches within training:
        # recompute them around the selected weights, keep them only when
        # they score better (the JAX package's measurements of both cases)
        model.load_state_dict(best_state)
        recalibrate_batch_stats(model, dm, prep, device=device, target_updates=RECAL_UPDATES)
        recal = _val_loss(model, dm, prep, prep_target, device)
        if not np.isfinite(recal):
            recal = best
        if logger:
            logger.log({"model": name, "Epoch": "recalibrated", "valid/loss": recal})
        if recal < best:
            best, best_state = recal, _snapshot(model)
    model.load_state_dict(best_state)
    return model, best


@torch.no_grad()
def recalibrate_batch_stats(model, dm, prep, *, device, target_updates=RECAL_UPDATES):
    """Converge `model`'s BatchNorm running statistics (momentum 0.99, a
    time constant of ~100 updates) around its weights by train-mode passes
    over the train split, at least `target_updates` batches."""
    done = 0
    while done < target_updates:
        batches = 0
        for x, _, _ in _batches(dm.train_dataloader(), dm.batch_size, device):
            model(prep(x), train=True)
            batches += 1
        if batches == 0:
            break
        done += batches


def _critic_scores(disc, x):
    """Per-sample critic scores (the patch map's mean), train mode."""
    return disc(x, train=True).reshape(x.shape[0], -1).mean(dim=-1)


def gan_step(gen, disc, vgg, opt_g, opt_d, x, y, w, disc_loss="srgan"):
    """One adversarial step on a wrap-padded batch: the critic's Adam step
    on its real and fake scores (both move its BatchNorm statistics), then
    the generator's on Hiedsrgan_loss against the updated critic, whose
    statistics that call leaves. Returns (g_loss, d_loss, (image,
    perception, tv)), detached."""
    fake = gen(x)
    wsum = torch.clamp_min(w.sum(), 1.0)

    def wmean(per):
        return (per * w).sum() / wsum

    opt_d.zero_grad(set_to_none=True)
    real_score = _critic_scores(disc, y)
    fake_score = _critic_scores(disc, fake.detach())
    if disc_loss == "bce":  # -log D(real) - log(1 - D(fake)); D emits probabilities
        eps = 1e-6
        d_loss = (wmean(-torch.log(torch.clamp(real_score, eps, 1.0)))
                  + wmean(-torch.log(torch.clamp(1.0 - fake_score, eps, 1.0))))
    else:  # 'srgan': the non-log arithmetic of the generator's 1 - D(out)
        d_loss = 1.0 - wmean(real_score) + wmean(fake_score)
    d_loss.backward()
    opt_d.step()

    # the generator's parameters did not change, so `fake` is its output
    opt_g.zero_grad(set_to_none=True)
    disc.requires_grad_(False)
    try:
        with frozen_batch_stats(disc):
            score = _critic_scores(disc, fake)
        image, percep, tv, total = hiedsr_gan_generator_loss(vgg, score, fake, y, weights=w)
        total.backward()
    finally:
        disc.requires_grad_(True)
    opt_g.step()
    return total.detach(), d_loss.detach(), (image.detach(), percep.detach(), tv.detach())


def train_hiedsrgan(dm, *, epochs, lr, device, generator=None, logger=None, gen_blocks=32,
                    vgg_weights=None, disc_loss="srgan"):
    """Adversarial hiedsr training; returns (the generator, holding its
    best-validation weights, and their val L2). The generator, critic and
    random VGG are drawn from `generator` in that order."""
    gen = HicedrnGenerator(number_blocks=gen_blocks, device=device, generator=generator)
    disc = HiedsrDiscriminator(device=device, generator=generator)
    vgg = VGGFeatures("vgg19_35", device=device, generator=generator)
    if vgg_weights:
        vgg.load_state_dict(load_vgg_params(vgg_weights))
    vgg.requires_grad_(False)
    opt_g, opt_d = adam(gen.parameters(), lr), adam(disc.parameters(), lr)

    best, best_state = float("inf"), None
    for epoch in range(1, epochs + 1):
        t0 = time.time()
        g_losses, d_losses = [], []
        for x, y, w in _batches(dm.train_dataloader(), dm.batch_size, device):
            g_loss, d_loss, _ = gan_step(gen, disc, vgg, opt_g, opt_d, x, y, w, disc_loss)
            g_losses.append(g_loss)
            d_losses.append(d_loss)
        vl = _val_loss(gen, dm, lambda x: x, lambda y: y, device)
        if vl < best:
            best, best_state = vl, _snapshot(gen)
        if logger:
            logger.log({"model": "hiedsrgan", "Epoch": epoch,
                        "train/g_loss": float(torch.stack(g_losses).mean()),
                        "train/d_loss": float(torch.stack(d_losses).mean()),
                        "valid/loss": vl, "epoch_seconds": time.time() - t0})
    if best_state is not None:
        gen.load_state_dict(best_state)
    return gen, best


def create_parser(argv=None):
    ap = argparse.ArgumentParser(description="Baseline pretraining (PyTorch/CUDA)")
    ap.add_argument("--models", nargs="*",
                    default=["hiedsr", "hicarn", "deephic", "hicsr", "unet", "hicplus"])
    ap.add_argument("-b", "--batch_size", type=int, default=16)
    ap.add_argument("-e", "--epoch", type=int, default=100)
    ap.add_argument("-l", "--celline", default="Human", choices=["Human", "Dros"])
    ap.add_argument("-n", "--celln", type=int, default=1)
    ap.add_argument("-s", "--sigma", type=float, default=0.1)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--root", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--gen-blocks", type=int, default=32,
                    help="hiedsrgan generator depth (tests use a small value)")
    ap.add_argument("--vgg-weights", default=None,
                    help="saved VGGFeatures params for the perceptual term "
                         "(default: the random-VGG stand-in)")
    ap.add_argument("--disc-loss", default="srgan", choices=["srgan", "bce"],
                    help="hiedsrgan critic objective: 'srgan' (non-log arithmetic) or 'bce' "
                         "(sigmoid cross-entropy; checkpoints get a _bce suffix)")
    ap.add_argument("--device", default="cuda", help="torch device to run on (default cuda)")
    return ap.parse_args(argv)


def main(argv=None):
    """Train each of --models; returns {name: (checkpoint path, best val L2)}."""
    args = create_parser(argv)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device(args.device)
    root = args.root or os.path.dirname(os.path.abspath(__file__))
    dm = build_test_module(args.celline, args.celln, "deno", args.sigma, root=root,
                           batch_size=args.batch_size)
    dm.prepare_data()
    dm.setup("fit")
    wdir = os.path.join(root, "Model_Weights")
    logger = MetricLogger(
        out_path=os.path.join(root, "logs", f"pretrain_baselines_cell{args.celln}.jsonl"),
        run_name=f"baselines cell_{args.celln}")
    results = {}
    for name in args.models:
        generator = torch.Generator().manual_seed(args.seed)
        t0 = time.time()
        ckpt_name = name
        if name == "hiedsrgan":
            model, best = train_hiedsrgan(
                dm, epochs=args.epoch, lr=args.lr, device=device, generator=generator,
                logger=logger, gen_blocks=args.gen_blocks, vgg_weights=args.vgg_weights,
                disc_loss=args.disc_loss)
            if args.disc_loss != "srgan":
                ckpt_name = f"{name}_{args.disc_loss}"
        else:
            model, best = train_one(name, dm, epochs=args.epoch, lr=args.lr, device=device,
                                    generator=generator, logger=logger)
        path = baseline_checkpoint_path(wdir, ckpt_name, args.celline, args.celln, "deno",
                                        args.sigma)
        save_checkpoint(path, params_to_jax(model.state_dict(), model=type(model).__name__))
        results[name] = (path, best)
        print(f"[{name}] best val L2 {best:.5f} in {time.time() - t0:.0f}s -> {path}")
    logger.close()
    print("Baseline pretraining is done !!!")
    return results


if __name__ == "__main__":
    main()
