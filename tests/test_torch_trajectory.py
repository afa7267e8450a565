"""A training trajectory of the port against the JAX package's, on the CPU.

The one-step tests (tests/test_torch_train.py, tests/test_torch_bf16.py)
hold a single Trainer step to JAX's; a drift that builds up over many steps
(Adam's moments, the EMA, bf16's roundings) would pass them. Here JAX's
jitted `Trainer._train_step` and the port's `Trainer.train_step` run STEPS
steps from the same flax init, on the same numpy batches (5 patches, ragged
against JAX's padding to the 8 devices, as the one-step test) and the same
JAX draws each step (t and noise from the step's key), with Adam and an EMA
of decay 0.9.

- `-u 0` is the conditional engine on the self-conditioned backbone at the
  sigmoid schedule, `-u 1` the unconditional engine on the plain backbone
  at the linear schedule: the full-scale protocols' engines
  (tools/torch_fullscale_quality.py).
- fp32: each step's loss within 1e-5 relative of JAX's; after the last step
  the params, EMA and Adam moments within 1e-5 of the largest magnitude of
  their leaf (or of 1).
- bf16 (the model in bf16, params, Adam, EMA and loss in fp32): the bar of
  tests/test_torch_bf16.py on the final params, held on both sides: the
  port's bf16 params lie no farther (L2) from JAX's bf16 params, and no
  farther from JAX's fp32 params, than those two lie from each other; the
  mean relative gap of the losses to JAX's bf16 losses over the run is at
  most 1e-2. JAX's bf16 run is jitted, so XLA's CPU backend keeps some
  fused elementwise chains in fp32.

Small sizes, those of tests/test_torch_train.py: 2 blocks of 16 features,
16x16 patches.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hicdiff_tpu.diffusion.gaussian import GaussianDiffusion as JaxGaussianDiffusion
from hicdiff_tpu.models.hicedrn import HicedrnDiff as JaxHicedrnDiff
from hicdiff_tpu.train.trainer import Trainer as JaxTrainer
from hicdiff_tpu_torch.convert import params_from_jax
from hicdiff_tpu_torch.diffusion.gaussian import GaussianDiffusion
from hicdiff_tpu_torch.models.hicedrn import HicedrnDiff
from hicdiff_tpu_torch.train.trainer import Trainer
from tests.test_torch_bf16 import assert_bf16_bar
from tests.test_torch_train import (
    BLOCKS,
    EMA,
    FEATURES,
    LR,
    SIZE,
    T,
    _batch,
    _jax_adam,
    _jax_draws,
    _port_trees,
    assert_trees_close,
)

STEPS, BATCH, PAD = 100, 5, 8
# the engines of train_torch.py -u 0 and -u 1 (tools/torch_fullscale_quality.py)
MODES = {"cond": dict(self_condition=True, schedule="sigmoid"),
         "uncond": dict(self_condition=False, schedule="linear")}


def _steps():
    """Each step's (key, data, target): a fresh ragged batch and key."""
    root = jax.random.PRNGKey(7)
    return [(jax.random.fold_in(root, i), *_batch(BATCH, seed=1000 + i)) for i in range(STEPS)]


@functools.lru_cache(maxsize=None)
def _init(mode):
    """The flax init of the mode's fp32 backbone, shared by every run."""
    return jax.tree.map(np.asarray, _jax_engine(mode, False).init_params(jax.random.PRNGKey(0)))


def _jax_engine(mode, bf16):
    m = MODES[mode]
    model = JaxHicedrnDiff(self_condition=m["self_condition"], number_resnet=BLOCKS,
                           features=FEATURES, dtype=jnp.bfloat16 if bf16 else None)
    return JaxGaussianDiffusion.create(model, image_size=SIZE, timesteps=T,
                                       beta_schedule=m["schedule"], mode=mode)


@functools.lru_cache(maxsize=None)
def _jax_run(mode, bf16):
    """JAX's jitted step, STEPS times: (losses, params, mu, nu, count, ema)."""
    trainer = JaxTrainer(_jax_engine(mode, bf16), lr=LR, ema_decay=EMA)
    params = jax.tree.map(jnp.array, _init(mode))
    opt_state = trainer.optimizer.init(params)
    ema = jax.tree.map(jnp.array, _init(mode))  # the step donates its inputs
    losses = []
    for key, data, target in _steps():
        batch, weights = trainer._prep_batch(data, target, pad_to=PAD)
        params, opt_state, ema, loss = trainer._train_step(params, opt_state, ema, key, batch,
                                                           weights)
        losses.append(float(loss))
    mu, nu, count = _jax_adam(opt_state)
    return (np.array(losses), *jax.tree.map(np.asarray, (params, mu, nu)), count,
            jax.tree.map(np.asarray, ema))


@functools.lru_cache(maxsize=None)
def _port_run(mode, bf16):
    """The port's Trainer.train_step, STEPS times, on JAX's draws."""
    m = MODES[mode]
    model = HicedrnDiff(self_condition=m["self_condition"], number_resnet=BLOCKS,
                        features=FEATURES, dtype=torch.bfloat16 if bf16 else None, device="cpu")
    model.load_state_dict(params_from_jax(_init(mode)))
    trainer = Trainer(GaussianDiffusion.create(model, device="cpu", timesteps=T,
                                               beta_schedule=m["schedule"], mode=mode),
                      lr=LR, ema_decay=EMA)
    losses = []
    for key, data, target in _steps():
        t, noise = _jax_draws(key, PAD, target.shape, BATCH)
        losses.append(float(trainer.train_step(data, target, t=t, noise=noise)))
    params, mu, nu, count, ema = _port_trees(trainer)
    return np.array(losses), params, mu, nu, count, ema


def _largest_gap(got, want):
    """max over leaves of |got - want| / max(|want|, 1), for the record."""
    return max(float(np.abs(np.asarray(g, np.float64) - w).max() / max(np.abs(w).max(), 1.0))
               for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)))


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("mode", ["cond", "uncond"], ids=["u0", "u1"])
def test_trajectory_matches_jax(mode, bf16):
    losses, params, mu, nu, count, ema = _port_run(mode, bf16)
    want_losses, want_params, want_mu, want_nu, want_count, want_ema = _jax_run(mode, bf16)
    assert count == want_count == STEPS
    rel = np.abs(losses - want_losses) / np.abs(want_losses)
    assert np.isfinite(losses).all() and np.isfinite(want_losses).all()
    if not bf16:
        assert rel.max() <= 1e-5, (int(rel.argmax()), float(rel.max()))
        assert_trees_close(params, want_params, 1e-5, "params")
        assert_trees_close(ema, want_ema, 1e-5, "ema")
        assert_trees_close(mu, want_mu, 1e-5, "mu")
        assert_trees_close(nu, want_nu, 1e-5, "nu")
        print(f"\n{mode} fp32 over {STEPS} steps: loss {rel.max():.3g} relative; params "
              f"{_largest_gap(params, want_params):.3g}, ema {_largest_gap(ema, want_ema):.3g}, "
              f"mu {_largest_gap(mu, want_mu):.3g}, nu {_largest_gap(nu, want_nu):.3g} "
              "of their leaf's largest magnitude")
        return
    assert rel.mean() <= 1e-2, float(rel.mean())
    f32_params = _jax_run(mode, False)[1]
    leaves = [jax.tree.leaves(p) for p in (params, want_params, f32_params)]
    d_bf16, d_f32, gap = assert_bf16_bar(*leaves, f"{mode} bf16 params after {STEPS} steps")
    assert max(d_bf16, d_f32) <= gap, (d_bf16, d_f32, gap)
    print(f"\n{mode} bf16 over {STEPS} steps: loss gap mean {rel.mean():.3g}, max "
          f"{rel.max():.3g}; params L2 to JAX bf16 {d_bf16:.3g}, to JAX fp32 {d_f32:.3g}, "
          f"JAX bf16 to fp32 {gap:.3g}")
