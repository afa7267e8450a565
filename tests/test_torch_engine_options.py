"""The port's engine options against the JAX package's GaussianDiffusion on
shared weights: the three objectives (pred_noise, pred_x0, pred_v), the l1
loss, the p2 weighting and the schedule's keyword arguments, DDIM without
its x0 clip, and `return_all_timesteps`.

Small models (a 2-block, 16-feature hicedrn, its sr3 variant for mode sr3)
at 16x16, sigmoid schedule, T = 1000. The losses take JAX's draws of t and
noise (and sr3's level); the chains are the deterministic ones: DDIM with
eta = 0, and the ancestral chain with its noise zeroed on both sides.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hicdiff_tpu.diffusion.gaussian import GaussianDiffusion as JaxGaussianDiffusion
from hicdiff_tpu.diffusion.schedules import make_schedule as jax_make_schedule
from hicdiff_tpu.models.hicedrn import HicedrnDiff as JaxHicedrnDiff
from hicdiff_tpu_torch.convert import params_from_jax, params_to_jax
from hicdiff_tpu_torch.diffusion import gaussian as gaussian_mod
from hicdiff_tpu_torch.diffusion.gaussian import GaussianDiffusion
from hicdiff_tpu_torch.diffusion.schedules import make_schedule
from hicdiff_tpu_torch.models.hicedrn import HicedrnDiff

SIZE, FEATURES, BLOCKS, T, T_START = 16, 16, 2, 1000, 29
OBJECTIVES = ("pred_noise", "pred_x0", "pred_v")
P2 = dict(p2_loss_weight_gamma=0.5, p2_loss_weight_k=2.0)


@functools.lru_cache(maxsize=None)
def _pair(mode, objective, loss_type="l2", clip=True):
    """(JAX engine, numpy params, port engine) on shared params; mode sr3
    runs the sr3 backbone, uncond a model without self-conditioning."""
    kw = dict(self_condition=mode != "uncond", number_resnet=BLOCKS, features=FEATURES,
              variant="sr3" if mode == "sr3" else "base")
    opts = dict(objective=objective, loss_type=loss_type, beta_schedule="sigmoid", mode=mode)
    opts.update(P2 if mode != "sr3" else {})
    jeng = JaxGaussianDiffusion.create(JaxHicedrnDiff(**kw), image_size=SIZE, timesteps=T,
                                       **opts)
    jeng = dataclasses.replace(jeng, ddim_clip_x_start=clip)
    params = jax.tree.map(np.asarray, jeng.init_params(jax.random.PRNGKey(3)))
    model = HicedrnDiff(device="cpu", **kw)
    model.load_state_dict(params_from_jax(params))
    eng = GaussianDiffusion.create(model, device="cpu", timesteps=T, image_size=SIZE,
                                   ddim_clip_x_start=clip, **opts)
    return jeng, params, eng


def _img(seed, b=3):
    rng = np.random.default_rng(seed)
    return np.clip(rng.normal(0, 0.3, (b, SIZE, SIZE, 1)), -1, 1).astype(np.float32)


def _draws(jeng, key, shape):
    """(t, level, noise) as p_losses draws them from `key` (level: sr3 only)."""
    b = shape[0]
    if jeng.mode == "sr3":
        t_key, u_key, noise_key = jax.random.split(key, 3)
        t = jax.random.randint(t_key, (), 1, T + 1)
        prev = jeng.schedule.sqrt_alphas_cumprod_prev
        level = torch.tensor(np.asarray(jax.random.uniform(
            u_key, (b,), minval=jnp.take(prev, t - 1), maxval=jnp.take(prev, t))))
    else:
        t_key, noise_key, _, _ = jax.random.split(key, 4)
        t = jax.random.randint(t_key, (b,), 0, T)
        level = None
    noise = jax.random.normal(noise_key, shape, dtype=jnp.float32)
    return torch.tensor(np.asarray(t)), level, torch.tensor(np.asarray(noise))


def _zero_noise(monkeypatch):
    def zeros(*shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list, torch.Size)):
            shape = shape[0]
        return torch.zeros(shape)

    monkeypatch.setattr(torch, "randn", zeros)
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape=(), dtype=jnp.float32: jnp.zeros(shape, dtype))


@pytest.mark.parametrize("mode", ["cond", "uncond", "sr3"])
@pytest.mark.parametrize("loss_type", ["l2", "l1"])
@pytest.mark.parametrize("objective", OBJECTIVES)
def test_p_losses_match_jax(objective, loss_type, mode):
    """Per-sample and mean loss within 1e-5 relative, every gradient within
    1e-4 of its leaf's largest value (p2-weighted with gamma 0.5, k 2 where
    the mode weights)."""
    jeng, params, eng = _pair(mode, objective, loss_type)
    cond, target = _img(1), _img(2)
    key = jax.random.PRNGKey(11)
    x_in = target if mode == "uncond" else (cond, target)
    per_want = np.asarray(jeng.p_losses(params, key, x_in, reduce=False))
    grads_want = jax.grad(lambda p: jeng.p_losses(p, key, x_in))(params)
    t, level, noise = _draws(jeng, key, target.shape)
    args = (None if mode == "uncond" else torch.from_numpy(cond), torch.from_numpy(target))
    eng.model.zero_grad(set_to_none=True)
    per = eng.p_losses(*args, t=t, level=level, noise=noise, reduce=False)
    np.testing.assert_allclose(per.detach().numpy(), per_want, rtol=1e-5)
    per.mean().backward()
    grads = params_to_jax({n: p.grad for n, p in eng.model.named_parameters()})
    want = dict(jax.tree_util.tree_leaves_with_path(grads_want))
    for path, leaf in jax.tree_util.tree_leaves_with_path(grads):
        ref = np.asarray(want[path])
        assert np.abs(leaf - ref).max() <= 1e-4 * np.abs(ref).max(), jax.tree_util.keystr(path)


@pytest.mark.parametrize("clip", [False, True], ids=["raw", "clipped"])
@pytest.mark.parametrize("mode", ["cond", "sr3"])
@pytest.mark.parametrize("objective", OBJECTIVES)
def test_model_predictions_match_jax(objective, mode, clip):
    jeng, params, eng = _pair(mode, objective)
    x, cond = _img(3), _img(4)
    t = np.array([5, 400, 999], np.int32)
    want = jeng.model_predictions(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(cond),
                                  clip_x_start=clip)
    with torch.no_grad():
        got = eng.model_predictions(torch.from_numpy(x), torch.from_numpy(t).long(),
                                    torch.from_numpy(cond), clip_x_start=clip)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-5 * max(np.abs(w).max(), 1.0)


@pytest.mark.parametrize("objective", OBJECTIVES)
def test_unclipped_ddim_returns_every_state_as_jax(objective):
    """Truncated DDIM, K = 5, eta = 0, the x0 clip off: the six states
    (the start and one a step) within 1e-4 of JAX's, the last equal to the
    chain's plain result."""
    jeng, params, eng = _pair("cond", objective, clip=False)
    jeng = dataclasses.replace(jeng, t_start=T_START, sampling_timesteps=5)
    eng = dataclasses.replace(eng, t_start=T_START, sampling_timesteps=5)
    cond = _img(5, 2)
    want = np.asarray(jeng.super_resolution(params, jax.random.PRNGKey(0), jnp.asarray(cond),
                                            return_all_timesteps=True))
    got = eng.super_resolution(torch.from_numpy(cond), torch.Generator().manual_seed(0),
                               return_all_timesteps=True)
    assert got.shape == want.shape == (6, 2, SIZE, SIZE, 1)
    assert np.abs(got.numpy() - want).max() <= 1e-4
    last = eng.super_resolution(torch.from_numpy(cond), torch.Generator().manual_seed(0))
    assert torch.equal(last, got[-1])


@pytest.mark.parametrize("objective", ["pred_x0", "pred_v"])
def test_zero_noise_ancestral_chain_matches_jax(objective, monkeypatch):
    """The truncated ancestral chain (30 steps from t* = 29) with its noise
    zeroed on both sides, every state within 1e-4 of JAX's."""
    _zero_noise(monkeypatch)
    jeng, params, eng = _pair("cond", objective)
    jeng = dataclasses.replace(jeng, t_start=T_START)
    eng = dataclasses.replace(eng, t_start=T_START)
    cond = _img(6, 2)
    want = np.asarray(jeng.p_sample_loop(params, jax.random.PRNGKey(0), jnp.asarray(cond),
                                         return_all_timesteps=True))
    got = eng.p_sample_loop(torch.from_numpy(cond), torch.Generator().manual_seed(0),
                            return_all_timesteps=True)
    assert got.shape == want.shape == (T_START + 2, 2, SIZE, SIZE, 1)
    assert np.abs(got.numpy() - want).max() <= 1e-4


@pytest.mark.parametrize("objective", OBJECTIVES)
def test_only_pred_noise_takes_the_fused_posterior_step(objective, monkeypatch):
    """As in the JAX package (gaussian.py:312), the fused step serves
    pred_noise alone: one call a step, none under pred_x0 or pred_v."""
    calls = []
    fused = gaussian_mod.fused_posterior_step

    def spy(*args):
        calls.append(1)
        return fused(*args)

    monkeypatch.setattr(gaussian_mod, "fused_posterior_step", spy)
    _, _, eng = _pair("cond", objective)
    eng = dataclasses.replace(eng, t_start=4)
    out = eng.p_sample_loop(torch.from_numpy(_img(7, 2)), torch.Generator().manual_seed(1))
    assert torch.isfinite(out).all()
    assert len(calls) == (5 if objective == "pred_noise" else 0)


@pytest.mark.parametrize("name, kwargs", [
    ("cosine", dict(s=0.02)),
    ("sigmoid", dict(start=-2, end=2, tau=0.5)),
    ("linear", {}),
])
def test_schedule_kwargs_and_p2_weights_bit_equal(name, kwargs):
    want = jax_make_schedule(name, 100, p2_loss_weight_gamma=1.0, p2_loss_weight_k=0.5,
                             **kwargs)
    got = make_schedule(name, 100, device="cpu", p2_loss_weight_gamma=1.0,
                        p2_loss_weight_k=0.5, **kwargs)
    for field in ("betas", "alphas_cumprod", "posterior_log_variance_clipped",
                  "p2_loss_weight"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)))
    eng = GaussianDiffusion.create(HicedrnDiff(self_condition=True, number_resnet=1,
                                               features=8, device="cpu"),
                                   device="cpu", timesteps=100, beta_schedule=name,
                                   schedule_fn_kwargs=kwargs, p2_loss_weight_gamma=1.0,
                                   p2_loss_weight_k=0.5)
    np.testing.assert_array_equal(eng.schedule.p2_loss_weight.numpy(),
                                  np.asarray(want.p2_loss_weight))


def test_bad_objective_and_loss_type_raise():
    model = HicedrnDiff(self_condition=True, number_resnet=1, features=8, device="cpu")
    with pytest.raises(ValueError, match="objective"):
        GaussianDiffusion.create(model, device="cpu", objective="pred_eps")
    with pytest.raises(ValueError, match="loss_type"):
        GaussianDiffusion.create(model, device="cpu", loss_type="huber")
