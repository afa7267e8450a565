"""The port's conditional engine against the JAX package's GaussianDiffusion.

The deterministic configurations give exact cross-framework checks: the
truncated DDIM chain with eta=0, and the ancestral chain with its noise
zeroed on both sides (jax.random.normal and torch.randn monkeypatched, as
tests/test_reference_parity.py does). Sigmoid schedule, T=1000, sigma=0.1:
t* = 29, so the ancestral chain is 30 clipped steps.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hicdiff_tpu.diffusion.gaussian import GaussianDiffusion as JaxGaussianDiffusion
from hicdiff_tpu.models.hicedrn import HicedrnDiff as JaxHicedrnDiff
from hicdiff_tpu_torch.convert import params_from_jax
from hicdiff_tpu_torch.diffusion.gaussian import GaussianDiffusion
from hicdiff_tpu_torch.models.hicedrn import HicedrnDiff

SIGMA = 0.1


@pytest.fixture(scope="module")
def engines():
    """(jax engine, jax params, port engine) on shared weights, untruncated."""
    jmodel = JaxHicedrnDiff(self_condition=True, number_resnet=2, features=16)
    jeng = JaxGaussianDiffusion.create(
        jmodel, image_size=16, timesteps=1000, beta_schedule="sigmoid", mode="cond"
    )
    params = jax.tree.map(np.asarray, jeng.init_params(jax.random.PRNGKey(0)))
    model = HicedrnDiff(self_condition=True, number_resnet=2, features=16, device="cpu")
    model.load_state_dict(params_from_jax(params))
    eng = GaussianDiffusion.create(
        model, device="cpu", timesteps=1000, beta_schedule="sigmoid"
    )
    return jeng, params, eng


def _cond(seed=0):
    rng = np.random.default_rng(seed)
    return np.clip(rng.normal(0, 0.3, (2, 16, 16, 1)), -1, 1).astype(np.float32)


def _zero_noise(monkeypatch):
    def zeros(*shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list, torch.Size)):
            shape = shape[0]
        return torch.zeros(shape)

    monkeypatch.setattr(torch, "randn", zeros)
    monkeypatch.setattr(
        jax.random, "normal",
        lambda key, shape=(), dtype=jnp.float32: jnp.zeros(shape, dtype),
    )


def test_truncation_timestep_matches(engines):
    jeng, _, eng = engines
    for sigma, want in ((0.1, 29), (1.0, 499)):
        assert eng.truncation_timestep(sigma) == jeng.truncation_timestep(sigma) == want


def test_posterior_algebra_matches(engines):
    """model_predictions, q_posterior and p_mean_variance at three timesteps."""
    jeng, params, eng = engines
    rng = np.random.default_rng(1)
    x = rng.normal(0, 0.7, (3, 16, 16, 1)).astype(np.float32)
    cond = _cond(2)[:1].repeat(3, axis=0)
    t = np.array([0, 29, 999])
    want = jeng.p_mean_variance(params, jnp.asarray(x), jnp.asarray(t, jnp.int32),
                                jnp.asarray(cond))
    with torch.no_grad():
        got = eng.p_mean_variance(torch.from_numpy(x), torch.from_numpy(t),
                                  torch.from_numpy(cond))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.broadcast_to(np.asarray(w), g.shape),
                                   atol=1e-5, rtol=1e-5)
    want_noise, want_x0 = jeng.model_predictions(
        params, jnp.asarray(x), jnp.asarray(t, jnp.int32), jnp.asarray(cond), clip_x_start=True
    )
    with torch.no_grad():
        got_noise, got_x0 = eng.model_predictions(
            torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(cond), clip_x_start=True
        )
    np.testing.assert_allclose(got_noise.numpy(), np.asarray(want_noise), atol=1e-5)
    np.testing.assert_allclose(got_x0.numpy(), np.asarray(want_x0), atol=1e-5)


@pytest.mark.parametrize("steps", [1, 30], ids=["K1", "K_tstar_plus_1"])
def test_truncated_ddim_matches(engines, steps):
    """Truncated DDIM, eta=0: a single forward at K=1, every step at K=t*+1."""
    jeng, params, eng = engines
    t_star = eng.truncation_timestep(SIGMA)
    jeng = dataclasses.replace(jeng, t_start=t_star, sampling_timesteps=steps)
    eng = dataclasses.replace(eng, t_start=t_star, sampling_timesteps=steps)
    cond = _cond()
    want = np.asarray(jeng.super_resolution(params, jax.random.PRNGKey(0), jnp.asarray(cond)))
    got = eng.super_resolution(torch.from_numpy(cond), torch.Generator().manual_seed(0))
    assert got.shape == cond.shape
    assert np.abs(got.numpy() - want).max() <= 1e-4


def test_zero_noise_ddim_with_eta_matches(engines, monkeypatch):
    """eta > 0 changes the DDIM update's coefficients (sigma, c); with the
    noise zeroed on both sides the chains stay comparable."""
    jeng, params, eng = engines
    _zero_noise(monkeypatch)
    t_star = eng.truncation_timestep(SIGMA)
    jeng = dataclasses.replace(jeng, t_start=t_star, sampling_timesteps=5, ddim_sampling_eta=1.0)
    eng = dataclasses.replace(eng, t_start=t_star, sampling_timesteps=5, ddim_sampling_eta=1.0)
    cond = _cond(5)
    want = np.asarray(jeng.super_resolution(params, jax.random.PRNGKey(0), jnp.asarray(cond)))
    got = eng.super_resolution(torch.from_numpy(cond), torch.Generator().manual_seed(0))
    assert np.abs(got.numpy() - want).max() <= 1e-4


def test_zero_noise_ancestral_chain_matches(engines, monkeypatch):
    """The 30-step truncated ancestral chain through the posterior-step
    plain version, noise zeroed on both sides; error builds up over 30
    clipped steps, hence 1e-4."""
    jeng, params, eng = engines
    _zero_noise(monkeypatch)
    t_star = eng.truncation_timestep(SIGMA)
    jeng = dataclasses.replace(jeng, t_start=t_star)
    eng = dataclasses.replace(eng, t_start=t_star)
    assert not eng.is_ddim_sampling
    cond = _cond(3)
    want = np.asarray(jeng.super_resolution(params, jax.random.PRNGKey(0), jnp.asarray(cond)))
    got = eng.super_resolution(torch.from_numpy(cond), torch.Generator().manual_seed(0))
    assert np.abs(got.numpy() - want).max() <= 1e-4


def test_ancestral_chain_noise_follows_the_generator(engines):
    """With noise on, the chain is a function of the generator's seed."""
    _, _, eng = engines
    eng = dataclasses.replace(eng, t_start=3)
    cond = torch.from_numpy(_cond(4))

    def run(seed):
        return eng.super_resolution(cond, torch.Generator().manual_seed(seed))

    a, b, c = run(0), run(0), run(1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.isfinite(a).all() and a.abs().max().item() <= 1.0


def test_t_start_out_of_range_raises(engines):
    _, _, eng = engines
    with pytest.raises(ValueError, match="t_start"):
        dataclasses.replace(eng, t_start=1000).super_resolution(
            torch.from_numpy(_cond()), torch.Generator()
        )


def test_engine_needs_self_conditioned_model():
    with pytest.raises(NotImplementedError, match="self_condition"):
        GaussianDiffusion.create(
            HicedrnDiff(self_condition=False, number_resnet=1, features=8, device="cpu"),
            device="cpu",
        )
