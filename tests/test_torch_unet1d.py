"""The port's 1-D U-Net and 1-D engine against the JAX package's, on shared
weights: Unet1D(dim=16, dim_mults=(1, 2)) over (B, 32, 1) sequences; the
engine in mode uncond with `seq_length=32` and the cosine schedule."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hicdiff_tpu.diffusion.gaussian import GaussianDiffusion as JaxGaussianDiffusion
from hicdiff_tpu.models.unet1d import Unet1D as JaxUnet1D
from hicdiff_tpu_torch.convert import params_from_jax, params_to_jax
from hicdiff_tpu_torch.diffusion.gaussian import GaussianDiffusion
from hicdiff_tpu_torch.models.unet1d import Unet1D

L, T = 32, 5


def _pair(self_condition=False, dim_mults=(1, 2)):
    """(flax module, params, port module): the port's seeded init carried to
    flax (flax's own init runs for tens of seconds eagerly on the CPU), its
    tree checked against the shapes flax's init gives."""
    kw = dict(dim=16, dim_mults=dim_mults, channels=1, self_condition=self_condition)
    jmodel = JaxUnet1D(**kw)
    x, t = jnp.zeros((2, L, 1)), jnp.zeros((2,), jnp.int32)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(1), x, t, None))["params"]
    port = Unet1D(device="cpu", generator=torch.Generator().manual_seed(1), **kw)
    params = params_to_jax(port.state_dict())
    assert jax.tree.structure(params) == jax.tree.structure(shapes)
    assert jax.tree.map(np.shape, params) == jax.tree.map(lambda a: a.shape, shapes)
    return jmodel, params, port


def _seq(seed, b=2):
    return (np.random.default_rng(seed).normal(size=(b, L, 1)) * 0.5).astype(np.float32)


@pytest.mark.parametrize("self_condition, dim_mults", [(False, (1, 2)), (True, (1, 2, 4))],
                         ids=["plain", "self_cond_3_levels"])
def test_unet1d_forward_and_round_trip_match_flax(self_condition, dim_mults):
    jmodel, params, port = _pair(self_condition, dim_mults)
    x, sc = _seq(0), _seq(1)
    t = np.array([0, 3], np.int64)
    cond = sc if self_condition else None
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x), jnp.asarray(t),
                                   None if cond is None else jnp.asarray(cond)))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(t),
                   None if cond is None else torch.from_numpy(cond)).numpy()
    assert got.shape == want.shape == (2, L, 1)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    sd = params_from_jax(params)
    assert set(sd) == set(port.state_dict())
    for name, w in port.state_dict().items():
        assert torch.equal(sd[name], w), name


def _engines():
    jmodel, params, port = _pair()
    jeng = JaxGaussianDiffusion.create(jmodel, image_size=L, timesteps=T, beta_schedule="cosine",
                                       mode="uncond", seq_length=L)
    eng = GaussianDiffusion.create(port, device="cpu", timesteps=T, beta_schedule="cosine",
                                   mode="uncond", seq_length=L)
    return jeng, params, eng


def test_1d_engine_loss_and_grads_match_jax():
    """p_losses with JAX's t and noise: 1e-5 relative; every gradient within
    1e-4 of its leaf's largest value."""
    jeng, params, eng = _engines()
    x = _seq(2, 4)
    key = jax.random.PRNGKey(3)
    want, grads_want = jax.jit(jax.value_and_grad(
        lambda p: jeng.p_losses(p, key, jnp.asarray(x))))(params)
    want = float(want)
    t_key, noise_key, _, _ = jax.random.split(key, 4)
    t = torch.tensor(np.asarray(jax.random.randint(t_key, (4,), 0, T)))
    noise = torch.tensor(np.asarray(jax.random.normal(noise_key, x.shape, jnp.float32)))
    loss = eng.p_losses(None, torch.from_numpy(x), t=t, noise=noise)
    assert abs(loss.item() - want) <= 1e-5 * abs(want)
    loss.backward()
    grads = params_to_jax({n: p.grad for n, p in eng.model.named_parameters()})
    ref = dict(jax.tree_util.tree_leaves_with_path(grads_want))
    for path, leaf in jax.tree_util.tree_leaves_with_path(grads):
        r = np.asarray(ref[path])
        assert np.abs(leaf - r).max() <= 1e-4 * max(np.abs(r).max(), 1e-12), path


def test_1d_engine_zero_noise_sample_matches_jax(monkeypatch):
    """`sample` from zero noise through T ancestral steps, every state
    within 1e-4 of JAX's: shape (T + 1, 2, L, 1)."""
    def zeros(*shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list, torch.Size)):
            shape = shape[0]
        return torch.zeros(shape)

    monkeypatch.setattr(torch, "randn", zeros)
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape=(), dtype=jnp.float32: jnp.zeros(shape, dtype))
    jeng, params, eng = _engines()
    want = np.asarray(jeng.sample(params, jax.random.PRNGKey(0), 2, return_all_timesteps=True))
    got = eng.sample(2, torch.Generator().manual_seed(0), return_all_timesteps=True)
    assert eng.sample_data_shape == (L, 1)
    assert got.shape == want.shape == (T + 1, 2, L, 1)
    assert np.abs(got.numpy() - want).max() <= 1e-4
