"""The port's baseline losses against the JAX package's, on shared weights.

The perceptual network is VGGFeatures with flax's init carried to the port by
`params_from_jax(..., model="VGGFeatures")`; images are numpy arrays from a
seed, batch 3 at 32x32 (VGG19's four pools leave 2x2). Every loss within
1e-5 relative of JAX's, and the GAN generator loss's gradient with respect
to the generated images within 1e-5 of its largest value.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hicdiff_tpu.metrics import losses as jl
from hicdiff_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from hicdiff_tpu_torch.convert import params_from_jax, params_to_jax
from hicdiff_tpu_torch.metrics import losses as pl

SIZE, BATCH = 32, 3


def _images(seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.uniform(-1, 1, (BATCH, SIZE, SIZE, 1)).astype(np.float32) for _ in range(2))


@functools.lru_cache(maxsize=None)
def _vgg_pair(variant):
    """(jax apply fn, port module, flax params) on flax's init of `variant`
    (cached: the tests only read them)."""
    model = jl.VGGFeatures(variant=variant)
    params = jax.tree.map(np.asarray, jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 1)))["params"])
    port = pl.VGGFeatures(variant, device="cpu")
    port.load_state_dict(params_from_jax(params, model="VGGFeatures"))
    port.requires_grad_(False)
    apply = jax.jit(lambda x: model.apply({"params": params}, x))
    return apply, port, params


@pytest.fixture
def vgg19():
    return _vgg_pair("vgg19_35")


def _close(got, want, rel=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rel, atol=rel * np.abs(want).max())


@pytest.mark.parametrize("variant", ["vgg19_35", "vgg16_31"])
def test_vgg_features_match_jax(variant):
    """The feature stack on a single-channel batch (tiled to 3), and the
    params round trip bit-exact in flax's order."""
    apply, port, params = _vgg_pair(variant)
    x, _ = _images(0)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    want = np.asarray(apply(jnp.asarray(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    back = params_to_jax(port.state_dict(), model="VGGFeatures")
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)


def test_vgg_params_init_and_load(vgg19, tmp_path):
    """init_vgg_params: flax's LeCun truncated normal from a generator, zero
    biases; load_vgg_params: a VGGFeatures msgpack the JAX package wrote."""
    sd = pl.init_vgg_params(torch.Generator().manual_seed(0))
    w = sd["features.28.weight"]  # 512 -> 512, 3x3
    std = np.sqrt(1.0 / w[0].numel())
    assert abs(float(w.std()) / std - 1) < 0.05
    assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-7
    assert all(float(v.abs().max()) == 0 for k, v in sd.items() if k.endswith(".bias"))
    _, port, params = vgg19
    path = str(tmp_path / "vgg.msgpack")
    jax_save_checkpoint(path, params)
    loaded = pl.load_vgg_params(path)
    assert all(torch.equal(loaded[k], v) for k, v in port.state_dict().items())


def test_tv_loss_matches_jax():
    x, _ = _images(1)
    _close(pl.tv_loss(torch.from_numpy(x), 0.5).item(), jl.tv_loss(jnp.asarray(x), 0.5))


def test_hiedsr_generator_loss_matches_jax(vgg19):
    apply, port, _ = vgg19
    out, target = _images(2)
    want = jl.hiedsr_generator_loss(apply, jnp.asarray(out), jnp.asarray(target))
    with torch.no_grad():
        got = pl.hiedsr_generator_loss(port, torch.from_numpy(out), torch.from_numpy(target))
    for g, w in zip(got, want):
        _close(g.item(), w)


@pytest.mark.parametrize("masked", [False, True], ids=["reference", "pad_mask"])
def test_hiedsr_gan_generator_loss_matches_jax(vgg19, masked):
    """Both arithmetics: the reference's plain means, and the per-sample
    weighted means of a pad mask (one repeat row); the gradient of the total
    with respect to the generated images too (the target's features carry
    none)."""
    apply, port, _ = vgg19
    out, target = _images(3)
    labels = np.random.default_rng(4).uniform(0, 1, (BATCH, 2, 2, 1)).astype(np.float32)
    w = np.array([1, 1, 0], np.float32) if masked else None

    def jax_total(o):
        return jl.hiedsr_gan_generator_loss(
            apply, jnp.asarray(labels), o, jnp.asarray(target),
            weights=None if w is None else jnp.asarray(w))
    want = jax_total(jnp.asarray(out))
    want_grad = jax.grad(lambda o: jax_total(o)[3])(jnp.asarray(out))
    o = torch.from_numpy(out).requires_grad_(True)
    got = pl.hiedsr_gan_generator_loss(port, torch.from_numpy(labels), o,
                                       torch.from_numpy(target),
                                       weights=None if w is None else torch.from_numpy(w))
    for g, ww in zip(got, want):
        _close(g.item(), ww)
    got[3].backward()
    np.testing.assert_allclose(o.grad.numpy(), np.asarray(want_grad), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(want_grad)).max())


def test_deephic_generator_loss_matches_jax():
    apply, port, _ = _vgg_pair("vgg16_31")
    out, target = _images(5)
    labels = np.random.default_rng(6).uniform(0, 1, (BATCH,)).astype(np.float32)
    want = jl.deephic_generator_loss(apply, jnp.asarray(labels), jnp.asarray(out),
                                     jnp.asarray(target))
    with torch.no_grad():
        got = pl.deephic_generator_loss(port, torch.from_numpy(labels), torch.from_numpy(out),
                                        torch.from_numpy(target))
    _close(got.item(), want)


def test_feature_reconstruction_loss_matches_jax():
    out, target = _images(7)
    want = jl.feature_reconstruction_loss(lambda x: [2 * x, jnp.tanh(x) ** 2, x[:, ::2]],
                                          jnp.asarray(out), jnp.asarray(target))
    got = pl.feature_reconstruction_loss(lambda x: [2 * x, torch.tanh(x) ** 2, x[:, ::2]],
                                         torch.from_numpy(out), torch.from_numpy(target))
    _close(got.item(), want)
