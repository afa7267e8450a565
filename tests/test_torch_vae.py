"""The port's VAE and latent perceptual loss against the JAX package's, on
shared weights: VAEModel(latent_dim=16, pre_latent=32, condensed_latent=8)
over (3, 64, 64, 1) patches, the reparameterisation's eps shared."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hicdiff_tpu.metrics.losses import vae_latent_loss as jax_vae_latent_loss
from hicdiff_tpu.models.vae import VAEModel as JaxVAEModel
from hicdiff_tpu_torch.convert import params_from_jax, params_to_jax
from hicdiff_tpu_torch.metrics.losses import vae_latent_loss
from hicdiff_tpu_torch.models.vae import VAEModel

KW = dict(latent_dim=16, pre_latent=32, condensed_latent=8, gamma=2.0, kld_weight=0.01)


@pytest.fixture(scope="module")
def pair():
    jmodel = JaxVAEModel(**KW)
    x = jnp.zeros((1, 64, 64, 1))
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0), x,
                                                  jax.random.PRNGKey(1))["params"])
    port = VAEModel(device="cpu", **KW)
    port.load_state_dict(params_from_jax(params, model="VAEModel"))
    return jmodel, params, port


def _patches(seed, b=3):
    rng = np.random.default_rng(seed)
    return np.tanh(rng.normal(size=(b, 64, 64, 1))).astype(np.float32)


def _close(got, want, tol=1e-5):
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got.detach().numpy() - want).max() <= tol * max(np.abs(want).max(), 1e-12)


def test_params_round_trip_is_bit_exact(pair):
    _, params, port = pair
    sd = params_from_jax(params, model="VAEModel")
    assert set(sd) == set(port.state_dict())
    back = params_to_jax(sd, model="VAEModel")
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(back),
                                 jax.tree_util.tree_leaves_with_path(params)):
        assert np.array_equal(a, b), path


def test_encode_decode_match_flax(pair):
    jmodel, params, port = pair
    x = _patches(1)
    mu_w, logvar_w = jmodel.apply({"params": params}, jnp.asarray(x), method="encode")
    z = np.random.default_rng(2).normal(size=(3, 16)).astype(np.float32)
    rec_w = jmodel.apply({"params": params}, jnp.asarray(z), method="decode")
    with torch.no_grad():
        mu, logvar = port.encode(torch.from_numpy(x))
        rec = port.decode(torch.from_numpy(z))
    _close(mu, mu_w)
    _close(logvar, logvar_w)
    _close(rec, rec_w)
    assert rec.shape == (3, 64, 64, 1)


def test_loss_and_grads_with_shared_eps_match_flax(pair):
    """The ELBO with JAX's eps (jax.random.normal(rng, mu.shape)) passed in:
    1e-5 relative; every gradient within 1e-4 of its leaf's largest value."""
    jmodel, params, port = pair
    x, rng = _patches(3), jax.random.PRNGKey(4)
    want, grads_want = jax.value_and_grad(lambda p: jmodel.apply(
        {"params": p}, jnp.asarray(x), rng, method="loss"))(params)
    eps = torch.tensor(np.asarray(jax.random.normal(rng, (3, 16))))
    port.zero_grad(set_to_none=True)
    loss = port.loss(torch.from_numpy(x), eps=eps)
    assert abs(loss.item() - float(want)) <= 1e-5 * abs(float(want))
    loss.backward()
    grads = params_to_jax({n: p.grad for n, p in port.named_parameters()}, model="VAEModel")
    ref = dict(jax.tree_util.tree_leaves_with_path(grads_want))
    for path, leaf in jax.tree_util.tree_leaves_with_path(grads):
        r = np.asarray(ref[path])
        assert np.abs(leaf - r).max() <= 1e-4 * np.abs(r).max(), path
    # the draw comes from the generator when no eps is given
    a = port.get_z(torch.from_numpy(x), torch.Generator().manual_seed(5))[0]
    b = port.get_z(torch.from_numpy(x), torch.Generator().manual_seed(5))[0]
    assert torch.equal(a, b)


def test_vae_latent_loss_value_and_grad_match_jax(pair):
    """The latent MSE of the encoder means, gradient through the output
    only: value 1e-5 relative, d loss / d output within 1e-4 of its largest."""
    jmodel, params, port = pair
    out, target = _patches(6), _patches(7)

    def encode(a):
        return jmodel.apply({"params": params}, a, method="encode")

    want, gwant = jax.value_and_grad(
        lambda o: jax_vae_latent_loss(encode, o, jnp.asarray(target)))(jnp.asarray(out))
    o = torch.from_numpy(out).requires_grad_(True)
    t = torch.from_numpy(target).requires_grad_(True)
    loss = vae_latent_loss(port.encode, o, t)
    assert abs(loss.item() - float(want)) <= 1e-5 * abs(float(want))
    loss.backward()
    _close(o.grad, gwant, 1e-4)
    assert t.grad is None  # the target branch is detached
