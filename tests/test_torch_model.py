"""The port's HicedrnDiff against the JAX package's, on shared weights.

Weights come from flax's init and reach the port through params_from_jax;
inputs are numpy arrays from a seed. Small sizes: 3 blocks, 16x16 patches.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hicdiff_tpu.models.common import SinusoidalPosEmb as JaxSinusoidalPosEmb
from hicdiff_tpu.models.fastpath import hicedrn_fused_forward
from hicdiff_tpu.models.hicedrn import HicedrnDiff as JaxHicedrnDiff
from hicdiff_tpu_torch.convert import params_from_jax
from hicdiff_tpu_torch.models.common import SinusoidalPosEmb
from hicdiff_tpu_torch.models.hicedrn import HicedrnDiff
from tools.export_torch_checkpoint import export_hicedrn_params

BLOCKS = 3


def _pair(features, seed=0):
    """A flax HicedrnDiff's params (numpy) and seeded inputs."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(2, 16, 16, 1)) * 0.3).astype(np.float32)
    cond = (rng.normal(size=(2, 16, 16, 1)) * 0.3).astype(np.float32)
    t = np.array([3, 700])
    model = JaxHicedrnDiff(self_condition=True, number_resnet=BLOCKS, features=features)
    params = model.init(
        jax.random.PRNGKey(seed), jnp.asarray(x), jnp.asarray(t, jnp.int32), jnp.asarray(cond)
    )["params"]
    return model, jax.tree.map(np.asarray, params), x, cond, t


def _port(params, features, dtype=None):
    model = HicedrnDiff(
        self_condition=True, number_resnet=BLOCKS, features=features, dtype=dtype, device="cpu"
    )
    model.load_state_dict(params_from_jax(params))
    return model


@pytest.mark.parametrize("with_cond", [True, False], ids=["cond", "cond_none"])
def test_backbone_matches_flax_fp32(with_cond):
    """fp32 forward at the bar tests/test_torch_convert.py sets; a missing
    self-conditioning input means zeros on both sides."""
    model, params, x, cond, t = _pair(features=32)
    jcond = jnp.asarray(cond) if with_cond else None
    want = np.asarray(model.apply({"params": params}, jnp.asarray(x), jnp.asarray(t, jnp.int32),
                                  jcond))
    port = _port(params, features=32)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(t),
                   torch.from_numpy(cond) if with_cond else None)
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-4)


def test_backbone_bf16_matches_jax_fused_path():
    """The bf16 dtype policy (fp32 time MLP, bf16 convs and block Dense, fused
    blocks with fp32 accumulation, fp32 output) against the JAX package's
    fused forward in bf16: one bf16 ulp of an output below 1 in magnitude."""
    _, params, x, cond, t = _pair(features=64, seed=1)
    want = np.asarray(hicedrn_fused_forward(
        params, jnp.asarray(x), jnp.asarray(t, jnp.int32), jnp.asarray(cond),
        number_resnet=BLOCKS, self_condition=True, features=64, dtype=jnp.bfloat16,
        interpret=True,
    ))
    port = _port(params, features=64, dtype=torch.bfloat16)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(cond))
    assert got.dtype == torch.float32
    assert np.abs(want).max() < 1.0
    assert np.abs(got.numpy() - want).max() <= 2.0**-7


def test_sinusoidal_embedding_matches_flax():
    """sin/cos of fp32 arguments up to ~1000, whose ulp is 2**-14: the two
    libraries' range reductions may differ by two such ulps."""
    t = np.array([0, 1, 29, 500, 999])
    want = np.asarray(JaxSinusoidalPosEmb(256).apply({}, jnp.asarray(t, jnp.int32)))
    got = SinusoidalPosEmb(256)(torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(got, want, atol=2.0**-13)


def test_params_from_jax_matches_export_tool():
    """The port's converter is the export tool's key map and transposes."""
    _, params, *_ = _pair(features=16)
    got = params_from_jax(params)
    want = export_hicedrn_params(params)
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key].numpy(), value)
    # and the port's module takes exactly these keys
    assert set(got) == set(_port(params, features=16).state_dict())


def test_params_from_jax_rejects_non_hicedrn():
    with pytest.raises(ValueError, match="HicedrnResBlock"):
        params_from_jax({"Conv2d_0": {}})


def test_seeded_init_is_torch_default_and_reproducible():
    def build(seed):
        return HicedrnDiff(self_condition=True, number_resnet=2, features=16, device="cpu",
                           generator=torch.Generator().manual_seed(seed))

    a, b, c = build(0).state_dict(), build(0).state_dict(), build(1).state_dict()
    for key, value in a.items():
        assert torch.equal(value, b[key])
        fan_in = value.numel() // value.shape[0] if key.endswith("weight") else None
        if fan_in:
            assert value.abs().max().item() <= fan_in**-0.5
    assert any(not torch.equal(a[k], c[k]) for k in a)


def test_block_weight_cache_follows_new_weights():
    """The blocks keep their weights in the kernel's layout; loading new
    weights must not leave a forward on the old ones."""
    _, params, x, cond, t = _pair(features=16, seed=2)
    port = HicedrnDiff(self_condition=True, number_resnet=BLOCKS, features=16, device="cpu")
    inputs = (torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(cond))
    with torch.no_grad():
        before = port(*inputs)
        port.load_state_dict(params_from_jax(params))
        after = port(*inputs)
        fresh = _port(params, features=16)(*inputs)
    assert not torch.equal(before, after)
    assert torch.equal(after, fresh)


def test_only_base_variant_is_ported():
    with pytest.raises(NotImplementedError):
        HicedrnDiff(variant="att", device="cpu")


def test_device_is_required():
    """The model is built where the caller says; it never defaults to the CPU."""
    with pytest.raises(TypeError, match="device"):
        HicedrnDiff(self_condition=True, number_resnet=1, features=8)
