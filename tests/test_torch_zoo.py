"""The port's diffusion-backbone zoo against the JAX package's, on shared weights.

Weights come from flax's init and reach the port through params_from_jax;
inputs are numpy arrays from a seed. Small sizes: the hicedrn variants at 32
features and 4 blocks (so the att variant has two attention layers), the
U-Nets as Unet(dim=16, dim_mults=(1, 2)), all at 16x16 patches.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hicdiff_tpu.models import unet as jax_unet
from hicdiff_tpu.models.common import SR3PositionalEncoding as JaxSR3PositionalEncoding
from hicdiff_tpu.models.hicedrn import HicedrnDiff as JaxHicedrnDiff
from hicdiff_tpu.models.hicedrn import HicedrnLinearAttention as JaxHicedrnLinearAttention
from hicdiff_tpu.models.hicedrn import SR3ResBlock as JaxSR3ResBlock
from hicdiff_tpu.models.zoo import DIFFUSION_BACKBONES as JAX_BACKBONES
from hicdiff_tpu_torch.convert import params_from_jax, params_to_jax
from hicdiff_tpu_torch.kernels import resblock as resblock_mod
from hicdiff_tpu_torch.models.common import SR3PositionalEncoding, dense
from hicdiff_tpu_torch.models.hicedrn import HicedrnDiff
from hicdiff_tpu_torch.models.unet import Unet, UnetResnetBlock, WSConv2d, downsample_s2d
from hicdiff_tpu_torch.models.zoo import DIFFUSION_BACKBONES

FEATURES, BLOCKS, SIZE = 32, 4, 16
NAMES = ["hicedrn_att", "hicedrn_sr3", "unet", "unet_sr3"]


def _models(name, dtype=None):
    """(flax module, port module) of `name` at the test's small size, the
    self-conditioned form; `dtype` is the compute dtype on both sides."""
    jdt = {None: None, torch.bfloat16: jnp.bfloat16}[dtype]
    if name.startswith("hicedrn"):
        variant = {"hicedrn": "base", "hicedrn_att": "att", "hicedrn_sr3": "sr3"}[name]
        kw = dict(self_condition=True, number_resnet=BLOCKS, features=FEATURES)
        return (JaxHicedrnDiff(variant=variant, dtype=jdt, **kw),
                HicedrnDiff(variant=variant, dtype=dtype, device="cpu", **kw))
    kw = dict(dim=16, dim_mults=(1, 2), self_condition=True, noise_level_emb=name == "unet_sr3")
    return jax_unet.Unet(dtype=jdt, **kw), Unet(dtype=dtype, device="cpu", **kw)


def _inputs(name, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(2, SIZE, SIZE, 1)) * 0.3).astype(np.float32)
    cond = (rng.normal(size=(2, SIZE, SIZE, 1)) * 0.3).astype(np.float32)
    # integer timesteps, or the sr3 continuous level sqrt(alpha-bar)
    time = (np.array([0.31, 0.995], np.float32) if name.endswith("sr3")
            else np.array([3, 700], np.int32))
    return x, time, cond


def _pair(name, dtype=None, seed=0):
    """(flax module, numpy params, port module loaded with them, inputs)."""
    jmodel, port = _models(name, dtype)
    inputs = _inputs(name, seed)
    params = jmodel.init(jax.random.PRNGKey(seed), *(jnp.asarray(a) for a in inputs))["params"]
    params = jax.tree.map(np.asarray, params)
    port.load_state_dict(params_from_jax(params))
    return jmodel, params, port, inputs


def _jax_forward(jmodel, params, inputs, **kw):
    return jmodel.apply({"params": params}, *(jnp.asarray(a) for a in inputs), **kw)


def _port_forward(port, inputs):
    with torch.no_grad():
        return port(*(torch.from_numpy(a) for a in inputs))


# ------------------------------------------------------------- the modules


def test_registry_names_match_jax():
    assert sorted(DIFFUSION_BACKBONES) == sorted(JAX_BACKBONES)


def test_hicedrn_linear_attention_matches_flax():
    """Pre-norm, qkv (3, 4 heads, 32), the two fp32 contractions, the
    projection, post-norm and residual, alone on the att model's weights."""
    _, params, port, _ = _pair("hicedrn_att")
    x = np.random.default_rng(3).normal(size=(2, 8, 8, FEATURES)).astype(np.float32)
    want = JaxHicedrnLinearAttention().apply(
        {"params": params["HicedrnLinearAttention_1"]}, jnp.asarray(x))
    with torch.no_grad():
        got = port.attn[1](torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-4)


def test_sr3_block_is_the_plain_twin_with_zero_scale(monkeypatch):
    """SR3ResBlock = conv -> + Dense(t_emb) -> SiLU -> conv -> x0.1 + x: on
    the CPU the fused block's plain twin with scale = 0, against flax."""
    _, params, port, _ = _pair("hicedrn_sr3")
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 8, 8, FEATURES)).astype(np.float32)
    temb = rng.normal(size=(2, 4 * FEATURES)).astype(np.float32)
    want = JaxSR3ResBlock(features=FEATURES).apply({"params": params["SR3ResBlock_2"]},
                                                   jnp.asarray(x), jnp.asarray(temb))
    scales = []
    plain = resblock_mod.fused_resblock_reference

    def spy(x, kernel, bias, scale, shift, residual=None):
        scales.append(scale)
        return plain(x, kernel, bias, scale, shift, residual)

    monkeypatch.setattr(resblock_mod, "fused_resblock_reference", spy)
    with torch.no_grad():
        got = port.body[2](torch.from_numpy(x), torch.from_numpy(temb))
    assert len(scales) == 1 and torch.equal(scales[0], torch.zeros(2, FEATURES))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-4)


def test_wsconv2d_matches_flax():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 9, 7, 6)).astype(np.float32)
    jmod = jax_unet.WSConv2d(features=10, kernel_size=3)
    params = jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"])
    want = jmod.apply({"params": params}, jnp.asarray(x))
    port = WSConv2d(6, 10, 3, padding=1)
    with torch.no_grad():
        port.weight.copy_(torch.tensor(params["kernel"].transpose(3, 2, 0, 1)))
        port.bias.copy_(torch.tensor(params["bias"]))
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-4)


def test_unet_attention_matches_flax():
    """The mid block's full softmax attention, alone on the U-Net's weights."""
    _, params, port, _ = _pair("unet")
    x = np.random.default_rng(6).normal(size=(2, 4, 4, 32)).astype(np.float32)
    want = jax_unet.UnetAttention().apply({"params": params["UnetAttention_0"]}, jnp.asarray(x))
    with torch.no_grad():
        got = port.mid_attn.fn.fn(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-4)


def test_downsample_is_channel_major():
    """New channel c * 4 + p1 * 2 + p2, as JAX's _downsample_s2d (and
    pixel_unshuffle on NCHW); not the order of a plain NHWC reshape,
    (p1 * 2 + p2) * C + c."""
    x = np.arange(2 * 4 * 6 * 3, dtype=np.float32).reshape(2, 4, 6, 3)
    want = np.asarray(jax_unet._downsample_s2d(jnp.asarray(x)))
    got = downsample_s2d(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    for c, p1, p2 in ((0, 0, 1), (1, 1, 0), (2, 1, 1)):
        assert got[1, 1, 2, c * 4 + p1 * 2 + p2] == x[1, 2 + p1, 4 + p2, c]
    unshuffled = torch.pixel_unshuffle(torch.from_numpy(x).permute(0, 3, 1, 2), 2)
    np.testing.assert_array_equal(unshuffled.permute(0, 2, 3, 1).numpy(), got)
    reshaped = x.reshape(2, 2, 2, 3, 2, 3).transpose(0, 1, 3, 2, 4, 5).reshape(2, 2, 3, 12)
    assert not np.array_equal(reshaped, got)


def test_sr3_positional_encoding_matches_flax():
    """Levels in [0, 1]: the sin/cos arguments stay below 1 in magnitude."""
    level = np.array([0.0, 0.31, 0.7, 0.995, 1.0], np.float32)
    want = np.asarray(JaxSR3PositionalEncoding(256).apply({}, jnp.asarray(level)))
    got = SR3PositionalEncoding(256)(torch.from_numpy(level)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-6)


# ------------------------------------------------------------- the backbones


@pytest.mark.parametrize("name", NAMES)
def test_backbone_matches_flax_fp32(name):
    """fp32 forward at test_torch_model.py's bar."""
    jmodel, params, port, inputs = _pair(name)
    want = np.asarray(_jax_forward(jmodel, params, inputs))
    got = _port_forward(port, inputs)
    assert got.dtype == torch.float32 and got.shape == inputs[0].shape
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-4)


def _port_stream_dtypes(port, name):
    """{flax module name: output dtype} of the port's blocks (and attention
    layers), named as flax numbers them."""
    out, hooks = {}, []

    def record(key):
        return lambda mod, args, result: out.__setitem__(key, result.dtype)

    if name.startswith("hicedrn"):
        block = "SR3ResBlock" if name.endswith("sr3") else "HicedrnResBlock"
        for i, m in enumerate(port.body):
            hooks.append(m.register_forward_hook(record(f"{block}_{i}")))
        for j, m in enumerate(getattr(port, "attn", [])):
            hooks.append(m.register_forward_hook(record(f"HicedrnLinearAttention_{j}")))
    else:
        calls = []
        for m in port.modules():
            if isinstance(m, UnetResnetBlock):
                hooks.append(m.register_forward_hook(
                    lambda mod, args, result: calls.append(result.dtype)))
        hooks.append(port.mid_attn.fn.fn.register_forward_hook(record("UnetAttention_0")))
    _port_forward(port, _inputs(name))
    for h in hooks:
        h.remove()
    if not name.startswith("hicedrn"):
        out.update({f"UnetResnetBlock_{k}": dt for k, dt in enumerate(calls)})
    return out


def _jax_stream_dtypes(jmodel, params, inputs):
    _, state = _jax_forward(jmodel, params, inputs, capture_intermediates=True,
                            mutable=["intermediates"])
    inter = state["intermediates"]
    return {k: v["__call__"][0].dtype for k, v in inter.items() if k != "__call__"}


@pytest.mark.parametrize("name", NAMES)
def test_backbone_bf16_follows_jax(name):
    """bf16 compute: every block and attention layer gives the dtype its
    flax counterpart gives (the att variant's stream is fp32 from its first
    attention on, every U-Net ResnetBlock gives fp32, the sr3 stream stays
    bf16), and the output is within twice the JAX package's own bf16-vs-fp32
    gap of JAX's bf16 output."""
    jbf, params, port, inputs = _pair(name, torch.bfloat16)
    jf32, _ = _models(name)
    want = np.asarray(_jax_forward(jbf, params, inputs))
    gap = np.abs(want - np.asarray(_jax_forward(jf32, params, inputs))).max()
    got = _port_forward(port, inputs)
    assert got.dtype == torch.float32
    assert gap > 0 and np.abs(got.numpy() - want).max() <= 2 * gap
    jax_dtypes = _jax_stream_dtypes(jbf, params, inputs)
    port_dtypes = _port_stream_dtypes(port, name)
    assert set(port_dtypes) <= set(jax_dtypes) and len(port_dtypes) >= BLOCKS
    for key, dt in port_dtypes.items():
        assert str(dt).split(".")[-1] == str(jax_dtypes[key]), key
    if name == "hicedrn_att":
        assert port_dtypes["HicedrnResBlock_1"] == torch.bfloat16
        assert port_dtypes["HicedrnResBlock_2"] == torch.float32


def test_bf16_att_blocks_carry_the_fp32_stream():
    """bf16 hicedrn_att: the blocks after an attention take the fp32 stream
    and return it fp32, as their bf16-rounded branch added to it in fp32
    (fused_resblock_reference's `residual`, the card's mode 6); the
    training path (FusedResblockFn) and the no-grad path give the same
    forward, and its backward reaches every parameter."""
    _, _, port, inputs = _pair("hicedrn_att", torch.bfloat16)
    seen = []
    for m in port.body:
        m.register_forward_hook(lambda mod, args, out: seen.append((args[0], out)))
    args = [torch.from_numpy(a) for a in inputs]
    with torch.no_grad():
        want = port(*args)
    no_grad = [(x.clone(), y.clone()) for x, y in seen]
    seen.clear()
    got = port(*args)
    assert torch.equal(got, want)
    assert [(x.dtype, y.dtype) for x, y in seen] == [(torch.bfloat16, torch.bfloat16)] * 2 + [
        (torch.float32, torch.float32)] * (BLOCKS - 2)
    for (x, y), (x0, y0) in zip(seen, no_grad):
        assert torch.equal(x.detach(), x0) and torch.equal(y.detach(), y0)
    block, (x, y) = port.body[2], seen[2]
    lin_w, lin_b, weight, bias = block._compute_weights(torch.bfloat16)
    t_in = torch.nn.functional.silu(port.time_mlp(args[1]).to(torch.bfloat16))
    scale, shift = dense(t_in, lin_w, lin_b).chunk(2, dim=-1)
    want_y = resblock_mod.fused_resblock_reference(
        x.detach().to(torch.bfloat16), block.conv["proj"].weight.detach().permute(2, 3, 1, 0).to(
            torch.bfloat16), bias, scale, shift, residual=x.detach())
    assert torch.equal(y.detach(), want_y)
    got.square().mean().backward()
    for n, p in port.named_parameters():
        assert p.grad is not None and p.grad.dtype == torch.float32, n
        assert torch.isfinite(p.grad).all() and p.grad.abs().max() > 0, n


@pytest.mark.parametrize("name", ["hicedrn"] + NAMES)
def test_params_round_trip_is_bit_exact(name):
    """flax -> port -> flax: the same tree, in flax's module order, every
    leaf bit-equal; the port's module takes exactly the converted keys."""
    _, params, port, _ = _pair(name)
    sd = params_from_jax(params)
    assert set(sd) == set(port.state_dict())
    back = params_to_jax(sd)
    want = jax.tree_util.tree_leaves_with_path(params)
    got = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b), path


def test_converters_reject_unknown_trees():
    with pytest.raises(ValueError, match="UnetResnetBlock"):
        params_from_jax({"Conv2d_0": {}})
    with pytest.raises(ValueError, match="init_conv"):
        params_to_jax({"head.weight": torch.zeros(1)})


@pytest.mark.parametrize("emb", ["learned_sinusoidal_cond", "random_fourier_features"])
def test_learned_time_embeddings_match_flax(emb):
    """The U-Net with a learned (or fixed random) Fourier time embedding:
    the forward within 1e-5 of flax's largest value, the params round trip
    bit-exact with `time_mlp.0.weights`, which takes a gradient only when
    learned."""
    kw = dict(dim=16, dim_mults=(1, 2), self_condition=True, **{emb: True})
    jmodel, port = jax_unet.Unet(**kw), Unet(device="cpu", **kw)
    inputs = _inputs("unet", 4)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(4),
                                                  *(jnp.asarray(a) for a in inputs))["params"])
    assert params["TimeMLP_0"]["LearnedSinusoidalPosEmb_0"]["weights"].shape == (8,)
    sd = params_from_jax(params)
    assert set(sd) == set(port.state_dict()) and sd["time_mlp.0.weights"].shape == (8,)
    port.load_state_dict(sd)
    want = np.asarray(_jax_forward(jmodel, params, inputs))
    got = _port_forward(port, inputs).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    back = params_to_jax(sd)
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(back),
                                 jax.tree_util.tree_leaves_with_path(params)):
        assert np.array_equal(a, b), path
    port(*(torch.from_numpy(a) for a in inputs)).square().mean().backward()
    grad = port.time_mlp[0].weights.grad
    if emb == "random_fourier_features":
        assert grad is None
    else:
        assert grad is not None and grad.abs().max() > 0


def test_registry_builds_full_width_on_the_named_device():
    """The registry's hicedrn_sr3 and unet at the JAX registry's widths,
    drawn from a generator: reproducible, on the device asked for."""
    a = DIFFUSION_BACKBONES["hicedrn_sr3"](True, None, device="cpu",
                                          generator=torch.Generator().manual_seed(0))
    b = DIFFUSION_BACKBONES["hicedrn_sr3"](True, None, device="cpu",
                                          generator=torch.Generator().manual_seed(0))
    assert len(a.body) == 32 and a.head.weight.shape == (256, 2, 3, 3)
    assert all(torch.equal(v, b.state_dict()[k]) for k, v in a.state_dict().items())
    unet = DIFFUSION_BACKBONES["unet"](False, None, device="cpu")
    assert unet.init_conv.weight.shape == (64, 1, 7, 7)
    assert unet.mid_block1.block1.proj.weight.shape == (512, 512, 3, 3)
    assert next(unet.parameters()).device.type == "cpu"
