"""Where the port's bf16 layers with a bias round, against flax's on the CPU.

flax's `Conv` and `Dense` with `dtype=bfloat16` round the product to bf16,
then its sum with the bias (`WSConv2d` adds its bias so explicitly).
PyTorch's CPU conv and linear with a bias fold it into the fp32 sum and
round once, so the port adds each bias after the product (`conv_nhwc`,
`dense`), on every device. Each case is one site of the port whose JAX
counterpart is a flax `Conv` or `Dense` with a bias in the compute dtype:
the port's call on the weights `params_from_jax` carried across, against
the flax module applied to the same input.

Weights and inputs are numpy draws on a coarse grid (multiples of 1/64),
so every fp32 sum of products is exact whatever its order: the only
rounding left is where the bias goes in, and bf16 outputs compare bit for
bit. The biases are plain normal draws, so the two roundings differ (each
case checks that they do). `WSConv2d`'s kernel is +-c in each output
channel, so it standardizes to +-1 in bf16 on both sides.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from hicdiff_tpu.models import common as jax_common
from hicdiff_tpu.models import unet as jax_unet
from hicdiff_tpu.models.hicedrn import HicedrnDiff as JaxHicedrnDiff
from hicdiff_tpu_torch.convert import params_from_jax
from hicdiff_tpu_torch.models import common, hicedrn
from hicdiff_tpu_torch.models.common import conv_nhwc, linear
from hicdiff_tpu_torch.models.hicedrn import HicedrnDiff
from hicdiff_tpu_torch.models.unet import Unet

FEATURES, BLOCKS, SIZE = 16, 2, 8
BF16 = torch.bfloat16
FP32_TOL = dict(atol=2e-5, rtol=1e-4)  # tests/test_torch_zoo.py's fp32 bar


def _grid(rng, shape, scale):
    """Integers in [-scale, scale] over 64: exact in bf16."""
    return (rng.integers(-scale, scale + 1, shape) / 64).astype(np.float32)


def _quantized(params, seed):
    """`params`' shapes with every leaf drawn from numpy: kernels on the grid,
    biases normal, norms' scales one and shifts zero; WSConv2d's kernels
    +-1/8, half of each output channel's weights each sign."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        names = [getattr(k, "key", str(k)) for k in path]
        if names[-1] == "kernel" and any(n.startswith("WSConv2d") for n in names):
            flat = np.ones((int(np.prod(x.shape[:-1])), x.shape[-1]), np.float32) / 8
            flat[: flat.shape[0] // 2] *= -1
            return rng.permuted(flat, axis=0).reshape(x.shape)
        if names[-1] == "kernel":
            return _grid(rng, x.shape, 8)
        if names[-1] == "bias" and not any(n.startswith("GroupNorm") for n in names):
            return rng.normal(0, 0.5, x.shape).astype(np.float32)
        return (np.ones if names[-1] in ("scale", "g") else np.zeros)(x.shape, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, params)


def _inputs(name):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(2, SIZE, SIZE, 1)) * 0.3).astype(np.float32)
    time = (np.array([0.31, 0.995], np.float32) if name == "sr3"
            else np.array([3, 700], np.int32))
    return x, time, x


@pytest.fixture(scope="module")
def models():
    """name -> (quantized flax params, the port's module loaded with them)."""
    out = {}
    for name in ("base", "sr3", "att", "unet"):
        if name == "unet":
            jmodel = jax_unet.Unet(dim=FEATURES, dim_mults=(1, 2), self_condition=True)
            port = Unet(dim=FEATURES, dim_mults=(1, 2), self_condition=True, device="cpu")
        else:
            kw = dict(self_condition=True, number_resnet=BLOCKS, features=FEATURES)
            jmodel = JaxHicedrnDiff(variant=name, **kw)
            port = HicedrnDiff(variant=name, device="cpu", **kw)
        shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                                *(jnp.asarray(a) for a in _inputs(name)))["params"]
        params = _quantized(shapes, seed=len(out))
        port.load_state_dict(params_from_jax(params))
        out[name] = params, port
    return out


def _conv(path, features, k):
    return path, lambda dt: jax_common.Conv2d(features, kernel_size=k, dtype=dt)


def _dense(path, features):
    return path, lambda dt: jax_common.Dense(features, dtype=dt)


def _block_dense(block, dt, sr3=False):
    """The block's Dense as its forward computes it (the no-grad path's
    weights): (scale, shift) concatenated, or the sr3 block's shift."""
    def call(x):
        scale, shift = block._scale_shift(x, *block._compute_weights(dt)[:2])
        return shift if sr3 else torch.cat([scale, shift], -1)
    return call


# case -> (model, flax sub-tree path, flax module of a dtype, input shape,
#          the port's call of the site in a dtype on its model)
F4 = 4 * FEATURES
CASES = {
    "head": ("base", *_conv("Conv2d_0", FEATURES, 3), (2, SIZE, SIZE, 2),
             lambda m, dt: lambda x: conv_nhwc(x, m.head.weight, m.head.bias, dt)),
    "body_tail": ("base", *_conv("Conv2d_1", FEATURES, 3), (2, SIZE, SIZE, FEATURES),
                  lambda m, dt: lambda x: conv_nhwc(x, m.body_tail.weight, m.body_tail.bias,
                                                    dt)),
    "tail": ("base", *_conv("Conv2d_2", 1, 3), (2, SIZE, SIZE, FEATURES),
             lambda m, dt: lambda x: conv_nhwc(x, m.tail.weight, m.tail.bias, dt)),
    "attn_to_out": ("att", *_conv("HicedrnLinearAttention_0/Conv2d_1", FEATURES, 1),
                    (2, SIZE, SIZE, 128),
                    lambda m, dt: lambda x: conv_nhwc(x, m.attn[0].to_out[0].weight,
                                                      m.attn[0].to_out[0].bias, dt)),
    "unet_wsconv": ("unet", "UnetResnetBlock_0/UnetBlock_0/WSConv2d_0",
                    lambda dt: jax_unet.WSConv2d(FEATURES, 3, dtype=dt),
                    (2, SIZE, SIZE, FEATURES),
                    lambda m, dt: lambda x: m.downs[0][0].block1.proj(x, dt)),
    "unet_res_conv": ("unet", *_conv("UnetResnetBlock_6/Conv2d_0", 2 * FEATURES, 1),
                      (2, SIZE, SIZE, 3 * FEATURES),
                      lambda m, dt: lambda x: conv_nhwc(x, m.ups[0][0].res_conv.weight,
                                                        m.ups[0][0].res_conv.bias, dt)),
    "base_block_dense": ("base", *_dense("HicedrnResBlock_0/Dense_0", 2 * FEATURES), (2, F4),
                         lambda m, dt: _block_dense(m.body[0], dt)),
    "sr3_block_dense": ("sr3", *_dense("SR3ResBlock_0/Dense_0", FEATURES), (2, F4),
                        lambda m, dt: _block_dense(m.body[0], dt, sr3=True)),
    "sr3_noise_level_mlp_1": ("sr3", *_dense("Dense_0", F4), (2, FEATURES),
                              lambda m, dt: lambda x: linear(x, m.noise_level_mlp[1], dt)),
    "sr3_noise_level_mlp_3": ("sr3", *_dense("Dense_1", F4), (2, F4),
                              lambda m, dt: lambda x: linear(x, m.noise_level_mlp[3], dt)),
    "unet_block_mlp": ("unet", *_dense("UnetResnetBlock_0/Dense_0", 2 * FEATURES), (2, F4),
                       lambda m, dt: lambda x: linear(x, m.downs[0][0].mlp[1], dt)),
}


def _subtree(params, path):
    for key in path.split("/"):
        params = params[key]
    return params


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
@pytest.mark.parametrize("case", list(CASES))
def test_site_rounds_as_flax(models, case, dtype):
    """bf16: the port's site bit-equal to the flax module, where rounding
    once would differ; fp32: within the fp32 bar."""
    model, path, make, shape, port_site = CASES[case]
    params, port = models[model]
    jdt, tdt = (jnp.bfloat16, BF16) if dtype == "bf16" else (None, None)
    x = _grid(np.random.default_rng(1), shape, 64)
    sub = _subtree(params, path)
    want = np.asarray(make(jdt).apply({"params": sub}, jnp.asarray(x, jdt or jnp.float32))
                      .astype(jnp.float32))
    xt = torch.from_numpy(x).to(tdt or torch.float32)
    with torch.no_grad():
        got = port_site(port, tdt)(xt)
    assert got.dtype == (tdt or torch.float32)
    got = got.float().numpy()
    if dtype == "fp32":
        np.testing.assert_allclose(got, want, **FP32_TOL)
        return
    np.testing.assert_array_equal(got, want)
    # rounding once (the bias in the fp32 sum) differs from flax here
    leaves = jax.tree.leaves(sub)
    kernel, bias = (leaves[1], leaves[0]) if leaves[0].ndim == 1 else leaves
    if case == "unet_wsconv":
        kernel = np.sign(kernel)  # the standardized +-1
    xb = torch.from_numpy(x)
    bb = torch.from_numpy(np.asarray(bias)).to(BF16).float()
    if kernel.ndim == 4:
        w = torch.from_numpy(np.asarray(kernel)).permute(3, 2, 0, 1)
        exact = conv_nhwc(xb, w, None)
    else:
        exact = F.linear(xb, torch.from_numpy(np.asarray(kernel)).T)
    once = (exact + bb).to(BF16).float().numpy()
    assert (once != want).mean() > 0.05


def _single_rounding(monkeypatch):
    """Round once, as PyTorch's CPU calls with a bias do: the bias in the
    product's fp32 sum."""
    def conv(x, weight, bias, dtype=None):
        dt = dtype or x.dtype
        y = F.conv2d(x.to(dt).permute(0, 3, 1, 2), weight.to(dt),
                     None if bias is None else bias.to(dt), padding=weight.shape[-1] // 2)
        return y.permute(0, 2, 3, 1).contiguous()

    monkeypatch.setattr(hicedrn, "conv_nhwc", conv)
    monkeypatch.setattr(hicedrn, "dense", F.linear)
    monkeypatch.setattr(common, "dense", F.linear)


def test_bf16_forward_is_closer_to_flax(monkeypatch):
    """A bf16 HicedrnDiff forward, weights drawn from numpy as PyTorch's
    default init draws them: the port with its biases added as flax adds
    them lies closer (L2) to flax's bf16 forward than the port rounding
    once does. The fused block still adds its conv bias in fp32, as the
    Pallas kernel does, so they are not equal."""
    kw = dict(self_condition=True, number_resnet=BLOCKS, features=FEATURES)
    jmodel = JaxHicedrnDiff(dtype=jnp.bfloat16, **kw)
    port = HicedrnDiff(dtype=BF16, device="cpu", **kw)
    inputs = _inputs("base")
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            *(jnp.asarray(a) for a in inputs))["params"]
    rng = np.random.default_rng(2)

    def draw(path, x):  # U(+-1/sqrt(fan_in)), the fan-in of the layer's kernel
        fan_in = int(np.prod(_subtree(shapes, "/".join(
            getattr(k, "key", "") for k in path[:-1]))["kernel"].shape[:-1]))
        return rng.uniform(-1, 1, x.shape).astype(np.float32) / np.sqrt(fan_in)

    params = jax.tree_util.tree_map_with_path(draw, shapes)
    port.load_state_dict(params_from_jax(params))
    want = np.asarray(jmodel.apply({"params": params}, *(jnp.asarray(a) for a in inputs)),
                      np.float64)
    args = [torch.from_numpy(a) for a in inputs]
    with torch.no_grad():
        now = port(*args).double().numpy()
        with monkeypatch.context() as m:
            _single_rounding(m)
            before = port(*args).double().numpy()
    d_now, d_before = np.linalg.norm(now - want), np.linalg.norm(before - want)
    assert d_now < d_before, (d_now, d_before)
