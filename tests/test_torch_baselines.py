"""The port's baseline zoo against the JAX package's, on shared weights.

Weights come from flax's init (BatchNorm running statistics drawn away from
their 0 / 1 start, so eval mode reads them) and reach the port through
`params_from_jax(..., model=<class name>)`; inputs are numpy arrays from a
seed. Small sizes: batch 2, 32x32 patches (44x44 for the VALID models),
hiedsr at 2 blocks, DeepHiC and HiCSR at 2 residual blocks, HiCARN at 16
channels; the discriminators, DAE and Unet2D at their own widths.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as jnn

from hicdiff_tpu.models import baselines as jb
from hicdiff_tpu.models.hicedrn import HicedrnGenerator as JaxHicedrnGenerator
from hicdiff_tpu.models.zoo import load_baseline as jax_load_baseline
from hicdiff_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from hicdiff_tpu_torch.convert import params_from_jax, params_to_jax
from hicdiff_tpu_torch.models import baselines as pb
from hicdiff_tpu_torch.models.common import BatchNorm
from hicdiff_tpu_torch.models.hicedrn import HicedrnGenerator
from hicdiff_tpu_torch.models.zoo import BASELINES, TABLE_BASELINES, load_baseline

# name -> (flax module, port ctor, input size)
MODELS = {
    "HicPlus": (jb.HicPlus(), lambda **kw: pb.HicPlus(**kw), 44),
    "HicedrnGenerator": (JaxHicedrnGenerator(number_blocks=2),
                         lambda **kw: HicedrnGenerator(number_blocks=2, **kw), 32),
    "DeepHiC": (jb.DeepHiC(resblock_num=2), lambda **kw: pb.DeepHiC(resblock_num=2, **kw), 32),
    "DeepHiCDiscriminator": (jb.DeepHiCDiscriminator(),
                             lambda **kw: pb.DeepHiCDiscriminator(**kw), 32),
    "HiCSR": (jb.HiCSR(num_res_blocks=2), lambda **kw: pb.HiCSR(num_res_blocks=2, **kw), 44),
    "HiCSRDiscriminator": (jb.HiCSRDiscriminator(), lambda **kw: pb.HiCSRDiscriminator(**kw), 32),
    "HiedsrDiscriminator": (jb.HiedsrDiscriminator(),
                            lambda **kw: pb.HiedsrDiscriminator(**kw), 32),
    "DAE": (jb.DAE(), lambda **kw: pb.DAE(**kw), 32),
    "Unet2D": (jb.Unet2D(), lambda **kw: pb.Unet2D(**kw), 32),
    "HiCARN": (jb.HiCARN(num_channels=16), lambda **kw: pb.HiCARN(num_channels=16, **kw), 32),
}
HAS_BN = {"DeepHiC", "DeepHiCDiscriminator", "HiCSR", "HiCSRDiscriminator",
          "HiedsrDiscriminator", "Unet2D"}


def _input(size, seed=0, batch=2):
    return np.random.default_rng(seed).uniform(-1, 1, (batch, size, size, 1)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_variables(name, seed=0):
    """flax's init of `name`, numpy leaves; batch_stats drawn from a seed
    (cached: callers do not change it)."""
    jmodel, _, size = MODELS[name]
    variables = jax.tree.map(np.asarray, dict(jax.jit(jmodel.init)(
        jax.random.PRNGKey(seed), jnp.zeros((1, size, size, 1)))))
    if "batch_stats" in variables:
        rng = np.random.default_rng(seed + 1)
        variables["batch_stats"] = jax.tree.map(
            lambda a: (rng.normal(size=a.shape) * 0.3 if a.dtype == np.float32 and a.ndim == 1
                       else a).astype(np.float32), variables["batch_stats"])
        variables["batch_stats"] = jax.tree_util.tree_map_with_path(
            lambda p, a: 1.0 + np.abs(a) if p[-1].key == "var" else a, variables["batch_stats"])
    return variables


def _port(name, variables):
    port = MODELS[name][1](device="cpu")
    tree = variables if name in HAS_BN else variables["params"]
    port.load_state_dict(params_from_jax(tree, model=name))
    return port


def _port_call(port, name, x, train):
    return port(x, train=train) if name in HAS_BN else port(x)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_forward_matches_jax(name):
    """The forward in eval and in train mode within 1e-5 of the largest
    value; after the train-mode call the BatchNorm running statistics
    within 1e-6 relative of flax's updated batch_stats."""
    jmodel, _, size = MODELS[name]
    variables = _jax_variables(name)
    x = _input(size)

    def both(v, x):
        if name not in HAS_BN:
            return jmodel.apply(v, x), None
        return jmodel.apply(v, x), jmodel.apply(v, x, train=True, mutable=["batch_stats"])

    want_eval, train = jax.jit(both)(variables, jnp.asarray(x))
    port = _port(name, variables)
    for mode, want in (("eval", want_eval), ("train", None if train is None else train[0])):
        if want is None:
            continue
        with torch.no_grad():
            got = _port_call(port, name, torch.from_numpy(x), mode == "train").numpy()
        want = np.asarray(want)
        assert got.shape == want.shape, mode
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * max(np.abs(want).max(), 1e-6),
                                   err_msg=mode)
    if train is not None:
        stats = params_to_jax(port.state_dict(), model=name)["batch_stats"]
        assert (jax.tree_util.tree_structure(stats)
                == jax.tree_util.tree_structure(train[1]["batch_stats"]))
        for g, w in zip(jax.tree.leaves(stats), jax.tree.leaves(train[1]["batch_stats"])):
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_params_round_trip_is_bit_exact(name):
    """flax -> port -> flax gives the tree flax's init made, leaf for leaf,
    with batch_stats for the BatchNorm models and bare params otherwise."""
    variables = _jax_variables(name)
    port = _port(name, variables)
    back = params_to_jax(port.state_dict(), model=name)
    want = variables if name in HAS_BN else variables["params"]
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        assert a.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    # every port parameter and buffer is carried
    assert set(params_from_jax(want, model=name)) == set(port.state_dict())


def test_batch_norm_is_flax_not_torch():
    """One train-mode call: flax's momentum (0.99 on the old value) and
    biased variance, where torch.nn.BatchNorm2d keeps 0.9 and the unbiased one;
    inside frozen_batch_stats the statistics stay."""
    from hicdiff_tpu_torch.models.common import frozen_batch_stats

    x = np.random.default_rng(0).normal(2.0, 3.0, (4, 5, 6, 3)).astype(np.float32)
    variables = jnn.BatchNorm(use_running_average=False).init(jax.random.PRNGKey(0), x)
    y, upd = jnn.BatchNorm(use_running_average=False).apply(
        variables, jnp.asarray(x), mutable=["batch_stats"])
    bn = BatchNorm(3)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = bn(xt, train=True).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(y), atol=1e-5)
    np.testing.assert_allclose(bn.running_mean, upd["batch_stats"]["mean"], rtol=1e-6)
    np.testing.assert_allclose(bn.running_var, upd["batch_stats"]["var"], rtol=1e-6)
    before = bn.running_var.clone()
    with frozen_batch_stats(bn):
        bn(xt, train=True)
    assert torch.equal(bn.running_var, before) and bn.update_stats


@pytest.mark.parametrize("k, s, padding, size", [
    (3, 1, "SAME", 5), (3, 2, (1, 2), 5), (4, 2, "SAME", 4), (4, 2, "VALID", 3), (2, 2, "SAME", 3),
], ids=["dae_same", "dae_last", "unet2d_up", "valid", "k2"])
def test_conv_transpose_grid_matches_flax(k, s, padding, size):
    """flax's ConvTranspose (its kernel unmirrored) against
    F.conv_transpose2d with `conv_transpose_padding`'s (padding,
    output_padding) and the flipped weight: the same output grid and values,
    on a non-square input."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, size, size + 2, 3)).astype(np.float32)
    flax_padding = padding if isinstance(padding, str) else (padding, padding)
    layer = jnn.ConvTranspose(4, (k, k), strides=(s, s), padding=flax_padding)
    variables = layer.init(jax.random.PRNGKey(1), x)
    want = np.asarray(layer.apply(variables, jnp.asarray(x)))
    p, op = pb.conv_transpose_padding(k, s, padding)
    kernel = np.asarray(variables["params"]["kernel"])
    w = torch.from_numpy(kernel[::-1, ::-1].transpose(2, 3, 0, 1).copy())
    got = F.conv_transpose2d(torch.from_numpy(x).permute(0, 3, 1, 2), w,
                             torch.from_numpy(np.array(variables["params"]["bias"])),
                             stride=s, padding=p, output_padding=op).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_conv_transpose_padding_refuses_what_torch_cannot_pad():
    """flax 'SAME' at k=3, s=2 pads the dilated input (2, 1): no
    (padding, output_padding) of PyTorch gives that, hence DAE's explicit
    (1, 2)."""
    with pytest.raises(ValueError):
        pb.conv_transpose_padding(3, 2, "SAME")


def test_registry_matches_jax():
    from hicdiff_tpu.models.zoo import BASELINES as JAX_BASELINES
    from hicdiff_tpu.models.zoo import TABLE_BASELINES as JAX_TABLE

    assert TABLE_BASELINES == JAX_TABLE
    assert set(BASELINES) == set(JAX_BASELINES)
    for name, (ctor, pad, out_range) in BASELINES.items():
        jctor, jpad, jrange = JAX_BASELINES[name]
        assert (pad, out_range) == (jpad, jrange), name
        assert type(jctor()).__name__ == ctor.__name__, name


@pytest.mark.parametrize("name", ["deephic", "hicplus"])
def test_load_baseline_matches_jax_on_its_checkpoint(name, tmp_path):
    """A checkpoint the JAX package writes (its variables, bare params for
    the non-BatchNorm hicplus) loads in the port's load_baseline to the JAX
    loader's forward, '01' range and 6-pixel pad included; had_checkpoint
    is True, and False in an empty directory."""
    jctor = {"deephic": jb.DeepHiC, "hicplus": jb.HicPlus, "hicsr": jb.HiCSR,
             "unet": jb.Unet2D}[name]
    size = 76 if name in ("hicplus", "hicsr") else 64
    variables = jax.tree.map(np.asarray, dict(jctor().init(jax.random.PRNGKey(3),
                                                           jnp.zeros((1, size, size, 1)))))
    payload = variables if "batch_stats" in variables else variables["params"]
    wdir = str(tmp_path)
    path = os.path.join(wdir, f"finalg_40000_c64_s64_Human1_deno_0.1_{name}.msgpack")
    jax_save_checkpoint(path, payload)
    x = _input(64, seed=5)
    jfn, jhad = jax_load_baseline(name, wdir=wdir)
    fn, had = load_baseline(name, wdir=wdir, device="cpu")
    assert had and jhad
    got, want = fn(x).numpy(), np.asarray(jfn(x))
    assert got.shape == (2, 64, 64, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    _, had_none = load_baseline(name, wdir=str(tmp_path / "none"), device="cpu")
    assert not had_none


def test_load_baseline_range_and_pad_maps(tmp_path):
    """model_fn = 2 * model(pad((x + 1) / 2)) - 1 for the '01' models
    (hicplus with its 6-pixel pad), model(pad(x)) for 'pm1' hicsr."""
    x = _input(64, seed=2)
    for name in ("hicplus", "deephic", "hicsr"):
        ctor, needs_pad, out_range = BASELINES[name]
        fn, had = load_baseline(name, wdir=str(tmp_path), device="cpu",
                                generator=torch.Generator().manual_seed(4))
        model = ctor(device="cpu", generator=torch.Generator().manual_seed(4))
        xt = torch.from_numpy(x)
        if out_range == "01":
            xt = (xt + 1) / 2
        if needs_pad:
            xt = F.pad(xt, (0, 0, 6, 6, 6, 6))
        with torch.no_grad():
            want = model(xt)
        if out_range == "01":
            want = want * 2 - 1
        assert not had
        torch.testing.assert_close(fn(x), want, rtol=0, atol=1e-6)


@torch.no_grad()
def test_init_distributions():
    """Each layer kind as the JAX package draws it: Unet2D's kaiming convs
    (std sqrt(2 / fan_in)) and N(1, 0.02) BatchNorm scales, as
    tests/test_baselines.py checks flax's; LeCun's truncated normal on the
    discriminators' bare convs (std sqrt(1 / fan_in), nothing past 2 of the
    untruncated std); PyTorch's uniform on the Conv2d-wrapper convs; zero
    biases and the BatchNorm start."""
    g = torch.Generator().manual_seed(0)
    unet = pb.Unet2D(device="cpu", generator=g)
    checked = 0
    for name, w in unet.state_dict().items():
        if w.ndim == 4 and w.numel() >= 4096:
            fan_in = w[0].numel() if "up.weight" not in name else w.shape[0] * w[0, 0].numel()
            expect = np.sqrt(2.0 / fan_in)
            assert 0.8 * expect < float(w.std()) < 1.2 * expect, name
            checked += 1
        if name.endswith(".1.weight") or name.endswith(".4.weight"):
            if w.numel() >= 64:
                assert abs(float(w.mean()) - 1.0) < 0.02 and 0.005 < float(w.std()) < 0.05, name
    assert checked >= 5

    disc = pb.HiedsrDiscriminator(device="cpu", generator=g)
    w = disc.body["8"]["0"].weight  # 512 -> 512, 3x3, bare nn.Conv
    std = np.sqrt(1.0 / w[0].numel())
    assert abs(float(w.detach().std()) / std - 1) < 0.05
    assert float(w.detach().abs().max()) <= 2 * std / 0.87962566103423978 + 1e-7
    head = disc.body["0"]  # the Conv2d wrapper: PyTorch's U(+-1/sqrt(fan_in))
    bound = 1 / np.sqrt(head.weight[0].numel())
    assert float(head.weight.abs().max()) <= bound and float(head.bias.abs().max()) <= bound
    assert all(float(m.running_var.min()) == 1.0 and float(m.running_mean.abs().max()) == 0.0
               and float(m.weight.min()) == 1.0 for m in disc.modules() if isinstance(m, BatchNorm))
    assert float(disc.body["2"]["1"].bias.abs().max()) == 0.0
