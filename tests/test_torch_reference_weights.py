"""Weights in the reference's `.pytorch` format, both ways, on the CPU.

A small base HicedrnDiff (2 blocks, 16 features) initialised by flax is
saved as msgpack by the JAX package. Its `.pytorch` exports, by the JAX tool
(tools/export_torch_checkpoint.py) and by the port's
(tools/torch_export_checkpoint.py), bare and `model.`-prefixed, must carry
the same weights: through `convert.state_dict_from_reference` into the
port's model, through the JAX tool tools/convert_torch_checkpoint.py and
the port's tools/torch_convert_checkpoint.py back into msgpack files that
both packages read to the source tree, bit for bit.
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hicdiff_tpu.models.hicedrn import HicedrnDiff as JaxHicedrnDiff
from hicdiff_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from hicdiff_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from hicdiff_tpu_torch.convert import (
    params_from_jax,
    state_dict_from_reference,
    state_dict_to_reference,
)
from hicdiff_tpu_torch.models.hicedrn import HicedrnDiff
from hicdiff_tpu_torch.train.checkpoint import load_checkpoint
from tools import convert_torch_checkpoint as jax_convert_tool
from tools import export_torch_checkpoint as jax_export_tool
from tools import torch_convert_checkpoint, torch_export_checkpoint

KW = dict(self_condition=True, number_resnet=2, features=16)


def _params(seed):
    x = jnp.zeros((1, 16, 16, 1))
    params = JaxHicedrnDiff(**KW).init(jax.random.PRNGKey(seed), x, jnp.array([3]), x)["params"]
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def source(tmp_path_factory):
    """(msgpack path, its params, its ema params), written by the JAX package."""
    params, ema = _params(0), _params(1)
    path = str(tmp_path_factory.mktemp("refw") / "bestg.msgpack")
    jax_save_checkpoint(path, params, ema_params=ema)
    return path, params, ema


def _run_jax_tool(monkeypatch, tool, *args):
    monkeypatch.setattr(sys, "argv", [tool.__file__, *args])
    tool.main()


def _assert_tree_equal(got, want):
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _forward(sd):
    model = HicedrnDiff(device="cpu", **KW)
    model.load_state_dict(sd)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(2, 16, 16, 1)).astype(np.float32))
    with torch.no_grad():
        return model(x, torch.tensor([1, 700]), x * 0.5)


@pytest.mark.parametrize("prefix", [False, True], ids=["bare", "diffusion_prefix"])
def test_jax_export_loads_in_the_port(source, tmp_path, monkeypatch, prefix):
    """The JAX tool's .pytorch file -> state_dict_from_reference: the state
    dict and the forward of params_from_jax of the source msgpack, exactly;
    the reference's schedule buffers beside `model.*` keys are dropped."""
    path, params, _ = source
    out = str(tmp_path / "jax.pytorch")
    _run_jax_tool(monkeypatch, jax_export_tool, path, "--out", out,
                  *(["--diffusion-prefix"] if prefix else []))
    raw = torch.load(out, map_location="cpu", weights_only=True)
    assert all(k.startswith("model.") for k in raw) == prefix
    if prefix:  # as the reference's GaussianDiffusion.state_dict() carries them
        raw = {**raw, "betas": torch.rand(8), "alphas_cumprod": torch.rand(8)}
    sd = state_dict_from_reference(raw)
    want = params_from_jax(params)
    assert sd.keys() == want.keys()
    for k in want:
        assert torch.equal(sd[k], want[k]), k
    assert torch.equal(_forward(sd), _forward(want))


@pytest.mark.parametrize("prefix", [False, True], ids=["bare", "diffusion_prefix"])
def test_port_export_reads_back_in_the_jax_converter(source, tmp_path, monkeypatch, prefix):
    """The port's tool writes the JAX tool's keys and tensors; the JAX
    converter turns its file back into the source params tree."""
    path, params, _ = source
    ours, theirs = str(tmp_path / "port.pytorch"), str(tmp_path / "jax.pytorch")
    flag = ["--diffusion-prefix"] if prefix else []
    torch_export_checkpoint.main([path, "--out", ours, *flag])
    _run_jax_tool(monkeypatch, jax_export_tool, path, "--out", theirs, *flag)
    a = torch.load(ours, map_location="cpu", weights_only=True)
    b = torch.load(theirs, map_location="cpu", weights_only=True)
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) and a[k].dtype == torch.float32 for k in a)
    back = str(tmp_path / "back.msgpack")
    _run_jax_tool(monkeypatch, jax_convert_tool, ours, "--out", back)
    _assert_tree_equal(jax_load_checkpoint(back)["params"], params)


def test_port_export_use_ema(source, tmp_path):
    """--use-ema exports the EMA weights, else the params."""
    path, params, ema = source
    for flag, want in (([], params), (["--use-ema"], ema)):
        out = str(tmp_path / "x.pytorch")
        torch_export_checkpoint.main([path, "--out", out, *flag])
        sd = state_dict_from_reference(torch.load(out, map_location="cpu", weights_only=True))
        got = params_from_jax(want)
        assert all(torch.equal(sd[k], got[k]) for k in got)


def test_port_converter_output_loads_in_both_packages(source, tmp_path, monkeypatch):
    """tools/torch_convert_checkpoint.py on a reference-layout file (the JAX
    exporter's, `model.`-prefixed): the JAX package's load_checkpoint and
    the port's read it to the source params tree."""
    path, params, _ = source
    pt, out = str(tmp_path / "jax.pytorch"), str(tmp_path / "conv.msgpack")
    _run_jax_tool(monkeypatch, jax_export_tool, path, "--out", pt, "--diffusion-prefix")
    torch_convert_checkpoint.main([pt, "--out", out])
    _assert_tree_equal(jax_load_checkpoint(out)["params"], params)
    _assert_tree_equal(load_checkpoint(out)["params"], params)


def test_reference_state_dict_of_no_known_backbone_raises():
    with pytest.raises(ValueError):
        state_dict_from_reference({"model.conv1.weight": torch.zeros(8, 1, 9, 9)})
    with pytest.raises(ValueError):
        state_dict_to_reference({"conv1.weight": torch.zeros(8, 1, 9, 9)})
