"""Parameters of the JAX package's diffusion backbones <-> the port's state dicts.

Every backbone of the registry (`models/zoo.py`) maps through one layout
table: each entry pairs a flax module path with a port parameter prefix and
the kind of layer, in the order flax's init creates the modules, so both
directions walk the same table and the round trip flax -> port -> flax is
bit-exact. Conv kernels go HWIO -> OIHW, Dense kernels are transposed,
channel-LayerNorm scales take the reference's (1, C, 1, 1) shape. The base
HicedrnDiff's map is that of tools/export_torch_checkpoint.py (flax
`Conv2d_0` / `TimeMLP_0` / `HicedrnResBlock_{i}` -> the reference's `head` /
`time_mlp.1` / `body.{i}.conv.proj`), carried here so the port imports
neither `tools/` nor the JAX package; the att, sr3, U-Net and 1-D U-Net
names are those of `models/hicedrn.py`, `models/unet.py` and
`models/unet1d.py` (a U-Net with a learned time embedding adds its
`time_mlp.0.weights`). Both directions pick the backbone from the tree's own
keys and raise on a tree they do not know.

The baselines (`models/baselines.py`, `HicedrnGenerator`, `VGGFeatures`,
and `models/vae.py`'s `VAEModel`)
each have a table too, chosen by `model=` (the class name; their trees
share module names, so the keys cannot tell them apart). Their flax paths
are the JAX models' (`Conv2d_i` of the `Conv2d` wrapper, `Conv_i` and
`ConvTranspose_i` of bare flax layers, `BatchNorm_i`, `_BNResBlock_i`,
`_DoubleConv_i`), their port names the reference's. A baseline with
BatchNorm goes as its flax variables {"params", "batch_stats"} (the
running mean and variance are the port's buffers), one without as bare
params: the payloads of the JAX package's `pretrain_baselines.py`
checkpoints. A flax ConvTranspose kernel (kh, kw, in, out), which
`lax.conv_transpose` does not mirror, is PyTorch's (in, out, kh, kw)
weight flipped in space, both ways.

`state_dict_from_reference` and `state_dict_to_reference` read and write
the reference's own `.pytorch` state dicts (its backbone names are the
port's, so only the `model.` prefix and the schedule buffers differ), for
`tools/torch_convert_checkpoint.py` and `tools/torch_export_checkpoint.py`.

`adam_state_to_jax` and `adam_state_from_jax` carry Adam's moments and
step count to and from the state of the JAX trainer's `optax.adam`, as its
checkpoints store it: `(ScaleByAdamState(count, mu, nu), EmptyState())`
serialised as {"0": {"count": int32, "mu": params tree, "nu": params tree},
"1": {}}. The moments take the params' key map and transposes; torch's
per-parameter `step` is optax's one `count`.
"""
from __future__ import annotations

import itertools
from typing import Optional

import numpy as np
import torch

__all__ = ["adam_state_from_jax", "adam_state_to_jax", "params_from_jax", "params_to_jax",
           "state_dict_from_reference", "state_dict_to_reference"]

# layer kinds: flax leaves under the entry's path <-> the port's parameters
#   conv  {Conv_0: {kernel HWIO, bias?}}  <-> weight OIHW, bias?
#   dense {Dense_0: {kernel (in, out), bias}} <-> weight (out, in), bias
#   linear {kernel (in, out), bias} (flax nn.Dense) <-> weight (out, in), bias
#   bare  {kernel HWIO, bias?} (WSConv2d, flax nn.Conv) <-> weight OIHW, bias?
#   convt {kernel (kh, kw, in, out), bias?} (flax nn.ConvTranspose)
#                                          <-> weight (in, out, kh, kw) flipped in space, bias?
#   bn    {scale, bias} + batch_stats {mean, var} (BatchNorm)
#                                          <-> weight, bias + running_mean, running_var
#   gn    {scale, bias} (GroupNorm)        <-> weight, bias
#   g     {g (C,)} (ChannelLayerNorm)      <-> g (1, C, 1, 1)
#   g1    {g (C,)} (the 1-D LayerNorm)     <-> g (1, C, 1)
#   weights {weights (n,)} (LearnedSinusoidalPosEmb) <-> weights (n,)
# A 1-D conv kernel (K, I, O) maps to the weight (O, I, K).


def _hicedrn_layout(blocks: int, variant: str) -> list:
    layout = [(("Conv2d_0",), "head", "conv")]
    if variant == "sr3":
        layout += [(("Dense_0",), "noise_level_mlp.1", "dense"),
                   (("Dense_1",), "noise_level_mlp.3", "dense")]
    else:
        layout += [(("TimeMLP_0", "Dense_0"), "time_mlp.1", "dense"),
                   (("TimeMLP_0", "Dense_1"), "time_mlp.3", "dense")]
    for i in range(blocks):
        if variant == "sr3":
            layout += [((f"SR3ResBlock_{i}", "Conv2d_0"), f"body.{i}.conv.proj", "conv"),
                       ((f"SR3ResBlock_{i}", "Dense_0"), f"body.{i}.noise_func.noise_func.0",
                        "dense")]
        else:
            layout += [((f"HicedrnResBlock_{i}", "Dense_0"), f"body.{i}.mlp.1", "dense"),
                       ((f"HicedrnResBlock_{i}", "Conv2d_0"), f"body.{i}.conv.proj", "conv")]
        if variant == "att" and i % 2 == 1:
            a, p = f"HicedrnLinearAttention_{i // 2}", f"attn.{i // 2}"
            layout += [((a, "ChannelLayerNorm_0"), f"{p}.norm", "g"),
                       ((a, "Conv2d_0"), f"{p}.to_qkv", "conv"),
                       ((a, "Conv2d_1"), f"{p}.to_out.0", "conv"),
                       ((a, "ChannelLayerNorm_1"), f"{p}.to_out.1", "g")]
    return layout + [(("Conv2d_1",), "body_tail", "conv"), (("Conv2d_2",), "tail", "conv")]


def _unet_layout(levels: int, sr3: bool, learned: bool = False) -> list:
    resnet_ids, conv_ids, norm_ids, attn_ids = (itertools.count(s) for s in (0, 1, 0, 0))
    layout = [(("Conv2d_0",), "init_conv", "conv")]
    if learned:
        layout.append((("TimeMLP_0", "LearnedSinusoidalPosEmb_0"), "time_mlp.0", "weights"))
    if sr3:
        layout += [(("Dense_0",), "noise_level_mlp.1", "dense"),
                   (("Dense_1",), "noise_level_mlp.3", "dense")]
    else:
        layout += [(("TimeMLP_0", "Dense_0"), "time_mlp.1", "dense"),
                   (("TimeMLP_0", "Dense_1"), "time_mlp.3", "dense")]

    def resnet(name, res_conv):
        f = f"UnetResnetBlock_{next(resnet_ids)}"
        layout.append(((f, "Dense_0"), f"{name}.mlp.1", "dense"))
        for k in (0, 1):
            layout.append(((f, f"UnetBlock_{k}", "WSConv2d_0"), f"{name}.block{k + 1}.proj", "bare"))
            layout.append(((f, f"UnetBlock_{k}", "GroupNorm_0"), f"{name}.block{k + 1}.norm", "gn"))
        if res_conv:  # the up blocks and the final block take wider inputs
            layout.append(((f, "Conv2d_0"), f"{name}.res_conv", "conv"))

    def prenorm(name):
        layout.append(((f"_PreNormResidual_{next(norm_ids)}", "ChannelLayerNorm_0"),
                       f"{name}.fn.norm", "g"))

    def linear_attention(name):
        prenorm(name)
        a = f"UnetLinearAttention_{next(attn_ids)}"
        layout.extend([((a, "Conv2d_0"), f"{name}.fn.fn.to_qkv", "conv"),
                       ((a, "Conv2d_1"), f"{name}.fn.fn.to_out.0", "conv"),
                       ((a, "ChannelLayerNorm_0"), f"{name}.fn.fn.to_out.1", "g")])

    def resample(name, last):
        layout.append(((f"Conv2d_{next(conv_ids)}",), name if last else f"{name}.1", "conv"))

    for side in ("downs", "ups"):
        for i in range(levels):
            resnet(f"{side}.{i}.0", side == "ups")
            resnet(f"{side}.{i}.1", side == "ups")
            linear_attention(f"{side}.{i}.2")
            resample(f"{side}.{i}.3", i == levels - 1)
        if side == "downs":
            resnet("mid_block1", False)
            prenorm("mid_attn")
            layout += [(("UnetAttention_0", "Conv2d_0"), "mid_attn.fn.fn.to_qkv", "conv"),
                       (("UnetAttention_0", "Conv2d_1"), "mid_attn.fn.fn.to_out", "conv")]
            resnet("mid_block2", False)
    resnet("final_res_block", True)
    resample("final_conv", True)
    return layout


def _unet1d_layout(levels: int) -> list:
    resnet_ids, conv_ids, norm_ids, attn_ids = (itertools.count(s) for s in (0, 1, 0, 0))
    layout = [(("Conv1d_0",), "init_conv", "conv"),
              (("TimeMLP_0", "Dense_0"), "time_mlp.1", "dense"),
              (("TimeMLP_0", "Dense_1"), "time_mlp.3", "dense")]

    def resnet(name, res_conv):
        f = f"_ResnetBlock1d_{next(resnet_ids)}"
        layout.append(((f, "Dense_0"), f"{name}.mlp.1", "dense"))
        for k in (0, 1):
            layout.append(((f, f"_Block1d_{k}", "WSConv1d_0"), f"{name}.block{k + 1}.proj", "bare"))
            layout.append(((f, f"_Block1d_{k}", "GroupNorm_0"), f"{name}.block{k + 1}.norm", "gn"))
        if res_conv:
            layout.append(((f, "Conv1d_0"), f"{name}.res_conv", "conv"))

    def attention(name, linear):
        layout.append(((f"_PreNormResidual1d_{next(norm_ids)}", "_LayerNorm1d_0"),
                       f"{name}.fn.norm", "g1"))
        a = f"_Attention1d_{next(attn_ids)}"
        layout.append(((a, "Conv1d_0"), f"{name}.fn.fn.to_qkv", "conv"))
        if linear:
            layout.extend([((a, "Conv1d_1"), f"{name}.fn.fn.to_out.0", "conv"),
                           ((a, "_LayerNorm1d_0"), f"{name}.fn.fn.to_out.1", "g1")])
        else:
            layout.append(((a, "Conv1d_1"), f"{name}.fn.fn.to_out", "conv"))

    def resample(name):
        layout.append(((f"Conv1d_{next(conv_ids)}",), name, "conv"))

    for i in range(levels):
        resnet(f"downs.{i}.0", False)
        resnet(f"downs.{i}.1", False)
        attention(f"downs.{i}.2", True)
        resample(f"downs.{i}.3")
    resnet("mid_block1", False)
    attention("mid_attn", False)
    resnet("mid_block2", False)
    for i in range(levels):
        resnet(f"ups.{i}.0", True)
        resnet(f"ups.{i}.1", True)
        attention(f"ups.{i}.2", True)
        resample(f"ups.{i}.3" if i == levels - 1 else f"ups.{i}.3.1")
    resnet("final_res_block", True)
    resample("final_conv")
    return layout


def _count(present) -> int:
    return next(i for i in itertools.count() if not present(i))


def _layout_of_params(params: dict) -> list:
    if "UnetResnetBlock_0" in params:
        resnets = _count(lambda i: f"UnetResnetBlock_{i}" in params)
        return _unet_layout((resnets - 3) // 4, sr3="TimeMLP_0" not in params,
                            learned="LearnedSinusoidalPosEmb_0" in params.get("TimeMLP_0", {}))
    if "_ResnetBlock1d_0" in params:
        return _unet1d_layout((_count(lambda i: f"_ResnetBlock1d_{i}" in params) - 3) // 4)
    if "SR3ResBlock_0" in params:
        return _hicedrn_layout(_count(lambda i: f"SR3ResBlock_{i}" in params), "sr3")
    if "HicedrnResBlock_0" in params:
        variant = "att" if "HicedrnLinearAttention_0" in params else "base"
        return _hicedrn_layout(_count(lambda i: f"HicedrnResBlock_{i}" in params), variant)
    raise ValueError("not a params tree of a known backbone (no HicedrnResBlock_0, "
                     "SR3ResBlock_0, UnetResnetBlock_0 or _ResnetBlock1d_0)")


def _layout_of_state_dict(state_dict: dict) -> list:
    if "init_conv.weight" in state_dict:
        levels = _count(lambda i: f"downs.{i}.0.mlp.1.weight" in state_dict)
        if state_dict["init_conv.weight"].ndim == 3:
            return _unet1d_layout(levels)
        return _unet_layout(levels, sr3="noise_level_mlp.1.weight" in state_dict,
                            learned="time_mlp.0.weights" in state_dict)
    if "body.0.conv.proj.weight" in state_dict:
        blocks = _count(lambda i: f"body.{i}.conv.proj.weight" in state_dict)
        variant = ("sr3" if "noise_level_mlp.1.weight" in state_dict
                   else "att" if "attn.0.to_qkv.weight" in state_dict else "base")
        return _hicedrn_layout(blocks, variant)
    raise ValueError("not a state dict of a known backbone (no body.0.conv.proj.weight "
                     "or init_conv.weight)")


def _c(path, name, kind="conv"):
    """One table entry; `path` is "/"-separated."""
    return (tuple(path.split("/")), name, kind)


def _bn_resblock(flax, port) -> list:  # conv - bn - conv - bn, in flax's order
    return [_c(f"{flax}Conv2d_0", f"{port}conv1"), _c(f"{flax}BatchNorm_0", f"{port}bn1", "bn"),
            _c(f"{flax}Conv2d_1", f"{port}conv2"), _c(f"{flax}BatchNorm_1", f"{port}bn2", "bn")]


def _generator_layout(blocks: int) -> list:
    return ([_c("Conv2d_0", "head")]
            + [_c(f"Conv2d_{i + 1}", f"body.{i}.res_conv") for i in range(blocks)]
            + [_c(f"Conv2d_{blocks + 1}", f"body.{blocks}"), _c(f"Conv2d_{blocks + 2}", "tail")])


def _deephic_layout(blocks: int) -> list:
    layout = [_c("Conv2d_0", "conv1")]
    for i in range(blocks):
        layout += _bn_resblock(f"_BNResBlock_{i}/", f"resblocks.{i}.")
    return layout + [_c("Conv2d_1", "conv2"), _c("BatchNorm_0", "bn2", "bn"), _c("Conv2d_2", "conv3")]


def _hicsr_layout(blocks: int) -> list:
    layout = [_c("Conv2d_0", "pre_res_block.0")]
    for i in range(blocks):
        layout += [_c(f"Conv2d_{2 * i + 1}", f"res_blocks.{i}.conv1"),
                   _c(f"BatchNorm_{2 * i}", f"res_blocks.{i}.bn1", "bn"),
                   _c(f"Conv2d_{2 * i + 2}", f"res_blocks.{i}.conv2"),
                   _c(f"BatchNorm_{2 * i + 1}", f"res_blocks.{i}.bn2", "bn")]
    layout += [_c(f"Conv2d_{2 * blocks + 1}", "post_res_block.0"),
               _c(f"BatchNorm_{2 * blocks}", "post_res_block.1", "bn")]
    return layout + [_c(f"Conv2d_{2 * blocks + 2 + j}", f"final_block.{j}") for j in range(5)]


def _dae_layout(layers: int) -> list:
    return ([_c("Conv_0", "conv_layers.0.0", "bare")]
            + [_c(f"Conv2d_{i}", f"conv_layers.{i + 1}.0") for i in range(layers - 1)]
            + [_c(f"ConvTranspose_{i}", f"deconv_layers.{i}.0", "convt") for i in range(layers - 1)]
            + [_c(f"ConvTranspose_{layers - 1}", f"deconv_layers.{layers - 1}", "convt")])


def _unet2d_layout() -> list:
    layout = []

    def double(flax, port):
        layout.extend([_c(f"{flax}/Conv_0", f"{port}.double_conv.0", "bare"),
                       _c(f"{flax}/BatchNorm_0", f"{port}.double_conv.1", "bn"),
                       _c(f"{flax}/Conv_1", f"{port}.double_conv.3", "bare"),
                       _c(f"{flax}/BatchNorm_1", f"{port}.double_conv.4", "bn")])

    for i, port in enumerate(("conv1", "conv2", "conv3", "conv4", "center")):
        double(f"_DoubleConv_{i}", port)
    for i, level in enumerate((4, 3, 2, 1)):
        layout.append(_c(f"ConvTranspose_{i}", f"up_concat{level}.up", "convt"))
        double(f"_DoubleConv_{5 + i}", f"up_concat{level}.conv")
    return layout + [_c("Conv_0", "final", "bare")]


def _hicarn_layout() -> list:
    layout = [_c("Conv2d_0", "entry")]
    for k in range(5):  # the cascading blocks' convs, then the fusion after each
        n, cb = 1 + 7 * k, f"cb{k + 1}"
        layout += [_c(f"Conv2d_{n}", f"{cb}.r1.conv1"), _c(f"Conv2d_{n + 1}", f"{cb}.r1.conv2"),
                   _c(f"Conv2d_{n + 2}", f"{cb}.c1"), _c(f"Conv2d_{n + 3}", f"{cb}.r2.conv1"),
                   _c(f"Conv2d_{n + 4}", f"{cb}.r2.conv2"), _c(f"Conv2d_{n + 5}", f"{cb}.c2"),
                   _c(f"Conv2d_{n + 6}", f"cv{k + 1}")]
    return layout + [_c("Conv2d_36", "cv6"), _c("Conv2d_37", "cv7")]


def _vgg_layout(convs: int) -> list:
    layout, i = [], 0
    pools = (2, 4, 8, 12) if convs == 16 else (2, 4, 7, 10)  # convs before each max-pool
    for n in range(convs):
        i += n in pools
        layout.append(_c(f"Conv_{n}", f"features.{i}", "bare"))
        i += 2
    return layout


def _cbl_stage(i) -> list:
    return [_c(f"Conv_{i}", f"body.{2 + i}.0", "bare"), _c(f"BatchNorm_{i}", f"body.{2 + i}.1", "bn")]


# class name -> (layout(n), n from the flax params, n from the port's state
# dict); n is the depth the model was built with, or unused
_BASELINE_LAYOUTS = {
    "HicPlus": (lambda n: [_c("Conv2d_0", "conv1"), _c("Conv2d_1", "conv2"),
                           _c("Conv2d_2", "conv3")], None, None),
    "HicedrnGenerator": (_generator_layout,
                         lambda p: _count(lambda i: f"Conv2d_{i}" in p) - 3,
                         lambda sd: _count(lambda i: f"body.{i}.res_conv.weight" in sd)),
    "DeepHiC": (_deephic_layout, lambda p: _count(lambda i: f"_BNResBlock_{i}" in p),
                lambda sd: _count(lambda i: f"resblocks.{i}.conv1.weight" in sd)),
    "HiCSR": (_hicsr_layout, lambda p: (_count(lambda i: f"BatchNorm_{i}" in p) - 1) // 2,
              lambda sd: _count(lambda i: f"res_blocks.{i}.conv1.weight" in sd)),
    "DAE": (_dae_layout, lambda p: _count(lambda i: f"ConvTranspose_{i}" in p),
            lambda sd: _count(lambda i: f"deconv_layers.{i}.0.weight" in sd) + 1),
    "Unet2D": (lambda n: _unet2d_layout(), None, None),
    "HiCARN": (lambda n: _hicarn_layout(), None, None),
    "DeepHiCDiscriminator": (lambda n: [
        _c("Conv2d_0", "conv1"), _c("Conv_0", "conv2", "bare"), _c("BatchNorm_0", "bn2", "bn"),
        _c("Conv2d_1", "conv3"), _c("BatchNorm_1", "bn3", "bn"), _c("Conv_1", "conv4", "bare"),
        _c("BatchNorm_2", "bn4", "bn"), _c("Conv2d_2", "conv5"), _c("BatchNorm_3", "bn5", "bn"),
        _c("Conv_2", "conv6", "bare"), _c("BatchNorm_4", "bn6", "bn"), _c("Conv2d_3", "conv7"),
    ], None, None),
    "HiCSRDiscriminator": (lambda n: [
        _c("Conv_0", "conv.0", "bare"), _c("Conv_1", "conv.2", "bare"),
        _c("BatchNorm_0", "conv.3", "bn"), _c("Conv_2", "conv.5", "bare"),
        _c("BatchNorm_1", "conv.6", "bn"), _c("Conv_3", "conv.8", "bare"),
        _c("BatchNorm_2", "conv.9", "bn"), _c("Conv_4", "conv.11", "bare"),
    ], None, None),
    "HiedsrDiscriminator": (lambda n: (
        [_c("Conv2d_0", "body.0")] + [e for i in range(7) for e in _cbl_stage(i)]
        + [_c("Conv2d_1", "body.9")]), None, None),
    "VAEModel": (lambda n: (
        [_c(f"enc{i}", f"enc_convs.{i}", "bare") for i in range(4)]
        + [_c("enc_pre", "enc_dense", "linear"), _c("mu", "mu_head", "linear"),
           _c("logvar", "logvar_head", "linear"), _c("dec_pre", "dec_dense", "linear")]
        + [_c(f"dec{i}", f"dec_convs.{i}", "convt") for i in range(3)]
        + [_c("dec_out", "dec_out", "convt")]), None, None),
    "VGGFeatures": (_vgg_layout, lambda p: _count(lambda i: f"Conv_{i}" in p),
                    lambda sd: len([k for k in sd if k.startswith("features.")]) // 2),
}


def _baseline_layout(model: str, tree: dict, from_flax: bool) -> list:
    """The table of baseline `model` at the depth `tree` (flax params, or
    the port's state dict) was built with."""
    if model not in _BASELINE_LAYOUTS:
        raise ValueError(f"model must be one of {sorted(_BASELINE_LAYOUTS)}, got {model!r}")
    layout, depth_of_params, depth_of_state_dict = _BASELINE_LAYOUTS[model]
    depth_of = depth_of_params if from_flax else depth_of_state_dict
    return layout(depth_of(tree) if depth_of else None)


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))  # a writable copy


def params_from_jax(tree: dict, *, model: Optional[str] = None) -> dict[str, torch.Tensor]:
    """A flax tree -> the port's float32 state dict. With model None, the
    params of a registry backbone (nested dict of arrays). With `model` a
    baseline's class name (module docstring), its bare params or its
    variables {"params", "batch_stats"}; the running statistics come with
    the latter only."""
    params, stats = tree, {}
    if model is None:
        layout = _layout_of_params(params)
    else:
        if "params" in tree:
            params, stats = tree["params"], tree.get("batch_stats") or {}
        layout = _baseline_layout(model, params, from_flax=True)
    sd = {}

    def oihw(kernel) -> torch.Tensor:
        k = np.asarray(kernel)
        return _tensor(k.transpose(3, 2, 0, 1) if k.ndim == 4 else k.transpose(2, 1, 0))

    def walk(t, path):
        for key in path:
            t = t[key]
        return t

    for path, name, kind in layout:
        node = walk(params, path)
        if kind in ("conv", "bare", "convt"):
            leaves = node["Conv_0"] if kind == "conv" else node
            if kind == "convt":
                sd[name + ".weight"] = _tensor(np.asarray(leaves["kernel"])[::-1, ::-1]
                                               .transpose(2, 3, 0, 1))
            else:
                sd[name + ".weight"] = oihw(leaves["kernel"])
            if "bias" in leaves:
                sd[name + ".bias"] = _tensor(leaves["bias"])
        elif kind in ("dense", "linear"):
            leaves = node["Dense_0"] if kind == "dense" else node
            sd[name + ".weight"] = _tensor(np.asarray(leaves["kernel"]).T)
            sd[name + ".bias"] = _tensor(leaves["bias"])
        elif kind == "weights":
            sd[name + ".weights"] = _tensor(node["weights"])
        elif kind in ("gn", "bn"):
            sd[name + ".weight"] = _tensor(node["scale"])
            sd[name + ".bias"] = _tensor(node["bias"])
            if kind == "bn" and stats:
                st = walk(stats, path)
                sd[name + ".running_mean"] = _tensor(st["mean"])
                sd[name + ".running_var"] = _tensor(st["var"])
        else:  # g, g1
            sd[name + ".g"] = _tensor(node["g"]).reshape((1, -1, 1, 1) if kind == "g" else (1, -1, 1))
    return sd


def params_to_jax(state_dict: dict, *, model: Optional[str] = None) -> dict:
    """The port's state dict -> a flax tree of float32 numpy arrays, in the
    module order flax's init gives: a registry backbone's params (model
    None), or a baseline's (`model` its class name) bare params, or its
    variables {"params", "batch_stats"} when it has BatchNorm."""

    def array(name) -> np.ndarray:
        return np.ascontiguousarray(
            state_dict[name].detach().to("cpu", torch.float32).numpy())

    def hwio(name) -> np.ndarray:
        w = array(name)
        return np.ascontiguousarray(w.transpose(2, 3, 1, 0) if w.ndim == 4 else w.transpose(2, 1, 0))

    def at(tree, path) -> dict:
        for key in path[:-1]:
            tree = tree.setdefault(key, {})
        return tree

    layout = (_layout_of_state_dict(state_dict) if model is None
              else _baseline_layout(model, state_dict, from_flax=False))
    params: dict = {}
    stats: dict = {}
    for path, name, kind in layout:
        tree = at(params, path)
        if kind in ("conv", "bare", "convt"):
            if kind == "convt":
                kernel = np.ascontiguousarray(array(name + ".weight")[:, :, ::-1, ::-1]
                                              .transpose(2, 3, 0, 1))
            else:
                kernel = hwio(name + ".weight")
            leaves = {"kernel": kernel}
            if name + ".bias" in state_dict:
                leaves["bias"] = array(name + ".bias")
            tree[path[-1]] = {"Conv_0": leaves} if kind == "conv" else leaves
        elif kind in ("dense", "linear"):
            leaves = {"kernel": np.ascontiguousarray(array(name + ".weight").T),
                      "bias": array(name + ".bias")}
            tree[path[-1]] = {"Dense_0": leaves} if kind == "dense" else leaves
        elif kind == "weights":
            tree[path[-1]] = {"weights": array(name + ".weights")}
        elif kind in ("gn", "bn"):
            tree[path[-1]] = {"scale": array(name + ".weight"), "bias": array(name + ".bias")}
            if kind == "bn":
                at(stats, path)[path[-1]] = {"mean": array(name + ".running_mean"),
                                             "var": array(name + ".running_var")}
        else:  # g, g1
            tree[path[-1]] = {"g": np.ascontiguousarray(array(name + ".g").reshape(-1))}
    return {"params": params, "batch_stats": stats} if stats else params


def state_dict_from_reference(sd: dict) -> dict[str, torch.Tensor]:
    """A reference backbone state dict as `torch.load` reads it -> the
    port's float32 state dict. It may be the bare backbone's or the
    reference's `torch.save(GaussianDiffusion.state_dict())`, whose backbone
    keys are `model.`-prefixed and which carries the schedule buffers
    (dropped: the engine rebuilds them from its config)."""
    if any(k.startswith("model.") for k in sd):
        sd = {k[len("model."):]: v for k, v in sd.items() if k.startswith("model.")}
    out = {k: torch.as_tensor(v).detach().to("cpu", torch.float32).clone() for k, v in sd.items()}
    _layout_of_state_dict(out)  # raises on a state dict of no known backbone
    return out


def state_dict_to_reference(sd: dict, prefix: str = "") -> dict[str, torch.Tensor]:
    """The port's state dict of a registry backbone -> the reference's
    layout: the same names, each with `prefix` (`"model."` for the
    reference's GaussianDiffusion layout, whose schedule buffers are not
    written: load it with strict=False or into the bare backbone), as
    contiguous float32 CPU tensors."""
    _layout_of_state_dict(sd)
    return {prefix + k: v.detach().to("cpu", torch.float32).contiguous() for k, v in sd.items()}


def adam_state_to_jax(mu: dict, nu: dict, count: int) -> dict:
    """Adam's moments (state dicts of the port's parameter names) and step
    count in optax's serialised layout (module docstring)."""
    return {"0": {"count": np.asarray(count, np.int32), "mu": params_to_jax(mu),
                  "nu": params_to_jax(nu)}, "1": {}}


def adam_state_from_jax(opt_state: dict) -> tuple[dict, dict, int]:
    """(mu, nu, count) from optax's serialised Adam state, as
    `load_checkpoint` returns it: the moments as float32 state dicts."""
    adam = opt_state["0"]
    return (params_from_jax(adam["mu"]), params_from_jax(adam["nu"]),
            int(np.asarray(adam["count"])))
