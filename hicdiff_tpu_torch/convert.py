"""Parameters of the JAX package's HicedrnDiff -> the port's state dict.

The key map and transposes are those of tools/export_torch_checkpoint.py
(flax `Conv2d_0` / `TimeMLP_0` / `HicedrnResBlock_{i}` names -> the
reference's `head` / `time_mlp.1` / `body.{i}.conv.proj` names; conv kernels
HWIO -> OIHW, Dense kernels transposed), carried here so the port imports
neither `tools/` nor the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_jax"]


def params_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """flax HicedrnDiff params (nested dict of arrays) -> float32 state dict."""
    sd = {}

    def tensor(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=np.float32))  # a writable copy

    def conv(name, tree):
        k = np.asarray(tree["Conv_0"]["kernel"])  # (kh, kw, in, out)
        sd[name + ".weight"] = tensor(k.transpose(3, 2, 0, 1))
        sd[name + ".bias"] = tensor(tree["Conv_0"]["bias"])

    def dense(name, tree):
        sd[name + ".weight"] = tensor(np.asarray(tree["Dense_0"]["kernel"]).T)
        sd[name + ".bias"] = tensor(tree["Dense_0"]["bias"])

    if "HicedrnResBlock_0" not in params:
        raise ValueError("not a HicedrnDiff params tree (no HicedrnResBlock_0)")
    conv("head", params["Conv2d_0"])
    conv("body_tail", params["Conv2d_1"])
    conv("tail", params["Conv2d_2"])
    dense("time_mlp.1", params["TimeMLP_0"]["Dense_0"])
    dense("time_mlp.3", params["TimeMLP_0"]["Dense_1"])
    i = 0
    while f"HicedrnResBlock_{i}" in params:
        block = params[f"HicedrnResBlock_{i}"]
        conv(f"body.{i}.conv.proj", block["Conv2d_0"])
        dense(f"body.{i}.mlp.1", block["Dense_0"])
        i += 1
    return sd
