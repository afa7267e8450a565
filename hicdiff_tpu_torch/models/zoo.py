"""The model registries (port of hicdiff_tpu/models/zoo.py): the diffusion
backbones and the baselines, with the baselines' checkpoint-aware loader.

name -> ctor(self_condition, dtype, *, device, generator=None), the five
backbones of the pretrain experiments ({hicedrn, hicedrn_att, hicedrn_sr3,
unet, unet_sr3}), each at the width and depth the JAX registry builds:
32 blocks x 256 features for the hicedrn variants, Unet(dim=64,
dim_mults=(1, 2, 4, 8)) for the U-Nets. Shared by `pretrain_torch.py`
(training) and `inference_torch.py --model` (evaluation).

`BASELINES`: name -> (ctor, needs the 6-pixel pad, native output range),
each ctor the model's class, built as `cls(device=, generator=)` at the JAX
registry's size;
`load_baseline` builds one with the checkpoint of its name overlaid, for
`sample/stard_metric_normal_torch.py`, trained by
`pretrain_baselines_torch.py`.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from hicdiff_tpu_torch.convert import params_from_jax
from hicdiff_tpu_torch.models.baselines import DeepHiC, HiCARN, HiCSR, HicPlus, Unet2D
from hicdiff_tpu_torch.models.hicedrn import HicedrnDiff, HicedrnGenerator
from hicdiff_tpu_torch.models.unet import Unet
from hicdiff_tpu_torch.train.checkpoint import load_checkpoint

__all__ = ["BASELINES", "DIFFUSION_BACKBONES", "TABLE_BASELINES", "baseline_checkpoint_path",
           "load_baseline"]


def _hicedrn(variant):
    def ctor(sc, dt, *, device, generator=None):
        return HicedrnDiff(self_condition=sc, variant=variant, dtype=dt, device=device,
                           generator=generator)
    return ctor


def _unet(noise_level_emb):
    def ctor(sc, dt, *, device, generator=None):
        return Unet(dim=64, dim_mults=(1, 2, 4, 8), self_condition=sc,
                    noise_level_emb=noise_level_emb, dtype=dt, device=device,
                    generator=generator)
    return ctor


DIFFUSION_BACKBONES: Dict[str, Callable] = {
    "hicedrn": _hicedrn("base"),
    "hicedrn_att": _hicedrn("att"),
    "hicedrn_sr3": _hicedrn("sr3"),
    "unet": _unet(False),
    "unet_sr3": _unet(True),
}

# name -> (ctor, needs_6px_pad, native output range); ctor(device=,
# generator=) builds the model at the JAX registry's size. Output range ('pm1' =
# [-1, 1], '01' = [0, 1]): deephic ends in (tanh + 1) / 2, unet_2D in a
# sigmoid, hicplus in a relu, so they train in their native range and
# load_baseline maps them back to the [-1, 1] patch convention (the JAX
# registry's note, PARITY.md #31). hiedsrgan and hiedsrgan_bce are the hiedsr
# generator trained adversarially (pretrain_baselines_torch.py --models
# hiedsrgan, --disc-loss srgan / bce); they are not in the reference's table.
BASELINES: Dict[str, Tuple[Callable, bool, str]] = {
    "hiedsr": (HicedrnGenerator, False, "pm1"),
    "hicarn": (HiCARN, False, "pm1"),
    "deephic": (DeepHiC, False, "01"),
    "hicsr": (HiCSR, True, "pm1"),
    "unet": (Unet2D, False, "01"),
    "hicplus": (HicPlus, True, "01"),
    "hiedsrgan": (HicedrnGenerator, False, "pm1"),
    "hiedsrgan_bce": (HicedrnGenerator, False, "pm1"),
}

# the reference's six-model evaluation table (stard_metric_normal.py:141)
TABLE_BASELINES = ["hiedsr", "hicarn", "deephic", "hicsr", "unet", "hicplus"]


def baseline_checkpoint_path(wdir: str, name: str, cell_line: str, celln: int, deg: str,
                             sigma) -> str:
    """The reference's weight-file convention (3DComp.py:97-132), .msgpack."""
    return os.path.join(
        wdir, f"finalg_40000_c64_s64_{cell_line}{celln}_{deg}_{sigma}_{name}.msgpack")


def load_baseline(
    name: str,
    *,
    wdir: str,
    cell_line: str = "Human",
    celln: int = 1,
    deg: str = "deno",
    sigma=0.1,
    device,
    generator: Optional[torch.Generator] = None,
) -> Tuple[Callable, bool]:
    """(model_fn, had_checkpoint) of a named baseline on `device`.

    The model is drawn from `generator` (default: seeded 0) and the
    checkpoint of its name in `wdir`, if there is one, is loaded over it:
    bare params, or {"params", "batch_stats"} (a bare-params file leaves a
    BatchNorm model's running statistics at their init, as in the JAX
    loader). model_fn maps an NHWC (B, 64, 64, 1) [-1, 1] numpy batch to the
    [-1, 1] prediction, a tensor on `device`: '01' models see (x + 1) / 2
    and give 2 * out - 1, hicplus and hicsr see the batch padded by 6
    pixels of zeros (after the range map), as the JAX loader does."""
    ctor, needs_pad, out_range = BASELINES[name]
    model = ctor(device=device, generator=generator if generator is not None
                else torch.Generator().manual_seed(0))
    ckpt = baseline_checkpoint_path(wdir, name, cell_line, celln, deg, sigma)
    had = os.path.exists(ckpt)
    if had:
        kind = type(model).__name__
        sd = params_from_jax(load_checkpoint(ckpt, only={"params"})["params"], model=kind)
        missing = model.load_state_dict(sd, strict=False).missing_keys
        if any(not k.endswith(("running_mean", "running_var")) for k in missing):
            raise ValueError(f"{ckpt} lacks parameters of {kind}: {missing}")
    model.eval()

    @torch.no_grad()
    def model_fn(lr_batch) -> torch.Tensor:
        x = torch.as_tensor(np.asarray(lr_batch, np.float32), device=device)
        if out_range == "01":
            x = (x + 1.0) / 2.0
        if needs_pad:
            x = F.pad(x, (0, 0, 6, 6, 6, 6))
        out = model(x)
        return out * 2.0 - 1.0 if out_range == "01" else out

    return model_fn, had
