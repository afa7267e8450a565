"""The HicedrnDiff backbone, base variant (port of hicdiff_tpu/models/hicedrn.py).

    head 3x3 conv (in_ch -> F; in_ch doubles when self-conditioned)
    time MLP: sinusoidal(F) -> Linear(F, 4F) -> GELU -> Linear(4F, 4F), fp32
    N residual blocks, each ONE shared 3x3 conv applied twice with a
      scale-shift after the first application, SiLU, x0.1 residual
    body_tail conv + global residual, tail conv to `channels`

Inputs and outputs are NHWC, as in the JAX package. Parameters are float32
and named in the reference's state-dict layout (`head.weight`,
`time_mlp.1.weight`, `body.{i}.mlp.1.weight`, `body.{i}.conv.proj.weight`,
`body_tail.*`, `tail.*`), so `params_from_jax` output and reference
`hicedrn_Diff` state dicts load with `load_state_dict`. `dtype` is the compute
dtype (None: the input's); the time MLP runs in fp32 and the output is fp32,
as in `HicedrnDiff(dtype=...)`.

Every residual block goes through `kernels.resblock.fused_resblock_prepared`:
the hand-written CUDA kernel for CUDA tensors, its plain version for CPU ones.
The head, body_tail and tail convs and the small GEMMs are `F.conv2d` /
`F.linear`, as the JAX package leaves them to XLA.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from hicdiff_tpu_torch.kernels.resblock import fused_resblock_prepared, prepare_weight
from hicdiff_tpu_torch.models.common import TimeMLP, init_torch_default

__all__ = ["HicedrnDiff", "HicedrnResBlock"]

N_FEAT = 256


def _conv_nhwc(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """3x3 SAME conv on an NHWC tensor in x's dtype. The NCHW view of NHWC
    memory is channels_last, so no copy is made on the way in or out."""
    dt = x.dtype
    y = F.conv2d(x.permute(0, 3, 1, 2), conv.weight.to(dt), conv.bias.to(dt), padding=1)
    return y.permute(0, 2, 3, 1).contiguous()


class HicedrnResBlock(nn.Module):
    """Time-conditioned residual block with a single conv applied twice."""

    def __init__(self, features: int = N_FEAT, *, device=None):
        super().__init__()
        self.mlp = nn.Sequential(nn.SiLU(), nn.Linear(features * 4, features * 2, device=device))
        self.conv = nn.ModuleDict(
            {"proj": nn.Conv2d(features, features, 3, padding=1, device=device)}
        )
        self._packed_key = None
        self._packed = None

    def _compute_weights(self, dtype):
        """(Dense weight, Dense bias, conv weight, conv bias) in `dtype`, the
        conv weight as the CUDA kernel of that dtype reads it (`prepare_weight`
        of the HWIO kernel). Made once per weight update and dtype rather than
        on every call."""
        params = (self.mlp[1].weight, self.mlp[1].bias, self.conv["proj"].weight,
                  self.conv["proj"].bias)
        key = (dtype, *((p.device, p.data_ptr(), p._version) for p in params))
        if key != self._packed_key:
            lin_w, lin_b, conv_w, conv_b = (p.detach() for p in params)
            self._packed = (
                lin_w.to(dtype), lin_b.to(dtype),
                prepare_weight(conv_w.permute(2, 3, 1, 0).to(dtype)),
                conv_b.to(dtype).contiguous(),
            )
            self._packed_key = key
        return self._packed

    def forward(self, x: torch.Tensor, t_act: torch.Tensor) -> torch.Tensor:
        """x (B,H,W,C) in the compute dtype; t_act = silu(t_emb) (B, 4C), same dtype."""
        lin_w, lin_b, weight, bias = self._compute_weights(x.dtype)
        scale, shift = F.linear(t_act, lin_w, lin_b).chunk(2, dim=-1)
        return fused_resblock_prepared(x, weight, bias, scale, shift)


class HicedrnDiff(nn.Module):
    """The hicedrn_Diff backbone, variant 'base'.

    Call: model(x, time, x_self_cond) with x (B, H, W, channels) NHWC and
    integer timesteps `time` (B,). Parameters are drawn on the CPU from
    `generator` (default: a fresh `torch.Generator()`) with PyTorch's default
    init, then moved to `device`, which the caller must name."""

    def __init__(
        self,
        *,
        channels: int = 1,
        number_resnet: int = 32,
        self_condition: bool = False,
        variant: str = "base",
        features: int = N_FEAT,
        dtype: Optional[torch.dtype] = None,
        device: torch.device | str,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if variant != "base":
            raise NotImplementedError(
                f"variant {variant!r} is not ported yet; only 'base' is"
            )
        self.channels = channels
        self.self_condition = self_condition
        self.dtype = dtype
        in_ch = channels * (2 if self_condition else 1)
        meta = torch.device("meta")  # shapes only; materialised and drawn below
        self.head = nn.Conv2d(in_ch, features, 3, padding=1, device=meta)
        self.time_mlp = TimeMLP(features, features * 4, device=meta)
        self.body = nn.ModuleList(
            HicedrnResBlock(features, device=meta) for _ in range(number_resnet)
        )
        self.body_tail = nn.Conv2d(features, features, 3, padding=1, device=meta)
        self.tail = nn.Conv2d(features, channels, 3, padding=1, device=meta)
        self.to_empty(device="cpu")
        init_torch_default(self, generator if generator is not None else torch.Generator())
        self.to(device)

    def forward(self, x, time, x_self_cond=None):
        if self.self_condition:
            if x_self_cond is None:
                x_self_cond = torch.zeros_like(x)
            # the reference concatenates (cond, x) along channels
            x = torch.cat([x_self_cond, x], dim=-1)
        cdt = self.dtype or x.dtype
        h = _conv_nhwc(x.to(cdt), self.head)
        r = h
        t_act = F.silu(self.time_mlp(time).to(cdt))
        for block in self.body:
            h = block(h, t_act)
        h = _conv_nhwc(h, self.body_tail) + r
        return _conv_nhwc(h, self.tail).float()
