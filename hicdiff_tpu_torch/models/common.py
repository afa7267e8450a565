"""Shared model building blocks (port of hicdiff_tpu/models/common.py).

Convolutions and linear layers are plain `nn.Conv2d` / `nn.Linear`; their
parameters are initialised by `init_torch_default` from an explicit
generator with the same distribution as PyTorch's own default (and as the
JAX package's `torch_kernel_init` / `torch_bias_init`).
"""
from __future__ import annotations

import math

import torch
from torch import nn

__all__ = ["SinusoidalPosEmb", "TimeMLP", "init_torch_default"]


class SinusoidalPosEmb(nn.Module):
    """Sinusoidal timestep embedding.

    emb[i] = exp(-log(10000) * i / (half_dim - 1)); out = cat(sin(t*emb), cos(t*emb)).
    """

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        half_dim = self.dim // 2
        scale = math.log(10000) / (half_dim - 1)
        emb = torch.exp(torch.arange(half_dim, dtype=torch.float32, device=t.device) * -scale)
        emb = t.float()[:, None] * emb[None, :]
        return torch.cat([emb.sin(), emb.cos()], dim=-1)


class TimeMLP(nn.Sequential):
    """sinusoidal(fourier_dim) -> Linear -> GELU (exact erf) -> Linear, in fp32.

    A Sequential so its parameters are named `1.*` and `3.*`, the reference
    state-dict layout (`time_mlp.1.weight`, ...)."""

    def __init__(self, fourier_dim: int, time_dim: int, *, device=None):
        super().__init__(
            SinusoidalPosEmb(fourier_dim),
            nn.Linear(fourier_dim, time_dim, device=device),
            nn.GELU(),
            nn.Linear(time_dim, time_dim, device=device),
        )


@torch.no_grad()
def init_torch_default(module: nn.Module, generator: torch.Generator) -> None:
    """PyTorch's default init for every Conv2d / Linear, drawn from `generator`.

    kaiming_uniform(a=sqrt(5)) on the weight and U(+-1/sqrt(fan_in)) on the
    bias both reduce to U(-1/sqrt(fan_in), 1/sqrt(fan_in)). Parameters must
    lie on the generator's device."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            m.weight.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                m.bias.uniform_(-bound, bound, generator=generator)
