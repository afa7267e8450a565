"""Shared model building blocks (port of hicdiff_tpu/models/common.py).

Convolutions and linear layers are plain `nn.Conv2d` / `nn.Linear`; their
parameters are initialised by `init_torch_default` from an explicit
generator with the same distribution as PyTorch's own default (and as the
JAX package's `torch_kernel_init` / `torch_bias_init`).

Tensors are NHWC, as in the JAX package. A layer given a compute `dtype`
casts its input and weights to it, as a flax layer with `dtype=` does; with
None it computes in its input's dtype. The normalizations keep their
parameters in fp32, so a bf16 input comes out of them in fp32, as JAX's type
promotion makes it.

The baselines (`models/baselines.py`) mix three inits, each a layer kind of
the JAX package: its `Conv2d` wrapper (PyTorch's default), flax's default for
a bare `nn.Conv` / `nn.ConvTranspose` (LeCun: a truncated normal scaled by
fan-in, zero bias), and the kaiming normal of `Unet2D`. `init_layers` draws
each layer by its `init_kind`; `BatchNorm` is flax's, with its running
statistics as buffers.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "BatchNorm", "ChannelLayerNorm", "frozen_batch_stats", "init_layers",
    "LearnedSinusoidalPosEmb", "NoiseLevelMLP", "ParamCache", "SR3PositionalEncoding",
    "SinusoidalPosEmb", "TimeMLP", "conv_nhwc", "dense", "init_torch_default",
    "layer_norm_channels", "linear",
]


def conv_nhwc(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """SAME conv of an NHWC tensor with an OIHW weight (odd kernel), in
    `dtype` (None: x's). The NCHW view of NHWC memory is channels_last, so
    no copy is made on the way in or out.

    The bias is added to the conv's output in `dtype`, as flax's Conv adds
    it: in bf16 the conv is rounded, then its sum with the bias. cuDNN adds
    it so too; PyTorch's CPU conv would fold it into the fp32 sum and round
    once."""
    dt = dtype or x.dtype
    y = F.conv2d(x.to(dt).permute(0, 3, 1, 2), weight.to(dt), None,
                 padding=weight.shape[-1] // 2)
    if bias is not None:
        y = y.add_(bias.to(dt)[:, None, None])
    return y.permute(0, 2, 3, 1).contiguous()


def dense(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """x @ weight.T + bias in x's dtype. In bf16 the product is rounded
    before the bias is added, as flax's Dense adds it (PyTorch's call with
    the bias rounds once, on the CPU and through cuBLAS's epilogue)."""
    if x.dtype == torch.bfloat16:
        return F.linear(x, weight) + bias
    return F.linear(x, weight, bias)


def linear(x: torch.Tensor, layer: nn.Linear, dtype: Optional[torch.dtype] = None):
    """`layer` applied in `dtype` (None: x's), through `dense`."""
    dt = dtype or x.dtype
    return dense(x.to(dt), layer.weight.to(dt), layer.bias.to(dt))


class ParamCache:
    """A per-module cache of values derived from parameters (a packed or
    standardized weight), kept until one of them changes."""

    def _cached(self, what, params, make):
        """make(*detached params), kept until one of `params` changes (a new
        tensor or an in-place update, as an optimizer step makes)."""
        cache = self.__dict__.setdefault("_cache", {})
        key = tuple((p.device, p.data_ptr(), p._version) for p in params)
        hit = cache.get(what)
        if hit is None or hit[0] != key:
            hit = cache[what] = (key, make(*(p.detach() for p in params)))
        return hit[1]


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


class LearnedSinusoidalPosEmb(nn.Module):
    """Learned (or, with is_random, fixed random Fourier) sinusoidal
    embedding of dim + 1 features: t, sin(2 pi t w), cos(2 pi t w) for the
    dim // 2 frequencies w, drawn from N(0, 1). The random variant's
    frequencies take no gradient."""

    def __init__(self, dim: int, is_random: bool = False, *, device=None):
        super().__init__()
        self.weights = nn.Parameter(torch.zeros(dim // 2, device=device),
                                    requires_grad=not is_random)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        t = t.float()[:, None]
        freqs = t * self.weights[None, :] * 2 * math.pi
        return torch.cat([t, freqs.sin(), freqs.cos()], dim=-1)


class SR3PositionalEncoding(nn.Module):
    """WaveGrad-style encoding of a continuous noise level (sqrt alpha-bar),
    fp32: level * exp(-ln(1e4) * i / count) for i < count = dim // 2, then
    [sin, cos]."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, noise_level: torch.Tensor) -> torch.Tensor:
        count = self.dim // 2
        step = torch.arange(count, dtype=torch.float32, device=noise_level.device) / count
        encoding = noise_level.float()[:, None] * torch.exp(-math.log(1e4) * step[None, :])
        return torch.cat([encoding.sin(), encoding.cos()], dim=-1)


class TimeMLP(nn.Sequential):
    """sinusoidal(fourier_dim) -> Linear -> GELU (exact erf) -> Linear, in fp32.
    With `learned_dim`, a LearnedSinusoidalPosEmb(learned_dim, `random`) of
    learned_dim + 1 features replaces the fixed embedding.

    A Sequential so its parameters are named `0.weights` (learned), `1.*`
    and `3.*`, the reference state-dict layout (`time_mlp.1.weight`, ...)."""

    def __init__(self, fourier_dim: int, time_dim: int, *, learned_dim: Optional[int] = None,
                 random: bool = False, device=None):
        if learned_dim is None:
            emb, width = SinusoidalPosEmb(fourier_dim), fourier_dim
        else:
            emb = LearnedSinusoidalPosEmb(learned_dim, random, device=device)
            width = learned_dim + 1
        super().__init__(
            emb,
            nn.Linear(width, time_dim, device=device),
            nn.GELU(),
            nn.Linear(time_dim, time_dim, device=device),
        )


class NoiseLevelMLP(nn.Sequential):
    """The SR3 time path: SR3PositionalEncoding(dim) (fp32) -> Linear(dim,
    time_dim) -> exact GELU -> Linear(time_dim, time_dim), the Linears in
    the compute dtype (None: fp32). Laid out as the SR3 code's
    `noise_level_mlp` Sequential (`noise_level_mlp.1.*`, `.3.*`)."""

    def __init__(self, dim: int, time_dim: int, *, device=None):
        super().__init__(
            SR3PositionalEncoding(dim),
            nn.Linear(dim, time_dim, device=device),
            nn.GELU(),
            nn.Linear(time_dim, time_dim, device=device),
        )

    def forward(self, noise_level: torch.Tensor, dtype: Optional[torch.dtype] = None):
        emb = self[0](noise_level).to(dtype or torch.float32)
        return linear(F.gelu(linear(emb, self[1])), self[3])


def layer_norm_channels(x: torch.Tensor, g: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the channel (last) axis: biased variance, (x - mean) *
    rsqrt(var + eps) * g. The statistics are computed in fp32 and rounded to
    x's dtype, as jnp.mean / jnp.var do; g is fp32, so the result is fp32."""
    xf = x.float()
    var = xf.var(-1, keepdim=True, unbiased=False).to(x.dtype)
    mean = xf.mean(-1, keepdim=True).to(x.dtype)
    return (x - mean) * torch.rsqrt(var + eps) * g


class ChannelLayerNorm(nn.Module):
    """LayerNorm with a learnable per-channel scale `g` only, fp32, of the
    reference's shape (1, C, 1, 1)."""

    def __init__(self, dim: int, *, device=None):
        super().__init__()
        self.g = nn.Parameter(torch.ones(1, dim, 1, 1, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm_channels(x, self.g.reshape(-1))


@torch.no_grad()
def init_torch_default(module: nn.Module, generator: torch.Generator) -> None:
    """PyTorch's default init for every Conv2d / Linear, drawn from `generator`;
    GroupNorm and ChannelLayerNorm scales to one, their biases to zero.

    kaiming_uniform(a=sqrt(5)) on the weight and U(+-1/sqrt(fan_in)) on the
    bias both reduce to U(-1/sqrt(fan_in), 1/sqrt(fan_in)). Parameters must
    lie on the generator's device."""
    for m in module.modules():
        if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Linear)):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            m.weight.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                m.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, nn.GroupNorm):
            m.reset_parameters()
        elif isinstance(m, ChannelLayerNorm):
            m.g.fill_(1.0)
        elif isinstance(m, LearnedSinusoidalPosEmb):
            m.weights.normal_(generator=generator)


class BatchNorm(nn.Module):
    """flax.linen.BatchNorm (momentum 0.99, epsilon 1e-5) over the channel
    axis 1 of an NCHW tensor: `weight` and `bias` are flax's scale and
    bias, the buffers `running_mean` and `running_var` its batch_stats.

    forward(x, train): train=False normalizes with the running statistics;
    train=True with the batch's mean and biased variance E[x^2] - E[x]^2
    (clipped at 0), computed in fp32 and differentiated through, and moves
    the running statistics toward them, as flax's mutable batch_stats:
    new = 0.99 * old + 0.01 * batch. torch.nn.BatchNorm2d differs in both:
    its momentum weights the new value, and it keeps the unbiased variance.
    Inside `frozen_batch_stats` a train-mode call leaves them as they are,
    as a flax call whose batch_stats update is discarded."""

    def __init__(self, features: int, *, momentum: float = 0.99, eps: float = 1e-5,
                 device=None):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("running_mean", torch.zeros(features, device=device))
        self.register_buffer("running_var", torch.ones(features, device=device))
        self.update_stats = True

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train:
            xf = x.float()
            mean = xf.mean(dim=(0, 2, 3))
            var = torch.clamp_min(xf.square().mean(dim=(0, 2, 3)) - mean.square(), 0.0)
            if self.update_stats:
                with torch.no_grad():
                    m = self.momentum
                    self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                    self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        shape = (1, -1, 1, 1)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.reshape(shape)) * mul.reshape(shape) + self.bias.reshape(shape)


@contextlib.contextmanager
def frozen_batch_stats(module: nn.Module):
    """Inside, train-mode calls of `module`'s BatchNorm layers normalize with
    their batch's statistics but do not move the running ones."""
    layers = [m for m in module.modules() if isinstance(m, BatchNorm)]
    before = [m.update_stats for m in layers]
    for m in layers:
        m.update_stats = False
    try:
        yield
    finally:
        for m, flag in zip(layers, before):
            m.update_stats = flag


@torch.no_grad()
def init_layers(module: nn.Module, generator: torch.Generator) -> None:
    """Every conv / linear layer of `module` drawn from `generator` as the
    JAX package draws its counterpart, by the layer's `init_kind`:

      'torch'   (the default) PyTorch's own init, U(+-1/sqrt(fan_in)) on
                weight and bias: the JAX package's `Conv2d` / `Dense`
      'lecun'   flax's default for a bare nn.Conv / nn.ConvTranspose: a
                normal truncated at 2 sigma, std sqrt(1/fan_in) / 0.8796
                (the truncated law's std), zero bias
      'kaiming' a normal of variance 2/fan_in, zero bias (`Unet2D`)

    fan_in counts the kernel's window times its input channels, for a
    transposed conv too. BatchNorm: scale one (init_kind 'normal': drawn
    from N(1, 0.02), `Unet2D`'s), bias zero, running mean 0 and variance 1.
    Parameters must lie on the generator's device."""
    for m in module.modules():
        kind = getattr(m, "init_kind", "torch")
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            w = m.weight
            fan_in = w.shape[0] * w[0, 0].numel() if isinstance(m, nn.ConvTranspose2d) \
                else w[0].numel()
            if kind == "torch":
                bound = 1.0 / math.sqrt(fan_in)
                w.uniform_(-bound, bound, generator=generator)
                if m.bias is not None:
                    m.bias.uniform_(-bound, bound, generator=generator)
                continue
            if kind == "lecun":
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
            elif kind == "kaiming":
                nn.init.normal_(w, 0.0, math.sqrt(2.0 / fan_in), generator=generator)
            else:
                raise ValueError(f"unknown init_kind {kind!r}")
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, BatchNorm):
            if kind == "normal":
                m.weight.normal_(1.0, 0.02, generator=generator)
            else:
                m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
