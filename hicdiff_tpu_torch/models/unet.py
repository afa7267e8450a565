"""Attention U-Net diffusion backbone (port of hicdiff_tpu/models/unet.py).

The lucidrains-style `Unet` of the reference engines (hicdiff.py:255-387):
7x7 init conv, dims [init, d, 2d, 4d, 8d], per resolution [ResnetBlock x2,
Residual(PreNorm(LinearAttention)), Downsample], a full-attention mid block,
symmetric ups with skip concatenation, a final res block and 1x1 conv. Its
blocks: WeightStandardizedConv2d -> GroupNorm(8) -> scale-shift -> SiLU.
Downsample is space-to-depth with channel-major order (new channel
c * 4 + p1 * 2 + p2) + 1x1 conv; Upsample is nearest x2 + 3x3 conv.
`noise_level_emb=True` is the SR3 variant (hicdiff_sr3.py:348-359): it
conditions on a continuous noise level through `NoiseLevelMLP`.
`learned_sinusoidal_cond` (or `random_fourier_features`, its frequencies
fixed) replaces the fixed sinusoidal time embedding by a learned Fourier one
of learned_sinusoidal_dim + 1 features (hicdiff.py:136-151;
`time_mlp.0.weights`).

Tensors are NHWC. Parameters are float32 and named in the lucidrains
state-dict layout: `init_conv`, `time_mlp.{1,3}` (`noise_level_mlp.{1,3}`
for SR3), `downs.{i}.{0,1}` (ResnetBlocks: `mlp.1`, `block{1,2}.proj`,
`block{1,2}.norm`, `res_conv`), `downs.{i}.2.fn.norm.g` and
`downs.{i}.2.fn.fn.{to_qkv, to_out.0, to_out.1.g}`, `downs.{i}.3.1` (the
Downsample conv; `downs.{i}.3` at the last level), `mid_block1`,
`mid_attn.fn.{norm.g, fn.to_qkv, fn.to_out}`, `mid_block2`, `ups.{i}.*`
likewise (`ups.{i}.3.1` the Upsample conv), `final_res_block`,
`final_conv`.

Everything here is plain PyTorch (`F.conv2d`, `F.group_norm`,
`torch.matmul`): the JAX package's U-Net reaches no Pallas kernel. The bf16
dtype flow is JAX's on every device: the convs and Dense layers run in the
compute dtype, GroupNorm and the channel LayerNorm promote to fp32, so every
ResnetBlock gives fp32 while the convs between them give bf16.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from hicdiff_tpu_torch.models.common import (
    ChannelLayerNorm,
    NoiseLevelMLP,
    ParamCache,
    TimeMLP,
    conv_nhwc,
    init_torch_default,
    linear,
)
from hicdiff_tpu_torch.models.hicedrn import linear_attention

__all__ = ["Unet", "UnetAttention", "UnetLinearAttention", "UnetResnetBlock", "WSConv2d",
           "downsample_s2d"]


class WSConv2d(nn.Conv2d, ParamCache):
    """Weight-standardized conv: each output channel's kernel to zero mean
    and unit (biased) variance over (in, kh, kw), eps 1e-5, in fp32. The
    standardized weight is cached per weight update when no gradient is
    wanted."""

    def standardized(self) -> torch.Tensor:
        def make(w):
            mean = w.mean(dim=(1, 2, 3), keepdim=True)
            var = w.var(dim=(1, 2, 3), keepdim=True, unbiased=False)
            return (w - mean) * torch.rsqrt(var + 1e-5)

        if torch.is_grad_enabled() and self.weight.requires_grad:
            return make(self.weight)
        return self._cached("standardized", (self.weight,), make)

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        return conv_nhwc(x, self.standardized(), self.bias, dtype)


class UnetBlock(nn.Module):
    """WSConv -> GroupNorm (fp32) -> scale-shift -> SiLU."""

    def __init__(self, dim: int, dim_out: int, *, device=None):
        super().__init__()
        self.proj = WSConv2d(dim, dim_out, 3, padding=1, device=device)
        self.norm = nn.GroupNorm(8, dim_out, eps=1e-5, device=device)

    def forward(self, x, scale_shift=None, dtype=None):
        x = self.proj(x, dtype)
        x = F.group_norm(x.float().permute(0, 3, 1, 2), self.norm.num_groups, self.norm.weight,
                         self.norm.bias, self.norm.eps).permute(0, 2, 3, 1)
        if scale_shift is not None:
            scale, shift = scale_shift
            x = x * (scale + 1) + shift
        return F.silu(x)


class UnetResnetBlock(nn.Module):
    """block1 (scale-shift from Dense(silu(t))) -> block2 -> + res_conv(x);
    res_conv is a 1x1 conv only when the widths differ."""

    def __init__(self, dim: int, dim_out: int, time_emb_dim: int, *, device=None):
        super().__init__()
        self.mlp = nn.Sequential(nn.SiLU(), nn.Linear(time_emb_dim, dim_out * 2, device=device))
        self.block1 = UnetBlock(dim, dim_out, device=device)
        self.block2 = UnetBlock(dim_out, dim_out, device=device)
        self.res_conv = (nn.Conv2d(dim, dim_out, 1, device=device) if dim != dim_out
                         else nn.Identity())

    def forward(self, x, t_emb, dtype=None):
        te = linear(F.silu(t_emb), self.mlp[1], dtype)[:, None, None, :]
        h = self.block1(x, te.chunk(2, dim=-1), dtype)
        h = self.block2(h, None, dtype)
        if isinstance(self.res_conv, nn.Conv2d):
            x = conv_nhwc(x, self.res_conv.weight, self.res_conv.bias, dtype)
        return h + x


class UnetLinearAttention(nn.Module):
    """Linear attention without a pre-norm (the U-Net wraps it in one), post
    channel LayerNorm."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32, *, device=None):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        hidden = heads * dim_head
        self.to_qkv = nn.Conv2d(dim, hidden * 3, 1, bias=False, device=device)
        self.to_out = nn.Sequential(nn.Conv2d(hidden, dim, 1, device=device),
                                    ChannelLayerNorm(dim, device=device))

    def forward(self, x, dtype=None):
        qkv = conv_nhwc(x, self.to_qkv.weight, None, dtype)
        out = linear_attention(qkv, self.heads, self.dim_head, x.dtype)
        return self.to_out[1](conv_nhwc(out, self.to_out[0].weight, self.to_out[0].bias, dtype))


class UnetAttention(nn.Module):
    """Full softmax attention of the mid block: q scaled, the two products
    accumulated in fp32, the softmax in fp32 then cast to v's dtype."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32, *, device=None):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        hidden = heads * dim_head
        self.to_qkv = nn.Conv2d(dim, hidden * 3, 1, bias=False, device=device)
        self.to_out = nn.Conv2d(hidden, dim, 1, device=device)

    def forward(self, x, dtype=None):
        b, h, w, _ = x.shape
        heads, d = self.heads, self.dim_head
        qkv = conv_nhwc(x, self.to_qkv.weight, None, dtype).reshape(b, h * w, 3, heads, d)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # (b, heads, n, d)
        q = q * d**-0.5
        sim = torch.matmul(q.float(), k.float().transpose(-1, -2))
        attn = sim.softmax(dim=-1).to(v.dtype)
        out = torch.matmul(attn.float(), v.float())
        out = out.transpose(1, 2).reshape(b, h, w, heads * d).to(x.dtype)
        return conv_nhwc(out, self.to_out.weight, self.to_out.bias, dtype)


class _PreNorm(nn.Module):
    def __init__(self, dim: int, fn: nn.Module, *, device=None):
        super().__init__()
        self.fn = fn
        self.norm = ChannelLayerNorm(dim, device=device)


class _Residual(nn.Module):
    """Residual(PreNorm(fn)): fn(norm(x)) + x."""

    def __init__(self, dim: int, fn: nn.Module, *, device=None):
        super().__init__()
        self.fn = _PreNorm(dim, fn, device=device)

    def forward(self, x, dtype=None):
        return self.fn.fn(self.fn.norm(x), dtype) + x


def downsample_s2d(x: torch.Tensor) -> torch.Tensor:
    """Space-to-depth 'b c (h 2) (w 2) -> b (c 4) h w' on NHWC: new channel
    c * 4 + p1 * 2 + p2, channel-major (not pixel_unshuffle's order)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, h // 2, w // 2, c * 4)


def _upsample_nearest2(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def _cat(*xs: torch.Tensor) -> torch.Tensor:
    """Channel concatenation in the promoted dtype, as jnp.concatenate."""
    dt = xs[0].dtype
    for t in xs[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return torch.cat([t.to(dt) for t in xs], dim=-1)


class Unet(nn.Module):
    """Unet(dim=64, dim_mults=(1,2,4,8)) of the reference, NHWC, with the JAX
    Unet's defaults for what the registry leaves unset (init_dim = dim,
    out_dim = channels, GroupNorm of 8 groups).

    Call: model(x, time, x_self_cond) with x (B, H, W, channels); `time` is
    integer timesteps, or the continuous noise level when noise_level_emb.
    Parameters are drawn on the CPU from `generator` (default: a fresh
    `torch.Generator()`) with PyTorch's default init, then moved to
    `device`."""

    def __init__(
        self,
        *,
        dim: int = 64,
        dim_mults: Sequence[int] = (1, 2, 4, 8),
        channels: int = 1,
        self_condition: bool = False,
        learned_sinusoidal_cond: bool = False,
        random_fourier_features: bool = False,
        learned_sinusoidal_dim: int = 16,
        noise_level_emb: bool = False,
        dtype: Optional[torch.dtype] = None,
        device: torch.device | str,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.channels = channels
        self.self_condition = self_condition
        self.noise_level_emb = noise_level_emb
        self.dtype = dtype
        meta = torch.device("meta")  # shapes only; materialised and drawn below
        self.init_conv = nn.Conv2d(channels * (2 if self_condition else 1), dim, 7, padding=3,
                                   device=meta)
        dims = [dim] + [dim * m for m in dim_mults]
        in_out = list(zip(dims[:-1], dims[1:]))
        time_dim = dim * 4
        if noise_level_emb:
            self.noise_level_mlp = NoiseLevelMLP(dim, time_dim, device=meta)
        else:
            learned = learned_sinusoidal_cond or random_fourier_features
            self.time_mlp = TimeMLP(dim, time_dim,
                                    learned_dim=learned_sinusoidal_dim if learned else None,
                                    random=random_fourier_features, device=meta)

        def block(a, b):
            return UnetResnetBlock(a, b, time_dim, device=meta)

        def attn(d):
            return _Residual(d, UnetLinearAttention(d, device=meta), device=meta)

        self.downs = nn.ModuleList()
        for ind, (dim_in, dim_out) in enumerate(in_out):
            last = ind == len(in_out) - 1
            self.downs.append(nn.ModuleList([
                block(dim_in, dim_in), block(dim_in, dim_in), attn(dim_in),
                nn.Conv2d(dim_in, dim_out, 3, padding=1, device=meta) if last else
                nn.Sequential(nn.Identity(), nn.Conv2d(dim_in * 4, dim_out, 1, device=meta)),
            ]))
        mid_dim = dims[-1]
        self.mid_block1 = block(mid_dim, mid_dim)
        self.mid_attn = _Residual(mid_dim, UnetAttention(mid_dim, device=meta), device=meta)
        self.mid_block2 = block(mid_dim, mid_dim)
        self.ups = nn.ModuleList()
        for ind, (dim_in, dim_out) in enumerate(reversed(in_out)):
            last = ind == len(in_out) - 1
            self.ups.append(nn.ModuleList([
                block(dim_out + dim_in, dim_out), block(dim_out + dim_in, dim_out), attn(dim_out),
                nn.Conv2d(dim_out, dim_in, 3, padding=1, device=meta) if last else
                nn.Sequential(nn.Identity(), nn.Conv2d(dim_out, dim_in, 3, padding=1,
                                                       device=meta)),
            ]))
        self.final_res_block = block(dim * 2, dim)
        self.final_conv = nn.Conv2d(dim, channels, 1, device=meta)
        self.to_empty(device="cpu")
        init_torch_default(self, generator if generator is not None else torch.Generator())
        self.to(device)

    def forward(self, x, time, x_self_cond=None):
        if self.self_condition:
            if x_self_cond is None:
                x_self_cond = torch.zeros_like(x)
            x = torch.cat([x_self_cond, x], dim=-1)
        dt = self.dtype
        x = conv_nhwc(x, self.init_conv.weight, self.init_conv.bias, dt)
        r = x
        if self.noise_level_emb:
            t = self.noise_level_mlp(time, dt).to(x.dtype)
        else:
            t = self.time_mlp(time).to(x.dtype)

        h_stack = []
        for block1, block2, attn, down in self.downs:
            x = block1(x, t, dt)
            h_stack.append(x)
            x = attn(block2(x, t, dt), dt)
            h_stack.append(x)
            if isinstance(down, nn.Sequential):
                x = downsample_s2d(x)
                down = down[1]
            x = conv_nhwc(x, down.weight, down.bias, dt)

        x = self.mid_block1(x, t, dt)
        x = self.mid_attn(x, dt)
        x = self.mid_block2(x, t, dt)

        for block1, block2, attn, up in self.ups:
            x = block1(_cat(x, h_stack.pop()), t, dt)
            x = block2(_cat(x, h_stack.pop()), t, dt)
            x = attn(x, dt)
            if isinstance(up, nn.Sequential):
                x = _upsample_nearest2(x)
                up = up[1]
            x = conv_nhwc(x, up.weight, up.bias, dt)

        x = self.final_res_block(_cat(x, r), t, dt)
        return conv_nhwc(x, self.final_conv.weight, self.final_conv.bias, dt).float()
