"""1-D attention U-Net, the backbone of the 1-D engine (port of
hicdiff_tpu/models/unet1d.py).

The lucidrains `Unet1D` of hicdiff_1d.py over (B, L, C) sequences: a 7-wide
init conv, per level [ResnetBlock x2, Residual(PreNorm(LinearAttention)),
down], a full-attention mid block, symmetric ups with skip concatenation, a
final res block and a 1-wide conv. Its blocks: weight-standardized Conv1d
-> GroupNorm -> scale-shift -> SiLU. Down is a strided Conv1d(k=4, s=2,
p=1) (a width-3 conv at the last level), up is nearest x2 + width-3 conv.
The 1-D linear attention scales q only (no division of v by the token
count) and post-norms its projection; the mid block's full attention has no
post-norm.

Tensors are (B, L, C) outside, as the JAX model's; the convs run on the
(B, C, L) view. Parameters are float32, named in the reference's layout:
`init_conv`, `time_mlp.{1,3}`, `downs.{i}.{0,1}` (ResnetBlocks: `mlp.1`,
`block{1,2}.proj`, `block{1,2}.norm`, `res_conv`),
`downs.{i}.2.fn.{norm.g, fn.to_qkv, fn.to_out.0, fn.to_out.1.g}`,
`downs.{i}.3`, `mid_block1`, `mid_attn.fn.{norm.g, fn.to_qkv, fn.to_out}`,
`mid_block2`, `ups.{i}.*` likewise (`ups.{i}.3.1` the up conv, `ups.{i}.3`
at the last level), `final_res_block`, `final_conv`; channel LayerNorm
scales (1, C, 1). Plain PyTorch: the JAX model reaches no Pallas kernel.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from hicdiff_tpu_torch.models.common import ChannelLayerNorm, TimeMLP, init_torch_default

__all__ = ["Unet1D"]


def _conv(x: torch.Tensor, conv: nn.Conv1d, weight: Optional[torch.Tensor] = None):
    """`conv` on a (B, L, C) tensor; `weight` replaces its own."""
    y = F.conv1d(x.transpose(1, 2), conv.weight if weight is None else weight, conv.bias,
                 stride=conv.stride, padding=conv.padding)
    return y.transpose(1, 2)


class LayerNorm1d(ChannelLayerNorm):
    """The channel LayerNorm with the 1-D reference's scale shape (1, C, 1)."""

    def __init__(self, dim: int, *, device=None):
        super().__init__(dim, device=device)
        self.g = nn.Parameter(torch.ones(1, dim, 1, device=device))


class WSConv1d(nn.Conv1d):
    """Weight-standardized Conv1d: each output channel's kernel to zero mean
    and unit (biased) variance over (in, k), eps 1e-5."""

    def forward(self, x):
        w = self.weight
        mean = w.mean(dim=(1, 2), keepdim=True)
        var = w.var(dim=(1, 2), keepdim=True, unbiased=False)
        return _conv(x, self, (w - mean) * torch.rsqrt(var + 1e-5))


class Block1d(nn.Module):
    def __init__(self, dim: int, dim_out: int, groups: int = 8, *, device=None):
        super().__init__()
        self.proj = WSConv1d(dim, dim_out, 3, padding=1, device=device)
        self.norm = nn.GroupNorm(groups, dim_out, eps=1e-5, device=device)

    def forward(self, x, scale_shift=None):
        x = self.proj(x)
        x = self.norm(x.transpose(1, 2)).transpose(1, 2)
        if scale_shift is not None:
            scale, shift = scale_shift
            x = x * (scale + 1) + shift
        return F.silu(x)


class ResnetBlock1d(nn.Module):
    """block1 (scale-shift from Linear(silu(t))) -> block2 -> + res_conv(x);
    res_conv is a 1-wide conv only when the widths differ."""

    def __init__(self, dim: int, dim_out: int, time_emb_dim: int, groups: int = 8, *,
                 device=None):
        super().__init__()
        self.mlp = nn.Sequential(nn.SiLU(), nn.Linear(time_emb_dim, dim_out * 2, device=device))
        self.block1 = Block1d(dim, dim_out, groups, device=device)
        self.block2 = Block1d(dim_out, dim_out, groups, device=device)
        self.res_conv = (nn.Conv1d(dim, dim_out, 1, device=device) if dim != dim_out
                         else nn.Identity())

    def forward(self, x, t_emb):
        te = self.mlp(t_emb)[:, None, :]
        h = self.block1(x, te.chunk(2, dim=-1))
        h = self.block2(h)
        if isinstance(self.res_conv, nn.Conv1d):
            x = _conv(x, self.res_conv)
        return h + x


class Attention1d(nn.Module):
    """Linear attention (q softmax over d then scaled, k softmax over
    tokens, post LayerNorm) or full softmax attention, heads 4 x 32."""

    def __init__(self, dim: int, linear: bool, heads: int = 4, dim_head: int = 32, *,
                 device=None):
        super().__init__()
        self.heads, self.dim_head, self.linear = heads, dim_head, linear
        hidden = heads * dim_head
        self.to_qkv = nn.Conv1d(dim, hidden * 3, 1, bias=False, device=device)
        out = nn.Conv1d(hidden, dim, 1, device=device)
        self.to_out = nn.Sequential(out, LayerNorm1d(dim, device=device)) if linear else out

    def forward(self, x):
        b, n, _ = x.shape
        heads, d = self.heads, self.dim_head
        qkv = _conv(x, self.to_qkv).reshape(b, n, 3, heads, d)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # (b, heads, n, d)
        scale = d**-0.5
        if self.linear:
            q = q.softmax(dim=-1) * scale
            k = k.softmax(dim=-2)
            out = torch.matmul(q, torch.matmul(k.transpose(-1, -2), v))
        else:
            attn = torch.matmul(q * scale, k.transpose(-1, -2)).softmax(dim=-1)
            out = torch.matmul(attn, v)
        out = out.transpose(1, 2).reshape(b, n, heads * d)
        if self.linear:
            return self.to_out[1](_conv(out, self.to_out[0]))
        return _conv(out, self.to_out)


class _PreNorm(nn.Module):
    def __init__(self, dim: int, fn: nn.Module, *, device=None):
        super().__init__()
        self.fn = fn
        self.norm = LayerNorm1d(dim, device=device)


class _Residual(nn.Module):
    """Residual(PreNorm(fn)): fn(norm(x)) + x."""

    def __init__(self, dim: int, fn: nn.Module, *, device=None):
        super().__init__()
        self.fn = _PreNorm(dim, fn, device=device)

    def forward(self, x):
        return self.fn.fn(self.fn.norm(x)) + x


class Unet1D(nn.Module):
    """Unet1D(dim, dim_mults, channels) over (B, L, C) sequences; L must be
    divisible by 2 ** (len(dim_mults) - 1).

    Call: model(x, time, x_self_cond) with integer timesteps `time` (B,).
    Parameters are drawn on the CPU from `generator` (default: a fresh
    `torch.Generator()`) with PyTorch's default init, then moved to
    `device`."""

    def __init__(self, *, dim: int = 64, init_dim: Optional[int] = None,
                 out_dim: Optional[int] = None, dim_mults: Sequence[int] = (1, 2, 4, 8),
                 channels: int = 1, self_condition: bool = False, resnet_block_groups: int = 8,
                 learned_variance: bool = False, device: torch.device | str,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.channels = channels
        self.self_condition = self_condition
        meta = torch.device("meta")  # shapes only; materialised and drawn below
        init_dim = init_dim or dim
        self.init_conv = nn.Conv1d(channels * (2 if self_condition else 1), init_dim, 7,
                                   padding=3, device=meta)
        dims = [init_dim] + [dim * m for m in dim_mults]
        in_out = list(zip(dims[:-1], dims[1:]))
        time_dim = dim * 4
        self.time_mlp = TimeMLP(dim, time_dim, device=meta)
        g = resnet_block_groups

        def block(a, b):
            return ResnetBlock1d(a, b, time_dim, g, device=meta)

        def attn(d, linear=True):
            return _Residual(d, Attention1d(d, linear, device=meta), device=meta)

        self.downs = nn.ModuleList()
        for ind, (din, dout) in enumerate(in_out):
            last = ind == len(in_out) - 1
            self.downs.append(nn.ModuleList([
                block(din, din), block(din, din), attn(din),
                nn.Conv1d(din, dout, 3, padding=1, device=meta) if last
                else nn.Conv1d(din, dout, 4, stride=2, padding=1, device=meta),
            ]))
        mid = dims[-1]
        self.mid_block1 = block(mid, mid)
        self.mid_attn = attn(mid, linear=False)
        self.mid_block2 = block(mid, mid)
        self.ups = nn.ModuleList()
        for ind, (din, dout) in enumerate(reversed(in_out)):
            last = ind == len(in_out) - 1
            self.ups.append(nn.ModuleList([
                block(dout + din, dout), block(dout + din, dout), attn(dout),
                nn.Conv1d(dout, din, 3, padding=1, device=meta) if last else
                nn.Sequential(nn.Identity(), nn.Conv1d(dout, din, 3, padding=1, device=meta)),
            ]))
        self.final_res_block = block(init_dim * 2, dim)
        self.out_dim = out_dim or channels * (2 if learned_variance else 1)
        self.final_conv = nn.Conv1d(dim, self.out_dim, 1, device=meta)
        self.to_empty(device="cpu")
        init_torch_default(self, generator if generator is not None else torch.Generator())
        self.to(device)

    def forward(self, x, time, x_self_cond=None):
        if self.self_condition:
            if x_self_cond is None:
                x_self_cond = torch.zeros_like(x)
            x = torch.cat([x_self_cond, x], dim=-1)
        x = _conv(x, self.init_conv)
        r = x
        t = self.time_mlp(time)

        hs = []
        for block1, block2, attn, down in self.downs:
            x = block1(x, t)
            hs.append(x)
            x = attn(block2(x, t))
            hs.append(x)
            x = _conv(x, down)

        x = self.mid_block1(x, t)
        x = self.mid_attn(x)
        x = self.mid_block2(x, t)

        for block1, block2, attn, up in self.ups:
            x = block1(torch.cat([x, hs.pop()], dim=-1), t)
            x = block2(torch.cat([x, hs.pop()], dim=-1), t)
            x = attn(x)
            if isinstance(up, nn.Sequential):
                x = x.repeat_interleave(2, dim=1)
                up = up[1]
            x = _conv(x, up)

        x = self.final_res_block(torch.cat([x, r], dim=-1), t)
        return _conv(x, self.final_conv)
