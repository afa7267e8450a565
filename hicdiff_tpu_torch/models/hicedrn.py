"""The HicedrnDiff backbone family (port of hicdiff_tpu/models/hicedrn.py).

    head 3x3 conv (in_ch -> F; in_ch doubles when self-conditioned)
    time path: base / att: sinusoidal(F) -> Linear(F, 4F) -> GELU ->
      Linear(4F, 4F), fp32; sr3: SR3PositionalEncoding(F) of the continuous
      noise level -> Linear -> GELU -> Linear, in the compute dtype
    N residual blocks, each ONE shared 3x3 conv applied twice, SiLU between,
      x0.1 residual: base / att scale-shift by Dense(silu(t_emb)) after the
      first application; sr3 (`SR3ResBlock`) adds Dense(t_emb) there
    att: a `HicedrnLinearAttention` after every 2nd block
    body_tail conv + global residual, tail conv to `channels`

Inputs and outputs are NHWC, as in the JAX package. Parameters are float32
and named in the reference's state-dict layout: `head.*`, `time_mlp.1.*` /
`time_mlp.3.*`, `body.{i}.mlp.1.*` and `body.{i}.conv.proj.*`, `body_tail.*`,
`tail.*` (hicedrn_Diff.py, as tools/export_torch_checkpoint.py maps it), so
reference `hicedrn_Diff` state dicts load with `load_state_dict`. The sr3
variant names its time path `noise_level_mlp.{1,3}.*` and its blocks'
Dense `body.{i}.noise_func.noise_func.0.*`, after the SR3 code's modules
that hicedrn_sr3_Diff.py builds from (`noise_level_mlp`,
`FeatureWiseAffine.noise_func`); the att variant's attention layers are
`attn.{j}.{norm.g, to_qkv.weight, to_out.0.*, to_out.1.g}`, the
LinearAttention of hicedrn_Diff.py with its pre-norm. The reference tree is
not in the repository, so the sr3 and att names are not checked against a
reference state dict.

`dtype` is the compute dtype (None: the input's); the output is fp32, as
in `HicedrnDiff(dtype=...)`. In bf16 the att variant's residual stream is
fp32 after its first attention (the post-norm's fp32 scale promotes it, and
every later block adds its bf16 branch to it), as in the JAX package: those
blocks read the stream cast to bf16 and add their bf16-rounded branch to it
in fp32 (`fused_resblock_reference`'s `residual`; on the card the bf16
kernel's fp32-stream modes 6 and 7).

Every residual block goes through the hand-written CUDA kernel for CUDA
tensors and its plain version for CPU ones: `fused_resblock_prepared` when no
gradient is wanted (under `torch.no_grad`, the sampling and serving paths),
else `FusedResblockFn`, whose backward reaches the block's conv and Dense
parameters, fp32 or bf16 (fp32 parameters, gradients and optimizer state in
both). The sr3 block is the same kernel with scale = 0 and
shift = Dense(t_emb): conv * (0 + 1) is exact.
The head, body_tail and tail convs, the attention and the small GEMMs are
`F.conv2d` / `F.linear` / `torch.matmul`, as the JAX package leaves them to
XLA. A conv's or a Dense's bias is added after the product, in the compute
dtype, as flax adds it (`conv_nhwc`, `dense`): in bf16 the product rounds
first, on either device.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from hicdiff_tpu_torch.kernels.resblock import (
    FusedResblockFn,
    fused_resblock_prepared,
    prepare_weight,
    transpose_kernel,
)
from hicdiff_tpu_torch.models.common import (
    ChannelLayerNorm,
    NoiseLevelMLP,
    ParamCache,
    TimeMLP,
    conv_nhwc,
    dense,
    init_torch_default,
)

__all__ = ["HicedrnDiff", "HicedrnGenerator", "HicedrnLinearAttention", "HicedrnResBlock",
           "SR3ResBlock", "linear_attention"]

N_FEAT = 256


class _SharedConvBlock(nn.Module, ParamCache):
    """A residual block of one shared 3x3 conv applied twice; subclasses
    name its Dense (`_dense`) and say how it makes (scale, shift)."""

    def __init__(self, features: int, device=None):
        super().__init__()
        self.conv = nn.ModuleDict(
            {"proj": nn.Conv2d(features, features, 3, padding=1, device=device)}
        )

    def _dense(self) -> nn.Linear:
        raise NotImplementedError

    def _compute_weights(self, dtype):
        """(Dense weight, Dense bias, conv weight, conv bias) in `dtype`, the
        conv weight as the CUDA kernel of that dtype reads it (`prepare_weight`
        of the HWIO kernel). Made once per weight update and dtype rather than
        on every call."""
        lin, conv = self._dense(), self.conv["proj"]
        params = (lin.weight, lin.bias, conv.weight, conv.bias)
        return self._cached(dtype, params, lambda lin_w, lin_b, conv_w, conv_b: (
            lin_w.to(dtype), lin_b.to(dtype),
            prepare_weight(conv_w.permute(2, 3, 1, 0).to(dtype)),
            conv_b.to(dtype).contiguous(),
        ))

    def _train_packs(self, dtype):
        """(forward pack, transposed pack) of the conv weight in `dtype`, which
        `FusedResblockFn` reads on CUDA: the first is `_compute_weights`'
        pack, the second is cached beside it; each made once per weight
        update and dtype."""
        transposed = self._cached(("transposed", dtype), (self.conv["proj"].weight,),
                                  lambda conv_w: prepare_weight(
                                      transpose_kernel(conv_w.permute(2, 3, 1, 0).to(dtype))))
        return self._compute_weights(dtype)[2], transposed

    def _scale_shift(self, t_in, lin_w, lin_b):
        raise NotImplementedError

    def forward(self, x: torch.Tensor, t_in: torch.Tensor) -> torch.Tensor:
        """x (B,H,W,C); t_in (B, 4C) in the compute dtype: silu(t_emb) for
        the base block, t_emb for the sr3 block. x in another dtype than
        t_in is the att variant's fp32 stream under bf16 compute."""
        lin, conv = self._dense(), self.conv["proj"]
        cdt = t_in.dtype
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (x, t_in, lin.weight, lin.bias, conv.weight, conv.bias)):
            scale, shift = self._scale_shift(t_in, lin.weight.to(cdt), lin.bias.to(cdt))
            packs = self._train_packs(cdt) if x.is_cuda else None
            return FusedResblockFn.apply(x, conv.weight, conv.bias, scale, shift, packs)
        lin_w, lin_b, weight, bias = self._compute_weights(cdt)
        scale, shift = self._scale_shift(t_in, lin_w, lin_b)
        if x.dtype != cdt:  # the att variant's fp32 stream under bf16 compute
            return fused_resblock_prepared(x.to(cdt), weight, bias, scale, shift, residual=x)
        return fused_resblock_prepared(x, weight, bias, scale, shift)


class HicedrnResBlock(_SharedConvBlock):
    """Time-conditioned residual block with a single conv applied twice:
    scale, shift = split(Dense(silu(t_emb)))."""

    def __init__(self, features: int = N_FEAT, *, device=None):
        super().__init__(features, device)
        self.mlp = nn.Sequential(nn.SiLU(), nn.Linear(features * 4, features * 2, device=device))

    def _dense(self):
        return self.mlp[1]

    def _scale_shift(self, t_act, lin_w, lin_b):
        return dense(t_act, lin_w, lin_b).chunk(2, dim=-1)


class SR3ResBlock(_SharedConvBlock):
    """SR3 residual block: conv -> + Dense(t_emb) -> SiLU -> conv -> x0.1 +
    x (FeatureWiseAffine without the affine level), run as the fused block
    with scale = 0."""

    def __init__(self, features: int = N_FEAT, *, device=None):
        super().__init__(features, device)
        self.noise_func = nn.Module()
        self.noise_func.noise_func = nn.Sequential(
            nn.Linear(features * 4, features, device=device))

    def _dense(self):
        return self.noise_func.noise_func[0]

    def _scale_shift(self, t_emb, lin_w, lin_b):
        shift = dense(t_emb, lin_w, lin_b)
        return torch.zeros_like(shift), shift


def linear_attention(qkv: torch.Tensor, heads: int, dim_head: int, dtype: torch.dtype):
    """The softmax-kernel linear attention of (B, H, W, 3 * heads * dim_head)
    packed (3, heads, dim_head) channels: q softmax over d (then scaled), k
    softmax over tokens, v / (h w); both contractions accumulated in fp32.
    Returns (B, H, W, heads * dim_head) in `dtype`."""
    b, h, w, _ = qkv.shape
    qkv = qkv.reshape(b, h * w, 3, heads, dim_head)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # (b, heads, n, d)
    q = q.softmax(dim=-1) * dim_head**-0.5
    k = k.softmax(dim=-2)
    v = v / (h * w)
    context = torch.matmul(k.float().transpose(-1, -2), v.float())  # (b, heads, d, e)
    out = torch.matmul(q.float(), context)  # (b, heads, n, e)
    return out.transpose(1, 2).reshape(b, h, w, heads * dim_head).to(dtype)


class HicedrnLinearAttention(nn.Module):
    """Pre-norm linear attention with post-norm and residual, heads 4 x 32:
    x + norm2(to_out(attn(to_qkv(norm(x)))))."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32, *, device=None):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        hidden = heads * dim_head
        self.norm = ChannelLayerNorm(dim, device=device)
        self.to_qkv = nn.Conv2d(dim, hidden * 3, 1, bias=False, device=device)
        self.to_out = nn.Sequential(nn.Conv2d(hidden, dim, 1, device=device),
                                    ChannelLayerNorm(dim, device=device))

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        qkv = conv_nhwc(self.norm(x), self.to_qkv.weight, None, dtype)
        out = linear_attention(qkv, self.heads, self.dim_head, x.dtype)
        out = conv_nhwc(out, self.to_out[0].weight, self.to_out[0].bias, dtype)
        return self.to_out[1](out) + x


class HicedrnDiff(nn.Module):
    """The hicedrn_Diff backbone, variants 'base', 'att' and 'sr3'.

    Call: model(x, time, x_self_cond) with x (B, H, W, channels) NHWC;
    `time` is integer timesteps (B,) for base / att, the continuous noise
    level (sqrt alpha-bar) for sr3. Parameters are drawn on the CPU from
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
        if variant not in ("base", "att", "sr3"):
            raise ValueError(f"variant must be 'base', 'att' or 'sr3', got {variant!r}")
        self.channels = channels
        self.self_condition = self_condition
        self.variant = variant
        self.dtype = dtype
        in_ch = channels * (2 if self_condition else 1)
        meta = torch.device("meta")  # shapes only; materialised and drawn below
        self.head = nn.Conv2d(in_ch, features, 3, padding=1, device=meta)
        if variant == "sr3":
            self.noise_level_mlp = NoiseLevelMLP(features, features * 4, device=meta)
            block = SR3ResBlock
        else:
            self.time_mlp = TimeMLP(features, features * 4, device=meta)
            block = HicedrnResBlock
        self.body = nn.ModuleList(block(features, device=meta) for _ in range(number_resnet))
        if variant == "att":
            self.attn = nn.ModuleList(
                HicedrnLinearAttention(features, device=meta) for _ in range(number_resnet // 2))
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
        h = conv_nhwc(x, self.head.weight, self.head.bias, cdt)
        r = h
        if self.variant == "sr3":
            t_in = self.noise_level_mlp(time, cdt)
        else:
            t_in = F.silu(self.time_mlp(time).to(cdt))
        for i, block in enumerate(self.body):
            h = block(h, t_in)
            if self.variant == "att" and i % 2 == 1:
                h = self.attn[i // 2](h, cdt)
        h = conv_nhwc(h, self.body_tail.weight, self.body_tail.bias, cdt) + r
        return conv_nhwc(h, self.tail.weight, self.tail.bias, cdt).float()


class _GeneratorBlock(nn.Module):
    """relu(conv(x)) -> conv (the same conv) -> x0.1 + x."""

    def __init__(self, features: int, device=None):
        super().__init__()
        self.res_conv = nn.Conv2d(features, features, 3, padding=1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.res_conv(F.relu(self.res_conv(x))) * 0.1 + x


class HicedrnGenerator(nn.Module):
    """The plain (non-diffusion) hicedrn Generator, the 'hiedsr' baseline
    (port of `HicedrnGenerator`, hicdiff_tpu/models/hicedrn.py:195): head
    conv -> `number_blocks` x (conv - relu - the same conv, x0.1 + x) ->
    body tail conv -> global residual -> tail conv. No timestep and no
    scale/shift, and a relu between the convs, so the blocks are plain
    `F.conv2d` (the JAX package's are plain `nn.Conv` too).

    NHWC in and out, fp32. Parameters are named as the reference's
    schicedrn_gan.py Generator names them: `head`, `body.{i}.res_conv`,
    `body.{number_blocks}` (the body tail), `tail`; PyTorch's default init
    drawn on the CPU from `generator`, then moved to `device`."""

    def __init__(self, *, channels: int = 1, number_blocks: int = 32, device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        meta = torch.device("meta")
        self.head = nn.Conv2d(channels, N_FEAT, 3, padding=1, device=meta)
        self.body = nn.ModuleList([_GeneratorBlock(N_FEAT, meta) for _ in range(number_blocks)]
                                  + [nn.Conv2d(N_FEAT, N_FEAT, 3, padding=1, device=meta)])
        self.tail = nn.Conv2d(N_FEAT, channels, 3, padding=1, device=meta)
        self.to_empty(device="cpu")
        init_torch_default(self, generator if generator is not None else torch.Generator())
        self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.head(x.permute(0, 3, 1, 2))
        r = h
        for block in self.body:
            h = block(h)
        return self.tail(h + r).permute(0, 2, 3, 1).contiguous()
