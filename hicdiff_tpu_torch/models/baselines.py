"""The baseline (non-diffusion) model zoo (port of hicdiff_tpu/models/baselines.py).

HicPlus (three VALID convs, H-12), DeepHiC (swish and BatchNorm residual
blocks, (tanh+1)/2), HiCSR (BatchNorm residual blocks between VALID convs,
H-12, tanh), DAE (strided conv down, transposed convs up with skip adds),
Unet2D (filters/4, max-pool downs, transposed-conv ups, sigmoid), HiCARN
(the JAX package's HiCARN-1-style cascading generator), and the three
discriminators: DeepHiC's, HiCSR's and hiedsr's. The hiedsr generator is
`models.hicedrn.HicedrnGenerator`.

Inputs and outputs are NHWC, as in the JAX package; inside, each model runs
on the NCHW view of its input (channels_last memory), so its layers are
plain `nn.Conv2d` / `nn.ConvTranspose2d`. A model with BatchNorm takes
`forward(x, train=False)` as the flax model does: train=True normalizes with
the batch's statistics and moves the running ones (`models.common.BatchNorm`).

Parameters are named as the reference's modules name them where the
reference has the model (hicplus.py, deephic.py, hicsr.py, schicedrn_gan.py,
DAE_model.py, Unet_parts1.py, as tests/test_baseline_parity.py maps them);
HiCARN's module is absent from the reference, so its names follow HiCARN-1's
(`entry`, `cb{k}`, `cv{k}`). `convert.params_from_jax(..., model=<class
name>)` carries a flax tree onto them. Each layer is initialised as the JAX
package initialises its counterpart (`models.common.init_layers`): the JAX
`Conv2d` wrapper with PyTorch's default, a bare flax `nn.Conv` /
`nn.ConvTranspose` with LeCun's truncated normal, Unet2D with kaiming.

Transposed convs: flax's `ConvTranspose` runs `lax.conv_transpose` without
mirroring its kernel, while `F.conv_transpose2d` mirrors; so the port's
weight, in PyTorch's (in, out, kh, kw) layout, is the flax kernel flipped in
space (`convert.py`). The padding comes from lax's rule for the dilated
input (`conv_transpose_padding`).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from hicdiff_tpu_torch.models.common import BatchNorm, init_layers
from hicdiff_tpu_torch.models.hicedrn import HicedrnGenerator

__all__ = [
    "DAE",
    "DeepHiC",
    "DeepHiCDiscriminator",
    "HiCARN",
    "HiCSR",
    "HiCSRDiscriminator",
    "HicPlus",
    "HicedrnGenerator",
    "HiedsrDiscriminator",
    "Unet2D",
    "conv_transpose_padding",
]


def conv_transpose_padding(k: int, s: int, padding: Union[str, Sequence[int]]):
    """(padding, output_padding) of `F.conv_transpose2d` for flax's
    ConvTranspose of kernel k, stride s and `padding` ('SAME', 'VALID' or
    explicit (lo, hi)). lax.conv_transpose pads the s-dilated input by (lo,
    hi) (for 'SAME' and 'VALID' by its own rule) and correlates; PyTorch
    pads it by (k-1-p, k-1-p+output_padding)."""
    if isinstance(padding, str):
        if padding == "SAME":
            total = k + s - 2
            lo = k - 1 if s > k - 1 else math.ceil(total / 2)
        elif padding == "VALID":
            total = k + s - 2 + max(k - s, 0)
            lo = k - 1
        else:
            raise ValueError(f"padding must be 'SAME', 'VALID' or (lo, hi), got {padding!r}")
        hi = total - lo
    else:
        lo, hi = padding
    p, op = k - 1 - lo, hi - lo
    if p < 0 or not 0 <= op < s:
        raise ValueError(f"flax padding {(lo, hi)} of a {k}x{k} stride-{s} ConvTranspose has no "
                         "F.conv_transpose2d equivalent")
    return p, op


def _conv(cin, cout, k, *, stride=1, padding=None, bias=True, init="torch"):
    """A conv on the meta device, `init_kind` `init`; padding None is SAME
    for an odd kernel at stride 1 (the JAX `Conv2d` wrapper's default)."""
    layer = nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2 if padding is None else padding,
                      bias=bias, device="meta")
    layer.init_kind = init
    return layer


def _conv_t(cin, cout, k, *, stride=1, padding="SAME", init="lecun"):
    p, op = conv_transpose_padding(k, stride, padding)
    layer = nn.ConvTranspose2d(cin, cout, k, stride=stride, padding=p, output_padding=op,
                               device="meta")
    layer.init_kind = init
    return layer


def _bn(features, init="torch"):
    layer = BatchNorm(features, device="meta")
    layer.init_kind = init
    return layer


class _Baseline(nn.Module):
    """Materialises the layers built on the meta device, draws them from
    `generator` (default: a fresh one) on the CPU, moves them to `device`.
    Subclasses build their layers, then call `_finish`; `forward` permutes
    NHWC to NCHW, runs `_forward`, and permutes back."""

    def _finish(self, device, generator):
        self.to_empty(device="cpu")
        init_layers(self, generator if generator is not None else torch.Generator())
        self.to(device)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self._forward(x.permute(0, 3, 1, 2), train).permute(0, 2, 3, 1).contiguous()


class HicPlus(_Baseline):
    """hicplus.py: conv9(1->8) relu, conv1(8->8) relu, conv5(8->1) relu, all
    VALID, so the output is H-12 x W-12 (the harness pads inputs by 6)."""

    def __init__(self, *, device, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv1 = _conv(1, 8, 9, padding=0)
        self.conv2 = _conv(8, 8, 1, padding=0)
        self.conv3 = _conv(8, 1, 5, padding=0)
        self._finish(device, generator)

    def _forward(self, x, train):
        return F.relu(self.conv3(F.relu(self.conv2(F.relu(self.conv1(x))))))


class _BNResBlock(nn.Module):
    """deephic's residualBlock: conv-bn-swish-conv-bn + x."""

    def __init__(self, channels):
        super().__init__()
        self.conv1, self.bn1 = _conv(channels, channels, 3), _bn(channels)
        self.conv2, self.bn2 = _conv(channels, channels, 3), _bn(channels)

    def forward(self, x, train):
        h = F.silu(self.bn1(self.conv1(x), train))
        return x + self.bn2(self.conv2(h), train)


class DeepHiC(_Baseline):
    """deephic.py Generator: conv9 swish -> `resblock_num` BN residual blocks
    -> conv3-bn swish -> conv9 on (x + emb) -> (tanh + 1) / 2."""

    def __init__(self, *, in_channel: int = 1, resblock_num: int = 5, device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv1 = _conv(in_channel, 64, 9)
        self.resblocks = nn.ModuleList(_BNResBlock(64) for _ in range(resblock_num))
        self.conv2, self.bn2 = _conv(64, 64, 3), _bn(64)
        self.conv3 = _conv(64, in_channel, 9)
        self._finish(device, generator)

    def _forward(self, x, train):
        emb = F.silu(self.conv1(x))
        h = emb
        for block in self.resblocks:
            h = block(h, train)
        h = F.silu(self.bn2(self.conv2(h), train))
        return (torch.tanh(self.conv3(h + emb)) + 1) / 2


class DeepHiCDiscriminator(_Baseline):
    """deephic.py Discriminator: swish convs, three strided, BatchNorm after
    all but the first, a 1x1 conv, sigmoid of the global mean: (B,)."""

    def __init__(self, *, in_channel: int = 1, device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv1 = _conv(in_channel, 64, 3)
        self.conv2, self.bn2 = _conv(64, 64, 3, stride=2, padding=1, init="lecun"), _bn(64)
        self.conv3, self.bn3 = _conv(64, 128, 3), _bn(128)
        self.conv4, self.bn4 = _conv(128, 128, 3, stride=2, padding=1, init="lecun"), _bn(128)
        self.conv5, self.bn5 = _conv(128, 256, 3), _bn(256)
        self.conv6, self.bn6 = _conv(256, 256, 3, stride=2, padding=1, init="lecun"), _bn(256)
        self.conv7 = _conv(256, 1, 1)
        self._finish(device, generator)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = F.silu(self.conv1(x.permute(0, 3, 1, 2)))
        for i in range(2, 7):
            x = F.silu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x), train))
        return torch.sigmoid(self.conv7(x).mean(dim=(1, 2, 3)))


class HiCSR(_Baseline):
    """hicsr.py Generator: a VALID pre-block conv (H-2) relu, `num_res_blocks`
    SAME BN residual blocks, post conv + BN + the pre-block output, then four
    VALID convs and a VALID conv to one channel (H-10 more), tanh. Net
    output H-12 (the harness pads by 6)."""

    def __init__(self, *, num_res_blocks: int = 15, device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.pre_res_block = nn.Sequential(_conv(1, 64, 3, padding=0))
        blocks = []
        for _ in range(num_res_blocks):
            block = nn.Module()
            block.conv1, block.bn1 = _conv(64, 64, 3), _bn(64)
            block.conv2, block.bn2 = _conv(64, 64, 3), _bn(64)
            blocks.append(block)
        self.res_blocks = nn.ModuleList(blocks)
        self.post_res_block = nn.Sequential(_conv(64, 64, 3), _bn(64))
        widths = (64, 128, 128, 256, 256, 1)
        self.final_block = nn.Sequential(*(_conv(a, b, 3, padding=0)
                                           for a, b in zip(widths, widths[1:])))
        self._finish(device, generator)

    def _forward(self, x, train):
        first = F.relu(self.pre_res_block[0](x))
        h = first
        for b in self.res_blocks:
            hh = F.relu(b.bn1(b.conv1(h), train))
            h = h + b.bn2(b.conv2(hh), train)
        h = first + self.post_res_block[1](self.post_res_block[0](h), train)
        return torch.tanh(self.final_block(h))


class HiCSRDiscriminator(_Baseline):
    """hicsr.py Discriminator: 4x4 stride-2 convs without bias, LeakyReLU
    0.2, BatchNorm after all but the first; a 1x1 conv to patch logits."""

    def __init__(self, *, device, generator: Optional[torch.Generator] = None):
        super().__init__()
        lecun = dict(padding=1, bias=False, init="lecun")
        self.conv = nn.ModuleDict({
            "0": _conv(1, 64, 4, stride=2, **lecun),
            "2": _conv(64, 128, 4, stride=2, **lecun), "3": _bn(128),
            "5": _conv(128, 256, 4, stride=2, **lecun), "6": _bn(256),
            "8": _conv(256, 512, 3, **lecun), "9": _bn(512),
            "11": _conv(512, 1, 1, padding=0, bias=False, init="lecun"),
        })
        self._finish(device, generator)

    def _forward(self, x, train):
        c = self.conv
        x = F.leaky_relu(c["0"](x), 0.2)
        for conv, bn in (("2", "3"), ("5", "6"), ("8", "9")):
            x = F.leaky_relu(c[bn](c[conv](x), train), 0.2)
        return c["11"](x)


class HiedsrDiscriminator(_Baseline):
    """schicedrn_gan.py Discriminator: a conv with LeakyReLU 0.01, seven
    conv (no bias) - BatchNorm - LeakyReLU 0.2 stages, three of them
    strided, a conv to one channel, sigmoid: a patch map of probabilities."""

    STAGES = ((64, 64, 4, 2), (64, 128, 3, 1), (128, 128, 4, 2), (128, 256, 3, 1),
              (256, 256, 4, 2), (256, 512, 3, 1), (512, 512, 3, 1))

    def __init__(self, *, device, generator: Optional[torch.Generator] = None):
        super().__init__()
        body = {"0": _conv(1, 64, 3)}
        for i, (cin, cout, k, s) in enumerate(self.STAGES):
            body[str(2 + i)] = nn.ModuleDict({
                "0": _conv(cin, cout, k, stride=s, padding=1, bias=False, init="lecun"),
                "1": _bn(cout)})
        body["9"] = _conv(512, 1, 3)
        self.body = nn.ModuleDict(body)
        self._finish(device, generator)

    def _forward(self, x, train):
        x = F.leaky_relu(self.body["0"](x), 0.01)
        for i in range(len(self.STAGES)):
            stage = self.body[str(2 + i)]
            x = F.leaky_relu(stage["1"](stage["0"](x), train), 0.2)
        return torch.sigmoid(self.body["9"](x))


class DAE(_Baseline):
    """DAE_model.py: `num_layers` convs down (the first at stride 2), as
    many transposed convs up (the last at stride 2) with a skip add after
    every other one, + the input, tanh."""

    def __init__(self, *, num_layers: int = 5, num_features: int = 64, channels: int = 1,
                 device, generator: Optional[torch.Generator] = None):
        super().__init__()
        f, n = num_features, num_layers
        # torch Conv2d(k3, s2, p1) pads (1, 1), as the JAX model does explicitly
        self.conv_layers = nn.ModuleList(
            [nn.Sequential(_conv(channels, f, 3, stride=2, padding=1, init="lecun"))]
            + [nn.Sequential(_conv(f, f, 3)) for _ in range(n - 1)])
        # the last pads the dilated input by (1, 2), as the JAX model does
        self.deconv_layers = nn.ModuleList(
            [nn.Sequential(_conv_t(f, f, 3)) for _ in range(n - 1)]
            + [_conv_t(f, channels, 3, stride=2, padding=(1, 2))])
        self.num_layers = n
        self._finish(device, generator)

    def _forward(self, x, train):
        n = self.num_layers
        conv_feats = []
        h = x
        for i, layer in enumerate(self.conv_layers):
            h = F.relu(layer[0](h))
            if (i + 1) % 2 == 0 and len(conv_feats) < math.ceil(n / 2) - 1:
                conv_feats.append(h)
        idx = 0
        for i in range(n):
            if i < n - 1:
                h = F.relu(self.deconv_layers[i][0](h))
            else:
                h = self.deconv_layers[i](h)
            if (i + 1 + n) % 2 == 0 and idx < len(conv_feats):
                h = F.relu(h + conv_feats[-(idx + 1)])
                idx += 1
        return torch.tanh(h + x)


class _DoubleConv(nn.Module):
    """unetConv2: (conv3 no bias, BatchNorm, relu) x 2, kaiming, BatchNorm
    scales from N(1, 0.02); laid out as its `double_conv` Sequential."""

    def __init__(self, cin, cout, mid=None):
        super().__init__()
        mid = mid or cout
        self.double_conv = nn.ModuleDict({
            "0": _conv(cin, mid, 3, padding=1, bias=False, init="kaiming"),
            "1": _bn(mid, init="normal"),
            "3": _conv(mid, cout, 3, padding=1, bias=False, init="kaiming"),
            "4": _bn(cout, init="normal"),
        })

    def forward(self, x, train):
        d = self.double_conv
        x = F.relu(d["1"](d["0"](x), train))
        return F.relu(d["4"](d["3"](x), train))


class Unet2D(_Baseline):
    """unet_2D (Unet_parts1.py): filters [16, 32, 64, 128, 256] at
    feature_scale 4, max-pool downs, 4x4 stride-2 transposed-conv ups
    concatenated (up, skip), sigmoid out."""

    def __init__(self, *, feature_scale: int = 4, n_classes: int = 1, channels: int = 1,
                 device, generator: Optional[torch.Generator] = None):
        super().__init__()
        f = [w // feature_scale for w in (64, 128, 256, 512, 1024)]
        self.conv1 = _DoubleConv(channels, f[0])
        self.conv2 = _DoubleConv(f[0], f[1])
        self.conv3 = _DoubleConv(f[1], f[2])
        self.conv4 = _DoubleConv(f[2], f[3])
        self.center = _DoubleConv(f[3], f[4])
        for level in (4, 3, 2, 1):
            up = nn.Module()
            up.up = _conv_t(f[level], f[level - 1], 4, stride=2, init="kaiming")
            up.conv = _DoubleConv(2 * f[level - 1], f[level - 1])
            setattr(self, f"up_concat{level}", up)
        self.final = _conv(f[0], n_classes, 1, init="kaiming")
        self._finish(device, generator)

    def _forward(self, x, train):
        c1 = self.conv1(x, train)
        c2 = self.conv2(F.max_pool2d(c1, 2), train)
        c3 = self.conv3(F.max_pool2d(c2, 2), train)
        c4 = self.conv4(F.max_pool2d(c3, 2), train)
        h = self.center(F.max_pool2d(c4, 2), train)
        for level, skip in ((4, c4), (3, c3), (2, c2), (1, c1)):
            up = getattr(self, f"up_concat{level}")
            h = up.conv(torch.cat([up.up(h), skip], dim=1), train)
        return torch.sigmoid(self.final(h))


class _ResBlock(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv1, self.conv2 = _conv(c, c, 3), _conv(c, c, 3)

    def forward(self, h):
        return F.relu(self.conv2(F.relu(self.conv1(h))) + h)


class _CascadingBlock(nn.Module):
    """Two residual sub-blocks, each followed by a 1x1 fusion of everything
    before it."""

    def __init__(self, c):
        super().__init__()
        self.r1, self.c1 = _ResBlock(c), _conv(2 * c, c, 1)
        self.r2, self.c2 = _ResBlock(c), _conv(3 * c, c, 1)

    def forward(self, h):
        b1 = self.r1(h)
        o1 = F.relu(self.c1(torch.cat([h, b1], dim=1)))
        b2 = self.r2(o1)
        return F.relu(self.c2(torch.cat([h, b1, b2], dim=1)))


class HiCARN(_Baseline):
    """The JAX package's HiCARN-1-style cascading residual generator (the
    reference's module is missing): entry conv, 5 cascading blocks, each
    followed by a 1x1 fusion of every earlier output, exit convs on (h +
    entry)."""

    def __init__(self, *, num_channels: int = 64, device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        c = num_channels
        self.entry = _conv(1, c, 3)
        for k in range(1, 6):
            setattr(self, f"cb{k}", _CascadingBlock(c))
            setattr(self, f"cv{k}", _conv((k + 1) * c, c, 1))
        self.cv6, self.cv7 = _conv(c, c, 3), _conv(c, 1, 3)
        self._finish(device, generator)

    def _forward(self, x, train):
        h = self.entry(x)
        entry = h
        blocks = [h]
        for k in range(1, 6):
            blocks.append(getattr(self, f"cb{k}")(h))
            h = F.relu(getattr(self, f"cv{k}")(torch.cat(blocks, dim=1)))
        return self.cv7(self.cv6(h + entry))
