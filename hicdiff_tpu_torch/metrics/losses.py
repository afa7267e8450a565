"""Composite training losses of the GAN / SR baselines (port of
hicdiff_tpu/metrics/losses.py).

The reference's perceptual term runs torchvision's ImageNet-pretrained VGG19
/ VGG16 feature stacks, whose weights this package does not download: the
perceptual network is `VGGFeatures`, a VGG-shaped feature stack whose
parameters the caller supplies, either saved ones (`load_vgg_params`) or
the documented random stand-in (`init_vgg_params`, flax's LeCun init drawn
from a torch generator). The weightings are the reference's.

Image tensors are NHWC. A `vgg` argument is any callable mapping an NHWC
image batch to its features, e.g. a `VGGFeatures` module; the target's
features are detached, as the JAX package stops their gradient.
`vae_latent_loss` is the latent perceptual loss of a `models/vae.py` VAE.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from hicdiff_tpu_torch.convert import params_from_jax
from hicdiff_tpu_torch.models.common import init_layers
from hicdiff_tpu_torch.train.checkpoint import load_checkpoint

__all__ = [
    "VGGFeatures",
    "deephic_generator_loss",
    "feature_reconstruction_loss",
    "hiedsr_gan_generator_loss",
    "hiedsr_generator_loss",
    "init_vgg_params",
    "load_vgg_params",
    "tv_loss",
    "vae_latent_loss",
]


def tv_loss(x: torch.Tensor, weight: float = 1.0) -> torch.Tensor:
    """Total-variation loss (Hiedsr_loss.py:31-46), NHWC."""
    b, h, w, c = x.shape
    count_h = (h - 1) * w * c
    count_w = h * (w - 1) * c
    h_tv = (x[:, 1:] - x[:, : h - 1]).square().sum()
    w_tv = (x[:, :, 1:] - x[:, :, : w - 1]).square().sum()
    return weight * 2 * (h_tv / count_h + w_tv / count_w) / b


# the VGG feature stacks (conv widths, "M" a 2x2 max-pool), as the JAX
# package's _VGG19_CFG / _VGG16_CFG
VGG_CFGS = {
    "vgg19_35": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
                 512, 512, 512, 512, "M", 512, 512, 512, 512],
    "vgg16_31": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
                 512, 512, 512, "M", 512, 512, 512],
}


class VGGFeatures(nn.Module):
    """The VGG feature stack: 3x3 convs with bias, each followed by a relu,
    and 2x2 max-pools, per `VGG_CFGS[variant]`. A single-channel input is
    repeated to 3 channels, as the reference's `.repeat([1, 3, 1, 1])`.
    Conv layers are named `features.{i}` at torchvision's indices (each
    conv and each relu and pool takes one). NHWC in and out; flax's LeCun
    init drawn from `generator` (default: a fresh one) on the CPU, then
    moved to `device`."""

    def __init__(self, variant: str = "vgg19_35", *, device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if variant not in VGG_CFGS:
            raise ValueError(f"variant must be one of {sorted(VGG_CFGS)}, got {variant!r}")
        self.variant = variant
        layers, cin, i = {}, 3, 0
        for v in VGG_CFGS[variant]:
            if v == "M":
                i += 1
                continue
            layers[str(i)] = nn.Conv2d(cin, v, 3, padding=1, device="meta")
            layers[str(i)].init_kind = "lecun"
            cin, i = v, i + 2
        self.features = nn.ModuleDict(layers)
        self.to_empty(device="cpu")
        init_layers(self, generator if generator is not None else torch.Generator())
        self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-1] == 1:
            x = x.expand(*x.shape[:-1], 3)
        h = x.permute(0, 3, 1, 2)
        convs = iter(self.features.values())
        for v in VGG_CFGS[self.variant]:
            h = F.max_pool2d(h, 2) if v == "M" else F.relu(next(convs)(h))
        return h.permute(0, 2, 3, 1)


def init_vgg_params(generator: torch.Generator, variant: str = "vgg19_35") -> dict:
    """The random perceptual network's state dict, flax's LeCun init drawn
    from `generator`: the stand-in for torchvision's ImageNet weights."""
    return VGGFeatures(variant, device="cpu", generator=generator).state_dict()


def load_vgg_params(path: str) -> dict:
    """Saved VGGFeatures params (a msgpack checkpoint in the JAX package's
    layout) as the port's state dict."""
    return params_from_jax(load_checkpoint(path, only={"params"})["params"],
                           model="VGGFeatures")


def _perception_loss(vgg, out_images, target_images):
    out_feat = vgg(out_images)
    with torch.no_grad():
        target_feat = vgg(target_images)
    b = out_feat.shape[0]
    return (out_feat.reshape(b, -1) - target_feat.reshape(b, -1)).square().mean()


def hiedsr_generator_loss(vgg, out_images, target_images):
    """Hiedsr_loss.GeneratorLoss (no adversarial term): mse + 0.001 *
    perception + 2e-8 * tv. Returns (image, perception, tv, total)."""
    image_loss = (out_images - target_images).square().mean()
    perception = _perception_loss(vgg, out_images, target_images)
    tv = tv_loss(out_images)
    return image_loss, perception, tv, image_loss + 0.001 * perception + 2e-8 * tv


def hiedsr_gan_generator_loss(vgg, out_labels, out_images, target_images,
                              weights: Optional[torch.Tensor] = None):
    """Hiedsrgan_loss.GeneratorLoss: adds 2e-3 * (1 - D(out)).

    weights=None is the reference's arithmetic (plain batch means). With a
    (b,) 0/1 pad mask every term is a per-sample weighted mean, so
    wrap-padded repeat rows carry no gradient (out_labels are then
    per-sample scores, (b,) or reshapeable to (b, -1)). Returns (image,
    perception, tv, total)."""
    if weights is None:
        adversarial = (1.0 - out_labels).mean()
        image_loss = (out_images - target_images).square().mean()
        perception = _perception_loss(vgg, out_images, target_images)
        tv = tv_loss(out_images)
    else:
        b = out_images.shape[0]
        wsum = torch.clamp_min(weights.sum(), 1.0)

        def wmean(per):
            return (per * weights).sum() / wsum

        adversarial = wmean(1.0 - out_labels.reshape(b, -1).mean(dim=-1))
        image_loss = wmean((out_images - target_images).square().mean(dim=(1, 2, 3)))
        out_feat = vgg(out_images).reshape(b, -1)
        with torch.no_grad():
            target_feat = vgg(target_images).reshape(b, -1)
        perception = wmean((out_feat - target_feat).square().mean(dim=-1))
        # per-sample TV with the reference's count/b normalization kept
        _, h, w, c = out_images.shape
        h_tv = (out_images[:, 1:] - out_images[:, :-1]).square().sum(dim=(1, 2, 3)) / (
            (h - 1) * w * c)
        w_tv = (out_images[:, :, 1:] - out_images[:, :, :-1]).square().sum(dim=(1, 2, 3)) / (
            h * (w - 1) * c)
        tv = wmean(2.0 * (h_tv + w_tv))
    total = image_loss + 0.001 * perception + 2e-8 * tv + 2e-3 * adversarial
    return image_loss, perception, tv, total


def deephic_generator_loss(vgg, out_labels, out_images, target_images):
    """deepLoss.GeneratorLoss (VGG16): mse + 0.001 * adv (detached) + 0.006
    * perception + 2e-8 * tv; the scalar total only, as the reference."""
    adversarial = (1.0 - out_labels).mean().detach()
    image_loss = (out_images - target_images).square().mean()
    perception = _perception_loss(vgg, out_images, target_images)
    tv = tv_loss(out_images)
    return image_loss + 0.001 * adversarial + 0.006 * perception + 2e-8 * tv


def vae_latent_loss(
    encode_fn: Callable[[torch.Tensor], Sequence[torch.Tensor]],
    output: torch.Tensor,
    target: torch.Tensor,
) -> torch.Tensor:
    """vae_loss.VaeLoss.forward: the MSE between the VAE-encoder means of
    output and target (`encode_fn` maps a patch batch to (mu, logvar), e.g.
    a trained `models.vae.VAEModel.encode`). The target's encoding is
    detached, so the gradient flows through the output alone."""
    mu_out = encode_fn(output)[0]
    with torch.no_grad():
        mu_target = encode_fn(target)[0]
    return (mu_target - mu_out).square().mean()


def feature_reconstruction_loss(
    encoder_feats_fn: Callable[[torch.Tensor], Sequence[torch.Tensor]],
    prediction: torch.Tensor,
    target: torch.Tensor,
) -> torch.Tensor:
    """fe_rec_loss.FeatureReconstructionLoss: the sum of the MSEs between
    the encoder activations of prediction and target at each depth
    (`encoder_feats_fn` maps an image to its list of activations, e.g. from
    a trained DAE); the target's are detached."""
    with torch.no_grad():
        target_feats = list(encoder_feats_fn(target))
    total = 0.0
    for pf, tf in zip(encoder_feats_fn(prediction), target_feats):
        total = total + (pf - tf).square().mean()
    return total
