"""Convolutional VAE for Hi-C patches (port of hicdiff_tpu/models/vae.py).

The module behind the latent perceptual loss (`metrics.losses.
vae_latent_loss`), with the reference yaml's hyperparameter surface
(latent_dim, pre_latent, condensed_latent, gamma, kld_weight). The encoder
is four stride-2 3x3 convs (64x64 -> 4x4, widths 32, 64, 64,
condensed_latent) feeding a pre-latent Linear and the mu / logvar heads;
the decoder mirrors it with stride-2 3x3 transposed convs and a tanh.

Tensors are NHWC, as the JAX model's. Its layers are flax's bare `nn.Conv`,
`nn.ConvTranspose` and `nn.Dense` with SAME padding: a stride-2 conv of an
even input pads (0, 1); a stride-2 transposed conv pads the dilated input
(2, 1), which is PyTorch's unpadded transposed conv (2, 2) less its last
row and column, the kernel mirrored in space (`convert.py`'s `convt`).
Parameters are drawn as flax draws them (LeCun normal, zero bias) from an
explicit generator. The reparameterisation's eps comes from the caller or
from an explicit `torch.Generator`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from hicdiff_tpu_torch.models.common import init_layers

__all__ = ["VAEModel"]


def _lecun(layer: nn.Module) -> nn.Module:
    layer.init_kind = "lecun"
    return layer


class VAEModel(nn.Module):
    """VAE over (B, 64, 64, channels) patches in [-1, 1]."""

    def __init__(self, *, latent_dim: int = 128, pre_latent: int = 512,
                 condensed_latent: int = 64, gamma: float = 1.0, kld_weight: float = 1e-3,
                 channels: int = 1, device: torch.device | str,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.gamma, self.kld_weight = gamma, kld_weight
        self.condensed_latent = condensed_latent
        meta = torch.device("meta")
        widths = (32, 64, 64, condensed_latent)
        self.enc_convs = nn.ModuleList(
            _lecun(nn.Conv2d(cin, cout, 3, stride=2, device=meta))
            for cin, cout in zip((channels,) + widths[:-1], widths))
        self.enc_dense = _lecun(nn.Linear(16 * condensed_latent, pre_latent, device=meta))
        self.mu_head = _lecun(nn.Linear(pre_latent, latent_dim, device=meta))
        self.logvar_head = _lecun(nn.Linear(pre_latent, latent_dim, device=meta))
        self.dec_dense = _lecun(nn.Linear(latent_dim, 16 * condensed_latent, device=meta))
        dec = (condensed_latent, 64, 64, 32)
        self.dec_convs = nn.ModuleList(
            _lecun(nn.ConvTranspose2d(cin, cout, 3, stride=2, device=meta))
            for cin, cout in zip(dec[:-1], dec[1:]))
        self.dec_out = _lecun(nn.ConvTranspose2d(32, channels, 3, stride=2, device=meta))
        self.to_empty(device="cpu")
        init_layers(self, generator if generator is not None else torch.Generator())
        self.to(device)

    @staticmethod
    def _down(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
        y = F.conv2d(F.pad(x.permute(0, 3, 1, 2), (0, 1, 0, 1)), conv.weight, conv.bias, stride=2)
        return y.permute(0, 2, 3, 1)

    @staticmethod
    def _up(x: torch.Tensor, conv: nn.ConvTranspose2d) -> torch.Tensor:
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2), conv.weight, conv.bias, stride=2)
        return y[:, :, :-1, :-1].permute(0, 2, 3, 1)

    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mu, logvar), the reference's `get_z(x)[1:]`."""
        h = x
        for conv in self.enc_convs:
            h = F.silu(self._down(h, conv))
        h = F.silu(self.enc_dense(h.reshape(h.shape[0], -1)))
        return self.mu_head(h), self.logvar_head(h)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        h = F.silu(self.dec_dense(z)).reshape(z.shape[0], 4, 4, self.condensed_latent)
        for conv in self.dec_convs:
            h = F.silu(self._up(h, conv))
        return torch.tanh(self._up(h, self.dec_out))

    def get_z(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
              eps: Optional[torch.Tensor] = None):
        """(z, mu, logvar), z = mu + exp(logvar / 2) * eps; eps drawn on the
        CPU from `generator` unless given."""
        mu, logvar = self.encode(x)
        if eps is None:
            eps = torch.randn(tuple(mu.shape), generator=generator, dtype=torch.float32)
        return mu + torch.exp(0.5 * logvar) * eps.to(mu.device), mu, logvar

    def forward(self, x, generator=None, eps=None):
        z, mu, logvar = self.get_z(x, generator, eps)
        return self.decode(z), mu, logvar

    def loss(self, x, generator=None, eps=None) -> torch.Tensor:
        """beta-VAE ELBO: reconstruction MSE + gamma * kld_weight * KL."""
        recon, mu, logvar = self(x, generator, eps)
        rec = (recon - x).square().mean()
        kld = -0.5 * (1.0 + logvar - mu.square() - logvar.exp()).sum(dim=-1).mean()
        return rec + self.gamma * self.kld_weight * kld
