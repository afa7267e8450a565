"""Conditional Gaussian diffusion engine (port of the `mode="cond"`,
`objective="pred_noise"` part of hicdiff_tpu/diffusion/gaussian.py).

The noisy patch is the model's persistent self-conditioning input at every
step. Reverse chains are Python loops (the JAX package's `lax.scan`); each
ancestral step ends in `kernels.sample_step.fused_posterior_step`, the CUDA
kernel on a CUDA tensor. Randomness comes from an explicit CPU
`torch.Generator`: the ancestral step draws one seed from it, so the chain
never waits on the device for its noise.

`t_start` truncates the chain: it starts at t* from sqrt(acp[t*]) * y, which
is exactly the forward marginal q(x_t* | x0) when acp[t*] = 1 / (1 + sigma^2)
(`truncation_timestep`).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from hicdiff_tpu_torch.diffusion.schedules import DiffusionSchedule, make_schedule
from hicdiff_tpu_torch.kernels.sample_step import fused_posterior_step

__all__ = ["GaussianDiffusion", "ModelPrediction"]


class ModelPrediction(NamedTuple):
    pred_noise: torch.Tensor
    pred_x_start: torch.Tensor


def _extract(a: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """a[t] broadcast to an image batch: (b,) -> (b, 1, 1, 1)."""
    out = a[t]
    return out.reshape(out.shape[0], *((1,) * (ndim - 1)))


def _randn(shape, generator: torch.Generator, device) -> torch.Tensor:
    return torch.randn(shape, generator=generator, dtype=torch.float32).to(device)


@dataclasses.dataclass(frozen=True)
class GaussianDiffusion:
    """Conditional DDPM engine around a self-conditioned HicedrnDiff.

    `schedule` lives on the model's device; `host_schedule` is the same table
    on the CPU, read for the per-step scalars without a device sync."""

    model: nn.Module
    schedule: DiffusionSchedule
    host_schedule: DiffusionSchedule
    sampling_timesteps: Optional[int] = None
    ddim_sampling_eta: float = 0.0
    t_start: Optional[int] = None

    @classmethod
    def create(
        cls,
        model: nn.Module,
        *,
        device: torch.device | str,
        timesteps: int = 1000,
        sampling_timesteps: Optional[int] = None,
        beta_schedule: str = "sigmoid",
        ddim_sampling_eta: float = 0.0,
        t_start: Optional[int] = None,
    ) -> "GaussianDiffusion":
        if not getattr(model, "self_condition", False):
            raise NotImplementedError(
                "the port's engine is the conditional one: it needs a "
                "self_condition=True model (the uncond engine is not ported yet)"
            )
        host = make_schedule(beta_schedule, timesteps, device="cpu")
        return cls(
            model=model,
            schedule=host.to(device),
            host_schedule=host,
            sampling_timesteps=sampling_timesteps,
            ddim_sampling_eta=ddim_sampling_eta,
            t_start=t_start,
        )

    # ------------------------------------------------------------------ setup
    @property
    def num_timesteps(self) -> int:
        return self.schedule.num_timesteps

    @property
    def is_ddim_sampling(self) -> bool:
        return (
            self.sampling_timesteps is not None
            and self.sampling_timesteps < self.num_timesteps
        )

    def truncation_timestep(self, sigma0: float) -> int:
        """The t whose forward marginal matches `y = x + sigma0 * eps`."""
        acp = self.host_schedule.alphas_cumprod.numpy()
        return int(np.argmin(np.abs(acp - 1.0 / (1.0 + float(sigma0) ** 2))))

    def _truncated_init(self, cond: torch.Tensor) -> torch.Tensor:
        """sqrt(alphas_cumprod[t_start]) * y, the exact-marginal chain init."""
        scale = float(self.host_schedule.alphas_cumprod[self.t_start] ** 0.5)
        return (scale * cond).float()

    def _validate_t_start(self) -> bool:
        """Whether truncation is active; raises on an out-of-range t_start."""
        if self.t_start is None:
            return False
        if not 0 <= self.t_start < self.num_timesteps:
            raise ValueError(f"t_start {self.t_start} outside [0, {self.num_timesteps})")
        return True

    def _chain_init(self, cond: torch.Tensor, generator: torch.Generator):
        """(truncated?, x_T) for a chain conditioned on `cond`."""
        if self._validate_t_start():
            return True, self._truncated_init(cond)
        return False, _randn(cond.shape, generator, cond.device)

    # --------------------------------------------------------------- algebra
    def predict_start_from_noise(self, x_t, t, noise):
        s = self.schedule
        return (
            _extract(s.sqrt_recip_alphas_cumprod, t, x_t.ndim) * x_t
            - _extract(s.sqrt_recipm1_alphas_cumprod, t, x_t.ndim) * noise
        )

    def q_posterior(self, x_start, x_t, t):
        s = self.schedule
        posterior_mean = (
            _extract(s.posterior_mean_coef1, t, x_t.ndim) * x_start
            + _extract(s.posterior_mean_coef2, t, x_t.ndim) * x_t
        )
        posterior_variance = _extract(s.posterior_variance, t, x_t.ndim)
        posterior_log_variance = _extract(s.posterior_log_variance_clipped, t, x_t.ndim)
        return posterior_mean, posterior_variance, posterior_log_variance

    # ------------------------------------------------------------ prediction
    def model_predictions(self, x, t, x_self_cond=None, clip_x_start: bool = False):
        pred_noise = self.model(x, t, x_self_cond)
        x_start = self.predict_start_from_noise(x, t, pred_noise)
        if clip_x_start:
            x_start = torch.clamp(x_start, -1.0, 1.0)
        return ModelPrediction(pred_noise, x_start)

    def p_mean_variance(self, x, t, x_self_cond=None, clip_denoised: bool = True):
        x_start = self.model_predictions(x, t, x_self_cond).pred_x_start
        if clip_denoised:
            x_start = torch.clamp(x_start, -1.0, 1.0)
        model_mean, posterior_variance, posterior_log_variance = self.q_posterior(
            x_start, x, t
        )
        return model_mean, posterior_variance, posterior_log_variance, x_start

    # -------------------------------------------------------------- sampling
    @torch.no_grad()
    def p_sample_step(self, x, t_scalar: int, x_self_cond, generator: torch.Generator):
        """One reverse step (x_{t-1}, x0); its noise is zero at t == 0."""
        t = torch.full((x.shape[0],), t_scalar, dtype=torch.long, device=x.device)
        eps = self.model(x, t, x_self_cond)
        seed = int(torch.randint(0, 2**63 - 1, (1,), generator=generator))
        s = self.host_schedule
        return fused_posterior_step(
            x,
            eps,
            float(s.sqrt_recip_alphas_cumprod[t_scalar]),
            float(s.sqrt_recipm1_alphas_cumprod[t_scalar]),
            float(s.posterior_mean_coef1[t_scalar]),
            float(s.posterior_mean_coef2[t_scalar]),
            float(s.posterior_log_variance_clipped[t_scalar]),
            1.0 if t_scalar > 0 else 0.0,
            seed,
        )

    @torch.no_grad()
    def p_sample_loop(self, cond: torch.Tensor, generator: torch.Generator):
        """The ancestral chain conditioned on `cond` (B, H, W, C) at every step."""
        truncated, img = self._chain_init(cond, generator)
        top = self.t_start if truncated else self.num_timesteps - 1
        for t in range(top, -1, -1):
            img, _ = self.p_sample_step(img, t, cond, generator)
        return img

    @torch.no_grad()
    def ddim_sample(self, cond: torch.Tensor, generator: torch.Generator):
        """DDIM over `sampling_timesteps` time pairs, conditioned on `cond`."""
        truncated, img = self._chain_init(cond, generator)
        total = self.num_timesteps
        top = self.t_start if truncated else total - 1
        steps = min(self.sampling_timesteps or total, top + 1)
        times = np.linspace(-1, top, steps + 1).astype(int)[::-1]
        acp = self.host_schedule.alphas_cumprod.numpy()
        eta = np.float32(self.ddim_sampling_eta)
        for time, time_next in zip(times[:-1], times[1:]):
            t = torch.full((img.shape[0],), int(time), dtype=torch.long, device=img.device)
            pred_noise, x_start = self.model_predictions(img, t, cond, clip_x_start=True)
            if time_next < 0:
                img = x_start
                continue
            alpha, alpha_next = acp[time], acp[time_next]
            sigma = eta * np.sqrt((1 - alpha / alpha_next) * (1 - alpha_next) / (1 - alpha))
            c = np.sqrt(1 - alpha_next - sigma**2)
            img = x_start * float(np.sqrt(alpha_next)) + float(c) * pred_noise
            if sigma > 0:
                img = img + float(sigma) * _randn(img.shape, generator, img.device)
        return img

    def super_resolution(self, cond: torch.Tensor, generator: torch.Generator):
        """Conditional denoising: DDIM when sampling_timesteps < T, else the
        ancestral chain; either truncated at t_start when it is set."""
        fn = self.ddim_sample if self.is_ddim_sampling else self.p_sample_loop
        return fn(cond, generator)
