"""Diffusion noise schedules and their derived constant tables.

Port of hicdiff_tpu/diffusion/schedules.py: every beta schedule and every
derived table is computed in float64 numpy on the host and only then cast to
float32, so the tables are bit-equal to the JAX package's. Here they are
float32 torch tensors on an explicit device.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

__all__ = [
    "linear_beta_schedule",
    "cosine_beta_schedule",
    "sigmoid_beta_schedule",
    "make_beta_schedule",
    "get_beta_schedule",
    "DiffusionSchedule",
    "make_schedule",
]


def linear_beta_schedule(timesteps: int) -> np.ndarray:
    """Linear schedule from the original DDPM paper."""
    scale = 1000 / timesteps
    return np.linspace(scale * 0.0001, scale * 0.02, timesteps, dtype=np.float64)


def cosine_beta_schedule(timesteps: int, s: float = 0.008) -> np.ndarray:
    """Cosine schedule."""
    steps = timesteps + 1
    t = np.linspace(0, timesteps, steps, dtype=np.float64) / timesteps
    alphas_cumprod = np.cos((t + s) / (1 + s) * math.pi * 0.5) ** 2
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    return np.clip(betas, 0, 0.999)


def sigmoid_beta_schedule(
    timesteps: int, start: float = -3, end: float = 3, tau: float = 1
) -> np.ndarray:
    """Sigmoid schedule."""

    def _sigmoid(x):
        return 1.0 / (1.0 + np.exp(-np.asarray(x, dtype=np.float64)))

    # the reference evaluates sigmoid(start/tau) and sigmoid(end/tau) in
    # float32 before they enter the float64 pipeline; kept for parity
    def _sigmoid_f32(x):
        x32 = np.float32(x)
        return np.float64(np.float32(1.0) / (np.float32(1.0) + np.exp(-x32)))

    steps = timesteps + 1
    t = np.linspace(0, timesteps, steps, dtype=np.float64) / timesteps
    v_start = _sigmoid_f32(start / tau)
    v_end = _sigmoid_f32(end / tau)
    alphas_cumprod = (-_sigmoid((t * (end - start) + start) / tau) + v_end) / (
        v_end - v_start
    )
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    return np.clip(betas, 0, 0.999)


_SCHEDULES = {
    "linear": linear_beta_schedule,
    "cosine": cosine_beta_schedule,
    "sigmoid": sigmoid_beta_schedule,
}


def make_beta_schedule(name: str, timesteps: int, **kwargs) -> np.ndarray:
    if name not in _SCHEDULES:
        raise ValueError(f"unknown beta schedule {name}")
    return _SCHEDULES[name](timesteps, **kwargs)


def get_beta_schedule(
    beta_schedule: str, *, beta_start: float, beta_end: float, num_diffusion_timesteps: int
) -> np.ndarray:
    """The DDRM-side schedule family (metrics_diff.py:36-81), float64.

    Its `sigmoid` is a sigmoid ramp applied to the betas themselves, not
    `sigmoid_beta_schedule` above."""
    n = num_diffusion_timesteps
    if beta_schedule == "quad":
        betas = np.linspace(beta_start**0.5, beta_end**0.5, n, dtype=np.float64) ** 2
    elif beta_schedule == "linear":
        betas = np.linspace(beta_start, beta_end, n, dtype=np.float64)
    elif beta_schedule == "const":
        betas = beta_end * np.ones(n, dtype=np.float64)
    elif beta_schedule == "jsd":  # 1/T, 1/(T-1), ..., 1
        betas = 1.0 / np.linspace(n, 1, n, dtype=np.float64)
    elif beta_schedule == "sigmoid":
        betas = 1 / (np.exp(-np.linspace(-6, 6, n)) + 1) * (beta_end - beta_start) + beta_start
    else:
        raise NotImplementedError(beta_schedule)
    assert betas.shape == (n,)
    return betas


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """Table of diffusion constants, each a (T,) float32 tensor on one device,
    but `sqrt_alphas_cumprod_prev`: (T + 1,), sqrt(concat([1],
    alphas_cumprod_prev)), which the sr3 engine indexes at t + 1 (the
    reference's offset) for the level sqrt(acp[t - 1])."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    log_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    p2_loss_weight: torch.Tensor
    sqrt_alphas_cumprod_prev: torch.Tensor

    @property
    def num_timesteps(self) -> int:
        return int(self.betas.shape[0])

    def to(self, device) -> "DiffusionSchedule":
        return DiffusionSchedule(**{
            f.name: getattr(self, f.name).to(device) for f in dataclasses.fields(self)
        })


def make_schedule(name: str, timesteps: int, *, device: torch.device | str,
                  p2_loss_weight_gamma: float = 0.0,
                  p2_loss_weight_k: float = 1.0, **schedule_kwargs) -> DiffusionSchedule:
    """Build all derived constants in float64, cast to float32 on `device`.
    The p2 loss weight (k + acp / (1 - acp)) ** -gamma is all ones at
    gamma = 0, the only value train.py uses. `schedule_kwargs` go to the
    beta schedule (cosine's s; sigmoid's start, end, tau)."""
    betas = np.asarray(make_beta_schedule(name, timesteps, **schedule_kwargs), dtype=np.float64)

    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas)
    alphas_cumprod_prev = np.concatenate([[1.0], alphas_cumprod[:-1]])
    posterior_variance = betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)

    def f32(x):
        return torch.from_numpy(np.asarray(x, dtype=np.float32)).to(device)

    # alphas_cumprod can reach exactly 0 (linear schedule at small T scales
    # beta_end to 1.0); 1/0 -> inf is the reference's buffer value
    with np.errstate(divide="ignore"):
        sqrt_recip_acp = np.sqrt(1.0 / alphas_cumprod)
        sqrt_recipm1_acp = np.sqrt(1.0 / alphas_cumprod - 1.0)
    return DiffusionSchedule(
        betas=f32(betas),
        alphas_cumprod=f32(alphas_cumprod),
        alphas_cumprod_prev=f32(alphas_cumprod_prev),
        sqrt_alphas_cumprod=f32(np.sqrt(alphas_cumprod)),
        sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - alphas_cumprod)),
        log_one_minus_alphas_cumprod=f32(np.log(1.0 - alphas_cumprod)),
        sqrt_recip_alphas_cumprod=f32(sqrt_recip_acp),
        sqrt_recipm1_alphas_cumprod=f32(sqrt_recipm1_acp),
        posterior_variance=f32(posterior_variance),
        posterior_log_variance_clipped=f32(np.log(np.clip(posterior_variance, 1e-20, None))),
        posterior_mean_coef1=f32(betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod)),
        posterior_mean_coef2=f32(
            (1.0 - alphas_cumprod_prev) * np.sqrt(alphas) / (1.0 - alphas_cumprod)
        ),
        p2_loss_weight=f32(
            (p2_loss_weight_k + alphas_cumprod / (1 - alphas_cumprod)) ** -p2_loss_weight_gamma
        ),
        sqrt_alphas_cumprod_prev=f32(np.sqrt(np.concatenate([[1.0], alphas_cumprod_prev]))),
    )
