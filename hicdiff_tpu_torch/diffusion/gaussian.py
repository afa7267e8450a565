"""Gaussian diffusion engine (port of hicdiff_tpu/diffusion/gaussian.py).

`mode="cond"`: the noisy patch is the model's persistent self-conditioning
input at every step. `mode="sr3"`: the same conditioning, but the model
reads the continuous noise level sqrt_alphas_cumprod_prev[t + 1] in place
of the integer timestep (hicdiff_sr3.py; the t + 1 offset is the
reference's). `mode="uncond"`: the unconditional prior; its samplers start
from pure noise of a given shape and, for a self-conditioned model, thread
the previous step's x0 prediction (zeros at the first step); the DDRM
sampler (`sampling/ddrm.py`) drives it as a raw eps-model.

`objective`: the model predicts the noise (`pred_noise`, the default and
the only one the CLIs train), the clean image (`pred_x0`) or
v = sqrt(acp) eps - sqrt(1 - acp) x0 (`pred_v`); `model_predictions` turns
each into (noise, x0), and the losses target it. `loss_type` is `l2` or
`l1`; `p2_loss_weight_gamma` / `_k` and `schedule_fn_kwargs` go to the
schedule. `seq_length` makes the engine 1-D (samples (seq_length,
channels), e.g. for `models.unet1d.Unet1D`).

Reverse chains are Python loops (the JAX package's `lax.scan`). Under
`pred_noise` each ancestral step ends in
`kernels.sample_step.fused_posterior_step`, the CUDA kernel on a CUDA
tensor, which draws its noise in the kernel from one seed taken from an
explicit CPU `torch.Generator`, so the chain never waits on the device for
its noise. Under `pred_x0` and `pred_v` the step goes through
`p_mean_variance` and a normal draw from the generator, as the JAX package
fuses the step for `pred_noise` alone. DDIM clips its x0 prediction unless
`ddim_clip_x_start=False`; `return_all_timesteps` makes a chain return
every state, the start included, stacked on a new first axis.

`t_start` truncates a conditioned chain: it starts at t* from
sqrt(acp[t*]) * y, which is exactly the forward marginal q(x_t* | x0) when
acp[t*] = 1 / (1 + sigma^2) (`truncation_timestep`).

Training: `q_sample`, `q_sample_continuous` and `p_losses` (the JAX
package's `p_losses` and `_p_losses_sr3`). Its draws come from an explicit
`torch.Generator`, or from the caller.

A shard of a batch (`parallel/`: one rank's rows) passes `rows=(lo, n)`:
its first row lo within a batch of n real rows. The chains and the loss then
draw what the whole batch draws and keep the shard's rows (zeros past n, for
a rank's padding), and the posterior step draws its noise at the shard's
elements, so a sharded run draws what the one-process run draws.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from hicdiff_tpu_torch.diffusion.schedules import DiffusionSchedule, make_schedule
from hicdiff_tpu_torch.kernels.sample_step import fused_posterior_step

__all__ = ["GaussianDiffusion", "ModelPrediction", "draw_rows", "keep_rows"]

MODES = ("cond", "uncond", "sr3")
OBJECTIVES = ("pred_noise", "pred_x0", "pred_v")
LOSS_TYPES = ("l2", "l1")


class ModelPrediction(NamedTuple):
    pred_noise: torch.Tensor
    pred_x_start: torch.Tensor


def _extract(a: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """a[t] broadcast to an image batch: (b,) -> (b, 1, 1, 1)."""
    out = a[t]
    return out.reshape(out.shape[0], *((1,) * (ndim - 1)))


def keep_rows(full: torch.Tensor, rows, b: int) -> torch.Tensor:
    """A shard's b rows [lo, lo + b) of a draw made for the whole batch,
    rows = (lo, n); zeros past its end (a rank's padding)."""
    part = full[rows[0]:rows[0] + b]
    if part.shape[0] < b:
        part = torch.cat([part, part.new_zeros((b - part.shape[0], *part.shape[1:]))])
    return part


def draw_rows(fn, shape, rows=None) -> torch.Tensor:
    """fn(shape), a draw of a batch's shape, or, for a shard at rows =
    (lo, n), the shard's rows of fn((n, ...)), the whole batch's draw."""
    shape = tuple(shape)
    if rows is None:
        return fn(shape)
    return keep_rows(fn((rows[1], *shape[1:])), rows, shape[0])


def _normal(generator: torch.Generator):
    return lambda shape: torch.randn(shape, generator=generator, dtype=torch.float32)


def _randn(shape, generator: torch.Generator, device, rows=None) -> torch.Tensor:
    return draw_rows(_normal(generator), shape, rows).to(device)


def to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """t on `device`. A CPU tensor goes to a card through pinned memory, so
    the copy does not wait for the card's queued work."""
    if torch.device(device).type == "cuda" and not t.is_cuda:
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


@dataclasses.dataclass(frozen=True)
class GaussianDiffusion:
    """DDPM engine around a backbone of the registry: conditional (`cond`,
    `sr3`: a self-conditioned model) or unconditional.

    `schedule` lives on the model's device; `host_schedule` is the same table
    on the CPU, read for the per-step scalars without a device sync.
    `sr3_per_sample_t` (sr3 training only) draws t per sample instead of
    the reference's one t per step."""

    model: nn.Module
    schedule: DiffusionSchedule
    host_schedule: DiffusionSchedule
    sampling_timesteps: Optional[int] = None
    ddim_sampling_eta: float = 0.0
    t_start: Optional[int] = None
    mode: str = "cond"
    image_size: int = 64
    sr3_per_sample_t: bool = False
    objective: str = "pred_noise"
    loss_type: str = "l2"
    ddim_clip_x_start: bool = True
    seq_length: Optional[int] = None

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
        mode: str = "cond",
        image_size: int = 64,
        sr3_per_sample_t: bool = False,
        objective: str = "pred_noise",
        loss_type: str = "l2",
        ddim_clip_x_start: bool = True,
        p2_loss_weight_gamma: float = 0.0,
        p2_loss_weight_k: float = 1.0,
        schedule_fn_kwargs: Optional[dict] = None,
        seq_length: Optional[int] = None,
    ) -> "GaussianDiffusion":
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        if objective not in OBJECTIVES:
            raise ValueError(f"objective must be one of {OBJECTIVES}, got {objective!r}")
        if loss_type not in LOSS_TYPES:
            raise ValueError(f"loss_type must be one of {LOSS_TYPES}, got {loss_type!r}")
        if mode != "uncond" and not getattr(model, "self_condition", False):
            raise ValueError(f"mode={mode!r} conditions on the noisy patch through "
                             "self-conditioning: it needs a self_condition=True model")
        host = make_schedule(beta_schedule, timesteps, device="cpu",
                             p2_loss_weight_gamma=p2_loss_weight_gamma,
                             p2_loss_weight_k=p2_loss_weight_k, **(schedule_fn_kwargs or {}))
        return cls(
            model=model,
            schedule=host.to(device),
            host_schedule=host,
            sampling_timesteps=sampling_timesteps,
            ddim_sampling_eta=ddim_sampling_eta,
            t_start=t_start,
            mode=mode,
            image_size=image_size,
            sr3_per_sample_t=sr3_per_sample_t,
            objective=objective,
            loss_type=loss_type,
            ddim_clip_x_start=ddim_clip_x_start,
            seq_length=seq_length,
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

    @property
    def conditioned(self) -> bool:
        """Whether the chains take a conditioning batch (else a shape)."""
        return self.mode in ("cond", "sr3") and self.model.self_condition

    @property
    def sample_data_shape(self) -> tuple:
        """One sample's shape: (seq_length, C) 1-D, else (H, W, C)."""
        if self.seq_length is not None:
            return (self.seq_length, self.model.channels)
        return (self.image_size, self.image_size, self.model.channels)

    @property
    def device(self) -> torch.device:
        return self.schedule.betas.device

    def truncation_timestep(self, sigma0: float) -> int:
        """The t whose forward marginal matches `y = x + sigma0 * eps`."""
        acp = self.host_schedule.alphas_cumprod.numpy()
        return int(np.argmin(np.abs(acp - 1.0 / (1.0 + float(sigma0) ** 2))))

    def _truncated_init(self, cond: torch.Tensor) -> torch.Tensor:
        """sqrt(alphas_cumprod[t_start]) * y, the exact-marginal chain init."""
        scale = float(self.host_schedule.alphas_cumprod[self.t_start] ** 0.5)
        return (scale * cond).float()

    def _validate_t_start(self) -> bool:
        """Whether truncation is active; raises on an out-of-range t_start
        or an engine without a conditioning input to start from."""
        if self.t_start is None:
            return False
        if not self.conditioned:
            raise ValueError("t_start requires a conditioned engine (mode 'cond' or 'sr3' and "
                             "a self_condition=True model): the truncated chain starts from "
                             "the conditioning input")
        if not 0 <= self.t_start < self.num_timesteps:
            raise ValueError(f"t_start {self.t_start} outside [0, {self.num_timesteps})")
        return True

    def _chain_init(self, x_in, generator: torch.Generator, rows=None):
        """(truncated?, x_T) of a chain: x_in is the conditioning batch of a
        conditioned engine, else the shape to sample."""
        if self._validate_t_start():
            return True, self._truncated_init(x_in)
        if self.conditioned:
            return False, _randn(x_in.shape, generator, x_in.device, rows)
        return False, _randn(x_in, generator, self.device, rows)

    def _self_cond(self, cond, x_start_prev):
        """The model's self-conditioning input at a reverse step: the
        conditioning batch, the previous x0 prediction (uncond engine with a
        self-conditioned model), or None."""
        if self.conditioned:
            return cond
        return x_start_prev if self.model.self_condition else None

    # --------------------------------------------------------------- algebra
    def predict_start_from_noise(self, x_t, t, noise):
        s = self.schedule
        return (
            _extract(s.sqrt_recip_alphas_cumprod, t, x_t.ndim) * x_t
            - _extract(s.sqrt_recipm1_alphas_cumprod, t, x_t.ndim) * noise
        )

    def predict_noise_from_start(self, x_t, t, x0):
        s = self.schedule
        return ((_extract(s.sqrt_recip_alphas_cumprod, t, x_t.ndim) * x_t - x0)
                / _extract(s.sqrt_recipm1_alphas_cumprod, t, x_t.ndim))

    def predict_v(self, x_start, t, noise):
        s = self.schedule
        return (_extract(s.sqrt_alphas_cumprod, t, x_start.ndim) * noise
                - _extract(s.sqrt_one_minus_alphas_cumprod, t, x_start.ndim) * x_start)

    def predict_start_from_v(self, x_t, t, v):
        s = self.schedule
        return (_extract(s.sqrt_alphas_cumprod, t, x_t.ndim) * x_t
                - _extract(s.sqrt_one_minus_alphas_cumprod, t, x_t.ndim) * v)

    def q_sample(self, x_start, t, noise):
        """Forward diffusion x_t ~ q(x_t | x_0)."""
        s = self.schedule
        return (
            _extract(s.sqrt_alphas_cumprod, t, x_start.ndim) * x_start
            + _extract(s.sqrt_one_minus_alphas_cumprod, t, x_start.ndim) * noise
        )

    @staticmethod
    def q_sample_continuous(x_start, level, noise):
        """SR3 forward at a per-sample continuous level (sqrt alpha-bar)."""
        c = level.reshape(-1, *((1,) * (x_start.ndim - 1)))
        return c * x_start + torch.sqrt(1.0 - c**2) * noise

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
    def _model_time(self, t: torch.Tensor) -> torch.Tensor:
        """What the model reads for timesteps t: t itself, or in sr3 the
        level sqrt_alphas_cumprod_prev[t + 1]."""
        if self.mode == "sr3":
            return self.schedule.sqrt_alphas_cumprod_prev[t + 1]
        return t

    def model_predictions(self, x, t, x_self_cond=None, clip_x_start: bool = False):
        """(noise, x0) from the model's output under the engine's objective;
        x0 clipped to [-1, 1] with clip_x_start, before the noise is
        derived from it."""
        out = self.model(x, self._model_time(t), x_self_cond)

        def clip(z):
            return torch.clamp(z, -1.0, 1.0) if clip_x_start else z

        if self.objective == "pred_noise":
            return ModelPrediction(out, clip(self.predict_start_from_noise(x, t, out)))
        x_start = clip(out if self.objective == "pred_x0" else self.predict_start_from_v(x, t, out))
        return ModelPrediction(self.predict_noise_from_start(x, t, x_start), x_start)

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
    def p_sample_step(self, x, t_scalar: int, x_self_cond, generator: torch.Generator,
                      rows=None):
        """One reverse step (x_{t-1}, x0); its noise is zero at t == 0.
        pred_noise: the fused posterior step; else the posterior of
        `p_mean_variance` plus a normal draw from `generator`."""
        t = torch.full((x.shape[0],), t_scalar, dtype=torch.long, device=x.device)
        if self.objective != "pred_noise":
            mean, _, log_var, x_start = self.p_mean_variance(x, t, x_self_cond)
            if t_scalar == 0:
                return mean, x_start
            z = _randn(x.shape, generator, x.device, rows)
            return mean + torch.exp(0.5 * log_var) * z, x_start
        eps = self.model(x, self._model_time(t), x_self_cond)
        seed = int(torch.randint(0, 2**63 - 1, (1,), generator=generator))
        offset, total = 0, None
        if rows is not None:  # the shard's first element over 4, in a batch of n rows
            row = x[0].numel()
            if rows[0] * row % 4:
                raise ValueError(f"a shard must start on a group of 4 elements: row {rows[0]} "
                                 f"of {row} elements")
            offset, total = rows[0] * row // 4, rows[1] * row
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
            offset,
            total,
        )

    @torch.no_grad()
    def _ancestral(self, img, times, cond, generator, return_all_timesteps=False, rows=None):
        x_start = torch.zeros_like(img)
        states = [img]
        for t in times:
            img, x_start = self.p_sample_step(img, t, self._self_cond(cond, x_start), generator,
                                              rows)
            if return_all_timesteps:
                states.append(img)
        return torch.stack(states) if return_all_timesteps else img

    @torch.no_grad()
    def p_sample_loop(self, x_in, generator: torch.Generator, *,
                      return_all_timesteps: bool = False, rows=None):
        """The ancestral chain. x_in: the conditioning batch (B, H, W, C) of
        a conditioned engine, read at every step; else the shape to sample."""
        truncated, img = self._chain_init(x_in, generator, rows)
        top = self.t_start if truncated else self.num_timesteps - 1
        return self._ancestral(img, range(top, -1, -1), x_in if self.conditioned else None,
                               generator, return_all_timesteps, rows)

    @torch.no_grad()
    def ddim_sample(self, x_in, generator: torch.Generator, *,
                    return_all_timesteps: bool = False, rows=None):
        """DDIM over `sampling_timesteps` time pairs; x_in as in `p_sample_loop`."""
        truncated, img = self._chain_init(x_in, generator, rows)
        cond = x_in if self.conditioned else None
        total = self.num_timesteps
        top = self.t_start if truncated else total - 1
        steps = min(self.sampling_timesteps or total, top + 1)
        times = np.linspace(-1, top, steps + 1).astype(int)[::-1]
        acp = self.host_schedule.alphas_cumprod.numpy()
        eta = np.float32(self.ddim_sampling_eta)
        x_start = torch.zeros_like(img)
        states = [img]
        for time, time_next in zip(times[:-1], times[1:]):
            t = torch.full((img.shape[0],), int(time), dtype=torch.long, device=img.device)
            pred_noise, x_start = self.model_predictions(
                img, t, self._self_cond(cond, x_start), clip_x_start=self.ddim_clip_x_start)
            if time_next < 0:
                img = x_start
            else:
                alpha, alpha_next = acp[time], acp[time_next]
                sigma = eta * np.sqrt((1 - alpha / alpha_next) * (1 - alpha_next) / (1 - alpha))
                c = np.sqrt(1 - alpha_next - sigma**2)
                img = x_start * float(np.sqrt(alpha_next)) + float(c) * pred_noise
                if sigma > 0:
                    img = img + float(sigma) * _randn(img.shape, generator, img.device, rows)
            if return_all_timesteps:
                states.append(img)
        return torch.stack(states) if return_all_timesteps else img

    def super_resolution(self, x_in, generator: torch.Generator, *,
                         return_all_timesteps: bool = False, rows=None):
        """DDIM when sampling_timesteps < T, else the ancestral chain; a
        conditioned chain is truncated at t_start when it is set. x_in as in
        `p_sample_loop`; rows: a shard's (first row, rows of the batch)."""
        fn = self.ddim_sample if self.is_ddim_sampling else self.p_sample_loop
        return fn(x_in, generator, return_all_timesteps=return_all_timesteps, rows=rows)

    def sample(self, batch_size: int, generator: torch.Generator, *,
               return_all_timesteps: bool = False):
        """Unconditional samples (batch_size, *sample_data_shape) from pure
        noise."""
        return self.super_resolution((batch_size, *self.sample_data_shape), generator,
                                     return_all_timesteps=return_all_timesteps)

    @torch.no_grad()
    def interpolate(self, x1, x2, generator: torch.Generator, *, t: Optional[int] = None,
                    lam: float = 0.5):
        """Latent interpolation: diffuse both batches to step t (default
        T - 1) with two noise draws, blend (1 - lam) x_t1 + lam x_t2, then run
        the ancestral chain from t - 1 down to 0, threading the previous x0
        for a self-conditioned model."""
        t = self.num_timesteps - 1 if t is None else int(t)
        if x1.shape != x2.shape:
            raise ValueError("interpolate endpoints must share a shape")
        tb = torch.full((x1.shape[0],), t, dtype=torch.long, device=x1.device)
        xt1 = self.q_sample(x1, tb, _randn(x1.shape, generator, x1.device))
        xt2 = self.q_sample(x2, tb, _randn(x2.shape, generator, x2.device))
        img = (1.0 - lam) * xt1 + lam * xt2
        x_start = torch.zeros_like(img)
        for ti in range(t - 1, -1, -1):
            sc = x_start if self.model.self_condition else None
            img, x_start = self.p_sample_step(img, ti, sc, generator)
        return img

    # ------------------------------------------------------------------ loss
    def _elementwise_loss(self, model_out, target):
        diff = model_out - target
        return diff.square() if self.loss_type == "l2" else diff.abs()

    def p_losses(self, cond, x_start, *, generator: Optional[torch.Generator] = None,
                 t: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None,
                 level: Optional[torch.Tensor] = None, reduce: bool = True, rows=None):
        """The training loss: the model reads x_t = q_sample(x_start, t,
        noise) and predicts the objective's target (the noise, x_start, or
        predict_v(x_start, t, noise)); the per-sample mean of the l2 or l1
        error times p2_loss_weight[t]. mode 'cond': the model is self-conditioned
        on `cond`, the noisy patch. mode 'uncond': `cond` is None; a
        self-conditioned model conditions, on a fair coin, on its own x0
        prediction from zeros (gradient stopped), else on zeros
        (gaussian.py:688-703). mode 'sr3': `_p_losses_sr3`. `t` (B,) and
        `noise` (the shape of x_start) are drawn on the CPU from `generator`,
        in that order, unless given, and moved to x_start's device; the coin
        is drawn from it after them. reduce=False returns the per-sample (B,)
        vector, else its mean over the batch. rows: a shard's (first row,
        rows of the batch), whose draws are the whole batch's."""
        if self.mode == "sr3":
            return self._p_losses_sr3(cond, x_start, generator=generator, t=t, level=level,
                                      noise=noise, reduce=reduce, rows=rows)
        b, device = x_start.shape[0], x_start.device
        if t is None:
            t = draw_rows(lambda s: torch.randint(0, self.num_timesteps, s, generator=generator),
                          (b,), rows)
        if noise is None:
            noise = draw_rows(_normal(generator), x_start.shape, rows)
        t, noise = to_device(t, device), to_device(noise, device)
        x = self.q_sample(x_start, t, noise)
        if self.mode == "cond":
            x_self_cond = cond
        elif self.model.self_condition:
            x_self_cond = torch.zeros_like(x)
            if torch.rand((), generator=generator) < 0.5:
                with torch.no_grad():
                    x_self_cond = self.model_predictions(x, t, x_self_cond).pred_x_start
        else:
            x_self_cond = None
        model_out = self.model(x, t, x_self_cond)
        if self.objective == "pred_noise":
            target = noise
        elif self.objective == "pred_x0":
            target = x_start
        else:
            target = self.predict_v(x_start, t, noise)
        loss = self._elementwise_loss(model_out, target).reshape(b, -1).mean(dim=1)
        loss = loss * self.schedule.p2_loss_weight[t]
        return loss.mean() if reduce else loss

    def _p_losses_sr3(self, cond, x_end, *, generator=None, t=None, level=None, noise=None,
                      reduce=True, rows=None):
        """The sr3 loss (hicdiff_sr3.py:754-791): t in [1, T], one scalar per
        step (per sample under sr3_per_sample_t); a level per sample drawn
        as the JAX package's jax.random.uniform(minval=prev[t - 1],
        maxval=prev[t]) on sqrt_alphas_cumprod_prev; the model predicts
        the noise of q_sample_continuous(x_end, level, noise) from (x,
        level, cond); no p2 weighting. prev decreases, so minval > maxval,
        and that draw clamps to minval: the level is prev[t - 1] exactly,
        as in the JAX package. Unless given, t, the uniforms of the level
        and the noise are drawn from `generator` in that order; a given
        `level` needs no t, unless the objective is pred_v, whose target
        is predict_v(x_end, t - 1, noise)."""
        b, device = x_end.shape[0], x_end.device
        if level is not None and t is None and self.objective == "pred_v":
            raise ValueError("the pred_v target needs the t of the given level")
        if level is None:
            if t is None and self.sr3_per_sample_t:
                t = draw_rows(lambda s: torch.randint(1, self.num_timesteps + 1, s,
                                                      generator=generator), (b,), rows)
            elif t is None:
                t = torch.randint(1, self.num_timesteps + 1, (), generator=generator)
            prev = self.host_schedule.sqrt_alphas_cumprod_prev
            lo, hi = prev[t - 1], prev[t]
            u = draw_rows(lambda s: torch.rand(s, generator=generator, dtype=torch.float32),
                          (b,), rows)
            level = torch.maximum(lo, u * (hi - lo) + lo)  # jax.random.uniform's form
        if noise is None:
            noise = draw_rows(_normal(generator), x_end.shape, rows)
        level, noise = to_device(level, device), to_device(noise, device)
        x = self.q_sample_continuous(x_end, level, noise)
        model_out = self.model(x, level, cond if self.model.self_condition else None)
        if self.objective == "pred_noise":
            target = noise
        elif self.objective == "pred_x0":
            target = x_end
        else:
            tb = torch.clamp(torch.as_tensor(t) - 1, 0, self.num_timesteps - 1)
            target = self.predict_v(x_end, to_device(tb.expand(b), device), noise)
        loss = self._elementwise_loss(model_out, target)
        return loss.mean() if reduce else loss.reshape(b, -1).mean(dim=1)
