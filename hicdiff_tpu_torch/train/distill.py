"""Progressive DDIM distillation of the conditional reverse chain (port of
hicdiff_tpu/train/distill.py).

The truncated DDIM chain over t* + 1 steps is halved stage by stage (30 ->
15 -> 8 -> 4 -> 2 -> 1 at sigma = 0.1): a student initialized from the
teacher learns, in ONE DDIM step, the state the teacher reaches in TWO
(progressive distillation, Salimans & Ho, ICLR 2022). Stage grids are the
`np.linspace(-1, top, K + 1)` of `GaussianDiffusion.ddim_sample`, so a
distilled checkpoint runs through `inference_torch.py -u 0 --t-start auto
--sampling-steps K` with no new sampler code. The i = 0 training state is
the chain's deterministic init sqrt(acp[t*]) * y.

Loss (the JAX package's): x-space L2 between the student's one deployed
DDIM step and the teacher's two, both with the deployed x0 clip; the
teacher is a frozen copy whose forwards run under no_grad (on the card the
conv kernel's inference launches), the student trains through the training
launches and the weight gradient.

Draws: each step's i (which of the K grid steps) and noise come from the
CPU generator `step_generator(seed, step)` in that order, the val batches'
from (seed, 10_000_000 + i), as the JAX distiller folds those numbers into
its key; `loss` also takes them explicitly. With a mesh of more than one
rank the step is the trainer's data-parallel step: the batch padded to the
world size with weight-0 rows, each rank's rows with the whole batch's
draws, gradients and loss summed over the ranks before Adam.
"""
from __future__ import annotations

import copy
import dataclasses
import time
from typing import Optional, Tuple

import numpy as np
import torch

from hicdiff_tpu_torch.diffusion.gaussian import GaussianDiffusion, draw_rows, to_device
from hicdiff_tpu_torch.parallel import mesh as parallel
from hicdiff_tpu_torch.train.logging import MetricLogger
from hicdiff_tpu_torch.train.trainer import VAL_SEED_OFFSET, Trainer, step_generator

__all__ = ["ProgressiveDistiller", "halving_stages", "stage_grid"]


def stage_grid(top: int, k: int) -> np.ndarray:
    """The K-step DDIM time grid from `top` down to -1 (inclusive): the grid
    of `GaussianDiffusion.ddim_sample`, which deploys the student."""
    return np.linspace(-1, top, k + 1).astype(int)[::-1].copy()


def halving_stages(k0: int) -> list:
    """[k0, ceil(k0/2), ..., 1]: the progressive halving plan."""
    ks = [k0]
    while ks[-1] > 1:
        ks.append(-(-ks[-1] // 2))
    return ks


def _bc(v: torch.Tensor, ndim: int) -> torch.Tensor:
    return v.reshape(v.shape[0], *((1,) * (ndim - 1)))


class ProgressiveDistiller:
    """One distillation stage: teacher at its grid -> student at half the
    steps. The engine must be mode='cond' with a self-conditioned model and
    t_start set (the truncated conditional configuration); its model is the
    student, trained in place from the teacher's weights."""

    def __init__(self, engine: GaussianDiffusion, student_steps: int, lr: float = 1e-5,
                 mesh: Optional[parallel.Mesh] = None):
        assert engine.mode == "cond" and engine.model.self_condition, (
            "distillation targets the truncated conditional chain")
        assert engine.t_start is not None, "set engine.t_start (truncation_timestep)"
        assert engine.objective == "pred_noise"
        self.engine = engine
        self.model = engine.model
        self.device = next(self.model.parameters()).device
        self.student_steps = int(student_steps)
        self.mesh = mesh
        top = engine.t_start
        if self.student_steps > top + 1:
            raise ValueError(
                f"student_steps={self.student_steps} exceeds the truncated grid's "
                f"t_start+1={top + 1} distinct steps: start the halving plan at K0 <= t_start+1")
        grid = stage_grid(top, self.student_steps)  # (K+1,) descending to -1
        # padded to a stage-independent length, as the JAX distiller's tables
        t_hi = np.full((top + 1,), top, np.int64)
        t_hi[: self.student_steps] = grid[:-1]
        t_lo = np.full((top + 1,), -1, np.int64)
        t_lo[: self.student_steps] = grid[1:]
        self.t_hi_tab = torch.from_numpy(t_hi).to(self.device)
        self.t_lo_tab = torch.from_numpy(t_lo).to(self.device)
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=lr, betas=(0.9, 0.999),
                                          eps=1e-8)
        parallel.replicate(mesh, self.model)
        self.teacher = None

    def freeze_teacher(self) -> GaussianDiffusion:
        """The teacher: a frozen copy of the model as it stands now."""
        teacher = copy.deepcopy(self.model).eval().requires_grad_(False)
        self.teacher = dataclasses.replace(self.engine, model=teacher)
        return self.teacher

    # ------------------------------------------------------------------ loss
    def _alpha_at(self, t: torch.Tensor) -> torch.Tensor:
        """acp[t], with t = -1 meaning fully denoised (alpha = 1)."""
        a = self.engine.schedule.alphas_cumprod[torch.clamp(t, min=0)]
        return torch.where(t < 0, torch.ones_like(a), a)

    def _ddim_to(self, x0_hat, eps_hat, t_next, ndim):
        """The eta = 0 DDIM jump to t_next (t_next = -1 gives x0_hat)."""
        a = self._alpha_at(t_next)
        return _bc(torch.sqrt(a), ndim) * x0_hat + _bc(torch.sqrt(1.0 - a), ndim) * eps_hat

    def draws(self, b: int, shape, generator: torch.Generator, rows=None):
        """(i, noise) of a batch of b rows as the step draws them from
        `generator`, i in [0, K); for a shard at rows = (lo, n), its rows of
        the whole batch's draws."""
        i = draw_rows(lambda s: torch.randint(0, self.student_steps, s, generator=generator),
                      (b,), rows)
        noise = draw_rows(lambda s: torch.randn(s, generator=generator, dtype=torch.float32),
                          shape, rows)
        return i, noise

    def loss(self, y, x0, weights, i, noise, denom: Optional[float] = None) -> torch.Tensor:
        """sum(per * weights) / max(sum(weights), 1) over the batch (y, x0)
        (NHWC tensors on the device) at grid steps i with noise; `denom`
        replaces the weights' sum (a rank's part of a sharded batch)."""
        eng, teacher = self.engine, self.teacher
        ndim = x0.ndim
        i, noise = to_device(i, self.device), to_device(noise, self.device)
        t_hi, t_lo = self.t_hi_tab[i], self.t_lo_tab[i]
        t_mid = torch.div(t_hi + t_lo + 1, 2, rounding_mode="floor")  # t_hi when the gap is 1
        x_marginal = eng.q_sample(x0, t_hi, noise)
        # i == 0 (t_hi == t*): the deployment init, whose noise is the measurement's
        x_init = _bc(torch.sqrt(self._alpha_at(t_hi)), ndim) * y
        x = torch.where(_bc(i == 0, ndim), x_init, x_marginal)
        clip = eng.ddim_clip_x_start
        with torch.no_grad():  # the teacher's two deployed steps t_hi -> t_mid -> t_lo
            p1 = teacher.model_predictions(x, t_hi, y, clip_x_start=clip)
            x_mid = self._ddim_to(p1.pred_x_start, p1.pred_noise, t_mid, ndim)
            p2 = teacher.model_predictions(x_mid, t_mid, y, clip_x_start=clip)
            x_tgt = self._ddim_to(p2.pred_x_start, p2.pred_noise, t_lo, ndim)
        # the student's one deployed step t_hi -> t_lo, matched in x-space
        # (the PD paper's solved target is ill-conditioned on this truncated
        # high-SNR grid; see the JAX distiller)
        p_s = eng.model_predictions(x, t_hi, y, clip_x_start=clip)
        x_next = self._ddim_to(p_s.pred_x_start, p_s.pred_noise, t_lo, ndim)
        per = (x_next - x_tgt).square().reshape(x0.shape[0], -1).mean(dim=1)
        denom = torch.clamp(weights.sum(), min=1.0) if denom is None else max(denom, 1.0)
        return (per * weights).sum() / denom

    def _batch_loss(self, data, target, generator, i=None, noise=None) -> torch.Tensor:
        """The loss of a (noisy, clean) numpy batch on this rank: the whole
        batch, or with a mesh this rank's part of it."""
        if not parallel.sharded(self.mesh):
            y, x0 = (to_device(torch.from_numpy(np.ascontiguousarray(a)), self.device)
                     for a in (data, target))
            if i is None:
                i, noise = self.draws(y.shape[0], x0.shape, generator)
            return self.loss(y, x0, torch.ones(y.shape[0], device=self.device), i, noise)
        if i is not None:
            raise ValueError("a sharded step draws from its generator; pass no i or noise")
        rows, y, x0, w = parallel.shard_rows(self.mesh, data, target)
        i, noise = self.draws(y.shape[0], x0.shape, generator, rows=rows)
        return self.loss(y, x0, w, i, noise, denom=float(rows[1]))

    def step(self, data, target, generator: Optional[torch.Generator] = None, *, i=None,
             noise=None) -> torch.Tensor:
        """One Adam step of the student on a (noisy, clean) batch, its draws
        from `generator` unless given; returns the batch's loss as a device
        scalar."""
        self.optimizer.zero_grad(set_to_none=True)
        loss = self._batch_loss(data, target, generator, i, noise)
        loss.backward()
        if parallel.sharded(self.mesh):
            loss = parallel.reduce_step(self.mesh, self.model.parameters(), loss)
        self.optimizer.step()
        return loss.detach()

    @torch.no_grad()
    def eval_loss(self, data, target, generator: torch.Generator) -> torch.Tensor:
        loss = self._batch_loss(data, target, generator).reshape(1)
        parallel.all_reduce_(self.mesh, [loss])
        return loss[0]

    # ------------------------------------------------------------------- fit
    def fit(self, train_loader, val_loader, *, steps: int, seed: int = 0,
            logger: Optional[MetricLogger] = None) -> Tuple[dict, float]:
        """Train the student (init = the teacher, frozen from the model as
        it stands) for `steps` optimizer steps. Returns (the best student's
        state dict, its val loss); best is tracked by the distillation loss
        on the val split at the end of each data epoch."""
        self.freeze_teacher()
        self.model.train()
        logger = logger if parallel.is_main(self.mesh) else None
        best_val, best_student = float("inf"), None
        step = epoch = 0
        while step < steps:
            epoch += 1
            t0 = time.time()
            losses, sizes = [], []
            for data, target, _, _ in train_loader:
                if step >= steps:
                    break
                losses.append(self.step(data, target, step_generator(seed, step)))
                sizes.append(data.shape[0])
                step += 1
            train_loss = Trainer._weighted_mean(losses, sizes)
            losses, sizes = [], []
            for i, (data, target, _, _) in enumerate(val_loader):
                losses.append(self.eval_loss(data, target,
                                             step_generator(seed, VAL_SEED_OFFSET + i)))
                sizes.append(data.shape[0])
            val_loss = Trainer._weighted_mean(losses, sizes)
            if val_loss < best_val:
                best_val = val_loss
                best_student = {k: v.detach().clone() for k, v in self.model.state_dict().items()}
            if logger:
                logger.log({"stage_steps": self.student_steps, "epoch": epoch, "step": step,
                            "distill/train_loss": train_loss, "distill/val_loss": val_loss,
                            "epoch_seconds": time.time() - t0})
        if best_student is None:
            best_student = {k: v.detach().clone() for k, v in self.model.state_dict().items()}
        return best_student, best_val
