"""The training loop, on one device or data-parallel across processes
(port of hicdiff_tpu/train/trainer.py).

Any engine mode and any backbone of the registry: Adam at lr 2e-5 with
optax's defaults (b1 0.9, b2 0.999, eps 1e-8), the L2
noise-prediction loss of `GaussianDiffusion.p_losses` as the mean over a
batch's samples, an optional EMA of the parameters, and best/final
checkpoints in the JAX trainer's msgpack layout, so either package resumes
the other's. What differs from the JAX trainer:

  * without a mesh, one device: a ragged last batch runs at its own size,
    as eager PyTorch recompiles nothing, so no padding or weight mask is
    needed; the loss is the mean over the real samples, which is what the
    JAX trainer's masked weighted mean computes;
  * with a mesh (`parallel.mesh.make_mesh`, one process a rank) of more
    than one rank, the JAX trainer's data-parallel step: the global batch
    is padded to a multiple of the world size with weight-0 rows, each rank
    takes its rows, draws what the one-process step draws for the whole
    batch's real rows and keeps its own, adds its part of
    sum(per * w) / max(sum(w), 1), and the gradients and the loss are
    summed over the ranks before Adam, so params, Adam state and EMA stay
    equal on every rank; rank 0 alone writes checkpoints and logs, and a
    resume broadcasts what rank 0 read. A mesh of one rank is the
    one-device step, bit for bit, with no collective call;
  * per-step randomness (the step's timesteps, sr3 levels and noise)
    comes from a CPU `torch.Generator` seeded by (seed, step), and the val
    batches' from
    (seed, 10_000_000 + step + i), as the JAX trainer folds those numbers
    into its key: a resumed run draws what the uninterrupted run would;
  * the step's losses stay on the device and are reduced once per epoch.
"""
from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from hicdiff_tpu_torch.convert import (
    adam_state_from_jax,
    adam_state_to_jax,
    params_from_jax,
    params_to_jax,
)
from hicdiff_tpu_torch.diffusion.gaussian import GaussianDiffusion, to_device
from hicdiff_tpu_torch.parallel import mesh as parallel
from hicdiff_tpu_torch.train.checkpoint import checkpoint_name, load_checkpoint, save_checkpoint
from hicdiff_tpu_torch.train.logging import MetricLogger

__all__ = ["Trainer", "step_generator"]

VAL_SEED_OFFSET = 10_000_000


def step_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of one step's draws, seeded by (seed, step)."""
    state = np.random.SeedSequence((seed, step)).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state))


class Trainer:
    """Diffusion trainer bound to an engine; the model's parameters are
    trained in place."""

    def __init__(self, engine: GaussianDiffusion, lr: float = 2e-5, ema_decay: float = 0.0,
                 mesh: Optional[parallel.Mesh] = None):
        """ema_decay > 0 keeps an exponential moving average of the
        parameters, saved with the checkpoints (off by default, as in the
        JAX trainer and the reference, which has none). mesh: this rank's
        data-parallel world; the model, on the mesh's device, starts from
        rank 0's parameters."""
        self.engine = engine
        self.model = engine.model
        self.device = next(self.model.parameters()).device
        self.mesh = mesh
        if mesh is not None and self.device != mesh.device:
            raise ValueError(f"the model is on {self.device}, the mesh's rank on {mesh.device}")
        self.ema_decay = ema_decay
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=lr, betas=(0.9, 0.999),
                                          eps=1e-8)
        parallel.replicate(mesh, self.model)
        self.ema = self._param_copies() if ema_decay > 0 else None
        self.history: list[dict] = []
        # CUDA-event quadruples (start, loss, grads, update) of each step
        # while `time_steps` is True and the model is on CUDA
        self.time_steps = False
        self.step_events: list = []

    # ------------------------------------------------------------- state
    def _param_copies(self) -> dict:
        return {n: p.detach().clone() for n, p in self.model.named_parameters()}

    def _adam_moments(self) -> tuple[dict, dict, int]:
        """(mu, nu, count) of the optimizer; zeros and 0 before a step."""
        mu, nu, count = {}, {}, 0
        for name, p in self.model.named_parameters():
            state = self.optimizer.state.get(p)
            if state:
                mu[name], nu[name] = state["exp_avg"], state["exp_avg_sq"]
                count = int(state["step"])
            else:
                mu[name] = nu[name] = torch.zeros_like(p)
        return mu, nu, count

    def _load_adam(self, mu: dict, nu: dict, count: int) -> None:
        sd = self.optimizer.state_dict()
        names = [name for name, _ in self.model.named_parameters()]
        sd["state"] = {} if count == 0 else {
            i: {"step": torch.tensor(float(count)), "exp_avg": mu[name], "exp_avg_sq": nu[name]}
            for i, name in enumerate(names)
        }
        self.optimizer.load_state_dict(sd)

    def snapshot(self, step: int) -> dict:
        """A device-side copy of everything a checkpoint holds."""
        mu, nu, count = self._adam_moments()
        return dict(
            params=self._param_copies(), mu={n: t.clone() for n, t in mu.items()},
            nu={n: t.clone() for n, t in nu.items()}, count=count, step=step,
            ema=None if self.ema is None else {n: t.clone() for n, t in self.ema.items()},
        )

    def live_state(self, step: int) -> dict:
        """`snapshot` without the copies, for a checkpoint written now."""
        mu, nu, count = self._adam_moments()
        params = {n: p.detach() for n, p in self.model.named_parameters()}
        return dict(params=params, mu=mu, nu=nu, count=count, step=step, ema=self.ema)

    @staticmethod
    def save(path: str, state: dict, run_config: Optional[dict] = None) -> None:
        """Write a `snapshot`/`live_state` as the JAX trainer's checkpoint:
        {params, opt_state (optax's Adam layout), step, ema_params}."""
        save_checkpoint(
            path, params_to_jax(state["params"]),
            adam_state_to_jax(state["mu"], state["nu"], state["count"]), state["step"],
            ema_params=None if state["ema"] is None else params_to_jax(state["ema"]),
            run_config=run_config,
        )

    def resume(self, path: str) -> int:
        """Load params and Adam state from a checkpoint of either package;
        returns its step, the `start_step` of `fit`. The EMA restarts from
        the params when `fit` starts, as in the JAX trainer. With a mesh,
        rank 0 reads the file and broadcasts what it read."""
        step = 0
        if parallel.is_main(self.mesh):
            ck = load_checkpoint(path, only={"params", "opt_state", "step"})
            self.model.load_state_dict(params_from_jax(ck["params"]))
            if ck.get("opt_state"):
                self._load_adam(*adam_state_from_jax(ck["opt_state"]))
            step = int(ck.get("step") or 0)
        if not parallel.sharded(self.mesh):
            return step
        parallel.replicate(self.mesh, self.model, self.optimizer)
        count = torch.tensor([float(step)], device=self.device)
        torch.distributed.broadcast(count, src=0, group=self.mesh.group)
        return int(count.item())

    # -------------------------------------------------------------- steps
    def _loss(self, data, target, generator, t, noise, level=None) -> torch.Tensor:
        """The mean loss of a (data, target) batch of numpy arrays or tensors.
        The conditioned engines (cond, sr3) read `data` as the conditioning
        input; the unconditional engine trains on the clean targets alone
        (trainer.py:65,106 of the JAX package)."""
        def put(a):
            return to_device(a if isinstance(a, torch.Tensor)
                             else torch.from_numpy(np.ascontiguousarray(a)), self.device)

        cond = put(data) if self.engine.mode != "uncond" else None
        return self.engine.p_losses(cond, put(target), generator=generator, t=t, noise=noise,
                                    level=level)

    def _shard_loss(self, data, target, generator) -> torch.Tensor:
        """This rank's part of the global batch's weighted mean loss: the
        batch padded to a multiple of the world size, the rank's rows, their
        draws those of the whole batch (`p_losses(rows=)`)."""
        rows, data, target, weights = parallel.shard_rows(self.mesh, data, target)
        cond = data if self.engine.mode != "uncond" else None
        per = self.engine.p_losses(cond, target, generator=generator, reduce=False, rows=rows)
        return (per * weights).sum() / max(rows[1], 1)

    def _event(self, events: Optional[list]) -> None:
        if events is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)

    def train_step(self, data, target, *, generator: Optional[torch.Generator] = None,
                   t=None, noise=None, level=None) -> torch.Tensor:
        """One Adam step (and EMA update) on a (data, target) batch, NHWC:
        the conditioning noisy patches (read by the cond and sr3 engines)
        and the clean targets. The step's draws (timesteps, sr3 levels,
        noise) come from `generator`, unless given. Returns the
        loss as a device scalar; nothing waits for the device."""
        events = [] if self.time_steps and self.device.type == "cuda" else None
        self._event(events)
        self.optimizer.zero_grad(set_to_none=True)
        if parallel.sharded(self.mesh):
            if t is not None or noise is not None or level is not None:
                raise ValueError("a sharded step draws from its generator; pass no t, noise "
                                 "or level")
            loss = self._shard_loss(data, target, generator)
        else:
            loss = self._loss(data, target, generator, t, noise, level)
        self._event(events)
        loss.backward()
        if parallel.sharded(self.mesh):  # the whole batch's gradient and loss, on every rank
            loss = parallel.reduce_step(self.mesh, self.model.parameters(), loss)
        self._event(events)
        self.optimizer.step()
        if self.ema is not None:
            with torch.no_grad():
                ema = list(self.ema.values())
                torch._foreach_mul_(ema, self.ema_decay)
                torch._foreach_add_(ema, [p.detach() for p in self.model.parameters()],
                                    alpha=1.0 - self.ema_decay)
        self._event(events)
        if events is not None:
            self.step_events.append(events)
        return loss.detach()

    @torch.no_grad()
    def eval_loss(self, data, target, *, generator: torch.Generator) -> torch.Tensor:
        """The loss of a batch without a step, as a device scalar (with a
        mesh, the weighted sum over the ranks)."""
        if not parallel.sharded(self.mesh):
            return self._loss(data, target, generator, None, None)
        loss = self._shard_loss(data, target, generator).reshape(1)
        parallel.all_reduce_(self.mesh, [loss])
        return loss[0]

    def step_times_ms(self) -> list[tuple[float, float, float]]:
        """(loss forward, backward, update) ms of each timed step, by CUDA events."""
        torch.cuda.synchronize(self.device)
        return [(a.elapsed_time(b), b.elapsed_time(c), c.elapsed_time(d))
                for a, b, c, d in self.step_events]

    @staticmethod
    def _weighted_mean(losses: list, sizes: list) -> float:
        if not losses:
            return 0.0
        w = torch.tensor(sizes, dtype=torch.float32, device=losses[0].device)
        return float(torch.stack(losses) @ w) / max(sum(sizes), 1)

    # --------------------------------------------------------------- fit
    def fit(
        self,
        train_loader,
        val_loader,
        *,
        epochs: int,
        seed: int = 0,
        logger: Optional[MetricLogger] = None,
        ckpt_dir: Optional[str] = None,
        ckpt_tag: str = "HiCedrn_cond_l2_lin",
        ckpt_meta: Optional[dict] = None,
        log_every: int = 0,
        start_step: int = 0,
        ckpt_throttle_s: float = 0.0,
        run_config: Optional[dict] = None,
    ) -> float:
        """The epoch loop with best/final checkpoints (train.py:109-190).
        Returns the best val loss. start_step: the resume counter, which
        keeps the step draws those of the uninterrupted run.
        ckpt_throttle_s: least seconds between best-checkpoint writes; the
        best state is kept on the device and always written at the end.
        With a mesh, every rank runs the loop and rank 0 alone keeps the
        best state, writes the checkpoints and logs."""
        best_loss = float("inf")
        best_state = None
        last_ckpt_time = 0.0
        meta = ckpt_meta or {}
        step = start_step
        if self.ema is not None:
            self.ema = self._param_copies()
        ckpt_dir = ckpt_dir if parallel.is_main(self.mesh) else None
        logger = logger if parallel.is_main(self.mesh) else None

        def write_best():
            if ckpt_dir and best_state is not None:
                self.save(os.path.join(ckpt_dir, checkpoint_name("bestg", tag=ckpt_tag, **meta)),
                          best_state, run_config)

        for epoch in range(1, epochs + 1):
            t0 = time.time()
            losses, sizes = [], []
            for data, target, _, _ in train_loader:
                loss = self.train_step(data, target, generator=step_generator(seed, step))
                losses.append(loss)
                sizes.append(data.shape[0])
                step += 1
                if log_every and step % log_every == 0 and logger:
                    logger.log({"step": step, "train/step_loss": float(loss)})
            train_loss = self._weighted_mean(losses, sizes)

            losses, sizes = [], []
            for i, (data, target, _, _) in enumerate(val_loader):
                losses.append(self.eval_loss(
                    data, target, generator=step_generator(seed, VAL_SEED_OFFSET + step + i)))
                sizes.append(data.shape[0])
            val_loss = self._weighted_mean(losses, sizes)

            if val_loss < best_loss:
                best_loss = val_loss
                best_state = self.snapshot(step) if ckpt_dir else None
                now = time.time()
                if now - last_ckpt_time >= ckpt_throttle_s:
                    write_best()
                    last_ckpt_time = now
            record = {"Epoch": epoch, "train/loss": train_loss, "valid/loss": val_loss,
                      "epoch_seconds": time.time() - t0}
            self.history.append(record)
            if logger:
                logger.log(record)
        write_best()  # the true best always lands on disk
        if ckpt_dir:
            self.save(os.path.join(ckpt_dir, checkpoint_name("finalg", tag=ckpt_tag, **meta)),
                      self.live_state(step), run_config)
        return best_loss
