"""Serving: a persistent denoising daemon over a Unix socket.

Port of hicdiff_tpu/serve.py. One resident process owns the device: the
model is built and loaded once at startup (and the kernels are built by the
warm-up request), then newline-delimited JSON requests are answered by a
single device lock in arrival order, each padded to the fixed service batch.
`mode="cond"` runs the conditional sampler on noisy patches; `mode="ddrm"`
the unconditional model in the DDRM sampler (the -u 1 path) on the
measurements of `deg`'s operator, at the linear 1000-step betas.

Protocol (one JSON object per line, the response mirrors the request `id`):

  {"id": 1, "op": "ping"}                        # also the process's kernel launches
  {"id": 2, "op": "denoise", "npy": "/path/noisy.npy",
   "out": "/path/denoised.npy"}                  # (n,1,64,64) or NHWC, [-1,1];
                                                 # ddrm also (n, M) measurements
  {"id": 3, "op": "denoise_mcool", "mcool": "/path/cell.mcool",
   "out_mcool": "/path/denoised.mcool", "res": 40000, "chro": "all"}
  {"id": 4, "op": "shutdown"}

Responses: {"id", "ok": true, ...} or {"id", "ok": false, "error": "..."}.
`denoise_mcool` reads and writes .mcool files through the port's HDF5
reader and writer (`data/hdf5.py`).

Over several GPUs (a `parallel.mesh.Mesh`, one process a rank; the JAX
daemon shards its service batch over the chips) only rank 0 listens on
the socket. The service batch is rounded up to a multiple of the world
size; for each padded chunk that `denoise_patches` sends to the device,
rank 0 broadcasts a header (run, the chunk's shape, the DDRM batch count)
and then the chunk and the conditional sampler's generator state, and
every rank samples its rows of the chunk (`run_sharded`: each draws what
a one-rank service at this batch draws for the whole chunk, and keeps its
rows). The other ranks wait in `follow()` for those broadcasts; an idle
rank 0 sends a no-op header every KEEPALIVE_S, so that wait stays inside
the process group's timeout; `shutdown` sends stop and every rank exits.
A failed collective (a rank died or hung past the timeout) leaves the
ranks out of step: it is not answered as a request's error but ends
`serve_forever` with `ShardError`.
"""
from __future__ import annotations

import dataclasses
import json
import os
import socket
import socketserver
import threading
import time
from typing import Optional

import numpy as np
import torch

__all__ = ["DenoiseService", "ShardError", "serve_forever", "request", "KEEPALIVE_S"]

KEEPALIVE_S = 30.0  # the longest an idle rank 0 leaves the followers waiting
_STOP, _RUN, _NOOP = 0, 1, 2  # the header's op


class ShardError(RuntimeError):
    """A sharded chunk failed after rank 0 announced it: the ranks are out of
    step, so the daemon stops rather than answer the next request."""


class DenoiseService:
    """Resident denoising engine: build/load/warm once, then
    `denoise_patches` at steady state on `device` (no fallback: a CUDA
    device that is absent raises). With a mesh of more than one rank every
    rank builds the service (on the mesh's device); rank 0 serves and the
    others call `follow()`."""

    def __init__(
        self,
        weights: Optional[str] = None,
        *,
        device: torch.device | str,
        mode: str = "cond",
        deg: str = "deno",
        sigma: float = 0.1,
        percentile: Optional[float] = None,
        schedule: str = "sigmoid",
        timesteps: int = 1000,
        t_start: str | int | None = "auto",
        sampling_steps: Optional[int] = None,
        batch: int = 32,
        bf16: bool = True,
        blocks: int = 32,
        features: int = 256,
        use_ema: bool = False,
        seed: int = 0,
        warmup: bool = True,
        mesh=None,
    ):
        from hicdiff_tpu_torch.diffusion.gaussian import GaussianDiffusion
        from hicdiff_tpu_torch.models.hicedrn import HicedrnDiff

        if mode not in ("cond", "ddrm"):
            raise ValueError(f"mode must be 'cond' or 'ddrm', got {mode!r}")
        self.mode = mode
        self.deg = deg
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else torch.device(device)
        self.sigma = float(sigma)
        # inputs must be normalised at the percentile the checkpoint saw:
        # None adopts the checkpoint's stored value (else train.py's 99.99);
        # an explicit value wins, with a warning if it contradicts the
        # checkpoint's run_config
        requested_pct = None if percentile is None else float(percentile)
        self.percentile = 99.99 if requested_pct is None else requested_pct
        world = 1 if mesh is None else mesh.world_size
        # the sharded batch must split evenly over the ranks
        self.batch = -(-int(batch) // world) * world
        self._seed = int(seed)
        self._count = 0
        self._generator = torch.Generator().manual_seed(int(seed))
        # one device user at a time, re-entrant so handle() -> denoise_patches
        # keeps one acquisition; direct embedders get the same guarantee
        self._lock = threading.RLock()
        self._last_sent = time.monotonic()

        model = HicedrnDiff(
            self_condition=(mode == "cond"),
            dtype=torch.bfloat16 if bf16 else None,
            number_resnet=blocks,
            features=features,
            device=self.device,
            generator=torch.Generator().manual_seed(int(seed)),
        )
        self.engine = None
        self.t_start = None
        if mode == "cond":
            engine = GaussianDiffusion.create(
                model, device=self.device, timesteps=timesteps,
                beta_schedule=schedule, sampling_timesteps=sampling_steps,
            )
            if t_start is not None and str(t_start) not in ("full", "none"):
                ts = (engine.truncation_timestep(max(self.sigma, 1e-4))
                      if str(t_start) == "auto" else int(t_start))
                engine = dataclasses.replace(engine, t_start=ts)
            self.engine = engine
            self.t_start = engine.t_start
        else:  # the -u 1 configuration of inference.py
            from hicdiff_tpu_torch.sampling.ddrm import DDRMRestorer

            self.restorer = DDRMRestorer(lambda x, t: model(x, t, None), deg, self.sigma,
                                         device=self.device, t_start=t_start,
                                         sampling_steps=sampling_steps or timesteps)
            self.t_start = self.restorer.t_start
            # the operator's measurement width (for sr/cs/inp it is not the
            # image's): the warm-up's shape and the check of every request
            self._meas_dim = self.restorer.measurement_width()

        if weights is not None:
            from hicdiff_tpu_torch.convert import params_from_jax
            from hicdiff_tpu_torch.train.checkpoint import (
                load_checkpoint,
                warn_run_config_mismatch,
            )

            ck = load_checkpoint(
                weights,
                only={"params", "run_config"} | ({"ema_params"} if use_ema else set()),
            )
            # ddrm always runs the linear betas: compare with what runs
            expect = dict(sigma=sigma, schedule=schedule if mode == "cond" else "linear",
                          mode="cond" if mode == "cond" else "uncond", timestep=timesteps)
            if requested_pct is not None:
                expect["percentile"] = requested_pct
            warn_run_config_mismatch(ck, expect, weights)
            stored_pct = (ck.get("run_config") or {}).get("percentile")
            if requested_pct is None and stored_pct is not None:
                self.percentile = float(stored_pct)
            params = ck.get("ema_params") if use_ema and ck.get("ema_params") else ck["params"]
            model.load_state_dict(params_from_jax(params))
        model.eval()

        if warmup:
            # builds the CUDA kernels and warms the libraries; ddrm warms with
            # a measurement-shaped batch (one chunk, which a follower takes)
            if self._follower:
                self._follow_chunk()
            else:
                self.denoise_patches(np.zeros((1, self._meas_dim), np.float32)
                                     if mode == "ddrm" else np.zeros((1, 64, 64, 1), np.float32))

    @property
    def _follower(self) -> bool:
        return self.mesh is not None and self.mesh.rank != 0

    @property
    def _sharded(self) -> bool:
        return self.mesh is not None and self.mesh.world_size > 1

    def _sample(self, chunk: np.ndarray) -> torch.Tensor:
        """One padded chunk through the sampler, by rows over the mesh's
        ranks. ddrm draws from a generator on the device seeded by (seed,
        the service's batch count); cond from the service's generator."""
        from hicdiff_tpu_torch.parallel.mesh import run_sharded

        if self.mode == "ddrm":
            from hicdiff_tpu_torch.sampling.ddrm import generator_noise

            seed = np.random.SeedSequence((self._seed, self._count)).generate_state(
                1, np.uint64)[0]
            self._count += 1
            gen = torch.Generator(device=self.device).manual_seed(int(seed))

            def fn(y, rows):
                return self.restorer(y, None, noise=generator_noise(gen, self.device, rows))
        else:
            def fn(x, rows):
                return self.engine.super_resolution(x, self._generator, rows=rows)
        if self.mesh is None:
            return fn(torch.from_numpy(np.ascontiguousarray(chunk)).to(self.device), None)
        return run_sharded(self.mesh, fn, chunk)

    def _announce(self, op: int, chunk: Optional[np.ndarray] = None) -> None:
        """Rank 0: the header, then the chunk and the cond generator's state."""
        from hicdiff_tpu_torch.parallel.mesh import broadcast_array, broadcast_header

        head = [op] if chunk is None else [op, self._count, chunk.ndim, *chunk.shape]
        broadcast_header(self.mesh, head)
        if chunk is not None:
            broadcast_array(self.mesh, chunk, chunk.shape, np.float32)
            if self.mode == "cond":
                state = self._generator.get_state().numpy()
                broadcast_array(self.mesh, state, state.shape, np.uint8)
        self._last_sent = time.monotonic()

    def _lead(self, chunk: np.ndarray) -> torch.Tensor:
        """Rank 0: announce the chunk, then sample its rows."""
        self._announce(_RUN, chunk)
        return self._sample(chunk)

    def _follow_chunk(self) -> bool:
        """A follower: take rank 0's next header and, for a run, its chunk,
        and sample its rows. Returns False on stop."""
        from hicdiff_tpu_torch.parallel.mesh import broadcast_array, broadcast_header

        head = broadcast_header(self.mesh)
        if head[0] == _STOP:
            return False
        if head[0] == _RUN:
            self._count, ndim = head[1], head[2]
            chunk = broadcast_array(self.mesh, None, head[3:3 + ndim], np.float32)
            if self.mode == "cond":
                n = self._generator.get_state().numel()
                self._generator.set_state(torch.from_numpy(
                    broadcast_array(self.mesh, None, (n,), np.uint8)))
            self._sample(chunk)
        return True

    def follow(self) -> None:
        """A follower (a rank other than 0): sample rank 0's chunks until it
        sends stop."""
        if not self._follower:
            raise RuntimeError("follow() runs on the ranks other than 0")
        while self._follow_chunk():
            pass

    def keepalive(self) -> None:
        """Rank 0 of a sharded service: a no-op header when it has sent
        nothing for KEEPALIVE_S and no request holds the device."""
        if not self._sharded or time.monotonic() - self._last_sent < KEEPALIVE_S:
            return
        if self._lock.acquire(blocking=False):
            try:
                self._collective(self._announce, _NOOP)
            finally:
                self._lock.release()

    def stop_followers(self) -> None:
        """Rank 0 of a sharded service: send stop (the followers return
        from `follow()`)."""
        if self._sharded:
            with self._lock:
                self._collective(self._announce, _STOP)

    def _collective(self, fn, *args):
        """fn(*args) on rank 0 of a sharded service; a failure means the
        ranks are out of step and raises ShardError."""
        try:
            return fn(*args)
        except Exception as e:
            raise ShardError(f"a collective of the sharded service failed: "
                             f"{type(e).__name__}: {e}") from e

    def denoise_patches(self, patches: np.ndarray) -> np.ndarray:
        """NHWC or NCHW [-1,1] noisy patches -> denoised, same layout.
        Batches are padded to the fixed service batch; each batch draws
        fresh noise. mode='ddrm' also takes raw measurements as a 2-D
        (n, M) array, M the operator's measurement width, and returns NHWC
        images for them."""
        x = np.asarray(patches, np.float32)
        if x.ndim == 2 and self.mode != "ddrm":
            raise ValueError("2-D measurement input requires mode='ddrm'")
        nchw = x.ndim == 4 and x.shape[1] == 1 and x.shape[-1] != 1
        if nchw:
            x = np.transpose(x, (0, 2, 3, 1))
        outs = []
        with self._lock:
            for lo in range(0, x.shape[0], self.batch):
                chunk = x[lo : lo + self.batch]
                n = chunk.shape[0]
                if n < self.batch:
                    chunk = np.pad(chunk, [(0, self.batch - n)] + [(0, 0)] * (x.ndim - 1))
                if self.mode == "ddrm":
                    # an image-shaped measurement (deno, deblur) in y's layout
                    chunk = chunk.reshape(chunk.shape[0], -1)
                    if chunk.shape[1] != self._meas_dim:
                        raise ValueError(
                            f"operator '{self.deg}' takes measurements of dimension "
                            f"{self._meas_dim}, got {chunk.shape[1]} (image-shaped input "
                            "is a measurement only for image-sized degradations like "
                            "deno/deblur)")
                chunk = np.ascontiguousarray(chunk, np.float32)
                out = (self._collective(self._lead, chunk) if self._sharded
                       else self._sample(chunk))
                outs.append(out[:n].cpu().numpy())
        out = np.concatenate(outs) if outs else x
        return np.transpose(out, (0, 3, 1, 2)) if nchw else out

    # ---- request handlers ------------------------------------------------

    def handle(self, req: dict) -> dict:
        op = req.get("op")
        rid = req.get("id")
        t0 = time.time()
        try:
            with self._lock:
                return self._handle_locked(op, rid, req, t0)
        except ShardError:  # the ranks are out of step: the daemon stops
            raise
        except Exception as e:  # served errors must not kill the daemon
            return {"id": rid, "ok": False, "error": f"{type(e).__name__}: {e}"}

    def _handle_locked(self, op, rid, req: dict, t0) -> dict:
        if op == "ping":
            from hicdiff_tpu_torch.kernels.resblock import fused_resblock
            from hicdiff_tpu_torch.kernels.sample_step import fused_posterior_step

            return {"id": rid, "ok": True, "op": "ping", "mode": self.mode,
                    "t_start": self.t_start, "batch": self.batch,
                    "device": str(self.device),
                    "world_size": 1 if self.mesh is None else self.mesh.world_size,
                    "launches": {"fused_resblock": fused_resblock.launches,
                                 "fused_posterior_step": fused_posterior_step.launches}}
        if op == "denoise":
            x = np.load(req["npy"])
            out = self.denoise_patches(x)
            dst = req.get("out") or (os.path.splitext(req["npy"])[0] + "_denoised.npy")
            np.save(dst, out)
            return {"id": rid, "ok": True, "out": dst, "n_patches": int(x.shape[0]),
                    "elapsed_s": round(time.time() - t0, 3)}
        if op == "denoise_mcool":
            return self._denoise_mcool(req, rid, t0)
        if op == "shutdown":
            self.stop_followers()
            return {"id": rid, "ok": True, "shutdown": True}
        return {"id": rid, "ok": False, "error": f"unknown op {op!r}"}

    def _denoise_mcool(self, req: dict, rid, t0) -> dict:
        """The whole-file flow: .mcool -> normalize and patch (the prep
        path) -> denoise -> reassemble -> denoised .mcool."""
        from hicdiff_tpu_torch.data.assemble import assemble_chromosome, to_unit, write_mcool
        from hicdiff_tpu_torch.data.mcool import McoolFile
        from hicdiff_tpu_torch.data.preprocess import (
            coo_to_dense,
            inject_noise,
            normalize_matrix,
            split_pieces,
        )

        res = int(req.get("res", 40000))
        # the percentile the loaded checkpoint was trained at, by default
        percentile = float(req.get("percentile", self.percentile))
        mc = McoolFile(req["mcool"], res)
        names = mc.chromnames
        if req.get("chro") not in (None, "all"):
            want = str(req["chro"])
            names = [n for n in names if n == want or n == f"chr{want}"]
        mats, sizes = {}, {}
        for ci, name in enumerate(names, start=1):
            px = mc.fetch(name)
            if px.start1.size == 0:
                continue
            dense, _, _ = coo_to_dense(px.start1, px.start2, px.balanced, res)
            norm = normalize_matrix(dense, percentile)
            pieces = split_pieces(norm, piece_size=64, step=64, resol=res)
            if pieces.shape[0] == 0:
                continue
            if req.get("already_noisy", True):
                noisy = pieces  # the file is the measurement (the live case)
            else:  # synthetic degradation, for experiments
                noisy, _ = inject_noise(pieces, req.get("deg", "deno"), self.sigma,
                                        seed=int(req.get("seed", 0)))
            out = self.denoise_patches(noisy)
            mats[ci] = assemble_chromosome(out, norm.shape[0], resol=res)
            sizes[ci] = name
        if not mats:
            return {"id": rid, "ok": False, "error": "no usable chromosomes in input"}
        dst = req.get("out_mcool") or (os.path.splitext(req["mcool"])[0] + "_denoised.mcool")
        write_mcool(dst, res, {c: to_unit(m) for c, m in mats.items()},
                    chrom_names=[sizes[c] for c in sorted(mats)])
        return {"id": rid, "ok": True, "out_mcool": dst,
                "chromosomes": [sizes[c] for c in sorted(mats)],
                "elapsed_s": round(time.time() - t0, 3)}


def serve_forever(service: DenoiseService, socket_path: str) -> None:
    """Accept newline-JSON requests on a Unix socket until a shutdown op.

    Client connections are accepted concurrently, but every request funnels
    through the service's lock, so device work is serialized. A sharded
    service's rank 0 serves here; a failed collective stops the loop and
    raises ShardError (the client of that request gets no answer)."""
    if os.path.exists(socket_path):
        os.unlink(socket_path)
    stop = threading.Event()
    failed = []

    class Handler(socketserver.StreamRequestHandler):
        def handle(self):
            for line in self.rfile:
                line = line.strip()
                if not line:
                    continue
                try:
                    req = json.loads(line)
                except json.JSONDecodeError as e:
                    resp = {"ok": False, "error": f"bad json: {e}"}
                else:
                    try:
                        resp = service.handle(req)
                    except ShardError as e:
                        failed.append(e)
                        stop.set()
                        return
                self.wfile.write((json.dumps(resp) + "\n").encode())
                self.wfile.flush()
                if resp.get("shutdown"):
                    stop.set()
                    return

    class Server(socketserver.ThreadingUnixStreamServer):
        daemon_threads = True

    try:
        with Server(socket_path, Handler) as srv:
            srv.timeout = 0.2
            print(f"hicdiff_tpu_torch serving on {socket_path}", flush=True)
            while not stop.is_set():
                srv.handle_request()
                service.keepalive()
    finally:
        os.unlink(socket_path)
    if failed:
        raise failed[0]


def request(socket_path: str, req: dict, timeout: float = 600.0) -> dict:
    """One-shot client: send a request, return the parsed response."""
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
        s.settimeout(timeout)
        s.connect(socket_path)
        s.sendall((json.dumps(req) + "\n").encode())
        buf = b""
        while not buf.endswith(b"\n"):
            chunk = s.recv(65536)
            if not chunk:
                break
            buf += chunk
    return json.loads(buf.decode())
