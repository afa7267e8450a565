"""Serving: a persistent conditional-denoising daemon over a Unix socket.

Port of hicdiff_tpu/serve.py, `mode="cond"`. One resident process owns the
device: the model is built and loaded once at startup (and the kernels are
built by the warm-up request), then newline-delimited JSON requests are
answered by a single device lock in arrival order, each padded to the fixed
service batch.

Protocol (one JSON object per line, the response mirrors the request `id`):

  {"id": 1, "op": "ping"}
  {"id": 2, "op": "denoise", "npy": "/path/noisy.npy",
   "out": "/path/denoised.npy"}                  # (n,1,64,64) or NHWC, [-1,1]
  {"id": 3, "op": "shutdown"}

Responses: {"id", "ok": true, ...} or {"id", "ok": false, "error": "..."}.
`denoise_mcool` and `mode="ddrm"` are not ported yet.
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

__all__ = ["DenoiseService", "serve_forever", "request"]


class DenoiseService:
    """Resident denoising engine: build/load/warm once, then
    `denoise_patches` at steady state on `device` (no fallback: a CUDA
    device that is absent raises)."""

    def __init__(
        self,
        weights: Optional[str] = None,
        *,
        device: torch.device | str,
        mode: str = "cond",
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
    ):
        from hicdiff_tpu_torch.diffusion.gaussian import GaussianDiffusion
        from hicdiff_tpu_torch.models.hicedrn import HicedrnDiff

        if mode == "ddrm":
            raise NotImplementedError("mode='ddrm' (the -u 1 DDRM path) is not ported yet")
        if mode != "cond":
            raise ValueError(f"mode must be 'cond' or 'ddrm', got {mode!r}")
        self.mode = mode
        self.device = torch.device(device)
        self.sigma = float(sigma)
        # inputs must be normalised at the percentile the checkpoint saw:
        # None adopts the checkpoint's stored value (else train.py's 99.99);
        # an explicit value wins, with a warning if it contradicts the
        # checkpoint's run_config
        requested_pct = None if percentile is None else float(percentile)
        self.percentile = 99.99 if requested_pct is None else requested_pct
        self.batch = int(batch)
        self._generator = torch.Generator().manual_seed(int(seed))
        # one device user at a time, re-entrant so handle() -> denoise_patches
        # keeps one acquisition; direct embedders get the same guarantee
        self._lock = threading.RLock()

        model = HicedrnDiff(
            self_condition=True,
            dtype=torch.bfloat16 if bf16 else None,
            number_resnet=blocks,
            features=features,
            device=self.device,
            generator=torch.Generator().manual_seed(int(seed)),
        )
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
            expect = dict(sigma=sigma, schedule=schedule, mode="cond", timestep=timesteps)
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
            # builds the CUDA kernels and warms the convolution library
            self.denoise_patches(np.zeros((1, 64, 64, 1), np.float32))

    def denoise_patches(self, patches: np.ndarray) -> np.ndarray:
        """NHWC or NCHW [-1,1] noisy patches -> denoised, same layout.
        Batches are padded to the fixed service batch; each batch draws
        fresh noise from the service's generator."""
        x = np.asarray(patches, np.float32)
        if x.ndim == 2:
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
                cond = torch.from_numpy(np.ascontiguousarray(chunk)).to(self.device)
                out = self.engine.super_resolution(cond, self._generator)
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
        except Exception as e:  # served errors must not kill the daemon
            return {"id": rid, "ok": False, "error": f"{type(e).__name__}: {e}"}

    def _handle_locked(self, op, rid, req: dict, t0) -> dict:
        if op == "ping":
            return {"id": rid, "ok": True, "op": "ping", "mode": self.mode,
                    "t_start": self.t_start, "batch": self.batch,
                    "device": str(self.device)}
        if op == "denoise":
            x = np.load(req["npy"])
            out = self.denoise_patches(x)
            dst = req.get("out") or (os.path.splitext(req["npy"])[0] + "_denoised.npy")
            np.save(dst, out)
            return {"id": rid, "ok": True, "out": dst, "n_patches": int(x.shape[0]),
                    "elapsed_s": round(time.time() - t0, 3)}
        if op == "denoise_mcool":
            raise NotImplementedError("denoise_mcool is not ported yet")
        if op == "shutdown":
            return {"id": rid, "ok": True, "shutdown": True}
        return {"id": rid, "ok": False, "error": f"unknown op {op!r}"}


def serve_forever(service: DenoiseService, socket_path: str) -> None:
    """Accept newline-JSON requests on a Unix socket until a shutdown op.

    Client connections are accepted concurrently, but every request funnels
    through the service's lock, so device work is serialized."""
    if os.path.exists(socket_path):
        os.unlink(socket_path)
    stop = threading.Event()

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
                    resp = service.handle(req)
                self.wfile.write((json.dumps(resp) + "\n").encode())
                self.wfile.flush()
                if resp.get("shutdown"):
                    stop.set()
                    return

    class Server(socketserver.ThreadingUnixStreamServer):
        daemon_threads = True

    with Server(socket_path, Handler) as srv:
        srv.timeout = 0.2
        print(f"hicdiff_tpu_torch serving on {socket_path}", flush=True)
        while not stop.is_set():
            srv.handle_request()
    os.unlink(socket_path)


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
