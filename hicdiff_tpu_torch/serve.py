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
`denoise_mcool` reads and writes .mcool files with h5py (imported when the
op runs).
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
    ):
        from hicdiff_tpu_torch.diffusion.gaussian import GaussianDiffusion
        from hicdiff_tpu_torch.models.hicedrn import HicedrnDiff

        if mode not in ("cond", "ddrm"):
            raise ValueError(f"mode must be 'cond' or 'ddrm', got {mode!r}")
        self.mode = mode
        self.deg = deg
        self.device = torch.device(device)
        self.sigma = float(sigma)
        # inputs must be normalised at the percentile the checkpoint saw:
        # None adopts the checkpoint's stored value (else train.py's 99.99);
        # an explicit value wins, with a warning if it contradicts the
        # checkpoint's run_config
        requested_pct = None if percentile is None else float(percentile)
        self.percentile = 99.99 if requested_pct is None else requested_pct
        self.batch = int(batch)
        self._seed = int(seed)
        self._count = 0
        self._generator = torch.Generator().manual_seed(int(seed))
        # one device user at a time, re-entrant so handle() -> denoise_patches
        # keeps one acquisition; direct embedders get the same guarantee
        self._lock = threading.RLock()

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
            # a measurement-shaped batch
            self.denoise_patches(np.zeros((1, self._meas_dim), np.float32) if mode == "ddrm"
                                 else np.zeros((1, 64, 64, 1), np.float32))

    def _restore(self, y: torch.Tensor) -> torch.Tensor:
        """One ddrm batch, its draws from a generator on the device seeded by
        (seed, the service's batch count)."""
        seed = np.random.SeedSequence((self._seed, self._count)).generate_state(1, np.uint64)[0]
        self._count += 1
        return self.restorer(y, torch.Generator(device=self.device).manual_seed(int(seed)))

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
                inp = torch.from_numpy(np.ascontiguousarray(chunk)).to(self.device)
                out = (self._restore(inp) if self.mode == "ddrm"
                       else self.engine.super_resolution(inp, self._generator))
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
            from hicdiff_tpu_torch.kernels.resblock import fused_resblock
            from hicdiff_tpu_torch.kernels.sample_step import fused_posterior_step

            return {"id": rid, "ok": True, "op": "ping", "mode": self.mode,
                    "t_start": self.t_start, "batch": self.batch,
                    "device": str(self.device),
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
