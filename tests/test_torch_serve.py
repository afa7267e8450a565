"""The port's serving daemon and checkpoint reader against the JAX package's.

A checkpoint written by hicdiff_tpu.train.checkpoint.save_checkpoint is
served by both DenoiseServices in the deterministic truncated-DDIM
configuration (eta=0), and one `denoise` request must give the same array.
Tiny backbone (2 blocks, 16 features), T=8, 64x64 patches, on the CPU.
"""
import json
import os
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest
from flax import serialization

from hicdiff_tpu.diffusion.gaussian import GaussianDiffusion as JaxGaussianDiffusion
from hicdiff_tpu.models.hicedrn import HicedrnDiff as JaxHicedrnDiff
from hicdiff_tpu.serve import DenoiseService as JaxDenoiseService
from hicdiff_tpu.train.checkpoint import save_checkpoint
from hicdiff_tpu_torch.serve import DenoiseService, request, serve_forever
from hicdiff_tpu_torch.train.checkpoint import load_checkpoint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVICE = dict(sigma=0.1, schedule="sigmoid", timesteps=8, t_start=2, batch=4,
               bf16=False, blocks=2, features=16)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A JAX checkpoint with params, EMA params and a run_config."""
    model = JaxHicedrnDiff(self_condition=True, number_resnet=2, features=16)
    engine = JaxGaussianDiffusion.create(
        model, image_size=64, timesteps=8, beta_schedule="sigmoid", mode="cond"
    )
    params = engine.init_params(jax.random.PRNGKey(0))
    ema = jax.tree.map(lambda p: p * 0.5, params)
    path = str(tmp_path_factory.mktemp("ck") / "ck.msgpack")
    save_checkpoint(path, params, step=3, ema_params=ema, run_config=dict(
        sigma=0.1, schedule="sigmoid", mode="cond", timestep=8, percentile=99.0,
    ))
    return path


def _patches(seed, n=3):
    rng = np.random.default_rng(seed)
    return np.clip(rng.normal(0, 0.3, (n, 1, 64, 64)), -1, 1).astype(np.float32)


@pytest.mark.parametrize("use_ema", [False, True], ids=["params", "ema_params"])
def test_denoise_matches_jax_service_on_jax_checkpoint(checkpoint, use_ema):
    kw = dict(SERVICE, sampling_steps=2, use_ema=use_ema, warmup=False)
    want = JaxDenoiseService(checkpoint, scan_chunk=0, **kw).denoise_patches(_patches(0))
    port = DenoiseService(checkpoint, device="cpu", **kw)
    got = port.denoise_patches(_patches(0))
    assert got.shape == want.shape == (3, 1, 64, 64)
    assert np.abs(got - want).max() <= 1e-4


def test_load_checkpoint_matches_flax_restore(checkpoint):
    with open(checkpoint, "rb") as f:
        want = serialization.msgpack_restore(f.read())
    got = load_checkpoint(checkpoint)
    assert set(got) == set(want) and got["step"] == 3
    assert got["run_config"] == want["run_config"]
    for a, b in zip(jax.tree.leaves(got["params"]), jax.tree.leaves(want["params"])):
        np.testing.assert_array_equal(a, b)
    partial = load_checkpoint(checkpoint, only={"params", "run_config"})
    assert set(partial) == {"params", "run_config"}


def test_load_checkpoint_joins_chunked_leaves(tmp_path, monkeypatch):
    """Leaves over flax's chunk size are stored as chunk maps; the reader
    joins them back (shrunk chunk size, so the test stays small)."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    tree = {"params": {"w": np.arange(100, dtype=np.float32).reshape(4, 25)}, "step": 1}
    path = tmp_path / "chunked.msgpack"
    path.write_bytes(serialization.msgpack_serialize(tree))
    got = load_checkpoint(str(path))
    np.testing.assert_array_equal(got["params"]["w"], tree["params"]["w"])


def test_percentile_adoption(checkpoint):
    """None adopts the checkpoint's stored percentile; an explicit value wins."""
    kw = dict(SERVICE, device="cpu", warmup=False)
    assert DenoiseService(None, **kw).percentile == 99.99
    assert DenoiseService(checkpoint, **kw).percentile == 99.0
    assert DenoiseService(checkpoint, percentile=98.5, **kw).percentile == 98.5


@pytest.fixture(scope="module")
def service():
    return DenoiseService(None, device="cpu", warmup=True, **SERVICE)


@pytest.fixture()
def server(service, tmp_path):
    sock = str(tmp_path / "port.sock")
    thread = threading.Thread(target=serve_forever, args=(service, sock), daemon=True)
    thread.start()
    for _ in range(200):
        if os.path.exists(sock):
            break
        time.sleep(0.05)
    yield sock
    request(sock, {"id": -1, "op": "shutdown"})
    thread.join(timeout=10)
    assert not thread.is_alive()


def test_server_protocol(server, tmp_path):
    resp = request(server, {"id": 7, "op": "ping"})
    assert resp["ok"] and resp["id"] == 7 and resp["t_start"] == 2 and resp["mode"] == "cond"
    x = _patches(1)
    src = str(tmp_path / "noisy.npy")
    np.save(src, x)
    resp = request(server, {"id": 8, "op": "denoise", "npy": src})
    assert resp["ok"] and resp["n_patches"] == 3, resp
    out = np.load(resp["out"])
    assert out.shape == x.shape and np.isfinite(out).all() and np.abs(out).max() <= 1.0
    resp = request(server, {"id": 9, "op": "nope"})
    assert not resp["ok"] and "unknown op" in resp["error"]
    resp = request(server, {"id": 10, "op": "denoise", "npy": str(tmp_path / "absent.npy")})
    assert not resp["ok"]  # a served error; the daemon stays up
    resp = request(server, {"id": 11, "op": "denoise_mcool", "mcool": "x.mcool"})
    assert not resp["ok"] and "NotImplementedError" in resp["error"]
    assert request(server, {"id": 12, "op": "ping"})["ok"]


def test_cli_client_roundtrip(server):
    proc = subprocess.run(
        [sys.executable, "serve_torch.py", "--client", "--socket", server,
         "--request", json.dumps({"id": 1, "op": "ping"})],
        capture_output=True, text=True, cwd=ROOT, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip())["ok"]


def test_denoise_layouts_and_padding(service):
    """NCHW and NHWC inputs that are not a multiple of the batch come back in
    their own layout."""
    x = _patches(2, n=6)
    out = service.denoise_patches(x)
    assert out.shape == x.shape and np.isfinite(out).all()
    nhwc = np.transpose(x, (0, 2, 3, 1))
    assert service.denoise_patches(nhwc).shape == nhwc.shape


def test_service_rejects_what_is_not_ported(service):
    with pytest.raises(ValueError, match="ddrm"):
        service.denoise_patches(np.zeros((2, 64 * 64), np.float32))
    with pytest.raises(NotImplementedError, match="ddrm"):
        DenoiseService(None, device="cpu", mode="ddrm", warmup=False, **SERVICE)
