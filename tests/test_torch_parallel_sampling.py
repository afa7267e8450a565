"""Sampling over several ranks on the CPU (gloo): the CLIs and the daemon.

- inference_torch.py -u 0 (truncated chain, the posterior step at each
  rank's offset) and -u 1 (DDRM deno) under torchrun with two ranks against
  the plain one-process run on a 2-block, 16-feature model: the quartet
  within the multihost bars (chain and DDRM outputs 1e-4), written once;
- serve_torch.py with two ranks (rank 0 on the socket) answering `denoise`
  in cond and ddrm modes against a one-rank service at the same batch, then
  `shutdown` ending both ranks with exit code 0; a killed rank ending rank
  0 with an error at its next request instead of a hang.
"""
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from hicdiff_tpu_torch.convert import params_to_jax
from hicdiff_tpu_torch.models.hicedrn import HicedrnDiff
from hicdiff_tpu_torch.parallel import multihost
from hicdiff_tpu_torch.serve import DenoiseService, request
from hicdiff_tpu_torch.train.checkpoint import save_checkpoint
from tests.make_fixture_mcool import make_fixture

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--blocks", "2", "--features", "16"]
TOL = multihost.FP32_TOL


def _env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["OMP_NUM_THREADS"] = "2"
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
                "MASTER_PORT"):
        env.pop(key, None)
    return env


@pytest.fixture(scope="module")
def cell(tmp_path_factory):
    """A fixture cell (22 chromosomes of 128 bins: 12 test patches) and the
    tiny cond and uncond checkpoints."""
    root = tmp_path_factory.mktemp("cell")
    os.makedirs(root / "Datasets" / "Human")
    make_fixture(str(root / "Datasets" / "Human" / "cell1_synth.mcool"),
                 bins_per_chrom=tuple([128] * 22))
    ckpts = {}
    for mode, schedule, seed in (("cond", "sigmoid", 3), ("uncond", "linear", 4)):
        model = HicedrnDiff(self_condition=mode == "cond", number_resnet=2, features=16,
                            device="cpu", generator=torch.Generator().manual_seed(seed))
        ckpts[mode] = str(root / f"{mode}.msgpack")
        save_checkpoint(ckpts[mode], params_to_jax(model.state_dict()), run_config=dict(
            sigma=0.1, schedule=schedule, mode=mode, timestep=1000))
    return root, ckpts


CLI_RUNS = {
    "u0": (["-u", "0", "--schedule", "sigmoid"], "cond", "hicedrn_l2_sigHuman1_deno_0.1_test_cond",
           "sample"),
    "u1": (["-u", "1", "--schedule", "linear", "--deg", "deno"], "uncond",
           "hicedrn_l2_linHuman1_deno_0.1_trans2_1000_ts27", "ddrm"),
}


@pytest.mark.parametrize("run", sorted(CLI_RUNS))
def test_cli_two_ranks_equal_one(cell, run):
    """Two gloo ranks under torchrun against one plain process, batch 5 (a
    batch of 5 rows splits 3 + 2, the second rank's last row padding)."""
    root, ckpts = cell
    flags, mode, outdir, bar = CLI_RUNS[run]
    base = [sys.executable]
    args = ["inference_torch.py", *flags, "-s", "0.1", "--t-start", "auto", "-b", "5",
            "--weights", ckpts[mode], "--root", str(root), "--device", "cpu", *TINY]
    cmds = {"one": base + args + ["--out-tag", "_one"],
            "two": base + ["-m", "torch.distributed.run", "--nproc-per-node", "2",
                           "--master-port", str(multihost.free_port())]
            + args + ["--out-tag", "_two"]}
    quartets, logs = {}, {}
    for tag, cmd in cmds.items():  # "one" first: it prepares the shared cache
        r = subprocess.run(cmd, cwd=REPO, env=_env(), capture_output=True, text=True,
                           timeout=300)
        assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
        logs[tag] = r.stdout
        d = root / "Outputs_diff" / f"{outdir}_{tag}"
        quartets[tag] = {k: np.load(d / f"{k}.npy") for k in ("predict", "target", "noisy",
                                                              "inds")}
    assert logs["two"].count("outputs:") == 1 and logs["two"].count("metrics:") == 1
    assert "rank 0 of 2" in logs["two"] and "rank 1 of 2" in logs["two"]
    one, two = quartets["one"], quartets["two"]
    assert one["predict"].shape == (12, 1, 64, 64)
    for k in ("target", "noisy", "inds"):
        np.testing.assert_array_equal(one[k], two[k])
    assert np.isfinite(two["predict"]).all()
    assert np.abs(one["predict"] - two["predict"]).max() < TOL[bar]


def _daemon(rank, port, sock, flags, log):
    env = _env()
    env.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE="2", LOCAL_WORLD_SIZE="2",
               MASTER_ADDR="localhost", MASTER_PORT=str(port))
    return subprocess.Popen([sys.executable, "serve_torch.py", "--socket", sock,
                             "--device", "cpu", "--dist-backend", "gloo", "--batch", "3",
                             *TINY, *flags], cwd=REPO, env=env, stdout=log,
                            stderr=subprocess.STDOUT)


def _start(tmp_path, flags, tag):
    sock = str(tmp_path / f"{tag}.sock")
    port = multihost.free_port()
    logs = [open(tmp_path / f"{tag}_rank{r}.log", "w") for r in range(2)]
    procs = [_daemon(r, port, sock, flags, logs[r]) for r in range(2)]
    deadline = time.monotonic() + 120
    while not os.path.exists(sock):
        assert time.monotonic() < deadline and all(p.poll() is None for p in procs), \
            [open(tmp_path / f"{tag}_rank{r}.log").read()[-2000:] for r in range(2)]
        time.sleep(0.1)
    return sock, procs


def _stop(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()


SERVE_MODES = {"cond": ["-u", "0"], "ddrm": ["-u", "1", "--deg", "deno"]}


@pytest.mark.parametrize("mode", sorted(SERVE_MODES))
def test_two_rank_daemon_equals_one_rank_service(tmp_path, mode):
    """Requests of 6 and 3 patches (chunks of the service batch 4: 3
    rounded up to the world size) through the two-rank daemon equal a
    one-rank service at batch 4, request by request; shutdown ends both."""
    sock, procs = _start(tmp_path, SERVE_MODES[mode], mode)
    try:
        ping = request(sock, {"id": 0, "op": "ping"})
        assert ping["ok"] and ping["batch"] == 4 and ping["world_size"] == 2
        ref = DenoiseService(device="cpu", mode=mode, batch=4, bf16=False, blocks=2,
                             features=16)
        rng = np.random.default_rng(9)
        for i, n in enumerate((6, 3)):
            x = np.clip(rng.normal(0, 0.4, (n, 64, 64, 1)), -1, 1).astype(np.float32)
            np.save(tmp_path / f"x{i}.npy", x)
            resp = request(sock, {"id": i + 1, "op": "denoise", "npy": str(tmp_path / f"x{i}.npy"),
                                  "out": str(tmp_path / f"y{i}.npy")})
            assert resp["ok"], resp
            got, want = np.load(tmp_path / f"y{i}.npy"), ref.denoise_patches(x)
            assert got.shape == want.shape == (n, 64, 64, 1)
            assert np.abs(got - want).max() < TOL["sample" if mode == "cond" else "ddrm"]
        assert request(sock, {"id": 9, "op": "shutdown"})["shutdown"]
        assert [p.wait(timeout=60) for p in procs] == [0, 0]
    finally:
        _stop(procs)
    assert "rank 1 of 2" in (tmp_path / f"{mode}_rank1.log").read_text()


def test_killed_rank_ends_rank_zero_with_an_error(tmp_path):
    """After rank 1 is killed, rank 0's next request fails its collective:
    rank 0 exits non-zero (no hang) and the client gets no answer."""
    sock, procs = _start(tmp_path, SERVE_MODES["cond"], "killed")
    try:
        assert request(sock, {"id": 0, "op": "ping"})["ok"]
        procs[1].send_signal(signal.SIGKILL)
        procs[1].wait(timeout=30)
        np.save(tmp_path / "x.npy", np.zeros((2, 64, 64, 1), np.float32))
        with pytest.raises((json.JSONDecodeError, OSError)):
            request(sock, {"id": 1, "op": "denoise", "npy": str(tmp_path / "x.npy")},
                    timeout=120)
        assert procs[0].wait(timeout=120) not in (0, None)
    finally:
        _stop(procs)
    assert "ShardError" in (tmp_path / "killed_rank0.log").read_text()


KEEPALIVE = r"""
import sys, time
import numpy as np
from hicdiff_tpu_torch import serve
from hicdiff_tpu_torch.parallel.mesh import barrier, make_mesh

rank, port = int(sys.argv[1]), int(sys.argv[2])
serve.KEEPALIVE_S = 0.05
mesh = make_mesh("cpu", backend="gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                 world_size=2)
service = serve.DenoiseService(device="cpu", batch=2, bf16=False, blocks=1, features=8,
                               sampling_steps=2, mesh=mesh)
if rank == 0:
    sent = 0
    for _ in range(3):
        time.sleep(0.1)
        before = service._last_sent
        service.keepalive()
        sent += service._last_sent > before
    out = service.denoise_patches(np.zeros((3, 64, 64, 1), np.float32))
    service.stop_followers()
    print("noops", sent, "out", out.shape, flush=True)
else:
    service.follow()
    print("followed", flush=True)
barrier(mesh)
mesh.close()
"""


def test_idle_keepalive_keeps_the_ranks_in_step(tmp_path):
    """An idle rank 0 sends no-op headers (every KEEPALIVE_S) that the
    follower takes without sampling; a chunk and stop then follow in step."""
    port = multihost.free_port()
    procs = [subprocess.Popen([sys.executable, "-c", KEEPALIVE, str(r), str(port)], cwd=REPO,
                              env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        _stop(procs)
    assert [p.returncode for p in procs] == [0, 0], outs
    assert "noops 3 out (3, 64, 64, 1)" in outs[0] and "followed" in outs[1], outs
