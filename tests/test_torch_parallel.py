"""The port's data parallelism (hicdiff_tpu_torch/parallel/) on the CPU.

The batch helpers against the JAX package's; the sharded draws (a shard's
rows of the loss's, the chains' and DDRM's draws are the whole batch's rows);
multihost.launch's two gloo ranks against one rank (2 blocks x 32 features,
64x64 patches: losses within 1e-5, parameters after two steps within 1e-6,
chain and DDRM outputs within 1e-4); a one-rank mesh step against the
mesh-free step, bit for bit; train_torch.py under torchrun; the launcher's
cleanup when a rank hangs or fails; the device rules of the mesh.
"""
import dataclasses
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from hicdiff_tpu.parallel.mesh import pad_batch as jax_pad_batch
from hicdiff_tpu.parallel.mesh import process_slice as jax_process_slice
from hicdiff_tpu_torch.diffusion.gaussian import GaussianDiffusion, draw_rows
from hicdiff_tpu_torch.kernels.sample_step import fused_posterior_step_reference
from hicdiff_tpu_torch.models.hicedrn import HicedrnDiff
from hicdiff_tpu_torch.parallel import multihost
from hicdiff_tpu_torch.parallel.mesh import (
    Mesh,
    _check_nccl,
    is_main,
    make_mesh,
    pad_batch,
    process_slice,
    rank_device,
    sharded,
)
from hicdiff_tpu_torch.sampling.ddrm import DDRMRestorer
from hicdiff_tpu_torch.train.checkpoint import checkpoint_name, load_checkpoint
from hicdiff_tpu_torch.train.trainer import Trainer, step_generator
from tests.make_fixture_mcool import make_fixture

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def _mesh(rank, world):
    return Mesh(rank, world, CPU, "gloo")


# ------------------------------------------------------------ the helpers


@pytest.mark.parametrize("b,multiple", [(8, 8), (5, 8), (13, 2), (1, 4), (18, 2)])
def test_pad_batch_matches_jax(b, multiple):
    rng = np.random.default_rng(b)
    arrays = (rng.normal(size=(b, 3, 3, 1)).astype(np.float32),
              rng.normal(size=(b, 2)).astype(np.float32))
    (got, w), (want, w_want) = pad_batch(arrays, multiple), jax_pad_batch(arrays, multiple)
    np.testing.assert_array_equal(w, w_want)
    for a, a_want in zip(got, want):
        np.testing.assert_array_equal(a, a_want)


def test_process_slice_matches_jax_and_covers_the_batch():
    assert process_slice(16) == jax_process_slice(16) == (0, 16)  # one process
    parts = [process_slice(18, _mesh(r, 3)) for r in range(3)]
    assert parts == [(0, 6), (6, 12), (12, 18)]
    with pytest.raises(AssertionError):  # callers pad to the world size first
        process_slice(5, _mesh(0, 2))


# ------------------------------------------------------------ sharded draws


def _tiny(mode, self_condition=True, sr3_per_sample_t=False):
    model = HicedrnDiff(self_condition=self_condition, number_resnet=1, features=16,
                        device="cpu", generator=torch.Generator().manual_seed(0))
    return GaussianDiffusion.create(model, device="cpu", timesteps=50, beta_schedule="cosine",
                                    mode=mode, sr3_per_sample_t=sr3_per_sample_t)


def _shards(n, world):
    per = -(-n // world)
    return [(r * per, per) for r in range(world)]


@pytest.mark.parametrize("mode,kw", [("cond", {}), ("uncond", {}),
                                     ("uncond", {"self_condition": False}),
                                     ("sr3", {}), ("sr3", {"sr3_per_sample_t": True})])
def test_shard_loss_draws_are_the_whole_batch_rows(mode, kw):
    """Each shard's per-sample losses (rows=) are the whole batch's rows of
    the one-process losses, drawn from the same generator seed."""
    eng = _tiny(mode, **kw)
    rng = np.random.default_rng(1)
    x0 = torch.from_numpy(rng.normal(0, 0.3, (5, 16, 16, 1)).astype(np.float32))
    y = x0 + 0.1
    cond = None if mode == "uncond" else y
    with torch.no_grad():
        whole = eng.p_losses(cond, x0, generator=torch.Generator().manual_seed(3),
                             reduce=False)
        for lo, per in _shards(5, 2):
            xs = torch.cat([x0, torch.zeros_like(x0)])[lo:lo + per]
            cs = None if cond is None else torch.cat([cond, torch.zeros_like(cond)])[lo:lo + per]
            part = eng.p_losses(cs, xs, generator=torch.Generator().manual_seed(3),
                                reduce=False, rows=(lo, 5))
            real = max(0, min(per, 5 - lo))
            torch.testing.assert_close(part[:real], whole[lo:lo + real], rtol=1e-6, atol=0)


def test_posterior_twin_shard_draws_the_whole_batch_rows():
    """The plain posterior step at a shard's offset keeps the whole batch's
    z on its rows (and z = 0 past the batch, a rank's padding)."""
    g = torch.Generator().manual_seed(2)
    x, eps = torch.randn(6, 8, 8, 1, generator=g), torch.randn(6, 8, 8, 1, generator=g)
    args = (1.1, 0.5, 0.7, 0.3, -2.0, 1.0, 9)
    whole, _ = fused_posterior_step_reference(x, eps, *args)
    part, _ = fused_posterior_step_reference(x[2:5], eps[2:5], *args, offset=2 * 64 // 4,
                                             total=6 * 64)
    assert torch.equal(part, whole[2:5])
    pad_x = torch.cat([x[4:], torch.zeros(2, 8, 8, 1)])
    tail, _ = fused_posterior_step_reference(pad_x, torch.cat([eps[4:], torch.zeros(2, 8, 8, 1)]),
                                             *args, offset=4 * 64 // 4, total=6 * 64)
    assert torch.equal(tail[:2], whole[4:])
    no_noise, _ = fused_posterior_step_reference(pad_x[2:], pad_x[2:], *args[:5], 0.0, 9)
    assert torch.equal(tail[2:], no_noise)


@pytest.mark.parametrize("sampler", ["ancestral", "ddim_eta", "truncated"])
def test_sharded_chain_equals_the_whole_chain(sampler):
    """Two shards of a batch of 3 (padded to 4) through the chain, each with
    rows=, concatenated, equal the one-process chain: the init noise, the
    posterior step's seed and z, and DDIM's eta noise are the whole batch's."""
    eng = _tiny("cond")
    if sampler == "ddim_eta":
        eng = dataclasses.replace(eng, sampling_timesteps=5, ddim_sampling_eta=1.0)
    if sampler == "truncated":
        eng = dataclasses.replace(eng, t_start=3)
    y = torch.from_numpy(np.random.default_rng(4).normal(0, 0.3, (3, 16, 16, 1))
                         .astype(np.float32))
    whole = eng.super_resolution(y, torch.Generator().manual_seed(5))
    padded = torch.cat([y, torch.zeros(1, 16, 16, 1)])
    parts = [eng.super_resolution(padded[lo:lo + 2], torch.Generator().manual_seed(5),
                                  rows=(lo, 3)) for lo in (0, 2)]
    torch.testing.assert_close(torch.cat(parts)[:3], whole, rtol=0, atol=1e-6)


def _shard_normal(seed, rows):
    gen = torch.Generator().manual_seed(seed)
    return lambda shape: draw_rows(lambda s: torch.randn(s, generator=gen), shape, rows)


def test_sharded_ddrm_equals_the_whole_restoration():
    """DDRM deno (28 steps) on two shards of a batch of 3, each through a
    `noise` that keeps the shard's rows of the whole batch's draws (the
    init and each step's three): the whole batch's restoration."""
    model = HicedrnDiff(self_condition=False, number_resnet=1, features=16, device="cpu",
                        generator=torch.Generator().manual_seed(0)).eval()
    restorer = DDRMRestorer(lambda x, t: model(x, t, None), "deno", 0.1, device="cpu",
                            t_start="auto")
    y = torch.from_numpy(np.random.default_rng(6).normal(0, 0.3, (3, 4096)).astype(np.float32))
    whole = restorer(y, torch.Generator().manual_seed(7))
    padded = torch.cat([y, torch.zeros(1, 4096)])
    parts = [restorer(padded[lo:lo + 2], None, noise=_shard_normal(7, (lo, 3)))
             for lo in (0, 2)]
    torch.testing.assert_close(torch.cat(parts)[:3], whole, rtol=0, atol=1e-5)


# ------------------------------------------------------------ processes


def test_two_gloo_ranks_match_one_rank(tmp_path):
    """multihost.launch at the CPU harness's size: two steps (a batch of 8,
    then a ragged 5), the truncated chain and DDRM deno, two ranks against
    one: losses < 1e-5, params < 1e-6, outputs < 1e-4, and no weight's
    update over lr / 10 apart."""
    rec = multihost.launch(2, workdir=str(tmp_path), device="cpu", backend="gloo",
                           blocks=2, features=32, batch=8, ragged=5, timeout=300)
    assert rec["ok"] and rec["tol"] == multihost.FP32_TOL
    assert all(rec["max_diff"][k] < multihost.FP32_TOL[k] for k in rec["max_diff"])
    assert rec["update"]["outliers"] == 0 and rec["update"]["max_abs"] < multihost.UPDATE_TOL
    assert rec["ddrm_forwards"] == 28 and len(rec["ref_losses"]) == 2


def test_one_rank_mesh_step_is_the_mesh_free_step_bit_for_bit():
    """A one-rank gloo world makes no collective call: its Trainer steps
    (a full and a ragged batch) equal those without a mesh, bit for bit."""
    mesh = make_mesh("cpu", backend="gloo",
                     init_method=f"tcp://localhost:{multihost.free_port()}", rank=0,
                     world_size=1)
    try:
        trainers = []
        for m in (mesh, None):
            model = HicedrnDiff(self_condition=True, number_resnet=2, features=16, device="cpu",
                                generator=torch.Generator().manual_seed(0))
            eng = GaussianDiffusion.create(model, device="cpu", timesteps=100,
                                           beta_schedule="linear")
            trainers.append(Trainer(eng, lr=2e-5, ema_decay=0.9, mesh=m))
        rng = np.random.default_rng(8)
        target = rng.normal(0, 0.3, (7, 16, 16, 1)).astype(np.float32)
        data = (target + 0.1).astype(np.float32)
        for step, (lo, hi) in enumerate(((0, 4), (4, 7))):
            losses = [tr.train_step(data[lo:hi], target[lo:hi],
                                    generator=step_generator(1, step)) for tr in trainers]
            assert torch.equal(*losses)
        assert not sharded(mesh) and is_main(mesh)
        for a, b in zip(trainers[0].model.parameters(), trainers[1].model.parameters()):
            assert torch.equal(a, b)
        for a, b in zip(trainers[0].ema.values(), trainers[1].ema.values()):
            assert torch.equal(a, b)
    finally:
        mesh.close()
    assert not dist.is_initialized()


def _cpu_env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["OMP_NUM_THREADS"] = "2"
    return env


def test_train_cli_under_torchrun_matches_one_process(tmp_path):
    """train_torch.py -u 0 under torchrun with two gloo ranks on the CPU
    writes one set of checkpoints and one log, and its final weights equal
    the one-process run's within 1e-6."""
    roots = {}
    for tag in ("one", "two"):
        root = tmp_path / tag
        os.makedirs(root / "Datasets" / "Human")
        make_fixture(str(root / "Datasets" / "Human" / "cell1_synth.mcool"),
                     bins_per_chrom=tuple([64] * 22))
        roots[tag] = root
    args = ["train_torch.py", "-u", "0", "--device", "cpu", "-e", "1", "--blocks", "2",
            "--features", "16", "-s", "0.1", "-b", "8"]
    runs = {
        "one": [sys.executable] + args + ["--root", str(roots["one"])],
        "two": [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2",
                "--master-port", str(multihost.free_port())] + args
               + ["--root", str(roots["two"])],
    }
    for tag, cmd in runs.items():
        r = subprocess.run(cmd, cwd=REPO, env=_cpu_env(), capture_output=True, text=True,
                           timeout=300)
        assert r.returncode == 0, r.stderr[-3000:]
    meta = dict(res=40000, chunk=64, cell_line="Human", cell_no=1, tag="HiCedrn_cond_l2_lin")
    final = {tag: load_checkpoint(str(root / "Model_Weights" / checkpoint_name("finalg", **meta)))
             for tag, root in roots.items()}
    assert final["one"]["step"] == final["two"]["step"] == 2  # 14 train patches, batch 8
    for path, a in _leaves(final["one"]["params"]):
        b = _get(final["two"]["params"], path)
        assert np.abs(a - b).max() <= 1e-6, path
    logs = list((roots["two"] / "logs").iterdir())
    assert len(logs) == 1 and len(logs[0].read_text().splitlines()) == 1


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, np.asarray(tree)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


def _alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


@pytest.mark.parametrize("other", ["hangs", "fails"])
def test_launcher_kills_every_rank_on_timeout_or_failure(tmp_path, other):
    """One rank sleeps for a minute; the other hangs as well (the run then
    outlasts its 3 s timeout) or exits with an error at once. Either way the
    launcher raises and no rank is left running."""
    sleeper = [sys.executable, "-c", "import os, time; print(os.getpid(), flush=True); "
                                     "time.sleep(60)"]
    second = sleeper if other == "hangs" else [
        sys.executable, "-c", "import time; time.sleep(1); raise SystemExit(3)"]
    t0 = time.monotonic()
    error = subprocess.TimeoutExpired if other == "hangs" else RuntimeError
    with pytest.raises(error):
        multihost.run_ranks([sleeper, second], logdir=str(tmp_path), timeout=3, tag=other)
    assert time.monotonic() - t0 < 30
    pids = [int(p.read_text().split()[0]) for p in sorted(tmp_path.glob(f"{other}_rank*.log"))
            if p.read_text().strip() and p.read_text().split()[0].isdigit()]
    assert pids and not any(_alive(pid) for pid in pids)


# ------------------------------------------------------------ device rules


def test_nccl_refuses_a_shared_card_and_gloo_is_named():
    """NCCL needs a GPU a rank: two ranks on this host's (absent) GPUs
    raise rather than switch backend; a rank without a GPU of its own
    raises; an indexed device is taken as given."""
    with pytest.raises(ValueError, match="gloo"):
        _check_nccl(torch.device("cuda", 0), local_world_size=2)
    with pytest.raises(ValueError, match="CUDA"):
        make_mesh("cpu", backend="nccl", init_method="tcp://localhost:1", rank=0,
                  world_size=1)
    if torch.cuda.device_count() < 2:
        with pytest.raises(RuntimeError, match="no GPU of its own"):
            rank_device("cuda", local_rank=1)
    assert rank_device("cuda:0", local_rank=1) == torch.device("cuda", 0)
    assert rank_device("cpu", local_rank=3) == CPU
    assert not dist.is_initialized()
