"""The port's progressive distillation against the JAX package's, on the CPU.

Small sizes: 2 blocks, 16x16 patches, T = 20 sigmoid, t_start = 5. Weights
come from flax's init and reach the port through params_from_jax; the
student is the teacher plus a seeded perturbation, so that the loss is not
the rounding noise of two equal models; i and noise are drawn as the JAX
loss draws them from its key and handed to the port. fp32 tolerances as in
tests/test_torch_train.py (sums in another order: a few ulps of the largest
value).
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hicdiff_tpu.diffusion.gaussian import GaussianDiffusion as JaxGaussianDiffusion
from hicdiff_tpu.models.hicedrn import HicedrnDiff as JaxHicedrnDiff
from hicdiff_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from hicdiff_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from hicdiff_tpu.train.distill import ProgressiveDistiller as JaxDistiller
from hicdiff_tpu.train.distill import halving_stages as jax_halving_stages
from hicdiff_tpu.train.distill import stage_grid as jax_stage_grid
from hicdiff_tpu_torch.convert import params_from_jax, params_to_jax
from hicdiff_tpu_torch.diffusion.gaussian import GaussianDiffusion
from hicdiff_tpu_torch.models.hicedrn import HicedrnDiff
from hicdiff_tpu_torch.train.checkpoint import checkpoint_name, load_checkpoint
from hicdiff_tpu_torch.train.distill import ProgressiveDistiller, halving_stages, stage_grid
from tests.make_fixture_mcool import make_fixture
from tests.test_torch_train import assert_trees_close

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T, T_START, SIZE, BLOCKS, FEATURES, K = 20, 5, 16, 2, 16, 3


def test_stage_grid_and_halving_match_jax():
    for top, k in [(29, 15), (29, 8), (29, 1), (5, 3), (499, 4), (27, 28)]:
        np.testing.assert_array_equal(stage_grid(top, k), jax_stage_grid(top, k))
    for k0 in (1, 2, 7, 30, 100):
        assert halving_stages(k0) == jax_halving_stages(k0)


@pytest.fixture(scope="module")
def jax_pair():
    """(JAX engine, teacher params, student params) with a perturbed student."""
    model = JaxHicedrnDiff(self_condition=True, number_resnet=BLOCKS, features=FEATURES)
    eng = JaxGaussianDiffusion.create(model, image_size=SIZE, timesteps=T, loss_type="l2",
                                      beta_schedule="sigmoid", mode="cond")
    eng = dataclasses.replace(eng, t_start=T_START)
    teacher = jax.tree.map(np.asarray, eng.init_params(jax.random.PRNGKey(0)))
    leaves, tree = jax.tree_util.tree_flatten(teacher)
    rng = np.random.default_rng(1)
    student = jax.tree_util.tree_unflatten(tree, [
        (a + 0.05 * a.std() * rng.normal(size=a.shape)).astype(np.float32) for a in leaves])
    return eng, teacher, student


def _port(teacher, student, lr=1e-5):
    model = HicedrnDiff(self_condition=True, number_resnet=BLOCKS, features=FEATURES,
                        device="cpu")
    model.load_state_dict(params_from_jax(teacher))
    eng = GaussianDiffusion.create(model, device="cpu", timesteps=T, beta_schedule="sigmoid")
    dist = ProgressiveDistiller(dataclasses.replace(eng, t_start=T_START), student_steps=K,
                                lr=lr)
    dist.freeze_teacher()
    model.load_state_dict(params_from_jax(student))
    return dist


def _batch(n, seed):
    rng = np.random.default_rng(seed)
    x0 = np.clip(rng.normal(0, 0.3, (n, SIZE, SIZE, 1)), -1, 1).astype(np.float32)
    y = np.clip(x0 + 0.1 * rng.normal(size=x0.shape), -1, 1).astype(np.float32)
    return y, x0


def _jax_draws(key, b_padded, b):
    """i and noise as the JAX loss draws them for its padded batch, cut to b."""
    i_key, n_key = jax.random.split(key)
    i = jax.random.randint(i_key, (b_padded,), 0, K)
    noise = jax.random.normal(n_key, (b_padded, SIZE, SIZE, 1), dtype=jnp.float32)
    return torch.tensor(np.asarray(i)[:b]), torch.tensor(np.asarray(noise)[:b])


def _jax_args(jd, y, x0, b_padded):
    """JAX's padded batch, weights and grid tables for a batch of real rows."""
    pad = b_padded - y.shape[0]
    ypad, xpad = (np.pad(a, [(0, pad), (0, 0), (0, 0), (0, 0)]) for a in (y, x0))
    w = np.concatenate([np.ones(y.shape[0]), np.zeros(pad)]).astype(np.float32)
    return (jnp.asarray(ypad), jnp.asarray(xpad)), jnp.asarray(w), jd._grid_args()


def test_distill_loss_and_gradient_match_jax(jax_pair):
    """A ragged batch of 5 (JAX pads it to 8 and masks the padding): the
    loss within 1e-5 relative, the student's gradient within 1e-4 of each
    leaf's largest magnitude."""
    eng, teacher, student = jax_pair
    jd = JaxDistiller(eng, student_steps=K, lr=1e-5)
    y, x0 = _batch(5, seed=2)
    key = jax.random.PRNGKey(3)
    batch, w, grid = _jax_args(jd, y, x0, 8)

    def loss_of(sp):
        return jd._eval_step(sp, teacher, key, batch, w, *grid)

    want_loss, want_grad = jax.value_and_grad(loss_of)(student)
    i, noise = _jax_draws(key, 8, 5)
    assert set(i.tolist()) == set(range(K)), "the draws should visit every grid step"
    dist = _port(teacher, student)
    loss = dist.loss(torch.from_numpy(y), torch.from_numpy(x0), torch.ones(5), i, noise)
    loss.backward()
    assert abs(float(loss.detach()) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    grad = params_to_jax({n: p.grad for n, p in dist.model.named_parameters()})
    assert_trees_close(grad, jax.tree.map(np.asarray, want_grad), 1e-4, "student gradient")


def test_distill_adam_step_matches_jax(jax_pair):
    """One Adam step of the student on a full batch of 8: the loss within
    1e-5 relative, the student's params within 1e-6 of the largest
    magnitude of their leaf (or of 1)."""
    eng, teacher, student = jax_pair
    jd = JaxDistiller(eng, student_steps=K, lr=1e-3)
    y, x0 = _batch(8, seed=4)
    key = jax.random.PRNGKey(5)
    batch, w, grid = _jax_args(jd, y, x0, 8)
    copy = lambda tree: jax.tree.map(jnp.array, tree)  # the step donates its inputs
    want_params, _, want_loss = jd._distill_step(copy(student), jd.optimizer.init(student),
                                                 teacher, key, batch, w, *grid)
    i, noise = _jax_draws(key, 8, 8)
    dist = _port(teacher, student, lr=1e-3)
    loss = float(dist.step(y, x0, i=i, noise=noise))
    assert abs(loss - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    assert_trees_close(params_to_jax(dist.model.state_dict()),
                       jax.tree.map(np.asarray, want_params), 1e-6, "student params")


class _Loader:
    """(data, target, samp, info) NHWC batches in a fixed order, last one ragged."""

    def __init__(self, n, batch, seed):
        self.data, self.target = _batch(n, seed)
        self.batch_size = batch

    def __iter__(self):
        for lo in range(0, len(self.data), self.batch_size):
            d, t = self.data[lo:lo + self.batch_size], self.target[lo:lo + self.batch_size]
            yield d, t, d.reshape(len(d), -1), np.ones(len(d), np.int64)


def test_fit_val_loss_falls_and_student_samples(jax_pair):
    """As tests/test_distill.py: over 12 steps at lr 1e-3 the val loss ends
    no higher than 1.05 x its first value; the best student, loaded back,
    samples finite values through the K-step DDIM chain."""
    _, teacher, _ = jax_pair
    dist = _port(teacher, teacher, lr=1e-3)
    losses = []

    class Cap:
        def log(self, d):
            losses.append(d["distill/val_loss"])

    loader = _Loader(16, 8, seed=6)
    best, best_val = dist.fit(loader, loader, steps=12, seed=0, logger=Cap())
    assert np.isfinite(best_val) and len(losses) == 6
    assert losses[-1] <= losses[0] * 1.05
    dist.model.load_state_dict(best)
    eng = dataclasses.replace(dist.engine, sampling_timesteps=K)
    out = eng.ddim_sample(torch.zeros(2, SIZE, SIZE, 1), torch.Generator().manual_seed(0))
    assert torch.isfinite(out).all()


def _cpu_env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    return env


def test_distill_cli_checkpoint_runs_inference_and_loads_in_jax(tmp_path):
    """distill_torch.py (--stages 2,1) from a train.py-named teacher on the
    fixture writes ..._dist{K} checkpoints with run_config distilled_steps;
    inference_torch.py -u 0 --t-start auto --sampling-steps 1 --weights
    <dist1> denoises with it; JAX's load_checkpoint reads its params as the
    port wrote them, and the port reads a JAX-written one back."""
    root = tmp_path / "root"
    os.makedirs(root / "Datasets" / "Human")
    make_fixture(str(root / "Datasets" / "Human" / "cell1_synth.mcool"),
                 bins_per_chrom=tuple([64] * 22))
    model = HicedrnDiff(self_condition=True, number_resnet=2, features=16, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    meta = dict(res=40000, chunk=64, cell_line="Human", cell_no=1)
    jax_save_checkpoint(str(root / "Model_Weights" / checkpoint_name(
        "bestg", tag="HiCedrn_cond_l2_sig", **meta)), params_to_jax(model.state_dict()), None,
        step=0, run_config=dict(sigma=0.1, schedule="sigmoid", mode="cond", timestep=1000))
    common = ["--device", "cpu", "--blocks", "2", "--features", "16", "-s", "0.1",
              "--root", str(root)]
    run = subprocess.run([sys.executable, "distill_torch.py", "--stages", "2,1",
                          "--steps-per-stage", "2", "-b", "8"] + common,
                         cwd=REPO, env=_cpu_env(), capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    paths = {k: root / "Model_Weights" / checkpoint_name(
        "bestg", tag=f"HiCedrn_cond_l2_sig_dist{k}", **meta) for k in (2, 1)}
    for k, path in paths.items():
        ck = load_checkpoint(str(path))
        assert ck["run_config"]["distilled_steps"] == k and ck["step"] == 2
        raw = jax_load_checkpoint(str(path))
        assert raw["run_config"]["distilled_steps"] == k
        assert_trees_close(jax.tree.map(np.asarray, raw["params"]), ck["params"], 0.0, "params")
    assert (root / "logs" / "distill_HiCedrn_cond_l2_sig_cell1_s0.1.jsonl").exists()
    infer = subprocess.run([sys.executable, "inference_torch.py", "-u", "0", "-b", "8",
                            "--t-start", "auto", "--sampling-steps", "1", "--weights",
                            str(paths[1])] + common,
                           cwd=REPO, env=_cpu_env(), capture_output=True, text=True, timeout=300)
    assert infer.returncode == 0, infer.stderr[-3000:]
    pred = np.load(root / "Outputs_diff" / "hicedrn_l2_sigHuman1_deno_0.1_test_cond" /
                   "predict.npy")
    assert np.isfinite(pred).all() and np.abs(pred).max() <= 1.0
    # the reverse: a JAX-written distilled checkpoint loads in the port
    raw1 = jax_load_checkpoint(str(paths[1]))
    back = tmp_path / "jax_dist1.msgpack"
    jax_save_checkpoint(str(back), jax.tree.map(np.asarray, raw1["params"]), None, step=2,
                        run_config=dict(raw1["run_config"]))
    ck_back = load_checkpoint(str(back))
    assert ck_back["run_config"]["distilled_steps"] == 1
    want = params_from_jax(load_checkpoint(str(paths[1]))["params"])
    for name, t in params_from_jax(ck_back["params"]).items():
        assert torch.equal(t, want[name]), name
