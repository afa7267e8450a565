"""pretrain_baselines_torch.py and sample/stard_metric_normal_torch.py against
the JAX package's scripts, on the CPU.

One L2 step per baseline and one adversarial step per critic objective, each
against the JAX step of pretrain_baselines.py written out here from its
jitted closures (the same models, optax Adam and masked means), on flax's
init carried to the port: batch 4 of 32x32 patches (44x44 for the padded
models), a wrap-padded repeat row masked out; hiedsr at 2 blocks, DeepHiC
and HiCSR at 2 residual blocks, HiCARN at 16 channels. Losses within 1e-5
relative, gradients within 1e-5 of the largest, updated parameters within
lr / 10 where the gradient defines Adam's step (`_step_close`), BatchNorm statistics within
1e-5 of each tensor's largest value. Then the CLIs in-process on the 22x64-bin fixture cell, with
unet at feature_scale 16 in both packages' registries: the port's
checkpoints load in the JAX loader, and the port's metrics script gives the
JAX script's predictions and table.
"""
import importlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import pretrain_baselines as jax_pretrain
import pretrain_baselines_torch as pt
from hicdiff_tpu.metrics import losses as jl
from hicdiff_tpu.models import baselines as jb
from hicdiff_tpu.models import zoo as jax_zoo
from hicdiff_tpu.models.hicedrn import HicedrnGenerator as JaxHicedrnGenerator
from hicdiff_tpu_torch.convert import params_from_jax, params_to_jax
from hicdiff_tpu_torch.metrics.losses import VGGFeatures
from hicdiff_tpu_torch.models import baselines as pb
from hicdiff_tpu_torch.models import zoo as port_zoo
from hicdiff_tpu_torch.models.common import BatchNorm
from hicdiff_tpu_torch.models.hicedrn import HicedrnGenerator
from tests.make_fixture_mcool import make_fixture

LR = 1e-4
SMALL = {
    "hiedsr": (JaxHicedrnGenerator(number_blocks=2),
               lambda **kw: HicedrnGenerator(number_blocks=2, **kw)),
    "hicarn": (jb.HiCARN(num_channels=16), lambda **kw: pb.HiCARN(num_channels=16, **kw)),
    "deephic": (jb.DeepHiC(resblock_num=2), lambda **kw: pb.DeepHiC(resblock_num=2, **kw)),
    "hicsr": (jb.HiCSR(num_res_blocks=2), lambda **kw: pb.HiCSR(num_res_blocks=2, **kw)),
    "unet": (jb.Unet2D(), lambda **kw: pb.Unet2D(**kw)),
    "hicplus": (jb.HicPlus(), lambda **kw: pb.HicPlus(**kw)),
}


def _batch(seed=0, n=3, pad_to=4, size=32):
    """A wrap-padded (x, y, w) of n real samples, by both packages' wrap_pad."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, size, size, 1)).astype(np.float32)
    y = np.clip(x + rng.normal(0, 0.1, x.shape), -1, 1).astype(np.float32)
    (xp, yp), w = jax_pretrain.wrap_pad((x, y), pad_to)
    (xq, yq), wq = pt.wrap_pad((x, y), pad_to)
    assert np.array_equal(xp, xq) and np.array_equal(yp, yq) and np.array_equal(w, wq)
    return xp, yp, w


def _close(got, want, what, rel=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rel, atol=rel * np.abs(want).max(),
                               err_msg=what)


ADAM_EPS = 1e-8


def _step_close(model, kind, new_params, grads, what):
    """Each gradient within 1e-5 of the largest one; each updated parameter
    within lr / 10 of JAX's where JAX's gradient is at least 100 Adam eps.
    Adam's first step moves a parameter by lr g / (|g| + eps): there it is
    within 1 % of lr sign(g), and the gradient bar pins the sign. Below it
    (rounding noise: a conv bias that a train-mode BatchNorm follows, whose
    gradient the batch mean cancels exactly) the step is set by the last
    bits of g, and only the gradient is compared."""
    want = params_from_jax(jax.tree.map(np.asarray, new_params), model=kind)
    g_want = params_from_jax(jax.tree.map(np.asarray, grads), model=kind)
    g_max = max(float(g.abs().max()) for g in g_want.values())
    assert {n for n, _ in model.named_parameters()} == set(g_want), what
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), g_want[name].numpy(), rtol=0,
                                   atol=1e-5 * g_max, err_msg=f"{what} grad {name}")
        defined = (g_want[name].abs() >= 100 * ADAM_EPS).numpy()
        np.testing.assert_allclose(p.detach().numpy()[defined], want[name].numpy()[defined],
                                   rtol=0, atol=LR / 10, err_msg=f"{what} {name}")


def _stats_close(got, want, what):
    """Running statistics within 1e-5 of each tensor's largest value: from
    the fresh 0 / 1 start a step's running mean is 0.01 of the batch mean, a
    sum over the batch whose terms cancel, so an element near zero has no
    relative bar."""
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want), what
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * np.abs(b).max(), err_msg=what)


@pytest.mark.parametrize("name", sorted(SMALL))
def test_l2_step_matches_jax(name):
    """pretrain_baselines.py's step (prep inside, masked L2, optax Adam,
    BatchNorm in train mode) against l2_step on the same init and batch."""
    jmodel, ctor = SMALL[name]
    _, needs_pad, out_range = jax_zoo.BASELINES[name]
    has_bn = pt.HAS_BN[name]
    assert has_bn == jax_pretrain.HAS_BN[name]
    x, y, w = _batch()
    size = 44 if needs_pad else 32
    variables = jax.tree.map(np.asarray, dict(jax.jit(jmodel.init)(
        jax.random.PRNGKey(1), jnp.zeros((1, size, size, 1)))))

    def prep(x):
        if out_range == "01":
            x = (x + 1.0) / 2.0
        return jnp.pad(x, ((0, 0), (6, 6), (6, 6), (0, 0))) if needs_pad else x

    opt = optax.adam(LR)

    @jax.jit
    def step(params, batch_stats, x, y, w):
        x, y = prep(x), (y + 1.0) / 2.0 if out_range == "01" else y

        def loss_fn(p):
            v = {"params": p}
            if has_bn:
                v["batch_stats"] = batch_stats
                out, upd = jmodel.apply(v, x, train=True, mutable=["batch_stats"])
                return jax_pretrain.masked_l2(out, y, w), upd["batch_stats"]
            return jax_pretrain.masked_l2(jmodel.apply(v, x), y, w), batch_stats

        (loss, new_bs), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, _ = opt.update(grads, opt.init(params), params)
        return optax.apply_updates(params, updates), new_bs, loss, grads

    new_params, new_bs, loss, grads = step(variables["params"], variables.get("batch_stats"),
                                    jnp.asarray(x), jnp.asarray(y), jnp.asarray(w))

    model = ctor(device="cpu")
    kind = type(model).__name__
    model.load_state_dict(params_from_jax(variables if has_bn else variables["params"],
                                          model=kind))
    prep_t, prep_target = pt.prep_fns(name)
    got = pt.l2_step(model, pt.adam(model.parameters(), LR), prep_t(torch.from_numpy(x)),
                     prep_target(torch.from_numpy(y)), torch.from_numpy(w), has_bn)
    _close(got.item(), loss, "loss")
    _step_close(model, kind, new_params, grads, name)
    if has_bn:
        _stats_close(params_to_jax(model.state_dict(), model=kind)["batch_stats"], new_bs,
                     "batch_stats")


@pytest.fixture(scope="module")
def gan_init():
    """flax's init of the 2-block generator, the critic and VGG19, numpy."""
    gen, disc, vgg = JaxHicedrnGenerator(number_blocks=2), jb.HiedsrDiscriminator(), \
        jl.VGGFeatures(variant="vgg19_35")
    zero = jnp.zeros((1, 32, 32, 1))
    kg, kd, kv = jax.random.split(jax.random.PRNGKey(0), 3)
    g = jax.jit(gen.init)(kg, zero)["params"]
    d = dict(jax.jit(disc.init)(kd, zero))
    v = jax.jit(vgg.init)(kv, zero)["params"]
    return (gen, disc, vgg), jax.tree.map(np.asarray, (g, d["params"], d["batch_stats"], v))


@pytest.mark.parametrize("disc_loss", ["srgan", "bce"])
def test_gan_step_matches_jax(gan_init, disc_loss):
    """train_hiedsrgan's step: g_loss, d_loss and the loss parts, both
    updated parameter sets, and the critic's BatchNorm statistics, which
    move on the real and the fake call and not on the generator's call to
    the updated critic (JAX discards that third update; had it been kept,
    the statistics would lie far outside the bar)."""
    (gen, disc, vgg), (g_params, d_params, d_stats, vgg_params) = gan_init
    x, y, w = _batch(seed=2)
    opt_g, opt_d = optax.adam(LR), optax.adam(LR)

    def vgg_apply(x):
        return vgg.apply({"params": vgg_params}, x)

    def d_apply(p, stats, x):
        out, upd = disc.apply({"params": p, "batch_stats": stats}, x, train=True,
                              mutable=["batch_stats"])
        return jnp.reshape(out, (x.shape[0], -1)).mean(axis=-1), upd["batch_stats"]

    @jax.jit
    def gan_step(g_params, d_params, d_stats, x, y, w):  # pretrain_baselines.py:281-330
        fake = gen.apply({"params": g_params}, x)
        wsum = jnp.maximum(jnp.sum(w), 1.0)

        def wmean(per):
            return jnp.sum(per * w) / wsum

        def d_loss_fn(dp):
            real_score, stats1 = d_apply(dp, d_stats, y)
            fake_score, stats2 = d_apply(dp, stats1, jax.lax.stop_gradient(fake))
            if disc_loss == "bce":
                eps = 1e-6
                loss = wmean(-jnp.log(jnp.clip(real_score, eps, 1.0))) + wmean(
                    -jnp.log(jnp.clip(1.0 - fake_score, eps, 1.0)))
            else:
                loss = 1.0 - wmean(real_score) + wmean(fake_score)
            return loss, stats2

        (d_loss, new_stats), d_grads = jax.value_and_grad(d_loss_fn, has_aux=True)(d_params)
        grads = {"d": d_grads}
        d_updates, _ = opt_d.update(d_grads, opt_d.init(d_params), d_params)
        d_params = optax.apply_updates(d_params, d_updates)

        def g_loss_fn(gp):
            out = gen.apply({"params": gp}, x)
            score, _ = d_apply(d_params, new_stats, out)
            image, percep, tv, total = jl.hiedsr_gan_generator_loss(
                vgg_apply, score, out, y, weights=w)
            return total, (image, percep, tv)

        (g_loss, parts), g_grads = jax.value_and_grad(g_loss_fn, has_aux=True)(g_params)
        grads["g"] = g_grads
        g_updates, _ = opt_g.update(g_grads, opt_g.init(g_params), g_params)
        g_params = optax.apply_updates(g_params, g_updates)
        third = d_apply(d_params, new_stats, gen.apply({"params": g_params}, x))[1]
        return g_params, d_params, new_stats, g_loss, d_loss, parts, third, grads

    want = gan_step(g_params, d_params, d_stats, *(jnp.asarray(a) for a in (x, y, w)))
    new_g, new_d, new_stats, g_loss, d_loss, parts, third, grads = want

    pgen = HicedrnGenerator(number_blocks=2, device="cpu")
    pgen.load_state_dict(params_from_jax(g_params, model="HicedrnGenerator"))
    pdisc = pb.HiedsrDiscriminator(device="cpu")
    pdisc.load_state_dict(params_from_jax({"params": d_params, "batch_stats": d_stats},
                                          model="HiedsrDiscriminator"))
    pvgg = VGGFeatures(device="cpu")
    pvgg.load_state_dict(params_from_jax(vgg_params, model="VGGFeatures"))
    pvgg.requires_grad_(False)
    got = pt.gan_step(pgen, pdisc, pvgg, pt.adam(pgen.parameters(), LR),
                      pt.adam(pdisc.parameters(), LR),
                      *(torch.from_numpy(a) for a in (x, y, w)), disc_loss)
    _close(got[0].item(), g_loss, "g_loss")
    _close(got[1].item(), d_loss, "d_loss")
    for g, ww, what in zip(got[2], parts, ("image", "perception", "tv")):
        _close(g.item(), ww, what)
    _step_close(pgen, "HicedrnGenerator", new_g, grads["g"], "generator")
    _step_close(pdisc, "HiedsrDiscriminator", new_d, grads["d"], "critic")
    _stats_close(params_to_jax(pdisc.state_dict(), model="HiedsrDiscriminator")["batch_stats"],
                 new_stats, "critic stats")
    gap = max(float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())
              for a, b in zip(jax.tree.leaves(third), jax.tree.leaves(new_stats)))
    assert gap > 1e-3, gap
    assert all(m.update_stats for m in pdisc.modules() if isinstance(m, BatchNorm))
    assert all(p.requires_grad for p in pdisc.parameters())


class _FakeDM:
    """train/val splits of NHWC batches, as a data module yields them."""

    def __init__(self, train, val=(), batch_size=16):
        self.batches, self.val, self.batch_size = train, val, batch_size

    def train_dataloader(self):
        return [(x, y, None, None) for x, y in self.batches]

    def val_dataloader(self):
        return [(x, y, None, None) for x, y in self.val]


def test_recalibrate_batch_stats_converges():
    """As tests/test_baselines.py holds the JAX function: running stats
    skewed far from the data converge to its mean and variance."""

    class TinyBN(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.bn = BatchNorm(1)

        def forward(self, x, train=False):
            return self.bn(x.permute(0, 3, 1, 2), train).permute(0, 2, 3, 1)

    model = TinyBN()
    with torch.no_grad():
        model.bn.running_mean.fill_(-7.0)
        model.bn.running_var.fill_(40.0)
    xs = [np.random.default_rng(i).normal(3.0, 2.0, (16, 8, 8, 1)).astype("f4") for i in range(4)]
    pt.recalibrate_batch_stats(model, _FakeDM([(x, x) for x in xs]), lambda x: x, device="cpu")
    assert abs(float(model.bn.running_mean[0]) - 3.0) < 0.1
    assert abs(float(model.bn.running_var[0]) - 4.0) < 0.5


def test_train_hiedsrgan_runs_an_epoch(monkeypatch):
    """train_hiedsrgan over a ragged split (4 + 3 wrap-padded samples), bce
    critic, the generator at 16 features (the step's arithmetic is
    test_gan_step_matches_jax's): finite logged losses, the best-validation
    generator returned."""
    from hicdiff_tpu_torch.models import hicedrn
    from hicdiff_tpu_torch.train.logging import MetricLogger

    monkeypatch.setattr(hicedrn, "N_FEAT", 16)

    x, y, _ = _batch(seed=3, n=4, pad_to=4)
    records = []
    logger = MetricLogger()
    logger.log = records.append
    dm = _FakeDM([(x, y), (x[:3], y[:3])], val=[(x[:2], y[:2])], batch_size=4)
    gen, best = pt.train_hiedsrgan(dm, epochs=1, lr=LR, device="cpu", logger=logger,
                                   gen_blocks=1, disc_loss="bce",
                                   generator=torch.Generator().manual_seed(0))
    assert isinstance(gen, HicedrnGenerator) and len(gen.body) == 2
    rec = records[-1]
    assert np.isfinite([rec["train/g_loss"], rec["train/d_loss"], rec["valid/loss"], best]).all()
    assert best == rec["valid/loss"]


@pytest.fixture(scope="module")
def cli_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("baselines_cli"))
    os.makedirs(os.path.join(root, "Datasets", "Human"))
    make_fixture(os.path.join(root, "Datasets", "Human", "cell1_synth.mcool"),
                 bins_per_chrom=tuple([64] * 22))
    return root


@pytest.fixture
def small_unet(monkeypatch):
    """unet at feature_scale 16 in both registries."""
    monkeypatch.setitem(jax_zoo.BASELINES, "unet",
                        (lambda: jb.Unet2D(feature_scale=16), False, "01"))
    monkeypatch.setitem(port_zoo.BASELINES, "unet",
                        (lambda **kw: pb.Unet2D(feature_scale=16, **kw), False, "01"))


def test_pretrain_baselines_cli_writes_what_jax_loads(cli_root, small_unet, capsys,
                                                      monkeypatch):
    """--models hicplus unet -e 1 -b 8 --device cpu: pretrain_baselines.py's
    checkpoint names and payloads (bare params for hicplus, variables for
    unet), which the JAX load_baseline reads to the port loader's forward.
    The recalibration runs 12 updates here, not 600 (its convergence is
    test_recalibrate_batch_stats_converges')."""
    monkeypatch.setattr(pt, "RECAL_UPDATES", 12)
    results = pt.main(["--models", "hicplus", "unet", "-e", "1", "-b", "8", "-s", "0.1",
                       "--root", cli_root, "--device", "cpu"])
    out = capsys.readouterr().out
    assert "best val L2" in out and "Baseline pretraining is done !!!" in out
    wdir = os.path.join(cli_root, "Model_Weights")
    x = np.random.default_rng(0).uniform(-1, 1, (2, 64, 64, 1)).astype(np.float32)
    for name in ("hicplus", "unet"):
        path, best = results[name]
        assert path == jax_zoo.baseline_checkpoint_path(wdir, name, "Human", 1, "deno", 0.1)
        assert np.isfinite(best)
        jfn, jhad = jax_zoo.load_baseline(name, wdir=wdir)
        fn, had = port_zoo.load_baseline(name, wdir=wdir, device="cpu")
        assert jhad and had
        want = np.asarray(jfn(x))
        np.testing.assert_allclose(fn(x).numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
    log = os.path.join(cli_root, "logs", "pretrain_baselines_cell1.jsonl")
    assert '"recalibrated"' in open(log).read()


def test_stard_metric_normal_cli_matches_jax(cli_root, small_unet, monkeypatch):
    """The port's metrics script over the fixture's test split against the
    JAX script on the same checkpoints (the previous test's): the same
    predictions, the table appended with each model's seven metrics, a
    notice for a model without a checkpoint."""
    import sample.stard_metric_normal_torch as port_cli

    table = os.path.join(cli_root, "Metrics", "Human1_deno_0.1_normal.txt")
    argv = ["-n", "1", "-l", "Human", "-s", "0.1", "--root", cli_root,
            "--models", "hicplus", "unet"]
    jax_cli = importlib.import_module("sample.stard_metric_normal")
    monkeypatch.setattr(sys, "argv", ["stard_metric_normal.py", *argv])
    jax_cli.main()
    outdir = os.path.join(cli_root, "Outputs_diff")
    want = {n: np.load(os.path.join(outdir, f"{n}Human1_deno_0.1_normal", "predict.npy"))
            for n in ("hicplus", "unet")}
    jax_table = open(table).read()
    results = port_cli.main([*argv, "--device", "cpu"])
    for name, (res, had) in results.items():
        assert had, name
        got = np.load(os.path.join(res["outdir"], "predict.npy"))
        np.testing.assert_allclose(got, want[name], rtol=0,
                                   atol=1e-5 * np.abs(want[name]).max())
        assert all(np.isfinite(v) for v in res["metrics"].values()), name
    ours = open(table).read()[len(jax_table):]
    assert ours.count("ssim:") == 2 and "hicplus" in ours and "unet" in ours
    jvals = [float(ln.split("\t")[1]) for ln in jax_table.splitlines() if "\t" in ln]
    pvals = [float(ln.split("\t")[1]) for ln in ours.splitlines() if "\t" in ln]
    np.testing.assert_allclose(pvals, jvals[-len(pvals):], rtol=1e-4)

    fresh = port_cli.main(["-n", "1", "-s", "0.1", "--root", cli_root, "--models", "hicplus",
                           "--weights-dir", os.path.join(cli_root, "none"), "--device", "cpu"])
    assert not fresh["hicplus"][1]
