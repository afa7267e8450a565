"""tools/torch_fullscale_quality.py on the CPU at a tiny size: the `-u 1`
protocol (the unconditional prior at the linear schedule, DDRM over the test
split at t*=27) and the `-u 0` protocol at a second train seed, each through
the whole tool (fixture, training, inference, latent, scores) at 64 bins a
chromosome, one block of 16 features, one epoch."""
import json
import math

import pytest

from hicdiff_tpu_torch.train import trainer as trainer_mod
from tools import torch_fullscale_quality as tool

TINY = ["--bins", "64", "--blocks", "1", "--features", "16", "--epochs", "1",
        "--device", "cpu"]
METRICS = ("pas_ssim", "pas_psnr", "pas_mse", "pas_snr", "pas_pcc", "pas_spc", "pas_gds")


@pytest.fixture
def fit_seeds(monkeypatch):
    """The seed each Trainer.fit call receives."""
    seeds, fit = [], trainer_mod.Trainer.fit

    def spy(self, *args, **kw):
        seeds.append(kw["seed"])
        return fit(self, *args, **kw)

    monkeypatch.setattr(trainer_mod.Trainer, "fit", spy)
    return seeds


def _run(tmp_path, *flags):
    out = tmp_path / "summary.json"
    tool.main([*flags, *TINY, "--root", str(tmp_path / "root"), "--out", str(out)])
    return json.loads(out.read_text())


def _assert_scores(run, rows):
    assert set(run["scores"]) == {"latent", *rows}
    for row in rows:
        scores = run["scores"][row]
        assert all(math.isfinite(scores[m]) for m in METRICS), (row, scores)


def _assert_summary(s, u, seed):
    assert {"card", "torch", "precision", "protocol", "fixture", "train", "wall_s"} <= set(s)
    assert s["precision"] == "bfloat16"
    p = s["protocol"]
    assert (p["u"], p["seed"], p["fixture_seed"], p["band"], p["ckpt_throttle_s"]) == (
        u, seed, 7, 257, 0.0)
    assert (p["use_ema"], p["t_start"], p["ema_decay"], p["timestep"]) == (False, "auto", 0.999,
                                                                           1000)
    train = s["train"]
    assert train["seed"] == seed and train["mode"] == ("uncond" if u else "cond")
    assert [e["epoch"] for e in train["epochs"]] == [1]
    assert train["best_epoch"] == train["best_epoch_epochs_1_145"] == 1
    assert math.isfinite(train["best_val"]) and train["best_val_epochs_1_145"] == train["best_val"]
    # the CPU takes every kernel's plain version: no launch is counted
    assert train["launches"] == {"fused_resblock": 0, "fused_resblock_modes": {},
                                 "fused_posterior_step": 0}


def test_uncond_protocol(tmp_path, fit_seeds):
    s = _run(tmp_path, "-u", "1")
    _assert_summary(s, 1, 0)
    assert fit_seeds == [0]
    assert (s["protocol"]["schedule"], s["protocol"]["chro"]) == ("linear", "test")
    assert "t29" not in s and "k1" not in s
    ddrm = s["ddrm"]
    assert ddrm["t_start"] == 27 and "_trans2_1000_ts27" in ddrm["outdir"]
    assert ddrm["patches"] > 0 and ddrm["batches"] == -(-ddrm["patches"] // 64)
    assert ddrm["launches"]["fused_posterior_step"] == 0
    _assert_scores(ddrm, ["predict_vs_latent", "predict_vs_target", "noisy_vs_latent",
                          "noisy_vs_target", "target_vs_latent"])


def test_train_seed_reaches_the_trainer(tmp_path, fit_seeds):
    s = _run(tmp_path, "--train-seed", "1")
    _assert_summary(s, 0, 1)
    assert fit_seeds == [1]
    assert (s["protocol"]["schedule"], s["protocol"]["chro"]) == ("sigmoid", "all")
    assert "ddrm" not in s
    _assert_scores(s["t29"], ["predict_vs_latent", "predict_vs_target", "noisy_vs_latent",
                              "noisy_vs_target", "target_vs_latent"])
    _assert_scores(s["k1"], ["predict_vs_latent", "predict_vs_target"])
