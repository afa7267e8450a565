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


# --spread: JAX's rows as the artifact prints them, cut to the lines the
# tool reads, and per-seed summaries written by hand
JAX_TABLES = """## sigma=0.1 truncated t*=29 (full cell, 5,185 patches)
--- predict vs realized target:
{"pas_ssim": 0.1, "pas_psnr": 1.0, "pas_mse": 1.0, "pas_snr": 1.0, "pas_pcc": 0.1, "pas_spc": 0.1, "pas_gds": 0.1}
--- predict vs latent:
{"dir": "x", "predict": "predict", "target": "latent.npy", "pas_ssim": 0.86, "pas_psnr": 34.5, "pas_mse": 0.0003, "pas_snr": 1750000.0, "pas_pcc": 0.97, "pas_spc": 0.5, "pas_gds": 0.56}

## sigma=0.1 DDIM K=1 (full cell)
--- predict vs latent:
{"pas_ssim": 0.912, "pas_psnr": 35.86, "pas_mse": 0.000225, "pas_snr": 2072000.0, "pas_pcc": 0.978, "pas_spc": 0.657, "pas_gds": 0.568}

## DDRM t*=27 (test split, new uncond prior val 0.00589@e117)
--- predict vs latent:
{"pas_ssim": 0.895, "pas_psnr": 34.74, "pas_mse": 0.0003, "pas_snr": 459000.0, "pas_pcc": 0.972, "pas_spc": 0.556, "pas_gds": 0.566}
"""
JAX_VALIDATION = "The flagship (150 epochs,\nval 0.00498 best at epoch 134/150 — converged).\n"


def _summary(u, seed, scores, best_val, best_epoch):
    rows = ("ddrm",) if u else ("t29", "k1")
    train = {"seed": seed, "best_val": best_val, "best_epoch": best_epoch}
    if u:  # the -u 1 verdict reads the best over epochs 1-145, as JAX's run stopped
        train |= {"best_val": 0.0, "best_epoch": 150, "best_val_epochs_1_145": best_val,
                  "best_epoch_epochs_1_145": best_epoch}
    return {"protocol": {"u": u}, "train": train} | {
        row: {"scores": {"predict_vs_latent": dict(zip(METRICS, scores[row]))}} for row in rows}


def test_spread_reads_jax_rows_and_judges_each_metric(tmp_path, capsys):
    tables, validation = tmp_path / "tables.txt", tmp_path / "VALIDATION.md"
    tables.write_text(JAX_TABLES)
    validation.write_text(JAX_VALIDATION)
    jax = tool.jax_rows(str(tables), str(validation))
    assert jax["t29"]["pas_ssim"] == 0.86 and jax["k1"]["pas_spc"] == 0.657
    assert jax["ddrm"]["pas_psnr"] == 34.74
    assert jax["best_val_u0"] == {"best_val": 0.00498, "best_epoch": 134}
    assert jax["best_val_u1"] == {"best_val": 0.00589, "best_epoch": 117}
    # -u 0, three seeds: SSIM 0.85, 0.87, 0.89 (mean 0.87, sd 0.02) puts
    # JAX's 0.86 inside; SPC 0.60, 0.62, 0.64 puts JAX's 0.5 outside, 6.5 sd off
    t29 = [[s, 34.5 + d, 0.0003, 1.75e6, 0.97, sp, 0.56] for s, sp, d in
           ((0.85, 0.60, 0.1), (0.87, 0.62, 0.2), (0.89, 0.64, 0.3))]
    # K=1: SSIM 0.90, 0.91, 0.9105 puts JAX's 0.912 outside the range yet
    # within 2 sd of the mean (0.9068, sd 0.00578): within the spread
    k1 = [[s, 35.86, 0.000225, 2.072e6, 0.978, 0.657, 0.568] for s in (0.90, 0.91, 0.9105)]
    paths = []
    for seed in range(3):
        p = tmp_path / f"u0_{seed}.json"
        p.write_text(json.dumps(_summary(0, seed, {"t29": t29[seed], "k1": k1[seed]},
                                         0.0051 + 0.0001 * seed, 140 + seed)))
        paths.append(str(p))
    for seed, psnr in ((0, 35.45), (1, 34.5)):
        p = tmp_path / f"u1_{seed}.json"
        p.write_text(json.dumps(_summary(1, seed, {"ddrm": [0.9, psnr, 0.0003, 4.6e5, 0.97, 0.56,
                                                            0.566]}, 0.006, 145)))
        paths.append(str(p))
    table = tool.spread(paths, str(tables), str(validation))
    assert set(table) == {"t29", "k1", "ddrm", "best_val_u0", "best_val_u1"}
    assert table["t29"]["seeds"] == [0, 1, 2] and table["ddrm"]["seeds"] == [0, 1]
    ssim = table["t29"]["pas_ssim"]
    assert ssim["n"] == 3 and ssim["mean"] == pytest.approx(0.87)
    assert ssim["sd"] == pytest.approx(0.02) and (ssim["min"], ssim["max"]) == (0.85, 0.89)
    assert ssim["jax"] == 0.86 and ssim["verdict"] == "within the port's seed spread"
    spc = table["t29"]["pas_spc"]
    assert spc["gap"] == pytest.approx(-0.12) and spc["verdict"] == "systematic"
    k1_ssim = table["k1"]["pas_ssim"]
    assert not k1_ssim["min"] <= k1_ssim["jax"] <= k1_ssim["max"]
    assert k1_ssim["verdict"] == "within the port's seed spread"
    # every seed equal to JAX's: sd 0, JAX inside the range
    assert table["k1"]["pas_spc"]["verdict"] == "within the port's seed spread"
    psnr = table["ddrm"]["pas_psnr"]
    assert psnr["mean"] == pytest.approx(34.975) and psnr["verdict"] == "within the port's seed spread"
    val = table["best_val_u0"]["best_val"]
    assert val["mean"] == pytest.approx(0.0052) and val["verdict"] == "systematic"
    assert table["best_val_u0"]["best_epoch"]["verdict"] == "systematic"
    # -u 1 reads the best of epochs 1-145: 0.006 at 145 on both seeds (sd 0)
    assert table["best_val_u1"]["best_val"]["mean"] == pytest.approx(0.006)
    assert table["best_val_u1"]["best_epoch"]["verdict"] == "systematic"
    tool.print_spread(table)
    out = capsys.readouterr().out.splitlines()
    assert "| pas_spc | 0.62 | 0.02 | 0.6 - 0.64 | 0.5 | systematic |" in out
    assert json.loads(out[-1]) == json.loads(json.dumps(table))


def test_spread_reads_the_repository_files(capsys):
    """--spread on the kept summaries against the artifact's own rows: one
    table a row, JAX's values as the artifact prints them."""
    import glob
    import os

    paths = sorted(glob.glob(os.path.join(tool.ROOT, "artifacts", "torch_fullscale_seeds",
                                          "*.json")))
    tool.main(["--spread", *paths])
    table = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert {"t29", "k1", "ddrm", "best_val_u0", "best_val_u1"} <= set(table)
    assert table["k1"]["pas_spc"]["jax"] == pytest.approx(0.6572632386112849)
    assert table["ddrm"]["pas_psnr"]["jax"] == pytest.approx(34.74482002796205)
    assert table["best_val_u0"]["best_val"]["jax"] == 0.00498
    assert table["t29"]["seeds"][:2] == [0, 1] and table["ddrm"]["seeds"][0] == 0
    # the -u 1 runs cut at 117 epochs stand in rows of their own
    assert table["ddrm"]["seeds"] == table["ddrm_e117"]["seeds"] == [0, 1, 2]
    assert table["best_val_u1_e117"]["best_val"]["jax"] == table["best_val_u1"]["best_val"]["jax"]
