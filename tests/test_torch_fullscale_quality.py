"""tools/torch_fullscale_quality.py on the CPU at a tiny size: the `-u 1`
protocol (the unconditional prior at the linear schedule, DDRM over the test
split at t*=27) and the `-u 0` protocol at a second train seed, each through
the whole tool (fixture, training, inference, latent, scores) at 64 bins a
chromosome, one block of 16 features, one epoch; a run in two pieces against
the uninterrupted run, the kept checkpoints, a summary written as the call
goes, and `--spread`'s rows."""
import hashlib
import json
import math
import os

import numpy as np
import pytest
import torch

from hicdiff_tpu_torch.convert import params_from_jax
from hicdiff_tpu_torch.train import logging as logging_mod
from hicdiff_tpu_torch.train import trainer as trainer_mod
from hicdiff_tpu_torch.train.checkpoint import load_checkpoint
from tools import torch_fullscale_quality as tool

SIZE = ["--bins", "64", "--blocks", "1", "--features", "16", "--device", "cpu"]
TINY = [*SIZE, "--epochs", "1"]
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
    # the -u 1 sweep: its best checkpoint apart from the seed rows, and its
    # kept checkpoints of epochs 50-150
    assert table["ddrm_sweep"]["seeds"][0] == 0
    swept = table["ddrm_sweep_kept_seed0"]
    assert swept["epochs"] == list(range(50, 160, 10))
    assert swept["pas_psnr"]["min"] <= swept["pas_psnr"]["median"] <= swept["pas_psnr"]["max"]
    # the -u 0 sweeps: both rows of every kept checkpoint of epochs 50-150,
    # each verdict one of the rule's
    assert table["k1_sweep"]["seeds"] == table["t29_sweep"]["seeds"] == [0, 1]
    for row in ("k1", "t29"):
        for seed in (0, 1):
            swept = table[f"{row}_sweep_kept_seed{seed}"]
            assert swept["epochs"] == list(range(50, 160, 10))
            for m in METRICS:
                assert swept[m]["n"] == 11
                assert swept[m]["min"] <= swept[m]["median"] <= swept[m]["max"]
            assert swept["pas_ssim"]["verdict"] in (
                "within one run's checkpoint spread", "systematic") or swept["pas_ssim"][
                "verdict"].startswith("within the limit at epochs ")


def _tool(root, out, *flags):
    tool.main([*SIZE, *flags, "--root", str(root), "--out", str(out)])
    return json.loads(out.read_text())


def _bestg(root) -> dict:
    (path,) = (root / "Model_Weights").glob("bestg_*.msgpack")
    return params_from_jax(load_checkpoint(str(path), only={"params"})["params"])


def test_pieces_add_up_to_the_uninterrupted_run(tmp_path, monkeypatch):
    """Two pieces of one epoch each against one call of two epochs: the
    same batches in the same order, the same losses at each epoch, and the
    same best checkpoint. At train seed 2 the val rises at epoch 2, so the
    second piece writes a worse bestg and the tool must put back the
    first piece's."""
    batches = []
    step = trainer_mod.Trainer.train_step

    def spy(self, data, target, **kw):
        batches.append(hashlib.sha1(np.ascontiguousarray(target).tobytes()).hexdigest())
        return step(self, data, target, **kw)

    monkeypatch.setattr(trainer_mod.Trainer, "train_step", spy)
    flags = ("--train-seed", "2", "--epochs", "2", "--train-only")
    whole = _tool(tmp_path / "whole", tmp_path / "whole.json", *flags)
    whole_batches, batches[:] = list(batches), []
    first = _tool(tmp_path / "pieces", tmp_path / "p1.json", *flags, "--stop-after", "1")
    assert [e["epoch"] for e in first["train"]["epochs"]] == [1]
    last = _tool(tmp_path / "pieces", tmp_path / "p2.json", *flags, "--continue")
    assert batches == whole_batches and len(set(whole_batches)) == 2
    assert [e["epoch"] for e in last["train"]["epochs"]] == [1, 2]
    for key in ("train", "val"):
        assert [e[key] for e in last["train"]["epochs"]] == [e[key] for e in
                                                             whole["train"]["epochs"]]
    assert whole["train"]["best_epoch"] == last["train"]["best_epoch"] == 1
    assert last["train"]["best_val"] == whole["train"]["best_val"]
    assert [p["epochs"] for p in last["train"]["pieces"]] == [[1, 1], [2, 2]]
    want, got = _bestg(tmp_path / "whole"), _bestg(tmp_path / "pieces")
    assert set(got) == set(want)
    for name in want:
        assert torch.equal(got[name], want[name]), name
    # a piece of another protocol does not continue
    with pytest.raises(SystemExit):
        _tool(tmp_path / "pieces", tmp_path / "p3.json", "--epochs", "2", "--continue")


def _inference_spy(monkeypatch, scored: dict, fail_on: str = None):
    """Record each kept checkpoint's Inference call by its out tag: the
    params and step it loaded, and the call's arguments; raise on the tag
    `fail_on`."""
    infer = tool.inference_torch.Inference

    def spy(**kw):
        if kw["out_tag"] == fail_on:
            raise RuntimeError(f"inference of {fail_on} failed")
        if kw["weights"]:
            ck = load_checkpoint(kw["weights"], only={"params", "step"})
            scored[kw["out_tag"]] = (params_from_jax(ck["params"]), ck["step"], kw)
        return infer(**kw)

    monkeypatch.setattr(tool.inference_torch, "Inference", spy)


@pytest.mark.parametrize("u", [0, 1])
def test_kept_checkpoints_are_scored_and_deleted(tmp_path, monkeypatch, u):
    """--keep-every 1 over two epochs: two kept checkpoints, each the
    trainer's params at its epoch and the step it reached (256 bins a
    chromosome: three batches an epoch), run through the protocol's own
    inference without the EMA (`-u 1`: DDRM; `-u 0`: K=1, and t*=29 from
    KEPT_FROM, here epoch 2, on), scored, then deleted."""
    live, trainers = {}, []
    fit, log = trainer_mod.Trainer.fit, logging_mod.MetricLogger.log

    def fit_spy(self, *args, **kw):
        trainers.append(self)
        return fit(self, *args, **kw)

    def log_spy(self, record):  # the params as the epoch ends
        if "Epoch" in record:
            live[record["Epoch"]] = {n: p.detach().clone()
                                     for n, p in trainers[-1].model.named_parameters()}
        return log(self, record)

    scored = {}
    monkeypatch.setattr(trainer_mod.Trainer, "fit", fit_spy)
    monkeypatch.setattr(logging_mod.MetricLogger, "log", log_spy)
    monkeypatch.setattr(tool, "KEPT_FROM", 2)
    _inference_spy(monkeypatch, scored)
    s = _tool(tmp_path / "root", tmp_path / "s.json", "-u", str(u), "--epochs", "2",
              "--keep-every", "1", "--bins", "256", "--train-only")
    assert s["partial"] is False
    assert [k["epoch"] for k in s["kept"]] == [1, 2]
    # the row, its sampling steps and the output's tag of each inference run
    runs = {1: {"ddrm": (None, "_kept1")}, 2: {"ddrm": (None, "_kept2")}} if u else {
        1: {"k1": (1, "_kept1_k1")}, 2: {"t29": (None, "_kept2"), "k1": (1, "_kept2_k1")}}
    assert set(scored) == {tag for r in runs.values() for _, tag in r.values()}
    per_epoch = -(-s["train"]["train_patches"] // 64)
    assert per_epoch > 1
    vals = [e["val"] for e in s["train"]["epochs"]]
    for k in s["kept"]:
        assert set(k["scores"]) == set(k["runs"]) == set(runs[k["epoch"]])
        for row, (steps, tag) in runs[k["epoch"]].items():
            params, step, kw = scored[tag]
            assert step == k["epoch"] * per_epoch
            assert kw["use_ema"] is False and kw["sampling_steps"] == steps
            assert kw["chro"] == ("test" if u else "all")
            for name, p in live[k["epoch"]].items():
                assert torch.equal(params[name], p), (k["epoch"], name)
            # -u 0's rows against the latent alone
            _assert_scores({"scores": k["scores"][row]},
                           ["predict_vs_latent"] + (["predict_vs_target"] if u else []))
            assert not os.path.exists(k["scores"][row]["latent"]["quartet_dir"])
            assert k["runs"][row]["patches"] > 0 and k["runs"][row]["score_s"] > 0
            assert k["runs"][row]["launches"]["fused_resblock"] == 0  # the CPU's plain version
        assert k["val"] == vals[k["epoch"] - 1] and k["best_so_far"] == min(vals[:k["epoch"]])
    assert os.listdir(tmp_path / "root" / "kept") == []
    assert not {"ddrm", "k1", "t29"} & set(s)  # --train-only: the kept are scored all the same


def test_a_failed_call_leaves_the_scored_checkpoints(tmp_path, monkeypatch):
    """--out is written as the call goes: when the second kept checkpoint's
    inference fails, the summary holds the first one's scores, marked
    partial, and no temporary file is left beside it."""
    scored = {}
    _inference_spy(monkeypatch, scored, fail_on="_kept2_k1")
    out = tmp_path / "s.json"
    with pytest.raises(RuntimeError, match="_kept2_k1"):
        _tool(tmp_path / "root", out, "--epochs", "2", "--keep-every", "1", "--train-only")
    s = json.loads(out.read_text())
    assert s["partial"] is True and [e["epoch"] for e in s["train"]["epochs"]] == [1, 2]
    (k,) = s["kept"]
    assert k["epoch"] == 1 and set(k["scores"]) == {"k1"}  # epoch 1 < KEPT_FROM: K=1 alone
    _assert_scores({"scores": k["scores"]["k1"]}, ["predict_vs_latent"])
    assert set(scored) == {"_kept1_k1"}
    assert sorted(os.listdir(tmp_path)) == ["root", "s.json"]


def _kept(psnrs, ssim=0.9):
    """A kept `-u 1` sweep of epochs 10-150, epoch 10 first, in the layout
    the committed sweeps have: DDRM's scores unnested."""
    return [{"epoch": 10 * (i + 1), "val": 0.006, "best_so_far": 0.006, "scores": {
        "predict_vs_latent": dict(zip(METRICS, [ssim, p, 0.0003, 4.6e5, 0.97, 0.56, 0.566]))}}
        for i, p in enumerate(psnrs)]


def _kept_u0(ssims):
    """A kept `-u 0` sweep of epochs 10-150: K=1 at each, t*=29 from epoch
    50 on, its SSIM 0.052 below K=1's (JAX's two rows lie so apart)."""
    def row(ssim):
        return {"predict_vs_latent": dict(zip(METRICS, [ssim, 35.8, 0.000225, 2.07e6, 0.978,
                                                        0.63, 0.57]))}
    return [{"epoch": e, "val": 0.005, "best_so_far": 0.005, "scores": {"k1": row(x)} | (
        {"t29": row(x - 0.052)} if e >= 50 else {})} for e, x in zip(range(10, 160, 10), ssims)]


# each case's DDRM PSNR (JAX 34.74, limit 0.5 dB) and `-u 0` K=1 SSIM
# (JAX 0.912, limit 0.02) along a sweep of epochs 10-150 get one verdict
@pytest.mark.parametrize("psnrs, ssims, said", [
    # epoch 10's 34.0 is left out: from epoch 50 on, 35.3-36.1 lies above 35.24
    ([34.0] + [35.0] * 3 + [35.3 + 0.08 * i for i in range(11)],
     [0.95] + [0.90] * 3 + [0.85 + 0.004 * i for i in range(11)], "systematic"),
    ([35.0] * 4 + [35.6] * 9 + [35.2, 35.9], [0.9] * 4 + [0.88] * 9 + [0.895, 0.87],
     "within the limit at epochs 140"),
    ([35.0] * 4 + [35.6] * 5 + [34.5] + [35.6] * 5, [0.9] * 4 + [0.905] * 5 + [0.92] + [0.9] * 5,
     "within one run's checkpoint spread"),
])
def test_spread_reads_fp32_rows_and_the_kept_sweep(tmp_path, capsys, psnrs, ssims, said):
    tables, validation = tmp_path / "tables.txt", tmp_path / "VALIDATION.md"
    tables.write_text(JAX_TABLES)
    validation.write_text(JAX_VALIDATION)
    paths = []

    def put(name, summary):
        p = tmp_path / name
        p.write_text(json.dumps(summary))
        paths.append(str(p))

    # -u 0 bf16 seeds: K=1 SSIM 0.90-0.91 (JAX 0.912), SPC 0.60-0.66 (JAX 0.657)
    for seed, (ssim, spc) in enumerate(((0.90, 0.60), (0.91, 0.66))):
        row = [ssim, 35.86, 0.000225, 2.072e6, 0.978, spc, 0.568]
        put(f"u0_{seed}.json", _summary(0, seed, {"t29": row, "k1": row}, 0.005, 140))
    # fp32: SSIM 0.915 beyond the range on JAX's side; SPC 0.65 inside;
    # kept checkpoints scored at K=1 alone
    fp32 = [0.915, 35.86, 0.000225, 2.072e6, 0.978, 0.65, 0.568]
    put("u0_fp32.json", _summary(0, 0, {"t29": fp32, "k1": fp32}, 0.0049, 130) | {
        "precision": "float32", "kept": [
            {"epoch": e, "scores": {"k1": {"predict_vs_latent": dict(zip(METRICS, [
                0.905 + 0.001 * i, 35.8, 0.000225, 2.07e6, 0.978, 0.63, 0.57]))}}}
            for i, e in enumerate(range(10, 160, 10))]})
    # a bf16 -u 0 sweep at seed 0, beside the seed rows
    put("u0_sweep.json", _summary(0, 0, {"t29": fp32, "k1": fp32}, 0.005, 140) | {
        "kept": _kept_u0(ssims)})
    put("u1_sweep.json", _summary(1, 0, {"ddrm": [0.9, 35.5, 0.0003, 4.6e5, 0.97, 0.56,
                                                  0.566]}, 0.006, 140) | {"kept": _kept(psnrs)})
    table = tool.spread(paths, str(tables), str(validation))
    assert {"k1", "k1_fp32", "t29_fp32", "k1_fp32_kept_seed0", "best_val_u0_fp32",
            "ddrm_sweep", "ddrm_sweep_kept_seed0", "best_val_u1_sweep", "k1_sweep", "t29_sweep",
            "k1_sweep_kept_seed0", "t29_sweep_kept_seed0", "best_val_u0_sweep"} <= set(table)
    assert "ddrm" not in table  # the sweep repeats a seed: rows of its own
    assert "t29_fp32_kept_seed0" not in table  # no checkpoint scored at t*=29
    assert table["k1"]["seeds"] == [0, 1] and table["k1_sweep"]["seeds"] == [0]
    k1 = table["k1_fp32"]
    assert k1["seeds"] == [0] and k1["pas_ssim"]["bf16"] == "bf16 training implicated"
    assert k1["pas_spc"]["bf16"] == "bf16 training not implicated"
    swept = table["k1_fp32_kept_seed0"]
    assert swept["epochs"] == list(range(50, 160, 10))
    assert (swept["pas_ssim"]["min"], swept["pas_ssim"]["max"]) == pytest.approx((0.909, 0.919))
    assert swept["pas_ssim"]["verdict"] == "within one run's checkpoint spread"
    assert swept["pas_spc"]["verdict"] == "outside one run's checkpoint spread"
    psnr = table["ddrm_sweep_kept_seed0"]["pas_psnr"]
    assert psnr["n"] == 11 and psnr["jax"] == 34.74 and psnr["verdict"] == said
    for row, jax in (("k1", 0.912), ("t29", 0.86)):
        kept = table[f"{row}_sweep_kept_seed0"]
        assert kept["epochs"] == list(range(50, 160, 10))
        ssim = kept["pas_ssim"]
        assert ssim["n"] == 11 and ssim["jax"] == jax and ssim["verdict"] == said, row
        for m in ("pas_spc", "pas_gds"):  # no limit: two ways
            assert kept[m]["verdict"] == "outside one run's checkpoint spread", (row, m)
    tool.print_spread(table)
    out = capsys.readouterr().out
    assert "; bf16 training implicated |" in out and f"| {said} |" in out
    assert "| k1_fp32_kept_seed0 (seed 0), epochs 50-150 | min (epoch) |" in out
    assert "| t29_sweep_kept_seed0 (seed 0), epochs 50-150 | min (epoch) |" in out
