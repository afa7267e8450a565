"""tools/torch_card_trajectory.py on the CPU at a tiny size: with
`--device cpu` both "card" sides run the plain twins, so every bar holds
(the card's sides equal the CPU's bit for bit); weights perturbed on the
card's bf16 side after its first step must fail the bf16 bar."""
import json

import pytest
import torch

from tools import torch_card_trajectory as tool

TINY = dict(device=torch.device("cpu"), steps=3, batch=2, blocks=2, features=16, size=16,
            seed=0)


@pytest.mark.parametrize("mode", ["u0", "u1"])
def test_twins_hold_every_bar(mode):
    summary, detail = tool.run_mode(mode, **TINY)
    assert summary["ok"], summary["bars"]
    assert all(summary["bars"].values())
    bf16 = summary["bf16"]
    assert bf16["params_l2_card_vs_cpu_bf16"] == 0 and bf16["loss_gap_max"] == 0
    assert bf16["params_l2_card_vs_cpu_fp32"] == bf16["params_l2_cpu_bf16_vs_cpu_fp32"] > 0
    assert len(bf16["loss_gap_per_step"]) == len(summary["fp32"]["loss_gap_per_step"]) == 3
    assert summary["fp32"]["params"]["outliers"] == summary["fp32"]["mu"]["outliers"] == 0
    assert summary["first_step"]["bf16_first_leaf_beyond"] is None
    assert set(detail["losses"]) == {"card_bf16", "card_fp32", "cpu_bf16", "cpu_fp32"}
    # every leaf of the model is compared, the first step's gradients too:
    # head, time MLP, each block's conv and Dense, body tail, tail
    n_leaves = len(detail["first_step_grads"]["bf16_card_vs_cpu"])
    assert n_leaves == 2 + 4 + 4 * TINY["blocks"] + 2 + 2 == len(
        detail["params_l2_by_leaf"]["card_bf16_vs_cpu_fp32"])


def _perturb(side, model):
    if side == "card_bf16":
        g = torch.Generator().manual_seed(5)
        with torch.no_grad():
            for p in model.parameters():
                p.add_(1e-3 * torch.randn(p.shape, generator=g))


def test_perturbed_card_side_fails_the_bf16_bar():
    summary, detail = tool.run_mode("u0", **TINY, after_first_step=_perturb)
    assert not summary["ok"]
    assert not summary["bars"]["bf16_params"]
    bf16 = summary["bf16"]
    # far from both the twin and fp32, so the min of the two fails
    assert bf16["params_l2_card_vs_cpu_bf16"] > bf16["params_l2_cpu_bf16_vs_cpu_fp32"]
    assert bf16["params_l2_card_vs_cpu_fp32"] > bf16["params_l2_cpu_bf16_vs_cpu_fp32"]
    # the other sides are untouched
    assert summary["bars"]["fp32_loss"] and summary["bars"]["fp32_params"]
    # the perturbation comes after the first step: its gradients still agree
    assert summary["first_step"]["bf16_first_leaf_beyond"] is None


def test_cli_writes_one_line_a_mode(tmp_path, capsys):
    out = tmp_path / "traj.json"
    tool.main(["--device", "cpu", "--blocks", "2", "--features", "16", "--size", "16",
               "--steps", "2", "--out", str(out)])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if '"bars"' in x]
    assert [x["mode"] for x in lines] == ["u0", "u1"] and all(x["ok"] for x in lines)
    assert set(lines[0]["wall_s"]) == {"card_bf16", "card_fp32", "cpu_bf16", "cpu_fp32"}
    saved = json.loads(out.read_text())
    assert set(saved) == {"u0", "u1"} and "detail" in saved["u1"]


def test_diagnose_names_the_blocks_and_the_rounding():
    """--diagnose on the host: the first step's head, blocks and output in
    forward order, the fifth side, and where a bf16 layer with a bias
    rounds: the port's convs and Dense layers round the product, then its
    sum with the bias, as flax's Conv and Dense (and the card's cuDNN) do;
    PyTorch's own call with the bias rounds once on the CPU (oneDNN folds
    the bias into the fp32 sum)."""
    summary, detail = tool.run_mode("u1", **TINY | {"steps": 1}, diagnose=True)
    acts = detail["first_step_grads"]["acts"]
    assert list(acts) == ["head", "body.0", "body.1", "output"]
    assert all(twin == 0 and excess == 1 for twin, excess in acts.values())
    diag = summary["diagnose"]
    assert diag["card_bf16_fp32_reduction"]["params_l2_to_card_bf16"] == 0
    rounding = diag["bias_rounding"]
    layers = ("head", "body_tail", "tail", "body.0.mlp.1", "noise_level_mlp.1")
    assert set(rounding) == set(layers)
    # every element but where the reference's fp32 sum, in another order,
    # flips a rounding: 2-4 of the body tail's 131,072 (144 terms a sum)
    for where in ("card", "cpu"):  # both the host here
        for layer in layers:
            assert rounding[layer][f"{where}_port_equal_double"] >= 1 - 1e-4, (layer, where)
            assert rounding[layer][f"{where}_torch_equal_single"] >= 1 - 1e-4, (layer, where)
    for layer in ("head", "tail", "body.0.mlp.1", "noise_level_mlp.1"):  # short sums: all
        assert rounding[layer]["cpu_port_equal_double"] == 1, layer
        assert rounding[layer]["cpu_torch_equal_single"] == 1, layer
    for layer in layers:  # the two roundings differ, so the shares above tell them apart
        assert rounding[layer]["single_vs_double_equal"] < 0.9, layer
