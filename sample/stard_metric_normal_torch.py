#!/usr/bin/env python
"""Baseline evaluation on PyTorch/CUDA: the port of
sample/stard_metric_normal.py. It runs the six baseline generators (or
--models) over the cell's test split through the port's metrics harness
(SSIM/PSNR/MSE/SNR/PCC/SPC/GenomeDISCO, the Outputs_diff quartet under
`{model}{cell}{n}_deno_{sigma}_normal`) and appends the table to
Metrics/{cell}{n}_deno_{sigma}_normal.txt. A model without a checkpoint
(`models/zoo.py` baseline_checkpoint_path) is evaluated from its fresh init
with a notice. --device defaults to cuda; there is no fallback to the CPU:

    python sample/stard_metric_normal_torch.py [-n 1] [-l Human] [-s 0.1] [--root DIR]
        [--models hiedsr hicplus] [--weights-dir DIR] [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from hicdiff_tpu_torch.metrics.harness import evaluate_model  # noqa: E402
from hicdiff_tpu_torch.models.zoo import TABLE_BASELINES as MODELS  # noqa: E402
from hicdiff_tpu_torch.models.zoo import baseline_checkpoint_path, load_baseline  # noqa: E402

METRIC_NAMES = ["ssim", "psnr", "mse", "snr", "pcc", "spc", "gds"]


def create_parser(argv=None):
    ap = argparse.ArgumentParser(description="Baseline metrics (PyTorch/CUDA)")
    ap.add_argument("-n", "--celln", type=int, default=1)
    ap.add_argument("-l", "--celline", type=str, default="Human")
    ap.add_argument("-s", "--sigma", type=float, default=0.1)
    ap.add_argument("--root", type=str, default=None)
    ap.add_argument("--models", nargs="*", default=list(MODELS))
    ap.add_argument("--weights-dir", type=str, default=None)
    ap.add_argument("--device", default="cuda", help="torch device to run on (default cuda)")
    return ap.parse_args(argv)


def main(argv=None):
    """Returns {name: (the harness's result, had_checkpoint)}."""
    args = create_parser(argv)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device(args.device)
    root = args.root or os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    wdir = args.weights_dir or os.path.join(root, "Model_Weights")
    deg, sigma = "deno", args.sigma

    results = {}
    for name in args.models:
        model_fn, had = load_baseline(name, wdir=wdir, cell_line=args.celline, celln=args.celln,
                                      deg=deg, sigma=sigma, device=device)
        if not had:
            ckpt = baseline_checkpoint_path(wdir, name, args.celline, args.celln, deg, sigma)
            print(f"[{name}] no checkpoint at {ckpt}; evaluating fresh init")
        print(name)
        res = evaluate_model(model_fn, model_name=name, chro="test", deg=deg, sigma=sigma,
                             cellN=args.celln, cell_line=args.celline, root=root,
                             result_tag="_normal")
        results[name] = (res, had)

    # the metrics table (stard_metric_normal.py:140-161)
    gds_dir = os.path.join(root, "Metrics")
    os.makedirs(gds_dir, exist_ok=True)
    with open(os.path.join(gds_dir, f"{args.celline}{args.celln}_{deg}_{sigma}_normal.txt"),
              "a") as f:
        for name in args.models:
            f.write(f"\n{name}\n")
            metrics = results[name][0]["metrics"]
            for met in METRIC_NAMES:
                f.write(f"{met}:\t{metrics.get('pas_' + met, float('nan'))}\n")
    for name in args.models:
        print(name, {k: round(v, 4) for k, v in results[name][0]["metrics"].items()})
    return results


if __name__ == "__main__":
    main()
