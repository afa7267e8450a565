#!/usr/bin/env python
"""Export a msgpack backbone checkpoint (either package's) to the
reference's torch state-dict layout, with PyTorch alone: the port's
counterpart of tools/export_torch_checkpoint.py (same flags), importing no
JAX.

    python tools/torch_export_checkpoint.py Model_Weights/bestg_....msgpack \
        --out bestg_....pytorch [--use-ema] [--diffusion-prefix]

Keys are bare (`head.weight`, ...) for the reference's hicedrn_Diff
load_state_dict; --diffusion-prefix writes them `model.`-prefixed, the
layout of its torch.save(GaussianDiffusion.state_dict()), without the
schedule buffers (load with strict=False or into the bare backbone).
--use-ema exports the EMA weights when the checkpoint has them.
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from hicdiff_tpu_torch.convert import params_from_jax, state_dict_to_reference  # noqa: E402
from hicdiff_tpu_torch.train.checkpoint import load_checkpoint  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("checkpoint", help=".msgpack checkpoint")
    ap.add_argument("--out", required=True, help="output .pytorch path")
    ap.add_argument("--use-ema", action="store_true", help="export the EMA weights if present")
    ap.add_argument("--diffusion-prefix", action="store_true",
                    help="prefix keys with 'model.' (GaussianDiffusion layout)")
    args = ap.parse_args(argv)

    ck = load_checkpoint(args.checkpoint, only={"params", "ema_params"})
    params = ck["ema_params"] if args.use_ema and ck.get("ema_params") else ck["params"]
    sd = state_dict_to_reference(params_from_jax(params),
                                 prefix="model." if args.diffusion_prefix else "")
    torch.save(sd, args.out)
    n = sum(v.numel() for v in sd.values())
    print(f"exported {args.checkpoint} -> {args.out} ({n:,} params)")


if __name__ == "__main__":
    main()
