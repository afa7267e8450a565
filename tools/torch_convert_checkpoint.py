#!/usr/bin/env python
"""Convert a reference HiCDiff .pytorch checkpoint to the msgpack layout both
packages read, with PyTorch alone: the port's counterpart of
tools/convert_torch_checkpoint.py (same flags), importing no JAX.

    python tools/torch_convert_checkpoint.py bestg_..._HiCedrn_cond_l2_sig.pytorch \
        --out Model_Weights/bestg_..._HiCedrn_cond_l2_sig.msgpack

The file is read with torch.load(weights_only=True): a bare backbone state
dict or the reference's torch.save(GaussianDiffusion.state_dict()), whose
backbone keys are `model.`-prefixed and whose schedule buffers are dropped
(`convert.state_dict_from_reference`). The port's backbone names are the
reference's, so the params tree is `convert.params_to_jax` of it, written
by the port's checkpoint codec.
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from hicdiff_tpu_torch.convert import params_to_jax, state_dict_from_reference  # noqa: E402
from hicdiff_tpu_torch.train.checkpoint import save_checkpoint  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("checkpoint", help=".pytorch file (torch.save'd state dict)")
    ap.add_argument("--out", required=True, help="output .msgpack path")
    args = ap.parse_args(argv)

    sd = state_dict_from_reference(
        torch.load(args.checkpoint, map_location="cpu", weights_only=True))
    save_checkpoint(args.out, params_to_jax(sd))
    n = sum(v.numel() for v in sd.values())
    print(f"converted {args.checkpoint} -> {args.out} ({n:,} params)")


if __name__ == "__main__":
    main()
