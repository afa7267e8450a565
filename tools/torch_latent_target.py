"""Attach the latent (pre-Poisson) ground truth to a saved Outputs_diff
quartet: the port of tools/latent_target.py, on the port's data module.

The full-scale synthetic cell (tools/torch_make_fullscale_fixture.py) draws
every count from a Poisson rate lam(i, j); the realized counts carry a
speckle no denoiser can remove, so the quartet is also scored against lam
itself. This tool rebuilds lam on the quartet's [-1, 1] scale and writes it
as `latent.npy` (NCHW, in the quartet's patch order):

  python tools/torch_make_fullscale_fixture.py --root DIR --latent-dir LDIR
  python tools/torch_latent_target.py --quartet-dir DIR/Outputs_diff/<run> \\
      --datafull-dir DIR/DataFull/DataFull_... --latent-dir LDIR --percentile 99.99
  python tools/torch_quartet_metrics.py --dir DIR/Outputs_diff/<run> --target-file latent.npy

The latent is balanced with the same weights, row-dropped with the same
removeidx and clipped and scaled at the same percentile value as the
observed matrix the prep normalized, so latent and realized target share
one scale and differ only by the sampling noise. The weights are the
fixture's `weights_chr{i}.npy` beside the latents, or those of an .mcool
(--mcool, read through the port's McoolFile).
"""
import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from hicdiff_tpu_torch.data.fastio import load_coo_txt  # noqa: E402
from hicdiff_tpu_torch.data.preprocess import (  # noqa: E402
    apply_normalize_stats,
    coo_to_dense,
    normalize_matrix_stats,
    split_pieces,
)

__all__ = ["latent_pieces_for_chrom", "build_latent_npy"]


def _observed_stats(constraints_dir: str, chro: int, res: int, percentile: float):
    """Replay the prep's normalization of the observed matrix
    (`load_both_constraints`) and return its bin range and statistics."""
    a = load_coo_txt(os.path.join(constraints_dir, f"chrom_{chro}_{res}.txt"))
    b = load_coo_txt(os.path.join(constraints_dir, f"chrom_{chro}_count.txt"))
    rows = np.concatenate([a[:, 0], a[:, 1], b[:, 0], b[:, 1]]) / res
    bigbin, smallbin = int(rows.max()), int(rows.min())
    mata, _, _ = coo_to_dense(a[:, 0], a[:, 1], a[:, 2], res, smallbin=smallbin, bigbin=bigbin)
    _, removeidx, per = normalize_matrix_stats(mata, percentile)
    return smallbin, bigbin, removeidx, per


def _latent_dense(lam_band: np.ndarray, weights: np.ndarray) -> np.ndarray:
    """(n, band) latent rates and per-bin weights -> the symmetric dense
    balanced latent (NaN weights -> 0; the shared removeidx drops those rows)."""
    n, band = lam_band.shape
    w = np.nan_to_num(weights, nan=0.0)
    dense = np.zeros((n, n), np.float32)
    for d in range(band):
        m = n - d
        if m <= 0:
            break
        i = np.arange(m)
        vals = lam_band[:m, d] * w[i] * w[i + d]
        dense[i, i + d] = vals
        dense[i + d, i] = vals
    return dense


def _weights_of(latent_dir: str, chro: int, mcool=None) -> np.ndarray:
    """Chromosome `chro`'s balancing weights: the fixture's file, or the
    .mcool's bins/weight column."""
    if mcool is not None:
        return mcool.weights(mcool.chromnames[chro - 1])
    return np.load(os.path.join(latent_dir, f"weights_chr{chro}.npy"))


def latent_pieces_for_chrom(latent_dir: str, constraints_dir: str, chro: int, res: int,
                            percentile: float, piece_size: int = 64, mcool=None) -> np.ndarray:
    """One chromosome's latent band patches on the observed quartet's
    [-1, 1] scale, in `split_pieces` order: 1:1 with the prep's targets."""
    lam_band = np.load(os.path.join(latent_dir, f"latent_chr{chro}.npy"))
    smallbin, bigbin, removeidx, per = _observed_stats(constraints_dir, chro, res, percentile)
    weights = _weights_of(latent_dir, chro, mcool)
    if lam_band.shape[0] != weights.shape[0] or lam_band.shape[0] <= bigbin:
        raise ValueError(
            f"chr{chro}: latent has {lam_band.shape[0]} bins but the fixture has "
            f"{weights.shape[0]} (observed range ..{bigbin}): latent_dir was generated "
            "with another seed or bin table than this fixture"
        )
    lam_band = lam_band[smallbin:bigbin + 1]
    weights = weights[smallbin:bigbin + 1]
    dense = _latent_dense(lam_band, weights)
    norm = np.float32(apply_normalize_stats(dense, removeidx, per))
    return split_pieces(norm, piece_size, piece_size, resol=res)


def build_latent_npy(quartet_dir: str, datafull_dir: str, latent_dir: str, res: int = 40000,
                     percentile: float = 99.0, piece_size: int = 64, mcool: str = None) -> dict:
    """Write `<quartet_dir>/latent.npy` aligned with the quartet's inds."""
    inds = np.load(os.path.join(quartet_dir, "inds.npy"))
    target = np.load(os.path.join(quartet_dir, "target.npy"))
    constraints = os.path.join(datafull_dir, "Constraints")
    mc = None
    if mcool is not None:
        from hicdiff_tpu_torch.data.mcool import McoolFile

        mc = McoolFile(mcool, res)

    # chromosomes in order of first appearance in inds: the dataset's order
    chros = list(dict.fromkeys(int(c) for c in inds))
    parts = []
    for c in chros:
        pieces = latent_pieces_for_chrom(latent_dir, constraints, c, res, percentile,
                                         piece_size, mcool=mc)
        n_expect = int((inds == c).sum())
        if pieces.shape[0] != n_expect:
            raise ValueError(
                f"chr{c}: latent yields {pieces.shape[0]} pieces but the quartet has "
                f"{n_expect}: latent_dir or seed does not match this quartet's fixture"
            )
        parts.append(pieces)
    latent = np.concatenate(parts).astype(np.float32)
    if latent.shape != target.shape:
        raise ValueError(f"latent {latent.shape} vs target {target.shape}")
    np.save(os.path.join(quartet_dir, "latent"), latent)

    flat_l, flat_t = latent.ravel(), target.ravel()
    corr = float(np.corrcoef(flat_l, flat_t)[0, 1])
    return {
        "quartet_dir": quartet_dir,
        "n_patches": int(latent.shape[0]),
        "chromosomes": chros,
        "corr_latent_target": round(corr, 4),
        "speckle_rms": round(float(np.sqrt(np.mean((flat_l - flat_t) ** 2))), 5),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quartet-dir", required=True)
    ap.add_argument("--datafull-dir", required=True,
                    help="the DataFull_... cache whose Constraints/ the prep normalized")
    ap.add_argument("--latent-dir", required=True,
                    help="latent_chr{i}.npy (and weights_chr{i}.npy) from "
                         "torch_make_fullscale_fixture.py --latent-dir, same seed")
    ap.add_argument("--mcool", default=None,
                    help="take the weights from this .mcool instead")
    ap.add_argument("--res", type=int, default=40000)
    ap.add_argument("--percentile", type=float, default=99.0,
                    help="99.0 population cells (1/22), 99.99 single cells: that of "
                         "the prep that produced the quartet")
    args = ap.parse_args(argv)
    info = build_latent_npy(args.quartet_dir, args.datafull_dir, args.latent_dir,
                            res=args.res, percentile=args.percentile, mcool=args.mcool)
    print(json.dumps(info))


if __name__ == "__main__":
    main()
