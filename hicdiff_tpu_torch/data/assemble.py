"""Patch -> chromosome reassembly and denoised contact-map export (port of
hicdiff_tpu/data/assemble.py).

- `band_tile_offsets` re-derives the (i, j) grid position of every patch by
  mirroring `split_pieces`' enumeration;
- `assemble_chromosome` scatters patches into a symmetric dense matrix
  (off-band entries stay 0);
- `write_mcool` writes a minimal single-resolution .mcool (the cooler layout
  `data/mcool.py` reads) through `data/mcool.py:write_cooler`.

Matrices are in the pipeline's normalized space ([-1, 1], percentile-clipped
Full_Mats units, compacted rows); `to_unit` rescales to [0, 1] for export.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import numpy as np

from hicdiff_tpu_torch.data.mcool import write_cooler

__all__ = [
    "band_tile_offsets",
    "assemble_chromosome",
    "assemble_by_chromosome",
    "to_unit",
    "write_mcool",
]


def band_tile_offsets(
    n_bins: int, piece_size: int = 64, step: Optional[int] = None, resol: int = 40000,
) -> np.ndarray:
    """(n_tiles, 2) upper-triangle (i, j) tile origins in `split_pieces`'
    order (so `patches[k]` sits at `offsets[k]`); `step` defaults to
    `piece_size`."""
    step = piece_size if step is None else step
    scal = int(40000 / resol)
    rest = n_bins % piece_size
    bound = n_bins + (piece_size - rest if rest else 0)
    band = int(piece_size * 4 * scal + 1)
    offsets = [
        (i, j)
        for i in range(0, bound, step)
        for j in range(i, bound, step)
        if abs(i - j) <= band and i + step <= bound and j + step <= bound
    ]
    return np.asarray(offsets, dtype=np.int64).reshape(-1, 2)


def assemble_chromosome(
    patches: np.ndarray,
    n_bins: int,
    piece_size: int = 64,
    step: Optional[int] = None,
    resol: int = 40000,
    symmetrize: bool = True,
) -> np.ndarray:
    """Scatter (n, 1, p, p) or (n, p, p) patches back into an (n_bins, n_bins)
    matrix, the inverse of `split_pieces` on the band; off-band entries are 0.
    Diagonal tiles are averaged with their transpose and off-diagonal tiles
    mirrored, so the result is symmetric."""
    patches = np.asarray(patches, dtype=np.float32)
    if patches.ndim == 4:  # NCHW (cache layout) or NHWC (device layout)
        patches = patches[:, 0] if patches.shape[1] == 1 else patches[..., 0]
    offsets = band_tile_offsets(n_bins, piece_size, step, resol)
    if patches.shape[0] != offsets.shape[0]:
        raise ValueError(
            f"{patches.shape[0]} patches for a {n_bins}-bin chromosome; the "
            f"band grid has {offsets.shape[0]} tiles — wrong chromosome, "
            "piece size, or resolution"
        )
    bound = n_bins + ((piece_size - n_bins % piece_size) % piece_size)
    mat = np.zeros((bound, bound), dtype=np.float32)
    for (i, j), tile in zip(offsets, patches):
        if symmetrize and i == j:
            mat[i : i + piece_size, j : j + piece_size] = (tile + tile.T) / 2.0
        else:
            mat[i : i + piece_size, j : j + piece_size] = tile
            if symmetrize:
                mat[j : j + piece_size, i : i + piece_size] = tile.T
    return mat[:n_bins, :n_bins]


def assemble_by_chromosome(
    patches: np.ndarray,
    inds: np.ndarray,
    n_bins_per_chrom: Mapping[int, int],
    piece_size: int = 64,
    step: Optional[int] = None,
    resol: int = 40000,
) -> Dict[int, np.ndarray]:
    """Group concatenated predictions by their `inds` chromosome labels
    (patches stay in split order within a chromosome: the test loader never
    shuffles) and assemble each chromosome in `n_bins_per_chrom`."""
    patches = np.asarray(patches)
    inds = np.asarray(inds)
    out: Dict[int, np.ndarray] = {}
    for chro, n_bins in n_bins_per_chrom.items():
        sel = patches[inds == chro]
        if sel.shape[0] == 0:
            continue
        out[chro] = assemble_chromosome(sel, n_bins, piece_size, step, resol)
    return out


def to_unit(mat: np.ndarray) -> np.ndarray:
    """[-1, 1] normalized space -> [0, 1] (inverse_data_transform 'rescaled')."""
    return np.clip((np.asarray(mat) + 1.0) / 2.0, 0.0, 1.0)


def write_mcool(
    path: str,
    res: int,
    mats: Mapping[int, np.ndarray],
    chrom_names: Optional[Sequence[str]] = None,
    value_scale: float = 1.0,
) -> str:
    """Write per-chromosome dense matrices as a minimal single-resolution
    .mcool (chroms/, bins/, pixels/ with bin1_offset and chrom_offset
    indexes, unit weights) through the port's HDF5 writer. `mats` maps a
    chromosome NUMBER (1-based, the pipeline's `inds` label) to a dense
    symmetric matrix; the upper triangle's nonzero entries are stored as
    float32 counts times `value_scale`."""
    chros = sorted(mats)
    names = chrom_names or [f"chr{c}" for c in chros]
    sizes = [int(mats[c].shape[0]) for c in chros]

    bin1, bin2, count = [], [], []
    offset = 0
    for c, n in zip(chros, sizes):
        iu, ju = np.triu_indices(n)
        vals = np.asarray(mats[c], dtype=np.float32)[iu, ju] * value_scale
        keep = vals != 0
        bin1.append(iu[keep] + offset)
        bin2.append(ju[keep] + offset)
        count.append(vals[keep])
        offset += n
    bin1 = np.concatenate(bin1).astype(np.int64)
    bin2 = np.concatenate(bin2).astype(np.int64)
    count = np.concatenate(count).astype(np.float32)
    order = np.lexsort((bin2, bin1))
    return write_cooler(path, res, names, sizes, bin1[order], bin2[order], count[order],
                        np.ones(int(sum(sizes))))
