"""Full-scale synthetic human cell for the PyTorch port, written as the
contact lists the port's data module extracts from an .mcool, or as the
.mcool itself: the port of tools/make_fullscale_fixture.py.

The cell is the JAX tool's, pixel for pixel: hg19 bin counts at 40 kb
(72,031 bins over chr1..chr22), per chromosome a power-law band of Poisson
counts BAND bins wide, enriched 2.5x inside random TAD blocks and modulated
by a per-bin coverage bias; balancing weights uniform in [0.5, 1.5] with 5%
NaN. The generator consumes `np.random.default_rng(seed)` in the JAX tool's
order (the weights, the NaN choice, then one `band_pixels` per chromosome),
so a seed gives the same counts and latents bit for bit.

By default it writes, instead of the .mcool, what
`HiCDataModule.extract_constraint_mats` would write from it,

  <root>/DataFull/DataFull_Human_cell<n>_40000_deno_<sigma><marker>/Constraints/
      chrom_{i}_40000.txt   start1, start2, count * w[bin1] * w[bin2] (NaN -> 0)
      chrom_{i}_count.txt   start1, start2, count

byte-equal to that stage's text, so `prepare_data` starts from them. The
directory is the data module's for (--sigma, --percentile): the trainer
prepares the single-cell percentile 99.99, whose cache ends in `_p99.99`,
and inference adopts the checkpoint's percentile. With --latent-dir it also
writes, per chromosome, `latent_chr{i}.npy` (the (n, band) pre-Poisson
rates) and `weights_chr{i}.npy` (the bins' balancing weights, NaN kept), the
inputs of tools/torch_latent_target.py. With --mcool PATH it writes the
JAX tool's .mcool instead, through the port's HDF5 writer.

  python tools/torch_make_fullscale_fixture.py --root DIR --latent-dir DIR/latent
  python tools/torch_make_fullscale_fixture.py --mcool DIR/Datasets/Human/cell1_synth.mcool
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from hicdiff_tpu_torch.data.datamodule import GSE130711Module  # noqa: E402
from hicdiff_tpu_torch.data.fastio import save_coo_txt  # noqa: E402
from hicdiff_tpu_torch.data.mcool import write_cooler  # noqa: E402

__all__ = ["HG19_BINS_40KB", "PATCH_BAND", "band_pixels", "cell_pixels", "make_fullscale",
           "make_fullscale_mcool", "constraints_dir"]

# hg19 chromosome lengths // 40000 (chr1..chr22)
HG19_BINS_40KB = [
    6232, 6080, 4951, 4779, 4523, 4278, 3979, 3659, 3530, 3389,
    3376, 3346, 2880, 2684, 2563, 2259, 2030, 1952, 1479, 1576,
    1203, 1283,
]

#: the prep path's patch band (piece_size * 4 * scal + 1 = 257): a narrower
#: generated band leaves the far-band patches with empty targets
PATCH_BAND = 64 * 4 + 1


def band_pixels(n: int, rng, band: int = PATCH_BAND, tad_boost: float = 2.5,
                latent_out: list = None):
    """Upper-triangle COO (i, j, count) of one chromosome, one diagonal
    offset at a time.

    latent_out: a list to which the latent band intensity, the Poisson rate
    lam(i, i+d) each count is drawn from, is appended as an (n, band)
    float32 array (entry [i, d]; 0 past the chromosome's end). Capturing it
    consumes no randomness."""
    seg_len = rng.integers(5, 26, size=n // 5 + 2)  # TAD blocks of 5-25 bins
    bounds = np.cumsum(seg_len)
    tad_id = np.searchsorted(bounds, np.arange(n), side="right")
    bias = rng.lognormal(0.0, 0.25, size=n)  # per-bin coverage bias

    lam_band = np.zeros((n, band), np.float32) if latent_out is not None else None
    rows, cols, counts = [], [], []
    for d in range(band):
        m = n - d
        if m <= 0:
            break
        i = np.arange(m)
        j = i + d
        lam = 25.0 / (1.0 + d) ** 0.85
        lam = lam * np.where(tad_id[i] == tad_id[j], tad_boost, 1.0)
        lam = lam * bias[i] * bias[j]
        if lam_band is not None:
            lam_band[:m, d] = lam
        c = rng.poisson(lam)
        if d == 0:
            c = np.maximum(c, 1)  # prep drops rows with a zero diagonal
        keep = c > 0
        rows.append(i[keep])
        cols.append(j[keep])
        counts.append(c[keep])
    if latent_out is not None:
        latent_out.append(lam_band)
    return (
        np.concatenate(rows),
        np.concatenate(cols),
        np.concatenate(counts).astype(np.int32),
    )


def constraints_dir(root: str, sigma: float = 0.1, percentile: float = 99.99,
                    cell_no: int = 1, res: int = 40000) -> str:
    """The Constraints/ directory the port's data module reads for these
    settings (its cache-directory rule)."""
    dm = GSE130711Module(root=root, sigma_0=sigma, percentile=percentile, cell_No=cell_no,
                         res=res, deg="deno")
    return os.path.join(dm.dirname, "Constraints")


def cell_pixels(seed: int = 7, bins_per_chrom=None, nan_weight_frac: float = 0.05,
                band: int = PATCH_BAND):
    """(weights, chromosomes) of the cell: the bins' balancing weights (NaN
    kept), and an iterator over the chromosomes of (rows, cols, counts) in
    the cooler's pixel order, with the (n, band) latent. The generator is
    consumed in the JAX tool's order as the iterator advances."""
    bins_per_chrom = bins_per_chrom or HG19_BINS_40KB
    rng = np.random.default_rng(seed)
    n_bins = int(np.sum(bins_per_chrom))
    weights = rng.uniform(0.5, 1.5, size=n_bins)
    weights[rng.choice(n_bins, int(nan_weight_frac * n_bins), replace=False)] = np.nan

    def chromosomes():
        for n in bins_per_chrom:
            latent_out = []
            r, c, v = band_pixels(n, rng, band=band, latent_out=latent_out)
            order = np.lexsort((c, r))  # the cooler's pixel order
            yield r[order].astype(np.int64), c[order].astype(np.int64), v[order], latent_out[0]

    return weights, chromosomes()


def make_fullscale(outdir: str, res: int = 40000, seed: int = 7, bins_per_chrom=None,
                   nan_weight_frac: float = 0.05, latent_dir: str = None,
                   band: int = PATCH_BAND):
    """Write chrom_{i}_{res,count}.txt for every chromosome into `outdir`
    (and the latents and weights into `latent_dir`); returns (bins, pixels)."""
    bins_per_chrom = bins_per_chrom or HG19_BINS_40KB
    weights, chromosomes = cell_pixels(seed, bins_per_chrom, nan_weight_frac, band)
    os.makedirs(outdir, exist_ok=True)
    if latent_dir is not None:
        os.makedirs(latent_dir, exist_ok=True)
    offset, n_pixels = 0, 0
    for ci, (n, (r, c, v, latent)) in enumerate(zip(bins_per_chrom, chromosomes)):
        count = v.astype(np.float64)
        w = weights[offset:offset + n]
        # McoolFile.fetch: count * w[bin1] * w[bin2], NaN -> 0
        balanced = np.nan_to_num(count * w[r] * w[c], nan=0.0)
        start1, start2 = r * res, c * res
        save_coo_txt(os.path.join(outdir, f"chrom_{ci + 1}_{res}.txt"),
                     np.stack([start1, start2, balanced], axis=1))
        save_coo_txt(os.path.join(outdir, f"chrom_{ci + 1}_count.txt"),
                     np.stack([start1, start2, count], axis=1), int_value=True)
        if latent_dir is not None:
            np.save(os.path.join(latent_dir, f"latent_chr{ci + 1}"), latent)
            np.save(os.path.join(latent_dir, f"weights_chr{ci + 1}"), w)
        offset += n
        n_pixels += len(r)
    return int(np.sum(bins_per_chrom)), n_pixels


def make_fullscale_mcool(path: str, res: int = 40000, seed: int = 7, bins_per_chrom=None,
                         nan_weight_frac: float = 0.05, band: int = PATCH_BAND):
    """Write the cell as the JAX tool's .mcool (int32 counts, the weights as
    drawn) through the port's writer (`data/mcool.py:write_cooler`);
    returns (bins, pixels)."""
    bins_per_chrom = bins_per_chrom or HG19_BINS_40KB
    weights, chromosomes = cell_pixels(seed, bins_per_chrom, nan_weight_frac, band)
    bin1, bin2, count = [], [], []
    offset = 0
    for n, (r, c, v, _) in zip(bins_per_chrom, chromosomes):
        bin1.append(r + offset)
        bin2.append(c + offset)
        count.append(v)
        offset += n
    bin1 = np.concatenate(bin1)
    write_cooler(path, res, [f"chr{i + 1}" for i in range(len(bins_per_chrom))],
                 bins_per_chrom, bin1, np.concatenate(bin2), np.concatenate(count), weights)
    return offset, len(bin1)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default="_work/fullscale",
                    help="the CLIs' --root: the contact lists go to its DataFull/ cache")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--sigma", type=float, default=0.1,
                    help="the noise level of the cache directory (the CLIs' -s)")
    ap.add_argument("--percentile", type=float, default=99.99,
                    help="the normalization percentile of the cache directory "
                         "(99.99: the trainer's single-cell prep)")
    ap.add_argument("--latent-dir", default=None,
                    help="also write latent_chr{i}.npy and weights_chr{i}.npy here")
    ap.add_argument("--band", type=int, default=PATCH_BAND,
                    help="generated band width in bins (default: the patch band, 257)")
    ap.add_argument("--bins", type=int, default=None,
                    help="bins of every chromosome (default: hg19's at 40 kb)")
    ap.add_argument("--mcool", default=None,
                    help="write the cell as an .mcool at this path (the JAX tool's file, "
                         "written by the port's HDF5 writer) instead of the contact lists")
    args = ap.parse_args(argv)
    if args.mcool:
        bins = [args.bins] * len(HG19_BINS_40KB) if args.bins else None
        nb, npx = make_fullscale_mcool(args.mcool, seed=args.seed, bins_per_chrom=bins,
                                       band=args.band)
        print(f"wrote {args.mcool}: {nb} bins, {npx} pixels")
        return
    outdir = constraints_dir(args.root, args.sigma, args.percentile)
    bins = [args.bins] * len(HG19_BINS_40KB) if args.bins else None
    nb, npx = make_fullscale(outdir, seed=args.seed, bins_per_chrom=bins,
                             latent_dir=args.latent_dir, band=args.band)
    print(f"wrote {outdir}: {nb} bins, {npx} pixels"
          + (f" (+latent -> {args.latent_dir})" if args.latent_dir else ""))


if __name__ == "__main__":
    main()
