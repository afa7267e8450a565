"""Data modules: .mcool -> cached patch arrays -> batch loaders.

Port of hicdiff_tpu/data/datamodule.py with the same on-disk cache layout
(the reference's, byte-compatible) and the same seeds, so a cache prepared
by either package is reused by the other:

    DataFull/DataFull_{cellLine}_cell{N}_{res}_{deg}_{sigma}/
        Constraints/chrom_{i}_{res}.txt, chrom_{i}_count.txt
        Full_Mats/GSE131811_mat_full_chr_{i}_{res}.npy
        Splits/GSE131811_{full,noisy,sample}_chr_{i}_{res}_piece_{p}.npy

(the GSE131811 prefix is the reference's for both cell lines). Only the
first stage reads the .mcool (`data/hdf5.py`); when `Constraints/` is present the
caches are built from its text contact lists, with numpy alone. Loaders are
numpy batch iterators that yield NHWC arrays.
"""
from __future__ import annotations

import glob
import os
import zlib
from typing import Iterator, Optional, Sequence, Tuple, Union

import numpy as np

from hicdiff_tpu_torch.data.fastio import save_coo_txt
from hicdiff_tpu_torch.data.mcool import McoolFile
from hicdiff_tpu_torch.data.preprocess import (
    inject_noise,
    load_both_constraints,
    q_sample_numpy,
    split_pieces,
)

__all__ = ["HiCDataModule", "GSE130711Module", "GSE131811Module", "NumpyLoader",
           "HiCPatchDataset"]

# chromosome splits (PrepareData_linear.py:237-241, 485-490)
HUMAN_SPLITS = {
    "train": [1, 3, 5, 7, 8, 9, 11, 13, 15, 16, 17, 19, 21, 22],
    "val": [4, 14, 18, 20],
    "test": [2, 6, 10, 12],
}
DROS_SPLITS = {"train": [5], "val": [2], "test": [1, 2, 3, 4, 5, 6]}


def _stable_seed(*parts) -> int:
    return zlib.adler32("|".join(str(p) for p in parts).encode()) & 0x7FFFFFFF


class HiCPatchDataset:
    """Concatenated per-chromosome patch arrays of one split
    (gse131811Dataset, PrepareData_linear.py:225-324)."""

    def __init__(self, chros: Sequence[int], res: int, piece_size: int, dirname: str):
        self.chros = list(chros)
        targets, datas, samps, infos = [], [], [], []
        for chro in self.chros:
            base = f"{dirname}/Splits/GSE131811_%s_chr_{chro}_{res}_piece_{piece_size}.npy"
            target = np.load(base % "full")
            if len(target) == 0:
                continue
            targets.append(target)
            datas.append(np.load(base % "noisy"))
            samps.append(np.load(base % "sample"))
            infos.append(np.repeat(chro, target.shape[0]))
        empty = np.zeros((0, 1, piece_size, piece_size), np.float32)
        self.target = np.concatenate(targets) if targets else empty
        self.data = np.concatenate(datas) if datas else self.target
        self.samp = (np.concatenate(samps) if samps
                     else np.zeros((0, piece_size * piece_size), np.float32))
        self.info = np.concatenate(infos) if infos else np.zeros((0,), np.int64)

    def __len__(self):
        return self.target.shape[0]

    def __getitem__(self, idx):
        return self.data[idx], self.target[idx], self.samp[idx], self.info[idx]


class NumpyLoader:
    """Batch iterator over an HiCPatchDataset, yielding (data, target, samp,
    info) with the image arrays NCHW -> NHWC; optional seeded shuffling per
    epoch."""

    def __init__(self, dataset: HiCPatchDataset, batch_size: int, shuffle: bool = False,
                 seed: int = 0, drop_last: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self._epoch = 0

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    @staticmethod
    def _to_nhwc(x: np.ndarray) -> np.ndarray:
        return np.transpose(x, (0, 2, 3, 1)) if x.ndim == 4 else x

    def __iter__(self) -> Iterator[Tuple[np.ndarray, ...]]:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(idx)
            self._epoch += 1
        stop = (n // self.batch_size) * self.batch_size if self.drop_last else n
        for lo in range(0, stop, self.batch_size):
            sel = idx[lo : lo + self.batch_size]
            yield (
                self._to_nhwc(self.dataset.data[sel]),
                self._to_nhwc(self.dataset.target[sel]),
                self.dataset.samp[sel],
                self.dataset.info[sel],
            )


class HiCDataModule:
    """One data module for both cell lines and all prep variants.

    variant: 'linear'      — H(x)+sigma*eps noise (PrepareData_linear / _sing)
             'pure_noise'  — DDPM q_sample noise (PrepareData_pure_noise)
             'clean'       — targets only (PrepareData_tensorH)
    percentile: 99.0 population (cells 1/22) vs 99.99 single-cell (cells
    2-6), as metrics_cond.py:68-77 chooses the module.
    """

    def __init__(
        self,
        batch_size: int = 64,
        res: int = 40000,
        piece_size: int = 64,
        cell_line: str = "Human",
        cell_No: int = 1,
        sigma_0: float = 0.1,
        deg: str = "deno",
        channel: int = 1,
        percentile: Optional[float] = None,
        variant: str = "linear",
        root: Optional[str] = None,
        timestep: int = 1000,
        beta_schedule: str = "linear",
        n_chroms: Optional[int] = None,
    ):
        self.batch_size = batch_size
        self.res = res
        self.piece_size = piece_size
        self.step = piece_size
        self.cell_line = cell_line
        self.cell_no = cell_No
        self.sigma_0 = sigma_0
        self.deg = deg
        self.channel = channel
        self.variant = variant
        self.timestep = timestep
        self.beta_schedule = beta_schedule
        self.root = root or os.environ.get("HICDIFF_ROOT", os.getcwd())
        default_pct = 99.0 if cell_No in (1, 22) else 99.99
        if percentile is None:
            percentile = default_pct
        self.percentile = percentile
        self._n_chroms = n_chroms  # override for tiny synthetic fixtures
        # non-default variants and percentiles are different data and get
        # their own cache directory; the default linear layout is the
        # reference's
        marker = "" if variant == "linear" else f"_{variant}"
        if percentile != default_pct:
            marker += f"_p{percentile}"
        self.dirname = os.path.join(
            self.root, "DataFull",
            f"DataFull_{cell_line}_cell{cell_No}_{res}_{deg}_{sigma_0}{marker}",
        )
        self.train_set = self.val_set = self.test_set = None

    @property
    def is_human(self) -> bool:
        return self.cell_line == "Human"

    @property
    def n_chroms(self) -> int:
        if self._n_chroms is not None:
            return self._n_chroms
        return 22 if self.is_human else 6

    @property
    def splits(self):
        return HUMAN_SPLITS if self.is_human else DROS_SPLITS

    def _mcool_path(self) -> str:
        sub = "Human" if self.is_human else "Drosophila"
        pattern = os.path.join(self.root, "Datasets", sub, f"cell{self.cell_no}_*.mcool")
        matches = sorted(glob.glob(pattern))
        if not matches:
            raise FileNotFoundError(f"no .mcool matches {pattern}")
        return matches[0]

    # ------------------------------------------------------------ prep stages
    def extract_constraint_mats(self):
        """mcool -> per-chromosome COO txt, balanced and raw count
        (PrepareData_linear.py:129-159)."""
        outdir = os.path.join(self.dirname, "Constraints")
        os.makedirs(outdir, exist_ok=True)
        mc = McoolFile(self._mcool_path(), self.res)
        for i, chrom in enumerate(mc.chromnames):
            if i >= self.n_chroms:  # Human keeps idx<22, Dros idx<6
                continue
            px = mc.fetch(chrom)
            bal = np.stack([px.start1, px.start2, px.balanced], axis=1)
            cnt = np.stack([px.start1, px.start2, px.count], axis=1)
            save_coo_txt(os.path.join(outdir, f"chrom_{i+1}_{self.res}.txt"), bal)
            save_coo_txt(os.path.join(outdir, f"chrom_{i+1}_count.txt"), cnt, int_value=True)

    def extract_create_numpy(self):
        """Constraints txt -> normalized dense Full_Mats npys
        (PrepareData_linear.py:161-181)."""
        outdir = os.path.join(self.dirname, "Full_Mats")
        os.makedirs(outdir, exist_ok=True)
        probe = os.path.join(self.dirname, "Constraints", f"chrom_1_{self.res}.txt")
        if not os.path.exists(probe):
            self.extract_constraint_mats()
        for i in range(1, self.n_chroms + 1):
            target = load_both_constraints(
                os.path.join(self.dirname, "Constraints", f"chrom_{i}_{self.res}.txt"),
                os.path.join(self.dirname, "Constraints", f"chrom_{i}_count.txt"),
                self.res,
                percentile=self.percentile,
            )
            np.save(os.path.join(outdir, f"GSE131811_mat_full_chr_{i}_{self.res}"),
                    np.float32(target))

    def split_numpy(self):
        """Full_Mats -> band patches + noisy/sample caches
        (PrepareData_linear.py:183-213)."""
        outdir = os.path.join(self.dirname, "Splits")
        os.makedirs(outdir, exist_ok=True)
        probe = os.path.join(self.dirname, "Full_Mats", f"GSE131811_mat_full_chr_1_{self.res}.npy")
        if not os.path.exists(probe):
            self.extract_create_numpy()
        for i in range(1, self.n_chroms + 1):
            full = np.load(os.path.join(
                self.dirname, "Full_Mats", f"GSE131811_mat_full_chr_{i}_{self.res}.npy"))
            target = split_pieces(full, self.piece_size, self.step, resol=self.res)
            base = os.path.join(outdir, f"GSE131811_%s_chr_{i}_{self.res}_piece_{self.piece_size}")
            np.save(base % "full", target)
            seed = _stable_seed(self.cell_line, self.cell_no, self.res, self.deg, self.sigma_0, i)
            if self.variant == "pure_noise":
                noisy = q_sample_numpy(target, self.timestep, self.beta_schedule, seed=seed)
                samp = noisy.reshape(noisy.shape[0], -1)
            elif self.variant == "clean":
                noisy, samp = target, target.reshape(target.shape[0], -1)
            else:
                noisy, samp = inject_noise(
                    target, self.deg, self.sigma_0, piece_size=self.piece_size,
                    channel=self.channel, seed=seed,
                )
            np.save(base % "noisy", noisy)
            np.save(base % "sample", samp)

    def prepare_data(self):
        """Cache check and (re)build (PrepareData_linear.py:215-223), requiring
        every chromosome's split."""
        pattern = os.path.join(
            self.dirname, "Splits", f"GSE131811_full_chr_*_{self.res}_piece_{self.piece_size}.npy"
        )
        if len(glob.glob(pattern)) >= self.n_chroms:
            return
        self.split_numpy()

    # ----------------------------------------------------------------- setup
    def setup(self, stage: Union[str, int, None] = None):
        def mk(chros):
            return HiCPatchDataset(chros, self.res, self.piece_size, self.dirname)

        if isinstance(stage, int) and stage in range(1, self.n_chroms + 1):
            self.test_set = mk([stage])
        if stage == "all":  # full-cell evaluation: every chromosome
            self.test_set = mk(list(range(1, self.n_chroms + 1)))
        if stage == "fit":
            self.train_set = mk(self.splits["train"])
            self.val_set = mk(self.splits["val"])
        if stage == "test":
            self.test_set = mk(self.splits["test"])

    def train_dataloader(self) -> NumpyLoader:
        return NumpyLoader(self.train_set, self.batch_size, shuffle=True,
                           seed=_stable_seed("train", self.cell_line, self.cell_no))

    def val_dataloader(self) -> NumpyLoader:
        return NumpyLoader(self.val_set, self.batch_size)

    def test_dataloader(self) -> NumpyLoader:
        return NumpyLoader(self.test_set, self.batch_size)


def GSE130711Module(single_cell: Optional[bool] = None, **kw) -> HiCDataModule:
    """Human data module. single_cell=None keeps the percentile chosen by
    cell number; True/False force the _sing / population variant."""
    kw.setdefault("cell_line", "Human")
    if single_cell is not None:
        kw.setdefault("percentile", 99.99 if single_cell else 99.0)
    return HiCDataModule(**kw)


def GSE131811Module(single_cell: Optional[bool] = None, **kw) -> HiCDataModule:
    """Drosophila data module."""
    kw.setdefault("cell_line", "Dros")
    if single_cell is not None:
        kw.setdefault("percentile", 99.99 if single_cell else 99.0)
    return HiCDataModule(**kw)
