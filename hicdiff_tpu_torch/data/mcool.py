""".mcool/.cool reader (port of hicdiff_tpu/data/mcool.py).

A cooler file is an HDF5 file with a documented schema (groups
bins{chrom,start,end,weight}, chroms{name,length}, pixels{bin1_id,bin2_id,
count}, indexes{chrom_offset,bin1_offset}); this reads the subset the
pipeline uses, per-chromosome intra-chromosomal pixels with balanced
weights, with vectorized numpy. The file is read through `data/hdf5.py`,
the port's own reader of the HDF5 subset cooler files use (no h5py).
"""
from __future__ import annotations

import dataclasses
import os
from typing import List, Sequence

import numpy as np

from hicdiff_tpu_torch.data.hdf5 import File, write_file

__all__ = ["list_coolers", "McoolFile", "ChromPixels", "write_cooler"]


def list_coolers(path: str) -> List[str]:
    """The cooler group paths in an .mcool (cooler.fileops.list_coolers)."""
    out = []
    with File(path) as f:
        if "resolutions" in f:
            for res in sorted(f["resolutions"], key=lambda r: int(r)):
                out.append(f"/resolutions/{res}")
        elif "pixels" in f:
            out.append("/")
    return out


@dataclasses.dataclass
class ChromPixels:
    """Intra-chromosomal COO pixels of one chromosome: start1/start2 are
    genomic coordinates (bp); `balanced` has NaN weights filled with 0
    (reference: c2.fillna(0), PrepareData_linear.py:152)."""

    start1: np.ndarray
    start2: np.ndarray
    count: np.ndarray
    balanced: np.ndarray


class McoolFile:
    """One resolution of an .mcool file:
    McoolFile(path, 40000).fetch('chr1') -> ChromPixels."""

    def __init__(self, path: str, resolution: int):
        self.path = path
        self.resolution = int(resolution)
        with File(path) as f:
            grp = self._group(f)
            # the reader and the upper-triangle symmetrization downstream
            # assume the schema's symmetric-upper layout; a declared
            # 'square' cooler fails here rather than yielding half its data
            mode = grp.attrs.get("storage-mode", "symmetric-upper")
            mode = mode.decode() if isinstance(mode, bytes) else str(mode)
            if mode != "symmetric-upper":
                raise ValueError(
                    f"{path} declares storage-mode={mode!r}; this reader "
                    "supports only 'symmetric-upper' coolers"
                )
            self.chromnames = [
                n.decode() if isinstance(n, bytes) else str(n)
                for n in grp["chroms/name"][:]
            ]
            self.chromsizes = grp["chroms/length"][:].astype(np.int64)
            self._chrom_offset = self._load_chrom_offset(grp)
            self._bin_start = grp["bins/start"][:].astype(np.int64)
            if "weight" not in grp["bins"]:
                # the pipeline consumes balance=True matrices; weights of 1
                # would pass raw counts off as balanced
                raise ValueError(
                    f"{path} has no bins/weight column (unbalanced cooler); "
                    "run ICE balancing first (PrepareData_linear.py:149)"
                )
            self._weights = grp["bins/weight"][:].astype(np.float64)

    def _load_chrom_offset(self, grp) -> np.ndarray:
        """indexes/chrom_offset when present, else rebuilt from the bins
        table (the indexes group is optional in the schema)."""
        if "indexes" in grp and "chrom_offset" in grp["indexes"]:
            return grp["indexes/chrom_offset"][:].astype(np.int64)
        chrom_of_bin = grp["bins/chrom"][:]
        if chrom_of_bin.dtype.kind in ("S", "U", "O"):  # names, not codes
            names = [c.decode() if isinstance(c, bytes) else str(c) for c in chrom_of_bin]
            code = {n: i for i, n in enumerate(self.chromnames)}
            chrom_of_bin = np.asarray([code[n] for n in names], np.int64)
        # bins are ordered by chromosome in the schema
        return np.searchsorted(
            np.asarray(chrom_of_bin, np.int64), np.arange(len(self.chromnames) + 1)
        ).astype(np.int64)

    def _chrom_index(self, chrom: str) -> int:
        """Name lookup tolerant of the UCSC ('chr1') vs Ensembl ('1') naming."""
        if chrom in self.chromnames:
            return self.chromnames.index(chrom)
        alt = chrom[3:] if chrom.startswith("chr") else "chr" + chrom
        if alt in self.chromnames:
            return self.chromnames.index(alt)
        raise KeyError(
            f"chromosome {chrom!r} not in {self.path} "
            f"(names: {self.chromnames[:8]}{'...' if len(self.chromnames) > 8 else ''})"
        )

    def weights(self, chrom: str) -> np.ndarray:
        """The balancing weights of one chromosome's bins, NaN as stored."""
        ci = self._chrom_index(chrom)
        return self._weights[self._chrom_offset[ci]:self._chrom_offset[ci + 1]]

    def _group(self, f):
        if "resolutions" in f:
            return f[f"resolutions/{self.resolution}"]
        return f

    def _bin1_offset(self, grp, lo_bin: int, hi_bin: int):
        """(p_lo, p_hi) pixel range for bin1 in [lo_bin, hi_bin): the
        indexes/bin1_offset index when present, else a binary search of
        pixels/bin1_id (sorted in the schema) that reads only the elements
        it probes (and so only the chunks that hold them)."""
        if "indexes" in grp and "bin1_offset" in grp["indexes"]:
            bin1_offset = grp["indexes/bin1_offset"]
            return int(bin1_offset[lo_bin]), int(bin1_offset[hi_bin])
        bin1 = grp["pixels/bin1_id"]
        p_lo = _bisect_left(bin1, lo_bin, 0, bin1.shape[0])
        return p_lo, _bisect_left(bin1, hi_bin, p_lo, bin1.shape[0])

    def fetch(self, chrom: str) -> ChromPixels:
        """All intra-chromosomal pixels of `chrom` with balanced values:
        balanced[i] = count[i] * weight[bin1] * weight[bin2]; NaN -> 0."""
        ci = self._chrom_index(chrom)
        lo_bin = int(self._chrom_offset[ci])
        hi_bin = int(self._chrom_offset[ci + 1])

        with File(self.path) as f:
            grp = self._group(f)
            p_lo, p_hi = self._bin1_offset(grp, lo_bin, hi_bin)
            bin1 = grp["pixels/bin1_id"][p_lo:p_hi].astype(np.int64)
            bin2 = grp["pixels/bin2_id"][p_lo:p_hi].astype(np.int64)
            count = grp["pixels/count"][p_lo:p_hi].astype(np.float64)

        if bin2.size and (bin2 < bin1).any():
            raise ValueError(
                f"{self.path} stores lower-triangle pixels for {chrom}; the "
                "symmetric-upper schema this reader assumes stores i <= j only"
            )
        mask = (bin2 >= lo_bin) & (bin2 < hi_bin)  # intra-chromosomal only
        bin1, bin2, count = bin1[mask], bin2[mask], count[mask]
        balanced = np.nan_to_num(count * self._weights[bin1] * self._weights[bin2], nan=0.0)
        return ChromPixels(
            start1=self._bin_start[bin1],
            start2=self._bin_start[bin2],
            count=count,
            balanced=balanced,
        )


def write_cooler(path: str, res: int, chrom_names: Sequence[str], bins_per_chrom: Sequence[int],
                 bin1: np.ndarray, bin2: np.ndarray, count: np.ndarray,
                 weights: np.ndarray) -> str:
    """Write one resolution of an .mcool (`resolutions/{res}`: chroms/,
    bins/, pixels/ and the bin1_offset and chrom_offset indexes) through
    `data/hdf5.py`. The pixels are genome-wide bin ids sorted by (bin1,
    bin2); each array keeps its dtype, the schema's others are int64 (the
    bins' chromosome codes int32, the names fixed-width bytes sized to the
    longest)."""
    sizes = np.asarray(bins_per_chrom, np.int64)
    n_bins = int(sizes.sum())
    start = np.concatenate([np.arange(n, dtype=np.int64) * res for n in sizes])
    names = [str(n).encode() for n in chrom_names]
    width = max(1, max(len(b) for b in names))
    bin1 = np.asarray(bin1)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    return write_file(path, {"resolutions": {str(int(res)): {
        "chroms": {"name": np.array(names, dtype=f"S{width}"), "length": sizes * res},
        "bins": {"chrom": np.repeat(np.arange(len(sizes), dtype=np.int32), sizes),
                 "start": start, "end": start + res, "weight": np.asarray(weights)},
        "pixels": {"bin1_id": bin1, "bin2_id": np.asarray(bin2), "count": np.asarray(count)},
        "indexes": {
            "bin1_offset": np.searchsorted(bin1, np.arange(n_bins + 1)).astype(np.int64),
            "chrom_offset": np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)},
    }}})


def _bisect_left(column, value: int, lo: int, hi: int) -> int:
    """The first index in [lo, hi) of a sorted on-disk column whose element
    is >= value (hi if none), reading one element a probe."""
    while lo < hi:
        mid = (lo + hi) // 2
        if int(column[mid]) < value:
            lo = mid + 1
        else:
            hi = mid
    return lo
