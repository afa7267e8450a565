"""The port's .mcool reader and writer, which run on the port's own HDF5
module (no h5py), against the JAX package's, which run on h5py:

- McoolFile on tests/make_fixture_mcool.py's file and on a cooler-style
  copy of it (gzip, shuffle and small chunks, maxshape None, the
  storage-mode attribute a variable-length string, bins/chrom an enum);
- a cooler without indexes/bin1_offset, searched chunk by chunk;
- write_mcool's file against the JAX writer's, dataset by dataset;
- stage 1 (`extract_constraint_mats`): the Constraints/ text of both data
  modules byte-equal, and equal to what the full-scale fixture tool writes
  directly.
"""
import filecmp
import os

import h5py
import numpy as np
import pytest

from hicdiff_tpu.data import assemble as jax_assemble
from hicdiff_tpu.data.mcool import McoolFile as JaxMcoolFile
from hicdiff_tpu.metrics.harness import build_test_module as jax_build_test_module
from hicdiff_tpu_torch.data import assemble as port_assemble
from hicdiff_tpu_torch.data import hdf5
from hicdiff_tpu_torch.data.mcool import McoolFile, list_coolers
from hicdiff_tpu_torch.metrics.harness import build_test_module as port_build_test_module
from tests.make_fixture_mcool import make_fixture
from tools import make_fullscale_fixture as jax_fix
from tools import torch_make_fullscale_fixture as port_fix

RES = 40000


def _cooler_style(src, dst, chunk=32, drop=()):
    """A copy of src's datasets as cooler writes them (chunked, gzip 6 with
    shuffle, growable; bins/chrom an enum of the names), without `drop`."""
    with h5py.File(src, "r") as a, h5py.File(dst, "w") as b:
        g = b.create_group(f"resolutions/{RES}")
        g.attrs["storage-mode"] = "symmetric-upper"
        g.attrs["bin-size"] = RES
        g.attrs["format"] = "HDF5::Cooler"
        src_g = a[f"resolutions/{RES}"]
        names = [n.decode() for n in src_g["chroms/name"][:]]
        for grp in ("chroms", "bins", "pixels", "indexes"):
            for key, ds in src_g[grp].items():
                name = f"{grp}/{key}"
                if name in drop:
                    continue
                kw = dict(compression="gzip", compression_opts=6, shuffle=True,
                          chunks=(min(chunk, ds.shape[0]),), maxshape=(None,))
                if name == "bins/chrom":
                    kw["dtype"] = h5py.enum_dtype({n: i for i, n in enumerate(names)},
                                                  basetype=np.int32)
                g.create_dataset(name, data=ds[:], **kw)
    return dst


@pytest.fixture(scope="module")
def coolers(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("coolers")
    plain = str(tmp / "fixture.mcool")
    make_fixture(plain, bins_per_chrom=(48, 32, 70))
    return {"fixture": plain,
            "cooler_style": _cooler_style(plain, str(tmp / "cooler_style.mcool")),
            "no_bin1_offset": _cooler_style(plain, str(tmp / "no_index.mcool"), chunk=16,
                                            drop=("indexes/bin1_offset",))}


def _same_pixels(got, want, names):
    for name in names:
        a, b = got.fetch(name), want.fetch(name)
        for field in ("start1", "start2", "count", "balanced"):
            x, y = getattr(a, field), getattr(b, field)
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), (name, field)
        assert got.weights(name).tobytes() == want.weights(name).tobytes()


@pytest.mark.parametrize("kind", ["fixture", "cooler_style", "no_bin1_offset"])
def test_mcool_file_matches_jax(coolers, kind):
    path = coolers[kind]
    got, want = McoolFile(path, RES), JaxMcoolFile(path, RES)
    assert list_coolers(path) == [f"/resolutions/{RES}"]
    assert got.chromnames == want.chromnames == ["chr1", "chr2", "chr3"]
    assert got.chromsizes.tobytes() == want.chromsizes.tobytes()
    _same_pixels(got, want, got.chromnames + ["2"])  # also by Ensembl name


def test_missing_bin1_offset_reads_only_the_chunks_it_probes(coolers, monkeypatch):
    """Without indexes/bin1_offset a fetch binary-searches pixels/bin1_id:
    besides the chunks that hold the chromosome's pixels it decodes at most
    two searches' worth, about log2 of the column's chunks each."""
    decoded = []
    chunk = hdf5.Dataset._chunk

    def counting(self, offsets, *args):
        if self.name.endswith("pixels/bin1_id") and (not self._last_chunk
                                                    or self._last_chunk[0] != offsets):
            decoded.append(offsets[0])
        return chunk(self, offsets, *args)

    monkeypatch.setattr(hdf5.Dataset, "_chunk", counting)
    mc = McoolFile(coolers["no_bin1_offset"], RES)
    with h5py.File(coolers["no_bin1_offset"], "r") as f:
        bin1 = f[f"resolutions/{RES}/pixels/bin1_id"][:]
        offsets = f[f"resolutions/{RES}/indexes/chrom_offset"][:]
    total = -(-bin1.size // 16)
    for ci, name in enumerate(mc.chromnames):
        decoded.clear()
        assert mc.fetch(name).start1.size > 0
        p_lo, p_hi = np.searchsorted(bin1, offsets[ci:ci + 2])
        rows = set(range(p_lo // 16 * 16, p_hi, 16))  # the chunks holding its pixels
        probes = set(decoded) - rows
        assert rows <= set(decoded) and len(probes) <= 2 * int(np.ceil(np.log2(total))), \
            (name, sorted(probes), total)


def test_write_mcool_matches_the_jax_writer(tmp_path):
    """The port's file holds the JAX writer's groups and datasets, each of
    the same dtype and bytes (h5py reading both), and reads alike through
    both packages' readers."""
    rng = np.random.default_rng(3)
    mats = {}
    for c, n in ((1, 40), (3, 23), (7, 64)):
        m = rng.uniform(0, 1, (n, n)).astype(np.float32) * (rng.uniform(size=(n, n)) > 0.4)
        mats[c] = (m + m.T) / 2
    names = ["chr1", "chr3", "chr19_GL949746v1_alt"]
    port = port_assemble.write_mcool(str(tmp_path / "port.mcool"), RES, mats, names)
    ref = jax_assemble.write_mcool(str(tmp_path / "jax.mcool"), RES, mats, names)

    def datasets(f):
        out = {}

        def visit(key, obj):
            if isinstance(obj, h5py.Dataset):
                out[key] = obj[()]

        f.visititems(visit)
        return out

    with h5py.File(port, "r") as a, h5py.File(ref, "r") as b:
        got, want = datasets(a), datasets(b)
    assert sorted(got) == sorted(want) and len(got) == 11
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert got[key].tobytes() == want[key].tobytes(), key
    _same_pixels(JaxMcoolFile(port, RES), JaxMcoolFile(ref, RES), names)
    _same_pixels(McoolFile(port, RES), JaxMcoolFile(ref, RES), names)


def _stage1(build, root):
    dm = build("Human", 1, "deno", 0.1, root=root, batch_size=3)
    dm.extract_constraint_mats()
    return os.path.join(dm.dirname, "Constraints")


def _same_dirs(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and names
    match, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert not mismatch and not errors, mismatch + errors


@pytest.mark.parametrize("kind", ["fixture", "cooler_style"])
def test_stage1_text_is_byte_equal_to_jax(coolers, tmp_path, kind):
    """Stage 1 of both data modules on one .mcool (all 22 of the cell's
    chromosomes read, 3 present) writes byte-equal Constraints/ text."""
    dirs = []
    for tag, build in (("jax", jax_build_test_module), ("port", port_build_test_module)):
        root = tmp_path / tag
        os.makedirs(root / "Datasets" / "Human")
        os.symlink(coolers[kind], root / "Datasets" / "Human" / "cell1_synth.mcool")
        dirs.append(_stage1(build, str(root)))
    _same_dirs(*dirs)
    assert len(os.listdir(dirs[1])) == 6


def test_fixture_tool_mcool_stage1_equals_its_text(tmp_path):
    """The port tool's .mcool (written by the port's writer) and the JAX
    tool's (h5py) hold the same cell; stage 1 from the port's writes the
    text the port tool writes directly, and the JAX module's stage 1 from
    the JAX tool's writes it too."""
    bins = [300, 280, 260]
    roots = {k: tmp_path / k for k in ("port", "jax")}
    paths = {k: str(r / "Datasets" / "Human" / "cell1_synth.mcool") for k, r in roots.items()}
    for p in paths.values():
        os.makedirs(os.path.dirname(p))
    nb, npx = port_fix.make_fullscale_mcool(paths["port"], seed=3, bins_per_chrom=bins)
    _, nb_j, npx_j = jax_fix.make_fullscale(paths["jax"], seed=3, bins_per_chrom=bins)
    assert (nb, npx) == (nb_j, npx_j) == (sum(bins), npx)
    _same_pixels(McoolFile(paths["port"], RES), JaxMcoolFile(paths["jax"], RES),
                 ["chr1", "chr2", "chr3"])
    text = port_fix.constraints_dir(str(tmp_path / "text"), sigma=0.1, percentile=99.0)
    port_fix.make_fullscale(text, seed=3, bins_per_chrom=bins)
    _same_dirs(_stage1(port_build_test_module, str(roots["port"])), text)
    _same_dirs(_stage1(jax_build_test_module, str(roots["jax"])), text)
