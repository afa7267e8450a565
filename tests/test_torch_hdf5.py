"""The port's HDF5 reader and writer (hicdiff_tpu_torch/data/hdf5.py)
against h5py, the oracle: a matrix of h5py-written files read equal to
h5py's reading of them (integers and strings to the byte, floats bit for
bit), a libver="latest" file and an unknown filter refused by name, the
writer's files opened by h5py."""
import os

import h5py
import numpy as np
import pytest

from hicdiff_tpu_torch.data import hdf5

RNG = np.random.default_rng(17)
N = 1000

DTYPES = ["<i1", "<u1", "<i2", "<u2", "<i4", "<u4", "<i8", "<u8", ">i2", ">u4", ">i8",
          "<f4", "<f8", ">f4", ">f8", "S7"]


def _data(dtype, n=N):
    dtype = np.dtype(dtype)
    if dtype.kind == "S":
        return np.array([f"c{i}"[:dtype.itemsize].encode() for i in range(n)], dtype)
    if dtype.kind == "f":
        a = RNG.normal(0, 1e3, n).astype(dtype)
        a[::97] = np.nan
        a[5] = -0.0
        return a
    info = np.iinfo(dtype)
    return RNG.integers(info.min, info.max, n, dtype=dtype.newbyteorder("="), endpoint=True) \
        .astype(dtype)


LAYOUTS = {
    "contiguous": {},
    "compact": None,  # h5py's low-level API
    "chunked": {"chunks": (64,), "maxshape": (None,)},
    "gzip_shuffle": {"chunks": (64,), "maxshape": (None,), "compression": "gzip",
                     "compression_opts": 6, "shuffle": True},
    "fletcher32": {"chunks": (100,), "fletcher32": True},
    "all_filters": {"chunks": (37,), "compression": "gzip", "shuffle": True,
                    "fletcher32": True, "maxshape": (None,)},
}
SLICES = [slice(None), slice(0, 1), slice(63, 65), slice(100, 701), slice(990, None),
          slice(-5, None), slice(3, 400, 7), slice(500, 500), 0, 641, -1]


def _create(group, name, data, layout):
    if LAYOUTS[layout] is not None:
        return group.create_dataset(name, data=data, **LAYOUTS[layout])
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_layout(h5py.h5d.COMPACT)
    dsid = h5py.h5d.create(group.id, name.encode(), h5py.h5t.py_create(data.dtype),
                           h5py.h5s.create_simple(data.shape), dcpl=dcpl)
    dsid.write(h5py.h5s.ALL, h5py.h5s.ALL, data)
    return group[name]


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype.kind == b.dtype.kind, (a.dtype, b.dtype, a.shape)
    if a.dtype.kind == "O":
        assert a.tolist() == b.tolist()
        return
    na, nb = a.astype(a.dtype.newbyteorder("=")), b.astype(b.dtype.newbyteorder("="))
    assert na.dtype.itemsize == nb.dtype.itemsize and na.tobytes() == nb.tobytes()


@pytest.mark.parametrize("layout,dtype", [(lay, dt) for lay in LAYOUTS for dt in DTYPES])
def test_reader_matches_h5py(tmp_path, layout, dtype):
    """Every dtype under every layout and filter set, read whole, sliced
    across chunk borders, stepped and by index, equal to h5py's reading;
    with attributes of every kind on the dataset and its groups."""
    path = str(tmp_path / "f.h5")
    data = _data(dtype)
    with h5py.File(path, "w") as f:
        g = f.create_group("a/b")
        g.attrs["storage-mode"] = "symmetric-upper"  # a variable-length string
        g.attrs["fixed"] = np.bytes_("fixed-len")
        g.attrs["scalar_i"] = np.int64(-7)
        g.attrs["scalar_f"] = np.float64(2.5)
        g.attrs["vec"] = np.arange(5, dtype=np.int32)
        g.attrs["vlen_vec"] = np.array(["x", "yz", ""], dtype=h5py.string_dtype())
        ds = _create(g, "ds", data, layout)
        ds.attrs["unit"] = "bp"
        f.attrs["format-version"] = 3
        f.create_dataset("z/2d", data=RNG.integers(0, 9, (30, 7)).astype("<i4"),
                         **({"chunks": (8, 3)} if layout not in ("contiguous", "compact")
                            else {}))
    with h5py.File(path, "r") as ref, hdf5.File(path) as got:
        assert list(got) == list(ref) == ["a", "z"]
        assert list(got["a"]) == ["b"] and list(got["a/b"]) == ["ds"]
        assert "a/b/ds" in got and "a/c" not in got
        assert got["a/b/ds"].shape == ref["a/b/ds"].shape
        for s in SLICES:
            _same(got["a/b/ds"][s], ref["a/b/ds"][s])
        _same(got["a/b/ds"][...], ref["a/b/ds"][...])
        _same(got["z/2d"][:], ref["z/2d"][:])
        _same(got["z/2d"][5:22], ref["z/2d"][5:22])
        for obj in ("a/b", "a/b/ds"):
            assert sorted(got[obj].attrs) == sorted(ref[obj].attrs)
            for k, v in ref[obj].attrs.items():
                w = got[obj].attrs[k]
                assert type(w) is type(v) or (isinstance(v, np.generic)
                                              and np.asarray(w).dtype == np.asarray(v).dtype), k
                _same(w, v)
        assert got.attrs["format-version"] == ref.attrs["format-version"]


def test_enum_and_chunk_reads(tmp_path):
    """cooler's `bins/chrom` enum reads as its codes; a slice decodes only
    the chunks it overlaps; many chunks make a multi-level chunk B-tree."""
    path = str(tmp_path / "e.h5")
    codes = RNG.integers(0, 3, 5000).astype(np.int32)
    with h5py.File(path, "w") as f:
        f.create_dataset("chrom", data=codes, chunks=(16,), compression="gzip",
                         dtype=h5py.enum_dtype({"chr1": 0, "chr2": 1, "chrX": 2},
                                               basetype=np.int32))
    with h5py.File(path, "r") as ref, hdf5.File(path) as got:
        ds = got["chrom"]
        _same(ds[:], ref["chrom"][:])
        assert ds.chunks_read == -(-5000 // 16)
        fresh = got["chrom"]
        _same(fresh[40:70], ref["chrom"][40:70])
        assert fresh.chunks_read == 3  # rows 32-47, 48-63, 64-79


def test_libver_latest_is_refused_by_name(tmp_path):
    path = str(tmp_path / "latest.h5")
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("x", data=np.arange(4))
    with pytest.raises(ValueError, match="superblock version [23].*libver='latest'"):
        hdf5.File(path)


def test_unknown_filter_and_new_style_group_are_refused_by_name(tmp_path):
    path = str(tmp_path / "lzf.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("g/x", data=np.arange(100), chunks=(10,), compression="lzf")
        f.create_group("ordered", track_order=True)
    with hdf5.File(path) as f:
        with pytest.raises(ValueError, match=r"\(/g/x\).*filter 32000 \(lzf\)"):
            f["g/x"]
        with pytest.raises(ValueError, match=r"\(/ordered\): version 2 object header"):
            f["ordered"]


def test_writer_files_open_in_h5py(tmp_path):
    """write_file's groups (more links than one symbol node holds) and
    datasets of every written dtype, read by h5py and by the reader."""
    tree = {"resolutions": {"40000": {
        "bins": {k: _data(dt, 50) for k, dt in (("chrom", "<i4"), ("start", "<i8"),
                                                ("weight", "<f8"))},
        "chroms": {"name": np.array([b"chr1", b"chr19_GL949746v1_alt"]),
                   "length": np.array([10, 20], np.int64)},
        "empty": {"count": np.zeros(0, np.float32)},
        "many": {f"d{i:02d}": np.full(3, i, np.uint16) for i in range(19)},
    }}, "top": _data("<f4", 7), "s": _data("S3", 4)}
    path = str(tmp_path / "w.h5")
    hdf5.write_file(path, tree)
    assert os.path.getsize(path) % 8 == 0

    def walk(t, prefix=""):
        for k, v in t.items():
            if isinstance(v, dict):
                yield from walk(v, f"{prefix}{k}/")
            else:
                yield prefix + k, v

    with h5py.File(path, "r") as ref, hdf5.File(path) as got:
        assert sorted(ref["resolutions/40000/many"]) == sorted(tree["resolutions"]["40000"]
                                                               ["many"])
        for name, want in walk(tree):
            _same(ref[name][()], want)
            _same(got[name][:], want)
