"""The HDF5 subset that cooler files use, read and written with `struct`,
`zlib` and numpy (no h5py).

Reading covers what h5py writes with its default (earliest) format and
cooler's dataset options:

- superblock versions 0 and 1;
- version 1 object headers, with continuation messages;
- groups stored as symbol tables (a version 1 group B-tree, symbol nodes
  and a local heap);
- simple dataspaces, and scalar ones for attributes;
- fixed-point (1, 2, 4, 8 bytes, signed or unsigned, either byte order),
  IEEE float (4, 8), fixed-length strings, variable-length strings (held
  in the global heap) and enums, read as their base type's codes;
- data layout message version 3: compact, contiguous, and chunked with a
  version 1 chunk B-tree;
- the deflate (1), shuffle (2) and fletcher32 (3) filters;
- attribute messages versions 1 to 3.

`ds[lo:hi]` of a chunked dataset decodes only the chunks that overlap the
rows asked for. A file outside the subset raises ValueError naming the
feature and the object's path: a `libver="latest"` file (superblock 2 or
3, `OHDR` object headers, link messages), an unknown filter, a compound
type.

Writing (`write_file`) covers what `data/assemble.py:write_mcool` needs:
superblock version 0, version 1 object headers, symbol-table groups, and
contiguous datasets without filters of fixed-point, float and fixed-length
string data. No attributes are written.

    with File(path) as f:
        names = f["resolutions/40000/chroms/name"][:]
    write_file(path, {"resolutions": {"40000": {"chroms": {"name": names}}}})
"""
from __future__ import annotations

import os
import struct
import zlib
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np

__all__ = ["File", "Group", "Dataset", "write_file"]

SIGNATURE = b"\x89HDF\r\n\x1a\n"

# object header message types
_NIL, _DATASPACE, _LINK_INFO, _DATATYPE = 0x0, 0x1, 0x2, 0x3
_LINK, _LAYOUT, _GROUP_INFO, _FILTERS, _ATTRIBUTE = 0x6, 0x8, 0xA, 0xB, 0xC
_CONTINUATION, _SYMBOL_TABLE, _ATTRIBUTE_INFO = 0x10, 0x11, 0x15
_NEW_STYLE = {_LINK_INFO: "link info", _LINK: "link", _GROUP_INFO: "group info"}

_DEFLATE, _SHUFFLE, _FLETCHER32 = 1, 2, 3
_FILTER_NAMES = {1: "deflate", 2: "shuffle", 3: "fletcher32", 4: "szip", 5: "nbit",
                 6: "scaleoffset", 32001: "blosc", 32004: "lz4", 32008: "bitshuffle",
                 32015: "zstd"}

_VLEN_STRING = "vlen-str"  # the dtype marker of a variable-length string


def _pad8(n: int) -> int:
    return (n + 7) & ~7


class _Reader:
    """Little-endian fields of a byte buffer, offsets and lengths of the
    file's sizes."""

    def __init__(self, buf: bytes, pos: int, size_off: int, size_len: int):
        self.buf, self.pos, self.so, self.sl = buf, pos, size_off, size_len

    def u(self, n: int) -> int:
        v = int.from_bytes(self.buf[self.pos:self.pos + n], "little")
        self.pos += n
        return v

    def off(self) -> int:
        return self.u(self.so)

    def length(self) -> int:
        return self.u(self.sl)

    def raw(self, n: int) -> bytes:
        v = self.buf[self.pos:self.pos + n]
        self.pos += n
        return bytes(v)


class File:
    """An HDF5 file open for reading (the subset in the module docstring).
    `f["a/b"]` is a Group or a Dataset; `f.attrs` the root's attributes."""

    def __init__(self, path: str):
        self.filename = path
        self._fh = open(path, "rb")
        try:
            self._size = os.fstat(self._fh.fileno()).st_size
            self._superblock()
        except Exception:
            self._fh.close()
            raise
        self._heaps: Dict[int, bytes] = {}
        self._root = Group(self, "/", self._root_addr)

    # ---- file access
    def _read(self, addr: int, n: int) -> bytes:
        if self._base + addr + n > self._size or n < 0:
            raise ValueError(f"{self.filename}: a read of {n} bytes at {addr} passes the end "
                             f"of the file ({self._size} bytes)")
        self._fh.seek(self._base + addr)
        return self._fh.read(n)

    def _at(self, addr: int, n: int) -> _Reader:
        return _Reader(self._read(addr, n), 0, self._so, self._sl)

    def _superblock(self) -> None:
        base = 0
        while True:  # after a user block the signature sits at 512, 1024, 2048, ...
            self._fh.seek(base)
            head = self._fh.read(9)
            if head[:8] == SIGNATURE:
                break
            base = 512 if base == 0 else base * 2
            if base >= self._size:
                raise ValueError(f"{self.filename}: no HDF5 signature (not an HDF5 file)")
        version = head[8]
        if version not in (0, 1):
            raise ValueError(f"{self.filename} (/): superblock version {version} (a "
                             "libver='latest' file) is outside the supported subset "
                             "(versions 0 and 1)")
        self._fh.seek(base + 8)
        buf = self._fh.read(200)
        r = _Reader(buf, 0, 8, 8)
        r.u(5)  # versions: superblock, free space, root symbol table entry, reserved, shared
        self._so, self._sl = r.u(1), r.u(1)
        r.so, r.sl = self._so, self._sl
        r.u(5)  # reserved, the group B-trees' K (2 + 2)
        r.u(4)  # consistency flags
        if version == 1:
            r.u(4)  # indexed storage K, reserved
        self._base = r.off() or base
        r.off()  # free-space address
        r.off()  # end of file
        r.off()  # driver information block
        r.off()  # root entry: link name offset
        self._root_addr = r.off()

    # ---- object headers
    def _messages(self, addr: int, path: str) -> List[Tuple[int, int, bytes]]:
        """(type, flags, data) of every message of the object header at addr."""
        head = self._read(addr, 16)
        if head[:4] == b"OHDR":
            raise ValueError(f"{self.filename} ({path}): version 2 object header (OHDR, a "
                             "libver='latest' file) is outside the supported subset")
        if head[0] != 1:
            raise ValueError(f"{self.filename} ({path}): object header version {head[0]} "
                             "is not supported")
        size = struct.unpack_from("<I", head, 8)[0]
        chunks = [(addr + 16, size)]
        out = []
        while chunks:
            at, size = chunks.pop(0)
            buf = self._read(at, size)
            pos = 0
            while pos + 8 <= size:
                mtype, msize, flags = struct.unpack_from("<HHB", buf, pos)
                data = buf[pos + 8:pos + 8 + msize]
                pos += 8 + msize
                if mtype == _NIL:
                    continue
                if flags & 0x2:
                    raise ValueError(f"{self.filename} ({path}): shared message of type "
                                     f"{mtype:#x} (a committed datatype) is not supported")
                if mtype == _CONTINUATION:
                    r = _Reader(data, 0, self._so, self._sl)
                    chunks.append((r.off(), r.length()))
                    continue
                if mtype in _NEW_STYLE:
                    raise ValueError(f"{self.filename} ({path}): {_NEW_STYLE[mtype]} message "
                                     "(a new-style group, libver='latest' or track_order) is "
                                     "outside the supported subset")
                out.append((mtype, flags, data))
        return out

    def _local_heap(self, addr: int, path: str) -> bytes:
        if addr not in self._heaps:
            r = self._at(addr, 8 + 2 * self._sl + self._so)
            if r.raw(4) != b"HEAP":
                raise ValueError(f"{self.filename} ({path}): bad local heap signature")
            r.u(4)
            size = r.length()
            r.length()  # free list
            self._heaps[addr] = self._read(r.off(), size)
        return self._heaps[addr]

    def _global_heap_object(self, coll: int, index: int, path: str) -> bytes:
        key = ("gcol", coll)
        if key not in self._heaps:
            head = self._at(coll, 8 + self._sl)
            if head.raw(4) != b"GCOL":
                raise ValueError(f"{self.filename} ({path}): bad global heap signature")
            head.u(4)
            size = head.length()
            buf = self._read(coll, size)
            objects, pos = {}, 8 + self._sl
            while pos + 8 + self._sl <= size:
                r = _Reader(buf, pos, self._so, self._sl)
                idx = r.u(2)
                r.u(6)
                n = r.length()
                if idx == 0:  # the free space closes the collection
                    break
                objects[idx] = bytes(buf[r.pos:r.pos + n])
                pos = r.pos + _pad8(n)
            self._heaps[key] = objects
        return self._heaps[key][index]

    def _btree(self, addr: int, node_type: int, path: str, ndims: int = 0) -> list:
        """The level-0 entries of a version 1 B-tree: (key, child) with key
        the chunk's (size, filter mask, offsets) for raw data, None for a
        group's (whose children are symbol nodes)."""
        key_size = self._sl if node_type == 0 else 8 + 8 * ndims
        out = []
        todo = [addr]
        while todo:
            at = todo.pop(0)
            head = self._at(at, 8 + 2 * self._so)
            if head.raw(4) != b"TREE":
                raise ValueError(f"{self.filename} ({path}): bad B-tree node signature")
            kind, level, used = head.u(1), head.u(1), head.u(2)
            if kind != node_type:
                raise ValueError(f"{self.filename} ({path}): B-tree node of type {kind}, "
                                 f"expected {node_type}")
            r = self._at(at + 8 + 2 * self._so, used * (key_size + self._so) + key_size)
            children = []
            for _ in range(used):
                key = r.raw(key_size)
                children.append((key, r.off()))
            if level > 0:
                todo[:0] = [c for _, c in children]
                continue
            for key, child in children:
                if node_type == 0:
                    out.append((None, child))
                else:
                    size, mask = struct.unpack_from("<II", key, 0)
                    offsets = struct.unpack_from(f"<{ndims}Q", key, 8)
                    out.append(((size, mask, offsets[:-1]), child))
        return out

    # ---- the mapping interface
    def __getitem__(self, name: str):
        return self._root[name]

    def __contains__(self, name: str) -> bool:
        return name in self._root

    def __iter__(self):
        return iter(self._root)

    @property
    def attrs(self) -> Dict:
        return self._root.attrs

    def close(self) -> None:
        self._fh.close()

    def __enter__(self) -> "File":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _child_path(path: str, name: str) -> str:
    return f"/{name}" if path == "/" else f"{path}/{name}"


class _Object:
    def __init__(self, file: File, name: str, addr: int, messages=None):
        self.file, self.name, self._addr = file, name, addr
        self._msgs = messages if messages is not None else file._messages(addr, name)
        self._attrs = None

    @property
    def attrs(self) -> Dict:
        """The object's attributes: numpy scalars or arrays, str for
        variable-length strings, bytes for fixed-length ones."""
        if self._attrs is None:
            self._attrs = {}
            for mtype, _, data in self._msgs:
                if mtype == _ATTRIBUTE:
                    key, value = _attribute(self.file, data, self.name)
                    self._attrs[key] = value
                elif mtype == _ATTRIBUTE_INFO:
                    r = _Reader(data, 2 + (2 if data[1] & 1 else 0), self.file._so,
                                self.file._sl)
                    if r.off() != (1 << (8 * self.file._so)) - 1:
                        raise ValueError(f"{self.file.filename} ({self.name}): dense "
                                         "attribute storage (a fractal heap) is outside the "
                                         "supported subset")
        return self._attrs


class Group(_Object):
    """A symbol-table group: names in sorted order, `g["a/b"]`."""

    def __init__(self, file: File, name: str, addr: int, messages=None):
        super().__init__(file, name, addr, messages)
        stab = [d for t, _, d in self._msgs if t == _SYMBOL_TABLE]
        if not stab:
            raise ValueError(f"{file.filename} ({name}): a group without a symbol table "
                             "message is outside the supported subset")
        r = _Reader(stab[0], 0, file._so, file._sl)
        self._btree_addr, self._heap_addr = r.off(), r.off()
        self._links: Optional[Dict[str, int]] = None

    def _entries(self) -> Dict[str, int]:
        if self._links is None:
            f = self.file
            heap = f._local_heap(self._heap_addr, self.name)
            entry = 2 * f._so + 24
            links = {}
            for _, snod in f._btree(self._btree_addr, 0, self.name):
                head = f._read(snod, 8)
                if head[:4] != b"SNOD":
                    raise ValueError(f"{f.filename} ({self.name}): bad symbol node signature")
                n = struct.unpack_from("<H", head, 6)[0]
                r = f._at(snod + 8, n * entry)
                for _ in range(n):
                    name_off, header = r.off(), r.off()
                    r.raw(24)  # cache type, reserved, scratch pad
                    links[heap[name_off:heap.index(b"\0", name_off)].decode()] = header
            self._links = dict(sorted(links.items()))
        return self._links

    def __getitem__(self, name: str):
        parts = [p for p in name.split("/") if p]
        if name.startswith("/") and self.name != "/":
            return self.file[name]
        if not parts:
            return self
        links = self._entries()
        if parts[0] not in links:
            raise KeyError(f"{parts[0]!r} is not in {self.name} of {self.file.filename}")
        path = _child_path(self.name, parts[0])
        addr = links[parts[0]]
        msgs = self.file._messages(addr, path)
        obj = (Group(self.file, path, addr, msgs)
               if any(t == _SYMBOL_TABLE for t, _, _ in msgs)
               else Dataset(self.file, path, addr, msgs))
        return obj["/".join(parts[1:])] if len(parts) > 1 else obj

    def __contains__(self, name: str) -> bool:
        try:
            self[name]
        except KeyError:
            return False
        return True

    def __iter__(self):
        return iter(self._entries())


def _datatype(buf: bytes, pos: int, where: str) -> Tuple[object, int, int]:
    """(numpy dtype or the vlen-string marker, element size, bytes read) of
    the datatype message at buf[pos:]."""
    cls_ver, b0, b1, b2, size = struct.unpack_from("<BBBBI", buf, pos)
    cls, version = cls_ver & 0x0F, cls_ver >> 4
    bits = b0 | (b1 << 8) | (b2 << 16)
    if cls == 0:  # fixed-point
        order = ">" if bits & 1 else "<"
        if size not in (1, 2, 4, 8):
            raise ValueError(f"{where}: {size}-byte integers are outside the supported subset")
        return np.dtype(f"{order}{'i' if bits & 8 else 'u'}{size}"), size, 12
    if cls == 1:  # IEEE float
        if bits & 0x40 or size not in (2, 4, 8):
            raise ValueError(f"{where}: a {size}-byte float in a non-IEEE layout is outside "
                             "the supported subset")
        return np.dtype(f"{'>' if bits & 1 else '<'}f{size}"), size, 20
    if cls == 3:  # fixed-length string
        return np.dtype(f"S{size}"), size, 8
    if cls == 8:  # enum: its base type's codes
        nmembers = bits & 0xFFFF
        base, base_size, used = _datatype(buf, pos + 8, where)
        at = pos + 8 + used
        for _ in range(nmembers):
            end = buf.index(b"\0", at)
            at = end + 1 if version >= 3 else at + _pad8(end - at + 1)
        return base, base_size, at + nmembers * base_size - pos
    if cls == 9:  # variable length
        if bits & 0xF != 1:
            raise ValueError(f"{where}: variable-length sequences are outside the supported "
                             "subset (only variable-length strings)")
        _, _, used = _datatype(buf, pos + 8, where)
        return _VLEN_STRING, size, 8 + used
    names = {2: "time", 4: "bitfield", 5: "opaque", 6: "compound", 7: "reference",
             10: "array", 11: "complex"}
    raise ValueError(f"{where}: datatype class {cls} ({names.get(cls, 'unknown')}) is outside "
                     "the supported subset")


def _dataspace(data: bytes, so: int, sl: int, where: str) -> Tuple[int, ...]:
    version, rank, flags = data[0], data[1], data[2]
    if version == 1:
        pos = 8
    elif version == 2:
        if data[3] == 2:  # null dataspace
            return (0,)
        pos = 4
    else:
        raise ValueError(f"{where}: dataspace version {version} is not supported")
    r = _Reader(data, pos, so, sl)
    return tuple(r.length() for _ in range(rank))


def _decode(file: File, raw: bytes, dtype, shape, where: str):
    """Elements of `dtype` from raw bytes; variable-length strings resolved
    through the global heap into an object array of str."""
    count = int(np.prod(shape, dtype=np.int64))
    if dtype is not _VLEN_STRING:
        return np.frombuffer(raw, dtype=dtype, count=count).reshape(shape)
    out = np.empty(count, dtype=object)
    r = _Reader(raw, 0, file._so, file._sl)
    for i in range(count):
        n = r.u(4)
        coll, index = r.off(), r.u(4)
        out[i] = file._global_heap_object(coll, index, where)[:n].decode("utf-8")
    return out.reshape(shape)


def _attribute(file: File, data: bytes, where: str):
    version, flags = data[0], data[1]
    name_size, type_size, space_size = struct.unpack_from("<HHH", data, 2)
    if version not in (1, 2, 3):
        raise ValueError(f"{where}: attribute message version {version} is not supported")
    if flags & 0x3:
        raise ValueError(f"{where}: an attribute with a shared datatype or dataspace is "
                         "outside the supported subset")
    pos = 8 + (1 if version == 3 else 0)
    pad = _pad8 if version == 1 else (lambda n: n)
    name = data[pos:pos + name_size].split(b"\0")[0].decode()
    pos += pad(name_size)
    dtype, size, _ = _datatype(data, pos, f"{where} attribute {name!r}")
    pos += pad(type_size)
    shape = _dataspace(data[pos:pos + space_size], file._so, file._sl, where)
    pos += pad(space_size)
    count = int(np.prod(shape, dtype=np.int64))
    value = _decode(file, data[pos:pos + count * size], dtype, shape, where)
    return name, (value[()] if shape == () else value)


class Dataset(_Object):
    """A dataset: `shape`, `dtype`, `ds[...]` / `ds[lo:hi]` / `ds[i]`.
    `chunks_read` counts the chunks decoded so far."""

    def __init__(self, file: File, name: str, addr: int, messages=None):
        super().__init__(file, name, addr, messages)
        where = f"{file.filename} ({name})"
        self.filters: List[Tuple[int, int, Tuple[int, ...]]] = []
        layout = None
        for mtype, _, data in self._msgs:
            if mtype == _DATASPACE:
                self.shape = _dataspace(data, file._so, file._sl, where)
            elif mtype == _DATATYPE:
                self._type, self._esize, _ = _datatype(data, 0, where)
            elif mtype == _LAYOUT:
                layout = data
            elif mtype == _FILTERS:
                self.filters = _filters(data, where)
        if layout is None:
            raise ValueError(f"{where}: no data layout message")
        self.dtype = np.dtype(object) if self._type is _VLEN_STRING else self._type
        if layout[0] != 3:
            raise ValueError(f"{where}: data layout version {layout[0]} is outside the "
                             "supported subset (version 3)")
        self._class = layout[1]
        r = _Reader(layout, 2, file._so, file._sl)
        self.chunks: Optional[Tuple[int, ...]] = None
        if self._class == 0:  # compact
            n = r.u(2)
            self._compact = r.raw(n)
        elif self._class == 1:  # contiguous
            self._data_addr = r.off()
        elif self._class == 2:  # chunked
            ndims = r.u(1)
            self._btree_addr = r.off()
            self.chunks = tuple(r.u(4) for _ in range(ndims))[:-1]
            self._chunk_index = None
        else:
            raise ValueError(f"{where}: layout class {self._class} is outside the supported "
                             "subset")
        if self.filters and self._class != 2:
            raise ValueError(f"{where}: filters on an unchunked dataset")
        self.chunks_read = 0
        self._last_chunk = None

    def __getitem__(self, key):
        if isinstance(key, (int, np.integer)):
            n = self.shape[0]
            i = int(key) + n if key < 0 else int(key)
            if not 0 <= i < n:
                raise IndexError(f"index {key} is out of range for {self.name} of {n} rows")
            return self._rows(i, i + 1)[0]
        if key is Ellipsis or (isinstance(key, tuple) and not key):
            return self._rows(0, self.shape[0] if self.shape else 1)[()]
        if isinstance(key, slice):
            rows = range(*key.indices(self.shape[0]))
            if key.step in (None, 1) or not rows:
                return self._rows(rows.start, max(rows.start, rows.stop))
            first = min(rows[0], rows[-1])
            return self._rows(first, max(rows[0], rows[-1]) + 1)[np.asarray(rows) - first]
        raise TypeError(f"{self.name}: index {key!r} is not supported (an int, a slice, ... "
                        "or ())")

    def _rows(self, lo: int, hi: int):
        """Rows [lo, hi) of the first axis (a scalar dataset has one row)."""
        f, where = self.file, f"{self.file.filename} ({self.name})"
        rest = self.shape[1:] if self.shape else ()
        row = int(np.prod(rest, dtype=np.int64)) * self._esize
        if self._class == 0:
            out = _decode(f, self._compact[lo * row:hi * row], self._type,
                          (hi - lo, *rest), where)
        elif self._class == 1:
            if hi <= lo or self._data_addr == (1 << (8 * f._so)) - 1:  # empty or unwritten
                out = np.zeros((max(hi - lo, 0), *rest), self.dtype)
            else:
                raw = f._read(self._data_addr + lo * row, (hi - lo) * row)
                out = _decode(f, raw, self._type, (hi - lo, *rest), where)
        else:
            out = self._chunked(lo, hi, rest, where)
        return out if self.shape else out.reshape(())

    def _chunked(self, lo: int, hi: int, rest, where: str):
        if self._type is _VLEN_STRING:
            raise ValueError(f"{where}: chunked variable-length strings are outside the "
                             "supported subset")
        # chunks never written read as the fill value; h5py's default is 0
        out = np.zeros((max(hi - lo, 0), *rest), self._type)
        if hi <= lo:
            return out
        if self._chunk_index is None:
            entries = self.file._btree(self._btree_addr, 1, self.name, len(self.chunks) + 1)
            self._chunk_index = sorted(((key[2], key[0], key[1], addr)
                                        for key, addr in entries), key=lambda e: e[0])
            self._chunk_starts = np.asarray([e[0][0] for e in self._chunk_index], np.int64)
        c0 = self.chunks[0]
        first, last = np.searchsorted(self._chunk_starts, [lo - c0 + 1, hi])
        for offsets, size, mask, addr in self._chunk_index[first:last]:
            start = offsets[0]
            chunk = self._chunk(offsets, size, mask, addr, where)
            a, b = max(lo, start), min(hi, start + c0, self.shape[0])
            region = tuple(slice(o, min(o + c, s)) for o, c, s in
                           zip(offsets[1:], self.chunks[1:], self.shape[1:]))
            inner = tuple(slice(0, r.stop - r.start) for r in region)
            out[(slice(a - lo, b - lo), *region)] = chunk[(slice(a - start, b - start),
                                                            *inner)]
        return out

    def _chunk(self, offsets, size: int, mask: int, addr: int, where: str) -> np.ndarray:
        if self._last_chunk is not None and self._last_chunk[0] == offsets:
            return self._last_chunk[1]
        buf = self.file._read(addr, size)
        for i in reversed(range(len(self.filters))):
            if mask & (1 << i):
                continue
            fid, _, client = self.filters[i]
            if fid == _DEFLATE:
                buf = zlib.decompress(buf)
            elif fid == _SHUFFLE:
                buf = _unshuffle(buf, client[0] if client else self._esize)
            elif fid == _FLETCHER32:
                buf = _check_fletcher32(buf, where)
        chunk = np.frombuffer(buf, self._type,
                              count=int(np.prod(self.chunks, dtype=np.int64))).reshape(self.chunks)
        self.chunks_read += 1
        self._last_chunk = (offsets, chunk)
        return chunk


def _filters(data: bytes, where: str) -> List[Tuple[int, int, Tuple[int, ...]]]:
    version, n = data[0], data[1]
    pos = 8 if version == 1 else 2
    out = []
    for _ in range(n):
        fid = struct.unpack_from("<H", data, pos)[0]
        pos += 2
        name_len = 0
        if version == 1 or fid >= 256:
            name_len = struct.unpack_from("<H", data, pos)[0]
            pos += 2
        flags, ncd = struct.unpack_from("<HH", data, pos)
        pos += 4
        name = data[pos:pos + name_len].split(b"\0")[0].decode(errors="replace")
        pos += _pad8(name_len) if version == 1 else name_len
        client = struct.unpack_from(f"<{ncd}I", data, pos)
        pos += 4 * ncd + (4 if version == 1 and ncd % 2 else 0)
        if fid not in (_DEFLATE, _SHUFFLE, _FLETCHER32):
            label = name or _FILTER_NAMES.get(fid, "unknown")
            raise ValueError(f"{where}: filter {fid} ({label}) is outside the supported "
                             "subset (deflate, shuffle, fletcher32)")
        out.append((fid, flags, client))
    return out


def _unshuffle(buf: bytes, esize: int) -> bytes:
    n = len(buf) // esize
    if esize <= 1 or n <= 1:
        return buf
    body = np.frombuffer(buf, np.uint8, count=n * esize).reshape(esize, n).T
    return body.tobytes() + buf[n * esize:]


def _fletcher32(buf: bytes) -> int:
    """HDF5's Fletcher checksum (H5_checksum_fletcher32): sums of big-endian
    16-bit words, reduced mod 65535 with 0 kept only for an all-zero sum."""
    if len(buf) % 2:
        buf = buf + b"\0"
    words = np.frombuffer(buf, ">u2").astype(np.int64)
    n = words.size
    s1 = int(words.sum())
    s2 = int((words * np.arange(n, 0, -1, dtype=np.int64)).sum())

    def fold(s):
        return 0 if s == 0 else (s - 1) % 65535 + 1

    return (fold(s2) << 16) | fold(s1)


def _check_fletcher32(buf: bytes, where: str) -> bytes:
    body, stored = buf[:-4], struct.unpack("<I", buf[-4:])[0]
    got = _fletcher32(body)
    swapped = ((got & 0xFF) << 24) | ((got & 0xFF00) << 8) | ((got >> 8) & 0xFF00) | (got >> 24)
    if stored not in (got, swapped):  # older libraries stored it byte-swapped
        raise ValueError(f"{where}: fletcher32 checksum mismatch ({stored:#x} stored, "
                         f"{got:#x} computed)")
    return body


# ------------------------------------------------------------------ writer

_UNDEF = b"\xff" * 8
_LEAF_K, _INTERNAL_K = 4, 16  # h5py's defaults: 8 links a symbol node, 32 nodes a B-tree


def _datatype_message(dtype: np.dtype, name: str) -> bytes:
    dtype = np.dtype(dtype)
    order = 1 if dtype.byteorder == ">" else 0
    if dtype.kind in "iu" and dtype.itemsize in (1, 2, 4, 8):
        return struct.pack("<BBBBIHH", 0x10, order | (8 if dtype.kind == "i" else 0), 0, 0,
                           dtype.itemsize, 0, 8 * dtype.itemsize)
    if dtype.kind == "f" and dtype.itemsize in (4, 8):
        exp_loc, exp_size, mant, bias = (23, 8, 23, 127) if dtype.itemsize == 4 else \
            (52, 11, 52, 1023)
        bits = 8 * dtype.itemsize
        return struct.pack("<BBBBIHHBBBBI", 0x11, order | 0x20, bits - 1, 0, dtype.itemsize, 0,
                           bits, exp_loc, exp_size, 0, mant, bias)
    if dtype.kind == "S" and dtype.itemsize > 0:
        return struct.pack("<BBBBI", 0x13, 1, 0, 0, dtype.itemsize)  # null-padded ASCII
    raise ValueError(f"{name}: write_file writes integers, 4- and 8-byte floats and "
                     f"fixed-length strings, not {dtype}")


def _message(mtype: int, data: bytes) -> bytes:
    data = data + b"\0" * (_pad8(len(data)) - len(data))
    return struct.pack("<HHB3x", mtype, len(data), 0) + data


def _object_header(messages: List[bytes]) -> bytes:
    body = b"".join(messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body


class _Writer:
    def __init__(self, fh):
        self.fh = fh
        self.eof = 96  # the superblock

    def put(self, data) -> int:
        """Write bytes or a contiguous array at the end; returns its address."""
        addr = self.eof
        if isinstance(data, np.ndarray):
            data = memoryview(data.reshape(-1).view(np.uint8))
        self.fh.seek(addr)
        self.fh.write(data)
        self.eof = _pad8(addr + len(data))
        return addr

    def dataset(self, a: np.ndarray, name: str) -> int:
        a = np.ascontiguousarray(a)
        dtype_msg = _datatype_message(a.dtype, name)
        addr = self.put(a) if a.nbytes else None
        dims = b"".join(struct.pack("<Q", d) for d in a.shape)
        space = struct.pack("<BBB5x", 1, a.ndim, 0) + dims
        layout = struct.pack("<BB", 3, 1) + (struct.pack("<Q", addr) if addr is not None
                                             else _UNDEF) + struct.pack("<Q", a.nbytes)
        return self.put(_object_header([_message(_DATASPACE, space),
                                        _message(_DATATYPE, dtype_msg),
                                        _message(_LAYOUT, layout)]))

    def group(self, tree: Mapping, name: str) -> Tuple[int, int, int]:
        """(object header, B-tree, local heap) of a group and its children."""
        links = []
        for key in sorted(tree, key=lambda k: str(k).encode()):
            child, path = tree[key], _child_path(name, str(key))
            if isinstance(child, Mapping):
                header, btree, heap = self.group(child, path)
                links.append((str(key), header, (btree, heap)))
            else:
                links.append((str(key), self.dataset(np.asarray(child), path), None))
        heap, offsets = bytearray(8), []
        for key, _, _ in links:
            encoded = key.encode()
            if b"/" in encoded or not encoded:
                raise ValueError(f"{name}: bad link name {key!r}")
            offsets.append(len(heap))
            heap += encoded + b"\0" * (_pad8(len(encoded) + 1) - len(encoded))
        heap_data = self.put(bytes(heap))
        heap_addr = self.put(b"HEAP" + struct.pack("<B3xQQQ", 0, len(heap), 1, heap_data))
        per = 2 * _LEAF_K
        nodes = [list(range(i, min(i + per, len(links)))) for i in range(0, len(links), per)]
        if len(nodes) > 2 * _INTERNAL_K:
            raise ValueError(f"{name}: write_file writes at most {2 * _INTERNAL_K * per} "
                             "links a group")
        snods = []
        for node in nodes:
            body = bytearray(b"SNOD" + struct.pack("<BBH", 1, 0, len(node)))
            for i in node:
                _, header, stab = links[i]
                body += struct.pack("<QQI4x", offsets[i], header, 1 if stab else 0)
                body += struct.pack("<QQ", *stab) if stab else b"\0" * 16
            body += b"\0" * (8 + per * 40 - len(body))
            snods.append(self.put(bytes(body)))
        tree_node = bytearray(b"TREE" + struct.pack("<BBH", 0, 0, len(snods)) + _UNDEF * 2)
        tree_node += struct.pack("<Q", 0)
        for node, snod in zip(nodes, snods):
            tree_node += struct.pack("<QQ", snod, offsets[node[-1]])
        tree_node += b"\0" * (24 + 2 * _INTERNAL_K * 8 + (2 * _INTERNAL_K + 1) * 8
                              - len(tree_node))
        btree = self.put(bytes(tree_node))
        header = self.put(_object_header([_message(_SYMBOL_TABLE,
                                                   struct.pack("<QQ", btree, heap_addr))]))
        return header, btree, heap_addr


def write_file(path: str, tree: Mapping) -> str:
    """Write a tree of groups (mappings) and datasets (numpy arrays of
    integers, 4- or 8-byte floats or fixed-length strings) as an HDF5 file
    h5py opens: superblock 0, version 1 object headers, symbol-table groups,
    contiguous datasets without filters."""
    with open(path, "wb") as fh:
        w = _Writer(fh)
        header, btree, heap = w.group(tree, "/")
        eof = w.eof
        fh.truncate(eof)
        sb = (SIGNATURE + struct.pack("<8B", 0, 0, 0, 0, 0, 8, 8, 0)
              + struct.pack("<HHI", _LEAF_K, _INTERNAL_K, 0)
              + struct.pack("<Q", 0) + _UNDEF + struct.pack("<Q", eof) + _UNDEF
              + struct.pack("<QQI4xQQ", 0, header, 1, btree, heap))
        fh.seek(0)
        fh.write(sb)
    return path
