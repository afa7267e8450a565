"""Read the JAX package's msgpack checkpoints without flax or JAX.

Port of the reading half of hicdiff_tpu/train/checkpoint.py
(`load_checkpoint(only=...)` and `warn_run_config_mismatch`); the writer
comes with training. A checkpoint is a msgpack map {params, opt_state, step,
ema_params, run_config}; arrays are flax's msgpack ext type 1 (a packed
(shape, dtype name, C-order bytes) triple), numpy scalars ext type 3, and
leaves over 1 GiB are split into `__msgpack_chunked_array__` maps. The map
is stream-decoded, and keys outside `only` are skipped without building
their arrays. Leaves come back as numpy arrays.

`msgpack` is imported inside `load_checkpoint`, so the port imports on a
machine without it; there, loading a checkpoint raises ImportError.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

__all__ = ["load_checkpoint", "warn_run_config_mismatch"]

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3  # flax's _MsgpackExtType
_CHUNKED = "__msgpack_chunked_array__"


def _ndarray_from_bytes(msgpack, data: bytes) -> np.ndarray:
    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    if dtype_name == b"bfloat16":
        raise ValueError("bfloat16 checkpoint leaves are not supported (numpy has no bfloat16)")
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode())).reshape(shape)


def _ext_hook(msgpack):
    def hook(code, data):
        if code == _EXT_NDARRAY:
            return _ndarray_from_bytes(msgpack, data)
        if code == _EXT_NPSCALAR:
            return _ndarray_from_bytes(msgpack, data)[()]
        if code == _EXT_COMPLEX:
            real, imag = msgpack.unpackb(data)
            return complex(real, imag)
        return msgpack.ExtType(code, data)

    return hook


def _unchunk(tree):
    """Join flax's chunked leaves back into arrays."""
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        chunks = tree["chunks"]
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        flat = np.concatenate([chunks[str(i)] for i in range(len(chunks))])
        return flat.reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def load_checkpoint(path: str, only: Optional[set] = None) -> dict:
    """The checkpoint's top-level map, restricted to the keys in `only`
    (all keys when None). Absent keys simply don't appear."""
    import msgpack

    limit = 2**31 - 1
    with open(path, "rb") as f:
        unpacker = msgpack.Unpacker(
            f, ext_hook=_ext_hook(msgpack), raw=False, strict_map_key=False,
            max_buffer_size=2**33, max_bin_len=limit, max_str_len=limit,
            max_array_len=limit, max_map_len=limit, max_ext_len=limit,
        )
        out = {}
        for _ in range(unpacker.read_map_header()):
            key = unpacker.unpack()
            if only is None or key in only:
                out[key] = _unchunk(unpacker.unpack())
            else:
                unpacker.skip()
    return out


def _sigma_irrelevant(stored: dict, expect: dict) -> bool:
    """A sigma difference is benign only when both sides claim mode='uncond'
    (the unconditional prior never sees the noise level)."""
    return stored.get("mode") == "uncond" and expect.get("mode") == "uncond"


def warn_run_config_mismatch(ck: dict, expect: dict, path: str) -> list:
    """Print a warning for each key whose stored run_config value differs
    from `expect`; keys absent on either side are ignored. Returns the keys."""
    stored = ck.get("run_config") or {}
    skip = {"sigma"} if _sigma_irrelevant(stored, expect) else set()
    bad = [
        k for k, v in expect.items()
        if k not in skip and k in stored and stored[k] is not None and stored[k] != v
    ]
    for k in bad:
        print(
            f"WARNING: checkpoint {os.path.basename(path)} was trained with "
            f"{k}={stored[k]!r} but this run uses {k}={expect[k]!r} — results "
            "will be silently wrong if this is not intentional"
        )
    return bad
