"""Build and load the port's CUDA kernels.

Every `hicdiff_tpu_torch/csrc/*.cu` file is compiled by `nvcc` for Hopper
(`sm_90a`) into ONE shared library with a plain C interface, which the kernel
wrappers load with `ctypes`. The build happens on first use (the first CUDA
tensor that reaches a kernel), not at import, so the package imports on a
machine without `nvcc` or a GPU. The library lands in `build/hicdiff_tpu_torch/`
beside the package, named by a hash of the sources and flags: a changed
source rebuilds, an unchanged one loads the existing file.
"""
from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile

__all__ = [
    "BUILD_DIR", "NVCC_FLAGS", "check_status", "find_nvcc", "library_path",
    "load_library",
]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "hicdiff_tpu_torch")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # per-kernel registers / shared memory / spills, kept in the .log
)


def find_nvcc() -> str | None:
    """`$CUDA_HOME/bin/nvcc` (default `/usr/local/cuda`), else `nvcc` on PATH."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = os.path.join(home, "bin", "nvcc")
    return candidate if os.path.isfile(candidate) else shutil.which("nvcc")


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(_CSRC_DIR, "*.cu")))


def library_path() -> str:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libhicdiff_kernels_{h.hexdigest()[:16]}.so")


def _compile(nvcc: str, dst: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    # compile to a private name and rename, so a concurrent build or a build
    # cut off halfway never leaves a truncated library under the final name
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-o", tmp, *_sources()],
            capture_output=True, text=True, check=False,
        )
        with open(os.path.splitext(dst)[0] + ".log", "w") as log:
            log.write(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed (exit {proc.returncode}) building {dst}:\n"
                f"{proc.stderr[-4000:]}"
            )
        os.replace(tmp, dst)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build the kernels if needed and load them; raise if that is impossible.

    A failure is not cached, so a later call tries again."""
    dst = library_path()
    if not os.path.exists(dst):
        nvcc = find_nvcc()
        if nvcc is None:
            raise RuntimeError(
                "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
                "PATH): the port's CUDA kernels cannot be built on this machine"
            )
        _compile(nvcc, dst)
    lib = ctypes.CDLL(dst)
    lib.hicdiff_cuda_error_string.argtypes = [ctypes.c_int]
    lib.hicdiff_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check_status(lib: ctypes.CDLL, status: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error."""
    if status != 0:
        msg = lib.hicdiff_cuda_error_string(status).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {status} ({msg})")
