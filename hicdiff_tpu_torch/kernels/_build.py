"""Build and load the port's CUDA kernels.

Every `hicdiff_tpu_torch/csrc/*.cu` file is compiled by `nvcc` for Hopper
(`sm_90a`), one `nvcc` per source, all started together, and the objects are
linked into ONE shared library with a plain C interface, which the kernel
wrappers load with `ctypes`. The build happens on first use (the first CUDA
tensor that reaches a kernel), not at import, so the package imports on a
machine without `nvcc` or a GPU. The library lands in `build/hicdiff_tpu_torch/`
beside the package, named by a hash of the sources and flags: a changed
source rebuilds, an unchanged one loads the existing file.

`current_stream` and `on_device` are the launch helpers the wrappers share.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile

import torch

__all__ = [
    "BUILD_DIR", "NVCC_FLAGS", "check_status", "current_stream", "find_nvcc", "library_path",
    "load_library", "on_device",
]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "hicdiff_tpu_torch")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
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
    h = hashlib.sha256(" ".join(NVCC_FLAGS + ("-shared",)).encode())
    for src in _sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libhicdiff_kernels_{h.hexdigest()[:16]}.so")


def _run_all(cmds: list[list[str]]) -> list[tuple[int, str]]:
    """Run the commands in parallel; (exit code, stdout + stderr) of each."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    return [(p.returncode, out) for p, out in zip(procs, outs)]


def _compile(nvcc: str, dst: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    # build in a private directory and rename, so a concurrent build or a
    # build cut off halfway never leaves a truncated library under the final name
    work = tempfile.mkdtemp(dir=BUILD_DIR)
    try:
        sources = _sources()
        objs = [os.path.join(work, os.path.basename(src) + ".o") for src in sources]
        results = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
                            for src, obj in zip(sources, objs)])
        tmp = os.path.join(work, "lib.so")
        if all(rc == 0 for rc, _ in results):
            results += _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]])
        with open(os.path.splitext(dst)[0] + ".log", "w") as log:
            log.write("".join(out for _, out in results))
        for (rc, out), what in zip(results, sources + ["the link"]):
            if rc != 0:
                raise RuntimeError(f"nvcc failed (exit {rc}) on {what} building {dst}:\n"
                                   f"{out[-4000:]}")
        os.replace(tmp, dst)
    finally:
        shutil.rmtree(work, ignore_errors=True)


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


def current_stream(index: int) -> int:
    """The cudaStream_t of PyTorch's current stream on CUDA device `index`.

    torch._C._cuda_getCurrentRawStream, which torch's compiled kernels
    launch on, returns the handle without building the Python Stream object
    that torch.cuda.current_stream() builds, which costs more host time than
    the launch itself."""
    return torch._C._cuda_getCurrentRawStream(index)


def on_device(index: int):
    """A context in which CUDA device `index` is current. Entering
    torch.cuda.device costs microseconds of host time, so it is entered only
    when another device is current."""
    if index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(index)
