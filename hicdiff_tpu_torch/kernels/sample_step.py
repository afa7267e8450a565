"""Fused posterior sampling step (port of hicdiff_tpu/kernels/sample_step.py).

One reverse step after the model forward, elementwise in fp32:

    x0     = clip(a * x - b * eps, -1, 1)
    mean   = c1 * x0 + c2 * x
    x_next = mean + exp(logvar / 2) * gate * z,   z ~ N(0, 1) from `seed`

`fused_posterior_step` takes the plain PyTorch version below for a CPU
tensor. For a CUDA tensor it launches the kernel of `csrc/sample_step.cu`,
which draws z from a counter-based Philox inside the kernel, or raises.
The two draw different (equally distributed) noise for one seed, as the
Pallas kernel's noise differs from jax.random's.

A shard of a batch passes `offset`, its first element over 4: the kernel
then draws the noise the whole batch draws at those elements, and the plain
version draws z for the whole batch (`total` elements) and keeps the shard's.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from hicdiff_tpu_torch.kernels import _build

__all__ = ["fused_posterior_step", "fused_posterior_step_reference"]


def _noise_scale(post_log_var_t, noise_gate) -> float:
    # sigma * gate with sigma = exp(logvar / 2), as the JAX wrapper computes
    # it; the kernel receives it rounded to float32
    return math.exp(0.5 * post_log_var_t) * noise_gate


def _check_offset(offset: int, total) -> None:
    if int(offset) < 0:
        raise ValueError(f"offset must be >= 0, got {offset}")
    if total is not None and int(total) < 4 * int(offset):
        raise ValueError(f"total {total} ends before the shard's first element {4 * offset}")


def fused_posterior_step_reference(
    x, eps, sqrt_recip_acp_t, sqrt_recipm1_acp_t, post_coef1_t, post_coef2_t,
    post_log_var_t, noise_gate, seed, offset=0, total=None,
):
    """The plain PyTorch version; z comes from a CPU generator seeded `seed`:
    `total` draws (default 4 * offset + x.numel()) for the whole batch, of
    which the shard keeps those from element 4 * offset on; elements past
    `total` (a shard's padding) get z = 0."""
    _check_offset(offset, total)
    x = x.float()
    x0 = torch.clamp(sqrt_recip_acp_t * x - sqrt_recipm1_acp_t * eps.float(), -1.0, 1.0)
    mean = post_coef1_t * x0 + post_coef2_t * x
    scale = _noise_scale(post_log_var_t, noise_gate)
    if scale == 0.0:
        return mean, x0
    first, n = 4 * int(offset), x.numel()
    total = first + n if total is None else int(total)
    gen = torch.Generator().manual_seed(int(seed))
    z = torch.randn((total,), generator=gen, dtype=torch.float32)[first:first + n]
    z = torch.cat([z, z.new_zeros(n - z.numel())]).reshape(x.shape).to(x.device)
    return mean + scale * z, x0


@functools.lru_cache(maxsize=None)
def _posterior_step():
    lib = _build.load_library()
    fn = lib.hicdiff_posterior_step
    p, f = ctypes.c_void_p, ctypes.c_float
    u64 = ctypes.c_ulonglong
    fn.argtypes = [p, p, p, p, ctypes.c_longlong, f, f, f, f, f, u64, u64, p]
    fn.restype = ctypes.c_int
    return lib, fn


def fused_posterior_step(
    x, eps, sqrt_recip_acp_t, sqrt_recipm1_acp_t, post_coef1_t, post_coef2_t,
    post_log_var_t, noise_gate, seed, offset=0, total=None,
):
    """(x_{t-1}, x0) from (x_t, predicted eps) and the step's schedule scalars.

    x, eps: same shape; the schedule values are Python floats; noise_gate is
    1.0 for t > 0 and 0.0 at t == 0; seed: int in [0, 2**64). offset: the
    shard's first element over 4 within the whole batch, whose element count
    is `total` (read by the plain version only: the kernel's draw of an
    element does not depend on the batch's size). Outputs are float32 in x's
    shape. Each CUDA call is one launch, counted in
    `fused_posterior_step.launches`."""
    if eps.shape != x.shape:
        raise ValueError(f"eps shape {tuple(eps.shape)} != x shape {tuple(x.shape)}")
    if eps.device != x.device:
        raise ValueError(f"eps is on {eps.device}, x on {x.device}")
    if x.device.type == "cpu":
        return fused_posterior_step_reference(
            x, eps, sqrt_recip_acp_t, sqrt_recipm1_acp_t, post_coef1_t, post_coef2_t,
            post_log_var_t, noise_gate, seed, offset, total,
        )
    lib, fn = _posterior_step()
    if not x.is_cuda:
        raise ValueError(f"fused_posterior_step runs on CPU or CUDA tensors, got {x.device}")
    if x.dtype != torch.float32 or eps.dtype != torch.float32:
        raise ValueError(f"x and eps must be float32, got {x.dtype} and {eps.dtype}")
    if not (x.is_contiguous() and eps.is_contiguous()):
        raise ValueError("x and eps must be contiguous")
    if x.data_ptr() % 16 or eps.data_ptr() % 16:
        raise ValueError("the CUDA kernel needs 16-byte aligned x and eps")
    if not 0 <= int(seed) < 2**64:
        raise ValueError(f"seed must be in [0, 2**64), got {seed}")
    _check_offset(offset, total)
    x_next = torch.empty_like(x)
    x0 = torch.empty_like(x)
    if x.numel() == 0:
        return x_next, x0
    args = (x.data_ptr(), eps.data_ptr(), x_next.data_ptr(), x0.data_ptr(), x.numel(),
            sqrt_recip_acp_t, sqrt_recipm1_acp_t, post_coef1_t, post_coef2_t,
            _noise_scale(post_log_var_t, noise_gate), int(seed), int(offset))
    index = x.get_device()
    with _build.on_device(index):
        status = fn(*args, _build.current_stream(index))
    _build.check_status(lib, status, "fused_posterior_step")
    fused_posterior_step.launches += 1
    return x_next, x0


fused_posterior_step.launches = 0
