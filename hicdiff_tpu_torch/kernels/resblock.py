"""Fused hicedrn residual block (port of hicdiff_tpu/kernels/resblock.py).

    y = conv(silu(conv(x) * (scale + 1) + shift)) * 0.1 + x

with ONE shared 3x3 C->C conv (bias, SAME zero padding) applied twice, NHWC.
Accumulation is fp32; the intermediate is cast back to x's dtype between the
two convs, as in the Pallas kernel.

`fused_resblock` takes the plain PyTorch version below for a CPU tensor. For
a CUDA tensor it launches the hand-written kernel of `csrc/resblock.cu` twice
(conv #1 with the scale-shift-SiLU epilogue, conv #2 with the x0.1 residual
epilogue) or raises: there is no fallback.

The CUDA kernels read the conv weight packed (`prepare_weight`): bf16 the
N x K matrix of `pack_conv_weight`, fp32 that matrix split into its TF32 high
and low parts (`tf32_split`), which the fp32 kernel multiplies as three TF32
products (3xTF32) on the tensor cores. `fused_resblock` prepares the weight
on every call; a module that calls the block many times with one weight
prepares it once and calls `fused_resblock_prepared`.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from hicdiff_tpu_torch.kernels import _build

__all__ = [
    "fused_resblock", "fused_resblock_prepared", "fused_resblock_reference",
    "pack_conv_weight", "prepare_weight", "tf32_round", "tf32_split",
]

_CONV1, _CONV2 = 1, 2  # the epilogue modes of csrc/resblock.cu
_DTYPES = (torch.float32, torch.bfloat16)


def fused_resblock_reference(x, kernel, bias, scale, shift):
    """The plain PyTorch version: fp32 convs on x's dtype, like the kernel.

    x (B,H,W,C); kernel (3,3,C,C) HWIO; bias (C,); scale/shift (B,C)."""
    dt = x.dtype
    w = kernel.float().permute(3, 2, 0, 1)  # HWIO -> OIHW
    b = bias.float()

    def conv(t):
        return F.conv2d(t.float().permute(0, 3, 1, 2), w, b, padding=1).permute(0, 2, 3, 1)

    h = conv(x) * (scale.float()[:, None, None, :] + 1.0) + shift.float()[:, None, None, :]
    h = F.silu(h).to(dt)
    return (conv(h) * 0.1 + x.float()).to(dt)


def pack_conv_weight(kernel):
    """(3, 3, C, C) HWIO -> (C, 9C): row co holds kernel[ky, kx, ci, co] at
    column (3 ky + kx) C + ci. This N x K, K-major matrix is what the bf16
    kernel loads by TMA, one (64 k, BN n) box per tap and 64 input channels."""
    c = kernel.shape[-1]
    return kernel.permute(3, 0, 1, 2).reshape(c, 9 * c).contiguous()


def tf32_round(t):
    """fp32 `t` rounded to TF32 (10 explicit mantissa bits, the low 13 bits
    of the word cleared), to nearest with ties away from zero, as
    cvt.rna.tf32.f32 rounds and csrc/resblock.cu's tf32_round computes: add
    half of the dropped bits' range to the magnitude, then clear them.
    inf and NaN pass through."""
    bits = t.contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isfinite(t), rounded, t)


def tf32_split(t):
    """(hi, lo) = (tf32(t), tf32(t - hi)): hi + lo is within 2^-22 |t| of t."""
    hi = tf32_round(t)
    return hi, tf32_round(t - hi)


def prepare_weight(kernel):
    """The conv weight as the CUDA kernel of its dtype reads it: bf16 takes
    `pack_conv_weight(kernel)` (C, 9C); fp32 that matrix's `tf32_split`
    planes stacked as (2, C, 9C), hi first."""
    packed = pack_conv_weight(kernel)
    if kernel.dtype == torch.bfloat16:
        return packed
    return torch.stack(tf32_split(packed))


def _hwio_view(packed):
    """The (3, 3, C, C) HWIO view of a packed (C, 9C) matrix."""
    c = packed.shape[0]
    return packed.view(c, 3, 3, c).permute(1, 2, 3, 0)


def _hwio(weight):
    """The (3, 3, C, C) HWIO kernel of a `prepare_weight` result. For fp32
    it is hi + lo, computed exactly in fp32 (22 significant bits), which is
    within 2^-22 |w| of the kernel that was prepared: the weight the CUDA
    kernel multiplies."""
    if weight.dtype != torch.bfloat16:
        weight = weight[0] + weight[1]
    return _hwio_view(weight)


def _check(x, kernel, bias, scale, shift):
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, C), got shape {tuple(x.shape)}")
    b, _, _, c = x.shape
    if x.dtype not in _DTYPES:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    for name, t, shape in (("kernel", kernel, (3, 3, c, c)), ("bias", bias, (c,)),
                           ("scale", scale, (b, c)), ("shift", shift, (b, c))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if t.dtype != x.dtype:
            raise ValueError(f"{name} must have x's dtype {x.dtype}, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


@functools.lru_cache(maxsize=None)
def _conv3x3(dtype):
    lib = _build.load_library()
    fn = lib.hicdiff_conv3x3_bf16 if dtype == torch.bfloat16 else lib.hicdiff_conv3x3_f32
    p = ctypes.c_void_p
    fn.argtypes = [p, p, p, p, p, ctypes.c_longlong, p, p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, p]
    fn.restype = ctypes.c_int
    return lib, fn


def _check_cuda(x, weight, bias, scale, shift):
    if not x.is_cuda:
        raise ValueError(f"fused_resblock runs on CPU or CUDA tensors, got {x.device}")
    c = x.shape[-1]
    if c % 128:
        raise ValueError(f"the CUDA kernels need C a multiple of 128, got C={c}")
    if x.numel() == 0:
        raise ValueError(f"x must have B, H, W >= 1, got shape {tuple(x.shape)}")
    if not (x.is_contiguous() and weight.is_contiguous() and bias.is_contiguous()):
        raise ValueError("x, the conv weight and bias must be contiguous")
    if scale.stride(1) != 1 or shift.stride(1) != 1 or scale.stride(0) != shift.stride(0):
        raise ValueError("scale and shift must be row-major with one row stride")
    vec = 16 // x.element_size()  # elements per 16-byte load
    if scale.stride(0) % vec:
        raise ValueError(f"scale/shift row stride must be a multiple of {vec}")
    for t in (x, weight, bias, scale, shift):
        if t.data_ptr() % 16:
            raise ValueError("the CUDA kernel needs 16-byte aligned tensors")


def _launch(fn, lib, src, weight, bias, scale, shift, res, out, mode):
    b, h, w, c = src.shape
    status = fn(
        src.data_ptr(), weight.data_ptr(), bias.data_ptr(), scale.data_ptr(),
        shift.data_ptr(), scale.stride(0), None if res is None else res.data_ptr(),
        out.data_ptr(), b, h, w, c, mode, _build.current_stream(src.get_device()),
    )
    _build.check_status(lib, status, "fused_resblock")
    fused_resblock.launches += 1


def _fused_resblock_cuda(x, weight, bias, scale, shift):
    lib, fn = _conv3x3(x.dtype)
    _check_cuda(x, weight, bias, scale, shift)
    with _build.on_device(x.get_device()):
        hidden = torch.empty_like(x)
        out = torch.empty_like(x)
        _launch(fn, lib, x, weight, bias, scale, shift, None, hidden, _CONV1)
        _launch(fn, lib, hidden, weight, bias, scale, shift, x, out, _CONV2)
    return out


def fused_resblock(x, kernel, bias, scale, shift):
    """y = conv(silu(conv(x)*(scale+1)+shift))*0.1 + x with one shared conv.

    x: (B, H, W, C) NHWC, float32 or bfloat16; kernel: (3, 3, C, C) HWIO;
    bias: (C,); scale/shift: (B, C) (= split(Dense(silu(t_emb)))). All in x's
    dtype and on x's device. Each call on CUDA is two kernel launches, each
    counted in `fused_resblock.launches`."""
    _check(x, kernel, bias, scale, shift)
    if x.device.type == "cpu":
        return fused_resblock_reference(x, kernel, bias, scale, shift)
    return _fused_resblock_cuda(x, prepare_weight(kernel), bias, scale, shift)


def fused_resblock_prepared(x, weight, bias, scale, shift):
    """`fused_resblock` with the conv weight given as `prepare_weight(kernel)`.
    A CPU tensor takes the plain version on the HWIO kernel of `weight`
    (`_hwio`); CUDA launches count in `fused_resblock.launches`."""
    c = x.shape[-1]
    want = (c, 9 * c) if weight.dtype == torch.bfloat16 else (2, c, 9 * c)
    if tuple(weight.shape) != want:
        raise ValueError(f"a {weight.dtype} prepared weight has shape {want}, "
                         f"got {tuple(weight.shape)}")
    # checked on a view of the (first) plane, which costs no device work
    _check(x, _hwio_view(weight.view(-1, 9 * c)[:c]), bias, scale, shift)
    if x.device.type == "cpu":
        return fused_resblock_reference(x, _hwio(weight), bias, scale, shift)
    return _fused_resblock_cuda(x, weight, bias, scale, shift)


fused_resblock.launches = 0
