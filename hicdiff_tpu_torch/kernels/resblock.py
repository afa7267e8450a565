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

Training goes through `FusedResblockFn`, a torch.autograd.Function on the
fp32 OIHW conv weight and bias, in the dtype of the block's scale (fp32, or
bf16 with the parameters cast for the forward and fp32 gradients returned).
On CUDA its forward runs conv #1 in the mode that also stores
z = conv(x) + bias (mode 3) and conv #2 as above, and keeps x, z and h;
its backward, for g = dL/dy,

    d_h = 0.1 convT(g);  u = z (scale + 1) + shift;  du = d_h silu'(u)
    dz = du (scale + 1);  dshift = sum_hw du;  dscale = sum_hw du z
    dx = g + convT(dz);   dW = corr(x, dz) + 0.1 corr(h, g)
    db = sum dz + 0.1 sum g

runs the two dgrad modes of the same kernel (`resblock_dgrad`: modes 4 and
5, on the pack of the transposed kernel, `transpose_kernel`) and the weight
gradient and channel sums of `csrc/resblock_bwd.cu`. In bf16, x, z, h, g,
dz, du and dx are bf16 (the flow of JAX's cotangents) and every sum and
epilogue operation is fp32. On a CPU tensor the Function's forward is
`fused_resblock_reference` and its backward the plain twin
`fused_resblock_backward_reference`, in the same dtype flow; nothing on the
CUDA path calls them.

The bf16 attention variant's residual stream is fp32 (the JAX package's
post-norm promotes it). A block on it reads the stream cast to bf16 and
adds its bf16-rounded branch to the fp32 stream in fp32 (`residual`): on
CUDA conv #2 runs mode 6, and the backward adds the fp32 g to the rounded
convT(dz) in mode 7.
"""
from __future__ import annotations

import collections
import ctypes
import functools

import torch
import torch.nn.functional as F

from hicdiff_tpu_torch.kernels import _build
from hicdiff_tpu_torch.kernels.resblock_bwd import (
    resblock_channel_sums,
    resblock_channel_sums_reference,
    resblock_wgrad,
    resblock_wgrad_reference,
)

__all__ = [
    "FusedResblockFn", "fused_resblock", "fused_resblock_backward_reference",
    "fused_resblock_prepared", "fused_resblock_reference", "pack_conv_weight",
    "prepare_weight", "resblock_dgrad", "tf32_round", "tf32_split", "transpose_kernel",
]

# the epilogue modes of csrc/resblock.cu (6 and 7: bf16 onto an fp32 stream)
_CONV1, _CONV2, _CONV1_Z, _DGRAD2, _DGRAD1, _CONV2_F32, _DGRAD1_F32 = 1, 2, 3, 4, 5, 6, 7
_DTYPES = (torch.float32, torch.bfloat16)


def fused_resblock_reference(x, kernel, bias, scale, shift, residual=None):
    """The plain PyTorch version: fp32 convs on x's dtype, like the kernel.

    x (B,H,W,C); kernel (3,3,C,C) HWIO; bias (C,); scale/shift (B,C).
    `residual`: the fp32 stream of the JAX package's bf16 attention variant,
    of which x is the bf16 cast; the branch, rounded to x's dtype, is added
    to it in fp32 (csrc/resblock.cu mode 6). None: the branch is added to x."""
    dt = x.dtype
    w = kernel.float().permute(3, 2, 0, 1)  # HWIO -> OIHW
    b = bias.float()

    def conv(t):
        return F.conv2d(t.float().permute(0, 3, 1, 2), w, b, padding=1).permute(0, 2, 3, 1)

    h = conv(x) * (scale.float()[:, None, None, :] + 1.0) + shift.float()[:, None, None, :]
    h = F.silu(h).to(dt)
    if residual is not None:
        return (conv(h) * 0.1).to(dt).float() + residual
    return (conv(h) * 0.1 + x.float()).to(dt)


def transpose_kernel(kernel):
    """The HWIO kernel of convT, the adjoint of the 3x3 SAME conv with
    `kernel`: flipped in space, C_in and C_out swapped. convT(g) is the
    forward conv of g with this kernel, so the dgrad kernels read its pack."""
    return kernel.flip(0, 1).transpose(2, 3)


def _conv_f32(t, kernel, bias=None):
    """fp32 3x3 SAME conv of an NHWC tensor with an HWIO kernel."""
    y = F.conv2d(t.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1), bias, padding=1)
    return y.permute(0, 2, 3, 1)


def _dgrad_reference(g, z, scale, shift, kernel_t, stream=None):
    """The plain version of the two dgrad modes: (dx, dz, du) for g = dL/dy,
    the saved z and the transposed kernel (`transpose_kernel`), all in g's
    dtype, with fp32 convs and epilogues as the kernels compute them.
    `stream`: the fp32 g of the attention variant's stream, to which the
    rounded convT(dz) is added in fp32 (mode 7); dx is then fp32."""
    dt = g.dtype
    sc, sh = scale.float()[:, None, None, :], shift.float()[:, None, None, :]
    kernel_t = kernel_t.float()
    d_h = _conv_f32(g.float(), kernel_t) * 0.1
    u = z.float() * (sc + 1.0) + sh
    s = torch.sigmoid(u)
    du = d_h * (s * (1.0 + u * (1.0 - s)))
    dz = (du * (sc + 1.0)).to(dt)
    conv = _conv_f32(dz.float(), kernel_t)
    dx = (conv + g.float()).to(dt) if stream is None else conv.to(dt).float() + stream
    return dx, dz, du.to(dt)


def fused_resblock_backward_reference(g, x, kernel, bias, scale, shift):
    """The plain twin of the block's backward: the gradients (dx, dkernel
    (3,3,C,C) HWIO, dbias, dscale, dshift) of `fused_resblock_reference(x,
    kernel, bias, scale, shift)` for g = dL/dy, by the formulas the kernels
    compute (module docstring), in their dtype flow: kernel, bias, scale and
    shift in the compute dtype; x and g in it, or fp32 for the attention
    variant's stream (the forward's `residual`); dkernel and dbias fp32,
    dscale and dshift in the compute dtype, dx in x's."""
    cdt = scale.dtype
    stream = g if x.dtype != cdt else None
    xc, gc = x.to(cdt), g.to(cdt)
    sc, sh = scale.float()[:, None, None, :], shift.float()[:, None, None, :]
    v = _conv_f32(xc.float(), kernel.float(), bias.float())
    z = v.to(cdt)
    h = F.silu(v * (sc + 1.0) + sh).to(cdt)
    dx, dz, du = _dgrad_reference(gc, z, scale, shift, transpose_kernel(kernel), stream)
    dscale, dshift, dbias = resblock_channel_sums_reference(du, z, dz, gc)
    dkernel = _hwio_view(resblock_wgrad_reference(xc, dz, h, gc))
    return dx, dkernel, dbias, dscale, dshift


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
    fn.argtypes = [p, p, p, p, p, ctypes.c_longlong, p, p, p,
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


def _check_cuda_tensor(t):
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError("the CUDA kernel needs contiguous, 16-byte aligned tensors")


def _launch(fn, lib, src, weight, bias, scale, shift, res, out, mode, aux=None, counter=None):
    """One launch of the conv kernel in epilogue `mode`, counted in
    `counter.launches` (default `fused_resblock`) and by mode in
    `counter.mode_launches`, and a launch in an fp32-stream mode (6, 7) also
    in `counter.stream_launches`."""
    b, h, w, c = src.shape
    status = fn(
        src.data_ptr(), weight.data_ptr(), bias.data_ptr(), scale.data_ptr(),
        shift.data_ptr(), scale.stride(0), None if res is None else res.data_ptr(),
        out.data_ptr(), None if aux is None else aux.data_ptr(), b, h, w, c, mode,
        _build.current_stream(src.get_device()),
    )
    _build.check_status(lib, status, "fused_resblock")
    counter = counter or fused_resblock
    counter.launches += 1
    counter.mode_launches[mode] += 1
    if mode in (_CONV2_F32, _DGRAD1_F32):
        counter.stream_launches += 1


def _check_stream(x, residual):
    """The fp32 stream of the attention variant: fp32, of x's shape and on
    x's device, with x bf16."""
    if residual is not None and (x.dtype != torch.bfloat16 or residual.dtype != torch.float32
                                 or residual.shape != x.shape or residual.device != x.device):
        raise ValueError(f"a bf16 block's residual is the float32 stream of its shape on its "
                         f"device, got {residual.dtype} {tuple(residual.shape)} on "
                         f"{residual.device} for {x.dtype} {tuple(x.shape)} on {x.device}")


def _fused_resblock_cuda(x, weight, bias, scale, shift, residual=None, saving=False):
    """The block's two launches on CUDA: conv #1 in mode 1 (mode 3 with
    `saving`, which also stores z), conv #2 in mode 2, or mode 6 onto the
    fp32 stream `residual`. Returns y, or (y, z, h) with `saving`."""
    lib, fn = _conv3x3(x.dtype)
    _check_cuda(x, weight, bias, scale, shift)
    if residual is not None:
        _check_cuda_tensor(residual)
    with _build.on_device(x.get_device()):
        z = torch.empty_like(x) if saving else None
        hidden = torch.empty_like(x)
        out = torch.empty_like(x if residual is None else residual)
        _launch(fn, lib, x, weight, bias, scale, shift, None, hidden,
                _CONV1_Z if saving else _CONV1, aux=z)
        _launch(fn, lib, hidden, weight, bias, scale, shift, x if residual is None else residual,
                out, _CONV2 if residual is None else _CONV2_F32)
    return (out, z, hidden) if saving else out


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


def fused_resblock_prepared(x, weight, bias, scale, shift, residual=None):
    """`fused_resblock` with the conv weight given as `prepare_weight(kernel)`.
    `residual`: the attention variant's fp32 stream, of which x is the bf16
    cast (`fused_resblock_reference`); y is then fp32. A CPU tensor takes the
    plain version on the HWIO kernel of `weight` (`_hwio`); CUDA launches
    count in `fused_resblock.launches`."""
    c = x.shape[-1]
    want = (c, 9 * c) if weight.dtype == torch.bfloat16 else (2, c, 9 * c)
    if tuple(weight.shape) != want:
        raise ValueError(f"a {weight.dtype} prepared weight has shape {want}, "
                         f"got {tuple(weight.shape)}")
    # checked on a view of the (first) plane, which costs no device work
    _check(x, _hwio_view(weight.view(-1, 9 * c)[:c]), bias, scale, shift)
    _check_stream(x, residual)
    if x.device.type == "cpu":
        return fused_resblock_reference(x, _hwio(weight), bias, scale, shift, residual)
    return _fused_resblock_cuda(x, weight, bias, scale, shift, residual)


def resblock_dgrad(g, z, scale, shift, weight_t, stream=None):
    """(dx, dz, du) of the block for g = dL/dy (B, H, W, C), the saved z and
    `weight_t` = `prepare_weight(transpose_kernel(kernel))`, all in the
    compute dtype (fp32 or bf16). `stream`: the fp32 g of the attention
    variant's stream, which dx adds in fp32 (mode 7; dx fp32). On CUDA two
    launches of the conv kernel, modes 4 and 5 (or 7), each counted in
    `resblock_dgrad.launches`; a CPU tensor takes `_dgrad_reference`."""
    b, c = g.shape[0], g.shape[-1]
    want_t = (c, 9 * c) if g.dtype == torch.bfloat16 else (2, c, 9 * c)
    if g.dtype not in _DTYPES:
        raise ValueError(f"g must be float32 or bfloat16, got {g.dtype}")
    for name, t, shape in (("weight_t", weight_t, want_t), ("z", z, tuple(g.shape)),
                           ("scale", scale, (b, c)), ("shift", shift, (b, c))):
        if tuple(t.shape) != shape or t.dtype != g.dtype or t.device != g.device:
            raise ValueError(f"{name} must be {g.dtype} on {g.device} with shape {shape}, "
                             f"got {t.dtype} on {t.device}, {tuple(t.shape)}")
    _check_stream(g, stream)
    if g.device.type == "cpu":
        return _dgrad_reference(g, z, scale, shift, _hwio(weight_t), stream)
    lib, fn = _conv3x3(g.dtype)
    _check_cuda(g, weight_t, z, scale, shift)
    if stream is not None:
        _check_cuda_tensor(stream)
    with _build.on_device(g.get_device()):
        dz = torch.empty_like(g)
        du = torch.empty_like(g)
        dx = torch.empty_like(g if stream is None else stream)
        # modes 4 and 5 read no bias; scale stands in for the pointer
        _launch(fn, lib, g, weight_t, scale, scale, shift, z, dz, _DGRAD2, aux=du,
                counter=resblock_dgrad)
        _launch(fn, lib, dz, weight_t, scale, scale, shift, g if stream is None else stream, dx,
                _DGRAD1 if stream is None else _DGRAD1_F32, counter=resblock_dgrad)
    return dx, dz, du


class FusedResblockFn(torch.autograd.Function):
    """The residual block with its backward: apply(x, weight, bias, scale,
    shift, packs) with x (B, H, W, C) NHWC, weight (C, C, 3, 3) OIHW and bias
    (C,) the fp32 conv parameters, scale/shift (B, C) in the compute dtype
    (fp32 or bf16), which the parameters are cast to for the forward; x is
    in the compute dtype, or is the attention variant's fp32 stream under
    bf16 (`fused_resblock_reference`'s `residual`). packs, on CUDA: the
    block's (`prepare_weight(kernel)`, `prepare_weight(transpose_kernel(
    kernel))`) of the current weight in the compute dtype (None: made here).
    The weight and bias gradients are fp32, dscale and dshift in the compute
    dtype, dx in x's. Each forward and backward launch is counted by its
    wrapper."""

    @staticmethod
    def forward(ctx, x, weight, bias, scale, shift, packs=None):
        cdt = scale.dtype
        kernel, bias_c = weight.permute(2, 3, 1, 0).to(cdt), bias.to(cdt)
        stream = x if x.dtype != cdt else None
        xc = x.to(cdt)
        _check(xc, kernel, bias_c, scale, shift)
        _check_stream(xc, stream)
        if x.device.type == "cpu":
            ctx.save_for_backward(x, weight, bias, scale, shift)
            return fused_resblock_reference(xc, kernel, bias_c, scale, shift, stream)
        if packs is None:
            packs = (prepare_weight(kernel), prepare_weight(transpose_kernel(kernel)))
        out, z, hidden = _fused_resblock_cuda(xc, packs[0], bias_c, scale, shift, stream,
                                              saving=True)
        ctx.save_for_backward(xc, z, hidden, scale, shift)
        ctx.weight_t, ctx.stream = packs[1], stream is not None
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        if g.device.type == "cpu":
            x, weight, bias, scale, shift = ctx.saved_tensors
            cdt = scale.dtype
            dx, dkernel, dbias, dscale, dshift = fused_resblock_backward_reference(
                g, x, weight.permute(2, 3, 1, 0).to(cdt), bias.to(cdt), scale, shift)
            return dx, dkernel.permute(3, 2, 0, 1), dbias, dscale, dshift, None
        xc, z, hidden, scale, shift = ctx.saved_tensors
        stream = g if ctx.stream else None
        gc = g.to(scale.dtype)
        dx, dz, du = resblock_dgrad(gc, z, scale, shift, ctx.weight_t, stream)
        dscale, dshift, dbias = resblock_channel_sums(du, z, dz, gc)
        packed = resblock_wgrad(xc, dz, hidden, gc)  # (C, 9C) fp32: [co][ky][kx][ci]
        c = packed.shape[0]
        dweight = packed.view(c, 3, 3, c).permute(0, 3, 1, 2).contiguous()
        return dx, dweight, dbias, dscale, dshift, None


fused_resblock.launches = fused_resblock.stream_launches = 0
resblock_dgrad.launches = resblock_dgrad.stream_launches = 0
fused_resblock.mode_launches = collections.Counter()
resblock_dgrad.mode_launches = collections.Counter()
