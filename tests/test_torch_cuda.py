"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `cuda` and skips without a CUDA device. The file
imports neither JAX nor the JAX package (the card has neither), so on the
card it runs without the suite's conftest, from the repo root:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

fp32 comparisons turn TF32 off, or the plain convs would run in TF32.
"""
import numpy as np
import pytest
import torch

import torch.nn.functional as F

from hicdiff_tpu_torch.kernels.resblock import fused_resblock, fused_resblock_reference
from hicdiff_tpu_torch.kernels.sample_step import (
    fused_posterior_step,
    fused_posterior_step_reference,
)
from hicdiff_tpu_torch.models.hicedrn import HicedrnDiff, HicedrnResBlock

pytestmark = pytest.mark.cuda

STEP_SCALARS = (1.1, 0.5, 0.7, 0.3, -2.0)  # a, b, c1, c2, logvar


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,tol,shape", [
    (torch.float32, 1e-4, (2, 10, 13, 256)),
    (torch.float32, 1e-4, (8, 64, 64, 256)),
    (torch.float32, 1e-4, (1, 6, 80, 256)),
    (torch.float32, 1e-4, (2, 10, 13, 128)),
    (torch.float32, 1e-4, (1, 5, 70, 384)),
    (torch.float32, 1e-4, (1, 3, 9, 512)),
    (torch.bfloat16, 0.016, (8, 64, 64, 256)),
    (torch.bfloat16, 0.016, (2, 10, 13, 256)),
    (torch.bfloat16, 0.016, (1, 6, 80, 256)),
    (torch.bfloat16, 0.016, (2, 10, 13, 128)),
    (torch.bfloat16, 0.016, (1, 5, 70, 384)),
    (torch.bfloat16, 0.016, (1, 3, 9, 512)),
], ids=["fp32", "fp32_main", "fp32_two_column_tiles", "fp32_c128", "fp32_c384", "fp32_c512",
        "bf16_main", "bf16_ragged", "bf16_two_column_tiles", "bf16_c128", "bf16_c384",
        "bf16_c512"])
def test_resblock_kernel_matches_plain(cuda_device, dtype, tol, shape):
    """fp32: three TF32 products per term (each within 2^-22 |a||w| of the
    fp32 product) summed over K = 9*C terms in another order; bf16: one ulp
    of |y| < 4.
    (8,64,64,256) is the main path's shape; W = 13, 70 and 80 leave ragged
    column tiles, odd H a ragged row tile, W != H checks the row arithmetic;
    C = 128 and 384 leave the last 256-channel tile half empty (zero-filled
    weight rows, no stores past C), C = 512 takes two full tiles."""
    rng = np.random.default_rng(0)
    b, h, w, c = shape
    bound = 1.0 / np.sqrt(9 * c)
    arrays = (
        rng.normal(size=(b, h, w, c)) * 0.5,
        rng.uniform(-bound, bound, size=(3, 3, c, c)),
        rng.uniform(-bound, bound, size=(c,)),
        rng.normal(size=(b, c)) * 0.5,
        rng.normal(size=(b, c)) * 0.5,
    )
    args = [torch.tensor(a, dtype=dtype, device=cuda_device) for a in arrays]
    before = fused_resblock.launches
    got = fused_resblock(*args)
    want = fused_resblock_reference(*args)
    torch.cuda.synchronize()
    assert fused_resblock.launches == before + 2
    assert got.dtype == dtype and got.shape == (b, h, w, c)
    assert (got.float() - want.float()).abs().max().item() <= tol


def test_posterior_step_kernel_matches_plain_and_draws_normals(cuda_device):
    g = torch.Generator().manual_seed(5)
    x = torch.randn(64, 4096, generator=g).to(cuda_device)
    eps = torch.randn(64, 4096, generator=g).to(cuda_device)
    before = fused_posterior_step.launches
    out, x0 = fused_posterior_step(x, eps, *STEP_SCALARS, 0.0, 1)
    want_out, want_x0 = fused_posterior_step_reference(x, eps, *STEP_SCALARS, 0.0, 1)
    assert fused_posterior_step.launches == before + 1
    assert (out - want_out).abs().max().item() <= 1e-6
    assert (x0 - want_x0).abs().max().item() <= 1e-6
    zeros = torch.zeros_like(x)
    logvar = 2 * float(np.log(0.5))
    noise, _ = fused_posterior_step(x, zeros, 1.0, 0.0, 0.0, 0.0, logvar, 1.0, 7)
    again, _ = fused_posterior_step(x, zeros, 1.0, 0.0, 0.0, 0.0, logvar, 1.0, 7)
    other, _ = fused_posterior_step(x, zeros, 1.0, 0.0, 0.0, 0.0, logvar, 1.0, 8)
    assert abs(noise.mean().item()) < 0.01 and abs(noise.std().item() - 0.5) <= 0.01
    assert torch.equal(noise, again) and not torch.equal(noise, other)


def test_backbone_kernel_path_matches_plain_path(cuda_device):
    """The same seeded weights on the card (kernels) and the CPU (plain)."""
    kw = dict(self_condition=True, number_resnet=2, features=128)
    on_card = HicedrnDiff(device=cuda_device, generator=torch.Generator().manual_seed(0), **kw)
    on_cpu = HicedrnDiff(device="cpu", generator=torch.Generator().manual_seed(0), **kw)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 16, 16, 1, generator=g) * 0.3
    cond = torch.randn(2, 16, 16, 1, generator=g) * 0.3
    t = torch.tensor([3, 700])
    before = fused_resblock.launches
    with torch.no_grad():
        got = on_card(x.to(cuda_device), t.to(cuda_device), cond.to(cuda_device)).cpu()
        want = on_cpu(x, t, cond)
    assert fused_resblock.launches == before + 2 * 2
    assert (got - want).abs().max().item() <= 1e-4


def _cached_vs_public(device, dtype):
    """A residual block's output on the weight it prepared once, the public
    HWIO call's, which prepares the same weight on the fly, the launches of
    both, and the block's prepared conv weight."""
    torch.manual_seed(0)
    block = HicedrnResBlock(256, device=device)
    g = torch.Generator(device=device).manual_seed(1)
    x = (torch.randn(2, 16, 16, 256, generator=g, device=device) * 0.5).to(dtype)
    t_act = F.silu(torch.randn(2, 1024, generator=g, device=device)).to(dtype)
    before = fused_resblock.launches
    with torch.no_grad():
        got = block(x, t_act)
        lin, conv = block.mlp[1], block.conv["proj"]
        scale, shift = F.linear(t_act, lin.weight.to(dtype), lin.bias.to(dtype)).chunk(2, -1)
        kernel = conv.weight.permute(2, 3, 1, 0).to(dtype)
        want = fused_resblock(x, kernel, conv.bias.to(dtype), scale, shift)
    torch.cuda.synchronize()
    return got, want, fused_resblock.launches - before, block._compute_weights(dtype)[2]


def test_block_cached_pack_matches_public_call(cuda_device):
    """A residual block on the card runs on the weight it packed once; the
    public HWIO call packs on the fly. Same bytes in, so the same bits out."""
    got, want, launches, _ = _cached_vs_public(cuda_device, torch.bfloat16)
    assert launches == 4
    assert torch.equal(got, want)


def test_fp32_block_cached_pack_matches_public_call(cuda_device):
    """The same for fp32: the block's cached (2, C, 9C) TF32 hi/lo pack and
    the pack the public call makes are the same bytes, so the same bits out."""
    got, want, launches, packed = _cached_vs_public(cuda_device, torch.float32)
    assert launches == 4
    assert got.dtype == torch.float32
    assert packed.shape == (2, 256, 9 * 256)
    assert torch.equal(got, want)
