"""The port's kernels on the CPU: their plain versions against the JAX
package's Pallas kernels (interpret mode) and flax, and the rule that a
non-CPU tensor never takes the plain version. The CUDA kernels themselves
are held to their plain versions in tests/test_torch_cuda.py.

Inputs come from numpy seeds and go through both frameworks as numpy arrays.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from hicdiff_tpu.kernels.resblock import fused_resblock as jax_fused_resblock
from hicdiff_tpu.kernels.sample_step import fused_posterior_step as jax_fused_posterior_step
from hicdiff_tpu.models.hicedrn import HicedrnResBlock
from hicdiff_tpu_torch.kernels import _build
from hicdiff_tpu_torch.kernels import resblock as resblock_mod
from hicdiff_tpu_torch.kernels import sample_step as sample_step_mod
from hicdiff_tpu_torch.kernels.resblock import (
    fused_resblock,
    fused_resblock_prepared,
    fused_resblock_reference,
    pack_conv_weight,
    prepare_weight,
    tf32_round,
    tf32_split,
)
from hicdiff_tpu_torch.kernels.sample_step import fused_posterior_step

STEP_SCALARS = (1.1, 0.5, 0.7, 0.3, -2.0)  # a, b, c1, c2, logvar
TILE_H, TILE_W, BK = 2, 64, 64  # the bf16 kernel's output tile and k-block (csrc/resblock.cu)
BK_F32 = 32  # the fp32 kernel's k-block: 32 channels, one 128-byte row


def _block_inputs(shape, seed=0):
    """x and a flax HicedrnResBlock's params + its (scale, shift), as numpy."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * 0.5).astype(np.float32)
    temb = rng.normal(size=(shape[0], shape[-1] * 4)).astype(np.float32)
    block = HicedrnResBlock(features=shape[-1])
    params = block.init(jax.random.PRNGKey(seed), jnp.asarray(x), jnp.asarray(temb))["params"]
    params = jax.tree.map(np.asarray, params)
    dense = params["Dense_0"]["Dense_0"]
    te = (temb / (1 + np.exp(-temb))) @ dense["kernel"] + dense["bias"]
    scale, shift = np.split(te.astype(np.float32), 2, axis=-1)
    conv = params["Conv2d_0"]["Conv_0"]
    return block, params, temb, x, conv["kernel"], conv["bias"], scale, shift


def test_resblock_plain_matches_pallas_kernel_and_flax():
    """fp32 at (1,16,16,256): the bar tests/test_fastpath.py holds the Pallas
    kernel to against flax."""
    block, params, temb, *args = _block_inputs((1, 16, 16, 256))
    got = fused_resblock(*(torch.tensor(a) for a in args)).numpy()
    pallas = np.asarray(jax_fused_resblock(*map(jnp.asarray, args), interpret=True))
    flax = np.asarray(block.apply({"params": params}, jnp.asarray(args[0]), jnp.asarray(temb)))
    assert np.abs(got - pallas).max() <= 2e-5
    assert np.abs(got - flax).max() <= 2e-5


def test_resblock_plain_bf16_matches_pallas_kernel():
    """bf16 inputs, fp32 accumulation, bf16 intermediate: both sides round
    the same fp32 values, so they differ by at most one bf16 ulp of |y| < 4."""
    _, _, _, *args = _block_inputs((1, 16, 16, 256), seed=1)
    args_bf16 = [jnp.asarray(a).astype(jnp.bfloat16) for a in args]
    pallas = np.asarray(jax_fused_resblock(*args_bf16, interpret=True).astype(jnp.float32))
    got = fused_resblock(
        *(torch.tensor(np.asarray(a.astype(jnp.float32))).to(torch.bfloat16)
          for a in args_bf16)
    )
    assert got.dtype == torch.bfloat16
    assert np.abs(got.float().numpy() - pallas).max() <= 0.016


def _tiled_conv(x, packed, bias, bk=BK, product=lambda a, w: a @ w.T):
    """conv(x) + bias as the CUDA kernels decompose it, in fp32. Each
    2-row x 64-column output tile (M = 128 pixels in [h][w] order) sums, over
    the 9 taps and the C/bk input-channel slices, the shifted (2, 64, bk)
    window of x, zero-filled outside x as TMA fills it, times the packed
    weight's (..., C, bk) slice of that k-block: `product(a, w)` of each."""
    b, h, w, c = x.shape
    th, tw = -(-h // TILE_H), -(-w // TILE_W)
    xpad = torch.zeros(b, th * TILE_H + 2, tw * TILE_W + 2, c)
    xpad[:, 1:h + 1, 1:w + 1] = x
    acc = torch.zeros(b, th, tw, TILE_H * TILE_W, c)
    for kb in range(9 * c // bk):
        tap, c0 = divmod(kb * bk, c)
        dy, dx = divmod(tap, 3)
        window = xpad[:, dy:dy + th * TILE_H, dx:dx + tw * TILE_W, c0:c0 + bk]
        a = (window.reshape(b, th, TILE_H, tw, TILE_W, bk).permute(0, 1, 3, 2, 4, 5)
             .reshape(b, th, tw, TILE_H * TILE_W, bk))
        acc += product(a, packed[..., kb * bk:(kb + 1) * bk])
    y = (acc.reshape(b, th, tw, TILE_H, TILE_W, c).permute(0, 1, 3, 2, 4, 5)
         .reshape(b, th * TILE_H, tw * TILE_W, c))
    return y[:, :h, :w] + bias


@pytest.mark.parametrize("shape", [(1, 10, 13, 128), (1, 6, 80, 128), (1, 16, 16, 256)],
                         ids=["ragged_w13", "two_column_tiles", "c256"])
def test_packed_weight_in_tiled_decomposition_matches_reference_and_pallas(shape):
    """pack_conv_weight's layout, read the way the bf16 kernel reads it, gives
    the block: fp32, at the bar tests/test_fastpath.py holds the Pallas kernel
    to against flax. W = 13 and 80 leave a ragged last column tile."""
    _, _, _, *args = _block_inputs(shape)
    x, kernel, bias, scale, shift = (torch.tensor(a) for a in args)
    packed = pack_conv_weight(kernel)
    assert packed.shape == (shape[-1], 9 * shape[-1]) and packed.is_contiguous()
    hidden = F.silu(_tiled_conv(x, packed, bias) * (scale[:, None, None] + 1.0)
                    + shift[:, None, None])
    got = (_tiled_conv(hidden, packed, bias) * 0.1 + x).numpy()
    want = fused_resblock_reference(x, kernel, bias, scale, shift).numpy()
    pallas = np.asarray(jax_fused_resblock(*map(jnp.asarray, args), interpret=True))
    assert np.abs(got - want).max() <= 2e-5
    assert np.abs(got - pallas).max() <= 2e-5


def _three_tf32(a, w):
    """a @ w[0].T as the fp32 kernel computes it from w = (hi, lo) planes:
    A split as the kernel splits it, then the three TF32 products, small
    terms first, summed in fp32 (a product of two TF32 values is exact)."""
    a_hi, a_lo = tf32_split(a)
    return a_lo @ w[0].T + a_hi @ w[1].T + a_hi @ w[0].T


def _one_tf32(a, w):
    return tf32_round(a) @ w[0].T


def test_tf32_round_ties_away_and_split_is_exact_to_2e22():
    # 1 + 2^-11 is halfway between 1 and 1 + 2^-10: ties away from zero
    # (round to nearest even would give 1)
    tie = torch.tensor([1 + 2.0**-11, -(1 + 2.0**-11), 1 + 3 * 2.0**-11, 0.0])
    assert tf32_round(tie).tolist() == [1 + 2.0**-10, -(1 + 2.0**-10), 1 + 2.0**-9, 0.0]
    special = torch.tensor([float("inf"), float("-inf"), float("nan")])
    assert torch.equal(tf32_round(special)[:2], special[:2])
    assert tf32_round(special)[2].isnan()
    w = torch.from_numpy(np.random.default_rng(4).normal(size=4096).astype(np.float32))
    w = w * torch.logspace(-6, 3, 4096)
    hi, lo = tf32_split(w)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    assert ((hi + lo - w).abs() <= 2.0**-22 * w.abs()).all()
    assert ((hi - w).abs() <= 2.0**-11 * w.abs()).all()


@pytest.mark.parametrize("shape", [(1, 10, 13, 128), (1, 6, 80, 128), (1, 16, 16, 256)],
                         ids=["ragged_w13", "two_column_tiles", "c256"])
def test_3xtf32_tiled_decomposition_matches_reference_and_pallas(shape):
    """The fp32 kernel's arithmetic: the tiled decomposition with 32-channel
    k-blocks, the weight as prepare_weight's (hi, lo) planes, A split per
    k-block, three TF32 products. It holds the block to the plain version and
    the Pallas kernel at 2e-5, and a single TF32 product per term misses the
    Pallas result by at least 100x more: the split is what gives fp32."""
    _, _, _, *args = _block_inputs(shape)
    x, kernel, bias, scale, shift = (torch.tensor(a) for a in args)
    planes = prepare_weight(kernel)
    assert planes.shape == (2, shape[-1], 9 * shape[-1]) and planes.is_contiguous()

    def block(product):
        hidden = F.silu(_tiled_conv(x, planes, bias, BK_F32, product)
                        * (scale[:, None, None] + 1.0) + shift[:, None, None])
        return (_tiled_conv(hidden, planes, bias, BK_F32, product) * 0.1 + x).numpy()

    got, single = block(_three_tf32), block(_one_tf32)
    want = fused_resblock_reference(x, kernel, bias, scale, shift).numpy()
    pallas = np.asarray(jax_fused_resblock(*map(jnp.asarray, args), interpret=True))
    err = np.abs(got - pallas).max()
    assert np.abs(got - want).max() <= 2e-5
    assert err <= 2e-5
    assert np.abs(single - pallas).max() >= 100 * err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_prepared_weight_gives_the_hwio_call(dtype):
    """On the CPU the prepared path runs the plain version on the HWIO kernel
    of the prepared weight. bf16: bit for bit the public call. fp32: the
    prepared kernel is hi + lo, within 2^-22 |w| of w, so the two calls agree
    to 1e-6 but not bitwise."""
    _, _, _, *args = _block_inputs((2, 6, 5, 128), seed=3)
    x, kernel, bias, scale, shift = (torch.tensor(a).to(dtype) for a in args)
    got = fused_resblock_prepared(x, prepare_weight(kernel), bias, scale, shift)
    want = fused_resblock(x, kernel, bias, scale, shift)
    if dtype == torch.bfloat16:
        assert torch.equal(got, want)
    else:
        assert (got - want).abs().max().item() <= 1e-6
    with pytest.raises(ValueError, match="prepared weight"):
        fused_resblock_prepared(x, kernel.reshape(9 * 128, 128), bias, scale, shift)


def test_resblock_rejects_mismatched_inputs():
    x = torch.zeros(1, 4, 4, 8)
    kernel = torch.zeros(3, 3, 8, 8)
    with pytest.raises(ValueError, match="dtype"):
        fused_resblock(x, kernel.bfloat16(), torch.zeros(8), torch.zeros(1, 8), torch.zeros(1, 8))
    with pytest.raises(ValueError, match="shape"):
        fused_resblock(x, kernel, torch.zeros(4), torch.zeros(1, 8), torch.zeros(1, 8))


def test_posterior_step_plain_matches_pallas_kernel_at_gate0():
    """gate=0 is the noiseless closed form; the interpreter's stubbed PRNG
    makes gate=1 incomparable, so only gate=0 is held to the Pallas kernel."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4, 16, 16, 1)).astype(np.float32)
    eps = rng.normal(size=x.shape).astype(np.float32)
    out, x0 = fused_posterior_step(
        torch.from_numpy(x), torch.from_numpy(eps), *STEP_SCALARS, 0.0, 123
    )
    want_out, want_x0 = jax_fused_posterior_step(
        jnp.asarray(x), jnp.asarray(eps), *STEP_SCALARS, 0.0, 123, interpret=True
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=1e-5)
    np.testing.assert_allclose(x0.numpy(), np.asarray(want_x0), atol=1e-5)


def test_posterior_step_plain_noise_is_seeded_normal():
    """gate=1 with mean 0: x_next is sigma * z, reproducible per seed."""
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(64, 4096)).astype(np.float32))
    zeros = torch.zeros_like(x)
    logvar = 2 * float(np.log(0.5))
    out, _ = fused_posterior_step(x, zeros, 1.0, 0.0, 0.0, 0.0, logvar, 1.0, 7)
    assert abs(out.mean().item()) < 0.01
    assert abs(out.std().item() - 0.5) <= 0.01
    again, _ = fused_posterior_step(x, zeros, 1.0, 0.0, 0.0, 0.0, logvar, 1.0, 7)
    other, _ = fused_posterior_step(x, zeros, 1.0, 0.0, 0.0, 0.0, logvar, 1.0, 8)
    assert torch.equal(out, again) and not torch.equal(out, other)


@pytest.mark.parametrize("wrapper,args", [
    (fused_resblock, lambda: (torch.empty(1, 4, 4, 128, device="meta"),
                              torch.empty(3, 3, 128, 128, device="meta"),
                              torch.empty(128, device="meta"),
                              torch.empty(1, 128, device="meta"),
                              torch.empty(1, 128, device="meta"))),
    (fused_posterior_step, lambda: (torch.empty(2, 8, device="meta"),
                                    torch.empty(2, 8, device="meta"),
                                    *STEP_SCALARS, 1.0, 0)),
], ids=["fused_resblock", "fused_posterior_step"])
def test_non_cpu_tensor_without_kernel_raises(monkeypatch, tmp_path, wrapper, args):
    """Off the CPU a wrapper launches its kernel or raises; it never takes
    the plain version. Here no kernel can be built (no nvcc)."""
    monkeypatch.setattr(_build, "find_nvcc", lambda: None)
    monkeypatch.setattr(_build, "library_path", lambda: str(tmp_path / "absent.so"))
    _build.load_library.cache_clear()
    resblock_mod._conv3x3.cache_clear()
    sample_step_mod._posterior_step.cache_clear()

    def plain(*a, **k):
        raise AssertionError("the plain version must not run for a non-CPU tensor")

    monkeypatch.setattr(resblock_mod, "fused_resblock_reference", plain)
    monkeypatch.setattr(sample_step_mod, "fused_posterior_step_reference", plain)
    try:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            wrapper(*args())
    finally:
        _build.load_library.cache_clear()
        resblock_mod._conv3x3.cache_clear()
        sample_step_mod._posterior_step.cache_clear()
