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

from hicdiff_tpu.kernels.resblock import fused_resblock as jax_fused_resblock
from hicdiff_tpu.kernels.sample_step import fused_posterior_step as jax_fused_posterior_step
from hicdiff_tpu.models.hicedrn import HicedrnResBlock
from hicdiff_tpu_torch.kernels import _build
from hicdiff_tpu_torch.kernels import resblock as resblock_mod
from hicdiff_tpu_torch.kernels import sample_step as sample_step_mod
from hicdiff_tpu_torch.kernels.resblock import fused_resblock
from hicdiff_tpu_torch.kernels.sample_step import fused_posterior_step

STEP_SCALARS = (1.1, 0.5, 0.7, 0.3, -2.0)  # a, b, c1, c2, logvar


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
