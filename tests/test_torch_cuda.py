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

from hicdiff_tpu_torch.kernels import resblock as resblock_mod
from hicdiff_tpu_torch.kernels.resblock import (
    FusedResblockFn,
    fused_resblock,
    fused_resblock_backward_reference,
    fused_resblock_reference,
    resblock_dgrad,
)
from hicdiff_tpu_torch.kernels.resblock_bwd import resblock_channel_sums, resblock_wgrad
from hicdiff_tpu_torch.kernels.sample_step import (
    fused_posterior_step,
    fused_posterior_step_reference,
)
from hicdiff_tpu_torch.models.common import dense
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


@pytest.mark.parametrize("first,rows", [(32, 32), (7, 18), (63, 1), (0, 64)])
def test_posterior_step_offset_draws_the_whole_batch_noise(cuda_device, first, rows):
    """A shard of rows [first, first + rows) at offset first * 4096 / 4
    equals the launch over the whole batch on those rows, bit for bit."""
    g = torch.Generator().manual_seed(6)
    x = torch.randn(64, 64, 64, 1, generator=g).to(cuda_device)
    eps = torch.randn(64, 64, 64, 1, generator=g).to(cuda_device)
    whole = fused_posterior_step(x, eps, *STEP_SCALARS, 1.0, 21)
    part = fused_posterior_step(x[first:first + rows].contiguous(),
                                eps[first:first + rows].contiguous(), *STEP_SCALARS, 1.0, 21,
                                offset=first * 4096 // 4)
    for got, want in zip(part, whole):
        assert torch.equal(got, want[first:first + rows])


def test_two_gloo_ranks_on_one_card_match_one_rank(cuda_device, tmp_path):
    """multihost.launch: two ranks sharing cuda:0 over gloo against one rank
    (2 blocks x 128 features): losses within 1e-5, chain and DDRM outputs
    within 1e-4, the weights' updates within lr / 10 but for one in 100,000
    (each within 4 lr), every kernel launched in both runs."""
    from hicdiff_tpu_torch.parallel import multihost

    rec = multihost.launch(2, workdir=str(tmp_path), device="cuda:0", backend="gloo",
                           blocks=2, features=128, batch=8, ragged=5,
                           tol={"loss": 1e-5, "params": None, "sample": 1e-4, "ddrm": 1e-4,
                                "update_outliers": 1e-5},
                           timeout=600)
    assert rec["ok"]
    for launches in rec["launches"].values():
        assert all(v for k, v in launches.items() if k != "fused_resblock_modes"), launches


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
        scale, shift = dense(t_act, lin.weight.to(dtype), lin.bias.to(dtype)).chunk(2, -1)
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


def test_harness_fetch_copies_behind_the_work(cuda_device):
    """The harness's deferred fetch queues the copy right behind the work
    that makes the prediction: work enqueued after it does not change what
    the fetch returns."""
    from hicdiff_tpu_torch.metrics.harness import _start_fetch

    x = torch.randn(64, 64, 64, 1, device=cuda_device)
    out = x * 2
    fetch = _start_fetch(out)
    out.fill_(0.0)  # the next batch's work, enqueued before the host waits
    np.testing.assert_array_equal(fetch(), (x * 2).cpu().numpy())


def _counts():
    return (fused_resblock.launches, resblock_dgrad.launches, resblock_wgrad.launches,
            resblock_channel_sums.launches)


@pytest.mark.parametrize("shape", [(8, 64, 64, 256), (2, 10, 13, 256), (1, 6, 80, 128),
                                   (1, 5, 70, 384), (64, 64, 64, 256), (18, 64, 64, 256)],
                         ids=["main", "ragged", "two_column_tiles_c128", "c384", "train_batch",
                              "train_ragged_batch"])
def test_backward_kernels_match_plain(cuda_device, shape):
    """The block's backward on the card (dgrad modes 4 and 5, wgrad, channel
    sums) against the plain twin on the same card, TF32 off. Each gradient
    within 1e-4 of its largest magnitude: the dgrads are 3xTF32 convs
    (~2^-22 a product), the weight gradient sums 2 B H W fp32 products per
    entry in another order than the plain GEMM. The training batches (64,
    and the ragged 18) give the channel sums more than 8 images a lane and
    each weight-gradient split more pixels than the smaller shapes."""
    rng = np.random.default_rng(1)
    b, h, w, c = shape
    bound = 1.0 / np.sqrt(9 * c)
    x = torch.tensor(rng.normal(size=shape) * 0.5, dtype=torch.float32, device=cuda_device)
    weight = torch.tensor(rng.uniform(-bound, bound, size=(c, c, 3, 3)), dtype=torch.float32,
                          device=cuda_device)
    bias = torch.tensor(rng.uniform(-bound, bound, size=(c,)), dtype=torch.float32,
                        device=cuda_device)
    te = torch.tensor(rng.normal(size=(b, 2 * c)) * 0.5, dtype=torch.float32, device=cuda_device)
    g = torch.tensor(rng.normal(size=shape), dtype=torch.float32, device=cuda_device)
    leaves = [t.clone().requires_grad_() for t in (x, weight, bias, te)]
    scale, shift = leaves[3].chunk(2, dim=-1)
    before = _counts()
    y = FusedResblockFn.apply(leaves[0], leaves[1], leaves[2], scale, shift, None)
    y.backward(g)
    torch.cuda.synchronize()
    assert [a - b_ for a, b_ in zip(_counts(), before)] == [2, 2, 1, 1]
    kernel = weight.permute(2, 3, 1, 0)
    sc, sh = te.chunk(2, dim=-1)
    assert (y - fused_resblock_reference(x, kernel, bias, sc, sh)).abs().max().item() <= 1e-4
    dx, dk, db, dscale, dshift = fused_resblock_backward_reference(g, x, kernel, bias, sc, sh)
    want = {"dx": dx, "dW": dk.permute(3, 2, 0, 1), "db": db,
            "dte": torch.cat([dscale, dshift], dim=-1)}
    got = dict(zip(want, (t.grad for t in leaves)))
    for name, ref in want.items():
        err = (got[name] - ref).abs().max().item()
        assert err <= 1e-4 * ref.abs().max().item(), (name, err, ref.abs().max().item())


@pytest.mark.parametrize("shape, dtype", [
    ((8, 64, 64, 256), torch.float32), ((64, 64, 64, 256), torch.float32),
    ((8, 64, 64, 256), torch.bfloat16), ((64, 64, 64, 256), torch.bfloat16),
    ((1, 5, 70, 384), torch.bfloat16),
], ids=["main", "train_batch", "bf16_main", "bf16_train_batch", "bf16_c384"])
def test_wgrad_is_bit_deterministic(cuda_device, shape, dtype):
    """Two calls of the weight gradient on the same inputs give the same
    bits: each split's partial is summed in one order, and the splits are
    added in a fixed order, with no atomics (bf16: whatever cluster member
    multicast a stage's A)."""
    g = torch.Generator(device=cuda_device).manual_seed(7)
    x, dz, h, gy = (torch.randn(shape, generator=g, device=cuda_device).to(dtype)
                    for _ in range(4))
    before = resblock_wgrad.launches
    first = resblock_wgrad(x, dz, h, gy)
    second = resblock_wgrad(x, dz, h, gy)
    torch.cuda.synchronize()
    assert resblock_wgrad.launches == before + 2
    assert torch.equal(first, second)


def test_training_step_keeps_every_grad_finite(cuda_device):
    """One loss.backward() through a 2-block, 128-feature model on the card:
    every parameter gets a finite, nonzero gradient, through the kernels."""
    from hicdiff_tpu_torch.diffusion.gaussian import GaussianDiffusion

    model = HicedrnDiff(self_condition=True, number_resnet=2, features=128, device=cuda_device,
                        generator=torch.Generator().manual_seed(0))
    engine = GaussianDiffusion.create(model, device=cuda_device, timesteps=1000,
                                      beta_schedule="linear")
    g = torch.Generator().manual_seed(1)
    target = (torch.randn(4, 16, 16, 1, generator=g) * 0.3).to(cuda_device)
    cond = (target.cpu() + 0.1 * torch.randn(4, 16, 16, 1, generator=g)).to(cuda_device)
    before = _counts()
    engine.p_losses(cond, target, generator=g).backward()
    torch.cuda.synchronize()
    assert [a - b_ for a, b_ in zip(_counts(), before)] == [4, 4, 2, 2]
    for name, p in model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
        assert p.grad.abs().max().item() > 0, name


def test_no_grad_forward_runs_only_modes_1_and_2(cuda_device, monkeypatch):
    """Sampling and serving run under no_grad: the conv kernel's two
    inference modes only. With gradients on, the forward runs modes 3 and 2
    and the backward modes 4 and 5."""
    modes = []
    launch = resblock_mod._launch

    def spy(*args, **kwargs):
        modes.append(args[9])
        return launch(*args, **kwargs)

    monkeypatch.setattr(resblock_mod, "_launch", spy)
    model = HicedrnDiff(self_condition=True, number_resnet=1, features=128, device=cuda_device)
    x = torch.randn(2, 16, 16, 1, device=cuda_device)
    t = torch.tensor([3, 700], device=cuda_device)
    with torch.no_grad():
        model(x, t, x)
    assert modes == [1, 2]
    modes.clear()
    with torch.inference_mode():
        model(x, t, x)
    assert modes == [1, 2]
    modes.clear()
    model(x, t, x).sum().backward()
    assert modes == [3, 2, 4, 5]


def test_kernels_launch_from_a_fresh_thread(cuda_device):
    """Autograd runs the backward on a thread of its own. On a thread where
    the caching allocator has served every allocation, no CUDA runtime call
    has bound a context yet, and the tensor-map encoder needs one: the
    launches bind it and go on."""
    import threading

    c = 128
    g = torch.Generator().manual_seed(2)
    x, gy, z = (torch.randn(2, 8, 8, c, generator=g).to(cuda_device) for _ in range(3))
    kernel = (torch.randn(3, 3, c, c, generator=g) * 0.03).to(cuda_device)
    bias = torch.zeros(c, device=cuda_device)
    scale, shift = torch.zeros(2, c, device=cuda_device), torch.zeros(2, c, device=cuda_device)
    wt = resblock_mod.prepare_weight(resblock_mod.transpose_kernel(kernel))
    want = (fused_resblock(x, kernel, bias, scale, shift), resblock_dgrad(gy, z, scale, shift, wt))
    got, errors = [], []

    def run():
        try:
            got.append((fused_resblock(x, kernel, bias, scale, shift),
                        resblock_dgrad(gy, z, scale, shift, wt)))
        except Exception as e:  # reported by the assertion below
            errors.append(e)

    thread = threading.Thread(target=run)
    thread.start()
    thread.join()
    assert not errors, errors
    torch.cuda.synchronize()
    assert torch.equal(got[0][0], want[0])
    for a, b in zip(got[0][1], want[1]):
        assert torch.equal(a, b)


# ------------------------------------------------------------- DDRM (-u 1)


def _operator_pair(name, device):
    """One degradation operator at 64x64, on `device` and on the CPU, from
    the same numpy draws."""
    from hicdiff_tpu_torch.degrade import operators as ops

    def build(dev):
        if name == "color":
            return ops.Colorization(64, device=dev)
        if name == "general":
            H = np.random.default_rng(5).normal(size=(512, 64 * 64))
            return ops.GeneralH(H, device=dev)
        return ops.make_operator(name, 1, 64, rng=np.random.default_rng(42), device=dev)

    return build(device), build("cpu")


DDRM_OPERATORS = ["deno", "inp_mask", "sr2", "sr_bicubic4", "deblur_uni", "deblur_aniso", "cs4",
                  "color", "general"]


@pytest.mark.parametrize("name", DDRM_OPERATORS)
def test_operator_on_card_matches_cpu(cuda_device, name):
    """Every map on the card within 1e-5 of the CPU's largest value (fp32,
    TF32 off), and Vt(V(x)) returns x within 1e-5 of its largest value."""
    card, cpu = _operator_pair(name, cuda_device)
    dim = 3 * 64 * 64 if name == "color" else 64 * 64
    m = cpu.H(torch.zeros(1, dim)).shape[1]
    s = cpu.singulars().shape[0]
    rng = np.random.default_rng(1)
    for fn, width in (("V", dim), ("Vt", dim), ("U", s), ("Ut", m), ("H", dim), ("Ht", m),
                      ("H_pinv", m)):
        x = torch.tensor(rng.normal(size=(4, width)), dtype=torch.float32)
        want = getattr(cpu, fn)(x)
        got = getattr(card, fn)(x.to(cuda_device)).cpu()
        assert (got - want).abs().max() <= 1e-5 * want.abs().max(), (name, fn)
    x = torch.tensor(rng.normal(size=(4, dim)), dtype=torch.float32, device=cuda_device)
    assert (card.Vt(card.V(x)) - x).abs().max() <= 1e-5 * x.abs().max()


@pytest.mark.parametrize("name", ["deblur_aniso", "general", "cs4"])
def test_ddrm_chain_on_card_keeps_fp32_under_tf32(cuda_device, name):
    """With TF32 on, as a --bf16 run leaves it, the chain still runs its
    spectral matmuls in fp32: a zero-noise chain on the card within 1e-4
    of the CPU's largest value (TF32 inputs would miss by ~1e-3), and the
    flag is back on afterwards."""
    from hicdiff_tpu_torch.sampling.ddrm import efficient_generalized_steps

    card, cpu = _operator_pair(name, cuda_device)
    rng = np.random.default_rng(2)
    x = torch.tensor(rng.normal(size=(2, 64, 64, 1)), dtype=torch.float32)
    y = cpu.H(torch.tensor(rng.uniform(-1, 1, (2, 64 * 64)), dtype=torch.float32))
    betas = np.linspace(1e-4, 2e-2, 20).astype(np.float32)

    def toy(a, t):
        return 0.1 * a + 0.05 * torch.sin(0.01 * t.float()).view(-1, 1, 1, 1)

    seq = list(range(0, 20, 2))
    want = efficient_generalized_steps(x, seq, toy, betas, cpu, y, 0.1,
                                       noise=lambda shape: torch.zeros(shape))[0]
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = efficient_generalized_steps(
            x.to(cuda_device), seq, toy, betas, card, y.to(cuda_device), 0.1,
            noise=lambda shape: torch.zeros(shape, device=cuda_device))[0]
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert (got.cpu() - want).abs().max() <= 1e-4 * want.abs().max()


# ------------------------------------------------------------- the zoo


@pytest.mark.parametrize("variant, dtype, tol", [
    ("att", torch.float32, 1e-4), ("sr3", torch.float32, 1e-4), ("sr3", torch.bfloat16, 0.05),
], ids=["att", "sr3", "sr3_bf16"])
def test_zoo_variant_kernel_path_matches_plain_path(cuda_device, variant, dtype, tol):
    """The att and sr3 variants' blocks launch the conv kernel twice each
    (the sr3 block with scale 0) and match the CPU plain path on the same
    weights; the bf16 bar is the bf16 block's over a 4-block stream."""
    kw = dict(self_condition=True, number_resnet=4, features=128, variant=variant, dtype=dtype)
    on_card = HicedrnDiff(device=cuda_device, generator=torch.Generator().manual_seed(0), **kw)
    on_cpu = HicedrnDiff(device="cpu", generator=torch.Generator().manual_seed(0), **kw)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 16, 16, 1, generator=g) * 0.3
    cond = torch.randn(2, 16, 16, 1, generator=g) * 0.3
    t = torch.tensor([0.3, 0.99]) if variant == "sr3" else torch.tensor([3, 700])
    before = fused_resblock.launches
    with torch.no_grad():
        got = on_card(x.to(cuda_device), t.to(cuda_device), cond.to(cuda_device)).cpu()
        want = on_cpu(x, t, cond)
    assert fused_resblock.launches == before + 4 * 2
    assert (got - want).abs().max().item() <= tol * max(1.0, want.abs().max().item())


def _bf16_close(got, want, tol):
    """The bf16 forward bar: max-abs within tol * max(1, want's largest)."""
    got, want = got.float(), want.float()
    return (got - want).abs().max().item() <= tol * max(1.0, want.abs().max().item())


def _sums_close(got, want, tol=1e-3):
    """Sums: within tol of want's largest magnitude; sums stored in bf16 also
    within one bf16 ulp of each value (two paths that add in other orders
    may round a sum to neighbouring bf16 numbers)."""
    ulp = 2.0**-7 if got.dtype == torch.bfloat16 else 0.0
    got, want = got.float(), want.float()
    return bool(((got - want).abs() <= tol * want.abs().max() + ulp * want.abs()).all())


@pytest.mark.parametrize("shape, stream", [
    ((8, 64, 64, 256), False), ((2, 10, 13, 256), False), ((1, 6, 80, 128), False),
    ((1, 5, 70, 384), False), ((64, 64, 64, 256), False), ((18, 64, 64, 256), False),
    ((8, 64, 64, 256), True), ((2, 10, 13, 256), True),
], ids=["main", "ragged", "two_column_tiles_c128", "c384", "train_batch", "train_ragged_batch",
        "fp32_stream_main", "fp32_stream_ragged"])
def test_bf16_backward_kernels_match_plain(cuda_device, shape, stream):
    """The bf16 block's training forward (mode 3, then 2 or, onto the att
    variant's fp32 stream, 6) and backward (dgrad modes 4 and 5 or 7, the
    bf16 weight gradient, the bf16 channel sums) on the card against the
    plain twin on the same card in the same dtype flow. y and dx: the bf16
    forward bar, 0.016 of max(1, largest); dW and db (fp32): 1e-3 of their
    largest value; dscale and dshift (bf16 sums): 1e-3 of their largest
    value and one bf16 rounding."""
    rng = np.random.default_rng(1)
    b, h, w, c = shape
    bound = 1.0 / np.sqrt(9 * c)
    x = torch.tensor(rng.normal(size=shape) * 0.5, dtype=torch.float32, device=cuda_device)
    x = x if stream else x.to(torch.bfloat16)
    weight = torch.tensor(rng.uniform(-bound, bound, size=(c, c, 3, 3)), dtype=torch.float32,
                          device=cuda_device)
    bias = torch.tensor(rng.uniform(-bound, bound, size=(c,)), dtype=torch.float32,
                        device=cuda_device)
    te = torch.tensor(rng.normal(size=(b, 2 * c)) * 0.5, dtype=torch.bfloat16,
                      device=cuda_device)
    g = torch.tensor(rng.normal(size=shape), dtype=x.dtype, device=cuda_device)
    leaves = [t.clone().requires_grad_() for t in (x, weight, bias, te)]
    scale, shift = leaves[3].chunk(2, dim=-1)
    before = _counts()
    y = FusedResblockFn.apply(leaves[0], leaves[1], leaves[2], scale, shift, None)
    y.backward(g)
    torch.cuda.synchronize()
    assert [a - b_ for a, b_ in zip(_counts(), before)] == [2, 2, 1, 1]
    kernel = weight.permute(2, 3, 1, 0).to(torch.bfloat16)
    sc, sh = te.chunk(2, dim=-1)
    want_y = fused_resblock_reference(x.to(torch.bfloat16), kernel, bias.to(torch.bfloat16), sc,
                                      sh, x if stream else None)
    assert y.dtype == x.dtype and _bf16_close(y, want_y, 0.016)
    dx, dk, db, dscale, dshift = fused_resblock_backward_reference(
        g, x, kernel, bias.to(torch.bfloat16), sc, sh)
    grads = (leaves[0].grad, leaves[1].grad, leaves[2].grad, *leaves[3].grad.chunk(2, dim=-1))
    assert [t.dtype for t in grads] == [x.dtype, torch.float32, torch.float32, torch.bfloat16,
                                        torch.bfloat16]
    assert _bf16_close(grads[0], dx, 0.016)
    for name, got, want in (("dW", grads[1], dk.permute(3, 2, 0, 1)), ("db", grads[2], db),
                            ("dscale", grads[3], dscale), ("dshift", grads[4], dshift)):
        assert _sums_close(got, want), name


@pytest.mark.parametrize("shape", [(8, 64, 64, 256), (2, 10, 13, 256), (2, 10, 13, 128),
                                   (1, 5, 70, 384), (64, 64, 64, 256)],
                         ids=["main", "ragged", "c128", "c384", "train_batch"])
def test_bf16_kernels_match_plain_on_the_same_inputs(cuda_device, shape):
    """Each bf16 kernel against its plain version on the same bf16 inputs:
    mode 3's z and h, the dgrad's dx, dz and du (and mode 7's fp32 dx) at
    the bf16 forward bar; the weight gradient within 1e-3 of its largest
    value; the channel sums within 1e-3 of theirs (dscale and dshift, bf16,
    plus one rounding). The weight gradient's shapes: C = 128 (three column
    groups, one cluster of 3 a row tile) and 384 (three row tiles, nine
    groups, clusters of 3), a ragged W, and the training batch (745
    k-blocks a split, twelve flush segments)."""
    from hicdiff_tpu_torch.kernels.resblock import (
        _conv_f32,
        _dgrad_reference,
        _fused_resblock_cuda,
        prepare_weight,
        transpose_kernel,
    )
    from hicdiff_tpu_torch.kernels.resblock_bwd import (
        resblock_channel_sums_reference,
        resblock_wgrad_reference,
    )

    g = torch.Generator(device=cuda_device).manual_seed(3)
    b, h, w, c = shape
    bf = torch.bfloat16

    def randn(*s, scale=1.0):
        return (torch.randn(*s, generator=g, device=cuda_device) * scale).to(bf)

    x, gy, z, hid = (randn(*shape, scale=0.5) for _ in range(4))
    kernel = randn(3, 3, c, c, scale=1 / np.sqrt(9 * c))
    bias, scale, shift = randn(c, scale=0.05), randn(b, c, scale=0.5), randn(b, c, scale=0.5)
    y, zk, hk = _fused_resblock_cuda(x, prepare_weight(kernel), bias, scale, shift, saving=True)
    v = _conv_f32(x.float(), kernel.float(), bias.float())
    h_want = torch.nn.functional.silu(v * (scale.float()[:, None, None] + 1)
                                      + shift.float()[:, None, None]).to(bf)
    for got, want in ((zk, v.to(bf)), (hk, h_want)):
        assert _bf16_close(got, want, 0.016)
    wt = prepare_weight(transpose_kernel(kernel))
    stream = torch.randn(shape, generator=g, device=cuda_device)
    for res in (None, stream):
        got = resblock_dgrad(gy, z, scale, shift, wt, res)
        want = _dgrad_reference(gy, z, scale, shift, transpose_kernel(kernel), res)
        for a, w_ in zip(got, want):
            assert a.dtype == w_.dtype and a.shape == shape
            assert _bf16_close(a, w_, 0.016)
    dx, dz, du = want
    wg = resblock_wgrad(x, dz, hid, gy)
    wg_want = resblock_wgrad_reference(x, dz, hid, gy)
    assert wg.dtype == torch.float32 and _sums_close(wg, wg_want)
    got = resblock_channel_sums(du, z, dz, gy)
    # the plain sums in fp32, before the rounding to the scale's dtype
    want = resblock_channel_sums_reference(*(t.float() for t in (du, z, dz, gy)))
    assert [t.dtype for t in got] == [bf, bf, torch.float32]
    for a, w_ in zip(got, want):
        assert _sums_close(a, w_)


@pytest.mark.parametrize("modes", [(3, 4), (6, 7)], ids=["modes_3_4", "modes_6_7"])
@pytest.mark.parametrize("shape", [
    (8, 64, 64, 256), (2, 10, 13, 256), (1, 6, 80, 256), (64, 64, 64, 256), (18, 64, 64, 256),
    (2, 10, 13, 128), (1, 5, 70, 384), (1, 3, 9, 512), (1, 64, 64, 256), (5, 64, 64, 256),
    (6, 64, 64, 512),
], ids=["main", "ragged", "two_column_tiles", "train_batch", "train_ragged_batch", "c128",
        "c384", "c512", "batch1_fewer_tiles_than_sms", "160_tiles", "c512_384_tiles"])
def test_bf16_modes_3_and_4_match_plain(cuda_device, shape, modes):
    """The persistent kernel's modes through the C entry against their plain
    versions on the same inputs, at the bf16 forward bar, and bit-equal over
    two calls: modes 3 (h and z) and 4 (dz and du); or, on the att variant's
    fp32 stream, mode 1 then 6 (y, fp32) against fused_resblock_reference
    with `residual`, and mode 4 then 7 (dx, fp32) against _dgrad_reference
    with `stream`. Batch 1 has 32 tiles, fewer than the card's SMs; 160 and
    384 tiles are no multiple of its 132, so blocks walk unequal numbers of
    tiles; C = 128, 384 and 512 run a half-empty or a second channel
    tile."""
    from hicdiff_tpu_torch.kernels import _build
    from hicdiff_tpu_torch.kernels.resblock import (
        _conv3x3,
        _conv_f32,
        _dgrad_reference,
        prepare_weight,
        transpose_kernel,
    )

    lib, fn = _conv3x3(torch.bfloat16)
    stream = torch.cuda.current_stream().cuda_stream

    def launch(mode, src, wgt, bias, res, out, aux=None):
        _build.check_status(lib, fn(
            src.data_ptr(), wgt.data_ptr(), bias.data_ptr(), scale.data_ptr(),
            shift.data_ptr(), scale.stride(0), None if res is None else res.data_ptr(),
            out.data_ptr(), None if aux is None else aux.data_ptr(), *shape, mode, stream),
            "conv3x3")

    g = torch.Generator(device=cuda_device).manual_seed(5)
    b, h, w, c = shape
    bf = torch.bfloat16
    x, gy, z = ((torch.randn(shape, generator=g, device=cuda_device) * 0.5).to(bf)
                for _ in range(3))
    kernel = (torch.randn(3, 3, c, c, generator=g, device=cuda_device) / np.sqrt(9 * c)).to(bf)
    bias = (torch.randn(c, generator=g, device=cuda_device) * 0.05).to(bf)
    scale, shift = (torch.randn(b, 2 * c, generator=g, device=cuda_device) * 0.5).to(bf).chunk(
        2, dim=-1)
    kernel_t = transpose_kernel(kernel)
    wp, wt = prepare_weight(kernel), prepare_weight(kernel_t)
    runs = []
    if modes == (3, 4):
        for _ in range(2):
            h3, z3, dz4, du4 = (torch.empty(shape, device=cuda_device, dtype=bf)
                                for _ in range(4))
            launch(3, x, wp, bias, None, h3, z3)
            launch(4, gy, wt, scale, z, dz4, du4)  # no bias: scale stands in for the pointer
            runs.append((h3, z3, dz4, du4))
        v = _conv_f32(x.float(), kernel.float(), bias.float())
        h_want = F.silu(v * (scale.float()[:, None, None] + 1) + shift.float()[:, None, None])
        _, dz_want, du_want = _dgrad_reference(gy, z, scale, shift, kernel_t)
        names, wants = ("h", "z", "dz", "du"), (h_want.to(bf), v.to(bf), dz_want, du_want)
    else:
        xs, gs = (torch.randn(shape, generator=g, device=cuda_device) * 0.5 for _ in range(2))
        xb, gb = xs.to(bf), gs.to(bf)
        for _ in range(2):
            h1, dz4, du4 = (torch.empty(shape, device=cuda_device, dtype=bf) for _ in range(3))
            y6, dx7 = (torch.empty(shape, device=cuda_device) for _ in range(2))
            launch(1, xb, wp, bias, None, h1)
            launch(6, h1, wp, bias, xs, y6)
            launch(4, gb, wt, scale, z, dz4, du4)
            launch(7, dz4, wt, scale, gs, dx7)
            runs.append((y6, dx7, dz4, du4))
        y_want = fused_resblock_reference(xb, kernel, bias, scale, shift, residual=xs)
        dx_want, dz_want, du_want = _dgrad_reference(gb, z, scale, shift, kernel_t, stream=gs)
        names, wants = ("y", "dx", "dz", "du"), (y_want, dx_want, dz_want, du_want)
        assert y_want.dtype == dx_want.dtype == torch.float32
    torch.cuda.synchronize()
    for name, got, want in zip(names, runs[0], wants):
        assert got.dtype == want.dtype and _bf16_close(got, want, 0.016), name
    for first, second in zip(*runs):
        assert torch.equal(first, second)


def test_bf16_att_runs_on_the_card(cuda_device, monkeypatch):
    """bf16 hicedrn_att builds for the card and its forward matches the CPU
    plain path on the same weights within the bf16 sr3 bar (2e-2 of the
    largest value): the blocks after an attention run modes 1 and 6 on the
    fp32 stream, the others 1 and 2; training launches 3, 2 or 6, and 4, 5
    or 7."""
    modes = []
    launch = resblock_mod._launch

    def spy(*args, **kwargs):
        modes.append(args[9])
        return launch(*args, **kwargs)

    kw = dict(self_condition=True, number_resnet=4, features=128, variant="att",
              dtype=torch.bfloat16)
    on_card = HicedrnDiff(device=cuda_device, generator=torch.Generator().manual_seed(0), **kw)
    on_cpu = HicedrnDiff(device="cpu", generator=torch.Generator().manual_seed(0), **kw)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 16, 16, 1, generator=g) * 0.3
    cond = torch.randn(2, 16, 16, 1, generator=g) * 0.3
    t = torch.tensor([3, 700])
    args = [a.to(cuda_device) for a in (x, t, cond)]
    monkeypatch.setattr(resblock_mod, "_launch", spy)
    with torch.no_grad():
        got = on_card(*args).cpu()
        want = on_cpu(x, t, cond)
    assert modes == [1, 2, 1, 2, 1, 6, 1, 6]
    assert (got - want).abs().max().item() <= 2e-2 * max(1.0, want.abs().max().item())
    modes.clear()
    on_card(*args).square().mean().backward()
    assert modes == [3, 2, 3, 2, 3, 6, 3, 6, 4, 7, 4, 7, 4, 5, 4, 5]
    for name, p in on_card.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name


def test_bf16_training_step_runs_the_kernels(cuda_device):
    """One loss.backward() through a 2-block bf16 model on the card: every
    block's forward and backward through the bf16 kernels, every parameter
    gradient fp32, finite and nonzero."""
    from hicdiff_tpu_torch.diffusion.gaussian import GaussianDiffusion

    model = HicedrnDiff(self_condition=True, number_resnet=2, features=128, device=cuda_device,
                        dtype=torch.bfloat16, generator=torch.Generator().manual_seed(0))
    engine = GaussianDiffusion.create(model, device=cuda_device, timesteps=1000,
                                      beta_schedule="linear")
    g = torch.Generator().manual_seed(1)
    target = (torch.randn(4, 16, 16, 1, generator=g) * 0.3).to(cuda_device)
    cond = (target.cpu() + 0.1 * torch.randn(4, 16, 16, 1, generator=g)).to(cuda_device)
    before = _counts()
    engine.p_losses(cond, target, generator=g).backward()
    torch.cuda.synchronize()
    assert [a - b_ for a, b_ in zip(_counts(), before)] == [4, 4, 2, 2]
    for name, p in model.named_parameters():
        assert p.grad is not None and p.grad.dtype == torch.float32, name
        assert torch.isfinite(p.grad).all() and p.grad.abs().max().item() > 0, name


def test_sr3_training_step_runs_the_kernels(cuda_device):
    """An sr3 block's forward and backward on the card (FusedResblockFn with
    a zero scale) against the CPU plain twin: output and every gradient
    within 1e-4 of its largest value."""
    from hicdiff_tpu_torch.models.hicedrn import SR3ResBlock

    torch.manual_seed(0)
    cpu = SR3ResBlock(128)
    card = SR3ResBlock(128, device=cuda_device)
    card.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(2)
    x = torch.randn(2, 12, 12, 128, generator=g)
    temb = torch.randn(2, 512, generator=g)
    dgrad_before = resblock_dgrad.launches
    outs = []
    for block, dev in ((card, cuda_device), (cpu, "cpu")):
        xi = x.to(dev).requires_grad_()
        y = block(xi, temb.to(dev))
        (y * torch.linspace(-1, 1, y.numel(), device=dev).view_as(y)).sum().backward()
        outs.append([y.detach().cpu(), xi.grad.cpu()]
                    + [p.grad.cpu() for p in block.parameters()])
    assert resblock_dgrad.launches == dgrad_before + 2
    for got, want in zip(*outs):
        assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()


@pytest.mark.parametrize("dtype, tol", [(None, 1e-4), (torch.bfloat16, 0.05)],
                         ids=["fp32", "bf16"])
def test_unet_on_card_matches_cpu(cuda_device, dtype, tol):
    """The U-Net is plain PyTorch on both sides: card vs CPU, fp32 and the
    bf16 dtype flow (bf16 convs, fp32 norms); the bf16 bar is a few bf16
    ulps of the output's largest value."""
    from hicdiff_tpu_torch.models.unet import Unet

    kw = dict(dim=16, dim_mults=(1, 2), self_condition=True, noise_level_emb=True, dtype=dtype)
    on_card = Unet(device=cuda_device, generator=torch.Generator().manual_seed(0), **kw)
    on_cpu = Unet(device="cpu", generator=torch.Generator().manual_seed(0), **kw)
    g = torch.Generator().manual_seed(1)
    x, cond = (torch.randn(2, 32, 32, 1, generator=g) for _ in range(2))
    level = torch.tensor([0.2, 0.9])
    with torch.no_grad():
        got = on_card(x.to(cuda_device), level.to(cuda_device), cond.to(cuda_device)).cpu()
        want = on_cpu(x, level, cond)
    assert got.dtype == torch.float32
    assert (got - want).abs().max().item() <= tol * max(1.0, want.abs().max().item())


@pytest.mark.parametrize("name", ["hiedsr", "hicarn", "deephic", "hicsr", "unet", "hicplus",
                                  "DeepHiCDiscriminator", "HiCSRDiscriminator",
                                  "HiedsrDiscriminator", "DAE", "VGGFeatures"])
def test_baseline_on_card_matches_cpu(cuda_device, name):
    """Each baseline at its registry size is plain PyTorch on both sides:
    the card's eval forward against the CPU's on the same weights, batch 2,
    within 1e-3 of the CPU's largest value (TF32 off)."""
    from hicdiff_tpu_torch.metrics.losses import VGGFeatures
    from hicdiff_tpu_torch.models import baselines
    from hicdiff_tpu_torch.models.zoo import BASELINES

    ctor, needs_pad = ((BASELINES[name][0], BASELINES[name][1]) if name in BASELINES
                       else (VGGFeatures if name == "VGGFeatures" else getattr(baselines, name),
                             False))
    models = [ctor(device=d, generator=torch.Generator().manual_seed(0))
              for d in (cuda_device, "cpu")]
    size = 76 if needs_pad else 64
    x = torch.rand(2, size, size, 1, generator=torch.Generator().manual_seed(1)) * 2 - 1
    with torch.no_grad():
        got, want = models[0](x.to(cuda_device)).cpu(), models[1](x)
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 1e-3 * want.abs().max().item()


@pytest.mark.parametrize("name", ["deephic", "hicplus"])
def test_baseline_step_on_card_matches_cpu(cuda_device, name):
    """One pretrain_baselines_torch.l2_step on the card and on the CPU from
    the same weights and wrap-padded batch: the loss within 1e-4 relative,
    the BatchNorm running statistics within 1e-5 of their largest value."""
    import pretrain_baselines_torch as pt
    from hicdiff_tpu_torch.models.zoo import BASELINES

    g = torch.Generator().manual_seed(3)
    x = (torch.rand(3, 64, 64, 1, generator=g) * 2 - 1).numpy()
    (x, y), w = pt.wrap_pad((x, np.clip(x * 0.9, -1, 1)), 4)
    prep, prep_target = pt.prep_fns(name)
    out = []
    for dev in (cuda_device, "cpu"):
        model = BASELINES[name][0](device=dev, generator=torch.Generator().manual_seed(0))
        xs, ys, ws = (torch.from_numpy(a).to(dev) for a in (x, y, w))
        loss = pt.l2_step(model, pt.adam(model.parameters(), 1e-4), prep(xs), prep_target(ys),
                          ws, pt.HAS_BN[name])
        out.append((loss.item(), {k: v.cpu() for k, v in model.state_dict().items()}))
    (loss_card, sd_card), (loss_cpu, sd_cpu) = out
    assert abs(loss_card - loss_cpu) <= 1e-4 * abs(loss_cpu)
    for k in sd_cpu:
        if k.endswith(("running_mean", "running_var")):
            bar = 1e-5 * sd_cpu[k].abs().max().item()
            assert (sd_card[k] - sd_cpu[k]).abs().max().item() <= bar, k


def _banded_blocks(n, count, seed):
    """Rescaled blocks like threed_comp's: Poisson counts decaying off the
    diagonal, normalized to [0, 1], x3 below 0.3; and one empty block."""
    rng = np.random.default_rng(seed)
    i, j = np.indices((n, n))
    mats = []
    for _ in range(count):
        m = rng.poisson(np.maximum(40 - 0.6 * np.abs(i - j), 1.0)).astype(float)
        m = np.triu(m) + np.triu(m, 1).T
        m = np.clip(m / np.percentile(m, 99), 0, 1)
        mats.append(np.where(m < 0.3, m * 3.0, m))
    return mats + [np.zeros((n, n))]


def test_batched_fit_on_card_matches_cpu(cuda_device):
    """The stress fit of a batch of blocks on the card against the CPU's from
    the same start (drawn on the CPU): after 100 iterations the coordinates
    agree within 1e-3 (unit scale; chip_smoke.py's FIT_SHORT_TOL), so the
    Gram products ran in fp32 even with TF32 switched on around the call
    (and the flag is restored); at the published 2000 iterations, where the
    fit amplifies rounding along its flat directions, each structure's
    stress within 2e-3 relative. The empty block gives zeros on both."""
    from hicdiff_tpu_torch.analysis import reconstruct as rec

    mats = _banded_blocks(48, 6, 0)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        card, _ = rec.reconstruct_batch(mats, max_iter=100, device=cuda_device)
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    cpu, _ = rec.reconstruct_batch(mats, max_iter=100, device="cpu")
    for a, b in zip(card, cpu):
        assert a.shape == b.shape == (3, 48, 3)
        np.testing.assert_allclose(a, b, atol=1e-3, rtol=0)
    assert not card[-1].any()
    card, card_l = rec.reconstruct_batch(mats, device=cuda_device)
    cpu, cpu_l = rec.reconstruct_batch(mats, device="cpu")
    for a, b in zip(card_l[:-1], cpu_l[:-1]):
        assert np.all(np.abs(a - b) <= 2e-3 * b), (a, b)
    assert not card[-1].any() and not card_l[-1].any()
