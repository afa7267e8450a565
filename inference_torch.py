#!/usr/bin/env python
"""HiCDiff inference CLI on PyTorch/CUDA — the `-u 0` and `-u 1` paths of
inference.py.

The flags and defaults of inference.py, plus --device (default cuda; there
is no fallback to the CPU when the device is absent):

    python inference_torch.py -u 0 -s 0.1 --t-start auto --root <dir> \
        [--weights <ckpt>] [--bf16] [--export-dense] [--device cpu]
    python inference_torch.py -u 1 -s 0.1 --schedule linear --t-start auto \
        --deg deno --root <dir> [--sampling-steps K] [--device cpu]

`-u 0` runs the conditional model's reverse `super_resolution` chain over
the test split of the cell. `-u 1` (the default, as in inference.py) runs
the unconditional model inside the DDRM restoration sampler on the
measurements of `--deg`'s operator, with the linear 1000-step betas. Both
write the Outputs_diff/{target,noisy,predict,inds}.npy quartet into the
directory inference.py names, and report the SSIM/PSNR/MSE/SNR/PCC/SPC/
GenomeDISCO suite. Checkpoints are the JAX package's msgpack files, read
without the `msgpack` package; .mcool files are read and written by the
port's own HDF5 module (`hicdiff_tpu_torch/data/hdf5.py`), without h5py.

`--model` picks the backbone from the registry (`models/zoo.py`), as
inference.py does: `hicedrn` (the default; `--blocks`/`--features` apply to
it alone) first looks for train.py's checkpoint tag, every backbone then
for pretrain.py's `{model}_{mode}_{pretrain_data}_l2_{sch}`. The `*_sr3`
backbones run the sr3 engine on `-u 0` and exit on `-u 1`, as inference.py
does; DDRM drives any other backbone raw. With --bf16 every backbone
computes in bf16 (`hicedrn_att` on its fp32 residual stream, as the JAX
package's).
`--scan-chunk` and `--fused-resblock` are accepted and have no effect: the
port runs each chain in one pass (CUDA has no per-execution time limit to
segment around), and every residual block always goes through the fused
kernel.

Over several GPUs, as inference.py shards each test batch over its chips,
launch it with torchrun: one process a rank, each on cuda:LOCAL_RANK over
NCCL, or every rank on the card `--device` names over gloo:

    torchrun --nproc-per-node 2 inference_torch.py -u 0 -s 0.1 --t-start auto ...
    torchrun --nproc-per-node 2 inference_torch.py ... --device cuda:0 --dist-backend gloo

Each rank samples its rows of every batch (`parallel.mesh.run_sharded`),
drawing what the one-process run draws for the whole batch, and the
batch's output is gathered; the main rank prepares the cache, computes the
metrics and writes the quartet and the exports. Launched plainly, the CLI
runs on one device and makes no collective call.
"""
import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from hicdiff_tpu_torch.convert import params_from_jax  # noqa: E402
from hicdiff_tpu_torch.diffusion.gaussian import GaussianDiffusion, to_device  # noqa: E402
from hicdiff_tpu_torch.metrics.harness import evaluate_model  # noqa: E402
from hicdiff_tpu_torch.models.hicedrn import HicedrnDiff  # noqa: E402
from hicdiff_tpu_torch.models.zoo import DIFFUSION_BACKBONES  # noqa: E402
from hicdiff_tpu_torch.parallel.mesh import (  # noqa: E402
    Mesh,
    barrier,
    is_main,
    mesh_from_launcher,
    run_sharded,
)
from hicdiff_tpu_torch.sampling.ddrm import DDRMRestorer, generator_noise  # noqa: E402
from hicdiff_tpu_torch.train.checkpoint import (  # noqa: E402
    checkpoint_name,
    load_checkpoint,
    warn_run_config_mismatch,
)

def create_parser(argv=None):
    parser = argparse.ArgumentParser(
        description="HiCDiff works for single-cell HI-C data denoising !!! (PyTorch/CUDA)"
    )
    parser.add_argument("-u", "--unspervised", type=int, default=1, choices=[0, 1],
                        help="0 = conditional sampler; 1 = unconditional model + DDRM")
    parser.add_argument("-b", "--batch_size", type=int, default=64)
    parser.add_argument("-e", "--epoch", type=int, default=400)
    parser.add_argument("-l", "--celline", type=str, default="Human", choices=["Human", "Dros"])
    parser.add_argument("-n", "--celln", type=int, default=1)
    parser.add_argument("-s", "--sigma", type=float, default=1.0)
    parser.add_argument("--root", type=str, default=None)
    parser.add_argument("--schedule", type=str, default="sigmoid")
    parser.add_argument("--timestep", type=int, default=None, help="diffusion T; default 1000")
    parser.add_argument("--sampling-steps", type=int, default=None,
                        help="DDIM fast path: use K < T sampling steps")
    parser.add_argument("--t-start", type=str, default=None,
                        help="truncated sampling: start the reverse chain at this "
                             "timestep, or 'auto' for the exact-marginal timestep "
                             "of sigma (alphas_cumprod[t] = 1/(1+sigma^2)). On -u 0 "
                             "the chain starts from the scaled noisy input; on -u 1 "
                             "the DDRM spectral init places the measurement at its "
                             "true noise level (t*=27 of 1000 at sigma=0.1, linear)")
    parser.add_argument("--ddim-eta", type=float, default=0.0,
                        help="DDIM stochasticity (0 = deterministic)")
    parser.add_argument("--bf16", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--weights", type=str, default=None,
                        help="explicit checkpoint path (overrides convention)")
    parser.add_argument("--blocks", type=int, default=32)
    parser.add_argument("--features", type=int, default=256)
    parser.add_argument("--deg", type=str, default="deno", help="degradation operator")
    parser.add_argument("--use-ema", action="store_true",
                        help="load the EMA weights from the checkpoint if present")
    parser.add_argument("--model", dest="model_name", default="hicedrn",
                        choices=sorted(DIFFUSION_BACKBONES),
                        help="diffusion backbone; the non-default ones load pretrain.py "
                             "checkpoints (tag {model}_{engine}_{data}_l2_{sch}); *_sr3 "
                             "backbones run the sr3 engine on -u 0")
    parser.add_argument("--pretrain-data", default="linear",
                        choices=["linear", "linear_sing", "pure_noise"],
                        help="data tag of the pretrain.py checkpoint to look for")
    parser.add_argument("--scan-chunk", type=int, default=250,
                        help="accepted for inference.py compatibility; no effect: "
                             "the port runs each chain in one pass")
    parser.add_argument("--fused-resblock", action="store_true",
                        help="accepted for inference.py compatibility; no effect: "
                             "every block always runs through the fused kernel")
    parser.add_argument("--chro", type=str, default="test",
                        help="'test' (reference split), 'all' (full cell), or a "
                             "chromosome number")
    parser.add_argument("--export-dense", action="store_true",
                        help="reassemble the denoised patches into per-chromosome "
                             "dense matrices (dense_chr_{i}.npy)")
    parser.add_argument("--export-mcool", type=str, default=None,
                        help="also write the denoised matrices as an .mcool at this "
                             "path")
    parser.add_argument("--out-tag", type=str, default="",
                        help="suffix of the Outputs_diff result directory name")
    parser.add_argument("--no-metrics", action="store_true",
                        help="skip the metric suite; only denoise and save/export")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default cuda; under torchrun, cuda is "
                             "each rank's cuda:LOCAL_RANK)")
    parser.add_argument("--dist-backend", default=None, choices=("nccl", "gloo"),
                        help="under torchrun: the process group's backend (default nccl on "
                             "GPUs, gloo on the CPU; gloo for ranks sharing one card)")
    return parser.parse_args(argv)


def _resolve_weights(root, tags, cell_line, cell_no):
    """The first existing checkpoint over (tag x cell) candidates: the
    reference's convention names Human1 for every run, train.py the run's own
    cell. Raises with the candidate list when none exists."""
    cells = [("Human", 1)]
    if (cell_line, cell_no) not in cells:
        cells.append((cell_line, cell_no))
    paths = [os.path.join(root, "Model_Weights", checkpoint_name("bestg", 40000, 64, cl, cn, tag))
             for tag in tags for (cl, cn) in cells]
    for p in paths:
        if os.path.exists(p):
            return p
    raise FileNotFoundError(
        "no checkpoint found; candidates tried:\n  " + "\n  ".join(paths)
        + "\ntrain one with train.py / pretrain.py or pass --weights"
    )


def _batch_seed(seed: int, batch: int) -> int:
    """The seed of one batch's noise generator, from (--seed, batch index)."""
    return int(np.random.SeedSequence((seed, batch)).generate_state(1, np.uint64)[0])


def _load_params(path, use_ema, expect, cellNo):
    """(params, the training percentile or None) of a checkpoint, warning
    where its run_config differs from `expect`. Inference never reads the
    Adam moments, so they are skipped while decoding."""
    ck = load_checkpoint(path, only={"params", "run_config"} | ({"ema_params"} if use_ema else set()))
    warn_run_config_mismatch(ck, expect, path)
    ck_pct = (ck.get("run_config") or {}).get("percentile")
    if ck_pct is not None:
        print(f"eval prep adopts the checkpoint's training percentile ({ck_pct}) — the "
              f"reference would evaluate cell {cellNo} at the population module's 99.0 "
              "(metrics_cond.py:67-77 train/eval mismatch)")
    params = ck.get("ema_params") if use_ema and ck.get("ema_params") else ck["params"]
    return params, ck_pct


def _to_device(batch: np.ndarray, device: torch.device) -> torch.Tensor:
    """A numpy batch on `device`; a pinned copy, so it does not wait for the
    device's queued work."""
    return to_device(torch.from_numpy(np.ascontiguousarray(batch, dtype=np.float32)), device)


def Inference(batch_size=64, cellNo=1, cell_Line="Human", sigma_t=0.1, condition=None,
              root=None, schedule="sigmoid", timestep=None, bf16=False, seed=0,
              weights=None, sampling_steps=None, chro="test", deg="deno", use_ema=False,
              blocks=32, features=256, ddim_eta=0.0, t_start=None, model_name="hicedrn",
              pretrain_data="linear", export_dense=False, export_mcool=None,
              compute_metrics=True, out_tag="", device="cuda", mesh: Mesh = None):
    """inference.py's Inference on `device`: condition False runs the
    conditional sampler (-u 0), True the unconditional model in DDRM (-u 1).
    Returns the harness's result dict ({'predict', 'inds', 'metrics',
    'outdir', 'data_dir', 'res', 'timing'}); inference.py returns its
    'predict'. With a mesh, each batch is sampled by rows over its ranks on
    the mesh's device (every rank calls this); only the main rank writes
    files, the others' 'metrics' is None."""
    if condition and model_name.endswith("sr3"):
        sys.exit("DDRM (-u 1) drives an integer-timestep eps-model; the "
                 "sr3 (continuous-level) backbones are a -u 0 path")
    root = root or os.path.dirname(os.path.abspath(__file__))
    device = mesh.device if mesh is not None else torch.device(device)
    timestep = timestep or 1000
    if isinstance(chro, str) and chro.isdigit():
        chro = int(chro)
    dtype = torch.bfloat16 if bf16 else None
    if model_name == "hicedrn":
        model = HicedrnDiff(self_condition=not condition, dtype=dtype, number_resnet=blocks,
                            features=features, device=device)
    else:
        model = DIFFUSION_BACKBONES[model_name](not condition, dtype, device=device)
    batches = [0]
    if not condition:
        mode = "sr3" if model_name.endswith("sr3") else "cond"
        engine = GaussianDiffusion.create(model, device=device, timesteps=timestep,
                                          beta_schedule=schedule,
                                          sampling_timesteps=sampling_steps,
                                          ddim_sampling_eta=ddim_eta, mode=mode)
        if t_start is not None and str(t_start) not in ("full", "none"):
            ts = (engine.truncation_timestep(max(sigma_t, 1e-4))
                  if str(t_start) == "auto" else int(t_start))
            engine = dataclasses.replace(engine, t_start=ts)
            print(f"truncated sampling: t_start={ts} ({ts + 1} of {timestep} reverse steps)")
        elif sampling_steps and sampling_steps >= 170:
            print("note: conditional DDIM from pure noise measured unstable "
                  f"at K={sampling_steps} (degenerate for K>=170, "
                  "VALIDATION.md); prefer --t-start auto or K<=100")

        # train.py's convention first (hicedrn only), then pretrain.py's tag
        tags = [f"HiCedrn_cond_l2_{schedule[:3]}"] if model_name == "hicedrn" else []
        tags.append(f"{model_name}_{mode}_{pretrain_data}_l2_{schedule[:3]}")
        path = weights or _resolve_weights(root, tags, cell_Line, cellNo)
        params, ck_pct = _load_params(path, use_ema, dict(
            sigma=sigma_t, schedule=schedule, mode=mode, timestep=timestep), cellNo)
        model.load_state_dict(params_from_jax(params))
        model.eval()

        def model_fn(lr_batch):
            # enqueue only: the harness fetches the result after the next
            # batch is enqueued
            generator = torch.Generator().manual_seed(_batch_seed(seed, batches[0]))
            batches[0] += 1
            if mesh is not None:  # each rank its rows, drawing the whole batch's noise
                return run_sharded(mesh, lambda x, rows: engine.super_resolution(
                    x, generator, rows=rows), lr_batch)
            return engine.super_resolution(_to_device(lr_batch, device), generator)

        result = evaluate_model(
            model_fn, model_name=f"{model_name}_l2_{schedule[:3]}", chro=chro, deg=deg,
            sigma=sigma_t, cellN=cellNo, cell_line=cell_Line, root=root,
            batch_size=batch_size, result_tag=f"_{chro}_cond{out_tag}",
            compute_metrics=compute_metrics, percentile=ck_pct, mesh=mesh,
        )
    else:
        # The reference's published uncond weights carry a `_trans` suffix
        # (inference.py:103); train.py -u 1 writes the plain tag. Both are
        # tried, so a train -> infer round trip needs no --weights flag
        # (PARITY.md #27); then pretrain.py's tag, the only one of the
        # other backbones.
        tags = ([f"HiCedrn_l2_{schedule[:3]}_trans", f"HiCedrn_l2_{schedule[:3]}"]
                if model_name == "hicedrn" else [])
        tags.append(f"{model_name}_uncond_{pretrain_data}_l2_{schedule[:3]}")
        path = weights or _resolve_weights(root, tags, cell_Line, cellNo)
        params, ck_pct = _load_params(path, use_ema, dict(
            sigma=sigma_t, schedule=schedule, mode="uncond", timestep=timestep), cellNo)
        model.load_state_dict(params_from_jax(params))
        model.eval()
        # DDRM drives the raw backbone (inference.py:108-109)
        restore = DDRMRestorer(lambda x, t: model(x, t, None), deg, sigma_t, device=device,
                               t_start=t_start, sampling_steps=sampling_steps or timestep)
        ddrm_t_start = restore.t_start
        if str(t_start) == "auto" and ddrm_t_start is None:
            print(f"truncated DDRM: operator '{deg}' has a null space "
                  "(unobserved spectral directions) — truncation would "
                  "skip the steps that synthesize their content; "
                  "running the full chain")
        elif ddrm_t_start is not None:
            print(f"truncated DDRM: t_start={ddrm_t_start} "
                  f"({restore.forwards} of {timestep} restoration steps)")

        def model_fn(samp_batch):
            generator = torch.Generator(device=device).manual_seed(
                _batch_seed(seed, 1000 + batches[0]))
            batches[0] += 1
            if mesh is not None:  # each rank its rows of the whole batch's draws
                return run_sharded(mesh, lambda y, rows: restore(
                    y, None, noise=generator_noise(generator, device, rows)), samp_batch)
            return restore(_to_device(samp_batch, device), generator)

        result = evaluate_model(
            model_fn, model_name=f"{model_name}_l2_{schedule[:3]}", chro=chro, deg=deg,
            sigma=sigma_t, cellN=cellNo, cell_line=cell_Line, root=root,
            batch_size=batch_size,
            result_tag=(f"_trans2_{timestep}"
                        + (f"_ts{ddrm_t_start}" if ddrm_t_start is not None else "")
                        + out_tag),
            input_kind="sample", compute_metrics=compute_metrics,
            percentile=ck_pct, mesh=mesh,
        )

    if not is_main(mesh):
        return result
    if export_dense or export_mcool:
        from hicdiff_tpu_torch.data.assemble import assemble_by_chromosome, to_unit, write_mcool

        res_bp = result["res"]
        n_bins = {}
        for c in sorted({int(c) for c in np.asarray(result["inds"])}):
            full = os.path.join(result["data_dir"], "Full_Mats",
                                f"GSE131811_mat_full_chr_{c}_{res_bp}.npy")
            n_bins[c] = np.load(full, mmap_mode="r").shape[0]
        dense = assemble_by_chromosome(result["predict"], result["inds"], n_bins, resol=res_bp)
        for c, m in dense.items():
            np.save(os.path.join(result["outdir"], f"dense_chr_{c}"), m)
        print(f"dense export: {len(dense)} chromosome(s) -> {result['outdir']}/dense_chr_*.npy")
        if export_mcool:
            write_mcool(export_mcool, res_bp, {c: to_unit(m) for c, m in dense.items()})
            print(f"mcool export: {export_mcool}")

    print("metrics:", result["metrics"])
    print("outputs:", result["outdir"])
    return result


def main(argv=None):
    args = create_parser(argv)
    if not args.bf16:  # the convs and Dense layers around the fused blocks in fp32, not TF32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    if args.unspervised:  # DDRM's spectral transforms are fp32 whatever the backbone's dtype
        torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.time()
    mesh = mesh_from_launcher(args.device, args.dist_backend)
    try:
        _run(args, mesh)
        barrier(mesh)  # no rank tears the group down while rank 0 still writes
    finally:
        if mesh is not None:
            mesh.close()
    if is_main(mesh):
        print(f"inference is done in {time.time() - t0:.1f}s, results saved !!!")


def _run(args, mesh):
    from hicdiff_tpu_torch.kernels.resblock import fused_resblock
    from hicdiff_tpu_torch.kernels.sample_step import fused_posterior_step

    Inference(
        batch_size=args.batch_size, cellNo=args.celln, cell_Line=args.celline,
        sigma_t=args.sigma, condition=bool(args.unspervised), root=args.root,
        schedule=args.schedule, timestep=args.timestep, bf16=args.bf16, seed=args.seed,
        weights=args.weights, sampling_steps=args.sampling_steps, chro=args.chro,
        deg=args.deg, use_ema=args.use_ema, blocks=args.blocks, features=args.features,
        ddim_eta=args.ddim_eta, t_start=args.t_start, model_name=args.model_name,
        pretrain_data=args.pretrain_data, export_dense=args.export_dense,
        export_mcool=args.export_mcool, compute_metrics=not args.no_metrics,
        out_tag=args.out_tag, device=args.device, mesh=mesh,
    )
    rank, world = (0, 1) if mesh is None else (mesh.rank, mesh.world_size)
    print(f"kernel launches, rank {rank} of {world}: " + json.dumps(
        {"fused_resblock": fused_resblock.launches,
         "fused_posterior_step": fused_posterior_step.launches}), flush=True)


if __name__ == "__main__":
    main()
