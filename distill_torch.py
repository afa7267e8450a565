#!/usr/bin/env python
"""Progressive distillation CLI on PyTorch/CUDA: compress the truncated
conditional sampler (the port of distill.py).

The flags of distill.py, plus --device (default cuda; there is no fallback
to the CPU when the device is absent), --blocks/--features (as
train_torch.py's) and, under torchrun, --dist-backend. Starting from a
trained conditional checkpoint (train_torch.py -u 0), it halves the
truncated DDIM chain (t*+1 steps at sigma's exact-marginal t*) stage by
stage through hicdiff_tpu_torch/train/distill.py. Each stage writes
Model_Weights/bestg_..._{tag}_dist{K}.msgpack in the JAX package's layout
(run_config `distilled_steps` = K); evaluate any stage through the standard
inference path, whose DDIM grid is the student's training grid:

    python inference_torch.py -u 0 --t-start auto --sampling-steps K \
        --weights Model_Weights/bestg_..._dist{K}.msgpack

Launched by torchrun (`torchrun --nproc-per-node N distill_torch.py ...`)
it distills data-parallel: a rank on cuda:LOCAL_RANK over NCCL, or
`--device cuda:0 --dist-backend gloo` for ranks that share one card; rank 0
prepares the caches and writes the checkpoints and the log.
"""
import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from hicdiff_tpu_torch.convert import params_from_jax, params_to_jax  # noqa: E402
from hicdiff_tpu_torch.data.datamodule import GSE130711Module, GSE131811Module  # noqa: E402
from hicdiff_tpu_torch.diffusion.gaussian import GaussianDiffusion  # noqa: E402
from hicdiff_tpu_torch.models.hicedrn import HicedrnDiff  # noqa: E402
from hicdiff_tpu_torch.parallel.mesh import barrier, is_main, mesh_from_launcher  # noqa: E402
from hicdiff_tpu_torch.train.checkpoint import (  # noqa: E402
    checkpoint_name,
    load_checkpoint,
    save_checkpoint,
    warn_run_config_mismatch,
)
from hicdiff_tpu_torch.train.distill import ProgressiveDistiller, halving_stages  # noqa: E402
from hicdiff_tpu_torch.train.logging import MetricLogger  # noqa: E402


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-b", "--batch_size", type=int, default=16)
    ap.add_argument("-l", "--celline", type=str, default="Human", choices=["Human", "Dros"])
    ap.add_argument("-n", "--celln", type=int, default=1)
    ap.add_argument("-s", "--sigma", type=float, default=0.1)
    ap.add_argument("--timestep", type=int, default=1000)
    ap.add_argument("--schedule", type=str, default="sigmoid")
    ap.add_argument("--teacher", type=str, default=None,
                    help="teacher checkpoint (default: the conventional conditional name for "
                         "this schedule/cell)")
    ap.add_argument("--use-ema", action="store_true",
                    help="start from the teacher's EMA params")
    ap.add_argument("--stages", type=str, default=None,
                    help="comma list of student step counts, e.g. '15,8,4,2,1' "
                         "(default: halvings of t*+1 down to 1)")
    ap.add_argument("--steps-per-stage", type=int, default=2000)
    ap.add_argument("--lr", type=float, default=1e-5)
    ap.add_argument("--root", type=str, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--blocks", type=int, default=32, help="hicedrn residual blocks")
    ap.add_argument("--features", type=int, default=256, help="hicedrn feature width")
    ap.add_argument("--device", default="cuda", help="torch device to run on (default cuda)")
    ap.add_argument("--dist-backend", default=None, choices=("nccl", "gloo"),
                    help="under torchrun: the collectives' backend (default nccl on CUDA, "
                         "gloo on the CPU; gloo for ranks that share one card)")
    return ap.parse_args(argv)


def stage_seed(seed: int, k: int) -> int:
    """The draws' seed of the stage whose student takes k steps."""
    return int(np.random.SeedSequence((seed, k)).generate_state(1, np.uint32)[0])


def main(argv=None):
    args = parse_args(argv)
    if not args.bf16:  # the convs and GEMMs around the fused blocks in fp32, not TF32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    root = args.root or os.path.dirname(os.path.abspath(__file__))
    ckpt_dir = os.path.join(root, "Model_Weights")
    mesh = mesh_from_launcher(args.device, args.dist_backend)
    device = torch.device(args.device) if mesh is None else mesh.device
    main_rank = is_main(mesh)

    factory = GSE130711Module if args.celline == "Human" else GSE131811Module
    dm = factory(single_cell=True, batch_size=args.batch_size, res=40000, piece_size=64,
                 cell_No=args.celln, sigma_0=args.sigma, deg="deno", root=root)
    if main_rank:  # one writer of the caches
        dm.prepare_data()
    barrier(mesh)
    dm.setup(stage="fit")

    model = HicedrnDiff(self_condition=True, number_resnet=args.blocks, features=args.features,
                        dtype=torch.bfloat16 if args.bf16 else None, device=device,
                        generator=torch.Generator().manual_seed(args.seed))
    engine = GaussianDiffusion.create(model, device=device, timesteps=args.timestep,
                                      beta_schedule=args.schedule, mode="cond")
    t_star = engine.truncation_timestep(args.sigma)
    engine = dataclasses.replace(engine, t_start=t_star)

    base_tag = f"HiCedrn_cond_l2_{args.schedule[:3]}"
    meta = dict(res=40000, chunk=64, cell_line=args.celline, cell_no=args.celln)
    teacher_path = args.teacher or os.path.join(
        ckpt_dir, checkpoint_name("bestg", tag=base_tag, **meta))
    ck = load_checkpoint(teacher_path, only={"params", "ema_params", "run_config"})
    if main_rank:
        warn_run_config_mismatch(ck, dict(sigma=args.sigma, schedule=args.schedule, mode="cond",
                                          timestep=args.timestep), teacher_path)
    params = ck["ema_params"] if args.use_ema and ck.get("ema_params") else ck["params"]
    model.load_state_dict(params_from_jax(params))
    print(f"teacher: {teacher_path}  t*={t_star} (K0={t_star + 1} truncated steps)")

    stages = ([int(x) for x in args.stages.split(",")] if args.stages
              else halving_stages(t_star + 1)[1:])  # students only
    logger = MetricLogger(
        out_path=os.path.join(root, "logs",
                              f"distill_{base_tag}_cell{args.celln}_s{args.sigma}.jsonl")
        if main_rank else None,
        run_name=f"distill {base_tag} s{args.sigma}",
    )
    try:
        for k in stages:
            distiller = ProgressiveDistiller(engine, student_steps=k, lr=args.lr, mesh=mesh)
            best, best_val = distiller.fit(dm.train_dataloader(), dm.val_dataloader(),
                                           steps=args.steps_per_stage,
                                           seed=stage_seed(args.seed, k), logger=logger)
            model.load_state_dict(best)  # the next stage's teacher and student init
            out = os.path.join(ckpt_dir,
                               checkpoint_name("bestg", tag=f"{base_tag}_dist{k}", **meta))
            if main_rank:
                save_checkpoint(
                    out, params_to_jax({n: t.cpu() for n, t in best.items()}),
                    step=args.steps_per_stage,
                    run_config=dict(sigma=args.sigma, schedule=args.schedule, mode="cond",
                                    timestep=args.timestep, distilled_steps=k))
            print(f"stage K={k}: val distill loss {best_val:.6f} -> {out}")
    finally:
        logger.close()
        if mesh is not None:
            mesh.close()
    print("Distillation is done !!!")


if __name__ == "__main__":
    main()
