#!/usr/bin/env python
"""Per-experiment training CLI on PyTorch/CUDA — the port of pretrain.py for
the diffusion-backbone zoo, one parameterized run per reference pretrain script:

  reference script                      equivalent invocation
  train_hicedrn_Diff.py            -->  --model hicedrn      --engine uncond --data pure_noise
  train_hicedrn_cond_Diff.py       -->  --model hicedrn      --engine cond   --data linear
  train_hicedrn_cond_Diff_n.py     -->  --model hicedrn      --engine cond   --data linear_sing
  train_hicedrn_Diff_sr3.py        -->  --model hicedrn_sr3  --engine sr3    --data linear
  train_unet_Diff.py               -->  --model unet         --engine uncond --data pure_noise
  train_unet_uncond.py             -->  --model unet         --engine uncond --data linear
  train_unet_Diff_cond.py          -->  --model unet         --engine cond   --data linear
  train_unet_Diff_cond_n.py        -->  --model unet         --engine cond   --data linear_sing
  train_unet_Diff_sr3.py           -->  --model unet_sr3     --engine sr3    --data linear

plus --model hicedrn_att for the attention variant. The flags and defaults
of pretrain.py, plus --device (default cuda; there is no fallback to the
CPU when the device is absent):

    python pretrain_torch.py --model hicedrn_sr3 --engine sr3 --root <dir> [-e N] \
        [-b 64] [--resume CKPT] [--sr3-per-sample-t] [--bf16] [--device cpu]

All runs: fp32 with TF32 off (or bf16 compute with --bf16, as pretrain.py:
fp32 parameters, Adam state, loss and checkpoints; the hicedrn variants'
residual blocks through the bf16 kernels, the att variant's on its fp32
stream), Adam at lr 2e-5, L2, the population data
module of the cell (`--data linear_sing`: its 99.99 percentile;
`pure_noise`: the DDPM-noised variant), best and final checkpoints
Model_Weights/{bestg,finalg}_40000_c64_s64_{cell}_{model}_{engine}_{data}
_l2_{sch}.msgpack in the JAX package's layout (either package resumes the
other's with --resume), the JSONL log under logs/. The uncond engine trains
a backbone without self-conditioning; cond and sr3 condition on the noisy
patch. Launched by torchrun (`torchrun --nproc-per-node N pretrain_torch.py
...`) it trains data-parallel, as pretrain.py does over make_mesh(): a rank
on cuda:LOCAL_RANK over NCCL, or `--device cuda:0 --dist-backend gloo` for
ranks that share one card; rank 0 prepares the caches and writes the
checkpoints and the log.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

from hicdiff_tpu_torch.data.datamodule import HiCDataModule  # noqa: E402
from hicdiff_tpu_torch.diffusion.gaussian import GaussianDiffusion  # noqa: E402
from hicdiff_tpu_torch.models.zoo import DIFFUSION_BACKBONES as MODELS  # noqa: E402
from hicdiff_tpu_torch.parallel.mesh import barrier, is_main, mesh_from_launcher  # noqa: E402
from hicdiff_tpu_torch.train.logging import MetricLogger  # noqa: E402
from hicdiff_tpu_torch.train.trainer import Trainer  # noqa: E402


def create_parser(argv=None):
    ap = argparse.ArgumentParser(description="HiCDiff per-experiment pretraining (PyTorch/CUDA)")
    ap.add_argument("--model", choices=sorted(MODELS), default="hicedrn")
    ap.add_argument("--engine", choices=["uncond", "cond", "sr3"], default="cond")
    ap.add_argument("--data", choices=["linear", "linear_sing", "pure_noise"], default="linear")
    ap.add_argument("-b", "--batch_size", type=int, default=64)
    ap.add_argument("-e", "--epoch", type=int, default=400)
    ap.add_argument("-l", "--celline", type=str, default="Human", choices=["Human", "Dros"])
    ap.add_argument("-n", "--celln", type=int, default=1)
    ap.add_argument("-s", "--sigma", type=float, default=0.1)
    ap.add_argument("--timestep", type=int, default=1000)
    ap.add_argument("--schedule", type=str, default="linear")
    ap.add_argument("--root", type=str, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--bf16", action="store_true", help="bf16 compute (fp32 params)")
    ap.add_argument("--ckpt-throttle", type=float, default=60.0,
                    help="min seconds between best-checkpoint writes; the running best stays "
                         "on the device and the true best is always written at the end")
    ap.add_argument("--resume", type=str, default=None,
                    help="checkpoint (of either package) to resume params, Adam state and "
                         "step from")
    ap.add_argument("--sr3-per-sample-t", action="store_true",
                    help="sr3 engine only: draw the continuous noise level per sample instead "
                         "of the reference's one scalar t per optimizer step")
    ap.add_argument("--device", default="cuda", help="torch device to run on (default cuda)")
    ap.add_argument("--dist-backend", default=None, choices=("nccl", "gloo"),
                    help="under torchrun: the collectives' backend (default nccl on CUDA, "
                         "gloo on the CPU; gloo for ranks that share one card)")
    return ap.parse_args(argv)


def main(argv=None):
    args = create_parser(argv)
    if not args.bf16:  # the convs and GEMMs around the fused blocks in fp32, not TF32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    root = args.root or os.path.dirname(os.path.abspath(__file__))
    mesh = mesh_from_launcher(args.device, args.dist_backend)
    device = torch.device(args.device) if mesh is None else mesh.device

    percentile = 99.99 if args.data == "linear_sing" else None
    variant = "pure_noise" if args.data == "pure_noise" else "linear"
    dm = HiCDataModule(
        batch_size=args.batch_size, cell_line=args.celline, cell_No=args.celln,
        sigma_0=args.sigma, deg="deno", percentile=percentile, variant=variant,
        root=root, timestep=args.timestep, beta_schedule=args.schedule,
    )
    if is_main(mesh):  # one writer of the caches
        dm.prepare_data()
    barrier(mesh)
    dm.setup("fit")

    self_cond = args.engine in ("cond", "sr3")
    model = MODELS[args.model](self_cond, torch.bfloat16 if args.bf16 else None, device=device,
                               generator=torch.Generator().manual_seed(args.seed))
    engine = GaussianDiffusion.create(
        model, device=device, timesteps=args.timestep, beta_schedule=args.schedule,
        mode=args.engine, sr3_per_sample_t=args.sr3_per_sample_t,
    )
    tag = f"{args.model}_{args.engine}_{args.data}_l2_{args.schedule[:3]}"
    trainer = Trainer(engine, lr=2e-5, mesh=mesh)
    logger = MetricLogger(
        out_path=os.path.join(root, "logs", f"pretrain_{tag}_cell{args.celln}.jsonl")
        if is_main(mesh) else None,
        run_name=f"{tag} cell_{args.celln}",
    )
    start_step = 0
    if args.resume:
        start_step = trainer.resume(args.resume)
        print(f"resumed from {args.resume} at step {start_step}")
    try:
        trainer.fit(
            dm.train_dataloader(), dm.val_dataloader(), epochs=args.epoch, seed=args.seed,
            logger=logger, start_step=start_step, ckpt_throttle_s=args.ckpt_throttle,
            ckpt_dir=os.path.join(root, "Model_Weights"), ckpt_tag=tag,
            ckpt_meta=dict(res=dm.res, chunk=64, cell_line=args.celline, cell_no=args.celln),
            run_config=dict(sigma=args.sigma, schedule=args.schedule, mode=args.engine,
                            timestep=args.timestep),
        )
    finally:
        logger.close()
        if mesh is not None:
            mesh.close()
    print("Pretraining is done !!!")
    return trainer


if __name__ == "__main__":
    main()
