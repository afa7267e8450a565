#!/usr/bin/env python
"""HiCDiff training CLI on PyTorch/CUDA — train.py's `-u 0` and `-u 1` paths.

The flags and defaults of train.py, plus --device (default cuda; there is
no fallback to the CPU when the device is absent):

    python train_torch.py -u 1 -s 0.1 --root <dir> [-e N] [-b 64] [--resume CKPT] \
        [--ema-decay D] [--bf16] [--device cpu]

`-u 1` (the default, as in train.py) trains the unconditional DDPM, the
prior the `-u 1` inference drives through DDRM: the base HicedrnDiff without
self-conditioning, on the clean patches alone, tag HiCedrn_l2_{sch}. `-u 0`
trains the conditional DDPM (self-conditioned on the noisy patch), tag
HiCedrn_cond_l2_{sch}. Both train with Adam at lr 2e-5 on the
single-cell data module of the cell and write the best (by val loss) and
final checkpoints as Model_Weights/{bestg,finalg}_40000_c64_s64_{cell}_{tag}
.msgpack in the JAX package's layout, with the JSONL log under logs/. A
checkpoint of either package resumes with --resume. The compute is fp32 with
TF32 off, or bf16 with --bf16, as train.py's: the model computes in bf16
(the residual blocks' forward and backward in the bf16 kernels), while the
parameters, Adam state, EMA, loss and checkpoints stay fp32.

Launched by torchrun, it trains data-parallel, one process a rank, as
train.py does over make_mesh(): each rank on cuda:LOCAL_RANK over NCCL, or,
for ranks that share one card, `--device cuda:0 --dist-backend gloo`:

    torchrun --nproc-per-node 2 train_torch.py -u 0 -s 0.1 --root <dir>

Rank 0 prepares the data caches, writes the checkpoints and the log.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

from hicdiff_tpu_torch.data.datamodule import GSE130711Module, GSE131811Module  # noqa: E402
from hicdiff_tpu_torch.diffusion.gaussian import GaussianDiffusion  # noqa: E402
from hicdiff_tpu_torch.models.hicedrn import HicedrnDiff  # noqa: E402
from hicdiff_tpu_torch.parallel.mesh import barrier, is_main, mesh_from_launcher  # noqa: E402
from hicdiff_tpu_torch.train.logging import MetricLogger  # noqa: E402
from hicdiff_tpu_torch.train.trainer import Trainer  # noqa: E402


def create_parser(argv=None):
    parser = argparse.ArgumentParser(
        description="HiCDiff works for single-cell HI-C data denoising !!! (PyTorch/CUDA)"
    )
    parser.add_argument("-u", "--unspervised", type=int, default=1, choices=[0, 1],
                        help="1: unsupervised/unconditional DDPM; "
                             "0: supervised/conditional DDPM")
    parser.add_argument("-b", "--batch_size", type=int, default=64)
    parser.add_argument("-e", "--epoch", type=int, default=400)
    parser.add_argument("-l", "--celline", type=str, default="Human", choices=["Human", "Dros"])
    parser.add_argument("-n", "--celln", type=int, default=1)
    parser.add_argument("-s", "--sigma", type=float, default=1.0,
                        help="Gaussian noise level in [0, 1]")
    parser.add_argument("--root", type=str, default=None,
                        help="data/checkpoint root (default: repo dir)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--bf16", action="store_true",
                        help="bf16 compute (fp32 params)")
    parser.add_argument("--timestep", type=int, default=1000)
    parser.add_argument("--schedule", type=str, default="linear")
    parser.add_argument("--blocks", type=int, default=32,
                        help="hicedrn residual blocks (reference: 32)")
    parser.add_argument("--features", type=int, default=256,
                        help="hicedrn feature width (reference: 256)")
    parser.add_argument("--resume", type=str, default=None,
                        help="checkpoint (of either package) to resume params, Adam state "
                             "and step from")
    parser.add_argument("--ckpt-throttle", type=float, default=0.0,
                        help="min seconds between best-checkpoint writes (the true best is "
                             "always written at the end)")
    parser.add_argument("--ema-decay", type=float, default=0.0,
                        help="exponential-moving-average decay for the params (0 disables; "
                             "saved in checkpoints, read by inference_torch.py --use-ema)")
    parser.add_argument("--device", default="cuda", help="torch device to run on (default cuda)")
    parser.add_argument("--dist-backend", default=None, choices=("nccl", "gloo"),
                        help="under torchrun: the collectives' backend (default nccl on CUDA, "
                             "gloo on the CPU; gloo for ranks that share one card)")
    return parser.parse_args(argv)


class HiCDiff:
    """train.py's HiCDiff on `device`: the data module, the model and
    engine (conditional or not), the trainer and the logger of one run."""

    def __init__(self, epoch=500, timestep=1000, cell_Line="Human", cellNo=1, res=40000,
                 batch_size=64, piece_s=64, sigma=0.1, condition=True, deg="deno", root=None,
                 seed=0, bf16=False, schedule="linear", blocks=32, features=256, ema_decay=0.0,
                 ckpt_throttle=0.0, device="cuda", mesh=None):
        self.epoch = epoch
        self.cell_line = cell_Line
        self.cell_no = cellNo
        self.res = res
        self.chunk = piece_s
        self.seed = seed
        self.ckpt_throttle = ckpt_throttle
        self.run_config = dict(sigma=sigma, deg=deg, schedule=schedule, timestep=timestep)
        root = root or os.path.dirname(os.path.abspath(__file__))
        self.out_dir = os.path.join(root, "Model_Weights")
        os.makedirs(self.out_dir, exist_ok=True)

        # the reference trains on the single-cell (_sing) modules
        factory = GSE130711Module if cell_Line == "Human" else GSE131811Module
        dm = factory(single_cell=True, batch_size=batch_size, res=res, piece_size=piece_s,
                     cell_No=cellNo, sigma_0=sigma, deg=deg, root=root)
        if is_main(mesh):  # one writer of the caches
            dm.prepare_data()
        barrier(mesh)
        dm.setup(stage="fit")
        # the normalization scale the weights are trained at, for serving
        self.run_config["percentile"] = float(dm.percentile)
        self.train_loader = dm.train_dataloader()
        self.val_loader = dm.val_dataloader()

        device = torch.device(device) if mesh is None else mesh.device
        # train.py's inverted naming: condition=True is the UNconditional engine
        self.mode = "uncond" if condition else "cond"
        model = HicedrnDiff(self_condition=not condition, number_resnet=blocks,
                            features=features, dtype=torch.bfloat16 if bf16 else None,
                            device=device,
                            generator=torch.Generator().manual_seed(seed))
        self.engine = GaussianDiffusion.create(model, device=device, timesteps=timestep,
                                               beta_schedule=schedule, mode=self.mode)
        self.trainer = Trainer(self.engine, lr=2e-5, ema_decay=ema_decay, mesh=mesh)
        self.tag = f"HiCedrn_{'cond_' if self.mode == 'cond' else ''}l2_{schedule[:3]}"
        log = os.path.join(root, "logs", f"train_{self.tag}_cell{cellNo}_s{sigma}.jsonl")
        self.logger = MetricLogger(
            out_path=log if is_main(mesh) else None,
            run_name=f"hicedrn_Diff_{self.mode}_L2_{schedule} cell_{cellNo}",
        )

    def fit_model(self, resume: str = None):
        """Train; returns the best val loss."""
        start_step = 0
        if resume:
            start_step = self.trainer.resume(resume)
            print(f"resumed from {resume} at step {start_step}")
        return self.trainer.fit(
            self.train_loader, self.val_loader, epochs=self.epoch, seed=self.seed,
            logger=self.logger, ckpt_dir=self.out_dir, ckpt_tag=self.tag,
            ckpt_meta=dict(res=self.res, chunk=self.chunk, cell_line=self.cell_line,
                           cell_no=self.cell_no),
            start_step=start_step, ckpt_throttle_s=self.ckpt_throttle,
            run_config=dict(mode=self.mode, **self.run_config),
        )


def main(argv=None):
    args = create_parser(argv)
    if not args.bf16:  # the convs and GEMMs around the fused blocks in fp32, not TF32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    mesh = mesh_from_launcher(args.device, args.dist_backend)
    train_model = HiCDiff(
        epoch=args.epoch, timestep=args.timestep, batch_size=args.batch_size,
        cellNo=args.celln, cell_Line=args.celline, sigma=args.sigma,
        condition=bool(args.unspervised), root=args.root, seed=args.seed, bf16=args.bf16,
        schedule=args.schedule, blocks=args.blocks, features=args.features,
        ema_decay=args.ema_decay, ckpt_throttle=args.ckpt_throttle, device=args.device,
        mesh=mesh,
    )
    try:
        train_model.fit_model(resume=args.resume)
    finally:
        train_model.logger.close()
        if mesh is not None:
            mesh.close()
    print("Training is done !!! ~~~~~")


if __name__ == "__main__":
    main()
