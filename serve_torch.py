#!/usr/bin/env python
"""hicdiff_tpu_torch serving CLI: the PyTorch/CUDA denoising daemon + client.

The flags of serve.py, plus --device (default cuda; there is no fallback to
the CPU when the device is absent):

    python serve_torch.py --socket /tmp/hicdiff.sock --weights <ckpt> -s 0.1 \
        --t-start auto --bf16
    python serve_torch.py --client --socket /tmp/hicdiff.sock \
        --request '{"id":1,"op":"denoise","npy":"noisy.npy"}'

    python serve_torch.py -u 1 --deg inp_mask --socket /tmp/hicdiff.sock \
        --weights <uncond ckpt> -s 0.1 --t-start auto

See hicdiff_tpu_torch/serve.py for the protocol. -u 0 serves the
conditional sampler, -u 1 the unconditional model in the DDRM sampler
(`mode="ddrm"`), whose requests may also carry (n, M) measurements.

Over several GPUs, launch it with torchrun: one process a rank (each on
cuda:LOCAL_RANK over NCCL, or all on the card --device names over gloo),
rank 0 listening on --socket, the service batch sharded over the ranks:

    torchrun --nproc-per-node 2 serve_torch.py --socket /tmp/hicdiff.sock --bf16 ...
    torchrun --nproc-per-node 2 serve_torch.py ... --device cuda:0 --dist-backend gloo

`shutdown` ends every rank with exit code 0; a rank that dies ends rank 0
(with an error) at its next collective.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def create_parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--socket", default="/tmp/hicdiff_tpu_torch.sock")
    ap.add_argument("--client", action="store_true",
                    help="act as a one-shot client instead of serving")
    ap.add_argument("--request", type=str, default='{"id":0,"op":"ping"}',
                    help="(client) JSON request to send")
    ap.add_argument("--weights", type=str, default=None,
                    help="JAX msgpack checkpoint to serve (default: seeded "
                         "random weights, for smoke runs)")
    ap.add_argument("-u", "--unspervised", type=int, default=0, choices=(0, 1),
                    help="0 = conditional sampler; 1 = unconditional prior + DDRM "
                         "restoration")
    ap.add_argument("--deg", default="deno",
                    help="(-u 1) degradation operator for the DDRM path")
    ap.add_argument("-s", "--sigma", type=float, default=0.1)
    ap.add_argument("--schedule", default="sigmoid")
    ap.add_argument("--timestep", type=int, default=1000)
    ap.add_argument("--t-start", default="auto")
    ap.add_argument("--sampling-steps", type=int, default=None)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--blocks", type=int, default=32)
    ap.add_argument("--features", type=int, default=256)
    ap.add_argument("--scan-chunk", type=int, default=250,
                    help="accepted for serve.py compatibility; the port runs "
                         "each chain in one pass, as CUDA has no per-execution "
                         "time limit to segment around")
    ap.add_argument("--use-ema", action="store_true")
    ap.add_argument("--no-warmup", action="store_true")
    ap.add_argument("--percentile", type=float, default=None,
                    help="normalization percentile. Default: adopt the "
                         "checkpoint's stored value (falling back to 99.99); "
                         "an explicit value overrides it, with a warning on "
                         "mismatch")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda; under torchrun, cuda is "
                         "each rank's cuda:LOCAL_RANK)")
    ap.add_argument("--dist-backend", default=None, choices=("nccl", "gloo"),
                    help="under torchrun: the process group's backend (default nccl on "
                         "GPUs, gloo on the CPU; gloo for ranks sharing one card)")
    return ap


def main(argv=None):
    args = create_parser().parse_args(argv)

    if args.client:
        from hicdiff_tpu_torch.serve import request

        resp = request(args.socket, json.loads(args.request))
        print(json.dumps(resp))
        return 0 if resp.get("ok") else 1

    import torch

    if not args.bf16:  # the convs and Dense layers around the fused blocks in fp32, not TF32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    if args.unspervised:  # DDRM's spectral transforms are fp32 whatever the backbone's dtype
        torch.backends.cuda.matmul.allow_tf32 = False
    from hicdiff_tpu_torch.parallel.mesh import barrier, mesh_from_launcher
    from hicdiff_tpu_torch.serve import DenoiseService, serve_forever

    mesh = mesh_from_launcher(args.device, args.dist_backend)
    try:
        service = DenoiseService(
            args.weights, device=args.device, mode="ddrm" if args.unspervised else "cond",
            deg=args.deg, sigma=args.sigma,
            schedule=args.schedule, timesteps=args.timestep, t_start=args.t_start,
            sampling_steps=args.sampling_steps, batch=args.batch, bf16=args.bf16,
            blocks=args.blocks, features=args.features, use_ema=args.use_ema,
            warmup=not args.no_warmup, percentile=args.percentile, mesh=mesh,
        )
        rank, world = (0, 1) if mesh is None else (mesh.rank, mesh.world_size)
        if rank == 0:
            serve_forever(service, args.socket)
        else:
            service.follow()
        print(f"kernel launches, rank {rank} of {world}: {json.dumps(_launches())}", flush=True)
        barrier(mesh)  # no rank tears the group down while another still works
    finally:
        if mesh is not None:
            mesh.close()
    return 0


def _launches() -> dict:
    from hicdiff_tpu_torch.kernels.resblock import fused_resblock
    from hicdiff_tpu_torch.kernels.sample_step import fused_posterior_step

    return {"fused_resblock": fused_resblock.launches,
            "fused_posterior_step": fused_posterior_step.launches}


if __name__ == "__main__":
    sys.exit(main())
