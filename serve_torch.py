#!/usr/bin/env python
"""hicdiff_tpu_torch serving CLI: the PyTorch/CUDA denoising daemon + client.

The flags of serve.py, plus --device (default cuda; there is no fallback to
the CPU when the device is absent):

    python serve_torch.py --socket /tmp/hicdiff.sock --weights <ckpt> -s 0.1 \
        --t-start auto --bf16
    python serve_torch.py --client --socket /tmp/hicdiff.sock \
        --request '{"id":1,"op":"denoise","npy":"noisy.npy"}'

See hicdiff_tpu_torch/serve.py for the protocol. Only -u 0 (the conditional
sampler) is ported; -u 1 raises NotImplementedError.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main():
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
                    help="0 = conditional sampler; 1 = DDRM (not ported yet)")
    ap.add_argument("--deg", default="deno",
                    help="(-u 1) degradation operator; -u 1 is not ported yet")
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
                    help="torch device to serve on (default cuda)")
    args = ap.parse_args()

    if args.client:
        from hicdiff_tpu_torch.serve import request

        resp = request(args.socket, json.loads(args.request))
        print(json.dumps(resp))
        return 0 if resp.get("ok") else 1

    if args.unspervised:
        raise NotImplementedError(
            f"-u 1 (DDRM restoration, --deg {args.deg}) is not ported yet"
        )
    from hicdiff_tpu_torch.serve import DenoiseService, serve_forever

    service = DenoiseService(
        args.weights, device=args.device, sigma=args.sigma,
        schedule=args.schedule, timesteps=args.timestep, t_start=args.t_start,
        sampling_steps=args.sampling_steps, batch=args.batch, bf16=args.bf16,
        blocks=args.blocks, features=args.features, use_ema=args.use_ema,
        warmup=not args.no_warmup, percentile=args.percentile,
    )
    serve_forever(service, args.socket)
    return 0


if __name__ == "__main__":
    sys.exit(main())
