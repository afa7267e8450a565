"""hicdiff_tpu_torch — the PyTorch/CUDA port of hicdiff_tpu.

The port so far covers both inference paths of the base HicedrnDiff
backbone: conditional denoising (`-u 0`) and DDRM restoration with the
unconditional model (`-u 1`: `degrade.operators`, `sampling.ddrm`), each
through the inference CLI (`inference_torch.py`, with the data modules,
metrics harness and exports), the serving daemon (`serve.DenoiseService`)
and fp32 training (`train_torch.py`, `train.trainer.Trainer`); and the
diffusion-backbone zoo (`models.zoo.DIFFUSION_BACKBONES`: the hicedrn
variants and the U-Nets) with the cond, uncond and sr3 engines, through
`inference_torch.py --model` and `pretrain_torch.py`; and the baseline zoo
(`models.baselines`, `models.hicedrn.HicedrnGenerator`, `models.zoo.BASELINES`,
`metrics.losses`) through `pretrain_baselines_torch.py` and
`sample/stard_metric_normal_torch.py`. Both Pallas kernels of the JAX package have
hand-written CUDA counterparts under `csrc/`, and so does the residual
block's backward, which the JAX package leaves to autodiff; all are built
for Hopper (`sm_90a`) on first use by `kernels._build`. Module names mirror the JAX package's; public
functions keep its NHWC layout.

Importing the package loads only torch and numpy: no JAX, no flax, no
`hicdiff_tpu`, no h5py or msgpack, and no CUDA toolchain.
"""

__version__ = "0.1.0"
