"""hicdiff_tpu_torch — the PyTorch/CUDA port of hicdiff_tpu.

The port's slice so far is conditional denoising with the base HicedrnDiff
backbone, served by `serve.DenoiseService`. Both Pallas kernels of the JAX
package have hand-written CUDA counterparts under `csrc/`, built for Hopper
(`sm_90a`) on first use by `kernels._build`. Module names mirror the JAX
package's; public functions keep its NHWC layout.

Importing the package loads only torch and numpy: no JAX, no flax, no
`hicdiff_tpu`, and no CUDA toolchain.
"""

__version__ = "0.1.0"
