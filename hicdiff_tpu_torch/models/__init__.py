"""The diffusion backbones (HicedrnDiff, Unet, Unet1D), the VAE, the baselines,
their building blocks and registry."""
