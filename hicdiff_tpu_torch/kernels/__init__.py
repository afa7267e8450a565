"""Hand-written CUDA kernels for the port, each with its plain PyTorch version."""
