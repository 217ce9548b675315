"""Hand-written CUDA kernels for Hopper, their builds, wrappers and
plain PyTorch versions."""
