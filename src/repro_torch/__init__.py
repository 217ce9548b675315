"""repro_torch — the B-MoE system in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper (sm_90a).

A port of the JAX package ``repro`` (which stays the reference): module
names mirror it, so ``repro_torch.core.bmoe`` is the counterpart of
``repro.core.bmoe``.  This package imports torch, numpy and the standard
library only.  Entry points run on the CUDA device unless the caller
passes ``device="cpu"``; on a CPU tensor every kernel wrapper takes its
plain PyTorch version.
"""
