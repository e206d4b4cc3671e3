"""Kernels of the port: each hand-written CUDA kernel (``csrc/``) behind a
wrapper, with its plain PyTorch version beside it."""
