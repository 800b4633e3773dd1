"""Kernel wrappers: each CUDA kernel under `csrc/` beside its plain PyTorch version."""
