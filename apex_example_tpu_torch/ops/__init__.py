"""Kernels of the port: each a CUDA source in ../csrc, its wrapper and
its plain PyTorch version."""
