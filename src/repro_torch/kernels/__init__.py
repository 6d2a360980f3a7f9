"""Planar layout, the hand-written CUDA kernels and their plain PyTorch
versions."""
