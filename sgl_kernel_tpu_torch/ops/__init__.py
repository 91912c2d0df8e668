"""Operators of the port: plain PyTorch, and hand-written Hopper kernels
behind the same functions for CUDA tensors."""
