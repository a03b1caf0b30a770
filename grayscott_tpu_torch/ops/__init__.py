"""Numerical operators: the plain PyTorch step, the kernels and their build."""
