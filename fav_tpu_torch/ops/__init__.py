"""Corruption kernels and their plain PyTorch versions."""
