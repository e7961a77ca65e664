"""Fused Gray–Scott 7-point stencil step: the CUDA kernel and its plain
PyTorch version."""
