"""Causal GQA flash attention (B5): the CUDA kernel, its plain PyTorch
version and the ``(B, S, H, hd)`` adapter ``ops.mha``."""
