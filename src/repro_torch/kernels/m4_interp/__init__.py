"""Cell-bucketed M'4 particle-mesh interpolation: bucketing, the CUDA P2M
and fused M2P kernels, and their plain PyTorch versions."""
