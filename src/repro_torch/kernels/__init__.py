"""Hand-written CUDA kernels (``*/csrc/*.cu``) with their PyTorch wrappers
and plain PyTorch versions. Built with ``nvcc`` at first use
(``_build.py``); importing needs no CUDA."""
