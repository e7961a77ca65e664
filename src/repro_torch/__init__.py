"""PyTorch/CUDA port of the OpenFPM reproduction in ``repro``.

The package mirrors ``repro`` module for module (``core``, ``numerics``,
``kernels``, ``apps``) and keeps its function names, so each function has
an obvious counterpart. It imports ``torch``, numpy and the standard
library only — never ``jax`` and nothing of ``repro``.

Entry points run on the CUDA card unless the caller asks for the CPU
(``device="cpu"``); asking for ``"cuda"`` without a card raises
``RuntimeError``. Hand-written CUDA kernels live under ``kernels/*/csrc``
and are compiled with ``nvcc`` at first use (``kernels/_build.py``);
nothing here needs CUDA at import time.
"""

import torch as _torch

# PyTorch's CPU sqrt kernel (seen in 2.13.0+cpu with AVX-512) can return
# values off by ~2e-4 in one worker thread's share of the first
# multi-threaded sqrt of a process; a first call small enough to run on one
# thread avoids it. The SPH and DEM bodies take sqrt over large pair tiles.
_torch.sqrt(_torch.ones(8))
