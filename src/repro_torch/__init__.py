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
