"""The Gray–Scott step from an ``apps.gray_scott.GSConfig``: the CUDA
kernel for CUDA tensors, the plain version for CPU tensors."""
from __future__ import annotations

from repro_torch.kernels.stencil7.stencil7 import gray_scott_step


def step(u, v, cfg):
    """Gray–Scott step from an ``apps.gray_scott.GSConfig``."""
    inv_h2 = (cfg.shape[0] / cfg.L) ** 2
    return gray_scott_step(u, v, Du=cfg.Du, Dv=cfg.Dv, F=cfg.F, k=cfg.k,
                           dt=cfg.dt, inv_h2=inv_h2)
