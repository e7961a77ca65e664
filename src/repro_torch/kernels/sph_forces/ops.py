"""End-to-end SPH rate op — delegates to ``apps.sph.compute_rates`` with the
engine's kernel backend (``"auto"``: the CUDA kernel for CUDA tensors)."""
from __future__ import annotations

import dataclasses

from repro_torch.apps import sph
from repro_torch.apps.sph import SPHConfig


def compute_rates(ps, cfg: SPHConfig):
    """Kernel-backed ``apps.sph.compute_rates``: returns (accel, drho,
    cell-list overflow)."""
    return sph.compute_rates(ps, dataclasses.replace(cfg, backend="auto"))
