"""End-to-end LJ force op — delegates to ``apps.md.compute_forces`` with the
engine's kernel backend (``"auto"``: the CUDA kernel for CUDA tensors)."""
from __future__ import annotations

import dataclasses

from repro_torch.apps import md


def forces(ps, cfg):
    """The interaction part of ``apps.md.compute_forces``: returns
    (forces, cell-list overflow)."""
    ps2, overflow = md.compute_forces(ps, dataclasses.replace(
        cfg, backend="auto"))
    return ps2.props["f"], overflow
