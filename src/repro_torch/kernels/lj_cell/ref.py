"""Oracle for the LJ cell-tile wrapper (``lj_cell.lj_cell_forces``): the
same dense masked math in plain PyTorch, written as ``repro``'s
``kernels/lj_cell/ref.py`` writes it, independent of the pair-body
protocol and the cell-pair engine."""
from __future__ import annotations

import torch


def lj_cell_forces_ref(cell_x, nbr_x, cell_mask, nbr_mask, *, sigma,
                       epsilon, r_cut):
    """Per-slot LJ forces (C, cc, 3) of tiles cell_x (C, cc, 3) against
    nbr_x (C, Kcc, 3), masked by the slot masks, ``r < r_cut`` and
    ``r² > 1e-12`` (self-pairs)."""
    dx = cell_x[:, :, None, :] - nbr_x[:, None, :, :]
    r2 = (dx * dx).sum(-1)
    ok = (cell_mask[:, :, None] & nbr_mask[:, None, :]
          & (r2 < r_cut * r_cut) & (r2 > 1e-12))
    r2s = torch.clamp(r2, min=1e-12)
    inv3 = (torch.full_like(r2s, sigma * sigma) / r2s) ** 3
    mag = 24.0 * epsilon * (2.0 * inv3 * inv3 - inv3) / r2s
    mag = torch.where(ok, mag, torch.zeros_like(mag))
    return torch.einsum("cij,cijd->cid", mag, dx)
