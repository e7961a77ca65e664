"""Cell-blocked Lennard-Jones forces (paper §4.1 hot loop) — a thin pair
body over the cell-pair engine (``kernels/cell_pair``)."""
from __future__ import annotations

from repro_torch.apps.md import lj_pair_body
from repro_torch.kernels.cell_pair.cell_pair import cell_pair


def lj_cell_forces(cell_x, nbr_x, cell_mask, nbr_mask, *, sigma: float,
                   epsilon: float, r_cut: float):
    """cell_x: (C, cc, 3); nbr_x: (C, Kcc, 3); masks: (C, cc)/(C, Kcc).
    Returns per-slot forces (C, cc, 3): the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors. Self-pairs are excluded by the
    engine's r² > 1e-12 guard."""
    out = cell_pair(cell_x, nbr_x, cell_mask, nbr_mask,
                    body=lj_pair_body(sigma, epsilon), out={"f": "radial"},
                    r_cut=r_cut)
    return out["f"]
