"""Fused SPH density+momentum tile kernel (paper §4.2 hot loop) — a thin
pair body over the cell-pair engine (``kernels/cell_pair``), whose CUDA
kernel runs it as the SPH functor.

The fusion (one cubic-spline gradient evaluation feeding both dρ/dt and
the acceleration) lives in ``apps.sph.SPHPairBody``; the engine does the
rest."""
from __future__ import annotations

from repro_torch.apps.sph import sph_pair_body
from repro_torch.kernels.cell_pair.cell_pair import cell_pair


def sph_cell_forces(cell_x, nbr_x, cell_v, nbr_v, cell_rho, nbr_rho,
                    cell_mask, nbr_mask, *, cfg):
    """Tiles: (C, cc, dim)/(C, Kcc, dim) positions+velocities, (C, cc)/(C,
    Kcc) densities+masks. Returns (accel (C, cc, dim), drho (C, cc)): the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    out = cell_pair(cell_x, nbr_x, cell_mask, nbr_mask,
                    {"v": cell_v, "rho": cell_rho},
                    {"v": nbr_v, "rho": nbr_rho},
                    body=sph_pair_body(cfg),
                    out={"a": "radial", "drho": "scalar"}, r_cut=cfg.r_cut,
                    precision=cfg.precision)
    return out["a"], out["drho"]
