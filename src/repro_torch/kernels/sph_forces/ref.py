"""Oracle for the SPH cell-tile kernel — the app's own kernel function
applied over the dense tiles (one source of truth)."""
from __future__ import annotations

import torch

from repro_torch.apps.sph import sph_kernel_factory


def sph_cell_forces_ref(cell_x, nbr_x, cell_v, nbr_v, cell_rho, nbr_rho,
                        cell_mask, nbr_mask, *, cfg):
    kern = sph_kernel_factory(cfg)
    dx = cell_x[:, :, None, :] - nbr_x[:, None, :, :]
    r2 = (dx * dx).sum(-1)
    ok = (cell_mask[:, :, None] & nbr_mask[:, None, :]
          & (r2 < cfg.r_cut ** 2) & (r2 > 1e-12))
    wi = {"v": cell_v[:, :, None, :], "rho": cell_rho[:, :, None]}
    wj = {"v": nbr_v[:, None, :, :], "rho": nbr_rho[:, None, :]}
    out = kern(dx, r2, wi, wj)
    a = torch.where(ok[..., None], out["a"], torch.zeros_like(out["a"]))
    drho = torch.where(ok, out["drho"], torch.zeros_like(out["drho"]))
    return a.sum(2), drho.sum(2)
