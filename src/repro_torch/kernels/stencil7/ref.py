"""Oracle: the plain Gray–Scott step, ``repro``'s ``stencil7/ref.py`` op
for op (the app's own stencil, one source of truth)."""
from __future__ import annotations

import torch


def gray_scott_step_ref(u, v, *, Du, Dv, F, k, dt, inv_h2):
    """One explicit-Euler step of both species on periodic fields of any
    dimension and floating type."""
    def lap(f):
        out = -2.0 * f.dim() * f
        for d in range(f.dim()):
            out = out + torch.roll(f, 1, dims=d) + torch.roll(f, -1, dims=d)
        return out * inv_h2

    uvv = u * v * v
    un = u + dt * (Du * lap(u) - uvv + F * (1.0 - u))
    vn = v + dt * (Dv * lap(v) + uvv - (F + k) * v)
    return un, vn
