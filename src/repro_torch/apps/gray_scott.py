"""Gray–Scott reaction-diffusion finite-difference solver (port of
``repro.apps.gray_scott``; paper §4.3).

Second-order centred 7-point (3-D) / 5-point (2-D) stencil on a periodic
Cartesian mesh, explicit Euler in time — the paper's AMReX comparison
case. Validation: Pearson-classified steady states (paper Fig. 6),
measured by the non-uniformity of ``v`` (patterns against homogeneous
death).

As in ``repro``, :func:`run` and :func:`gs_step` are the plain tensor
step; the fused CUDA stencil kernel is reached through
``kernels.stencil7.ops.step``. :func:`gs_step_padded` is the step over a
halo-padded leading axis that ``core.grid.apply_stencil_local`` takes.
``GSConfig.device`` (default ``"cuda"``) is where :func:`init_fields` and
:func:`run` put the fields. :func:`run_distributed` is the slab run over a
1-D device mesh, on ``grid.DistributedField`` blocks.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.core import grid as G
from repro_torch.core import runtime as RT
from repro_torch.core.particles import resolve_device

# Pearson (1993) parameter sets (paper Fig. 6 uses these classes)
PEARSON = {
    "alpha": (0.010, 0.047),
    "beta": (0.026, 0.051),
    "gamma": (0.022, 0.051),
    "delta": (0.030, 0.055),
    "epsilon": (0.018, 0.055),
    "zeta": (0.024, 0.060),
    "eta": (0.034, 0.063),
    "theta": (0.038, 0.061),
    "kappa": (0.050, 0.063),
}


@dataclasses.dataclass(frozen=True)
class GSConfig:
    shape: Tuple[int, ...] = (64, 64, 64)   # paper: 256^3
    Du: float = 2e-5
    Dv: float = 1e-5
    F: float = 0.030
    k: float = 0.055
    dt: float = 1.0
    L: float = 2.5                           # box length per axis
    device: str = "cuda"                     # where init_fields / run work


def laplacian(u, inv_h2):
    """Periodic second-order centred Laplacian, any dimension."""
    out = -2.0 * u.dim() * u
    for d in range(u.dim()):
        out = out + torch.roll(u, 1, dims=d) + torch.roll(u, -1, dims=d)
    return out * inv_h2


def gs_rhs(u, v, cfg: GSConfig):
    inv_h2 = (cfg.shape[0] / cfg.L) ** 2
    uvv = u * v * v
    du = cfg.Du * laplacian(u, inv_h2) - uvv + cfg.F * (1.0 - u)
    dv = cfg.Dv * laplacian(v, inv_h2) + uvv - (cfg.F + cfg.k) * v
    return du, dv


def gs_step(u, v, cfg: GSConfig):
    du, dv = gs_rhs(u, v, cfg)
    return u + cfg.dt * du, v + cfg.dt * dv


def gs_step_padded(cfg: GSConfig):
    """Stencil step over a halo-padded leading axis — the function handed
    to ``core.grid.apply_stencil_local`` (halo 1)."""

    def step(u_pad, v_pad):
        inv_h2 = (cfg.shape[0] / cfg.L) ** 2

        # leading axis: neighbours from the pad; the others periodic rolls
        def lap(f):
            out = -2.0 * f.dim() * f
            out = out + torch.roll(f, 1, dims=0) + torch.roll(f, -1, dims=0)
            for d in range(1, f.dim()):
                out = out + torch.roll(f, 1, dims=d) \
                    + torch.roll(f, -1, dims=d)
            return out * inv_h2

        uvv = u_pad * v_pad * v_pad
        du = cfg.Du * lap(u_pad) - uvv + cfg.F * (1.0 - u_pad)
        dv = cfg.Dv * lap(v_pad) + uvv - (cfg.F + cfg.k) * v_pad
        return u_pad + cfg.dt * du, v_pad + cfg.dt * dv

    return step


def init_fields(cfg: GSConfig, seed: int = 0):
    """Pearson's initialization on ``cfg.device``: u = 1, v = 0 with a
    perturbed square seed in the centre, and u lowered by 0.05·U(0, 1)
    noise drawn from a ``torch.Generator`` seeded with ``seed`` (on the
    CPU, then copied). The draws are not ``jax.random``'s."""
    dev = resolve_device(cfg.device)
    gen = torch.Generator().manual_seed(seed)
    u = torch.ones(cfg.shape, dtype=torch.float32)
    v = torch.zeros(cfg.shape, dtype=torch.float32)
    sl = tuple(slice(s // 2 - max(s // 16, 2), s // 2 + max(s // 16, 2))
               for s in cfg.shape)
    u[sl] = 0.5
    v[sl] = 0.25
    noise = 0.05 * torch.rand(cfg.shape, generator=gen, dtype=torch.float32)
    return (u - noise).to(dev), v.to(dev)


def run(cfg: GSConfig, n_steps: int, seed: int = 0):
    """``n_steps`` plain steps from :func:`init_fields`; returns
    ``(u, v)``."""
    u, v = init_fields(cfg, seed)
    for _ in range(n_steps):
        u, v = gs_step(u, v, cfg)
    return u, v


def run_distributed(cfg: GSConfig, n_steps: int, mesh=None,
                    axis_name="shards", seed: int = 0):
    """The slab-distributed run, as each rank calls it: both fields live
    as ``grid.DistributedField`` slab blocks (leading axis, halo 1) and
    step by ``grid.make_field_step`` over :func:`gs_step_padded`. Returns
    the full ``(u, v)`` (the blocks gathered) on every rank. ``mesh=None``
    builds a 1-D mesh over every rank (``runtime.make_mesh`` on
    ``cfg.device``'s type)."""
    if mesh is None:
        mesh = RT.make_mesh((RT.device_count(),), (axis_name,),
                            device_type=resolve_device(cfg.device).type)
    step = G.make_field_step(mesh, axis_name, gs_step_padded(cfg), halo=1,
                             periodic=True)
    u, v = init_fields(cfg, seed)
    fu = G.distribute_field(u, mesh, axis_name)
    fv = G.distribute_field(v, mesh, axis_name)
    for _ in range(n_steps):
        fu, fv = step(fu, fv)
    return (G.gather_field(fu, mesh, axis_name),
            G.gather_field(fv, mesh, axis_name))


def pattern_energy(v) -> float:
    """Non-uniformity metric: the population std of v (0 for homogeneous
    steady states), as ``jnp.std``."""
    return float(torch.std(v, correction=0))
