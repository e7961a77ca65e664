"""Time integrators (port of ``repro.numerics.integrators``): velocity
Verlet (MD, paper §4.1), leapfrog (DEM §4.5) and the periodic wrap. Pure
functions over :class:`ParticleSet`; invalid slots are left untouched."""
from __future__ import annotations

import torch

from repro_torch.core.particles import ParticleSet, const_tensor


def velocity_verlet_kick(ps: ParticleSet, dt: float, *, vel="v",
                         force="f", mass: float = 1.0) -> ParticleSet:
    """First half-kick + drift: v += dt/2 * f/m ; x += dt * v."""
    v = ps.props[vel] + 0.5 * dt * ps.props[force] / mass
    x = ps.x + dt * v
    m = ps.valid[:, None]
    return ps.replace(x=torch.where(m, x, ps.x)) \
             .with_prop(vel, torch.where(m, v, ps.props[vel]))


def velocity_verlet_kick2(ps: ParticleSet, dt: float, *, vel="v",
                          force="f", mass: float = 1.0) -> ParticleSet:
    """Second half-kick: v += dt/2 * f/m (after force recomputation)."""
    v = ps.props[vel] + 0.5 * dt * ps.props[force] / mass
    return ps.with_prop(vel, torch.where(ps.valid[:, None], v, ps.props[vel]))


def leapfrog(ps: ParticleSet, dt: float, *, vel="v", force="f",
             mass: float = 1.0) -> ParticleSet:
    """Leapfrog: v^{n+1} = v^n + dt f/m ; x^{n+1} = x^n + dt v^{n+1}."""
    v = ps.props[vel] + dt * ps.props[force] / mass
    x = ps.x + dt * v
    m = ps.valid[:, None]
    return ps.replace(x=torch.where(m, x, ps.x)) \
             .with_prop(vel, torch.where(m, v, ps.props[vel]))


def wrap_periodic(ps: ParticleSet, box_lo, box_hi, periodic) -> ParticleSet:
    """Wrap periodic axes into [lo, hi). ``torch.remainder`` is the
    floored mod with the divisor's sign, the same float32 results as
    ``jnp.mod`` at the box edge (pinned in tests/test_torch_core.py)."""
    lo = const_tensor(tuple(float(v) for v in box_lo), ps.x.dtype, ps.device)
    hi = const_tensor(tuple(float(v) for v in box_hi), ps.x.dtype, ps.device)
    per = const_tensor(tuple(bool(v) for v in periodic), torch.bool,
                       ps.device)
    wrapped = lo + torch.remainder(ps.x - lo, hi - lo)
    x = torch.where(per[None, :], wrapped, ps.x)
    return ps.replace(x=torch.where(ps.valid[:, None], x, ps.x))
