"""Lennard-Jones molecular dynamics (port of ``repro.apps.md``; paper §4.1,
Listing 4.1).

Particles on a periodic cubic lattice, LJ interactions within r_cut = 3σ,
velocity-Verlet integration, energies for the conservation check. The app
is a thin physics spec for the simulation layer: the LJ pair body
(:func:`lj_pair_body`) plus two integrator hooks (:func:`physics`).

``MDConfig.device`` (default ``"cuda"``) is where :func:`init_particles`
and :func:`run` put the state; ``MDConfig.backend="auto"`` runs the pair
pass through the CUDA cell-pair kernel on the card and through the plain
PyTorch path on the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import cell_list as CL
from repro_torch.core import interactions as I
from repro_torch.core import particles as P
from repro_torch.core import simulation as SIM
from repro_torch.numerics import integrators as TI


@dataclasses.dataclass(frozen=True)
class MDConfig:
    n_per_side: int = 10           # paper: 60 (216k particles)
    sigma: float = 0.1
    epsilon: float = 1.0
    dt: float = 0.0005             # paper Listing 4.1
    box: float = 1.0
    cell_cap: int = 48
    capacity_factor: float = 1.3
    dim: int = 3
    backend: str = "auto"          # "auto" | "torch" | "cuda" pair engine
    precision: str = "fp32"        # "fp32" | "bf16x" pair-engine mode
    device: str = "cuda"           # where init_particles / run put state

    @property
    def r_cut(self) -> float:
        return 3.0 * self.sigma

    @property
    def n_particles(self) -> int:
        return self.n_per_side ** self.dim


@dataclasses.dataclass(frozen=True)
class LJPairBody:
    """LJ force pair body (cell-pair engine protocol): F_ij = mag · dx.
    Called, it is the plain PyTorch body; ``cuda_kind``/``cuda_params``
    select the LJ functor of the CUDA kernel (``csrc/cell_pair.cu``)."""

    sigma: float
    epsilon: float
    cuda_kind = "lj"

    @property
    def cuda_params(self):
        """The LJ functor's fields: sigma², 24·epsilon."""
        return (self.sigma * self.sigma, 24.0 * self.epsilon)

    def __call__(self, dx, r2, ok, wi, wj):
        r2s = torch.clamp(r2, min=1e-12)
        # true division (a Python scalar over a tensor would be
        # reciprocal-then-multiply)
        inv = torch.full_like(r2s, self.sigma * self.sigma) / r2s
        inv3 = inv * inv * inv
        mag = I.weak(24.0 * self.epsilon, r2) \
            * (2.0 * inv3 * inv3 - inv3) / r2s
        return {"f": I.Radial(mag)}


def lj_pair_body(sigma: float, epsilon: float) -> LJPairBody:
    """LJ force pair body (cell-pair engine protocol): F_ij = mag · dx."""
    return LJPairBody(float(sigma), float(epsilon))


def physics(cfg: MDConfig) -> SIM.PhysicsSpec:
    """MD as a simulation-layer spec: velocity-Verlet around the LJ pair
    body. ``advance`` is the first kick + drift + periodic wrap;
    ``finish`` stores the new forces and applies the second kick."""
    dim = cfg.dim
    lo, hi = (0.0,) * dim, (cfg.box,) * dim

    def advance(ps, red, extras):
        ps = TI.velocity_verlet_kick(ps, cfg.dt)
        return TI.wrap_periodic(ps, lo, hi, (True,) * dim)

    def finish(ctx):
        ps = ctx.ps
        f = ctx.pair["f"][: ps.capacity]
        ps = ps.with_prop("f", torch.where(ps.valid[:, None], f,
                                           torch.zeros_like(f)))
        ps = TI.velocity_verlet_kick2(ps, cfg.dt)
        return ps, {}, 0

    return SIM.PhysicsSpec(
        name="md", box_lo=lo, box_hi=hi, periodic=(True,) * dim,
        r_cut=cfg.r_cut, cell_cap=cfg.cell_cap,
        pair_out={"f": "radial"},
        make_body=lambda: lj_pair_body(cfg.sigma, cfg.epsilon),
        ghost_props=(),                  # ghosts carry positions only
        finish_writes=("f",),
        advance=advance, finish=finish,
        backend=cfg.backend, precision=cfg.precision,
        bucket_cap=512, ghost_cap=1024)


# --------------------------------------------------------------------------
# Serial-convenience wrappers
# --------------------------------------------------------------------------

def lj_force_kernel(cfg: MDConfig):
    """``kernel(dx, r2, wi, wj) -> force`` from the same pair body."""
    kern = I.as_torch_kernel(lj_pair_body(cfg.sigma, cfg.epsilon),
                             {"f": "radial"}, cfg.r_cut)
    return lambda dx, r2, wi, wj: kern(dx, r2, wi, wj)["f"]


def lj_potential_kernel(cfg: MDConfig):
    s2 = cfg.sigma ** 2
    eps = cfg.epsilon
    rc2 = cfg.r_cut ** 2

    def kern(dx, r2, wi, wj):
        r2s = torch.clamp(r2, min=1e-12)
        inv3 = (torch.full_like(r2s, s2) / r2s) ** 3
        v = 4.0 * eps * (inv3 * inv3 - inv3)
        # half: pairs counted twice
        return torch.where(r2 < rc2, 0.5 * v, torch.zeros_like(v))

    return kern


def init_particles(cfg: MDConfig, capacity: Optional[int] = None,
                   device=None) -> P.ParticleSet:
    """The Listing 4.1 lattice on ``device`` (default ``cfg.device``)."""
    cap = capacity or int(cfg.n_particles * cfg.capacity_factor)
    return P.init_grid((0.0,) * cfg.dim, (cfg.box,) * cfg.dim,
                       (cfg.n_per_side,) * cfg.dim, capacity=cap,
                       prop_specs={"v": ((cfg.dim,), torch.float32),
                                   "f": ((cfg.dim,), torch.float32)},
                       device=cfg.device if device is None else device)


def _cl_kw(cfg: MDConfig):
    gs = CL.grid_shape_for((0.0,) * cfg.dim, (cfg.box,) * cfg.dim, cfg.r_cut)
    return dict(box_lo=(0.0,) * cfg.dim, box_hi=(cfg.box,) * cfg.dim,
                grid_shape=gs, periodic=(True,) * cfg.dim,
                cell_cap=cfg.cell_cap)


def compute_forces(ps: P.ParticleSet, cfg: MDConfig):
    cl = CL.build_cell_list(ps, **_cl_kw(cfg))
    out = I.apply_pair_kernel(ps, cl, lj_pair_body(cfg.sigma, cfg.epsilon),
                              out={"f": "radial"}, r_cut=cfg.r_cut,
                              backend=cfg.backend, precision=cfg.precision)
    return ps.with_prop("f", out["f"]), cl.overflow


def md_step(ps: P.ParticleSet, cfg: MDConfig):
    """One velocity-Verlet step (Listing 4.1 lines 54-73) through the
    engine's serial path. Returns (ps, overflow) with overflow a 0-d
    device tensor (``StepFlags.any()``)."""
    step = SIM.make_sim_step(physics, cfg)
    state, flags, _ = step(SIM.serial_state(ps, physics, cfg), {})
    return state.ps, flags.any()


def energies(ps: P.ParticleSet, cfg: MDConfig):
    """(E_kin, E_pot) as 0-d tensors — a diagnostic for log points,
    evaluated on the plain cell-batched path (as ``repro`` does)."""
    cl = CL.build_cell_list(ps, **_cl_kw(cfg))
    pot = I.apply_kernel_cells(ps, cl, lj_potential_kernel(cfg),
                               r_cut=cfg.r_cut)
    zero = torch.zeros_like(pot)
    e_pot = torch.where(ps.valid, pot, zero).sum()
    v2 = (ps.props["v"] ** 2).sum(-1)
    e_kin = 0.5 * torch.where(ps.valid, v2, torch.zeros_like(v2)).sum()
    return e_kin, e_pot


def run(cfg: MDConfig, n_steps: int, thermal_v: float = 0.0,
        seed: int = 0, log_every: int = 0, reuse=None, skin=None,
        device=None):
    """Single-process driver (the paper's Listing 4.1 main loop) on
    ``device`` (default ``cfg.device``). Returns (ps, log) with log
    entries (step, E_kin, E_pot).

    ``thermal_v > 0`` draws velocities from a seeded CPU
    ``torch.Generator`` (not ``jax.random``'s numbers). ``reuse``/``skin``
    select the skin-amortized engine (DESIGN.md §14,
    ``simulation.make_sim_step``): the cell binning is cached across steps
    and rebuilt only when the tripwire fires — the same trajectory, an
    amortized rebuild. The step flags stay on the device during the loop;
    after it, a nonzero flag raises RuntimeError (a capacity must be
    re-provisioned)."""
    ps = init_particles(cfg, device=device)
    if thermal_v > 0:
        gen = torch.Generator().manual_seed(seed)
        v = thermal_v * torch.randn(tuple(ps.props["v"].shape),
                                    generator=gen)
        v = v.to(ps.device)
        # zero the net momentum over VALID particles only
        vm = ps.valid[:, None]
        vz = torch.where(vm, v, torch.zeros_like(v))
        mean = vz.sum(0, keepdim=True) / ps.count().clamp(min=1)
        ps = ps.with_prop("v", torch.where(vm, v - mean, torch.zeros_like(v)))
    ps, worst = compute_forces(ps, cfg)
    log = []
    if reuse is not None:
        step = SIM.make_sim_step(physics, cfg, reuse=reuse, skin=skin)
        rstate = SIM.reuse_state(SIM.serial_state(ps, physics, cfg),
                                 physics, cfg, skin=skin)
    for i in range(n_steps):
        if reuse is None:
            ps, overflow = md_step(ps, cfg)
        else:
            rstate, flags, _ = step(rstate, {})
            ps, overflow = rstate.inner.ps, flags.any()
        worst = torch.maximum(worst, overflow)
        if log_every and (i % log_every == 0 or i == n_steps - 1):
            ek, ep = energies(ps, cfg)
            log.append((i, float(ek), float(ep)))
    if int(worst) != 0:
        raise RuntimeError(
            f"capacity overflow during md.run (worst flag {int(worst)}); "
            "raise cell_cap or capacity_factor")
    return ps, log
