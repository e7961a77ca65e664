"""Discrete Element Method: granular avalanche down an incline (port of
``repro.apps.dem``; paper §4.5).

Silbert grain model: Hertzian normal/tangential contact forces with
elastic tangential displacement history per contact, Coulomb rescaling,
leapfrog integration (paper eq. 9-13). The inclination is applied by
rotating the gravity vector (30°); x has fixed walls, y is periodic, +z
is free space.

The app is a thin physics spec for the simulation layer. The Hertzian
normal forces run through the cell-pair engine (:class:`DEMNormalBody`:
the CUDA kernel's DEM functor on the card, the plain PyTorch body on the
CPU); the history-dependent tangential pass stays on the contact list
inside the ``finish`` hook. The springs are per-particle fields
(``ct_id``: partner particle ids, ``ct_ut``: tangential displacements),
carried across list rebuilds by partner-id matching.

``DEMConfig.device`` (default ``"cuda"``) is where :func:`init_block` and
:func:`run` put the state. Units: k_n = 7.849e4 (the Walther & Sbalzarini
2009 magnitudes), as in ``repro``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.core import cell_list as CL
from repro_torch.core import interactions as I
from repro_torch.core import particles as P
from repro_torch.core import simulation as SIM
from repro_torch.core.particles import const_tensor


@dataclasses.dataclass(frozen=True)
class DEMConfig:
    R: float = 0.06
    m: float = 1.0
    inertia: float = 1.44e-3
    kn: float = 7.849e4
    kt: float = 2.243e4
    gamma_n: float = 34.01
    gamma_t: float = 17.0
    mu: float = 0.5
    g: float = 9.81
    incline_deg: float = 30.0
    box: Tuple[float, float, float] = (8.4, 3.0, 3.18)
    fill: Tuple[float, float, float] = (4.26, 3.06, 1.26)
    dt: float = 2e-4
    k_max: int = 12
    cell_cap: int = 24
    skin: float = 0.02
    backend: str = "auto"              # "auto" | "torch" | "cuda" normal pass
    precision: str = "fp32"            # "fp32" | "bf16x" pair-engine mode
    device: str = "cuda"               # where init_block / run put state

    @property
    def r_cut(self) -> float:
        return 2.0 * self.R + self.skin

    @property
    def k_full(self) -> int:
        """Contact slots of the full neighbor list (each pair listed on
        both rows): twice the half-list budget."""
        return 2 * self.k_max


def init_block(cfg: DEMConfig, capacity_factor: float = 1.3,
               device=None) -> P.ParticleSet:
    """A block of grains on a lattice resting just above the floor, on
    ``device`` (default ``cfg.device``); float64 numpy, then cast, so it
    matches ``repro``'s bitwise."""
    dev = P.resolve_device(cfg.device if device is None else device)
    dp = 2.02 * cfg.R
    axes = [np.arange(cfg.R * 1.1, min(f, b) - cfg.R * 0.1, dp)
            for f, b in zip(cfg.fill, cfg.box)]
    x = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    x[:, 2] += cfg.R  # rest just above the floor
    n = len(x)
    cap = int(n * capacity_factor)
    k = cfg.k_full
    f32 = dict(dtype=torch.float32, device=dev)
    ps = P.from_positions(
        torch.from_numpy(x).to(torch.float32).to(dev), capacity=cap,
        props={
            "v": torch.zeros((n, 3), **f32),
            "w": torch.zeros((n, 3), **f32),      # angular velocity
            "f": torch.zeros((n, 3), **f32),
            "t": torch.zeros((n, 3), **f32),      # torque
            # tangential contact springs, keyed by partner id (-1 = empty)
            "ct_id": torch.full((n, k), -1, dtype=torch.int32, device=dev),
            "ct_ut": torch.zeros((n, k, 3), **f32),
        })
    return SIM.with_ids(ps)


def gravity_vec(cfg: DEMConfig, device="cpu") -> torch.Tensor:
    """Gravity rotated by the incline: (g sin θ, 0, −g cos θ), on
    ``device``."""
    th = np.deg2rad(cfg.incline_deg)
    return const_tensor((float(cfg.g * np.sin(th)), 0.0,
                         float(-cfg.g * np.cos(th))), torch.float32,
                        torch.device(device))


@dataclasses.dataclass(frozen=True)
class DEMNormalBody:
    """Hertzian normal contact pair body (cell-pair engine protocol):
    spring + velocity damping, both radial — F_ij = mag · dx. Called, it
    is the plain PyTorch body; ``cuda_kind``/``cuda_params`` select the
    DEM functor of ``kernels/cell_pair/csrc/cell_pair.cu``, which repeats
    these operations in this order (in fp32 ``repro``'s division by 2R
    is a product with 1/(2R), so the two paths round alike; in bf16 the
    constants are rounded first and 2R divides, as in ``repro``)."""

    cfg: DEMConfig
    cuda_kind = "dem"

    @property
    def cuda_params(self):
        """The DEM functor's fields: 2R, 1/(2R), kn, gamma_n·m_eff."""
        cfg = self.cfg
        two_R = 2.0 * cfg.R
        return (two_R, 1.0 / two_R, cfg.kn, cfg.gamma_n * (cfg.m / 2.0))

    def __call__(self, dx, r2, ok, wi, wj):
        cfg = self.cfg
        two_R = 2.0 * cfg.R
        m_eff = cfg.m / 2.0
        w = lambda c: I.weak(c, r2)
        r = torch.sqrt(torch.clamp(r2, min=1e-12))
        delta = w(two_R) - r
        hertz = torch.sqrt(I.div_scalar(torch.clamp(delta, min=0.0),
                                        two_R))
        vr = (wi["v"][..., 0] - wj["v"][..., 0]) * dx(0)   # (v_i - v_j)·dx
        for d in range(1, 3):
            vr = vr + (wi["v"][..., d] - wj["v"][..., d]) * dx(d)
        # Fn = hertz·(kn·δ·n̂ − γn·m_eff·v_n), v_n = ((v_i−v_j)·n̂)n̂,
        # n̂ = dx/r  ⇒  purely radial with this magnitude:
        mag = hertz * (w(cfg.kn) * delta
                       - w(cfg.gamma_n * m_eff) * vr / r) / r
        return {"f": I.Radial(torch.where(delta > 0.0, mag,
                                          torch.zeros_like(mag)))}


def dem_normal_body(cfg: DEMConfig) -> DEMNormalBody:
    """Hertzian normal contact pair body (cell-pair engine protocol)."""
    return DEMNormalBody(cfg)


def _cl_kw(cfg: DEMConfig):
    lo = (0.0, 0.0, 0.0)
    hi = tuple(float(b) for b in cfg.box)
    gs = CL.grid_shape_for(lo, hi, cfg.r_cut)
    return dict(box_lo=lo, box_hi=hi, grid_shape=gs,
                periodic=(False, True, False), cell_cap=cfg.cell_cap)


def normal_forces(ps: P.ParticleSet, cfg: DEMConfig, backend: str = "auto"):
    """Grain-grain normal forces via the cell-pair engine (fresh cell list;
    periodic y handled by the gather's box shifts). Returns (f,
    cell-list overflow)."""
    cl = CL.build_cell_list(ps, **_cl_kw(cfg))
    out = I.apply_pair_kernel(ps, cl, dem_normal_body(cfg),
                              out={"f": "radial"}, r_cut=cfg.r_cut,
                              prop_names=("v",), backend=backend,
                              precision=cfg.precision)
    return out["f"], cl.overflow


def _where(mask, a, b):
    """``a`` where ``mask`` (broadcast over trailing dims), else ``b``."""
    return torch.where(I._bmask(mask, a), a, b)


def tangential_forces(ps: P.ParticleSet, combo: P.ParticleSet,
                      nbr: torch.Tensor, cfg: DEMConfig):
    """History-dependent tangential pass over the full contact list
    (paper eq. 10-12). ``nbr`` indexes ``combo`` (local + ghosts; the
    particles themselves serially); old springs in
    ``ps.props["ct_id"/"ct_ut"]`` are matched to the new list by partner
    id. Returns (F_t, torque, ct_id, ct_ut); the returned spring state is
    aligned with ``nbr``'s slots.

    Also recomputes Fn per listed contact: the Coulomb cap |Ft| ≤ μ|Fn|
    couples the two per contact, so the summed engine output cannot
    supply it."""
    cap_c = combo.capacity
    okj = nbr < cap_c
    j = nbr.clamp(max=cap_c - 1).long()
    xi = ps.masked_x()[:, None, :]
    xj = combo.masked_x()[j]
    # periodic y minimum image (ghosts would arrive unshifted there)
    Ly = cfg.box[1]
    dx = xi - xj
    dy = dx[..., 1] - Ly * torch.round(dx[..., 1] / Ly)
    dx = torch.stack([dx[..., 0], dy, dx[..., 2]], dim=-1)
    r = torch.sqrt((dx * dx).sum(-1))
    delta = 2.0 * cfg.R - r
    touch = okj & (delta > 0.0) & ps.valid[:, None]
    n_hat = dx / torch.clamp(r, min=1e-9)[..., None]

    vi = ps.props["v"][:, None, :]
    vj = combo.props["v"][j]
    wi = ps.props["w"][:, None, :]
    wj = combo.props["w"][j]
    # relative velocity at the contact point
    v_rel = vi - vj - torch.linalg.cross(cfg.R * (wi + wj), n_hat, dim=-1)
    v_n = (v_rel * n_hat).sum(-1, keepdim=True) * n_hat
    v_t = v_rel - v_n

    # carry springs over by partner id, then advance for touching contacts
    # (explicit Euler, paper eq. 10); project into the current tangent
    # plane. The match matrix has at most one 1 per row, so the fp32
    # product copies a spring exactly (TF32 off, PyTorch's default).
    pid = torch.where(okj, combo.props["id"][j], torch.full_like(nbr, -1))
    old_id = ps.props["ct_id"]
    match = (pid[:, :, None] == old_id[:, None, :]) \
        & (old_id[:, None, :] >= 0)
    carried = torch.bmm(match.to(torch.float32), ps.props["ct_ut"])
    u_t = carried + cfg.dt * v_t
    u_t = u_t - (u_t * n_hat).sum(-1, keepdim=True) * n_hat
    hertz = torch.sqrt(torch.clamp(delta, min=0.0)
                       / (2.0 * cfg.R))[..., None]
    m_eff = cfg.m / 2.0
    Fn = hertz * (cfg.kn * delta[..., None] * n_hat
                  - cfg.gamma_n * m_eff * v_n)
    Ft = hertz * (-cfg.kt * u_t - cfg.gamma_t * m_eff * v_t)
    # Coulomb rescaling: |Ft| <= mu |Fn|, rescale u_t too
    fn_mag = torch.sqrt((Fn * Fn).sum(-1, keepdim=True))
    ft_mag = torch.sqrt((Ft * Ft).sum(-1, keepdim=True))
    scale = torch.clamp(cfg.mu * fn_mag / torch.clamp(ft_mag, min=1e-9),
                        max=1.0)
    Ft = Ft * scale
    zero = torch.zeros_like(Ft)
    u_t = _where(touch, u_t * scale, zero)
    F = _where(touch, Ft, zero)
    T = _where(touch, -cfg.R * torch.linalg.cross(n_hat, Ft, dim=-1), zero)
    ct_id = torch.where(touch, pid, torch.full_like(pid, -1))
    return F.sum(1), T.sum(1), ct_id, u_t


def wall_forces(ps: P.ParticleSet, cfg: DEMConfig) -> torch.Tensor:
    """Fixed walls: floor z=0, x=0, x=Lx (paper geometry)."""
    x = ps.x
    v = ps.props["v"]
    cols = [torch.zeros_like(x[:, 0]) for _ in range(3)]
    for axis, pos, sign in ((2, 0.0, +1.0), (0, 0.0, +1.0),
                            (0, cfg.box[0], -1.0)):
        dist = sign * (x[:, axis] - pos)
        delta = cfg.R - dist
        touch = ps.valid & (delta > 0)
        hertz = torch.sqrt(torch.clamp(delta, min=0.0) / (2.0 * cfg.R))
        vn = v[:, axis]
        fmag = hertz * (cfg.kn * delta - sign * cfg.gamma_n * cfg.m / 2 * vn)
        cols[axis] = cols[axis] + torch.where(touch, sign * fmag,
                                              torch.zeros_like(fmag))
    return torch.stack(cols, dim=-1)


CACHE_KEYS = ("ct_nbr", "ct_nn", "ct_xb", "ct_ok")


def empty_contact_cache(ps: P.ParticleSet, cfg: DEMConfig):
    """A not-yet-valid contact-list cache for :func:`make_cached_stepper`
    (``ct_ok=False`` forces a build on the first step)."""
    cap = ps.capacity
    dev = ps.device
    return {"ct_nbr": torch.full((cap, cfg.k_full), cap, dtype=torch.int32,
                                 device=dev),
            "ct_nn": torch.zeros((cap,), dtype=torch.int32, device=dev),
            "ct_xb": ps.x,
            "ct_ok": torch.zeros((), dtype=torch.bool, device=dev)}


def physics(cfg: DEMConfig) -> SIM.PhysicsSpec:
    """DEM as a simulation-layer spec. Normal forces come from the pair
    engine; ``finish`` rebuilds the contact list, runs the
    tangential-history pass (id-matched springs), adds walls and rotated
    gravity, and advances the leapfrog.

    Skin-amortized rebuild: when the caller threads a contact-list cache
    through ``extras`` (:func:`make_cached_stepper`, or the reuse engine's
    ``cache_keys`` protocol, ``make_sim_step(..., reuse="skin")``), the
    rebuild is skipped while no particle moved more than skin/2 since the
    cached build — the cached list (built with ``r_cut = 2R + skin``)
    still covers every touching pair. Under the reuse engine the list is
    also rebuilt when ``"_reuse_slots_stable"`` is False (a slot
    permutation since the cached build); serially it is always True."""
    lo = (0.0, 0.0, 0.0)
    hi = tuple(float(b) for b in cfg.box)

    def contact_list(ctx):
        """(nbr, overflow, cache_out) — cached or rebuilt."""
        ps, combo, cl = ctx.ps, ctx.combo, ctx.cl
        n = ps.capacity
        slots_stable = ctx.extras.get("_reuse_slots_stable")
        # on a mesh, cached combo slots hold only while the slot
        # permutation is frozen (the reuse cadence says so); an every-step
        # distributed step re-maps and re-ghosts, so it rebuilds
        if "ct_nbr" not in ctx.extras or (ctx.red.distributed
                                          and slots_stable is None):
            vl = CL.build_verlet(combo, cl, cfg.r_cut, cfg.k_full,
                                 half=False)
            return vl.nbr[:n], vl.overflow, {}
        stale = (~ctx.extras["ct_ok"]) | CL.moved_beyond(
            ps.x, ctx.extras["ct_xb"], ps.valid, cfg.skin)
        if slots_stable is not None:
            # reuse-engine protocol: a slot permutation invalidates the
            # slot-indexed contacts whatever the drift
            stale = ctx.red.max(stale | ~slots_stable)
        if bool(stale):          # one host read per step
            vl = CL.build_verlet(combo, cl, cfg.r_cut, cfg.k_full,
                                 half=False)
            nbr, n_nbr, x_build = vl.nbr[:n], vl.n_nbr[:n], ps.x
        else:
            nbr, n_nbr, x_build = (ctx.extras["ct_nbr"],
                                   ctx.extras["ct_nn"], ctx.extras["ct_xb"])
        overflow = torch.clamp(n_nbr.max() - cfg.k_full, min=0)
        cache = {"ct_nbr": nbr, "ct_nn": n_nbr, "ct_xb": x_build,
                 "ct_ok": torch.ones((), dtype=torch.bool, device=ps.device)}
        return nbr, overflow, cache

    def finish(ctx):
        ps, combo = ctx.ps, ctx.combo
        n = ps.capacity
        nbr, nb_ovf, cache = contact_list(ctx)
        f_t, torque, ct_id, ct_ut = tangential_forces(ps, combo, nbr, cfg)
        f = (ctx.pair["f"][:n] + f_t + wall_forces(ps, cfg)
             + cfg.m * gravity_vec(cfg, ps.device)[None, :])
        # leapfrog (paper eq. 13)
        v = ps.props["v"] + cfg.dt / cfg.m * f
        x = ps.x + cfg.dt * v
        w = ps.props["w"] + cfg.dt / cfg.inertia * torque
        # periodic wrap in y
        x = torch.stack([x[:, 0], torch.remainder(x[:, 1], cfg.box[1]),
                         x[:, 2]], dim=-1)
        vm = ps.valid[:, None]
        zero = torch.zeros_like(v)
        ps = ps.replace(x=torch.where(vm, x, ps.x))
        ps = ps.with_prop("v", torch.where(vm, v, zero))
        ps = ps.with_prop("w", torch.where(vm, w, zero))
        ps = ps.with_prop("f", f).with_prop("t", torque)
        ps = ps.with_prop("ct_id", ct_id).with_prop("ct_ut", ct_ut)
        return ps, cache, nb_ovf

    return SIM.PhysicsSpec(
        name="dem", box_lo=lo, box_hi=hi,
        periodic=(False, True, False),
        r_cut=cfg.r_cut, cell_cap=cfg.cell_cap,
        pair_out={"f": "radial"},
        make_body=lambda: dem_normal_body(cfg),
        pair_props=("v",),
        ghost_props=("v", "w", "id"),
        advance=None, finish=finish,
        backend=cfg.backend, precision=cfg.precision,
        bucket_cap=512, ghost_cap=1024,
        # reuse-engine declarations: update steps refresh ghost angular
        # velocity too (the tangential pass reads combo "w"), and the
        # contact cache rides across steps
        update_props=("v", "w"),
        cache_keys=CACHE_KEYS, cache_scalars=("ct_ok",),
        cache_example=lambda ps: empty_contact_cache(ps, cfg))


def dem_step(ps: P.ParticleSet, cfg: DEMConfig):
    """One leapfrog step through the engine's serial path. Returns (ps,
    flags) — ``flags.any()`` is nonzero on cell/contact-slot overflow
    (raise ``cell_cap`` / ``k_max``). Rebuilds the contact list every
    step; :func:`make_cached_stepper` amortizes it."""
    step = SIM.make_sim_step(physics, cfg)
    state, flags, _ = step(SIM.serial_state(ps, physics, cfg), {})
    return state.ps, flags


def make_cached_stepper(cfg: DEMConfig):
    """Serial stepper with the skin-amortized contact-list rebuild: the
    contact list is carried across steps and rebuilt only when some
    particle moved more than skin/2 since the cached build. ``repro``
    decides in the graph (``lax.cond``); here the decision is one host
    read of the device flag ``stale`` per step, and only the chosen
    branch runs.

    Returns ``step(ps, cache=None) -> (ps, flags, cache)``; thread the
    returned cache into the next call (``None`` starts cold).
    """
    engine = SIM.make_sim_step(physics, cfg)

    def step(ps: P.ParticleSet, cache=None):
        cache = empty_contact_cache(ps, cfg) if cache is None else cache
        state, flags, scalars = engine(SIM.serial_state(ps, physics, cfg),
                                       cache)
        return state.ps, flags, {k: scalars[k] for k in CACHE_KEYS}

    return step


def run(cfg: DEMConfig, n_steps: int, device=None):
    """The serial avalanche on ``device`` (default ``cfg.device``): a
    rebuild-every-step leapfrog. The step flags stay on the device during
    the loop; after it, a nonzero flag raises RuntimeError (``repro``
    asserts on the host each step)."""
    ps = init_block(cfg, device=device)
    worst = torch.zeros((), dtype=torch.int32, device=ps.device)
    for _ in range(n_steps):
        ps, flags = dem_step(ps, cfg)
        worst = torch.maximum(worst, flags.any())
    if int(worst) != 0:
        raise RuntimeError(
            f"overflow during dem.run (worst flag {int(worst)}); raise "
            "DEMConfig.cell_cap / k_max")
    return ps
