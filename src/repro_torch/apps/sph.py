"""Weakly-compressible SPH dam break (port of ``repro.apps.sph``; paper
§4.2) — DualSPHysics-equivalent formulation: cubic-spline kernel, Tait
equation of state (γ=7, c_sound coefficient 20), Monaghan artificial
viscosity, dynamic boundary particles, Verlet time stepping with dynamic
time-step (CFL + force criteria).

The app is a thin physics spec for the simulation layer: the fused
continuity+momentum physics is one pair body (:class:`SPHPairBody`), the
integrator is the ``finish`` hook (:func:`physics`).

``SPHConfig.device`` (default ``"cuda"``) is where
:func:`init_dam_break` and :func:`run` put the state;
``SPHConfig.backend="auto"`` runs the pair pass through the CUDA
cell-pair kernel's SPH functor on the card and through the plain PyTorch
path on the CPU, in every precision (``"fp32"``, ``"bf16x"``,
``"bf16x:drho"``).
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

FLUID, BOUND = 0, 1


@dataclasses.dataclass(frozen=True)
class SPHConfig:
    dim: int = 2
    dp: float = 0.02                 # particle spacing
    rho0: float = 1000.0
    gamma: float = 7.0
    cs_coef: float = 20.0            # c = cs_coef * sqrt(g * h_swl)
    alpha: float = 0.02              # artificial viscosity
    eta2: float = 1e-6
    g: float = 9.81
    cfl: float = 0.2
    box: Tuple[float, ...] = (1.6, 0.8)
    fluid: Tuple[float, ...] = (0.4, 0.4)    # dam column extents
    cell_cap: int = 64
    verlet_reset: int = 40
    backend: str = "auto"              # "auto" | "torch" | "cuda" pair engine
    precision: str = "fp32"            # pair-engine mode: "fp32" | "bf16x"
    #                                    | "bf16x:drho" — the per-output form
    #                                    runs the density summation (drho)
    #                                    mixed-precision while the Tait-EOS
    #                                    force pass (a) keeps full fp32
    device: str = "cuda"               # where init_dam_break / run put state

    @property
    def h(self) -> float:
        return float(np.sqrt(self.dim) * self.dp)

    @property
    def r_cut(self) -> float:
        return 2.0 * self.h

    @property
    def h_swl(self) -> float:
        return self.fluid[-1]

    @property
    def c_sound(self) -> float:
        return self.cs_coef * float(np.sqrt(self.g * self.h_swl))

    @property
    def b_eos(self) -> float:
        return self.c_sound ** 2 * self.rho0 / self.gamma

    @property
    def mass(self) -> float:
        return self.rho0 * self.dp ** self.dim


def kernel_consts(cfg: SPHConfig):
    h = cfg.h
    if cfg.dim == 2:
        alpha_d = 10.0 / (7.0 * np.pi * h * h)
    else:
        alpha_d = 1.0 / (np.pi * h ** 3)
    return h, float(alpha_d)


def eos(rho, cfg: SPHConfig):
    """Tait pressure ``b_eos·((ρ/ρ0)^γ − 1)``. In fp32 ρ/ρ0 is taken as
    ρ·(1/ρ0), which rounds alike on every device (PyTorch divides by a
    Python number as a true division on the CPU and as a product with the
    reciprocal on the card); in bf16 the constants are rounded first, as
    in ``repro`` (:func:`~repro_torch.core.interactions.weak`). The CUDA
    functor does the same."""
    return I.weak(cfg.b_eos, rho) * (
        torch.pow(I.div_scalar(rho, cfg.rho0), cfg.gamma) - 1.0)


@dataclasses.dataclass(frozen=True)
class SPHPairBody:
    """Fused momentum + continuity pair body (cell-pair engine protocol):
    one cubic-spline gradient evaluation feeds both the acceleration
    (radial ``a``) and dρ/dt (scalar ``drho``). Called, it is the plain
    PyTorch body; ``cuda_kind``/``cuda_params`` select the SPH functor of
    ``kernels/cell_pair/csrc/cell_pair.cu``, which repeats these
    operations in this order. In fp32, constants that ``repro`` divides
    by are multiplied as reciprocals, so the two paths round alike; in
    bf16 every constant is rounded to bf16 and divided by as ``repro``
    does (:func:`~repro_torch.core.interactions.div_scalar`)."""

    cfg: SPHConfig
    cuda_kind = "sph"

    @property
    def cuda_params(self):
        """The SPH functor's fields, in its order."""
        cfg = self.cfg
        h, alpha_d = kernel_consts(cfg)
        return (h, 1.0 / h, alpha_d, -0.75 * alpha_d, cfg.rho0,
                1.0 / cfg.rho0, cfg.gamma, cfg.b_eos, cfg.eta2,
                -cfg.alpha * cfg.c_sound, -cfg.mass, cfg.mass)

    def __call__(self, dx, r2, ok, wi, wj):
        cfg = self.cfg
        h, alpha_d = kernel_consts(cfg)
        m = cfg.mass
        w = lambda c: I.weak(c, r2)
        r = torch.sqrt(torch.clamp(r2, min=1e-12))
        q = I.div_scalar(r, h)
        w1 = w(alpha_d) * (-3.0 * q + 2.25 * q * q)
        s = 2.0 - q
        w2 = w(-0.75 * alpha_d) * (s * s)
        dwdq = torch.where(q <= 1.0, w1, torch.where(
            q <= 2.0, w2, torch.zeros_like(w2)))
        gw_over_r = dwdq / (w(h) * r)             # gradW = gw_over_r · dx
        rho_i, rho_j = wi["rho"], wj["rho"]
        P_i, P_j = eos(rho_i, cfg), eos(rho_j, cfg)
        vr = (wi["v"][..., 0] - wj["v"][..., 0]) * dx(0)   # (v_i - v_j)·dx
        for d in range(1, cfg.dim):
            vr = vr + (wi["v"][..., d] - wj["v"][..., d]) * dx(d)
        # artificial viscosity (approaching pairs only)
        mu = w(h) * vr / (r2 + w(cfg.eta2))
        rho_bar = 0.5 * (rho_i + rho_j)
        visc = w(-cfg.alpha * cfg.c_sound) * mu / rho_bar
        pi_visc = torch.where(vr < 0.0, visc, torch.zeros_like(visc))
        coef = P_i / torch.clamp(rho_i * rho_i, min=1e-6) \
            + P_j / torch.clamp(rho_j * rho_j, min=1e-6) + pi_visc
        return {"a": I.Radial(w(-m) * coef * gw_over_r),
                "drho": w(m) * vr * gw_over_r}


def sph_pair_body(cfg: SPHConfig) -> SPHPairBody:
    """Fused momentum + continuity pair body (cell-pair engine protocol)."""
    return SPHPairBody(cfg)


def sph_kernel_factory(cfg: SPHConfig):
    """``kernel(dx, r2, wi, wj) -> {"a", "drho"}`` derived from the same
    pair body the engine runs (single-source physics)."""
    return I.as_torch_kernel(sph_pair_body(cfg),
                             {"a": "radial", "drho": "scalar"}, cfg.r_cut)


def _grav(cfg: SPHConfig, device) -> torch.Tensor:
    return const_tensor((0.0,) * (cfg.dim - 1) + (-cfg.g,), torch.float32,
                        device)


def physics(cfg: SPHConfig) -> SIM.PhysicsSpec:
    """SPH as a simulation-layer spec. No ``advance`` (rates come first);
    ``finish`` is the DualSPHysics Verlet scheme with the global dynamic
    dt (``red.max`` is the identity serially). ``extras["euler"]`` (a
    Python bool or a 0-d bool tensor; ``(B,)`` rows in a fleet) selects
    the periodic Euler stabilization step."""
    dim = cfg.dim
    lo = (0.0,) * dim
    hi = tuple(float(b) for b in cfg.box)

    def finish(ctx):
        ps, red = ctx.ps, ctx.red
        n = ps.capacity
        fluid = ps.props["kind"] == FLUID
        fl = fluid[:, None]
        a = torch.where(fl, ctx.pair["a"][:n] + _grav(cfg, ps.device),
                        torch.zeros_like(ps.x))
        drho = ctx.pair["drho"][:n]
        a_norm = torch.sqrt((a * a).sum(-1))
        amax = red.max(torch.where(ps.valid, a_norm,
                                   torch.zeros_like(a_norm)).max())
        dt = cfg.cfl * torch.clamp(
            torch.sqrt(torch.full_like(amax, cfg.h)
                       / torch.clamp(amax, min=1e-6)),
            max=cfg.h / cfg.c_sound)
        v, v_prev = ps.props["v"], ps.props["v_prev"]
        rho, rho_prev = ps.props["rho"], ps.props["rho_prev"]
        # a select, as repro's jnp.where: per member under the fleet's
        # vmap, and no host read of a device flag
        euler = ctx.extras["euler"]
        if not isinstance(euler, torch.Tensor):
            euler = const_tensor(bool(euler), torch.bool, ps.device)
        v_new = torch.where(euler, v + dt * a, v_prev + 2.0 * dt * a)
        rho_new = torch.where(euler, rho + dt * drho,
                              rho_prev + 2.0 * dt * drho)
        step = dt * v + 0.5 * dt * dt * a
        x_new = ps.x + torch.where(fl, step, torch.zeros_like(step))
        # clamp into box (boundary-penetration guard)
        eps = cfg.dp * 0.5
        x_new = torch.minimum(torch.clamp(x_new, min=eps), const_tensor(
            hi, torch.float32, ps.device) - eps)
        rho_new = torch.clamp(rho_new, min=0.9 * cfg.rho0)  # DualSPHysics
        vm = ps.valid[:, None]
        zero = torch.zeros_like(v)
        ps = ps.replace(x=torch.where(vm, x_new, ps.x))
        ps = ps.with_prop("v", torch.where(fl & vm, v_new, zero))
        ps = ps.with_prop("v_prev", v)
        ps = ps.with_prop("rho", torch.where(ps.valid, rho_new, rho))
        ps = ps.with_prop("rho_prev", rho)
        ps = ps.with_prop("a", a).with_prop("drho", drho)
        load = red.gather(ps.valid.sum())
        return ps, {"dt": dt, "load": load}, 0

    return SIM.PhysicsSpec(
        name="sph", box_lo=lo, box_hi=hi, periodic=(False,) * dim,
        r_cut=cfg.r_cut, cell_cap=cfg.cell_cap,
        pair_out={"a": "radial", "drho": "scalar"},
        make_body=lambda: sph_pair_body(cfg),
        pair_props=("v", "rho"),
        ghost_props=("v", "rho", "kind"),   # property-subset ghost_get
        advance=None, finish=finish,
        backend=cfg.backend, precision=cfg.precision,
        bucket_cap=2048, ghost_cap=2048)


# --------------------------------------------------------------------------
# Geometry
# --------------------------------------------------------------------------

def init_dam_break(cfg: SPHConfig, capacity_factor: float = 1.4,
                   device=None) -> P.ParticleSet:
    """Fluid column against the left wall + 3-layer dynamic boundary walls,
    on ``device`` (default ``cfg.device``). The lattice is built in float64
    numpy and cast, so it matches ``repro``'s bitwise."""
    dev = P.resolve_device(cfg.device if device is None else device)
    dp = cfg.dp
    dim = cfg.dim
    box = np.asarray(cfg.box)
    pts, kinds = [], []

    def lattice(lo, hi):
        axes = [np.arange(lo[d] + dp / 2, hi[d], dp) for d in range(dim)]
        g = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, dim)
        return g

    fl = lattice(np.zeros(dim) + 3 * dp, np.asarray(cfg.fluid) + 3 * dp)
    pts.append(fl)
    kinds.append(np.zeros(len(fl), np.int32))

    # dynamic boundary: 3 staggered layers on the floor and side walls
    # (open top). The fluid sits 3dp above the floor layers.
    wall = []
    for layer in range(3):
        off = (2.5 - layer) * dp  # layers at 2.5dp, 1.5dp, 0.5dp
        if dim == 2:
            xs = np.arange(dp / 2, box[0], dp)
            wall.append(np.stack([xs, np.full_like(xs, off)], -1))  # floor
            ys = np.arange(3 * dp, box[1], dp)
            wall.append(np.stack([np.full_like(ys, off), ys], -1))  # left
            wall.append(np.stack([np.full_like(ys, box[0] - off), ys], -1))
        else:
            xs = np.arange(dp / 2, box[0], dp)
            ys = np.arange(dp / 2, box[1], dp)
            X, Y = np.meshgrid(xs, ys, indexing="ij")
            wall.append(np.stack(
                [X.ravel(), Y.ravel(), np.full(X.size, off)], -1))  # floor
            zs = np.arange(3 * dp, box[2], dp)
            Yw, Zw = np.meshgrid(ys, zs, indexing="ij")
            wall.append(np.stack(
                [np.full(Yw.size, off), Yw.ravel(), Zw.ravel()], -1))
            wall.append(np.stack(
                [np.full(Yw.size, box[0] - off), Yw.ravel(), Zw.ravel()], -1))
            Xw, Zw = np.meshgrid(xs, zs, indexing="ij")
            wall.append(np.stack(
                [Xw.ravel(), np.full(Xw.size, off), Zw.ravel()], -1))
            wall.append(np.stack(
                [Xw.ravel(), np.full(Xw.size, box[1] - off), Zw.ravel()], -1))
    wb = np.concatenate(wall, axis=0)
    pts.append(wb)
    kinds.append(np.ones(len(wb), np.int32))

    x = np.concatenate(pts, axis=0)
    kind = np.concatenate(kinds, axis=0)
    n = len(x)
    cap = int(n * capacity_factor)
    f32 = dict(dtype=torch.float32, device=dev)
    return P.from_positions(
        torch.from_numpy(x).to(torch.float32).to(dev), capacity=cap,
        props={
            "v": torch.zeros((n, dim), **f32),
            "v_prev": torch.zeros((n, dim), **f32),
            "rho": torch.full((n,), cfg.rho0, **f32),
            "rho_prev": torch.full((n,), cfg.rho0, **f32),
            "kind": torch.from_numpy(kind).to(dev),
            "a": torch.zeros((n, dim), **f32),
            "drho": torch.zeros((n,), **f32),
        })


def _cl_kw(cfg: SPHConfig):
    lo = (0.0,) * cfg.dim
    hi = tuple(float(b) for b in cfg.box)
    gs = CL.grid_shape_for(lo, hi, cfg.r_cut)
    return dict(box_lo=lo, box_hi=hi, grid_shape=gs,
                periodic=(False,) * cfg.dim, cell_cap=cfg.cell_cap)


def compute_rates(ps: P.ParticleSet, cfg: SPHConfig):
    """(accelerations with gravity on fluid particles, dρ/dt, cell-list
    overflow) of one pair pass on ``cfg.backend``."""
    cl = CL.build_cell_list(ps, **_cl_kw(cfg))
    out = I.apply_pair_kernel(ps, cl, sph_pair_body(cfg),
                              out={"a": "radial", "drho": "scalar"},
                              r_cut=cfg.r_cut, prop_names=("v", "rho"),
                              backend=cfg.backend, precision=cfg.precision)
    fluid = ps.props["kind"] == FLUID
    a = torch.where(fluid[:, None], out["a"] + _grav(cfg, ps.device),
                    torch.zeros_like(out["a"]))
    return a, out["drho"], cl.overflow


def sph_step(ps: P.ParticleSet, cfg: SPHConfig, euler: bool = False):
    """Verlet step with dynamic dt (DualSPHysics scheme) through the
    engine's serial path; ``euler=True`` is the periodic stabilization
    step. Returns (ps, dt, overflow), dt and overflow 0-d device tensors
    (overflow is ``StepFlags.any()``)."""
    step = SIM.make_sim_step(physics, cfg)
    state, flags, scal = step(SIM.serial_state(ps, physics, cfg),
                              {"euler": bool(euler)})
    return state.ps, scal["dt"], flags.any()


def run(cfg: SPHConfig, n_steps: int, device=None):
    """The serial dam break on ``device`` (default ``cfg.device``): an
    Euler step every ``verlet_reset`` steps, Verlet steps between. Returns
    (ps, simulated time). The time is summed on the device in float64 and
    read once after the loop (``repro`` reads each step's dt); so are the
    step flags, and a nonzero flag raises RuntimeError then."""
    ps = init_dam_break(cfg, device=device)
    t = torch.zeros((), dtype=torch.float64, device=ps.device)
    worst = torch.zeros((), dtype=torch.int32, device=ps.device)
    for i in range(n_steps):
        ps, dt, overflow = sph_step(ps, cfg,
                                    euler=(i % cfg.verlet_reset == 0))
        t = t + dt.to(torch.float64)
        worst = torch.maximum(worst, overflow)
    if int(worst) != 0:
        raise RuntimeError(
            f"capacity overflow during sph.run (worst flag {int(worst)}); "
            "raise SPHConfig.cell_cap")
    return ps, float(t)


def run_distributed(cfg: SPHConfig, n_steps: int, mesh, ndev: int,
                    cap_factor: float = 3.0, axis_name: str = "shards",
                    use_sar: bool = True, imb_threshold: float = 0.3,
                    min_rebalance_gap: int = 10, _make_step=None,
                    reuse=None, skin=None, ghost_cap=None):
    """The distributed dam break with dynamic load balancing (``repro``'s
    driver of the paper's Table 3), as each rank calls it on ``cfg.device``.
    Returns (ps, t, n_rebalances, imbalance trace); ``ps`` is this rank's
    block (``convert.gather_dist_state`` joins the blocks).

    Rebalance trigger = SAR (degrading balance) OR the imbalance threshold
    (paper §3.5: 'automatically determined using SAR or specified by the
    user program'; SAR alone cannot fire on a constant imbalance). SAR
    runs on every rank, so its inputs must be the same on every rank: the
    load is gathered by the step, and the step's wall time is its ``pmax``
    over the ranks (one 0-d collective a step, only with ``use_sar``);
    a rank-local wall time would let one rank rebalance (a psum and an
    all_to_all) while another steps on.

    The split-phase window flag (``StepFlags.window``) is acted on: when
    DLB skews a slab past the step's interior row window, the window grows
    by the reported excess, the step is rebuilt and REDONE from the
    pre-step state, and a RuntimeError is raised at the grid's row count.
    ``_make_step`` is the step factory ``make_step(interior_rows) ->
    step`` (injectable, to test the control loop without a real skew).

    ``reuse``/``skin`` select the skin-amortized two-speed step (DESIGN.md
    §14): the state rides as ``SIM.ReuseState``, and a rebalance re-wraps
    it cold (moved slab bounds invalidate the cached ghost slots). The
    rebalance floors the slabs at the step's ghost band over its hops
    (``r_cut + skin`` under reuse), so it never moves the decomposition
    into ghost-contract violation. ``ghost_cap`` overrides the spec's
    per-side ghost capacity (2048; a large tank needs more), as
    ``make_sim_step``'s does."""
    import time
    from repro_torch.core import dlb
    from repro_torch.core import runtime as RT
    ps0 = init_dam_break(cfg, capacity_factor=1.05)
    state = SIM.distribute(ps0, physics, cfg, mesh, axis_name=axis_name,
                           cap_factor=cap_factor)
    del ps0
    dev = state.ps.device
    spec = physics(cfg)
    use_reuse = reuse is not None
    skin_v = SIM._resolve_skin(spec, skin) if use_reuse else 0.0
    n_rows = int(SIM._grid_kw(spec, (0,), skin=skin_v)["grid_shape"][0])
    w_int = min(n_rows, -(-n_rows // ndev) + 4)   # the step's default
    make_step = _make_step or (lambda w: SIM.make_sim_step(
        physics, cfg, mesh, axis_name=axis_name, interior_rows=w,
        reuse=reuse, skin=skin, ghost_cap=ghost_cap))
    step = make_step(w_int)
    # the rebalance keeps every slab as wide as the step's ghost band
    # needs at its hop count: r_cut, or r_cut + skin under reuse (repro
    # floors the slabs at r_cut either way, which the reuse step's band
    # flags as ghost_contract)
    r_band = float(spec.r_cut) + skin_v
    box_len = float(spec.box_hi[0]) - float(spec.box_lo[0])
    hops = SIM._auto_hops(r_band, box_len, ndev)
    rebalance = SIM.make_rebalance(physics, cfg, mesh, axis_name=axis_name,
                                   min_slab_width=r_band * 1.001 / hops)
    sar = dlb.SARController(rebalance_cost=0.02)

    def wrap(inner):
        return (SIM.reuse_state(inner, physics, cfg, mesh,
                                axis_name=axis_name, skin=skin,
                                ghost_cap=ghost_cap)
                if use_reuse else inner)

    state = wrap(state)
    t = 0.0
    n_reb = 0
    last_reb = -10**9
    imb_trace = []
    for i in range(n_steps):
        t0 = time.perf_counter()
        extras = {"euler": i % cfg.verlet_reset == 0}
        new_state, flags, scal = step(state, extras)
        while int(flags.window) > 0:
            grown = min(n_rows, w_int + int(flags.window))
            if grown == w_int:
                raise RuntimeError(
                    f"interior window overflow persists at the geometric "
                    f"ceiling interior_rows={w_int} (grid rows {n_rows})")
            w_int = grown
            step = make_step(w_int)
            new_state, flags, scal = step(state, extras)  # redo, pre-step
        state = new_state
        if int(flags.any()) != 0:
            bad = {f.name: int(getattr(flags, f.name))
                   for f in dataclasses.fields(flags) if f.name != "stale"}
            raise RuntimeError(
                f"capacity overflow at step {i} ({bad}); raise "
                "SPHConfig.cell_cap or the mesh capacities")
        t += float(scal["dt"])
        load = scal["load"].cpu().numpy().astype(np.float64)
        imb = float(load.max() / max(load.mean(), 1.0) - 1.0)
        imb_trace.append(imb)
        fire_sar = False
        if use_sar:
            wall = time.perf_counter() - t0
            with RT.on_mesh(mesh):
                wall = float(RT.pmax(torch.full(
                    (), wall, dtype=torch.float64, device=dev), axis_name))
            # SAR: imbalance-cost proxy = step wall time × imbalance
            fire_sar = sar.observe(wall * (1 + imb), wall)
        fire_thr = (imb > imb_threshold
                    and i - last_reb >= min_rebalance_gap)
        if fire_sar or fire_thr:
            inner, ovf = rebalance(state.inner if use_reuse else state)
            if int(ovf) != 0:
                raise RuntimeError(
                    f"map() overflow {int(ovf)} in the rebalance after step "
                    f"{i}; raise the bucket or slot capacity")
            # re-wrap cold: new bounds invalidate the cached structure
            state = wrap(inner)
            n_reb += 1
            last_reb = i
            sar.reset()
    ps_out = state.inner.ps if use_reuse else state.ps
    return ps_out, t, n_reb, imb_trace
