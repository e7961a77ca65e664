"""Helpers shared by the tests/test_torch_*.py parity tests: carry a
``repro`` (JAX) particle state into ``repro_torch`` through numpy, pull the
workload states out of benchmarks/backend_compare.py, and measure
divergence the way that module does, build the M'4 interpolation cases
of tests/test_kernels.py from numpy draws, and the port's copies of two
test physics: the reuse probe of tests/_reuse_probe.py (which imports
jax) and the toy mesh-field physics of tests/distributed/
test_dist_field.py. Imports neither jax nor repro."""
import dataclasses
import inspect
import pathlib
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from repro_torch import convert  # noqa: E402
from repro_torch.core import interactions as TI  # noqa: E402
from repro_torch.core import interp as TIP  # noqa: E402
from repro_torch.core import simulation as TSIM  # noqa: E402
from repro_torch.core.particles import const_tensor  # noqa: E402


def to_torch(ps_jax, device="cpu"):
    """The port's ParticleSet holding the same state as a JAX one."""
    return convert.particles_from_numpy(
        np.asarray(ps_jax.x), np.asarray(ps_jax.valid),
        {k: np.asarray(v) for k, v in ps_jax.props.items()}, device=device)


def case_state(case):
    """(cfg, ps) of a backend_compare case: the state its jitted ``fn``
    closes over."""
    cfg, fn = case()
    return cfg, inspect.getclosurevars(fn.__wrapped__).nonlocals["ps"]


def np_(a):
    """numpy view of a torch tensor or a JAX array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def rel(a, b):
    """max-abs relative divergence of a against reference b
    (benchmarks/backend_compare.py's ``rel``)."""
    a, b = np_(a).astype(np.float64), np_(b).astype(np.float64)
    return float(np.abs(a - b).max()) / (float(np.abs(b).max()) + 1e-9)


def interp_case(dim, seed, n=400, edge_cluster=False):
    """tests/test_kernels.py::_interp_case with numpy draws: (kw, x, val,
    valid, field) on the (16, 8, 8)[:dim] mesh of a (2, 1, 1) box."""
    shape = (16, 8, 8)[:dim]
    box_hi = np.asarray((2.0, 1.0, 1.0)[:dim], np.float32)
    kw = dict(shape=shape, box_lo=(0.0,) * dim,
              box_hi=tuple(float(v) for v in box_hi), periodic=(True,) * dim)
    rng = np.random.default_rng(seed)
    x = (rng.uniform(size=(n, dim)) * box_hi).astype(np.float32)
    if edge_cluster:
        # hug the box faces so every M'4 stencil wraps
        x = np.mod(x * np.float32(0.04) - np.float32(0.02) * box_hi,
                   box_hi).astype(np.float32)
    val = rng.normal(size=(n, 3)).astype(np.float32)
    valid = rng.uniform(size=n) > 0.2
    field = rng.normal(size=shape + (3,)).astype(np.float32)
    return kw, x, val, valid, field


# --------------------------------------------------------------------------
# The reuse probe (tests/_reuse_probe.py), in the port
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ProbeCfg:
    """tests/_reuse_probe.py's geometry: r_cut RC, a BOX x BOX periodic
    square (the CPU tests check both against that module's)."""

    cell_cap: int = 8
    rc: float = 0.25
    box: float = 4.0


def probe_physics(cfg: ProbeCfg) -> TSIM.PhysicsSpec:
    """Contact-counting probe: advance drifts x by the constant ``u``
    prop, the pair body emits 1 per candidate (the engine keeps only
    ``1e-12 < r2 < rc^2``), finish stores the per-particle sum as ``nc``."""
    def advance(ps, red, extras):
        return ps.replace(x=torch.where(ps.valid[:, None],
                                        ps.x + ps.props["u"], ps.x))

    def finish(ctx):
        ps = ctx.ps
        nc = ctx.pair["nc"][: ps.capacity]
        return ps.with_prop("nc", torch.where(ps.valid, nc,
                                              torch.zeros_like(nc))), {}, 0

    return TSIM.PhysicsSpec(
        name="reuse_probe", box_lo=(0.0, 0.0), box_hi=(cfg.box, cfg.box),
        periodic=(True, True), r_cut=cfg.rc, cell_cap=cfg.cell_cap,
        pair_out={"nc": "scalar"},
        make_body=lambda: lambda dx, r2, ok, wi, wj:
            {"nc": torch.ones_like(r2)},
        advance=advance, finish=finish, bucket_cap=16, ghost_cap=16)


# --------------------------------------------------------------------------
# The toy mesh-field physics (tests/distributed/test_dist_field.py)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ToyCfg:
    """The toy's configuration; ``cell_cap`` 8 (repro's spec has 64) keeps
    the pair pass, whose body is zero, cheap on the CPU. ``kernel=True``
    swaps in bodies the card runs: the pair pass is the LJ functor at
    epsilon 0 (zero forces, through B1) and the deposit goes through
    ``kernels/m4_interp/ops.p2m_block`` (B3)."""

    shape: tuple = (32, 8, 8)
    box: tuple = (8.0, 4.0, 4.0)
    dt: float = 0.08
    diff: float = 0.05
    n: int = 256
    cell_cap: int = 8
    kernel: bool = False
    backend: str = "auto"


def toy_physics(cfg: ToyCfg) -> TSIM.PhysicsSpec:
    """Non-interacting particles drift +x while depositing unit mass onto a
    mesh field that diffuses: the deposit needs ghost_put, the diffusion
    ghost_get."""
    from repro_torch.apps import md as TMD
    from repro_torch.kernels.m4_interp import ops as TM4
    kw = dict(shape=cfg.shape, box_lo=(0.0, 0.0, 0.0), box_hi=cfg.box,
              periodic=(True, True, True))
    H = 2

    def body(dx, r2, ok, wi, wj):
        return {"f": TI.Radial(torch.zeros_like(r2))}

    def advance(ps, red, extras):
        L = const_tensor(tuple(cfg.box), ps.x.dtype, ps.device)
        step = const_tensor((cfg.dt, 0.0, 0.0), ps.x.dtype, ps.device)
        x = torch.remainder(ps.x + step, L)
        return ps.replace(x=torch.where(ps.valid[:, None], x, ps.x))

    def finish(ctx):
        rho = ctx.fields["rho"]
        n_local = rho.shape[0]
        row0 = ctx.grid.first_row(n_local) - H
        mass = ctx.ps.valid.to(torch.float32)
        if cfg.kernel:
            blk, drop = TM4.p2m_block(ctx.ps.x, mass, ctx.ps.valid, row0,
                                      block_rows=n_local + 2 * H,
                                      backend=cfg.backend, **kw)
        else:
            blk, drop = TIP.p2m_block(ctx.ps.x, mass, ctx.ps.valid, row0,
                                      block_rows=n_local + 2 * H, **kw)
        deposit = ctx.grid.ghost_put(blk, H)
        pad = ctx.grid.ghost_get(rho, 1)
        lap = (torch.roll(pad, 1, 0) + torch.roll(pad, -1, 0)
               - 2 * pad)[1:-1]
        rho = rho + cfg.diff * lap + deposit
        return ctx.ps, {}, ctx.red.max(drop), {"rho": rho}

    make_body = ((lambda: TMD.lj_pair_body(0.1, 0.0)) if cfg.kernel
                 else (lambda: body))
    return TSIM.PhysicsSpec(
        name="toy_mesh", box_lo=(0.0, 0.0, 0.0), box_hi=cfg.box,
        periodic=(True, True, True), r_cut=0.5, cell_cap=cfg.cell_cap,
        pair_out={"f": "radial"}, make_body=make_body,
        advance=advance, finish=finish, backend=cfg.backend,
        mesh_props=("rho",))
