"""Helpers shared by the tests/test_torch_*.py parity tests: carry a
``repro`` (JAX) particle state into ``repro_torch`` through numpy, pull the
workload states out of benchmarks/backend_compare.py, and measure
divergence the way that module does, build the M'4 interpolation cases
of tests/test_kernels.py from numpy draws, the port's copies of two
test physics: the reuse probe of tests/_reuse_probe.py (which imports
jax) and the toy mesh-field physics of tests/distributed/
test_dist_field.py, and the pair bodies that hold B1's generated route
to integer props, wider props, more outputs and the newer ops (on the
CPU in test_torch_pair_codegen.py, on the card in test_torch_gpu.py).
Imports neither jax nor repro."""
import dataclasses
import inspect
import math
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


# --------------------------------------------------------------------------
# Pair bodies of B1's generated route
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class KABody:
    """The Kob–Andersen 80:20 binary LJ mixture (Kob & Andersen, Phys.
    Rev. E 51, 4626, 1995): a species per particle (its int32 id mod 2, A
    = 0, B = 1), eps and sigma looked up from constant 2 x 2 tables by the
    two species, each pair truncated at 2.5 sigma_ab; ``sigma`` is
    sigma_AA in the box's units."""

    sigma: float
    eps: tuple = ((1.0, 1.5), (1.5, 0.5))
    sig: tuple = ((1.0, 0.8), (0.8, 0.88))

    def tables(self):
        """(eps, sigma_ab^2, (2.5 sigma_ab)^2) as nested tuples."""
        s2 = tuple(tuple((self.sigma * s) ** 2 for s in row)
                   for row in self.sig)
        return self.eps, s2, tuple(tuple(6.25 * v for v in row)
                                   for row in s2)

    def __call__(self, dx, r2, ok, wi, wj):
        si = torch.remainder(wi["species"], 2)
        sj = torch.remainder(wj["species"], 2)
        eps, s2, rc2 = (torch.tensor(t, device=r2.device).to(r2.dtype)[si, sj]
                        for t in self.tables())
        r2s = torch.clamp(r2, min=1e-12)
        inv3 = (s2 / r2s) ** 3
        mag = 24.0 * eps * (2.0 * inv3 * inv3 - inv3) / r2s
        return {"f": TI.Radial(torch.where(r2 < rc2, mag,
                                           torch.zeros_like(mag)))}


@dataclasses.dataclass(frozen=True)
class DSFBody:
    """Damped shifted-force electrostatics (Fennell & Gezelter, J. Chem.
    Phys. 124, 234104, 2006): charges q, damping alpha, cutoff rc; the
    radial force f and the pair energy u (halved: each pair is met from
    both sides)."""

    alpha: float
    rc: float

    def __call__(self, dx, r2, ok, wi, wj):
        a, rc = self.alpha, self.rc
        g0 = 2.0 * a / math.sqrt(math.pi)
        e_rc = math.erfc(a * rc) / rc
        f_rc = (math.erfc(a * rc) / rc + g0 * math.exp(-a * a * rc * rc)) / rc
        qq = wi["q"] * wj["q"]
        r = torch.sqrt(torch.clamp(r2, min=1e-12))
        e = torch.erfc(a * r) / r
        fr = (e + g0 * torch.exp(-(a * a) * r2)) / r - f_rc
        u = e - e_rc + f_rc * (r - rc)
        return {"f": TI.Radial(qq * fr / r), "u": 0.5 * qq * u}


DSF_OUT = {"f": "radial", "u": "scalar"}


@dataclasses.dataclass(frozen=True)
class QuatBody:
    """Five outputs of a width-4 prop: unit quaternions ``q4`` weight a
    Gaussian kernel exp(-k r2) by their alignment (a toy anisotropic
    body). ``dens`` and ``twist`` read single components only, so they
    are the ones a ``bf16x:`` run lowers."""

    k: float

    def __call__(self, dx, r2, ok, wi, wj):
        qi, qj = wi["q4"], wj["q4"]
        w = torch.exp(-self.k * r2)
        dot = (qi * qj).sum(-1)
        return {"f": TI.Radial(w * (1.0 + 0.5 * dot * dot)),
                "align": w * dot * dot, "dens": w,
                "twist": TI.Radial(w * (qi[..., 0] * qj[..., 3]
                                        - qi[..., 3] * qj[..., 0])),
                "spin": w * torch.tanh((qi[..., 1:] * qj[..., 1:]).sum(-1))}


QUAT_OUT = {"f": "radial", "align": "scalar", "dens": "scalar",
            "twist": "radial", "spin": "scalar"}

@dataclasses.dataclass(frozen=True)
class OpsBody:
    """Every op the generator takes on integers and every elementwise
    float op it gained with them, in one body: an int32 prop ``kind``
    through remainder, abs, floor division, the bitwise ops, a comparison
    and where; a 3 x 3 table looked up by two of its values and by one (a
    row per pair), a 5 x 5 one (more entries than a select chain takes);
    and tanh, sin, cos, erf, erfc, log1p, expm1, sigmoid, atan2, floor,
    ceil, round, trunc and sign of the geometry."""

    k: float

    def __call__(self, dx, r2, ok, wi, wj):
        si, sj = wi["kind"], wj["kind"]
        tab = torch.tensor(((0.5, 1.0, 1.5), (2.0, 2.5, 3.0),
                            (3.5, 4.0, 4.5)), device=r2.device).to(r2.dtype)
        big = torch.tensor(tuple(tuple(1.0 + 0.25 * i - 0.125 * j
                                       for j in range(5)) for i in range(5)),
                           device=r2.device).to(r2.dtype)
        a = tab[torch.remainder(si, 3), torch.abs(sj) % 3] \
            + big[torch.remainder(si, 5), torch.remainder(sj, 5)] \
            - tab[torch.remainder(sj, 3)].sum(-1)
        m = (si * 7 - sj) // 3 + (si ^ sj) - (si & 3) + (sj | 1)
        w = torch.where(m > 4, m, -m).to(r2.dtype)
        x = torch.sqrt(r2) * self.k
        s = torch.tanh(x) + torch.sin(x) * torch.cos(x) + torch.erf(x) \
            - torch.erfc(x) + torch.log1p(x) + torch.expm1(-x) \
            + torch.sigmoid(x - 1.0) + torch.atan2(dx(0), dx(1))
        g = torch.floor(4.0 * x) + torch.ceil(4.0 * x) \
            + torch.round(4.0 * x) + torch.trunc(-4.0 * x) + torch.sign(dx(2))
        return {"e": a * s + 0.01 * w, "g": TI.Radial(g * a)}


OPS_OUT = {"e": "scalar", "g": "radial"}


def _stack(*vals):
    """torch.stack of per-pair values (a plain path's props are columns
    beside the pairs' tiles: broadcast first)."""
    return torch.stack(torch.broadcast_tensors(*vals))


#: The elementwise ops that repro's Pallas kernel takes and B1's generated
#: route took last, each as a function of the per-pair values of
#: :class:`NewOpsBody` (r2, dx, u, v, k): well-conditioned there, each
#: continuous in the positions, and the rounding ops' operands (u = 0.7 (m
#: + f) with f in [0.15, 0.85], and v: props alone) a way off every
#: discontinuity.
NEW_OPS = {
    "remainder": lambda r2, dx, u, v, k: torch.remainder(u, v),
    "remainder_s": lambda r2, dx, u, v, k: torch.remainder(u, 0.7),
    "fmod": lambda r2, dx, u, v, k: torch.fmod(u, v),
    "fmod_s": lambda r2, dx, u, v, k: torch.fmod(u, -0.7),
    "floordiv": lambda r2, dx, u, v, k: u // v,
    "floordiv_s": lambda r2, dx, u, v, k: u // 0.7,
    "div_floor_s": lambda r2, dx, u, v, k: torch.div(
        u, -0.7, rounding_mode="floor"),
    "div_trunc": lambda r2, dx, u, v, k: torch.div(u, v,
                                                   rounding_mode="trunc"),
    "div_trunc_s": lambda r2, dx, u, v, k: torch.div(
        u, 0.7, rounding_mode="trunc"),
    "round_2": lambda r2, dx, u, v, k: torch.round(u * v, decimals=2),
    "round_m1": lambda r2, dx, u, v, k: torch.round(3.7 * u, decimals=-1),
    "ipow": lambda r2, dx, u, v, k: (k ** 3 - k ** 2 + k ** 0).to(
        r2.dtype) * 1e-4,
    "hypot": lambda r2, dx, u, v, k: torch.hypot(dx(0), dx(1)),
    "copysign": lambda r2, dx, u, v, k: torch.copysign(r2, u),
    "copysign_s": lambda r2, dx, u, v, k: torch.copysign(r2, -1.0),
    "log2": lambda r2, dx, u, v, k: torch.log2(r2),
    "exp2": lambda r2, dx, u, v, k: torch.exp2(-3.0 * r2),
    "log10": lambda r2, dx, u, v, k: torch.log10(r2),
    "tan": lambda r2, dx, u, v, k: torch.tan(r2),
    "asin": lambda r2, dx, u, v, k: torch.asin(0.9 * r2 - 0.45),
    "acos": lambda r2, dx, u, v, k: torch.acos(0.9 * r2 - 0.45),
    "atan": lambda r2, dx, u, v, k: torch.atan(3.0 * r2),
    "sinh": lambda r2, dx, u, v, k: torch.sinh(2.0 * r2),
    "cosh": lambda r2, dx, u, v, k: torch.cosh(2.0 * r2),
    "asinh": lambda r2, dx, u, v, k: torch.asinh(3.0 * r2 - 1.0),
    "acosh": lambda r2, dx, u, v, k: torch.acosh(1.0 + 3.0 * r2),
    "atanh": lambda r2, dx, u, v, k: torch.atanh(0.9 * r2 - 0.4),
    "lgamma": lambda r2, dx, u, v, k: torch.lgamma(5.0 * r2 + 0.1),
    "amax": lambda r2, dx, u, v, k: _stack(r2, 0.05 * u, 0.5 * v).amax(0),
    "amin": lambda r2, dx, u, v, k: _stack(r2, 0.05 * u, 0.5 * v).amin(0),
    "ssum": lambda r2, dx, u, v, k: _stack(r2, u, v).sum(0),
    "sprod": lambda r2, dx, u, v, k: _stack(r2, u, v).prod(0),
    "maxdim": lambda r2, dx, u, v, k: torch.max(_stack(r2, 0.5 * v),
                                                0).values,
    "iamax": lambda r2, dx, u, v, k: _stack(k, 3 - k).amax(0).to(r2.dtype),
}

#: The NEW_OPS outputs that are exact on both packages (integer results,
#: rounding ops, and remainders of numbers away from their
#: discontinuities), held bit for bit where both compute in fp32.
NEW_OPS_EXACT = ("remainder", "remainder_s", "fmod", "fmod_s", "floordiv",
                 "floordiv_s", "div_floor_s", "div_trunc", "div_trunc_s",
                 "round_2", "round_m1", "ipow", "copysign", "copysign_s",
                 "amax", "amin", "maxdim", "iamax")


@dataclasses.dataclass(frozen=True)
class NewOpsBody:
    """One scalar output per op of ``ops`` (names of :data:`NEW_OPS`) and,
    with ``k_f`` > 0, a soft Gaussian radial force ``f`` = exp2(-k_f r2)
    (2 + 0.01 mean(ops)) that MD can integrate, so that every op moves
    the trajectory; props ``a`` (u, the dividend of the rounding ops),
    ``b`` (v, in [0.5, 1.5]) and the int32 ``k`` (k_i - k_j)."""

    ops: tuple = tuple(NEW_OPS)
    k_f: float = 0.0

    def __call__(self, dx, r2, ok, wi, wj):
        u, v, k = wi["a"], wj["b"], wi["k"] - wj["k"]
        out = {name: NEW_OPS[name](r2, dx, u, v, k) for name in self.ops}
        if self.k_f > 0.0:
            mean = sum(out.values()) * (0.01 / len(out))
            out["f"] = TI.Radial(torch.exp2(-self.k_f * r2) * (2.0 + mean))
        return out

    def out(self) -> dict:
        return {**{name: "scalar" for name in self.ops},
                **({"f": "radial"} if self.k_f > 0.0 else {})}


def new_ops_props(rng, shape):
    """The props of :class:`NewOpsBody` for particles of ``shape``, as
    numpy: a = 0.7 (m + f), m an integer in [-20, 20), f in [0.15, 0.85];
    b in [0.5, 1.5]; k an int32 in [-50, 50)."""
    m = rng.integers(-20, 20, shape)
    return {"a": (0.7 * (m + rng.uniform(0.15, 0.85, shape))).astype(
                np.float32),
            "b": rng.uniform(0.5, 1.5, shape).astype(np.float32),
            "k": rng.integers(-50, 50, shape).astype(np.int32)}
