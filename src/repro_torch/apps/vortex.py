"""Hybrid particle-mesh Vortex-in-Cell method (port of the serial part of
``repro.apps.vortex``; paper §4.4, Algorithm 1).

Incompressible Navier-Stokes in vorticity form on a 3D periodic box:
  Dω/Dt = (ω·∇)u + ν∆ω ,   ∆ψ = -ω ,  u = ∇×ψ.

Per step (two-stage RK with remeshing, M'4 interpolations):
  1. solve the vector Poisson equation for ψ (FFT)
  2. u = ∇×ψ; RHS = (ω·∇)u + ν∆ω on the mesh
  3. interpolate u, RHS to particles (M2P, M'4)
  4. move particles / update particle vorticity (RK2)
  5. interpolate vorticity back to the mesh (P2M, M'4) and remesh

``VortexConfig.interp`` selects the M'4 legs of steps 3–5:
``"cells"`` (the default) is the bucketed owner-gather subsystem of
``kernels.m4_interp``, which on CUDA tensors launches the hand-written
P2M and fused M2P kernels (one M2P pass interpolates u AND the RHS);
``"scatter"`` is the ``core.interp`` oracle. They are ``repro``'s
``use_pallas=True`` / ``False``. ``VortexConfig.device`` (default
``"cuda"``) is where :func:`init_ring` and :func:`run` put the field.

:func:`make_distributed_vic_step` and :func:`run_distributed` are the
slab-distributed step over a 1-D device mesh: the field lives in
``grid.DistributedField`` blocks, ψ comes from the slab FFT, the M'4 legs
are the 1-D block legs (``kernels.m4_interp.ops.p2m_block`` /
``m2p_fused_block`` on the cell path, so the CUDA P2M and M2P kernels
run on CUDA tensors; ``core.interp``'s on the scatter path), and
deposits go home by the halo reduce. Over a 2-D ``(rows, cols)`` device
mesh the pencil step shards the field over axes 0 and 1: the pencil FFT,
2-D halos and ``core.interp``'s pencil block legs (plain torch, as
``repro``'s are jnp).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.core import grid as G
from repro_torch.core import interp as IP
from repro_torch.core import remesh as RM
from repro_torch.core import runtime as RT
from repro_torch.core.particles import const_tensor, resolve_device
from repro_torch.numerics import poisson as PS

#: Steps redone by :func:`step_reprovision` after a bucket overflow, in
#: this process.
REDOS = 0


@dataclasses.dataclass(frozen=True)
class VortexConfig:
    shape: Tuple[int, int, int] = (64, 32, 32)   # paper: 1600x400x400
    lengths: Tuple[float, float, float] = (22.0, 5.57, 5.57)
    nu: float = 1.0 / 3750.0                     # Re = 3750 (paper)
    dt: float = 0.0125
    ring_R: float = 1.0
    ring_sigma: float = 1.0 / 3.531
    gamma: float = 1.0
    # particle–mesh interpolation subsystem (steps 3–5)
    interp: str = "cells"             # "cells" (m4_interp) | "scatter"
    backend: str = "auto"             # "auto" | "torch" | "cuda" cell path
    precision: str = "fp32"           # "fp32" | "bf16x" M'4 cell-path mode
    remesh_threshold: float = 0.0     # |ω| node re-seed cutoff (0 = all nodes)
    interp_cb: int = 4                # mesh nodes per interpolation cell/axis
    interp_cell_cap: int = 0          # particle slots per cell (0 = auto)
    device: str = "cuda"              # where init_ring / run put the field
    # distributed step: ghost rows per side of the M2P gather blocks and
    # the P2M deposit blocks (M'4 support needs 2; the rest absorbs a
    # step's advection across the slab face; an outrun is counted)
    mesh_halo: int = 3


def _axes(cfg):
    return [np.arange(n) * (L / n) for n, L in zip(cfg.shape, cfg.lengths)]


def _hs(cfg):
    return [L / n for n, L in zip(cfg.shape, cfg.lengths)]


def init_ring(cfg: VortexConfig) -> torch.Tensor:
    """Paper eq. (8): ω0 = Γ/(πσ²) exp(-s/σ) ring around the long axis,
    centred in the transverse plane, on ``cfg.device``. Built in float64
    numpy and cast, so it equals ``repro``'s bitwise."""
    dev = resolve_device(cfg.device)
    ax = _axes(cfg)
    Z, X, Y = np.meshgrid(*ax, indexing="ij")  # axis 0 is the long axis
    zc = cfg.lengths[0] * 0.25
    xc = cfg.lengths[1] / 2
    yc = cfg.lengths[2] / 2
    rho = np.sqrt((X - xc) ** 2 + (Y - yc) ** 2)
    s2 = (Z - zc) ** 2 + (rho - cfg.ring_R) ** 2
    mag = cfg.gamma / (np.pi * cfg.ring_sigma ** 2) * np.exp(
        -s2 / cfg.ring_sigma ** 2)
    denom = np.maximum(rho, 1e-9)
    tx = -(Y - yc) / denom
    ty = (X - xc) / denom
    w = np.stack([np.zeros_like(mag), mag * tx, mag * ty], axis=-1)
    return torch.from_numpy(w.astype(np.float32)).to(dev)


def _d(field, axis, h):
    return (torch.roll(field, -1, dims=axis) - torch.roll(field, 1, dims=axis)
            ) / (2.0 * h)


def curl(f, hs):
    """f: (..., 3) -> ∇×f with periodic central differences."""
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    cx = _d(fz, 1, hs[1]) - _d(fy, 2, hs[2])
    cy = _d(fx, 2, hs[2]) - _d(fz, 0, hs[0])
    cz = _d(fy, 0, hs[0]) - _d(fx, 1, hs[1])
    return torch.stack([cx, cy, cz], dim=-1)


def divergence(f, hs):
    return sum(_d(f[..., d], d, hs[d]) for d in range(3))


def laplacian_vec(f, hs):
    out = []
    for c in range(3):
        g = f[..., c]
        acc = torch.zeros_like(g)
        for d in range(3):
            acc = acc + (torch.roll(g, -1, dims=d) - 2 * g
                         + torch.roll(g, 1, dims=d)) / hs[d] ** 2
        out.append(acc)
    return torch.stack(out, dim=-1)


def project_divfree(w, cfg: VortexConfig):
    """Helmholtz projection (Algorithm 1 line 3): ω ← ω - ∇(∆⁻¹ ∇·ω)."""
    hs = _hs(cfg)
    phi = PS.fft_poisson(divergence(w, hs), cfg.lengths)
    grad = torch.stack([_d(phi, d, hs[d]) for d in range(3)], dim=-1)
    return w - grad


def velocity_from_vorticity(w, cfg: VortexConfig):
    psi = PS.fft_poisson(-w, cfg.lengths)
    return curl(psi, _hs(cfg))


def rhs_field(w, u, cfg: VortexConfig):
    """(ω·∇)u + ν∆ω on the mesh (second-order central, paper §4.4)."""
    hs = _hs(cfg)
    stretch = sum(w[..., d:d + 1] * _d(u, d, hs[d]) for d in range(3))
    return stretch + cfg.nu * laplacian_vec(w, hs)


def _mesh_particles(cfg, device="cpu"):
    ax = _axes(cfg)
    g = np.stack(np.meshgrid(*ax, indexing="ij"), -1).reshape(-1, 3)
    return torch.from_numpy(g.astype(np.float32)).to(device)


def _interp_ops(cfg: VortexConfig, kw, device):
    """Steps 3/5 per ``cfg.interp``: ``bucket`` builds (or skips) the
    per-position-set cell bucketing, which the fused m2p / p2m reuse — the
    RK2 stage interpolates twice at x1 but buckets it once."""
    if cfg.interp == "cells":
        from repro_torch.kernels.m4_interp import ops as M4
        pk = dict(cb=cfg.interp_cb, **kw)

        def bucket(x, valid):
            return M4.bucket_particles(x, valid,
                                       cell_cap=cfg.interp_cell_cap, **pk)

        def m2p2(b, fa, fb, x, valid):
            return M4.m2p_fused_bucketed(b, (fa, fb), valid,
                                         backend=cfg.backend,
                                         precision=cfg.precision, **pk)

        def p2m_(b, x, val, valid):
            return M4.p2m_bucketed(b, val, backend=cfg.backend,
                                   precision=cfg.precision, **pk)

        def ovf(b):
            return b.overflow
    elif cfg.interp == "scatter":
        def bucket(x, valid):
            return None

        def m2p2(b, fa, fb, x, valid):
            return IP.m2p(fa, x, valid, **kw), IP.m2p(fb, x, valid, **kw)

        def p2m_(b, x, val, valid):
            return IP.p2m(x, val, valid, **kw)

        def ovf(b):
            return torch.zeros((), dtype=torch.int32, device=device)
    else:
        raise ValueError(f"unknown interp {cfg.interp!r}; want 'cells' or "
                         "'scatter'")
    return bucket, m2p2, p2m_, ovf


def vic_step(w, cfg: VortexConfig):
    """One RK2 step with remeshing. w: (nx,ny,nz,3) mesh vorticity.
    Returns (w_next, overflow) — overflow (0-d int32 tensor) counts
    particles dropped by interpolation-cell capacity (cell path only; 0 on
    the scatter path). Non-zero means re-provision ``interp_cell_cap``
    (see :func:`step_reprovision`). Intermediates are released as soon as
    the step is done with them."""
    kw = dict(shape=tuple(cfg.shape), box_lo=(0.0, 0.0, 0.0),
              box_hi=tuple(cfg.lengths), periodic=(True, True, True))
    bucket, m2p2, p2m_, ovf = _interp_ops(cfg, kw, w.device)
    # remeshing engine: re-seed particles on significant mesh nodes
    ps, _ = RM.seed_from_mesh(w, box_lo=kw["box_lo"], box_hi=kw["box_hi"],
                              periodic=kw["periodic"],
                              threshold=cfg.remesh_threshold, dim=3)
    x0, wp0, valid = ps.x, ps.props["w"], ps.valid
    del ps
    L = const_tensor(tuple(float(v) for v in cfg.lengths), x0.dtype,
                     x0.device)
    vm = valid[:, None]

    # stage 1
    b0 = bucket(x0, valid)
    u0 = velocity_from_vorticity(w, cfg)
    r0 = rhs_field(w, u0, cfg)
    up, rp = m2p2(b0, u0, r0, x0, valid)
    ovf_total = ovf(b0)
    del u0, r0, b0
    x1 = x0 + cfg.dt * up
    wp1 = wp0 + cfg.dt * rp
    # P2M of stage-1 state
    x1 = torch.where(vm, torch.remainder(x1, L), x1)
    b1 = bucket(x1, valid)
    w1 = p2m_(b1, x1, wp1, valid)
    del wp1
    # stage 2 at the predicted state
    u1 = velocity_from_vorticity(w1, cfg)
    r1 = rhs_field(w1, u1, cfg)
    del w1
    up1, rp1 = m2p2(b1, u1, r1, x1, valid)
    ovf_total = ovf_total + ovf(b1)
    del u1, r1, b1, x1
    # combine (midpoint average), move from x0
    xf = torch.where(vm, torch.remainder(x0 + 0.5 * cfg.dt * (up + up1), L),
                     x0)
    del up, up1
    wpf = wp0 + 0.5 * cfg.dt * (rp + rp1)
    del rp, rp1
    bf = bucket(xf, valid)
    wf = p2m_(bf, xf, wpf, valid)
    return wf, ovf_total + ovf(bf)


def centroid_z(w, cfg: VortexConfig) -> torch.Tensor:
    """|ω|-weighted centroid along the propagation (first) axis."""
    mag = torch.linalg.vector_norm(w, dim=-1)
    z = torch.arange(cfg.shape[0], dtype=torch.float32, device=w.device) \
        * (cfg.lengths[0] / cfg.shape[0])
    wz = mag.sum(dim=(1, 2))
    return (z * wz).sum() / torch.clamp(wz.sum(), min=1e-9)


def enstrophy(w) -> torch.Tensor:
    return 0.5 * (w * w).sum(dim=-1).mean()


def step_reprovision(w, cfg: VortexConfig):
    """vic_step plus its control plane: on bucket overflow, double
    ``interp_cell_cap`` and redo the step (the OpenFPM re-provision
    contract; each redo adds one to :data:`REDOS`). Returns
    (w_next, cfg) — cfg may have grown. The cell path reads the overflow
    count on the host once per step; the scatter path never syncs
    (overflow is structurally zero there)."""
    global REDOS
    w2, ovf = vic_step(w, cfg)
    if cfg.interp == "cells":
        from repro_torch.kernels.m4_interp.ops import default_cell_cap
        while int(ovf) > 0:
            cap = cfg.interp_cell_cap or default_cell_cap(cfg.interp_cb, 3)
            cfg = dataclasses.replace(cfg, interp_cell_cap=2 * cap)
            del w2, ovf
            REDOS += 1
            w2, ovf = vic_step(w, cfg)
    return w2, cfg


def run(cfg: VortexConfig, n_steps: int):
    """Project the ring, step ``n_steps`` times on ``cfg.device``. Returns
    (w, z0, z1): the final field and the centroid before and after."""
    w = project_divfree(init_ring(cfg), cfg)
    z0 = float(centroid_z(w, cfg))
    for _ in range(n_steps):
        w, cfg = step_reprovision(w, cfg)
    return w, z0, float(centroid_z(w, cfg))


# --------------------------------------------------------------------------
# Distributed phase: the field and the particles in slab blocks
# --------------------------------------------------------------------------

def make_distributed_vic_step(mesh, cfg: VortexConfig, axis_name="shards",
                              *, stencil_overlap: bool = True):
    """The slab-sharded VIC step, as each rank calls it: ``step(f:
    grid.DistributedField) -> (f, overflow)``. Per stage, on this rank's
    block: re-seed particles from the block (``remesh.seed_from_block``);
    ψ by the slab FFT (``poisson.fft_poisson_slab_local``, one transpose);
    curl and RHS as halo-1 stencils (``grid.apply_stencil_local``, the
    two-slot schedule when ``stencil_overlap``); M'4 M2P against
    ``mesh_halo``-padded blocks and P2M into a ``local + 2 mesh_halo``
    block that the halo reduce (ghost_put) folds home. ``cfg.interp``
    picks the legs as :func:`vic_step` does. ``overflow`` (a 0-d int32,
    summed over ranks) counts re-seed surplus, particles whose support
    outran ``mesh_halo`` and cell-bucket drops. A ``(row, col)`` tuple
    ``axis_name`` whose column axis has size 1 is the slab step over the
    row axis; a larger one is the pencil step (:func:`_make_pencil_vic_step`,
    over ``grid.distribute_field2`` blocks)."""
    if isinstance(axis_name, tuple):
        row_axis, col_axis = axis_name
        if int(mesh.size(mesh.mesh_dim_names.index(col_axis))) > 1:
            return _make_pencil_vic_step(mesh, cfg, row_axis, col_axis)
        axis_name = row_axis
    with RT.on_mesh(mesh):
        ndev = RT.axis_size(axis_name)
    n0, n1, _ = cfg.shape
    if n0 % ndev or n1 % ndev:
        raise ValueError(
            f"shape {cfg.shape}: axes 0 and 1 must divide over {ndev} "
            "shards (slab rows + FFT transpose)")
    n0l = n0 // ndev
    H = int(cfg.mesh_halo)
    if not 2 <= H <= n0l:
        raise ValueError(
            f"mesh_halo={H} must be in [2, {n0l}] (M'4 support; single-hop "
            "ghost exchange)")
    kw = dict(shape=tuple(cfg.shape), box_lo=(0.0, 0.0, 0.0),
              box_hi=tuple(cfg.lengths), periodic=(True, True, True))
    hs = _hs(cfg)
    curl_st = G.apply_stencil_local(lambda p: curl(p, hs), 1, axis_name,
                                    overlap=stencil_overlap)
    rhs_st = G.apply_stencil_local(
        lambda wp, up: rhs_field(wp, up, cfg), 1, axis_name,
        overlap=stencil_overlap)
    if cfg.interp == "cells":
        from repro_torch.kernels.m4_interp import ops as M4
        pk = dict(cb=cfg.interp_cb, cell_cap=cfg.interp_cell_cap,
                  backend=cfg.backend, precision=cfg.precision, **kw)

        def m2p2(pa, pb, x, valid, row0):
            return M4.m2p_fused_block((pa, pb), x, valid, row0, **pk)

        def p2m_(x, wp, valid, row0):
            return M4.p2m_block(x, wp, valid, row0, block_rows=n0l + 2 * H,
                                **pk)
    elif cfg.interp == "scatter":
        def m2p2(pa, pb, x, valid, row0):
            a, da = IP.m2p_block(pa, x, valid, row0, **kw)
            b, db = IP.m2p_block(pb, x, valid, row0, **kw)
            return (a, b), da + db

        def p2m_(x, wp, valid, row0):
            return IP.p2m_block(x, wp, valid, row0, block_rows=n0l + 2 * H,
                                **kw)
    else:
        raise ValueError(f"unknown interp {cfg.interp!r}; want 'cells' or "
                         "'scatter'")

    def local_step(f):
        me = RT.axis_index(axis_name)
        w = f.data                                    # (n0l, n1, n2, 3)
        row_lo = f.node_bounds[me]
        row0 = row_lo - H                             # padded-block origin
        ps, ovf = RM.seed_from_block(w, row_lo,
                                     threshold=cfg.remesh_threshold, **kw)
        x0, wp0, valid = ps.x, ps.props["w"], ps.valid
        del ps
        L = const_tensor(tuple(float(v) for v in cfg.lengths), x0.dtype,
                         x0.device)
        vm = valid[:, None]

        def eval_fields(wf):
            """ψ solve, curl and RHS, on the local blocks."""
            psi = PS.fft_poisson_slab_local(-wf, cfg.lengths, axis_name)
            (u,) = curl_st(psi)
            del psi
            (r,) = rhs_st(wf, u)
            return u, r

        def gather(fa, fb, x):
            """M2P of two fields against ghost_get-padded blocks."""
            return m2p2(G.halo_pad(fa, H, axis_name),
                        G.halo_pad(fb, H, axis_name), x, valid, row0)

        def deposit(x, wp):
            """P2M into the local+halo block, then the halo reduce."""
            blk, drop = p2m_(x, wp, valid, row0)
            return G.halo_reduce(blk, H, axis_name), drop

        # stage 1
        u0, r0 = eval_fields(w)
        (up, rp), d0 = gather(u0, r0, x0)
        del u0, r0
        x1 = torch.where(vm, torch.remainder(x0 + cfg.dt * up, L), x0)
        wp1 = wp0 + cfg.dt * rp
        w1, d1 = deposit(x1, wp1)
        del wp1
        # stage 2 at the predicted state
        u1, r1 = eval_fields(w1)
        del w1
        (up1, rp1), d2 = gather(u1, r1, x1)
        del u1, r1, x1
        xf = torch.where(vm, torch.remainder(
            x0 + 0.5 * cfg.dt * (up + up1), L), x0)
        del up, up1
        wpf = wp0 + 0.5 * cfg.dt * (rp + rp1)
        del rp, rp1
        wf, d3 = deposit(xf, wpf)
        ovf = ovf + d0 + d1 + d2 + d3
        return (dataclasses.replace(f, data=wf),
                RT.psum(ovf.to(torch.int32), axis_name))

    def step(f):
        with RT.on_mesh(mesh):
            return local_step(f)

    return step


def _make_pencil_vic_step(mesh, cfg: VortexConfig, row_axis: str,
                          col_axis: str):
    """The pencil (2-D device mesh) VIC step, as each rank calls it
    (``repro``'s ``_make_pencil_vic_step``, DESIGN.md §13): the RK2 stages
    of the slab step with the field sharded over axes 0 and 1 — ψ by the
    two-transpose pencil FFT, the stencils over 2-D halos, M'4 against
    2-D ghost-padded blocks and deposits halo-reduced on both axes (the
    corners relay through the edge neighbours). ``cfg.interp`` must be
    one of the slab step's choices; both run the pencil block legs of
    ``core.interp``, plain torch as ``repro``'s are jnp (the CUDA M'4
    kernels address a slab block)."""
    if cfg.interp not in ("cells", "scatter"):
        raise ValueError(f"unknown interp {cfg.interp!r}; want 'cells' or "
                         "'scatter'")
    with RT.on_mesh(mesh):
        ndev_r, ndev_c = RT.axis_size(row_axis), RT.axis_size(col_axis)
    n0, n1, n2 = cfg.shape
    if n0 % ndev_r or n1 % ndev_c:
        raise ValueError(
            f"shape {cfg.shape}: axis 0 must divide over {ndev_r} row "
            f"shards and axis 1 over {ndev_c} column shards (pencil blocks)")
    if n1 % ndev_r or n2 % ndev_c:
        raise ValueError(
            f"shape {cfg.shape}: the pencil FFT transposes need axis 1 "
            f"divisible by {ndev_r} and axis 2 by {ndev_c}")
    n0l, n1l = n0 // ndev_r, n1 // ndev_c
    H = int(cfg.mesh_halo)
    if not 2 <= H <= min(n0l, n1l):
        raise ValueError(
            f"mesh_halo={H} must be in [2, {min(n0l, n1l)}] (M'4 support; "
            "single-hop ghost exchange per mesh axis)")
    kw = dict(shape=tuple(cfg.shape), box_lo=(0.0, 0.0, 0.0),
              box_hi=tuple(cfg.lengths), periodic=(True, True, True))
    hs = _hs(cfg)
    curl_st = G.apply_stencil_local2(lambda p: curl(p, hs), 1, row_axis,
                                     col_axis)
    rhs_st = G.apply_stencil_local2(
        lambda wp, up: rhs_field(wp, up, cfg), 1, row_axis, col_axis)
    axes = (row_axis, col_axis)

    def local_step(f):
        me_r, me_c = RT.axis_index(row_axis), RT.axis_index(col_axis)
        w = f.data                                    # (n0l, n1l, n2, 3)
        row_lo, col_lo = f.node_bounds[me_r], f.col_bounds[me_c]
        row0, col0 = row_lo - H, col_lo - H           # padded-block origin
        ps, ovf = RM.seed_from_block2(w, row_lo, col_lo,
                                      threshold=cfg.remesh_threshold, **kw)
        x0, wp0, valid = ps.x, ps.props["w"], ps.valid
        del ps
        L = const_tensor(tuple(float(v) for v in cfg.lengths), x0.dtype,
                         x0.device)
        vm = valid[:, None]

        def eval_fields(wf):
            """ψ solve, curl and RHS, on the local pencils."""
            psi = PS.fft_poisson_pencil_local(-wf, cfg.lengths, row_axis,
                                              col_axis)
            (u,) = curl_st(psi)
            del psi
            (r,) = rhs_st(wf, u)
            return u, r

        def gather(fld, x):
            """M2P against a 2-D ghost_get-padded block."""
            pad = G.halo_pad2(fld, H, row_axis, col_axis)
            return IP.m2p_block2(pad, x, valid, row0, col0, **kw)

        def deposit(x, wp):
            """P2M into the pencil + halo block, then the 2-D reduce."""
            blk, drop = IP.p2m_block2(x, wp, valid, row0, col0,
                                      block_rows=n0l + 2 * H,
                                      block_cols=n1l + 2 * H, **kw)
            return G.halo_reduce2(blk, H, row_axis, col_axis), drop

        # stage 1
        u0, r0 = eval_fields(w)
        up, d0 = gather(u0, x0)
        rp, d1 = gather(r0, x0)
        del u0, r0
        x1 = torch.where(vm, torch.remainder(x0 + cfg.dt * up, L), x0)
        wp1 = wp0 + cfg.dt * rp
        w1, d2 = deposit(x1, wp1)
        del wp1
        # stage 2 at the predicted state
        u1, r1 = eval_fields(w1)
        del w1
        up1, d3 = gather(u1, x1)
        rp1, d4 = gather(r1, x1)
        del u1, r1, x1
        xf = torch.where(vm, torch.remainder(
            x0 + 0.5 * cfg.dt * (up + up1), L), x0)
        del up, up1
        wpf = wp0 + 0.5 * cfg.dt * (rp + rp1)
        del rp, rp1
        wf, d5 = deposit(xf, wpf)
        ovf = ovf + d0 + d1 + d2 + d3 + d4 + d5
        return (dataclasses.replace(f, data=wf),
                RT.psum(ovf.to(torch.int32), axes))

    def step(f):
        with RT.on_mesh(mesh):
            return local_step(f)

    return step


def run_distributed(cfg: VortexConfig, n_steps: int, mesh,
                    axis_name="shards", *, auto_reprovision: bool = False,
                    _make_step=None):
    """The distributed driver mirroring :func:`run`, as each rank calls
    it: the field lives in slab blocks for the whole run. Returns (w, z0,
    z1) with the full field (the blocks gathered) on every rank. By
    default the overflow is summed on the device and read once after the
    loop; a nonzero total raises RuntimeError (raise ``mesh_halo`` or
    ``interp_cell_cap``).

    ``auto_reprovision=True`` adds the control plane: on an overflow (the
    step's, summed over the ranks, so every rank sees the same) the step
    is redone from the pre-step field with ``mesh_halo`` doubled, clamped
    to the slab height (the geometric ceiling of a single-hop exchange),
    and a RuntimeError at that ceiling. It reads the overflow on the host
    each step, and returns the grown ``cfg`` as a fourth value.
    ``_make_step`` is the step factory ``make_step(mesh, cfg, axis_name)
    -> step`` (injectable, to test the control loop without a real
    overflow)."""
    make_step = _make_step or make_distributed_vic_step
    row = axis_name[0] if isinstance(axis_name, tuple) else axis_name
    pencil = (isinstance(axis_name, tuple) and int(mesh.size(
        mesh.mesh_dim_names.index(axis_name[1]))) > 1)
    step = make_step(mesh, cfg, axis_name)
    w = project_divfree(init_ring(cfg), cfg)
    z0 = float(centroid_z(w, cfg))
    if pencil:
        f = G.distribute_field2(w, mesh, *axis_name)
        gather = lambda f: G.gather_field2(f, mesh, *axis_name)
    else:
        f = G.distribute_field(w, mesh, row)
        gather = lambda f: G.gather_field(f, mesh, row)
    del w
    if auto_reprovision:
        # the ceiling: a pencil's smaller side, or the slab height
        n0l = min(f.data.shape[:2]) if pencil else f.data.shape[0]
        for _ in range(n_steps):
            f2, ovf = step(f)
            while int(ovf) > 0:
                new_halo = min(2 * cfg.mesh_halo, n0l)
                if new_halo == cfg.mesh_halo:
                    raise RuntimeError(
                        f"halo overflow persists at the geometric ceiling "
                        f"mesh_halo={cfg.mesh_halo} (slab height {n0l}); "
                        "the decomposition is too fine for this flow")
                cfg = dataclasses.replace(cfg, mesh_halo=new_halo)
                step = make_step(mesh, cfg, axis_name)
                f2, ovf = step(f)        # redo from the pre-step field
            f = f2
        w = gather(f)
        return w, z0, float(centroid_z(w, cfg)), cfg
    total = torch.zeros((), dtype=torch.int32, device=f.data.device)
    for _ in range(n_steps):
        f, ovf = step(f)
        total = total + ovf
    if int(total) != 0:
        raise RuntimeError(
            f"interpolation overflow ({int(total)} particles outran the "
            f"halo or their cell bucket over {n_steps} steps); raise "
            f"VortexConfig.mesh_halo (= {cfg.mesh_halo}) or interp_cell_cap")
    w = gather(f)
    return w, z0, float(centroid_z(w, cfg))
