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

(``repro``'s distributed steps ``make_distributed_vic_step``,
``_make_pencil_vic_step`` and ``run_distributed`` arrive with the
multi-device layer, ROADMAP A14.)
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.core import interp as IP
from repro_torch.core import remesh as RM
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
