"""End-to-end M'4 interpolation ops (port of the serial part of
``repro.kernels.m4_interp.ops``): cell-list bucketing in PyTorch, then the
conflict-free P2M / fused M2P of :mod:`.m4_interp`, with the signatures of
the ``core/interp.py`` oracle so the apps can switch per config.

The cell grid is aligned with the mesh: each interpolation cell spans
``cb`` nodes per axis, so the P2M owner cells own disjoint node patches.
The path is periodic-only; non-periodic callers stay on ``core.interp``.

Bucketing is exposed (``bucket_particles`` → ``p2m_bucketed`` /
``m2p_fused_bucketed``) so callers interpolating several quantities at the
same positions pay for it once. Bucket overflow (particles beyond
``cell_cap`` in one cell) is counted and returned as a 0-d device tensor,
never clamped: the caller re-provisions.

``backend``: ``"auto"`` launches the CUDA kernels for CUDA tensors and
runs their plain versions for CPU tensors; ``"torch"`` forces the plain
versions; ``"cuda"`` forces the kernels and raises RuntimeError on CPU
tensors. (``repro``'s local-block legs ``p2m_block``/``m2p_fused_block``
serve the distributed VIC step and arrive with it, ROADMAP A14.)
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import cell_list as CL
from repro_torch.core.particles import ParticleSet
from repro_torch.kernels.m4_interp import m4_interp as K

DEFAULT_CB = 4


def default_cell_cap(cb: int, dim: int) -> int:
    """Default bucket capacity: 2× the one-particle-per-node density that
    remeshed VIC maintains. The single source for re-provisioning callers."""
    return 2 * cb ** dim


class InterpBuckets(NamedTuple):
    """Dense (n_cells, cc, ·) slot tiles from one bucketing pass."""

    cell_x: torch.Tensor      # (n_cells, cc, dim) slot positions
    cell_mask: torch.Tensor   # (n_cells, cc) slot occupancy
    safe: torch.Tensor        # (n_cells, cc) clamped slot→particle index
    overflow: torch.Tensor    # () int32 total dropped particles


def _check_layout(shape, periodic, cb):
    if cb < 2:
        raise ValueError(
            f"cb={cb}: the 3^dim neighbor-bucket gather only covers the M'4 "
            "support (2h) for cb >= 2")
    if not all(periodic):
        raise NotImplementedError(
            "the m4_interp cell path is periodic-only; use core.interp for "
            f"clamped boundaries (periodic={periodic})")
    if any(n % cb for n in shape):
        raise ValueError(f"mesh shape {shape} not divisible by cb={cb}")
    return tuple(int(n) // cb for n in shape)


def _kernels(backend: str, x: torch.Tensor):
    """(p2m_cells, m2p_cells) of ``backend`` for tensors like ``x``."""
    if backend == "auto":
        return K.p2m_cells, K.m2p_cells
    if backend == "torch":
        return K.p2m_cells_torch, K.m2p_cells_torch
    if backend == "cuda":
        if not x.is_cuda:
            raise RuntimeError(
                f"backend='cuda' needs CUDA tensors; the particles are on "
                f"{x.device} (use backend='auto' or 'torch' on the CPU)")
        return K.p2m_cells, K.m2p_cells
    raise ValueError(
        f"unknown backend {backend!r}; want 'auto', 'torch' or 'cuda'")


def bucket_particles(x, valid, *, shape, box_lo, box_hi, periodic,
                     cb: int = DEFAULT_CB,
                     cell_cap: int = 0) -> InterpBuckets:
    """Bin particles into mesh-aligned interpolation cells with the cell
    list. ``cell_cap`` defaults to ``2·cb^dim``; overflow > 0 means that
    many particles were dropped — re-provision."""
    dim = len(shape)
    grid_cells = _check_layout(shape, periodic, cb)
    cell_cap = cell_cap or default_cell_cap(cb, dim)
    ps = ParticleSet(x=torch.where(valid[:, None], x,
                                   torch.full_like(x, ParticleSet.FILL)),
                     props={}, valid=valid)
    cl = CL.build_cell_list(ps, box_lo=tuple(box_lo), box_hi=tuple(box_hi),
                            grid_shape=grid_cells, periodic=tuple(periodic),
                            cell_cap=cell_cap)
    cap = ps.capacity
    n_cells = int(np.prod(grid_cells))
    rows = cl.cells[:n_cells]                    # (n_cells, cc)
    safe = torch.clamp(rows, max=cap - 1)
    # total dropped particles (CellList.overflow is only the worst cell's
    # excess; sum the per-cell excess so callers report a true count)
    dropped = torch.clamp(cl.counts[:n_cells] - cell_cap, min=0).sum()
    return InterpBuckets(cell_x=ps.x[safe.long()], cell_mask=rows < cap,
                         safe=safe, overflow=dropped.to(torch.int32))


def p2m_bucketed(buckets: InterpBuckets, value, *, shape, box_lo, box_hi,
                 periodic, cb: int = DEFAULT_CB, backend: str = "auto",
                 precision: str = "fp32"):
    """P2M from an existing bucketing. ``value``: (N,) or (N, C) indexed by
    the particle slots the buckets were built from."""
    grid_cells = _check_layout(shape, periodic, cb)
    p2m_cells, _ = _kernels(backend, value)
    vec = value.dim() == 2
    val2 = value if vec else value[:, None]
    cell_val = val2.to(torch.float32)[buckets.safe.long()]
    out = p2m_cells(buckets.cell_x, cell_val, buckets.cell_mask,
                    grid_cells=grid_cells, cb=cb, box_lo=tuple(box_lo),
                    box_hi=tuple(box_hi), precision=precision)
    out = out.to(value.dtype)
    return out if vec else out[..., 0]


def _scatter_back(tiles, buckets: InterpBuckets, cap: int) -> torch.Tensor:
    """Per-slot values (n_cells, cc, C) → per-particle (cap, C). A valid
    particle occupies exactly one slot, so this is a copy, not a sum: the
    masked slots (whose ``safe`` index is clamped onto a real particle)
    are sent to dump rows past ``cap``, spread so no one row takes them
    all, and dropped. No atomics."""
    n_ch = tiles.shape[-1]
    flat = tiles.reshape(-1, n_ch)
    mask = buckets.cell_mask.reshape(-1)
    dump = cap + torch.arange(flat.shape[0], device=flat.device) % 1024
    dest = torch.where(mask, buckets.safe.reshape(-1).long(), dump)
    per_p = torch.zeros((cap + 1024, n_ch), dtype=torch.float32,
                        device=flat.device)
    per_p.index_copy_(0, dest, flat)
    return per_p[:cap]


def m2p_fused_bucketed(buckets: InterpBuckets, fields, valid, *, shape,
                       box_lo, box_hi, periodic, cb: int = DEFAULT_CB,
                       backend: str = "auto", precision: str = "fp32"):
    """Fused M2P from an existing bucketing: interpolate several mesh
    fields (each ``shape`` or ``shape + (C,)``) in ONE kernel pass — the
    weights are computed once for all stacked channels. Returns a tuple
    matching ``fields``."""
    grid_cells = _check_layout(shape, periodic, cb)
    _, m2p_cells = _kernels(backend, buckets.cell_x)
    dim = len(shape)
    fields = tuple(fields)
    chans = [1 if f.dim() == dim else f.shape[-1] for f in fields]
    stacked = torch.cat([f[..., None] if f.dim() == dim else f
                         for f in fields], dim=-1).to(torch.float32)
    tiles = m2p_cells(stacked, buckets.cell_x, buckets.cell_mask,
                      grid_cells=grid_cells, cb=cb, box_lo=tuple(box_lo),
                      box_hi=tuple(box_hi), precision=precision)
    del stacked
    per_p = _scatter_back(tiles, buckets, valid.shape[0])
    del tiles
    per_p = torch.where(valid[:, None], per_p, torch.zeros_like(per_p))
    out, c0 = [], 0
    for f, c in zip(fields, chans):
        piece = per_p[:, c0:c0 + c].to(f.dtype)
        out.append(piece[:, 0] if f.dim() == dim else piece)
        c0 += c
    return tuple(out)


def p2m(x, value, valid, *, shape, box_lo, box_hi, periodic,
        cb: int = DEFAULT_CB, cell_cap: int = 0, backend: str = "auto",
        return_overflow: bool = False, precision: str = "fp32"):
    """Cell-path P2M, drop-in for ``core.interp.p2m`` (periodic axes only).
    With ``return_overflow`` returns (field, dropped-particle count)."""
    kw = dict(shape=tuple(shape), box_lo=box_lo, box_hi=box_hi,
              periodic=periodic, cb=cb)
    b = bucket_particles(x, valid, cell_cap=cell_cap, **kw)
    out = p2m_bucketed(b, value, backend=backend, precision=precision, **kw)
    return (out, b.overflow) if return_overflow else out


def m2p_fused(fields, x, valid, *, shape, box_lo, box_hi, periodic,
              cb: int = DEFAULT_CB, cell_cap: int = 0, backend: str = "auto",
              return_overflow: bool = False, precision: str = "fp32"):
    """Fused cell-path M2P (bucket + gather in one call); see
    :func:`m2p_fused_bucketed`."""
    kw = dict(shape=tuple(shape), box_lo=box_lo, box_hi=box_hi,
              periodic=periodic, cb=cb)
    b = bucket_particles(x, valid, cell_cap=cell_cap, **kw)
    out = m2p_fused_bucketed(b, fields, valid, backend=backend,
                             precision=precision, **kw)
    return (out, b.overflow) if return_overflow else out


def m2p(field, x, valid, *, shape, box_lo, box_hi, periodic,
        cb: int = DEFAULT_CB, cell_cap: int = 0, backend: str = "auto",
        return_overflow: bool = False, precision: str = "fp32"):
    """Cell-path M2P, drop-in for ``core.interp.m2p`` (periodic axes
    only)."""
    res = m2p_fused((field,), x, valid, shape=shape, box_lo=box_lo,
                    box_hi=box_hi, periodic=periodic, cb=cb,
                    cell_cap=cell_cap, backend=backend,
                    return_overflow=return_overflow, precision=precision)
    if return_overflow:
        (out,), ovf = res
        return out, ovf
    return res[0]
