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
tensors.

The local-block legs :func:`p2m_block`/:func:`m2p_fused_block` run the same
kernels on a slab block of the mesh (owned rows plus a halo), embedded in
a ``cb``-aligned local torus.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import cell_list as CL
from repro_torch.core import interp as IP
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


# --------------------------------------------------------------------------
# Local-block legs (the slab P2M/M2P, DESIGN.md §10)
# --------------------------------------------------------------------------
# A block holds ``block_rows`` global rows from ``row0`` (owned rows ± a
# halo). The kernels are torus kernels, so the block is embedded in a local
# torus: rows padded up to a multiple of ``cb``, positions re-origined at
# the block start. Particles whose M'4 support leaves the block are masked
# out and counted (the contract of ``core.interp.p2m_block``, the oracle
# these are held against); for kept particles the torus wrap never
# engages, so the results match the oracle's.

def _block_frame(x, valid, row0, block_rows, shape, box_lo, box_hi,
                 periodic, cb):
    """(x_local, ok, padded rows, local box lo, hi) for a block embedded in
    a cb-aligned local torus."""
    _, h = IP._node_spacing(shape, box_lo, box_hi, periodic)
    base, frac = IP._block_base_frac(x, row0, block_rows, shape, box_lo,
                                     box_hi, periodic)
    ok = valid & IP._block_ok(base[:, 0], block_rows)
    rows_k = -(-block_rows // cb) * cb
    # the local coordinate rebuilt from the folded relative row and the
    # exact frac, so the kernel re-derives the (base, frac) the oracle uses
    x0_rel = (base[:, 0].to(x.dtype) + frac[:, 0]) * float(h[0])
    x_loc = torch.cat([x0_rel[:, None], x[:, 1:]], 1)
    x_loc = torch.where(ok[:, None], x_loc,
                        torch.full_like(x_loc, ParticleSet.FILL))
    local_lo = (0.0,) + tuple(float(v) for v in np.asarray(box_lo)[1:])
    local_hi = (float(rows_k * h[0]),) + tuple(
        float(v) for v in np.asarray(box_hi)[1:])
    return x_loc, ok, rows_k, local_lo, local_hi


def p2m_block(x, value, valid, row0, *, block_rows: int, shape, box_lo,
              box_hi, periodic, cb: int = DEFAULT_CB, cell_cap: int = 0,
              backend: str = "auto", precision: str = "fp32"):
    """Cell-path P2M onto a local slab block, the counterpart of
    ``core.interp.p2m_block`` (periodic global axes only). Returns
    ``(block, overflow)``: overflow (0-d int32) sums the particles whose
    support left the block and the bucket-capacity drops."""
    shape = tuple(int(n) for n in shape)
    x_loc, ok, rows_k, lo_l, hi_l = _block_frame(
        x, valid, row0, block_rows, shape, box_lo, box_hi, periodic, cb)
    kw = dict(shape=(rows_k,) + shape[1:], box_lo=lo_l, box_hi=hi_l,
              periodic=tuple(periodic), cb=cb)
    b = bucket_particles(x_loc, ok, cell_cap=cell_cap, **kw)
    vmask = ok[:, None] if value.dim() == 2 else ok
    out = p2m_bucketed(b, torch.where(vmask, value, torch.zeros_like(value)),
                       backend=backend, precision=precision, **kw)
    dropped = (valid & ~ok).sum().to(torch.int32)
    return out[:block_rows], b.overflow + dropped


def m2p_fused_block(blocks, x, valid, row0, *, shape, box_lo, box_hi,
                    periodic, cb: int = DEFAULT_CB, cell_cap: int = 0,
                    backend: str = "auto", precision: str = "fp32"):
    """Fused cell-path M2P from local slab blocks (each ``(block_rows,
    ...)``, all the same rows), the block counterpart of
    :func:`m2p_fused`. Returns ``(tuple(values), overflow)``; dropped
    particles read 0."""
    shape = tuple(int(n) for n in shape)
    blocks = tuple(blocks)
    block_rows = blocks[0].shape[0]
    x_loc, ok, rows_k, lo_l, hi_l = _block_frame(
        x, valid, row0, block_rows, shape, box_lo, box_hi, periodic, cb)
    kw = dict(shape=(rows_k,) + shape[1:], box_lo=lo_l, box_hi=hi_l,
              periodic=tuple(periodic), cb=cb)
    pad = rows_k - block_rows
    fields = tuple(
        torch.cat([f, f.new_zeros((pad,) + tuple(f.shape[1:]))]) if pad
        else f for f in blocks)
    b = bucket_particles(x_loc, ok, cell_cap=cell_cap, **kw)
    out = m2p_fused_bucketed(b, fields, ok, backend=backend,
                             precision=precision, **kw)
    dropped = (valid & ~ok).sum().to(torch.int32)
    return out, b.overflow + dropped


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
