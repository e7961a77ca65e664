"""Moment-conserving particle-mesh / mesh-particle interpolation with the
M'4 kernel (port of the serial part of ``repro.core.interp``; paper §2,
§4.4).

M'4 (Monaghan): W(s) =
    1 - 5/2 s^2 + 3/2 s^3          0 <= s < 1
    1/2 (2 - s)^2 (1 - s)          1 <= s < 2
    0                              s >= 2

Support is 4 nodes per axis. P2M is a scatter-add (``index_add_``) over
the 4^dim stencil; M2P is the corresponding gather. Grids are
node-centered: node i sits at ``lo + i*h`` with h = L/n on periodic axes
and h = L/(n-1) otherwise.

These plain PyTorch versions are the oracles of ``kernels/m4_interp`` and
the ``interp="scatter"`` path of the vortex app. The local-block legs
:func:`p2m_block`/:func:`m2p_block` address a slab block of the mesh
(owned rows plus a halo; serially the whole axis plus both halos). Their
pencil forms :func:`p2m_block2`/:func:`m2p_block2` address a block of
rows and columns and serve the pencil VIC step; they stay plain torch, as
``repro``'s are jnp outside any Pallas kernel.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .particles import const_tensor


def m4_prime(s: torch.Tensor) -> torch.Tensor:
    s = s.abs()
    s2 = s * s
    w_inner = 1.0 - 2.5 * s2 + 1.5 * (s2 * s)
    t = 2.0 - s
    w_outer = 0.5 * (t * t) * (1.0 - s)
    return torch.where(s < 1.0, w_inner,
                       torch.where(s < 2.0, w_outer, torch.zeros_like(s)))


def _stencil_offsets(dim: int) -> np.ndarray:
    rng = [(-1, 0, 1, 2)] * dim
    return np.stack(np.meshgrid(*rng, indexing="ij"), axis=-1).reshape(-1, dim)


def _node_spacing(shape, box_lo, box_hi, periodic):
    """(lo, h) per axis in float64 numpy; callers cast at use."""
    lo = np.asarray(box_lo, np.float64)
    hi = np.asarray(box_hi, np.float64)
    n = np.asarray(shape, np.float64)
    per = np.asarray(periodic, bool)
    h = np.where(per, (hi - lo) / n, (hi - lo) / np.maximum(n - 1, 1))
    return lo, h


def _base_and_frac(x, shape, box_lo, box_hi, periodic):
    lo, h = _node_spacing(shape, box_lo, box_hi, periodic)
    lo_t = const_tensor(tuple(float(v) for v in lo), x.dtype, x.device)
    h_t = const_tensor(tuple(float(v) for v in h), x.dtype, x.device)
    s = (x - lo_t) / h_t
    base = torch.floor(s).to(torch.int32)
    frac = s - base.to(x.dtype)
    return base, frac


def _wrap_index(idx, shape, periodic):
    out = []
    for d, n in enumerate(shape):
        i = idx[..., d]
        if periodic[d]:
            i = torch.remainder(i, n)
        else:
            i = torch.clamp(i, 0, n - 1)
        out.append(i)
    return tuple(out)


def _flat_index(idx: Tuple[torch.Tensor, ...], shape) -> torch.Tensor:
    flat = idx[0].long()
    for d in range(1, len(shape)):
        flat = flat * shape[d] + idx[d].long()
    return flat


def _stencil_weight(frac, off):
    w = torch.ones(frac.shape[0], dtype=frac.dtype, device=frac.device)
    for d in range(frac.shape[1]):
        w = w * m4_prime(frac[:, d] - float(off[d]))
    return w


def p2m(x: torch.Tensor, value: torch.Tensor, valid: torch.Tensor, *,
        shape: Tuple[int, ...], box_lo, box_hi, periodic) -> torch.Tensor:
    """Particle→mesh: scatter ``value`` (N,) or (N, C) onto the grid with
    M'4 weights. Returns a tensor of ``shape`` (+ trailing C)."""
    shape = tuple(int(n) for n in shape)
    dim = len(shape)
    base, frac = _base_and_frac(x, shape, box_lo, box_hi, periodic)
    vec = value.dim() == 2
    n_ch = value.shape[1] if vec else 1
    out = torch.zeros((int(np.prod(shape)), n_ch), dtype=value.dtype,
                      device=value.device)
    vm = valid.to(value.dtype)
    val2 = value if vec else value[:, None]
    for off in _stencil_offsets(dim):
        idx = base + torch.as_tensor(off, dtype=torch.int32,
                                     device=x.device)
        w = (_stencil_weight(frac, off) * vm).to(value.dtype)
        flat = _flat_index(_wrap_index(idx, shape, periodic), shape)
        out.index_add_(0, flat, val2 * w[:, None])
    out = out.reshape(shape + (n_ch,))
    return out if vec else out[..., 0]


# --------------------------------------------------------------------------
# Local-block interpolation: the slab P2M/M2P legs
# --------------------------------------------------------------------------
# A block holds rows [row0, row0 + n_block) of the global leading axis
# (owned rows plus a halo). The leading axis is addressed relative to
# ``row0``, a 0-d device tensor (so no host read), transverse axes keep the
# global extent and semantics. A valid particle whose M'4 support leaves
# the block is dropped WHOLE and counted, never clamped into the edge;
# nonzero counts mean the halo must be re-provisioned.

def _block_base_frac(x, row0, n_block, shape, box_lo, box_hi, periodic):
    """base/frac with the leading axis re-origined at global row ``row0``:
    the fractional part matches the global indexing exactly (integer
    shifts), the global periodic seam folds via the mod. When the block
    is wider than the global axis (the serial 1-slab case: owned rows and
    both halos), a folded row whose support would fall off the low edge
    is lifted by one period into the high halo — both placements land on
    the same global rows once the halo wraps."""
    base, frac = _base_and_frac(x, shape, box_lo, box_hi, periodic)
    n0 = int(shape[0])
    rel0 = base[:, 0] - row0
    if periodic[0]:
        rel0 = torch.remainder(rel0, n0)
        rel0 = torch.where((rel0 < 1) & (rel0 + n0 <= n_block - 3),
                           rel0 + n0, rel0)
    return torch.cat([rel0[:, None].to(base.dtype), base[:, 1:]], 1), frac


def _block_ok(base0_rel, n_block):
    """Full M'4 support (rows base-1..base+2) inside [0, n_block)."""
    return (base0_rel >= 1) & (base0_rel <= n_block - 3)


def p2m_block(x: torch.Tensor, value: torch.Tensor, valid: torch.Tensor,
              row0, *, block_rows: int, shape: Tuple[int, ...], box_lo,
              box_hi, periodic):
    """Particle→mesh onto a local slab block (rows [row0, row0 +
    block_rows) of the global mesh that ``shape``/``box_lo``/``box_hi``/
    ``periodic`` describe, as in :func:`p2m`). Returns ``(block,
    dropped)``: ``block`` has leading dim ``block_rows``; ``dropped`` (0-d
    int32) counts valid particles whose support left the block."""
    shape = tuple(int(n) for n in shape)
    dim = len(shape)
    base, frac = _block_base_frac(x, row0, block_rows, shape, box_lo,
                                  box_hi, periodic)
    ok = valid & _block_ok(base[:, 0], block_rows)
    bshape = (int(block_rows),) + shape[1:]
    n_nodes = int(np.prod(bshape))
    vec = value.dim() == 2
    n_ch = value.shape[1] if vec else 1
    # one dump row past the end takes the rows outside the block (repro's
    # scatter mode="drop"); their weights are zero
    out = torch.zeros((n_nodes + 1, n_ch), dtype=value.dtype,
                      device=value.device)
    vm = ok.to(value.dtype)
    val2 = value if vec else value[:, None]
    for off in _stencil_offsets(dim):
        idx = base + torch.as_tensor(off, dtype=torch.int32,
                                     device=x.device)
        w = (_stencil_weight(frac, off) * vm).to(value.dtype)
        row = idx[:, 0]
        wrapped = _wrap_index(idx[:, 1:], shape[1:], periodic[1:])
        flat = _flat_index((row,) + wrapped, bshape)
        flat = torch.where((row >= 0) & (row < block_rows), flat,
                           torch.full_like(flat, n_nodes))
        out.index_add_(0, flat, val2 * w[:, None])
    out = out[:n_nodes].reshape(bshape + (n_ch,))
    dropped = (valid & ~ok).sum().to(torch.int32)
    return (out if vec else out[..., 0]), dropped


def m2p_block(block: torch.Tensor, x: torch.Tensor, valid: torch.Tensor,
              row0, *, shape: Tuple[int, ...], box_lo, box_hi, periodic):
    """Mesh→particle from a local slab block (a halo-padded field whose row
    0 is global row ``row0``), with the global mesh geometry as in
    :func:`m2p`. Returns ``(values, dropped)``; dropped particles read
    0."""
    shape = tuple(int(n) for n in shape)
    dim = len(shape)
    n_block = block.shape[0]
    base, frac = _block_base_frac(x, row0, n_block, shape, box_lo, box_hi,
                                  periodic)
    ok = valid & _block_ok(base[:, 0], n_block)
    bshape = (n_block,) + shape[1:]
    vec = block.dim() == dim + 1
    flat_block = block.reshape((int(np.prod(bshape)),)
                               + tuple(block.shape[dim:]))
    out = torch.zeros(x.shape[:1] + tuple(block.shape[dim:]),
                      dtype=block.dtype, device=block.device)
    safe0 = torch.clamp(base[:, 0], 1, max(n_block - 3, 1))
    for off in _stencil_offsets(dim):
        off_t = torch.as_tensor(off, dtype=torch.int32, device=x.device)
        idx = torch.cat([safe0[:, None], base[:, 1:]], 1) + off_t
        w = _stencil_weight(frac, off).to(block.dtype)
        wrapped = _wrap_index(idx[:, 1:], shape[1:], periodic[1:])
        v = flat_block[_flat_index((idx[:, 0],) + wrapped, bshape)]
        out = out + v * (w[:, None] if vec else w)
    vm = ok.reshape(ok.shape + (1,) * (out.dim() - 1))
    dropped = (valid & ~ok).sum().to(torch.int32)
    return torch.where(vm, out, torch.zeros_like(out)), dropped


# --------------------------------------------------------------------------
# Pencil-block interpolation: the 2-D-mesh P2M/M2P legs
# --------------------------------------------------------------------------
# A pencil block holds rows [row0, row0 + n_block0) × columns [col0, col0 +
# n_block1) of the global mesh (owned nodes plus halos on both axes). The
# slab blocks' contract on axes 0 AND 1: a valid particle whose support
# leaves the block on either axis is dropped whole and counted.

def _block_base_frac2(x, row0, col0, n_block0, n_block1, shape, box_lo,
                      box_hi, periodic):
    """:func:`_block_base_frac` for a pencil block: axes 0 and 1 are both
    re-origined (at ``row0``, ``col0``) with the periodic fold and the
    low-edge lift applied per axis."""
    base, frac = _base_and_frac(x, shape, box_lo, box_hi, periodic)

    def rel(axis, origin, n_block):
        r = base[:, axis] - origin
        if periodic[axis]:
            n = int(shape[axis])
            r = torch.remainder(r, n)
            r = torch.where((r < 1) & (r + n <= n_block - 3), r + n, r)
        return r[:, None].to(base.dtype)

    return torch.cat([rel(0, row0, n_block0), rel(1, col0, n_block1),
                      base[:, 2:]], 1), frac


def p2m_block2(x: torch.Tensor, value: torch.Tensor, valid: torch.Tensor,
               row0, col0, *, block_rows: int, block_cols: int,
               shape: Tuple[int, ...], box_lo, box_hi, periodic):
    """Particle→mesh onto a local pencil block (rows [row0, row0 +
    block_rows) × columns [col0, col0 + block_cols) of the global mesh,
    as :func:`p2m_block` for one axis). Returns ``(block, dropped)``."""
    shape = tuple(int(n) for n in shape)
    dim = len(shape)
    base, frac = _block_base_frac2(x, row0, col0, block_rows, block_cols,
                                   shape, box_lo, box_hi, periodic)
    ok = (valid & _block_ok(base[:, 0], block_rows)
          & _block_ok(base[:, 1], block_cols))
    bshape = (int(block_rows), int(block_cols)) + shape[2:]
    n_nodes = int(np.prod(bshape))
    vec = value.dim() == 2
    n_ch = value.shape[1] if vec else 1
    # one dump row past the end takes indices outside the block (repro's
    # scatter mode="drop"); their weights are zero
    out = torch.zeros((n_nodes + 1, n_ch), dtype=value.dtype,
                      device=value.device)
    vm = ok.to(value.dtype)
    val2 = value if vec else value[:, None]
    for off in _stencil_offsets(dim):
        idx = base + torch.as_tensor(off, dtype=torch.int32,
                                     device=x.device)
        w = (_stencil_weight(frac, off) * vm).to(value.dtype)
        row, col = idx[:, 0], idx[:, 1]
        wrapped = _wrap_index(idx[:, 2:], shape[2:], periodic[2:])
        flat = _flat_index((row, col) + wrapped, bshape)
        inside = ((row >= 0) & (row < block_rows) & (col >= 0)
                  & (col < block_cols))
        flat = torch.where(inside, flat, torch.full_like(flat, n_nodes))
        out.index_add_(0, flat, val2 * w[:, None])
    out = out[:n_nodes].reshape(bshape + (n_ch,))
    dropped = (valid & ~ok).sum().to(torch.int32)
    return (out if vec else out[..., 0]), dropped


def m2p_block2(block: torch.Tensor, x: torch.Tensor, valid: torch.Tensor,
               row0, col0, *, shape: Tuple[int, ...], box_lo, box_hi,
               periodic):
    """Mesh→particle from a local pencil block (a ``grid.halo_pad2``-padded
    field whose [0, 0] corner is global node (row0, col0)). Returns
    ``(values, dropped)``; dropped particles read 0."""
    shape = tuple(int(n) for n in shape)
    dim = len(shape)
    n_block0, n_block1 = block.shape[0], block.shape[1]
    base, frac = _block_base_frac2(x, row0, col0, n_block0, n_block1, shape,
                                   box_lo, box_hi, periodic)
    ok = (valid & _block_ok(base[:, 0], n_block0)
          & _block_ok(base[:, 1], n_block1))
    bshape = (n_block0, n_block1) + shape[2:]
    vec = block.dim() == dim + 1
    flat_block = block.reshape((int(np.prod(bshape)),)
                               + tuple(block.shape[dim:]))
    out = torch.zeros(x.shape[:1] + tuple(block.shape[dim:]),
                      dtype=block.dtype, device=block.device)
    safe = torch.stack([torch.clamp(base[:, 0], 1, max(n_block0 - 3, 1)),
                        torch.clamp(base[:, 1], 1, max(n_block1 - 3, 1))],
                       1)
    for off in _stencil_offsets(dim):
        off_t = torch.as_tensor(off, dtype=torch.int32, device=x.device)
        idx = torch.cat([safe, base[:, 2:]], 1) + off_t
        w = _stencil_weight(frac, off).to(block.dtype)
        wrapped = _wrap_index(idx[:, 2:], shape[2:], periodic[2:])
        v = flat_block[_flat_index((idx[:, 0], idx[:, 1]) + wrapped,
                                   bshape)]
        out = out + v * (w[:, None] if vec else w)
    vm = ok.reshape(ok.shape + (1,) * (out.dim() - 1))
    dropped = (valid & ~ok).sum().to(torch.int32)
    return torch.where(vm, out, torch.zeros_like(out)), dropped


def m2p(field: torch.Tensor, x: torch.Tensor, valid: torch.Tensor, *,
        shape: Tuple[int, ...], box_lo, box_hi, periodic) -> torch.Tensor:
    """Mesh→particle: gather the field at particle positions with M'4
    weights. ``field`` has shape ``shape`` (+ trailing C)."""
    shape = tuple(int(n) for n in shape)
    dim = len(shape)
    base, frac = _base_and_frac(x, shape, box_lo, box_hi, periodic)
    vec = field.dim() == dim + 1
    flat_field = field.reshape((int(np.prod(shape)),) + tuple(
        field.shape[dim:]))
    out = torch.zeros(x.shape[:1] + tuple(field.shape[dim:]),
                      dtype=field.dtype, device=field.device)
    for off in _stencil_offsets(dim):
        idx = base + torch.as_tensor(off, dtype=torch.int32,
                                     device=x.device)
        w = _stencil_weight(frac, off).to(field.dtype)
        v = flat_field[_flat_index(_wrap_index(idx, shape, periodic), shape)]
        out = out + v * (w[:, None] if vec else w)
    vm = valid.reshape(valid.shape + (1,) * (out.dim() - 1))
    return torch.where(vm, out, torch.zeros_like(out))
