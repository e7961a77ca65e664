"""Remeshing engine for hybrid particle–mesh methods (port of
``repro.core.remesh``; paper §2, §4.4).

Remeshing restores a regular particle distribution every step: interpolate
the particle quantity onto the mesh (P2M, M'4), then re-seed particles on
the mesh nodes that carry significant field magnitude. The node→particle
re-seed is a static-shape compaction into a fixed-capacity
:class:`ParticleSet` (kept nodes stable-sorted to the front, surplus
counted as overflow); ``threshold=0.0`` keeps every node, in node order.

:func:`seed_from_block` re-seeds one slab block of the mesh in global
coordinates (serially, the whole mesh is one block);
:func:`seed_from_block2` one pencil block, for the pencil VIC step.
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from . import interp as IP
from .interp import _node_spacing
from .particles import ParticleSet


def _node_positions_np(shape, box_lo, box_hi, periodic) -> np.ndarray:
    lo, h = _node_spacing(shape, box_lo, box_hi, periodic)
    axes = [lo[d] + np.arange(n) * h[d] for d, n in enumerate(shape)]
    pts = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1)
    return pts.reshape(-1, len(shape)).astype(np.float32)


@functools.lru_cache(maxsize=4)
def _node_positions_dev(shape, box_lo, box_hi, periodic,
                        device: torch.device) -> torch.Tensor:
    return torch.from_numpy(
        _node_positions_np(shape, box_lo, box_hi, periodic)).to(device)


def node_positions(shape, box_lo, box_hi, periodic,
                   device="cpu") -> torch.Tensor:
    """(prod(shape), dim) f32 mesh-node coordinates, flat C-order — the
    node-centered layout of ``core.interp`` (node i at lo + i*h), built in
    float64 on the host and cast, as ``repro`` builds it. Kept on
    ``device`` per geometry; callers must not modify the result."""
    key = lambda t: tuple(float(v) for v in t)
    return _node_positions_dev(tuple(int(n) for n in shape), key(box_lo),
                               key(box_hi), tuple(bool(p) for p in periodic),
                               torch.device(device))


def _field_mag(flat_field: torch.Tensor) -> torch.Tensor:
    if flat_field.dim() == 1:
        return flat_field.abs()
    return torch.linalg.vector_norm(flat_field, dim=-1)


def seed_from_mesh(field: torch.Tensor, *, box_lo, box_hi, periodic,
                   threshold: float = 0.0, capacity: int = 0,
                   dim: int | None = None
                   ) -> Tuple[ParticleSet, torch.Tensor]:
    """Re-seed particles on mesh nodes with |field| >= threshold.

    ``field``: mesh tensor ``shape`` (scalar) or ``shape + (C,)``. Returns
    (ParticleSet with the node value in props["w"], overflow) where
    overflow (a 0-d int32 tensor) counts kept nodes that did not fit
    ``capacity`` (surplus nodes with the largest flat index are dropped).
    ``capacity`` defaults to the full node count. The dense branch's
    ``props["w"]`` is a view of ``field``."""
    dim = dim if dim is not None else len(box_lo)
    shape = tuple(field.shape[:dim])
    nodes = node_positions(shape, box_lo, box_hi, periodic, field.device)
    return _seed(field, nodes, threshold, capacity, dim)


def _seed(field, nodes, threshold, capacity, dim):
    """The re-seed of :func:`seed_from_mesh` on given node positions
    (prod(shape), dim)."""
    shape = tuple(field.shape[:dim])
    n_nodes = int(np.prod(shape))
    capacity = capacity or n_nodes
    dev = field.device
    flat = field.reshape((n_nodes,) + tuple(field.shape[dim:]))
    if threshold == 0.0 and capacity == n_nodes:
        # dense lattice: every node kept, in node order — skip the sort
        return (ParticleSet(x=nodes, props={"w": flat},
                            valid=torch.ones((n_nodes,), dtype=torch.bool,
                                             device=dev)),
                torch.zeros((), dtype=torch.int32, device=dev))
    keep = _field_mag(flat) >= threshold
    order = torch.argsort((~keep).to(torch.int8), stable=True)[:capacity]
    valid = keep[order]
    x = torch.where(valid[:, None], nodes[order],
                    torch.full((capacity, dim), ParticleSet.FILL,
                               dtype=torch.float32, device=dev))
    vshape = (1,) * (flat.dim() - 1)
    w = torch.where(valid.reshape((-1,) + vshape), flat[order],
                    torch.zeros((), dtype=flat.dtype, device=dev))
    overflow = torch.clamp(keep.sum() - capacity, min=0).to(torch.int32)
    return ParticleSet(x=x, props={"w": w}, valid=valid), overflow


def seed_from_block(block: torch.Tensor, row0, *, shape, box_lo, box_hi,
                    periodic, threshold: float = 0.0, capacity: int = 0
                    ) -> Tuple[ParticleSet, torch.Tensor]:
    """Per-slab re-seed: :func:`seed_from_mesh` over a local slab block.

    ``block`` holds rows [row0, row0 + n_local) of the global mesh that
    ``shape``/``box_lo``/``box_hi``/``periodic`` describe; ``row0`` is a
    0-d device tensor (or an int). Seeded particles carry global
    coordinates; thresholding and compaction are per block. A node's
    leading coordinate is formed as :func:`node_positions` forms it (lo +
    row·h in float64, then float32), so the block's particles equal the
    rows of :func:`seed_from_mesh`'s bit for bit (``repro`` adds the
    block's origin in float32, within an ulp of it)."""
    dim = len(shape)
    lo, h = _node_spacing(shape, box_lo, box_hi, periodic)
    dev = block.device
    bshape = tuple(block.shape[:dim])
    n_local = bshape[0]
    # the transverse axes of a local box with the global spacing
    local_lo = (0.0,) + tuple(float(v) for v in np.asarray(box_lo)[1:])
    local_hi = (float(n_local * h[0]),) + tuple(
        float(v) for v in np.asarray(box_hi)[1:])
    nodes = node_positions(bshape, local_lo, local_hi,
                           (True,) + tuple(periodic[1:]), dev)
    rows = torch.arange(n_local, device=dev) + row0
    x0 = (rows.to(torch.float64) * float(h[0]) + float(lo[0])).to(
        torch.float32)
    x0 = x0.repeat_interleave(int(np.prod(bshape[1:])))
    nodes = torch.cat([x0[:, None], nodes[:, 1:]], 1)
    return _seed(block, nodes, threshold, capacity, dim)


def seed_from_block2(block: torch.Tensor, row0, col0, *, shape, box_lo,
                     box_hi, periodic, threshold: float = 0.0,
                     capacity: int = 0) -> Tuple[ParticleSet, torch.Tensor]:
    """Per-pencil re-seed: :func:`seed_from_mesh` over a local pencil block
    owning rows [row0, row0 + n0_local) × columns [col0, col0 + n1_local)
    of the global mesh (DESIGN.md §13); ``row0`` and ``col0`` are 0-d
    device tensors (or ints). Seeded particles carry global coordinates,
    each of the two leading ones formed as :func:`seed_from_block` forms
    its one (float64, then float32)."""
    dim = len(shape)
    lo, h = _node_spacing(shape, box_lo, box_hi, periodic)
    dev = block.device
    bshape = tuple(block.shape[:dim])
    n0, n1 = bshape[0], bshape[1]
    local_lo = (0.0, 0.0) + tuple(float(v) for v in np.asarray(box_lo)[2:])
    local_hi = (float(n0 * h[0]), float(n1 * h[1])) + tuple(
        float(v) for v in np.asarray(box_hi)[2:])
    nodes = node_positions(bshape, local_lo, local_hi,
                           (True, True) + tuple(periodic[2:]), dev)

    def coord(origin, n, axis):
        rows = torch.arange(n, device=dev) + origin
        return (rows.to(torch.float64) * float(h[axis])
                + float(lo[axis])).to(torch.float32)

    rest = int(np.prod(bshape[2:]))
    x0 = coord(row0, n0, 0).repeat_interleave(n1 * rest)
    x1 = coord(col0, n1, 1).repeat_interleave(rest).repeat(n0)
    nodes = torch.cat([x0[:, None], x1[:, None], nodes[:, 2:]], 1)
    return _seed(block, nodes, threshold, capacity, dim)


def remesh(x: torch.Tensor, w: torch.Tensor, valid: torch.Tensor, *, shape,
           box_lo, box_hi, periodic, threshold: float = 0.0,
           capacity: int = 0, interp: str = "scatter", cb: int = 4,
           cell_cap: int = 0, backend: str = "auto"):
    """Full remeshing step: P2M the particle quantity ``w`` onto the mesh,
    re-seed on significant nodes, compact into a fixed-capacity set.

    ``interp="scatter"`` deposits through ``core.interp.p2m``;
    ``interp="cells"`` through the bucketed owner-gather of
    ``kernels.m4_interp`` (``backend`` as there: ``"auto"`` launches the
    CUDA kernel for CUDA tensors). Returns (ParticleSet, mesh_field,
    overflow) — overflow sums bucket-capacity drops and kept nodes that
    did not fit ``capacity``; non-zero means re-provision.
    """
    kw = dict(shape=tuple(shape), box_lo=box_lo, box_hi=box_hi,
              periodic=periodic)
    if interp == "cells":
        from repro_torch.kernels.m4_interp import ops as M4
        field, bucket_ovf = M4.p2m(x, w, valid, cb=cb, cell_cap=cell_cap,
                                   backend=backend, return_overflow=True,
                                   **kw)
    elif interp == "scatter":
        field = IP.p2m(x, w, valid, **kw)
        bucket_ovf = torch.zeros((), dtype=torch.int32, device=x.device)
    else:
        raise ValueError(f"unknown interp {interp!r}; want 'cells' or "
                         "'scatter'")
    ps, seed_ovf = seed_from_mesh(field, box_lo=box_lo, box_hi=box_hi,
                                  periodic=periodic, threshold=threshold,
                                  capacity=capacity, dim=len(shape))
    return ps, field, bucket_ovf + seed_ovf
