"""Cell lists (port of ``repro.core.cell_list``, paper §2, §4.1).

Particles are binned into a Cartesian cell grid sized by the cutoff; each
cell stores a dense ``(cell_cap,)`` row of particle indices (sentinel =
``cap``, an always-invalid slot), plus a trailing trash row that collects
invalid particles. Built with one stable sort, on the particles' device.
Exceeding ``cell_cap`` is detected (``overflow``), never clamped.

:func:`build_verlet` builds fixed-degree Verlet (contact) lists from a
cell list, in particle batches.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from .particles import ParticleSet, const_tensor


def grid_shape_for(box_lo, box_hi, r_cut: float,
                   skin: float = 0.0) -> Tuple[int, ...]:
    """Static cell-grid shape: cells no smaller than ``r_cut + skin`` per
    axis."""
    lo = np.asarray(box_lo, np.float64)
    hi = np.asarray(box_hi, np.float64)
    n = np.maximum(np.floor((hi - lo) / (r_cut + skin)).astype(int), 1)
    return tuple(int(v) for v in n)


def neighbor_offsets(dim: int) -> np.ndarray:
    """All 3^dim offsets (including zero) — the 27-neighborhood in 3D."""
    rng = [(-1, 0, 1)] * dim
    return np.stack(np.meshgrid(*rng, indexing="ij"), axis=-1).reshape(-1, dim)


@dataclasses.dataclass(frozen=True)
class CellList:
    """Dense cell list. ``cells`` has an extra trailing trash row (index
    ``n_cells``) collecting invalid particles."""

    cells: torch.Tensor        # (n_cells + 1, cell_cap) int32 particle indices
    counts: torch.Tensor       # (n_cells + 1,) int32
    cell_id: torch.Tensor      # (cap,) int32 flat cell per particle slot
    overflow: torch.Tensor     # () int32: max bucket excess over cell_cap
    grid_shape: Tuple[int, ...]
    periodic: Tuple[bool, ...]
    box_lo: Tuple[float, ...]
    box_hi: Tuple[float, ...]

    @property
    def n_cells(self) -> int:
        return int(np.prod(self.grid_shape))

    @property
    def cell_cap(self) -> int:
        return self.cells.shape[1]

    @property
    def dim(self) -> int:
        return len(self.grid_shape)


def _strides(grid_shape) -> np.ndarray:
    """Row-major flat-cell strides of ``grid_shape``."""
    return np.concatenate([np.cumprod(grid_shape[::-1])[::-1][1:],
                           [1]]).astype(np.int64)


def _flat_cell_of(x, valid, box_lo, box_hi, grid_shape):
    dev = x.device
    lo = const_tensor(tuple(float(v) for v in box_lo), x.dtype, dev)
    hi = const_tensor(tuple(float(v) for v in box_hi), x.dtype, dev)
    shape = const_tensor(tuple(int(v) for v in grid_shape), torch.int32, dev)
    strides = const_tensor(tuple(int(v) for v in _strides(grid_shape)),
                           torch.int32, dev)
    n_cells = int(np.prod(grid_shape))
    frac = (x - lo) / (hi - lo)
    # clamp while still floating, so FILL coordinates never reach an
    # out-of-range float→int conversion; identical to clip-after-cast for
    # every in-range value
    ixf = torch.floor(frac * shape)
    ix = torch.minimum(torch.clamp(ixf, min=0.0), shape - 1).to(torch.int32)
    flat = (ix * strides).sum(-1, dtype=torch.int32)
    return torch.where(valid, flat, torch.full_like(flat, n_cells))


def build_cell_list(ps: ParticleSet, *, box_lo, box_hi, grid_shape,
                    periodic, cell_cap: int) -> CellList:
    cap = ps.capacity
    dev = ps.device
    n_cells = int(np.prod(grid_shape))
    cell_id = _flat_cell_of(ps.x, ps.valid, box_lo, box_hi, grid_shape)
    order = torch.argsort(cell_id, stable=True)
    sorted_cells = cell_id[order]
    # rank of each particle within its cell
    start = torch.searchsorted(sorted_cells, sorted_cells, side="left")
    rank = torch.arange(cap, device=dev) - start
    # torch's scatter has no drop mode: ranks past cell_cap (trash row
    # included) go to one dump slot past the end, sliced off below
    n_slots = (n_cells + 1) * cell_cap
    dest = torch.where(rank < cell_cap, sorted_cells.long() * cell_cap + rank,
                       torch.full_like(rank, n_slots))
    cells = torch.full((n_slots + 1,), cap, dtype=torch.int32, device=dev)
    cells[dest] = order.to(torch.int32)
    cells = cells[:n_slots].view(n_cells + 1, cell_cap)
    counts = torch.zeros(n_cells + 1, dtype=torch.int32, device=dev)
    counts.index_add_(0, cell_id, torch.ones_like(cell_id))
    overflow = torch.clamp(counts[:n_cells].max() - cell_cap, min=0)
    return CellList(cells=cells, counts=counts, cell_id=cell_id,
                    overflow=overflow, grid_shape=tuple(grid_shape),
                    periodic=tuple(periodic), box_lo=tuple(box_lo),
                    box_hi=tuple(box_hi))


@functools.lru_cache(maxsize=None)
def _neighborhood_np(grid_shape, periodic, box_lo, box_hi):
    """Host numpy (cells, shifts) of one static geometry."""
    gs = np.asarray(grid_shape)
    dim = len(grid_shape)
    n_cells = int(np.prod(gs))
    coords = np.stack(np.meshgrid(*[np.arange(s) for s in gs], indexing="ij"),
                      axis=-1).reshape(-1, dim)
    offs = neighbor_offsets(dim)                       # (K, dim)
    nb = coords[:, None, :] + offs[None, :, :]          # (n_cells, K, dim)
    flat = np.zeros(nb.shape[:2], np.int64)
    valid = np.ones(nb.shape[:2], bool)
    strides = _strides(gs)
    L = np.asarray(box_hi) - np.asarray(box_lo)
    shifts = np.zeros(nb.shape, np.float32)
    for d in range(dim):
        c = nb[..., d]
        if periodic[d]:
            shifts[..., d] = (c // gs[d]) * L[d]
            c = np.mod(c, gs[d])
        else:
            valid &= (c >= 0) & (c < gs[d])
            c = np.clip(c, 0, gs[d] - 1)
        flat += c * strides[d]
    flat = np.where(valid, flat, n_cells)
    return flat.astype(np.int32), shifts


@functools.lru_cache(maxsize=None)
def _neighborhood_dev(grid_shape, periodic, box_lo, box_hi, device):
    cells, shifts = _neighborhood_np(grid_shape, periodic, box_lo, box_hi)
    return (torch.from_numpy(cells).to(device),
            torch.from_numpy(shifts).to(device))


def neighborhood(cl: CellList) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 3^dim cell-neighborhood enumeration: (cells, shifts), consumed
    zipped per (cell, K-slot).

    cells  — (n_cells, 3^dim) int32 flat ids of each cell's neighborhood
             (self included); non-periodic out-of-range neighbors point at
             the trash row.
    shifts — (n_cells, 3^dim, dim) float32 box shift of each neighbor cell
             relative to the home cell's frame (-L below the box, +L above,
             0 in range), so the direct displacement to a shifted neighbor
             equals the periodic image displacement for any grid size.

    The tables depend only on the static geometry. They are built once on
    the host and kept on the device per geometry (``repro`` recomputes
    them at trace time only; an eager step must not copy them per step).
    """
    return _neighborhood_dev(tuple(cl.grid_shape), tuple(cl.periodic),
                             tuple(cl.box_lo), tuple(cl.box_hi),
                             cl.cells.device)


def neighborhood_cells(cl: CellList) -> torch.Tensor:
    """(n_cells, 3^dim) flat neighborhood ids (see :func:`neighborhood`)."""
    return neighborhood(cl)[0]


def neighborhood_shifts(cl: CellList) -> torch.Tensor:
    """(n_cells, 3^dim, dim) neighbor box shifts (see :func:`neighborhood`)."""
    return neighborhood(cl)[1]


@dataclasses.dataclass(frozen=True)
class VerletList:
    """Fixed-degree neighbor matrix."""

    nbr: torch.Tensor        # (cap, k_max) int32 neighbor indices (cap = none)
    n_nbr: torch.Tensor      # (cap,) int32
    overflow: torch.Tensor   # () int32 max excess over k_max
    x_build: torch.Tensor    # positions at build time (for skin criterion)

    @property
    def k_max(self) -> int:
        return self.nbr.shape[1]


#: Particles per batch of :func:`build_verlet` (``repro``'s ``lax.map``
#: batch size).
_VERLET_BATCH = 4096


def build_verlet(ps: ParticleSet, cl: CellList, r_verlet: float,
                 k_max: int, half: bool = False) -> VerletList:
    """Build (cap, k_max) neighbor lists within ``r_verlet`` from a cell
    list, :data:`_VERLET_BATCH` particles at a time.

    ``half=True`` builds the symmetric list (j > i only), the paper's
    symmetric-interaction optimization (§4.1): each pair appears once.
    Each row lists the first ``k_max`` hits in candidate order (the K
    neighbor cells in ``neighbor_offsets`` order, slots in cell order);
    ``n_nbr`` counts all hits, so ``overflow`` reports the excess.

    Caveat (as in ``repro``): periodic images are resolved by minimum
    image over the listed index, so a periodic grid axis needs >= 3 cells.
    """
    cap = ps.capacity
    dev = ps.device
    hood = neighborhood_cells(cl)                      # (n_cells, K)
    K = hood.shape[1]
    cc = cl.cell_cap
    n_cells = cl.n_cells
    xm = ps.masked_x()
    rv2 = r_verlet * r_verlet
    nbr = torch.empty((cap, k_max), dtype=torch.int32, device=dev)
    n_nbr = torch.empty((cap,), dtype=torch.int32, device=dev)
    for b0 in range(0, cap, _VERLET_BATCH):
        i = torch.arange(b0, min(b0 + _VERLET_BATCH, cap), device=dev)
        B = i.shape[0]
        ci = cl.cell_id[i]     # in [0, n_cells]; n_cells = trash (invalid)
        cand = cl.cells[hood[ci.clamp(max=n_cells - 1).long()].long()]
        cand = torch.where((ci < n_cells)[:, None, None], cand,
                           torch.full_like(cand, cap)).reshape(B, K * cc)
        xj = torch.where((cand < cap)[..., None],
                         xm[cand.clamp(max=cap - 1).long()],
                         torch.full((), ParticleSet.FILL, device=dev))
        d = _min_image(xm[i][:, None, :] - xj, cl)
        r2 = (d * d).sum(-1)
        ok = (r2 < rv2) & (cand != i[:, None]) & (cand < cap)
        if half:
            ok &= cand > i[:, None]
        # stable selection of the first k_max hits; the rest go to a dump
        # column past the end
        rank = torch.cumsum(ok, dim=1) - 1
        dest = torch.where(ok & (rank < k_max), rank,
                           torch.full_like(rank, k_max))
        out = torch.full((B, k_max + 1), cap, dtype=torch.int32, device=dev)
        out.scatter_(1, dest, cand)
        nbr[b0:b0 + B] = out[:, :k_max]
        n_nbr[b0:b0 + B] = ok.sum(1)
    overflow = torch.clamp(n_nbr.max() - k_max, min=0)
    return VerletList(nbr=nbr, n_nbr=n_nbr, overflow=overflow, x_build=ps.x)


def _min_image(dx: torch.Tensor, cl: CellList) -> torch.Tensor:
    """Minimum-image displacement on periodic axes."""
    L = const_tensor(tuple(float(h) - float(l)
                           for l, h in zip(cl.box_lo, cl.box_hi)),
                     dx.dtype, dx.device)
    per = const_tensor(tuple(bool(p) for p in cl.periodic), torch.bool,
                       dx.device)
    wrapped = dx - L * torch.round(dx / L)
    # Guard FILL sentinels: enormous dx stays enormous.
    return torch.where(per, torch.where(dx.abs() < 0.6e30, wrapped, dx), dx)


def moved_beyond(x: torch.Tensor, x_build: torch.Tensor, valid: torch.Tensor,
                 skin: float) -> torch.Tensor:
    """Verlet skin criterion on raw positions: True when any valid particle
    moved more than skin/2 since ``x_build``."""
    d = torch.where(valid[:, None], x - x_build, torch.zeros_like(x))
    moved2 = (d * d).sum(-1)
    return moved2.max() > (0.5 * skin) ** 2


def needs_rebuild(ps: ParticleSet, vl: VerletList,
                  skin: float) -> torch.Tensor:
    """Verlet skin criterion: rebuild when any particle moved > skin/2
    since ``vl`` was built (a 0-d bool tensor on the device)."""
    return moved_beyond(ps.x, vl.x_build, ps.valid, skin)
