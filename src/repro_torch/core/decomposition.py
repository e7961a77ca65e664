"""Three-phase domain decomposition (paper §3.2, Fig. 1).

Phase 1 — *decomposition*: split the physical domain into a Cartesian grid of
sub-sub-domains (at least as many as processors, typically much more).

Phase 2 — *distribution*: assign sub-sub-domains to processors either by
weighted graph partitioning (ParMetis replacement in ``graph_partition.py``)
or along a Hilbert space-filling curve (``hilbert.py``).

Phase 3 — *sub-domain creation*: on each processor, greedily merge cuboidal
blocks of same-processor sub-sub-domains into larger sub-domains to minimize
ghost-layer surface. We implement the paper's seed-and-expand heuristic
verbatim: grow a box around a seed, one layer per direction at a time, until
blocked; repeat from the next unassigned boundary cell.

All host-side NumPy (control plane): the port's own copy of
``repro.core.decomposition``. The resulting ``Decomposition`` is the
static metadata the data plane (particles.py / grid.py, and the
multi-device mappings, ``core.mappings``) shards against.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from .domain import Domain
from . import graph_partition as gp
from .hilbert import hilbert_order


@dataclasses.dataclass(frozen=True)
class SubDomain:
    """A merged cuboidal block of sub-sub-domains, in grid coordinates
    [lo, hi) and physical coordinates [plo, phi)."""

    owner: int
    lo: Tuple[int, ...]
    hi: Tuple[int, ...]
    plo: Tuple[float, ...]
    phi: Tuple[float, ...]

    @property
    def n_cells(self) -> int:
        return int(np.prod(np.array(self.hi) - np.array(self.lo)))

    def surface_cells(self) -> int:
        ext = np.array(self.hi) - np.array(self.lo)
        vol = np.prod(ext)
        inner = np.prod(np.maximum(ext - 2, 0))
        return int(vol - inner)


@dataclasses.dataclass
class Decomposition:
    """Full decomposition state."""

    domain: Domain
    grid_shape: Tuple[int, ...]          # sub-sub-domain grid
    assignment: np.ndarray               # (n_ssd,) processor id per sub-sub-domain
    nparts: int
    subdomains: List[SubDomain]
    graph: gp.Graph

    @property
    def dim(self) -> int:
        return self.domain.dim

    @property
    def n_ssd(self) -> int:
        return int(np.prod(self.grid_shape))

    def cell_of_position(self, x: np.ndarray) -> np.ndarray:
        """Flat sub-sub-domain index for positions (…, dim)."""
        lo = np.asarray(self.domain.box.low)
        lengths = self.domain.box.lengths
        shape = np.asarray(self.grid_shape)
        ix = np.floor((x - lo) / lengths * shape).astype(np.int64)
        ix = np.clip(ix, 0, shape - 1)
        return np.ravel_multi_index(tuple(ix[..., d] for d in range(self.dim)),
                                    self.grid_shape)

    def owner_of_position(self, x: np.ndarray) -> np.ndarray:
        """Processor owning each position (…, dim)."""
        return self.assignment[self.cell_of_position(x)]

    def loads(self) -> np.ndarray:
        return np.bincount(self.assignment, weights=self.graph.vwgt,
                           minlength=self.nparts)

    def imbalance(self) -> float:
        return gp.imbalance(self.graph, self.assignment, self.nparts)

    def edge_cut(self) -> float:
        return gp.edge_cut(self.graph, self.assignment)


def _merge_subdomains(grid_shape: Tuple[int, ...], assignment: np.ndarray,
                      domain: Domain) -> List[SubDomain]:
    """Phase 3 — greedy seed-and-expand merge (paper §3.2, third phase)."""
    dim = len(grid_shape)
    part_nd = assignment.reshape(grid_shape)
    taken = np.zeros(grid_shape, bool)
    subdomains: List[SubDomain] = []
    lo_phys = np.asarray(domain.box.low)
    cell_len = domain.box.lengths / np.asarray(grid_shape)

    # iterate seeds in flat indexing order, as the paper specifies
    flat_part = part_nd.reshape(-1)
    flat_taken = taken.reshape(-1)
    for seed in range(flat_part.size):
        if flat_taken[seed]:
            continue
        owner = int(flat_part[seed])
        lo = np.array(np.unravel_index(seed, grid_shape), np.int64)
        hi = lo + 1
        # expand by one layer per direction, round-robin over +X,+Y,..,-X,-Y,..
        progress = True
        while progress:
            progress = False
            for ax in range(dim):
                for sgn in (+1, -1):
                    if sgn > 0:
                        if hi[ax] >= grid_shape[ax]:
                            continue
                        sl = tuple(
                            slice(hi[a], hi[a] + 1) if a == ax else slice(lo[a], hi[a])
                            for a in range(dim))
                    else:
                        if lo[ax] <= 0:
                            continue
                        sl = tuple(
                            slice(lo[a] - 1, lo[a]) if a == ax else slice(lo[a], hi[a])
                            for a in range(dim))
                    block_owner = part_nd[sl]
                    block_taken = taken[sl]
                    if np.all(block_owner == owner) and not block_taken.any():
                        if sgn > 0:
                            hi[ax] += 1
                        else:
                            lo[ax] -= 1
                        progress = True
        sl = tuple(slice(lo[a], hi[a]) for a in range(dim))
        taken[sl] = True
        flat_taken = taken.reshape(-1)
        subdomains.append(SubDomain(
            owner=owner,
            lo=tuple(int(v) for v in lo),
            hi=tuple(int(v) for v in hi),
            plo=tuple(float(v) for v in lo_phys + lo * cell_len),
            phi=tuple(float(v) for v in lo_phys + hi * cell_len),
        ))
    return subdomains


def decompose(domain: Domain, nparts: int, *,
              ssd_per_part: int = 8,
              grid_shape: Optional[Tuple[int, ...]] = None,
              vwgt: Optional[np.ndarray] = None,
              method: str = "graph") -> Decomposition:
    """Build the initial decomposition.

    ``ssd_per_part`` controls granularity: the sub-sub-domain count is at
    least ``nparts * ssd_per_part`` (paper: 'typically much larger' than the
    number of processors). ``method`` is 'graph' (ParMetis-style) or
    'hilbert' (space-filling curve), matching the paper's two options.
    """
    dim = domain.dim
    if grid_shape is None:
        # roughly isotropic grid with >= nparts * ssd_per_part cells
        n_target = max(1, nparts * ssd_per_part)
        per_axis = int(np.ceil(n_target ** (1.0 / dim)))
        # round up to power of two for Hilbert friendliness
        per_axis = 1 << (per_axis - 1).bit_length()
        grid_shape = (per_axis,) * dim
    grid_shape = tuple(int(s) for s in grid_shape)

    g = gp.grid_graph(grid_shape, vwgt=vwgt, periodic=domain.bc.periodic_mask)

    coords = np.stack(np.meshgrid(*[np.arange(s) for s in grid_shape],
                                  indexing="ij"), axis=-1).reshape(-1, dim)
    bits = max(int(np.ceil(np.log2(max(grid_shape)))), 1)
    order = hilbert_order(coords, bits)

    if method == "hilbert":
        # contiguous cost-balanced chunks along the Hilbert curve
        w = g.vwgt[order]
        cum = np.cumsum(w)
        total = cum[-1]
        bounds = total * (np.arange(1, nparts) / nparts)
        labels_sorted = np.searchsorted(cum - 1e-12, bounds).astype(np.int64)
        part_sorted = np.zeros(g.num_vertices, np.int64)
        prev = 0
        for p, b in enumerate(labels_sorted):
            part_sorted[prev:b] = p
            prev = b
        part_sorted[prev:] = nparts - 1
        assignment = np.empty(g.num_vertices, np.int64)
        assignment[order] = part_sorted
    elif method == "graph":
        assignment = gp.partition(g, nparts, seed_order=order)
    else:
        raise ValueError(f"unknown decomposition method {method!r}")

    subs = _merge_subdomains(grid_shape, assignment, domain)
    return Decomposition(domain=domain, grid_shape=grid_shape,
                         assignment=assignment, nparts=nparts,
                         subdomains=subs, graph=g)


def rebalance(dec: Decomposition, new_vwgt: np.ndarray,
              migration_cost: Optional[np.ndarray] = None,
              steps_since_rebalance: int = 1) -> Decomposition:
    """DLB re-decomposition (paper §3.5): keep the sub-sub-domain grid, update
    vertex costs, repartition with migration-cost soft constraint, re-merge."""
    g = gp.Graph(indptr=dec.graph.indptr, indices=dec.graph.indices,
                 vwgt=np.asarray(new_vwgt, np.float64), ewgt=dec.graph.ewgt)
    if migration_cost is None:
        migration_cost = np.asarray(new_vwgt, np.float64)
    assignment = gp.repartition(g, dec.assignment, dec.nparts, migration_cost,
                                steps_since_rebalance=steps_since_rebalance)
    subs = _merge_subdomains(dec.grid_shape, assignment, dec.domain)
    return Decomposition(domain=dec.domain, grid_shape=dec.grid_shape,
                         assignment=assignment, nparts=dec.nparts,
                         subdomains=subs, graph=g)
