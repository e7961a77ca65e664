"""Weighted graph partitioning — the ParMetis replacement (paper §3.2, §3.5;
the port's own copy of ``repro.core.graph_partition``, NumPy only).

OpenFPM models sub-sub-domain→processor assignment as graph partitioning:
vertices are sub-sub-domains weighted by computational cost ``c_i``; edges are
weighted by communication volume ``e_ij``. We implement:

  * ``partition``      — initial k-way partition: greedy BFS region growing
                         (cost-balanced) followed by Fiduccia–Mattheyses-style
                         boundary refinement minimizing the weighted edge cut.
  * ``repartition``    — DLB re-assignment with per-vertex migration cost
                         ``m_i`` as a soft constraint (paper §3.5): boundary
                         moves are accepted only if gain > discounted
                         migration cost.

Pure NumPy, host-side control plane. Deterministic given the same inputs.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np


@dataclasses.dataclass
class Graph:
    """Compressed-sparse adjacency with vertex and edge weights."""

    indptr: np.ndarray   # (V+1,) int64
    indices: np.ndarray  # (E,) int64 neighbor vertex ids
    vwgt: np.ndarray     # (V,) float64 vertex (compute) weights
    ewgt: np.ndarray     # (E,) float64 edge (communication) weights

    @property
    def num_vertices(self) -> int:
        return len(self.vwgt)

    def neighbors(self, v: int) -> Tuple[np.ndarray, np.ndarray]:
        s, e = self.indptr[v], self.indptr[v + 1]
        return self.indices[s:e], self.ewgt[s:e]


def grid_graph(shape: Tuple[int, ...], vwgt: np.ndarray | None = None,
               periodic: np.ndarray | None = None) -> Graph:
    """Build the face-adjacency graph of a Cartesian grid of sub-sub-domains.

    Edge weights default to 1 (uniform ghost area); vertex weights default to
    1 (uniform cost). ``periodic`` is a per-axis bool mask adding wrap edges.
    """
    shape = tuple(int(s) for s in shape)
    dim = len(shape)
    V = int(np.prod(shape))
    if vwgt is None:
        vwgt = np.ones(V, np.float64)
    vwgt = np.asarray(vwgt, np.float64).reshape(V)
    if periodic is None:
        periodic = np.zeros(dim, bool)

    coords = np.stack(np.meshgrid(*[np.arange(s) for s in shape], indexing="ij"),
                      axis=-1).reshape(V, dim)
    rows: List[np.ndarray] = []
    cols: List[np.ndarray] = []
    for ax in range(dim):
        for sgn in (-1, +1):
            nb = coords.copy()
            nb[:, ax] += sgn
            if periodic[ax]:
                nb[:, ax] %= shape[ax]
                valid = np.ones(V, bool)
                # degenerate axis (size 1 or 2 with wrap duplicating edges) is ok
                if shape[ax] == 1:
                    valid[:] = False
            else:
                valid = (nb[:, ax] >= 0) & (nb[:, ax] < shape[ax])
            flat = np.ravel_multi_index(
                tuple(np.clip(nb[:, a], 0, shape[a] - 1) for a in range(dim)), shape)
            rows.append(np.nonzero(valid)[0])
            cols.append(flat[valid])
    r = np.concatenate(rows)
    c = np.concatenate(cols)
    # dedupe (possible with periodic wrap on size-2 axes)
    key = r.astype(np.int64) * V + c.astype(np.int64)
    _, uniq = np.unique(key, return_index=True)
    r, c = r[uniq], c[uniq]
    order = np.lexsort((c, r))
    r, c = r[order], c[order]
    indptr = np.zeros(V + 1, np.int64)
    np.add.at(indptr, r + 1, 1)
    indptr = np.cumsum(indptr)
    return Graph(indptr=indptr, indices=c.astype(np.int64), vwgt=vwgt,
                 ewgt=np.ones(len(c), np.float64))


def _greedy_grow(g: Graph, nparts: int, seed_order: np.ndarray) -> np.ndarray:
    """Greedy cost-balanced BFS region growing, the paper's linear-time style
    heuristic (§3.2 sub-domain creation uses the same greedy spirit)."""
    V = g.num_vertices
    total = g.vwgt.sum()
    target = total / nparts
    part = np.full(V, -1, np.int64)
    load = np.zeros(nparts, np.float64)
    unassigned = V
    cursor = 0
    for p in range(nparts):
        # find an unassigned seed (in seed_order, e.g. Hilbert order for locality)
        while cursor < V and part[seed_order[cursor]] != -1:
            cursor += 1
        if cursor >= V:
            break
        frontier = [int(seed_order[cursor])]
        while frontier and load[p] < target and unassigned > 0:
            v = frontier.pop()
            if part[v] != -1:
                continue
            part[v] = p
            load[p] += g.vwgt[v]
            unassigned -= 1
            nbrs, _ = g.neighbors(v)
            for u in nbrs:
                if part[u] == -1:
                    frontier.append(int(u))
    # any leftovers go to the least-loaded neighboring part (or least loaded)
    leftovers = np.nonzero(part == -1)[0]
    for v in leftovers[np.argsort(-g.vwgt[leftovers])]:
        nbrs, _ = g.neighbors(int(v))
        nbp = part[nbrs]
        nbp = nbp[nbp >= 0]
        cand = np.unique(nbp) if len(nbp) else np.arange(nparts)
        p = int(cand[np.argmin(load[cand])])
        part[v] = p
        load[p] += g.vwgt[v]
    return part


def edge_cut(g: Graph, part: np.ndarray) -> float:
    """Total weight of edges crossing partition boundaries (each edge counted
    once)."""
    src = np.repeat(np.arange(g.num_vertices), np.diff(g.indptr))
    cross = part[src] != part[g.indices]
    return float(g.ewgt[cross].sum() / 2.0)


def imbalance(g: Graph, part: np.ndarray, nparts: int) -> float:
    """max load / mean load - 1."""
    load = np.bincount(part, weights=g.vwgt, minlength=nparts)
    mean = load.mean()
    return float(load.max() / mean - 1.0) if mean > 0 else 0.0


def _refine(g: Graph, part: np.ndarray, nparts: int, *, max_passes: int = 8,
            balance_tol: float = 0.05, migration_cost: np.ndarray | None = None,
            mig_scale: float = 0.0) -> np.ndarray:
    """FM-style boundary refinement. A vertex moves to a neighboring part if
    it reduces (cut + mig_scale * migration) without violating balance."""
    part = part.copy()
    V = g.num_vertices
    load = np.bincount(part, weights=g.vwgt, minlength=nparts).astype(np.float64)
    target = g.vwgt.sum() / nparts
    max_load = target * (1.0 + balance_tol)
    orig = part.copy() if migration_cost is not None else None
    # weight of the balance objective relative to the cut objective: typical
    # edge weight — lets overloaded parts shed vertices even at a cut loss
    ew_typ = float(g.ewgt.mean()) if len(g.ewgt) else 1.0

    for _ in range(max_passes):
        moved = 0
        # boundary vertices only
        src = np.repeat(np.arange(V), np.diff(g.indptr))
        boundary = np.unique(src[part[src] != part[g.indices]])
        for v in boundary:
            pv = part[v]
            nbrs, w = g.neighbors(int(v))
            if len(nbrs) == 0:
                continue
            # connectivity of v to each candidate part
            cand_parts = np.unique(part[nbrs])
            conn = {int(p): float(w[part[nbrs] == p].sum()) for p in cand_parts}
            internal = conn.get(int(pv), 0.0)
            best_gain, best_p = 0.0, -1
            for p, ext in conn.items():
                if p == pv:
                    continue
                gain = ext - internal
                if migration_cost is not None:
                    # moving back toward original location refunds migration
                    was, now = orig[v] == pv, orig[v] == p
                    if was and not now:
                        gain -= mig_scale * migration_cost[v]
                    elif now and not was:
                        gain += mig_scale * migration_cost[v]
                # balance term: overloaded parts shed vertices even at a
                # cut loss, proportional to how much the move helps balance
                if load[pv] > max_load and load[p] + g.vwgt[v] < load[pv]:
                    gain += ew_typ * (load[pv] - load[p] - g.vwgt[v]) / \
                        max(target, 1e-12)
                elif load[p] + g.vwgt[v] > max_load:
                    continue
                if gain > best_gain:
                    best_gain, best_p = gain, int(p)
            if best_p >= 0:
                load[pv] -= g.vwgt[v]
                load[best_p] += g.vwgt[v]
                part[v] = best_p
                moved += 1
        if moved == 0:
            break
    return part


def partition(g: Graph, nparts: int, seed_order: np.ndarray | None = None,
              balance_tol: float = 0.05) -> np.ndarray:
    """Initial k-way partition (paper §3.2 'distribution' phase)."""
    if nparts <= 0:
        raise ValueError("nparts must be positive")
    if nparts == 1:
        return np.zeros(g.num_vertices, np.int64)
    if seed_order is None:
        seed_order = np.arange(g.num_vertices)
    part = _greedy_grow(g, nparts, np.asarray(seed_order))
    return _refine(g, part, nparts, balance_tol=balance_tol)


def repartition(g: Graph, current: np.ndarray, nparts: int,
                migration_cost: np.ndarray, steps_since_rebalance: int = 1,
                balance_tol: float = 0.05) -> np.ndarray:
    """DLB re-assignment (paper §3.5): refine from the *current* partition,
    with migration cost linearly discounted over time steps since the last
    rebalancing, so the new decomposition stays close to the old one."""
    mig_scale = 1.0 / max(1, steps_since_rebalance)
    return _refine(g, np.asarray(current, np.int64).copy(), nparts,
                   migration_cost=np.asarray(migration_cost, np.float64),
                   mig_scale=mig_scale, balance_tol=balance_tol, max_passes=16)
