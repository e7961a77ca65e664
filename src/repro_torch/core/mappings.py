"""Mappings — OpenFPM's communication-only abstractions (port of
``repro.core.mappings``; paper §3.4).

  * ``map()``       →  fixed-capacity per-destination buckets, every field
                       in one ``all_to_all`` with equal splits; overflow is
                       counted and surfaced, never dropped silently.
  * ``ghost_get()`` →  ±h ring ``ppermute`` shifts along the mesh axis,
                       multi-hop, with property subsets, the periodic ±L
                       seam shift and the non-periodic wrap mask.
  * ``ghost_put()`` →  the reverse shifts and a masked scatter-reduce
                       (sum / max / min).

The decomposition is the adaptive slab of ``repro``: rank d owns
``bounds[d] <= x[slab_axis] < bounds[d + 1]``, ``bounds`` a replicated
device tensor. Every function here is the local (per-rank) function of
``repro``'s shard_map and keeps its signature; collectives come from
``runtime``. Slots are assigned as ``repro`` assigns them (a stable sort
and ``searchsorted(side="left")`` for buckets, a cumsum rank for ghost
slots), so buckets, ghost slots and ``src_slot`` equal ``repro``'s
exactly; ``repro`` scatters every row and drops the surplus, the port
gathers each slot's row, so a pack touches its capacity's rows, not the
set's. Nothing here reads a device tensor on the host, and every shape
is static.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from . import runtime as RT
from .particles import ParticleSet


# --------------------------------------------------------------------------
# Dense per-destination buckets
# --------------------------------------------------------------------------

def bucket_pack(dest: torch.Tensor, payload: Dict[str, torch.Tensor],
                ndev: int, bucket_cap: int):
    """Pack rows of ``payload`` (dict of tensors, leading dim N) into dense
    buckets ``(ndev, bucket_cap, ...)`` by destination; ``dest >= ndev``
    means discard. Returns ``(buckets, slot_valid (ndev, bucket_cap) bool,
    overflow)``, overflow a 0-d int32: the largest bucket's excess.

    ``repro`` scatters each row to (dest, rank within dest) after a stable
    sort; here each bucket slot gathers its row from the same sort (slot
    c of bucket d is sorted row ``start[d] + c``), so the buckets are
    equal and only ``ndev * bucket_cap`` rows are touched, not N."""
    n = dest.shape[0]
    dev = dest.device
    dest = torch.clamp(dest, max=ndev)        # discards sort last
    order = torch.argsort(dest, stable=True)
    sorted_dest = dest[order].contiguous()
    d = torch.arange(ndev, dtype=sorted_dest.dtype, device=dev)
    start = torch.searchsorted(sorted_dest, d, side="left")
    counts = torch.searchsorted(sorted_dest, d, side="right") - start
    col = torch.arange(bucket_cap, device=dev)
    slot_valid = col[None, :] < counts[:, None]
    src = order[torch.clamp(start[:, None] + col[None, :], max=n - 1)]
    buckets = {k: _take(a, src, slot_valid) for k, a in payload.items()}
    overflow = torch.clamp(counts.max() - bucket_cap, min=0).to(torch.int32)
    return buckets, slot_valid, overflow


def _take(a: torch.Tensor, src: torch.Tensor,
          filled: torch.Tensor) -> torch.Tensor:
    """``a[src]`` where ``filled``, zeros elsewhere."""
    got = a[src]
    m = filled.reshape(filled.shape + (1,) * (got.dim() - filled.dim()))
    return torch.where(m, got, torch.zeros_like(got))


def owner_of(x_axis: torch.Tensor, bounds: torch.Tensor) -> torch.Tensor:
    """Rank owning coordinate values, given slab ``bounds`` (ndev+1,)."""
    idx = torch.searchsorted(bounds.contiguous(), x_axis.contiguous(),
                             right=True) - 1
    return torch.clamp(idx, 0, bounds.shape[0] - 2).to(torch.int32)


def map_particles_local(ps: ParticleSet, bounds: torch.Tensor,
                        axis_name: str, bucket_cap: int, slab_axis: int = 0,
                        drop_props: Tuple[str, ...] = ()):
    """The ``map()`` mapping, per rank. Returns ``(new_ps, overflow)``:
    overflow (0-d int32, the same on every rank) is the larger of the
    bucket overflow and the slot overflow; nonzero means capacities must
    be re-provisioned (retained particles stay consistent).
    ``drop_props`` stay out of the messages, and the particles that
    arrive carry zeros there: props the caller overwrites before it reads
    them (``repro``'s compiled step drops their all-to-alls as unread)."""
    ndev = RT.axis_size(axis_name)
    me = RT.axis_index(axis_name)
    dest = owner_of(ps.x[:, slab_axis], bounds)
    dest = torch.where(ps.valid, dest, torch.full_like(dest, ndev))
    stay = ps.valid & (dest == me)
    leaving = torch.where(ps.valid & ~stay, dest,
                          torch.full_like(dest, ndev))
    payload = {"x": ps.x, **{"p." + k: v for k, v in ps.props.items()
                             if k not in drop_props}}
    buckets, slot_valid, ovf = bucket_pack(leaving, payload, ndev,
                                           bucket_cap)
    names = list(buckets)
    recv = RT.all_to_all_many([buckets[k] for k in names] + [slot_valid],
                              axis_name)
    flat = {k: a.reshape((ndev * bucket_cap,) + tuple(a.shape[2:]))
            for k, a in zip(names, recv)}
    n_in = ndev * bucket_cap
    incoming = ParticleSet(
        x=flat["x"],
        props={k: (v.new_zeros((n_in,) + tuple(v.shape[1:]))
                   if k in drop_props else flat["p." + k])
               for k, v in ps.props.items()},
        valid=recv[-1].reshape(n_in))
    merged, add_ovf = ps.where(stay).add_count(incoming)
    total = RT.pmax(torch.maximum(ovf, add_ovf.to(torch.int32)), axis_name)
    return merged, total


# --------------------------------------------------------------------------
# ghost_get(): halo particles from the slab neighbours
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GhostLayer:
    """Halo particles received from slab neighbours. Layout
    ``(2K, ghost_cap, ...)`` for a K-hop exchange: rows ``0..K-1`` came
    from the left neighbours at hops ``1..K``, rows ``K..2K-1`` from the
    right ones. ``src_slot`` is the slot in the source rank's set, the
    provenance ``ghost_put`` routes contributions home by (None when the
    exchange did not ship it: ``ghost_get_start(src_slots=False)``)."""

    x: torch.Tensor                    # (2K, ghost_cap, dim)
    props: Dict[str, torch.Tensor]     # (2K, ghost_cap, ...)
    valid: torch.Tensor                # (2K, ghost_cap)
    src_slot: Optional[torch.Tensor]   # (2K, ghost_cap) int32

    @property
    def ghost_cap(self) -> int:
        return self.x.shape[1]

    @property
    def n_hops(self) -> int:
        return self.x.shape[0] // 2

    def as_particles(self) -> ParticleSet:
        rows = self.x.shape[0] * self.ghost_cap
        return ParticleSet(
            x=self.x.reshape(rows, -1),
            props={k: a.reshape((rows,) + tuple(a.shape[2:]))
                   for k, a in self.props.items()},
            valid=self.valid.reshape(rows))


def _dense_slots(sel: torch.Tensor, ghost_cap: int):
    """``repro``'s dense slots of the selected rows (the k-th selected row,
    in index order, takes slot k; the rest past ``ghost_cap`` overflow),
    as a gather: (source row of each slot, slot filled)."""
    csum = torch.cumsum(sel.to(torch.int32), 0)
    k = torch.arange(1, ghost_cap + 1, dtype=torch.int32, device=sel.device)
    src = torch.searchsorted(csum, k, side="left")
    return torch.clamp(src, max=sel.shape[0] - 1), k <= csum[-1]


def _pack_side(ps: ParticleSet, sel: torch.Tensor, ghost_cap: int):
    """Pack selected particles into dense ``(ghost_cap, ...)`` buffers,
    recording source slots. Returns (x, props, valid, src_slot,
    overflow); empty slots hold zeros, ``src_slot`` the capacity."""
    src, filled = _dense_slots(sel, ghost_cap)
    x = _take(ps.x, src, filled)
    props = {k: _take(a, src, filled) for k, a in ps.props.items()}
    src_slot = torch.where(filled, src.to(torch.int32),
                           torch.full_like(src, ps.capacity,
                                           dtype=torch.int32))
    overflow = torch.clamp(sel.sum() - ghost_cap, min=0).to(torch.int32)
    return x, props, filled, src_slot, overflow


def _hop_selection(xs, valid, bounds, r_ghost, me, ndev, h, box_len):
    """(near_lo, near_hi): the particles the hop-h left and right receivers
    need, by ``repro``'s thresholds in the sender's frame. The receiver at
    +h needs ``x >= bounds[me + h] - r_ghost``, the one at -h ``x <
    bounds[me - h + 1] + r_ghost``; an index off the bounds array folds
    back with a ±L shift (h == 1 never wraps)."""
    if h == 1:
        return (valid & (xs < bounds[me] + r_ghost),
                valid & (xs >= bounds[me + 1] - r_ghost))
    idx_r, idx_l = me + h, me - h + 1
    wrap_r, wrap_l = idx_r > ndev, idx_l < 0
    thresh_hi = (bounds[idx_r - ndev if wrap_r else idx_r]
                 + (box_len if wrap_r else 0.0) - r_ghost)
    thresh_lo = (bounds[idx_l + ndev if wrap_l else idx_l]
                 - (box_len if wrap_l else 0.0) + r_ghost)
    return valid & (xs < thresh_lo), valid & (xs >= thresh_hi)


def _shift_slab(x: torch.Tensor, slab_axis: int, shift: float):
    """x with ``shift`` added (in x's dtype) on the slab axis."""
    col = x[:, slab_axis] + shift
    return torch.cat([x[:, :slab_axis], col[:, None], x[:, slab_axis + 1:]],
                     1)


def _seam(me, ndev, h, periodic, box_len):
    """(shift of the from-left rows, of the from-right rows, from-left
    kept, from-right kept) of hop h: periodic ghosts that crossed the seam
    sit just outside the slab; non-periodic wrap links carry none."""
    if periodic:
        return (-box_len if me - h < 0 else 0.0,
                box_len if me + h >= ndev else 0.0, True, True)
    return 0.0, 0.0, me - h >= 0, me + h < ndev


def ghost_get_start(ps: ParticleSet, bounds: torch.Tensor, r_ghost: float,
                    axis_name: str, ghost_cap: int, *, periodic: bool,
                    box_len: float, slab_axis: int = 0,
                    prop_names: Optional[Tuple[str, ...]] = None,
                    n_hops: int = 1, src_slots: bool = True) -> RT.InFlight:
    """First half of :func:`ghost_get_local`: pack and issue every hop's
    shifts as one batch. ``.wait()`` on the result yields ``(GhostLayer,
    overflow)``; work scheduled in between overlaps the exchange.
    ``src_slots=False`` leaves the source slots out of the messages (the
    layer's ``src_slot`` is None): a step that never sends contributions
    home needs none, and ``repro``'s compiled step drops that exchange as
    unread."""
    ndev = RT.axis_size(axis_name)
    me = RT.axis_index(axis_name)
    xs = ps.x[:, slab_axis]
    names = tuple(ps.props) if prop_names is None else tuple(prop_names)
    ps_send = ps.replace(props={k: ps.props[k] for k in names})
    sends, overflows = [], []
    for h in range(1, n_hops + 1):
        near_lo, near_hi = _hop_selection(xs, ps.valid, bounds, r_ghost, me,
                                          ndev, h, box_len)
        lo_x, lo_p, lo_v, lo_s, ovf_lo = _pack_side(ps_send, near_lo,
                                                    ghost_cap)
        hi_x, hi_p, hi_v, hi_s, ovf_hi = _pack_side(ps_send, near_hi,
                                                    ghost_cap)
        right, left = RT.shift_perms(ndev, h)
        hi_s, lo_s = ([hi_s], [lo_s]) if src_slots else ([], [])
        # what I receive from my hop-h LEFT neighbour it sent rightwards
        sends.append(([hi_x, hi_v] + hi_s + [hi_p[k] for k in names], right))
        sends.append(([lo_x, lo_v] + lo_s + [lo_p[k] for k in names], left))
        overflows.append(torch.maximum(ovf_lo, ovf_hi))
    ovf = overflows[0]
    for o in overflows[1:]:
        ovf = torch.maximum(ovf, o)
    overflow = RT.pmax(ovf, axis_name)

    def assemble(received):
        sides_l, sides_r = [], []
        for h in range(1, n_hops + 1):
            shift_l, shift_r, keep_l, keep_r = _seam(me, ndev, h, periodic,
                                                     box_len)
            for got, shift, keep, out in (
                    (received[2 * h - 2], shift_l, keep_l, sides_l),
                    (received[2 * h - 1], shift_r, keep_r, sides_r)):
                x, v = got[:2]
                s = got[2] if src_slots else None
                out.append((_shift_slab(x, slab_axis, shift),
                            v if keep else torch.zeros_like(v), s,
                            dict(zip(names, got[2 + src_slots:]))))
        sides = sides_l + sides_r        # rows 0..K-1 left, K..2K-1 right
        ghosts = GhostLayer(
            x=torch.stack([s[0] for s in sides]),
            props={k: torch.stack([s[3][k] for s in sides]) for k in names},
            valid=torch.stack([s[1] for s in sides]),
            src_slot=torch.stack([s[2] for s in sides]) if src_slots
            else None)
        return ghosts, overflow

    return RT.ppermute_many_start(sends, axis_name).then(assemble)


def ghost_get_local(ps: ParticleSet, bounds: torch.Tensor, r_ghost: float,
                    axis_name: str, ghost_cap: int, *, periodic: bool,
                    box_len: float, slab_axis: int = 0,
                    prop_names: Optional[Tuple[str, ...]] = None,
                    n_hops: int = 1, src_slots: bool = True
                    ) -> Tuple[GhostLayer, torch.Tensor]:
    """The ``ghost_get`` mapping, per rank: send particles within
    ``r_ghost`` of each slab face to the respective neighbour. Ghosts that
    cross the periodic seam are shifted by ±L, so downstream kernels need
    no minimum image for them. ``prop_names`` is OpenFPM's property-subset
    ``ghost_get<prop...>`` (all props if None). ``n_hops`` is the
    multi-hop generalisation (DESIGN.md §13): hop h ships, along the ±h
    ring, what the h-distant slab needs for its ghost window; hop windows
    are disjoint and cover the window while ``n_hops >= ceil(r_ghost /
    min slab width)``. Returns ``(GhostLayer, overflow)``, overflow the
    largest per-side excess over ``ghost_cap``, the same on every rank.
    ``src_slots`` as in :func:`ghost_get_start`."""
    return ghost_get_start(ps, bounds, r_ghost, axis_name, ghost_cap,
                           periodic=periodic, box_len=box_len,
                           slab_axis=slab_axis, prop_names=prop_names,
                           n_hops=n_hops, src_slots=src_slots).wait()


def _pack_payload(tree: Dict[str, torch.Tensor], sel: torch.Tensor,
                  ghost_cap: int) -> Dict[str, torch.Tensor]:
    """Selected rows into dense ``(ghost_cap, ...)`` buffers with
    :func:`_pack_side`'s slots: the same ``sel``, the same slots."""
    src, filled = _dense_slots(sel, ghost_cap)
    return {k: _take(a, src, filled) for k, a in tree.items()}


def ghost_update_start(ps: ParticleSet, x_anchor: torch.Tensor,
                       bounds: torch.Tensor, r_ghost: float, axis_name: str,
                       ghost_cap: int, *, periodic: bool, box_len: float,
                       slab_axis: int = 0, prop_names: Tuple[str, ...] = (),
                       n_hops: int = 1) -> RT.InFlight:
    """First half of :func:`ghost_update_local`: pack and issue the
    refresh as one batch. ``.wait()`` on the result yields the refreshed
    payload; work scheduled in between overlaps the exchange."""
    ndev = RT.axis_size(axis_name)
    me = RT.axis_index(axis_name)
    xa = x_anchor[:, slab_axis]
    names = ("x",) + tuple(prop_names)
    payload = {"x": ps.x, **{k: ps.props[k] for k in prop_names}}
    sends = []
    for h in range(1, n_hops + 1):
        near_lo, near_hi = _hop_selection(xa, ps.valid, bounds, r_ghost, me,
                                          ndev, h, box_len)
        lo_pk = _pack_payload(payload, near_lo, ghost_cap)
        hi_pk = _pack_payload(payload, near_hi, ghost_cap)
        right, left = RT.shift_perms(ndev, h)
        sends.append(([hi_pk[k] for k in names], right))
        sends.append(([lo_pk[k] for k in names], left))

    def assemble(received):
        sides_l, sides_r = [], []
        for h in range(1, n_hops + 1):
            # the cached valid mask already zeroes non-periodic wrap links
            shift_l, shift_r, _, _ = _seam(me, ndev, h, periodic, box_len)
            for got, shift, out in ((received[2 * h - 2], shift_l, sides_l),
                                    (received[2 * h - 1], shift_r, sides_r)):
                d = dict(zip(names, got))
                d["x"] = _shift_slab(d["x"], slab_axis, shift)
                out.append(d)
        sides = sides_l + sides_r
        return {k: torch.stack([s[k] for s in sides]) for k in names}

    return RT.ppermute_many_start(sends, axis_name).then(assemble)


def ghost_update_local(ps: ParticleSet, x_anchor: torch.Tensor,
                       bounds: torch.Tensor, r_ghost: float, axis_name: str,
                       ghost_cap: int, *, periodic: bool, box_len: float,
                       slab_axis: int = 0, prop_names: Tuple[str, ...] = (),
                       n_hops: int = 1) -> Dict[str, torch.Tensor]:
    """Property-subset refresh of an existing ghost layer (OpenFPM's
    ``ghost_get<prop...>(SKIP_LABELLING)``): the current positions and
    ``prop_names`` of the particles a prior :func:`ghost_get_local` shipped,
    selected again from ``x_anchor`` (the positions the layer was built
    from) so the slots are the same. Valid while no ``map()`` ran and
    ``bounds`` did not move since. Returns ``{"x": (2K, ghost_cap, dim),
    name: (2K, ghost_cap, ...)}`` row-aligned with the cached layer."""
    return ghost_update_start(ps, x_anchor, bounds, r_ghost, axis_name,
                              ghost_cap, periodic=periodic, box_len=box_len,
                              slab_axis=slab_axis, prop_names=prop_names,
                              n_hops=n_hops).wait()


# --------------------------------------------------------------------------
# ghost_put(): ghost contributions back to their owners
# --------------------------------------------------------------------------

def _identity(op: str, dtype: torch.dtype):
    if op == "sum":
        return 0
    info = torch.finfo(dtype) if dtype.is_floating_point \
        else torch.iinfo(dtype)
    if op == "max":
        return info.min
    if op == "min":
        return info.max
    raise ValueError(f"unknown ghost_put op {op!r}")


def ghost_put_local(contrib: Dict[str, torch.Tensor], ghosts: GhostLayer,
                    ps: ParticleSet, axis_name: str, op: str = "sum"
                    ) -> Dict[str, torch.Tensor]:
    """The ``ghost_put`` mapping, per rank. ``contrib`` holds tensors
    ``(2K, ghost_cap, ...)`` aligned with the ghost layer; they go back to
    their source ranks (each hop's permutation reversed) and merge into
    the owners' per-particle arrays with ``op`` in {sum, max, min}, channel
    by channel in ``repro``'s order. Returns ``{name: (ps.capacity,
    ...)}``; untouched rows hold the op's identity."""
    _identity(op, torch.float32)              # reject an unknown op early
    ndev = RT.axis_size(axis_name)
    k = ghosts.n_hops
    names = tuple(contrib)
    sends = []
    for h in range(1, k + 1):
        right, left = RT.shift_perms(ndev, h)
        # row h-1 came FROM the hop-h left neighbour: back left by h; row
        # K+h-1 back right by h
        for r, perm in ((h - 1, left), (k + h - 1, right)):
            sends.append(([contrib[n][r] for n in names]
                          + [ghosts.src_slot[r], ghosts.valid[r]], perm))
    returned = RT.ppermute_many_start(sends, axis_name).wait()
    cap = ps.capacity
    out = {}
    for i, n in enumerate(names):
        a = contrib[n]
        ident = _identity(op, a.dtype)
        base = torch.full((cap + 1,) + tuple(a.shape[2:]), ident,
                          dtype=a.dtype, device=a.device)
        for got in returned:
            c, slot, v = got[i], got[-2], got[-1]
            vm = v.reshape(v.shape + (1,) * (c.dim() - 1))
            c = torch.where(vm, c, torch.full_like(c, ident))
            idx = torch.where(v, slot.long(), torch.full_like(
                slot, cap, dtype=torch.int64))
            if op == "sum":
                base = base.index_add(0, idx, c)
            else:
                full = idx.reshape(idx.shape + (1,) * (c.dim() - 1)) \
                    .expand_as(c)
                base = base.scatter_reduce(
                    0, full, c, "amax" if op == "max" else "amin",
                    include_self=True)
        out[n] = base[:cap]
    return out


# --------------------------------------------------------------------------
# Per-rank callables over a mesh
# --------------------------------------------------------------------------

def make_map_fn(mesh, axis_name: str, bucket_cap: int, slab_axis: int = 0):
    """``fn(ps, bounds) -> (ps, overflow)``: the global ``map()`` as each
    rank calls it on its own block, with ``axis_name`` on ``mesh``."""

    def fn(ps: ParticleSet, bounds: torch.Tensor):
        with RT.on_mesh(mesh):
            return map_particles_local(ps, bounds, axis_name, bucket_cap,
                                       slab_axis)

    return fn


def make_ghost_get_fn(mesh, axis_name: str, ghost_cap: int, r_ghost: float,
                      *, periodic: bool, box_len: float, slab_axis: int = 0,
                      prop_names: Optional[Tuple[str, ...]] = None,
                      n_hops: int = 1):
    """``fn(ps, bounds) -> (GhostLayer, overflow)``: the global
    ``ghost_get()`` as each rank calls it on its own block."""

    def fn(ps: ParticleSet, bounds: torch.Tensor):
        with RT.on_mesh(mesh):
            return ghost_get_local(ps, bounds, r_ghost, axis_name, ghost_cap,
                                   periodic=periodic, box_len=box_len,
                                   slab_axis=slab_axis,
                                   prop_names=prop_names, n_hops=n_hops)

    return fn
