"""DistributedField — Cartesian mesh container with halo exchange (port
of ``repro.core.grid``; paper §3.1, OpenFPM's ``grid_dist``).

A mesh decomposed into slabs along its leading axis over a 1-D mesh axis,
carried with its slab geometry (``node_bounds``) in
:class:`DistributedField`. The two grid mappings:

  * ``ghost_get``  → :func:`halo_pad` — a pair of ``ppermute`` shifts
    populating ``halo`` rows from the slab neighbours;
  * ``ghost_put``  → :func:`halo_reduce` — the reverse: contributions
    deposited into the halo rows go back and are summed into the owners'
    edge rows (the O(halo) replacement of a full-mesh ``psum``).

Their single-device forms (:func:`halo_pad_local`,
:func:`halo_reduce_local`) have the same semantics: the periodic wrap, a
``fill`` value, or (``fill=None``) the edge row replicated. Stencil
application is the same strict communication/computation split as in
``repro``::

    padded = halo_pad(block)            # ghost_get
    new    = stencil_fn(padded)[h:-h]   # local computation

The split-phase (two-slot) mode of DESIGN.md §12: :func:`halo_pad_start`
issues the shifts and returns the two slots in flight
(``runtime.InFlight``), :func:`halo_pad_finish` waits for them and
assembles the padded block; ``apply_stencil_local(..., overlap=True)``
runs the stencil on the unpadded block between the two and only two
3·halo-row edge strips wait for the slots. :func:`halo_reduce_start` /
:func:`halo_reduce_finish` split ghost_put the same way. :class:`GridOps`
hands both mappings to physics hooks, distributed or serial.

Functions taking ``axis_name`` run per rank (``repro``'s shard_map
bodies); collectives come from ``runtime``. ``grid_sharding`` and ``field_spec``
have no counterpart: there is no ``NamedSharding`` or PartitionSpec; a
rank holds its block, which :func:`distribute_field` cuts and
:func:`gather_field` joins.

The pencil forms (a 2-D ``(rows, cols)`` device mesh, DESIGN.md §13)
compose the 1-D exchanges over a moved axis: :func:`halo_pad2` pads axis
0 over the rows, then axis 1 of the row-padded block over the columns,
so the corners relay through the edge neighbours; :func:`halo_reduce2`
is its adjoint; :func:`apply_stencil_local2` the blocking stencil engine;
:func:`distribute_field2` / :func:`gather_field2` cut and join pencil
blocks.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from . import runtime as RT
from .particles import resolve_device

def halo_pad_start(field: torch.Tensor, halo: int, axis_name: str, *,
                   periodic: bool = True, fill: Optional[float] = 0.0):
    """First half of the two-slot ghost_get: issue the neighbour shift
    pair and return the slots ``(from_left, from_right)`` in flight
    (``runtime.InFlight``). Non-periodic edges get ``fill`` rows;
    ``fill=None`` replicates the edge row."""
    ndev = RT.axis_size(axis_name)
    me = RT.axis_index(axis_name)
    right, left = RT.shift_perms(ndev)
    # my highest rows go right (the right neighbour's low halo), my lowest
    # rows left
    sent = RT.ppermute_many_start([([field[-halo:]], right),
                                   ([field[:halo]], left)], axis_name)
    from_left = sent.then(lambda r: r[0][0])
    from_right = sent.then(lambda r: r[1][0])
    if not periodic:
        rest = tuple(field.shape[1:])
        if fill is None:
            pad_lo = field[:1].expand((halo,) + rest)
            pad_hi = field[-1:].expand((halo,) + rest)
        else:
            pad_lo = torch.full((halo,) + rest, fill, dtype=field.dtype,
                                device=field.device)
            pad_hi = pad_lo
        if me == 0:
            from_left = from_left.then(lambda _: pad_lo)
        if me == ndev - 1:
            from_right = from_right.then(lambda _: pad_hi)
    return from_left, from_right


def halo_pad_finish(field: torch.Tensor, from_left, from_right
                    ) -> torch.Tensor:
    """Second half of the two-slot ghost_get: wait for the slots and
    assemble the padded block."""
    return torch.cat([RT.wait(from_left), field, RT.wait(from_right)], 0)


def halo_pad(field: torch.Tensor, halo: int, axis_name: str, *,
             periodic: bool = True, fill: Optional[float] = 0.0
             ) -> torch.Tensor:
    """Pad the leading axis of the local block with ``halo`` rows from the
    neighbouring slabs (non-periodic edges: ``fill``, or the edge row for
    ``fill=None``). The blocking composition of :func:`halo_pad_start` and
    :func:`halo_pad_finish`."""
    if halo == 0:
        return field
    from_left, from_right = halo_pad_start(field, halo, axis_name,
                                           periodic=periodic, fill=fill)
    return halo_pad_finish(field, from_left, from_right)


def halo_pad_local(field: torch.Tensor, halo: int, *, periodic: bool = True,
                   fill: Optional[float] = 0.0) -> torch.Tensor:
    """Single-device halo pad of the leading axis: ``halo`` rows each side,
    the periodic wrap, or non-periodic ``fill`` rows (``fill=None``: the
    edge row replicated)."""
    if halo == 0:
        return field
    if periodic:
        lo = field[-halo:]
        hi = field[:halo]
    else:
        rest = tuple(field.shape[1:])
        if fill is None:
            lo = field[:1].expand((halo,) + rest)
            hi = field[-1:].expand((halo,) + rest)
        else:
            lo = torch.full((halo,) + rest, fill, dtype=field.dtype,
                            device=field.device)
            hi = torch.full((halo,) + rest, fill, dtype=field.dtype,
                            device=field.device)
    return torch.cat([lo, field, hi], dim=0)


def pad_axis(field: torch.Tensor, axis: int, halo: int, *,
             periodic: bool = True, fill: Optional[float] = 0.0
             ) -> torch.Tensor:
    """:func:`halo_pad_local` along an arbitrary axis."""
    moved = torch.movedim(field, axis, 0)
    padded = halo_pad_local(moved, halo, periodic=periodic, fill=fill)
    return torch.movedim(padded, 0, axis)


def halo_reduce_local(padded: torch.Tensor, halo: int, *,
                      periodic: bool = True) -> torch.Tensor:
    """Single-device halo reduce: periodic pad rows wrap-add into the
    opposite edge, non-periodic pad rows are dropped. Returns a new tensor
    (``padded`` is not modified)."""
    if halo == 0:
        return padded
    core = padded[halo:-halo].clone()
    if periodic:
        core[-halo:] += padded[:halo]
        core[:halo] += padded[-halo:]
    return core


def halo_reduce(padded: torch.Tensor, halo: int, axis_name: str, *,
                periodic: bool = True) -> torch.Tensor:
    """The grid ``ghost_put``, per rank: fold the ``halo`` leading and
    trailing rows of a locally accumulated padded block (laid out as a
    :func:`halo_pad` result) into their owners and return the owned block.
    Contributions are summed; non-periodic edges drop the wrap-link rows.
    The single-hop exchange: ``halo`` must not exceed the local rows."""
    if halo == 0:
        return padded
    from_left, from_right = halo_reduce_start(padded, halo, axis_name,
                                              periodic=periodic)
    return halo_reduce_finish(padded, halo, from_left, from_right)


def halo_reduce_start(padded: torch.Tensor, halo: int, axis_name: str, *,
                      periodic: bool = True):
    """First half of the two-slot ghost_put: ship the foreign halo rows
    toward their owners and return the contribution slots ``(from_left,
    from_right)`` in flight. Work on the core rows can run meanwhile."""
    ndev = RT.axis_size(axis_name)
    me = RT.axis_index(axis_name)
    right, left = RT.shift_perms(ndev)
    # my low rows travel left (what I get back came from my right
    # neighbour), my high rows right
    sent = RT.ppermute_many_start([([padded[:halo]], left),
                                   ([padded[-halo:]], right)], axis_name)
    from_right = sent.then(lambda r: r[0][0])
    from_left = sent.then(lambda r: r[1][0])
    if not periodic:
        if me == 0:
            from_left = from_left.then(torch.zeros_like)
        if me == ndev - 1:
            from_right = from_right.then(torch.zeros_like)
    return from_left, from_right


def halo_reduce_finish(padded: torch.Tensor, halo: int, from_left,
                       from_right) -> torch.Tensor:
    """Second half of the two-slot ghost_put: add the arrived neighbour
    contributions into the owned edge rows (a new tensor) and return the
    owned block."""
    core = padded[halo:-halo].clone()
    core[:halo] += RT.wait(from_left)
    core[-halo:] += RT.wait(from_right)
    return core


@dataclasses.dataclass(frozen=True)
class DistributedField:
    """The mesh container (``grid_dist``): ``data`` the mesh field (per
    rank: its slab block) and ``node_bounds`` the slab geometry — slab d
    owns global rows ``node_bounds[d] <= r < node_bounds[d+1]``, a
    replicated int32 tensor. Serial state is the 1-slab case ``[0, n]``.
    ``col_bounds`` is the pencil decomposition's column slabs (global
    columns along axis 1, from :func:`distribute_field2`), None on slab
    and serial fields."""

    data: torch.Tensor
    node_bounds: torch.Tensor       # (n_slabs + 1,) int32
    col_bounds: Optional[torch.Tensor] = None

    @property
    def n_slabs(self) -> int:
        return self.node_bounds.shape[0] - 1


def serial_field(arr: torch.Tensor) -> DistributedField:
    """The 1-slab (serial) container: same type, trivial bounds."""
    return DistributedField(
        data=arr, node_bounds=torch.tensor([0, arr.shape[0]],
                                           dtype=torch.int32,
                                           device=arr.device))


def distribute_field(arr: torch.Tensor, mesh,
                     axis_name: str) -> DistributedField:
    """This rank's slab block of a full mesh array (every rank passes the
    same ``arr``), with the uniform slab geometry recorded in the
    container."""
    with RT.on_mesh(mesh):
        ndev = RT.axis_size(axis_name)
        me = RT.axis_index(axis_name)
    n = arr.shape[0]
    if n % ndev:
        raise ValueError(f"leading axis {n} not divisible by {ndev} shards")
    nl = n // ndev
    bounds = torch.from_numpy(np.arange(ndev + 1, dtype=np.int32) * nl).to(
        arr.device)
    return DistributedField(data=arr[me * nl:(me + 1) * nl].contiguous(),
                            node_bounds=bounds)


def gather_field(f: DistributedField, mesh, axis_name: str) -> torch.Tensor:
    """The full mesh array on every rank: the blocks in rank order."""
    with RT.on_mesh(mesh):
        return RT.all_gather(f.data, axis_name, tiled=True)


def distribute_field2(arr: torch.Tensor, mesh, row_axis: str,
                      col_axis: str) -> DistributedField:
    """This rank's pencil block of a full mesh array (every rank passes
    the same ``arr``): rows and columns (axes 0 and 1) split uniformly over
    an ``(r, c)`` device mesh, with the pencil geometry recorded in the
    container (``node_bounds`` the row slabs, ``col_bounds`` the column
    slabs)."""
    with RT.on_mesh(mesh):
        r, c = RT.axis_size(row_axis), RT.axis_size(col_axis)
        i, j = RT.axis_index(row_axis), RT.axis_index(col_axis)
    n0, n1 = arr.shape[0], arr.shape[1]
    if n0 % r:
        raise ValueError(f"leading axis {n0} not divisible by {r} row shards")
    if n1 % c:
        raise ValueError(f"axis 1 ({n1}) not divisible by {c} column "
                         "shards")
    nl0, nl1 = n0 // r, n1 // c
    dev = arr.device
    return DistributedField(
        data=arr[i * nl0:(i + 1) * nl0, j * nl1:(j + 1) * nl1].contiguous(),
        node_bounds=torch.from_numpy(
            np.arange(r + 1, dtype=np.int32) * nl0).to(dev),
        col_bounds=torch.from_numpy(
            np.arange(c + 1, dtype=np.int32) * nl1).to(dev))


def gather_field2(f: DistributedField, mesh, row_axis: str,
                  col_axis: str) -> torch.Tensor:
    """The full mesh array of a pencil field on every rank: the blocks
    joined along axis 1 over the columns, then along axis 0 over the
    rows."""
    with RT.on_mesh(mesh):
        rows = RT.all_gather(f.data, col_axis, axis=1, tiled=True)
        return RT.all_gather(rows, row_axis, tiled=True)


def halo_pad2(field: torch.Tensor, halo: int, row_axis: str, col_axis: str,
              *, periodic: bool = True, fill: Optional[float] = 0.0
              ) -> torch.Tensor:
    """The pencil ghost_get, per rank: pad axis 0 by ``halo`` over the row
    axis, then axis 1 of the row-padded block over the column axis. The
    column exchange ships the row-padded faces, so the corner ghosts of
    the diagonal neighbours arrive by the two-hop relay (no corner
    sends)."""
    if halo == 0:
        return field
    p = halo_pad(field, halo, row_axis, periodic=periodic, fill=fill)
    p = halo_pad(p.movedim(1, 0), halo, col_axis, periodic=periodic,
                 fill=fill)
    return p.movedim(0, 1)


def halo_reduce2(padded: torch.Tensor, halo: int, row_axis: str,
                 col_axis: str, *, periodic: bool = True) -> torch.Tensor:
    """The pencil ghost_put, per rank, the adjoint of :func:`halo_pad2`:
    reduce the column halos first, then the row halos; corner
    contributions relay through the (row, col -/+ 1) neighbour's row halo
    and land on the diagonal owner in the second exchange."""
    if halo == 0:
        return padded
    r = halo_reduce(padded.movedim(1, 0), halo, col_axis, periodic=periodic)
    return halo_reduce(r.movedim(0, 1), halo, row_axis, periodic=periodic)


@dataclasses.dataclass(frozen=True)
class GridOps:
    """ghost_get/ghost_put handed to physics hooks (the grid mirror of
    ``simulation.Reduce``): on a distributed step the slab-neighbour
    exchanges (:func:`halo_pad`, :func:`halo_reduce`) over ``axis_name``,
    serially the single-device pad and wrap with the same semantics.
    ``device`` is where :meth:`first_row` puts its index (the step passes
    the particles' device, so no op of a step mixes devices)."""

    axis_name: Optional[str] = None
    periodic: bool = True
    fill: Optional[float] = 0.0     # None = non-periodic edge replication
    device: Optional[torch.device] = None   # None: the CPU

    @property
    def distributed(self) -> bool:
        return self.axis_name is not None

    def ghost_get(self, field: torch.Tensor, halo: int) -> torch.Tensor:
        """Pad the leading axis with ``halo`` rows from the slab
        neighbours (serially: the wrap/edge/fill rows)."""
        if self.axis_name is None:
            return halo_pad_local(field, halo, periodic=self.periodic,
                                  fill=self.fill)
        return halo_pad(field, halo, self.axis_name, periodic=self.periodic,
                        fill=self.fill)

    def ghost_put(self, padded: torch.Tensor, halo: int) -> torch.Tensor:
        """Halo-reduce a padded contribution block back to its owners."""
        if self.axis_name is None:
            return halo_reduce_local(padded, halo, periodic=self.periodic)
        return halo_reduce(padded, halo, self.axis_name,
                           periodic=self.periodic)

    def first_row(self, n_local: int) -> torch.Tensor:
        """Global index of the local block's first owned row, a 0-d int32
        tensor on ``device`` (0 serially; uniform slabs distributed)."""
        me = 0 if self.axis_name is None else RT.axis_index(self.axis_name)
        return torch.full((), me * n_local, dtype=torch.int32,
                          device=self.device)


def apply_stencil_local(stencil_fn: Callable, halo: int,
                        axis_name: Optional[str] = None, *,
                        periodic: bool = True, fill: Optional[float] = 0.0,
                        overlap: bool = False):
    """The local engine of :func:`make_stencil_step`, per rank
    (``axis_name`` set) or serially (None): pad each field by ``halo`` on
    the leading axis, apply ``stencil_fn`` to the padded blocks, trim
    outputs of padded shape back to the owned rows. Returns
    ``run(*fields) -> tuple(new_fields)``.

    ``overlap=True`` selects the split-phase schedule (DESIGN.md §12):
    :func:`halo_pad_start` issues the exchange, ``stencil_fn`` runs on the
    unpadded blocks (rows ``[halo, n - halo)`` need no ghost), then only
    two 3·halo-row edge strips wait for the slots. It needs a stencil of
    radius <= halo that maps n rows to n rows, ``n >= 2 * halo`` and equal
    leading sizes, and runs the blocking path when the shapes do not
    allow it (and serially). Its rows equal the blocking path's bit for
    bit for an elementwise-composed stencil."""

    def pad(f):
        if axis_name is None:
            return halo_pad_local(f, halo, periodic=periodic, fill=fill)
        return halo_pad(f, halo, axis_name, periodic=periodic, fill=fill)

    def run_blocking(*fields):
        out = stencil_fn(*(pad(f) for f in fields))
        if not isinstance(out, tuple):
            out = (out,)
        trimmed = []
        for o, f in zip(out, fields):
            if halo and o.shape[0] == f.shape[0] + 2 * halo:
                o = o[halo:-halo]
            trimmed.append(o)
        return tuple(trimmed)

    if not overlap or halo == 0 or axis_name is None:
        return run_blocking

    def run_overlap(*fields):
        n = fields[0].shape[0]
        if n < 2 * halo or any(f.shape[0] != n for f in fields):
            return run_blocking(*fields)
        # 1) the exchange in flight
        slots = [halo_pad_start(f, halo, axis_name, periodic=periodic,
                                fill=fill) for f in fields]
        # 2) the interior: no dependence on the slots
        interior = stencil_fn(*fields)
        # 3) the edges: two 3*halo-row strips whose middle rows are final
        arrived = [(RT.wait(fl), RT.wait(fr)) for fl, fr in slots]
        lo_out = stencil_fn(*(torch.cat([fl, f[:2 * halo]], 0)
                              for f, (fl, _) in zip(fields, arrived)))
        hi_out = stencil_fn(*(torch.cat([f[-2 * halo:], fr], 0)
                              for f, (_, fr) in zip(fields, arrived)))
        if not isinstance(interior, tuple):
            interior, lo_out, hi_out = (interior,), (lo_out,), (hi_out,)
        combined = []
        for o_int, o_lo, o_hi in zip(interior, lo_out, hi_out):
            if o_int.shape[0] != n:
                raise ValueError(
                    "overlap=True needs an n-rows-to-n-rows stencil_fn "
                    f"(got {o_int.shape[0]} rows from {n})")
            combined.append(torch.cat(
                [o_lo[halo:2 * halo], o_int[halo:n - halo],
                 o_hi[halo:2 * halo]], 0))
        return tuple(combined)

    return run_overlap


def apply_stencil_local2(stencil_fn: Callable, halo: int, row_axis: str,
                         col_axis: str, *, periodic: bool = True,
                         fill: Optional[float] = 0.0):
    """The pencil form of :func:`apply_stencil_local`, per rank: pad each
    field by ``halo`` on axes 0 and 1 (:func:`halo_pad2`), apply
    ``stencil_fn`` to the padded blocks, and trim outputs of padded shape
    back to the owned block on both axes. The blocking schedule only, as
    in ``repro`` (the split-phase overlap is a 1-D row-window
    construction)."""

    def run(*fields):
        out = stencil_fn(*(halo_pad2(f, halo, row_axis, col_axis,
                                     periodic=periodic, fill=fill)
                           for f in fields))
        if not isinstance(out, tuple):
            out = (out,)
        trimmed = []
        for o, f in zip(out, fields):
            if (halo and o.shape[0] == f.shape[0] + 2 * halo
                    and o.shape[1] == f.shape[1] + 2 * halo):
                o = o[halo:-halo, halo:-halo]
            trimmed.append(o)
        return tuple(trimmed)

    return run


def make_stencil_step(mesh, axis_name: str, stencil_fn: Callable,
                      halo: int, *, periodic: bool = True,
                      fill: Optional[float] = 0.0, overlap: bool = False):
    """The distributed stencil step over each rank's raw blocks:
    ``step(*blocks) -> tuple(blocks)``. ``stencil_fn(*padded) ->
    tuple(new)`` sees blocks padded by ``halo`` along the leading axis and
    returns arrays of the padded or of the owned shape. ``overlap=True``
    needs the two-slot contract (see :func:`apply_stencil_local`)."""
    local = apply_stencil_local(stencil_fn, halo, axis_name,
                                periodic=periodic, fill=fill,
                                overlap=overlap)

    def step(*blocks):
        with RT.on_mesh(mesh):
            return local(*blocks)

    return step


def make_field_step(mesh, axis_name: str, stencil_fn: Callable, halo: int,
                    *, periodic: bool = True, fill: Optional[float] = 0.0,
                    overlap: bool = False):
    """:func:`make_stencil_step` over :class:`DistributedField` containers:
    ``step(*fields) -> tuple(fields)``, the slab geometry carried through
    unchanged."""
    local = make_stencil_step(mesh, axis_name, stencil_fn, halo,
                              periodic=periodic, fill=fill, overlap=overlap)

    def step(*fields: DistributedField):
        out = local(*(f.data for f in fields))
        return tuple(dataclasses.replace(f, data=o)
                     for f, o in zip(fields, out))

    return step


def grid_coords(shape: Sequence[int], box_lo, box_hi,
                dtype=torch.float32, device="cuda") -> torch.Tensor:
    """Physical node coordinates of a cell-centred grid, ``shape + (dim,)``,
    built in float64 with numpy and cast, as ``repro`` does."""
    shape = tuple(int(s) for s in shape)
    lo = np.asarray(box_lo, np.float64)
    hi = np.asarray(box_hi, np.float64)
    axes = [lo[d] + (np.arange(shape[d]) + 0.5) * (hi[d] - lo[d]) / shape[d]
            for d in range(len(shape))]
    mesh_nd = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1)
    return torch.from_numpy(mesh_nd).to(device=resolve_device(device),
                                        dtype=dtype)
