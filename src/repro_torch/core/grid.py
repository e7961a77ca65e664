"""DistributedField — Cartesian mesh container, serial slice (port of
``repro.core.grid``; paper §3.1, OpenFPM's ``grid_dist``).

The two grid mappings, in their single-device form:

  * ``ghost_get``  → :func:`halo_pad_local` — pad the leading axis with
    ``halo`` rows: the periodic wrap, a ``fill`` value, or (``fill=None``)
    the edge row replicated;
  * ``ghost_put``  → :func:`halo_reduce_local` — fold contributions that
    local computation deposited into the halo rows back onto their owners
    (periodic: the opposite edge; otherwise dropped).

Stencil application is the same strict communication/computation split as
in ``repro``::

    padded = halo_pad_local(block)      # ghost_get
    new    = stencil_fn(padded)[h:-h]   # local computation

:class:`GridOps` hands both mappings to physics hooks. Everything with a
device mesh (``halo_pad``, ``halo_reduce``, the ``*_start``/``*_finish``
split, the pencil ops, ``make_stencil_step``, ``make_field_step``,
``distribute_field*``) is the multi-device layer, ROADMAP A14; a
non-serial ``axis_name`` raises NotImplementedError here.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .particles import resolve_device

_A14 = ("the distributed grid layer (axis_name={!r}) is not ported yet "
        "(ROADMAP A14); use axis_name=None")


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


@dataclasses.dataclass(frozen=True)
class DistributedField:
    """The mesh container (``grid_dist``): ``data`` the mesh field and
    ``node_bounds`` the slab geometry — slab d owns global rows
    ``node_bounds[d] <= r < node_bounds[d+1]``. Serial state is the 1-slab
    case ``[0, n]``. ``col_bounds`` is the pencil decomposition's (A14),
    None here."""

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


@dataclasses.dataclass(frozen=True)
class GridOps:
    """ghost_get/ghost_put handed to physics hooks, serially the
    single-device pad and wrap (the grid mirror of
    ``simulation.Reduce``). ``axis_name`` other than None is the
    distributed layer, ROADMAP A14, and raises. ``device`` is where
    :meth:`first_row` puts its index (the step passes the particles'
    device, so no op of a step mixes devices)."""

    axis_name: Optional[str] = None
    periodic: bool = True
    fill: Optional[float] = 0.0     # None = non-periodic edge replication
    device: Optional[torch.device] = None   # None: the CPU

    def __post_init__(self):
        if self.axis_name is not None:
            raise NotImplementedError(_A14.format(self.axis_name))

    @property
    def distributed(self) -> bool:
        return False

    def ghost_get(self, field: torch.Tensor, halo: int) -> torch.Tensor:
        """Pad the leading axis with ``halo`` wrap/edge/fill rows."""
        return halo_pad_local(field, halo, periodic=self.periodic,
                              fill=self.fill)

    def ghost_put(self, padded: torch.Tensor, halo: int) -> torch.Tensor:
        """Halo-reduce a padded contribution block back to its owners."""
        return halo_reduce_local(padded, halo, periodic=self.periodic)

    def first_row(self, n_local: int) -> torch.Tensor:
        """Global index of the local block's first owned row: 0, a 0-d
        int32 tensor on ``device``."""
        return torch.zeros((), dtype=torch.int32, device=self.device)


def apply_stencil_local(stencil_fn: Callable, halo: int,
                        axis_name: Optional[str] = None, *,
                        periodic: bool = True, fill: Optional[float] = 0.0,
                        overlap: bool = False):
    """Pad each field by ``halo`` on the leading axis, apply
    ``stencil_fn`` to the padded blocks, trim outputs of padded shape back
    to the interior. Returns ``run(*fields) -> tuple(new_fields)``.
    Serially ``overlap=True`` is the blocking path, as in ``repro``;
    ``axis_name`` other than None raises (A14)."""
    if axis_name is not None:
        raise NotImplementedError(_A14.format(axis_name))
    del overlap     # the split-phase schedule needs a mesh axis

    def run_blocking(*fields):
        out = stencil_fn(*(halo_pad_local(f, halo, periodic=periodic,
                                          fill=fill) for f in fields))
        if not isinstance(out, tuple):
            out = (out,)
        trimmed = []
        for o, f in zip(out, fields):
            if halo and o.shape[0] == f.shape[0] + 2 * halo:
                o = o[halo:-halo]
            trimmed.append(o)
        return tuple(trimmed)

    return run_blocking


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
