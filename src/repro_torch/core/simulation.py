"""Simulation layer, serial slice (port of ``repro.core.simulation``,
DESIGN.md §9).

  * :class:`DistributedParticles` — the particle container plus the slab
    ``bounds`` it lives under; serial is the 1-slab case.
  * :class:`PhysicsSpec` — what an application declares: domain, cutoff,
    pair body, fields, and the ``advance``/``finish`` hooks.
  * :func:`make_sim_step` — the engine. This port has the serial path
    (``mesh=None``): ``advance`` → cell list → cell-pair engine →
    ``finish``. The multi-device path, the reuse cadence, split-phase
    overlap, multi-hop ghosts and mesh fields raise NotImplementedError
    naming the ROADMAP item that brings them.

Capacity contracts surface as :class:`StepFlags`: 0-d int32 tensors on the
particles' device. Nothing in a step reads a device tensor on the host, so
a step never waits for the card; callers read the flags at their log
points.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from . import cell_list as CL
from . import grid as G
from . import interactions as I
from .particles import ParticleSet, const_tensor


# --------------------------------------------------------------------------
# The container
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DistributedParticles:
    """The particle container (``vector_dist``): ``ps`` plus the slab
    decomposition ``bounds`` (serial: ``[box_lo, box_hi]`` along the slab
    axis). ``fields`` holds declared mesh state (empty in this port)."""

    ps: ParticleSet
    bounds: torch.Tensor       # (n_slabs + 1,) float32
    fields: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)

    @property
    def n_slabs(self) -> int:
        return self.bounds.shape[0] - 1


def _z32(device) -> torch.Tensor:
    """A 0-d int32 zero on ``device``: filled there, no host copy."""
    return torch.zeros((), dtype=torch.int32, device=device)


@dataclasses.dataclass(frozen=True)
class StepFlags:
    """Per-step overflow/contract flags (all 0-d int32 tensors on the
    device; 0 = healthy). Nonzero means a static capacity must be
    re-provisioned; nothing is silently dropped."""

    cell: torch.Tensor            # cell-list bucket excess over cell_cap
    neighbor: torch.Tensor        # Verlet/contact-list excess over k slots
    bucket: torch.Tensor          # map() per-destination bucket excess
    ghost: torch.Tensor           # ghost_get per-side excess over ghost_cap
    ghost_contract: torch.Tensor  # ghost-hop excess (multi-device only)
    window: torch.Tensor          # split-phase row-window excess
    stale: torch.Tensor           # reuse-engine tripwire (telemetry)

    def any(self) -> torch.Tensor:
        """Max over the *error* flags (``stale`` is cadence telemetry and
        is excluded), as a 0-d device tensor."""
        return torch.maximum(
            torch.maximum(torch.maximum(self.cell, self.neighbor),
                          torch.maximum(self.bucket, self.ghost)),
            torch.maximum(self.ghost_contract, self.window))


# --------------------------------------------------------------------------
# Reductions that degenerate: identity serially
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Reduce:
    """Global reductions handed to physics hooks; serially identities.
    Only ``axis_name=None`` is ported."""

    axis_name: Optional[str] = None

    def __post_init__(self):
        if self.axis_name is not None:
            raise NotImplementedError(
                "collective reductions arrive with the multi-device layer "
                "(ROADMAP A14)")

    @property
    def distributed(self) -> bool:
        return False

    def max(self, x):
        return x

    def sum(self, x):
        return x

    def mean(self, x):
        return x

    def gather(self, x):
        """(ndev,)-stacked per-shard values (shape (1,) serially)."""
        return torch.as_tensor(x)[None]


@dataclasses.dataclass(frozen=True)
class StepCtx:
    """What a ``finish`` hook sees after the pair pass: ``ps`` the local
    particles (post-``advance``), ``combo`` local+ghost (== ``ps``
    serially), ``cl`` the cell list over ``combo``, ``pair`` the engine
    outputs, ``red`` the reductions, ``extras`` per-step inputs.
    ``fields`` are the mesh fields and ``grid`` the mesh mappings
    (ghost_get/ghost_put; serially the single-device pad and wrap)."""

    ps: ParticleSet
    combo: ParticleSet
    cl: CL.CellList
    pair: Dict[str, torch.Tensor]
    red: Reduce
    extras: Dict[str, Any]
    fields: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    grid: G.GridOps = G.GridOps()


# --------------------------------------------------------------------------
# The physics declaration
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PhysicsSpec:
    """A workload, declared once.

    Hooks:
      advance(ps, red, extras) -> ps      pre-pair (e.g. MD kick+drift+wrap)
      finish(ctx)  -> (ps, scalars, neighbor_overflow[, fields])
                                          post-pair: integrate using
                                          ``ctx.pair`` sums.

    ``backend`` is the pair engine's (``"auto"`` | ``"torch"`` | ``"cuda"``,
    see ``interactions.apply_pair_kernel``). ``repro``'s multi-device and
    reuse declarations (``ghost_props``, ``bucket_cap``, ``ghost_cap``,
    ``update_props``, ``cache_*``) arrive with those engines.
    """

    name: str
    box_lo: Tuple[float, ...]
    box_hi: Tuple[float, ...]
    periodic: Tuple[bool, ...]
    r_cut: float
    cell_cap: int
    pair_out: Dict[str, str]                 # name -> "radial" | "scalar"
    make_body: Callable[[], Any]             # cell-pair engine pair body
    pair_props: Tuple[str, ...] = ()         # props the pair body reads
    advance: Optional[Callable] = None
    finish: Optional[Callable] = None
    backend: str = "auto"                    # "auto" | "torch" | "cuda"
    precision: str = "fp32"                  # "fp32" | "bf16x" pair engine
    mesh_props: Tuple[str, ...] = ()         # mesh fields in state.fields


def _grid_kw(spec: PhysicsSpec, padded_axes: Tuple[int, ...],
             skin: float = 0.0):
    """Cell grid: the declared domain, or (distributed) the ghost-padded
    box — every axis in ``padded_axes`` extended by ``r_cut + skin`` and
    made non-periodic. Serial passes ``()``."""
    lo = list(float(v) for v in spec.box_lo)
    hi = list(float(v) for v in spec.box_hi)
    per = list(bool(v) for v in spec.periodic)
    for ax in padded_axes:
        lo[ax] -= spec.r_cut + skin
        hi[ax] += spec.r_cut + skin
        per[ax] = False
    gs = CL.grid_shape_for(lo, hi, spec.r_cut, skin)
    return dict(box_lo=tuple(lo), box_hi=tuple(hi), grid_shape=gs,
                periodic=tuple(per), cell_cap=spec.cell_cap)


def _finish(spec: PhysicsSpec, ctx: StepCtx):
    dev = ctx.ps.device
    if spec.finish is None:
        return ctx.ps, {}, _z32(dev), ctx.fields
    out = spec.finish(ctx)
    if len(out) == 4:
        ps, scalars, nb_ovf, fields = out
    else:
        ps, scalars, nb_ovf = out
        fields = ctx.fields
    if isinstance(nb_ovf, torch.Tensor):
        nb_ovf = nb_ovf.to(torch.int32)
    else:   # a Python int: filled on the device, no host copy
        nb_ovf = torch.full((), int(nb_ovf), dtype=torch.int32, device=dev)
    return ps, scalars, nb_ovf, fields


# --------------------------------------------------------------------------
# The engine
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def make_serial_step_fn(physics, cfg, *, slab_axis: int = 0):
    """The serial (1-slab) step composition: ``advance`` → cell list →
    cell-pair engine → ``finish``. Cached on ``(physics, cfg,
    slab_axis)``."""
    spec = physics(cfg)
    body = spec.make_body()
    pair_kw = dict(out=spec.pair_out, r_cut=float(spec.r_cut),
                   prop_names=spec.pair_props, backend=spec.backend,
                   precision=spec.precision)
    cl_kw = _grid_kw(spec, ())

    def step(state: DistributedParticles, extras):
        red = Reduce(None)
        ps = state.ps
        if spec.advance is not None:
            ps = spec.advance(ps, red, extras)
        cl = CL.build_cell_list(ps, **cl_kw)
        pair = I.apply_pair_kernel(ps, cl, body, **pair_kw)
        ps, scalars, nb_ovf, fields = _finish(
            spec, StepCtx(ps=ps, combo=ps, cl=cl, pair=pair, red=red,
                          extras=extras, fields=state.fields))
        z = _z32(ps.device)
        flags = StepFlags(cell=cl.overflow.to(torch.int32), neighbor=nb_ovf,
                          bucket=z, ghost=z, ghost_contract=z, window=z,
                          stale=z)
        return (dataclasses.replace(state, ps=ps, fields=fields), flags,
                scalars)

    return step


@functools.lru_cache(maxsize=None)
def make_sim_step(physics, cfg, mesh=None, *, axis_name="shards",
                  slab_axis: int = 0, overlap: bool = False,
                  n_hops: Optional[int] = None,
                  reuse: Optional[str] = None,
                  skin: Optional[float] = None):
    """Build the simulation step for ``physics(cfg)``: ``step(state,
    extras) -> (state, flags, scalars)`` over a
    :class:`DistributedParticles` state. Only the serial path
    (``mesh=None``) is ported; the step runs eagerly (``repro`` jits it).

    ``physics`` must be a module-level callable ``physics(cfg) ->``
    :class:`PhysicsSpec` and ``cfg`` hashable: the step is cached on
    ``(physics, cfg)``."""
    if mesh is not None or overlap or n_hops is not None:
        raise NotImplementedError(
            "make_sim_step on a device mesh (overlap, n_hops) arrives with "
            "the multi-device layer (ROADMAP A14); pass mesh=None")
    if reuse is not None or skin is not None:
        raise NotImplementedError(
            "the skin-amortized reuse engine arrives with ROADMAP A8")
    if physics(cfg).mesh_props:
        raise NotImplementedError(
            "mesh fields (PhysicsSpec.mesh_props) arrive with the mesh "
            "half, ROADMAP A9-A10")
    return make_serial_step_fn(physics, cfg, slab_axis=slab_axis)


# --------------------------------------------------------------------------
# State construction
# --------------------------------------------------------------------------

def with_ids(ps: ParticleSet) -> ParticleSet:
    """Ensure an int32 ``id`` prop (dense index among valid rows). Reads
    ``valid`` on the host: a set-up function, not for a step."""
    if "id" in ps.props:
        return ps
    val = ps.valid.cpu().numpy()
    ids = np.cumsum(val) - 1
    return ps.with_prop("id", torch.from_numpy(
        np.where(val, ids, 0).astype(np.int32)).to(ps.device))


def serial_state(ps: ParticleSet, physics, cfg, slab_axis: int = 0,
                 fields: Optional[Dict[str, torch.Tensor]] = None
                 ) -> DistributedParticles:
    """The 1-slab (serial) container: same state type, trivial bounds."""
    spec = physics(cfg)
    bounds = const_tensor((float(spec.box_lo[slab_axis]),
                           float(spec.box_hi[slab_axis])), torch.float32,
                          ps.device)
    return DistributedParticles(ps=ps, bounds=bounds,
                                fields=dict(fields or {}))
