"""Simulation layer, serial slice (port of ``repro.core.simulation``,
DESIGN.md §9).

  * :class:`DistributedParticles` — the particle container plus the slab
    ``bounds`` it lives under; serial is the 1-slab case.
  * :class:`PhysicsSpec` — what an application declares: domain, cutoff,
    pair body, fields, and the ``advance``/``finish`` hooks.
  * :func:`make_sim_step` — the engine. This port has the serial path
    (``mesh=None``): ``advance`` → cell list → cell-pair engine →
    ``finish``, with declared mesh fields (``PhysicsSpec.mesh_props``)
    riding in the container, and the serial skin-amortized reuse cadence
    (``reuse="skin"|"update"``, DESIGN.md §14; state type
    :class:`ReuseState`, built by :func:`reuse_state`). The multi-device
    path, split-phase overlap and multi-hop ghosts raise
    NotImplementedError naming ROADMAP A14.

Capacity contracts surface as :class:`StepFlags`: 0-d int32 tensors on the
particles' device. Nothing in an every-step engine step reads a device
tensor on the host, so it never waits for the card; callers read the
flags at their log points. The reuse step reads one flag per step (see
:func:`make_sim_step`).
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
    axis). ``fields`` holds the mesh state a physics declares
    (``PhysicsSpec.mesh_props``): whole mesh tensors serially, leading
    axis the slab axis in mesh rows."""

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
    see ``interactions.apply_pair_kernel``).

    ``mesh_props`` declares mesh state carried in
    ``DistributedParticles.fields``; it reaches ``finish`` as
    ``ctx.fields`` with ``ctx.grid`` (ghost_get/ghost_put), and a 4th
    element of ``finish``'s result updates it.

    The reuse-engine declarations (DESIGN.md §14), as in ``repro``:
    ``cache_keys`` names ``finish`` scalars the engine lifts out of the
    scalar dict and carries across steps as physics cache (re-injected
    into ``extras`` next step, with ``"_reuse_slots_stable"``: always True
    serially, where slots never permute); ``cache_scalars`` marks which of
    those are scalars; ``cache_example`` builds the cold cache from a
    particle set. The serial engine reads only these. ``ghost_props``,
    ``update_props``, ``extras_example``, ``bucket_cap`` and ``ghost_cap``
    are declared for the multi-device layer (ROADMAP A14).
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
    ghost_props: Tuple[str, ...] = ()        # props ghosts carry (A14)
    extras_example: Tuple[str, ...] = ()     # names of per-step extras
    bucket_cap: int = 512                    # map() bucket (A14)
    ghost_cap: int = 1024                    # ghost_get per side (A14)
    mesh_props: Tuple[str, ...] = ()         # mesh fields in state.fields
    update_props: Optional[Tuple[str, ...]] = None  # ghost props refreshed
    #                                          on reuse update steps (A14)
    cache_keys: Tuple[str, ...] = ()         # finish scalars carried as
    #                                          reuse-engine physics cache
    cache_scalars: Tuple[str, ...] = ()      # cache_keys that are scalars
    cache_example: Optional[Callable] = None  # ps -> zero cache dict


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
    mesh_periodic = bool(spec.periodic[slab_axis])
    cl_kw = _grid_kw(spec, ())

    def step(state: DistributedParticles, extras):
        red = Reduce(None)
        ps = state.ps
        grid = G.GridOps(None, periodic=mesh_periodic, device=ps.device)
        if spec.advance is not None:
            ps = spec.advance(ps, red, extras)
        cl = CL.build_cell_list(ps, **cl_kw)
        pair = I.apply_pair_kernel(ps, cl, body, **pair_kw)
        ps, scalars, nb_ovf, fields = _finish(
            spec, StepCtx(ps=ps, combo=ps, cl=cl, pair=pair, red=red,
                          extras=extras, fields=state.fields, grid=grid))
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

    ``reuse`` selects the skin-amortized cadence (DESIGN.md §14) and makes
    the state a :class:`ReuseState` (build it with :func:`reuse_state`):

      * ``"skin"`` — cells widen to ``r_cut + skin``; the cell list is
        cached with the positions it was binned at, and a step rebuilds it
        only when the tripwire fires (some particle moved more than
        ``skin/2`` since, surfaced as ``StepFlags.stale``), so no pair
        within ``r_cut`` is missed;
      * ``"update"`` — the cached binning with no tripwire (the first step
        after a cold cache still builds). Unsafe beyond skin/2 drift; the
        negative control of the cadence.

    ``skin`` is the margin (default ``0.5 * r_cut``; in ``(0, r_cut]``).
    ``repro`` decides a step's branch in the graph (``lax.cond``); here it
    is one host read of the tripwire a step, and only the chosen branch
    runs.

    ``physics`` must be a module-level callable ``physics(cfg) ->``
    :class:`PhysicsSpec` and ``cfg`` hashable: the step is cached on
    ``(physics, cfg)``."""
    if reuse is not None and reuse not in ("skin", "update"):
        raise ValueError(
            f"reuse must be None, 'skin' or 'update'; got {reuse!r}")
    if mesh is not None or overlap or n_hops is not None:
        raise NotImplementedError(
            "make_sim_step on a device mesh (overlap, n_hops) arrives with "
            "the multi-device layer (ROADMAP A14); pass mesh=None")
    if reuse is not None:
        return _make_reuse_serial_fn(physics, cfg, slab_axis, reuse, skin)
    return make_serial_step_fn(physics, cfg, slab_axis=slab_axis)


# --------------------------------------------------------------------------
# The reuse engine: the serial skin-amortized cadence (DESIGN.md §14)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ReuseCache:
    """What the reuse engine carries across steps: the anchor positions
    the cell list was binned at, that binning, and the physics cache the
    spec declares (``cache_keys``, e.g. DEM's contact list). ``ok`` is a
    host bool (``repro``: a device scalar read by ``lax.cond``): False
    marks a cold cache, so the next step builds unconditionally. The
    multi-device fields of ``repro``'s cache (the ghost layer, the
    locals-only binning) arrive with ROADMAP A14."""

    ok: bool
    x_anchor: torch.Tensor               # (cap, dim) positions at build
    cl: CL.CellList                      # binning at build
    phys: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class ReuseState:
    """A :class:`DistributedParticles` riding with its reuse cache — the
    state type of ``make_sim_step(..., reuse=...)`` steps. Build with
    :func:`reuse_state`; read results from ``.inner``."""

    inner: DistributedParticles
    cache: ReuseCache


def _resolve_skin(spec: PhysicsSpec, skin: Optional[float]) -> float:
    rc = float(spec.r_cut)
    skin_v = float(skin) if skin is not None else 0.5 * rc
    if not 0.0 < skin_v <= rc:
        raise ValueError(
            f"reuse skin must be in (0, r_cut]; got {skin_v} (r_cut={rc})")
    return skin_v


@functools.lru_cache(maxsize=None)
def _make_reuse_serial_fn(physics, cfg, slab_axis, reuse, skin):
    """Serial reuse step: cached-binning reuse driven by the skin/2
    tripwire — the 1-slab case of ``repro``'s two-speed composition."""
    spec = physics(cfg)
    body = spec.make_body()
    skin_v = _resolve_skin(spec, skin)
    pair_kw = dict(out=spec.pair_out, r_cut=float(spec.r_cut),
                   prop_names=spec.pair_props, backend=spec.backend,
                   precision=spec.precision)
    mesh_periodic = bool(spec.periodic[slab_axis])
    cl_kw = _grid_kw(spec, (), skin=skin_v)

    def step(rstate: ReuseState, extras):
        state, cache = rstate.inner, rstate.cache
        red = Reduce(None)
        ps = state.ps
        dev = ps.device
        grid = G.GridOps(None, periodic=mesh_periodic, device=dev)
        if spec.advance is not None:
            ps = spec.advance(ps, red, extras)
        if cache.ok:
            moved = CL.moved_beyond(ps.x, cache.x_anchor, ps.valid, skin_v)
            stale = moved.to(torch.int32)
            # the one host read of the step (repro: lax.cond in the graph)
            take_full = reuse == "skin" and bool(moved)
        else:
            stale = torch.ones((), dtype=torch.int32, device=dev)
            take_full = True
        cl = CL.build_cell_list(ps, **cl_kw) if take_full else cache.cl
        pair = I.apply_pair_kernel(ps, cl, body, **pair_kw)
        extras_f = extras
        if spec.cache_keys:
            # serial slots never permute (no map), so slot-indexed physics
            # caches stay valid across rebuilds too
            extras_f = {**extras, **cache.phys,
                        "_reuse_slots_stable": torch.ones(
                            (), dtype=torch.bool, device=dev)}
        ps2, scalars, nb_ovf, fields = _finish(
            spec, StepCtx(ps=ps, combo=ps, cl=cl, pair=pair, red=red,
                          extras=extras_f, fields=state.fields, grid=grid))
        phys_new = cache.phys
        if spec.cache_keys:
            scalars = dict(scalars)
            phys_new = {k: scalars.pop(k) for k in spec.cache_keys}
        new_cache = ReuseCache(
            ok=True, x_anchor=ps.x if take_full else cache.x_anchor, cl=cl,
            phys=phys_new)
        z = _z32(dev)
        flags = StepFlags(cell=cl.overflow.to(torch.int32), neighbor=nb_ovf,
                          bucket=z, ghost=z, ghost_contract=z, window=z,
                          stale=stale)
        inner = dataclasses.replace(state, ps=ps2, fields=fields)
        return ReuseState(inner=inner, cache=new_cache), flags, scalars

    return step


def _cold_cell_list(cl_kw, rows_lead: int, id_lead: int, sentinel: int,
                    device) -> CL.CellList:
    """An all-empty cell list with the right static geometry — the
    cold-cache placeholder :func:`reuse_state` installs; its contents are
    never read (a cold cache builds first)."""
    n_cells = int(np.prod(cl_kw["grid_shape"]))
    return CL.CellList(
        cells=torch.full((rows_lead, int(cl_kw["cell_cap"])), sentinel,
                         dtype=torch.int32, device=device),
        counts=torch.zeros((rows_lead,), dtype=torch.int32, device=device),
        cell_id=torch.full((id_lead,), n_cells, dtype=torch.int32,
                           device=device),
        overflow=_z32(device),
        grid_shape=tuple(cl_kw["grid_shape"]),
        periodic=tuple(cl_kw["periodic"]),
        box_lo=tuple(cl_kw["box_lo"]), box_hi=tuple(cl_kw["box_hi"]))


def reuse_state(state: DistributedParticles, physics, cfg, mesh=None, *,
                skin: Optional[float] = None) -> ReuseState:
    """Wrap a container for the reuse engine with a cold cache: the first
    step builds unconditionally and warms it. Pass the ``skin`` given to
    ``make_sim_step``; it shapes the cached grid. ``mesh`` other than None
    is the multi-device layer (ROADMAP A14) and raises."""
    if mesh is not None:
        raise NotImplementedError(
            "reuse_state on a device mesh arrives with the multi-device "
            "layer (ROADMAP A14); pass mesh=None")
    spec = physics(cfg)
    skin_v = _resolve_skin(spec, skin)
    phys = {}
    if spec.cache_keys:
        if spec.cache_example is None:
            raise ValueError(
                "PhysicsSpec.cache_keys needs cache_example to seed the "
                "cold reuse cache")
        ex = spec.cache_example(state.ps)
        phys = {k: ex[k] for k in spec.cache_keys}
    cl_kw = _grid_kw(spec, (), skin=skin_v)
    cap = state.ps.capacity
    cache = ReuseCache(
        ok=False, x_anchor=state.ps.x,
        cl=_cold_cell_list(cl_kw, int(np.prod(cl_kw["grid_shape"])) + 1,
                           cap, cap, state.ps.device),
        phys=phys)
    return ReuseState(inner=state, cache=cache)


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
