"""Simulation layer — one particle container, every backend (port of
``repro.core.simulation``, DESIGN.md §9).

  * :class:`DistributedParticles` — the particle container plus the slab
    ``bounds`` it lives under; serial is the 1-slab case.
  * :class:`PhysicsSpec` — what an application declares: domain, cutoff,
    pair body, fields, and the ``advance``/``finish`` hooks.
  * :func:`make_sim_step` — the engine. ``mesh=None`` is the serial path:
    ``advance`` → cell list → cell-pair engine → ``finish``, with declared
    mesh fields (``PhysicsSpec.mesh_props``) riding in the container, and
    the serial skin-amortized reuse cadence (``reuse="skin"|"update"``,
    DESIGN.md §14; state type :class:`ReuseState`, built by
    :func:`reuse_state`). With a 1-D device mesh the same hooks run per
    rank with ``map()`` → multi-hop ``ghost_get`` → combo cell list →
    pair pass → ``finish``, under the split-phase overlap schedule or the
    blocking one, or under the two-speed reuse cadence (the ghost layer
    as a cache); :func:`distribute` cuts a rank's block and
    :func:`make_rebalance` moves the slab bounds (dynamic load
    balancing). Over a 2-D ``(rows, cols)`` device mesh the pencil step
    decomposes two space axes: a two-stage ``map()``, a two-stage
    ``ghost_get`` whose column exchange relays the corner ghosts, and one
    pair pass (DESIGN.md §13).

Capacity contracts surface as :class:`StepFlags`: 0-d int32 tensors on the
particles' device, the same on every rank. Nothing in an every-step
engine step reads a device tensor on the host, so it never waits for the
card; callers read the flags at their log points. The reuse step reads
one flag per step, on a mesh the pmax'd one (see :func:`make_sim_step`).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from . import cell_list as CL
from . import dlb
from . import grid as G
from . import interactions as I
from . import mappings as M
from . import runtime as RT
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
    axis the slab axis in mesh rows. ``col_bounds`` is the pencil
    decomposition's (DESIGN.md §13): rank (i, j) owns ``bounds[i] <= x0 <
    bounds[i+1]`` × ``col_bounds[j] <= x1 < col_bounds[j+1]``; None on
    slab and serial states (an empty subtree, so io and the fleet see
    the 1-D container's leaves)."""

    ps: ParticleSet
    bounds: torch.Tensor       # (n_slabs + 1,) float32
    fields: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    col_bounds: Optional[torch.Tensor] = None   # (n_cols + 1,) float32

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
    """Global reductions handed to physics hooks: the mesh collectives
    over ``axis_name`` (a name, or the pencil's ``(rows, cols)`` tuple) on
    a distributed step, identities serially — so a hook writes e.g. the
    SPH global dt once (``red.max(amax)``)."""

    axis_name: Any = None

    @property
    def distributed(self) -> bool:
        return self.axis_name is not None

    def max(self, x):
        return RT.pmax(x, self.axis_name) if self.axis_name else x

    def sum(self, x):
        return RT.psum(x, self.axis_name) if self.axis_name else x

    def mean(self, x):
        return RT.pmean(x, self.axis_name) if self.axis_name else x

    def gather(self, x):
        """(ndev,)-stacked per-shard values (shape (1,) serially)."""
        if self.axis_name:
            return RT.all_gather(x, self.axis_name)
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
    particle set. ``ghost_props`` are the props ghosts carry (OpenFPM's
    property-subset ``ghost_get``; a superset of ``pair_props``), and
    ``bucket_cap``/``ghost_cap`` the default ``map()`` bucket and
    ``ghost_get`` per-side capacities of a mesh step. ``update_props`` are
    the ghost props a reuse update step on a mesh refreshes (default
    ``pair_props``); the other ghost props come from the cached layer.
    ``finish_writes`` are the props ``finish`` overwrites before anything
    reads them (MD's force): a mesh step's ``map()`` leaves them out of
    its messages, as ``repro``'s compiled step drops their all-to-alls as
    unread.
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
    ghost_props: Tuple[str, ...] = ()        # props ghosts carry
    extras_example: Tuple[str, ...] = ()     # names of per-step extras
    bucket_cap: int = 512                    # map() per-destination bucket
    ghost_cap: int = 1024                    # ghost_get per-side capacity
    mesh_props: Tuple[str, ...] = ()         # mesh fields in state.fields
    update_props: Optional[Tuple[str, ...]] = None  # ghost props refreshed
    #                                          on reuse update steps
    finish_writes: Tuple[str, ...] = ()      # props finish overwrites unread
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


def _auto_hops(rc: float, box_len: float, ndev: int) -> int:
    """Static default ghost-hop count: the hops a *uniform* decomposition
    of ``ndev`` slabs needs to cover ``rc`` (clamped to the ring
    diameter). The step re-derives the need from its bounds; the excess
    lands in ``StepFlags.ghost_contract``."""
    if ndev <= 1:
        return 1
    need = int(np.ceil(rc * ndev / box_len - 1e-9))
    return max(1, min(ndev - 1, need))


def _slab_geom(cl_kw, slab_axis: int, ndev: int,
               interior_rows: Optional[int], device):
    """Static split-phase window geometry over a slab-decomposed cell
    grid: the slab-axis row count, the interior window ``w_int``, the
    coordinate→row map (the cell list's own binning expression, so window
    edges agree with particle homes bit for bit) and whole rows → flat
    home-cell ids (masked-out rows become the sentinel ``n_cells``)."""
    gs = cl_kw["grid_shape"]
    n_rows = int(gs[slab_axis])
    n_cells = int(np.prod(gs))
    strides = np.concatenate(
        [np.cumprod(np.asarray(gs)[::-1])[::-1][1:], [1]]).astype(np.int64)
    row_stride = int(strides[slab_axis])
    oshape = list(gs)
    oshape[slab_axis] = 1
    oix = np.indices(oshape).reshape(len(gs), -1)
    # flat cell ids of the slab-row cross-section (row index 0)
    other_offs = const_tensor(tuple(int(v) for v in np.sort(
        (oix * strides[:, None]).sum(axis=0))), torch.int32, device)
    lo_s = const_tensor((float(cl_kw["box_lo"][slab_axis]),), torch.float32,
                        device)[0]
    hi_s = const_tensor((float(cl_kw["box_hi"][slab_axis]),), torch.float32,
                        device)[0]
    w_int = int(interior_rows if interior_rows is not None
                else min(n_rows, -(-n_rows // ndev) + 4))

    def row_of(t):
        frac = (t - lo_s) / (hi_s - lo_s)
        r = torch.floor(frac * float(n_rows))
        return torch.clamp(torch.clamp(r, min=0.0), max=n_rows - 1).to(
            torch.int32)

    def rows_to_cells(rows, ok):
        flat = rows[:, None] * row_stride + other_offs[None, :]
        return torch.where(ok[:, None], flat,
                           torch.full_like(flat, n_cells)).reshape(-1)

    return dict(n_rows=n_rows, n_cells=n_cells, w_int=w_int, row_of=row_of,
                rows_to_cells=rows_to_cells)


def _hop_excess(bounds: torch.Tensor, rc: float, k: int) -> torch.Tensor:
    """The ghost contract against the slab bounds: how many hops ``ceil(rc
    / min width)`` needs beyond the ``k`` exchanged (0 = covered)."""
    min_w = torch.clamp((bounds[1:] - bounds[:-1]).min(), min=1e-12)
    k_needed = torch.ceil(rc / min_w).to(torch.int32)
    return torch.clamp(k_needed - k, min=0).to(torch.int32)


#: Boundary cell rows per slab face in the split-phase schedule: <= 3 are
#: needed (cells are >= r_cut wide, so [face - r_cut, face + r_cut] spans
#: <= 3 rows), plus 1 margin each way for fp32 seam-shift rounding.
W_B = 5


def _interior_cells(g, my_lo, my_hi):
    """The split-phase interior home cells: the ``w_int`` rows from this
    rank's first owned row; and the window excess (0-d, the owned rows
    past the window: ``StepFlags.window``)."""
    r0 = g["row_of"](my_lo)
    r_last = g["row_of"](my_hi)
    rows = r0 + torch.arange(g["w_int"], dtype=torch.int32,
                             device=my_lo.device)
    return (g["rows_to_cells"](rows, rows < g["n_rows"]),
            torch.clamp(r_last + 1 - (r0 + g["w_int"]), min=0))


def _boundary_cells(g, my_lo, my_hi, width: float):
    """The split-phase boundary home cells: ``W_B`` rows from one below
    ``face - width`` at either face (the band within ``width`` of a face
    and the ghost pad), the hi side deduplicated against the lo side so no
    cell scatters twice."""
    wb = torch.arange(W_B, dtype=torch.int32, device=my_lo.device)
    lo_rows = g["row_of"](my_lo - width) - 1 + wb
    hi_rows = g["row_of"](my_hi - width) - 1 + wb
    lo_ok = (lo_rows >= 0) & (lo_rows < g["n_rows"])
    hi_ok = ((hi_rows >= 0) & (hi_rows < g["n_rows"])
             & (hi_rows > lo_rows[-1]))
    return torch.cat([g["rows_to_cells"](lo_rows, lo_ok),
                      g["rows_to_cells"](hi_rows, hi_ok)])


def _combine(ps, cl, pair_int, pair_bnd, bnd_cells):
    """Per particle, the boundary pass's sums where its home cell in
    ``cl`` (the combined cell list) is one of ``bnd_cells`` (and for every
    ghost row), the interior pass's elsewhere. The boundary cells hold
    every particle within the combine width of a face and every cell whose
    neighbourhood holds ghost slots, so elsewhere the interior pass ran
    the blocking pass's very tile: the same sums, bit for bit, on an
    engine whose summation order follows the tile's valid candidates."""
    n_loc = ps.capacity
    mark = torch.zeros(cl.n_cells + 1, dtype=torch.bool,
                       device=bnd_cells.device)
    mark[bnd_cells.long()] = True
    mark[cl.n_cells] = False             # the inactive sentinel's row
    bnd = mark[cl.cell_id[:n_loc].long()]
    return {k: torch.cat([torch.where(I._bmask(bnd, v[:n_loc]), v[:n_loc],
                                      pair_int[k]), v[n_loc:]])
            for k, v in pair_bnd.items()}


def _combo_of(ps: ParticleSet, ghosts: M.GhostLayer,
              prop_names) -> ParticleSet:
    """Locals then ghosts, over the ghost props: the set a slab step's
    combo cell list bins and its pair pass reads."""
    gp = ghosts.as_particles()
    return ParticleSet(
        x=torch.cat([ps.x, gp.x]),
        props={k: torch.cat([ps.props[k], gp.props[k]]) for k in prop_names},
        valid=torch.cat([ps.valid, gp.valid]))


def _axis_names(mesh, axis_name):
    """(row axis, column axis or None, size of the column axis) of
    ``axis_name``: a name, or a ``(row, col)`` tuple."""
    if not isinstance(axis_name, tuple):
        return axis_name, None, 1
    row, col = axis_name
    return row, col, int(mesh.size(mesh.mesh_dim_names.index(col)))


@functools.lru_cache(maxsize=None)
def make_sim_step(physics, cfg, mesh=None, *, axis_name="shards",
                  slab_axis: int = 0, bucket_cap: Optional[int] = None,
                  ghost_cap: Optional[int] = None, overlap: bool = True,
                  interior_rows: Optional[int] = None,
                  n_hops: Optional[int] = None,
                  reuse: Optional[str] = None,
                  skin: Optional[float] = None):
    """Build the simulation step for ``physics(cfg)``: ``step(state,
    extras) -> (state, flags, scalars)`` over a
    :class:`DistributedParticles` state. The step runs eagerly (``repro``
    jits it).

    ``mesh=None`` builds the serial path (the mesh options are then
    ignored, as in ``repro``). With a 1-D device mesh (``runtime
    .make_mesh``) every rank calls the step on its own block (its state
    from :func:`distribute`): ``map()`` under the (replicated) bounds, the
    ``n_hops``-hop ``ghost_get`` of ``ghost_props`` (default: the hops a
    uniform decomposition needs; a shortfall against the actual bounds is
    ``StepFlags.ghost_contract``), a cell list over locals + ghosts on the
    ghost-padded box, the pair pass, and ``finish``. ``bucket_cap`` and
    ``ghost_cap`` default to the spec's. A ``(row, col)`` tuple
    ``axis_name`` whose column axis has size 1 is the same slab step over
    the row axis (bit for bit). A larger column axis is the pencil step
    (DESIGN.md §13; :func:`distribute` with the tuple gives its state):
    particles are decomposed along ``slab_axis`` over the rows and
    ``slab_axis + 1`` over the columns, with a two-stage map, a two-stage
    ghost_get (rows, then the columns over locals + row ghosts, which
    relays the corner ghosts) and one blocking pair pass over a cell box
    padded on both axes. ``n_hops`` is then per axis.

    ``overlap=True`` selects the split-phase schedule (DESIGN.md §12): the
    ghost shifts are issued first (``mappings.ghost_get_start``), the pair
    engine runs on the interior cell rows of a locals-only cell list while
    they fly, and only the boundary rows (within r_cut of a face, and the
    ghost pad) wait for the ghosts; the combine takes each particle's sums
    from the pass that saw all its partners. Both passes sum identical
    tiles, so the step equals ``overlap=False`` (the blocking chain) bit
    for bit. Multi-hop and pencil steps run the blocking schedule.
    ``interior_rows``
    caps the interior window (default: the uniform share + 4); a slab
    beyond it raises ``StepFlags.window``.

    ``reuse`` selects the skin-amortized two-speed cadence (DESIGN.md
    §14) and makes the state a :class:`ReuseState` (build it with
    :func:`reuse_state`, mirroring these options):

      * ``"skin"`` — cells (and on a mesh the ghost band) widen to
        ``r_cut + skin``; the cell list (on a mesh also the ghost slot
        layout) is cached with the positions it was built at, and a step
        rebuilds only when the tripwire fires (some particle moved more
        than ``skin/2`` since, surfaced as ``StepFlags.stale``), so no
        pair within ``r_cut`` is missed. A step in between is an update
        step: on a mesh no ``map()`` and no re-binning, only the
        fixed-payload ``mappings.ghost_update_start`` refreshing the
        positions and ``update_props`` of the same ghost slots; with
        ``overlap`` the interior pass runs on the cached locals-only
        binning while that refresh is in flight;
      * ``"update"`` — the cached structure with no tripwire (the first
        step after a cold cache still builds). Unsafe beyond skin/2
        drift; the negative control of the cadence.

    ``skin`` is the margin (default ``0.5 * r_cut``; in ``(0, r_cut]``).
    ``repro`` decides a step's branch in the graph (``lax.cond``); here it
    is one host read of the tripwire a step, and only the chosen branch
    runs. On a mesh the tripwire read is of its ``pmax`` over the ranks,
    so every rank takes the same branch and issues the same collectives.
    On a pencil mesh (more than one column) reuse runs ``repro``'s inert
    fallback: every step is the full pencil step, ``StepFlags.stale`` is
    1 throughout, and the state is still a :class:`ReuseState`. (A tuple
    with one column runs the slab reuse step, where ``repro`` runs the
    fallback on any tuple.)

    ``physics`` must be a module-level callable ``physics(cfg) ->``
    :class:`PhysicsSpec` and ``cfg`` hashable: the step is cached on
    ``(physics, cfg, mesh, ...)``."""
    if reuse is not None and reuse not in ("skin", "update"):
        raise ValueError(
            f"reuse must be None, 'skin' or 'update'; got {reuse!r}")
    if mesh is None:
        if reuse is not None:
            return _make_reuse_serial_fn(physics, cfg, slab_axis, reuse,
                                         skin)
        return make_serial_step_fn(physics, cfg, slab_axis=slab_axis)
    row_axis, col_axis, ndev_c = _axis_names(mesh, axis_name)
    if ndev_c > 1:
        inner = _make_sim_step_2d(physics, cfg, mesh, row_axis, col_axis,
                                  slab_axis, bucket_cap, ghost_cap, n_hops)
        return inner if reuse is None else _wrap_reuse_fallback(inner)
    if reuse is not None:
        return _make_reuse_step_1d(physics, cfg, mesh, row_axis, slab_axis,
                                   bucket_cap, ghost_cap, overlap,
                                   interior_rows, n_hops, reuse, skin)
    return _make_sim_step_1d(physics, cfg, mesh, row_axis, slab_axis,
                             bucket_cap, ghost_cap, overlap, interior_rows,
                             n_hops)


def _make_sim_step_1d(physics, cfg, mesh, axis_name: str, slab_axis: int,
                      bucket_cap, ghost_cap, overlap: bool, interior_rows,
                      n_hops):
    """The slab (1-D device mesh) step composition, per rank."""
    spec = physics(cfg)
    body = spec.make_body()
    rc = float(spec.r_cut)
    pair_kw = dict(out=spec.pair_out, r_cut=rc, prop_names=spec.pair_props,
                   backend=spec.backend, precision=spec.precision)
    b_cap = int(bucket_cap or spec.bucket_cap)
    g_cap = int(ghost_cap or spec.ghost_cap)
    box_len = float(spec.box_hi[slab_axis]) - float(spec.box_lo[slab_axis])
    per_slab = bool(spec.periodic[slab_axis])
    with RT.on_mesh(mesh):
        ndev = RT.axis_size(axis_name)
    k_hops = int(n_hops) if n_hops is not None else _auto_hops(rc, box_len,
                                                               ndev)
    cl_kw = _grid_kw(spec, (slab_axis,))
    # the split-phase windows assume single-hop boundary bands
    overlap = overlap and k_hops == 1
    geoms = {}

    def geom(device):
        if device not in geoms:
            geoms[device] = _slab_geom(cl_kw, slab_axis, ndev,
                                       interior_rows, device)
        return geoms[device]

    def local_step(state: DistributedParticles, extras):
        red = Reduce(axis_name)
        ps, bounds = state.ps, state.bounds
        dev = ps.device
        grid = G.GridOps(axis_name, periodic=per_slab, device=dev)
        if spec.advance is not None:
            ps = spec.advance(ps, red, extras)
        # map(): migrate to the owners under the (replicated) bounds
        ps, ovf_bucket = M.map_particles_local(ps, bounds, axis_name, b_cap,
                                               slab_axis, spec.finish_writes)
        contract = _hop_excess(bounds, rc, k_hops)
        pending = M.ghost_get_start(
            ps, bounds, rc, axis_name, g_cap, periodic=per_slab,
            box_len=box_len, slab_axis=slab_axis,
            prop_names=spec.ghost_props, n_hops=k_hops, src_slots=False)
        win_ovf = _z32(dev)
        if overlap:
            # the interior pass while the ghosts fly: a locals-only cell
            # list restricted to this rank's owned rows (boundary
            # particles get ghost-less sums here, replaced below)
            g = geom(dev)
            me = RT.axis_index(axis_name)
            my_lo, my_hi = bounds[me], bounds[me + 1]
            int_cells, win_ovf = _interior_cells(g, my_lo, my_hi)
            cl_loc = CL.build_cell_list(ps, **cl_kw)
            pair_int = I.apply_pair_kernel(ps, cl_loc, body, cells=int_cells,
                                           **pair_kw)
        ghosts, ovf_ghost = pending.wait()
        combo = _combo_of(ps, ghosts, spec.ghost_props)
        cl = CL.build_cell_list(combo, **cl_kw)
        if overlap:
            # the boundary pass against the arrived ghosts
            bnd_cells = _boundary_cells(g, my_lo, my_hi, rc)
            pair_bnd = I.apply_pair_kernel(combo, cl, body, cells=bnd_cells,
                                           **pair_kw)
            pair = _combine(ps, cl, pair_int, pair_bnd, bnd_cells)
            cl_ovf = torch.maximum(cl.overflow, cl_loc.overflow)
        else:
            pair = I.apply_pair_kernel(combo, cl, body, **pair_kw)
            cl_ovf = cl.overflow
        ps, scalars, nb_ovf, fields = _finish(
            spec, StepCtx(ps=ps, combo=combo, cl=cl, pair=pair, red=red,
                          extras=extras, fields=state.fields, grid=grid))
        # the rank-local flags in one all_reduce
        local = RT.pmax(torch.stack([cl_ovf.to(torch.int32), nb_ovf,
                                     win_ovf.to(torch.int32)]), axis_name)
        flags = StepFlags(cell=local[0], neighbor=local[1],
                          bucket=ovf_bucket, ghost=ovf_ghost,
                          ghost_contract=contract, window=local[2],
                          stale=_z32(dev))
        return (dataclasses.replace(state, ps=ps, fields=fields), flags,
                scalars)

    def step(state: DistributedParticles, extras):
        with RT.on_mesh(mesh):
            return local_step(state, extras)

    return step


def _make_sim_step_2d(physics, cfg, mesh, row_axis: str, col_axis: str,
                      slab_axis: int, bucket_cap, ghost_cap, n_hops):
    """The pencil (2-D device mesh) step composition, per rank (``repro``'s
    ``_make_sim_step_2d``, DESIGN.md §13): two-stage map, two-stage
    multi-hop ghost_get (the columns exchange locals + row ghosts,
    relaying the corner ghosts), one blocking pair pass over a cell box
    ghost-padded on both decomposed axes."""
    spec = physics(cfg)
    if spec.mesh_props:
        raise NotImplementedError(
            "mesh_props on a 2-D device mesh need pencil GridOps (neither "
            "package has them); decompose mesh-carrying physics as "
            "(ndev, 1) or use apps/vortex.py's pencil VIC step")
    col_space_axis = slab_axis + 1
    if col_space_axis >= len(spec.box_lo):
        raise ValueError("pencil decomposition needs a space axis "
                         f"{col_space_axis}; physics is "
                         f"{len(spec.box_lo)}-D")
    body = spec.make_body()
    rc = float(spec.r_cut)
    pair_kw = dict(out=spec.pair_out, r_cut=rc, prop_names=spec.pair_props,
                   backend=spec.backend, precision=spec.precision)
    b_cap = int(bucket_cap or spec.bucket_cap)
    g_cap = int(ghost_cap or spec.ghost_cap)
    box_len_r = float(spec.box_hi[slab_axis]) - float(spec.box_lo[slab_axis])
    box_len_c = (float(spec.box_hi[col_space_axis])
                 - float(spec.box_lo[col_space_axis]))
    per_row = bool(spec.periodic[slab_axis])
    per_col = bool(spec.periodic[col_space_axis])
    with RT.on_mesh(mesh):
        ndev_r = RT.axis_size(row_axis)
        ndev_c = RT.axis_size(col_axis)
    k_row = (int(n_hops) if n_hops is not None
             else _auto_hops(rc, box_len_r, ndev_r))
    k_col = (int(n_hops) if n_hops is not None
             else _auto_hops(rc, box_len_c, ndev_c))
    axes = (row_axis, col_axis)
    cl_kw = _grid_kw(spec, (slab_axis, col_space_axis))

    def local_step(state: DistributedParticles, extras):
        red = Reduce(axes)
        ps, bounds, cbounds = state.ps, state.bounds, state.col_bounds
        if spec.advance is not None:
            ps = spec.advance(ps, red, extras)
        # two-stage map(): rows re-own along slab_axis within each mesh
        # column, then columns along col_space_axis within each row
        ps, ovf_r = M.map_particles_local(ps, bounds, row_axis, b_cap,
                                          slab_axis, spec.finish_writes)
        ps, ovf_c = M.map_particles_local(ps, cbounds, col_axis, b_cap,
                                          col_space_axis, spec.finish_writes)
        contract = torch.maximum(_hop_excess(bounds, rc, k_row),
                                 _hop_excess(cbounds, rc, k_col))
        # two-stage ghost_get: rows first; the column exchange ships
        # locals + row ghosts, so the corners relay through the (row,
        # col -/+ 1) neighbour with no diagonal sends
        ghosts_r, ovf_gr = M.ghost_get_local(
            ps, bounds, rc, row_axis, g_cap, periodic=per_row,
            box_len=box_len_r, slab_axis=slab_axis,
            prop_names=spec.ghost_props, n_hops=k_row, src_slots=False)
        combo_r = _combo_of(ps, ghosts_r, spec.ghost_props)
        ghosts_c, ovf_gc = M.ghost_get_local(
            combo_r, cbounds, rc, col_axis, g_cap, periodic=per_col,
            box_len=box_len_c, slab_axis=col_space_axis,
            prop_names=spec.ghost_props, n_hops=k_col, src_slots=False)
        combo = _combo_of(combo_r, ghosts_c, spec.ghost_props)
        cl = CL.build_cell_list(combo, **cl_kw)
        pair = I.apply_pair_kernel(combo, cl, body, **pair_kw)
        ps, scalars, nb_ovf, fields = _finish(
            spec, StepCtx(ps=ps, combo=combo, cl=cl, pair=pair, red=red,
                          extras=extras, fields=state.fields,
                          grid=G.GridOps(device=ps.device)))
        # the flags over both axes, in one reduction
        local = RT.pmax(torch.stack([
            cl.overflow.to(torch.int32), nb_ovf,
            torch.maximum(ovf_r, ovf_c).to(torch.int32),
            torch.maximum(ovf_gr, ovf_gc).to(torch.int32)]), axes)
        flags = StepFlags(cell=local[0], neighbor=local[1], bucket=local[2],
                          ghost=local[3], ghost_contract=contract,
                          window=_z32(ps.device), stale=_z32(ps.device))
        return (dataclasses.replace(state, ps=ps, fields=fields), flags,
                scalars)

    def step(state: DistributedParticles, extras):
        with RT.on_mesh(mesh):
            return local_step(state, extras)

    return step


# --------------------------------------------------------------------------
# The reuse engine: the skin-amortized two-speed cadence (DESIGN.md §14)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ReuseCache:
    """What the reuse engine carries across steps (OpenFPM's ghost layer
    as a cache, paper §4.1): the anchor positions the structure was built
    from, the (combo) cell-list binning, on a mesh the ghost layer (slot
    layout and static props; its positions are the build-time ones) and
    the locals-only binning of the split-phase schedule (``None``
    serially), and the physics cache the spec declares (``cache_keys``,
    e.g. DEM's contact list). ``ok`` is a host bool (``repro``: a device
    scalar read by ``lax.cond``): False marks a cold cache, so the next
    step builds unconditionally. On a mesh it is the same on every rank:
    every rank sets it from the same replicated decision."""

    ok: bool
    x_anchor: torch.Tensor               # (cap, dim) positions at build
    cl: CL.CellList                      # combo binning at build
    ghosts: Optional[M.GhostLayer] = None   # cached layer (None serially)
    cl_loc: Optional[CL.CellList] = None    # locals-only binning (overlap)
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


def _make_reuse_step_1d(physics, cfg, mesh, axis_name: str, slab_axis: int,
                        bucket_cap, ghost_cap, overlap: bool, interior_rows,
                        n_hops, reuse: str, skin):
    """The two-speed slab step (``repro``'s ``_make_reuse_step_1d``), per
    rank. Each step advances, then reads the Verlet tripwire (locals
    against their build anchors) pmax'd over the ranks: every ghost is
    some rank's local with the same anchor, so the global max covers the
    ghost band too, and every rank takes the same branch. The full branch
    is map → ``ghost_get`` at ``r_cut + skin`` → combo cell list → one pair
    pass (with overlap, also the locals-only binning later update steps
    use). The update branch issues ``mappings.ghost_update_start`` (the
    positions and ``update_props`` of the cached ghost slots, re-derived
    from the cached anchors so the slots are the cached layer's), runs
    the interior pass on the cached locals-only binning while it flies
    (overlap), then the pass over the combo on the cached binning: only
    its boundary rows with overlap, the whole combo without. Cells and
    the ghost band are ``r_cut + skin`` wide, so the cached structure is
    pair-complete for ``r_cut`` until some particle drifts past skin/2,
    which is when the tripwire forces the full branch."""
    spec = physics(cfg)
    body = spec.make_body()
    rc = float(spec.r_cut)
    skin_v = _resolve_skin(spec, skin)
    r_g = rc + skin_v
    pair_kw = dict(out=spec.pair_out, r_cut=rc, prop_names=spec.pair_props,
                   backend=spec.backend, precision=spec.precision)
    b_cap = int(bucket_cap or spec.bucket_cap)
    g_cap = int(ghost_cap or spec.ghost_cap)
    box_len = float(spec.box_hi[slab_axis]) - float(spec.box_lo[slab_axis])
    per_slab = bool(spec.periodic[slab_axis])
    with RT.on_mesh(mesh):
        ndev = RT.axis_size(axis_name)
    k_row = (int(n_hops) if n_hops is not None
             else _auto_hops(r_g, box_len, ndev))
    overlap = overlap and k_row == 1
    cl_kw = _grid_kw(spec, (slab_axis,), skin=skin_v)
    upd_props = (spec.update_props if spec.update_props is not None
                 else spec.pair_props)
    gkw = dict(periodic=per_slab, box_len=box_len, slab_axis=slab_axis,
               n_hops=k_row)
    # W_B boundary rows per face hold here too: the combine band is r_cut
    # + skin wide and cached anchors lag positions by <= skin/2, so the
    # band's build rows span <= 2 + (skin/2)/(r_cut + skin) <= 2.25 cell
    # widths: <= 4 rows, + 1 low margin
    geoms = {}

    def geom(device):
        if device not in geoms:
            geoms[device] = _slab_geom(cl_kw, slab_axis, ndev,
                                       interior_rows, device)
        return geoms[device]

    def local_step(rstate: ReuseState, extras):
        state, cache = rstate.inner, rstate.cache
        red = Reduce(axis_name)
        ps, bounds = state.ps, state.bounds
        dev = ps.device
        grid = G.GridOps(axis_name, periodic=per_slab, device=dev)
        if spec.advance is not None:
            ps = spec.advance(ps, red, extras)
        if cache.ok:
            moved = CL.moved_beyond(ps.x, cache.x_anchor, ps.valid, skin_v)
            stale = RT.pmax(moved.to(torch.int32), axis_name)
            # the one host read of the step, of the pmax'd tripwire (repro:
            # lax.cond in the graph); "update" skips it
            take_full = reuse == "skin" and bool(stale)
        else:
            stale = torch.ones((), dtype=torch.int32, device=dev)
            take_full = True
        contract = _hop_excess(bounds, r_g, k_row)
        win_ovf = _z32(dev)
        if overlap:
            g = geom(dev)
            me = RT.axis_index(axis_name)
            my_lo, my_hi = bounds[me], bounds[me + 1]
            int_cells, win_ovf = _interior_cells(g, my_lo, my_hi)
        if take_full:
            # the rebuild branch's collectives are conditional: repro's
            # sit in a lax.cond branch (launch/comm_analysis.py)
            with RT.conditional():
                ps, ovf_bucket = M.map_particles_local(
                    ps, bounds, axis_name, b_cap, slab_axis,
                    spec.finish_writes)
                ghosts, ovf_ghost = M.ghost_get_local(
                    ps, bounds, r_g, axis_name, g_cap,
                    prop_names=spec.ghost_props, **gkw)
            combo = _combo_of(ps, ghosts, spec.ghost_props)
            cl = CL.build_cell_list(combo, **cl_kw)
            pair = I.apply_pair_kernel(combo, cl, body, **pair_kw)
            cl_loc = CL.build_cell_list(ps, **cl_kw) if overlap else None
        else:
            # the same slots, refreshed positions and update props; the
            # valid mask, source slots, static props and both binnings
            # come from the cache
            pending = M.ghost_update_start(ps, cache.x_anchor, bounds, r_g,
                                           axis_name, g_cap,
                                           prop_names=upd_props, **gkw)
            cl, cl_loc = cache.cl, cache.cl_loc
            if overlap:
                pair_int = I.apply_pair_kernel(ps, cl_loc, body,
                                               cells=int_cells, **pair_kw)
            upd = pending.wait()
            ghosts = dataclasses.replace(
                cache.ghosts, x=upd["x"],
                props={**cache.ghosts.props,
                       **{k: upd[k] for k in upd_props}})
            combo = _combo_of(ps, ghosts, spec.ghost_props)
            if overlap:
                # the combine band widens by the skin: cached ghosts may
                # have drifted up to skin/2 into the slab since the build
                bnd_cells = _boundary_cells(g, my_lo, my_hi, r_g)
                pair_bnd = I.apply_pair_kernel(combo, cl, body,
                                               cells=bnd_cells, **pair_kw)
                pair = _combine(ps, cl, pair_int, pair_bnd, bnd_cells)
            else:
                pair = I.apply_pair_kernel(combo, cl, body, **pair_kw)
            ovf_bucket = ovf_ghost = _z32(dev)
        extras_f = extras
        if spec.cache_keys:
            # combo slots hold only while nothing re-mapped or re-ghosted
            extras_f = {**extras, **cache.phys,
                        "_reuse_slots_stable": torch.full(
                            (), not take_full, dtype=torch.bool,
                            device=dev)}
        ps2, scalars, nb_ovf, fields = _finish(
            spec, StepCtx(ps=ps, combo=combo, cl=cl, pair=pair, red=red,
                          extras=extras_f, fields=state.fields, grid=grid))
        phys_new = cache.phys
        if spec.cache_keys:
            scalars = dict(scalars)
            phys_new = {k: scalars.pop(k) for k in spec.cache_keys}
        # the rank-local flags in one all_reduce; the cached cell lists
        # keep the pmax'd overflow, the same on every rank
        loc_ovf = cl_loc.overflow if overlap else _z32(dev)
        local = RT.pmax(torch.stack([cl.overflow.to(torch.int32),
                                     loc_ovf.to(torch.int32), nb_ovf,
                                     win_ovf.to(torch.int32)]), axis_name)
        cl = dataclasses.replace(cl, overflow=local[0])
        if overlap:
            cl_loc = dataclasses.replace(cl_loc, overflow=local[1])
        # an update step keeps the cached layer (anchor positions), not
        # the refreshed one: its slots are the same
        new_cache = ReuseCache(
            ok=True, x_anchor=ps.x if take_full else cache.x_anchor, cl=cl,
            ghosts=ghosts if take_full else cache.ghosts, cl_loc=cl_loc,
            phys=phys_new)
        flags = StepFlags(cell=torch.maximum(local[0], local[1]),
                          neighbor=local[2], bucket=ovf_bucket,
                          ghost=ovf_ghost, ghost_contract=contract,
                          window=local[3], stale=stale)
        inner = dataclasses.replace(state, ps=ps2, fields=fields)
        return ReuseState(inner=inner, cache=new_cache), flags, scalars

    def step(rstate: ReuseState, extras):
        with RT.on_mesh(mesh):
            return local_step(rstate, extras)

    return step


def _wrap_reuse_fallback(inner_step):
    """The reuse engine on a pencil mesh (``repro``'s inert fallback): the
    cache rides along untouched and every step runs the full pencil step;
    ``StepFlags.stale`` is 1 throughout, the state a :class:`ReuseState`."""
    def step(rstate: ReuseState, extras):
        inner, flags, scalars = inner_step(rstate.inner, extras)
        flags = dataclasses.replace(flags, stale=torch.ones(
            (), dtype=torch.int32, device=flags.stale.device))
        return ReuseState(inner=inner, cache=rstate.cache), flags, scalars
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
                axis_name="shards", slab_axis: int = 0,
                ghost_cap: Optional[int] = None, overlap: bool = True,
                n_hops: Optional[int] = None,
                skin: Optional[float] = None) -> ReuseState:
    """Wrap a container for the reuse engine with a COLD cache: the first
    step takes the full path (on a mesh map → ghost_get → rebuild)
    unconditionally and warms it. Mirror the options given to
    ``make_sim_step``: they shape the cached structure (grid geometry, hop
    count, overlap binning). On a mesh each rank wraps its own block, so
    the cache has this rank's shapes. Call it again after any
    re-decomposition outside the step (``make_rebalance``): a moved slab
    boundary invalidates the cached ghost slots. On a pencil mesh (more
    than one column) the cache is the inert one of ``repro``'s fallback,
    shaped as the serial cache (see :func:`make_sim_step`)."""
    spec = physics(cfg)
    skin_v = _resolve_skin(spec, skin)
    pencil = False
    if mesh is not None:
        row_axis, _, ndev_c = _axis_names(mesh, axis_name)
        pencil = ndev_c > 1
    phys = {}
    if spec.cache_keys:
        if spec.cache_example is None:
            raise ValueError(
                "PhysicsSpec.cache_keys needs cache_example to seed the "
                "cold reuse cache")
        ex = spec.cache_example(state.ps)
        phys = {k: ex[k] for k in spec.cache_keys}
    ps = state.ps
    dev = ps.device
    cap = ps.capacity
    if mesh is None or pencil:
        cl_kw = _grid_kw(spec, (), skin=skin_v)
        cache = ReuseCache(
            ok=False, x_anchor=ps.x,
            cl=_cold_cell_list(cl_kw, int(np.prod(cl_kw["grid_shape"])) + 1,
                               cap, cap, dev),
            phys=phys)
        return ReuseState(inner=state, cache=cache)
    g_cap = int(ghost_cap or spec.ghost_cap)
    box_len = float(spec.box_hi[slab_axis]) - float(spec.box_lo[slab_axis])
    with RT.on_mesh(mesh):
        ndev = RT.axis_size(row_axis)
    k_row = (int(n_hops) if n_hops is not None
             else _auto_hops(float(spec.r_cut) + skin_v, box_len, ndev))
    overlap = overlap and k_row == 1
    cl_kw = _grid_kw(spec, (slab_axis,), skin=skin_v)
    n_cells = int(np.prod(cl_kw["grid_shape"]))
    k2 = 2 * k_row
    combo_cap = cap + k2 * g_cap
    ghosts = M.GhostLayer(
        x=torch.zeros((k2, g_cap, ps.x.shape[1]), dtype=ps.x.dtype,
                      device=dev),
        props={k: torch.zeros((k2, g_cap) + tuple(ps.props[k].shape[1:]),
                              dtype=ps.props[k].dtype, device=dev)
               for k in spec.ghost_props},
        valid=torch.zeros((k2, g_cap), dtype=torch.bool, device=dev),
        src_slot=torch.full((k2, g_cap), cap, dtype=torch.int32,
                            device=dev))
    cache = ReuseCache(
        ok=False, x_anchor=ps.x,
        cl=_cold_cell_list(cl_kw, n_cells + 1, combo_cap, combo_cap, dev),
        ghosts=ghosts,
        cl_loc=(_cold_cell_list(cl_kw, n_cells + 1, cap, cap, dev)
                if overlap else None),
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


@functools.lru_cache(maxsize=None)
def make_rebalance(physics, cfg, mesh, *, axis_name="shards",
                   slab_axis: int = 0, bucket_cap: Optional[int] = None,
                   nbins: int = 256, min_slab_width: Optional[float] = None,
                   n_hops: int = 1):
    """The DLB 'repartition + migrate' pair (paper §3.5), as each rank
    calls it: cost-balanced slab bounds from the particle histogram
    (psum'd over the ranks, so every rank computes the same bounds), then
    ``map()`` under the new decomposition. The bounds are projected onto
    slabs >= ``min_slab_width`` (default ``r_cut·1.001 / n_hops``: a step
    exchanging ``n_hops`` ghost hops covers r_cut across slabs that thin;
    the 0.1% margin keeps rounding from landing under it), so the
    balancer never moves the decomposition into ghost-contract violation.
    Mesh fields stay where they are: DLB moves the particle slab bounds
    only. Returns ``fn(state) -> (state, overflow)``, overflow the
    ``map()`` flag (the same on every rank). A ``(row, col)`` tuple
    ``axis_name`` whose column axis has size 1 is the slab. On a pencil
    mesh each decomposed axis is rebalanced against its own histogram,
    psum'd over the whole mesh: the row bounds, the map over the rows,
    then the column bounds (``slab_axis + 1``) and the map over the
    columns; ``col_bounds`` rides in the state."""
    row_axis, col_axis, ndev_c = _axis_names(mesh, axis_name)
    spec = physics(cfg)
    with RT.on_mesh(mesh):
        ndev = RT.axis_size(row_axis)
    col_space_axis = slab_axis + 1
    b_cap = int(bucket_cap or spec.bucket_cap)
    min_w = float(spec.r_cut * 1.001 / max(int(n_hops), 1)
                  if min_slab_width is None else min_slab_width)
    # the histograms psum over the whole mesh (a tuple on a pencil)
    red_axes = (row_axis, col_axis) if ndev_c > 1 else row_axis

    def balanced(ps, axis: int, n: int):
        lo, hi = float(spec.box_lo[axis]), float(spec.box_hi[axis])
        hist = RT.psum(dlb.histogram_cost(ps.x[:, axis],
                                          ps.valid.to(torch.float32), lo,
                                          hi, nbins), red_axes)
        return dlb.enforce_min_width(
            dlb.bounds_from_histogram(hist, n, lo, hi), min_w)

    def local(state: DistributedParticles):
        ps = state.ps
        bounds = balanced(ps, slab_axis, ndev)
        ps, ovf = M.map_particles_local(ps, bounds, row_axis, b_cap,
                                        slab_axis)
        cbounds = state.col_bounds
        if ndev_c > 1:
            cbounds = balanced(ps, col_space_axis, ndev_c)
            ps, ovf_c = M.map_particles_local(ps, cbounds, col_axis, b_cap,
                                              col_space_axis)
            ovf = RT.pmax(torch.maximum(ovf, ovf_c), red_axes)
        return dataclasses.replace(state, ps=ps, bounds=bounds,
                                   col_bounds=cbounds), ovf

    def fn(state: DistributedParticles):
        with RT.on_mesh(mesh):
            return local(state)

    return fn


def distribute(ps0: ParticleSet, physics, cfg, mesh, *,
               axis_name="shards", slab_axis: int = 0,
               cap_per_dev: Optional[int] = None, cap_factor: float = 3.0,
               bounds=None, col_bounds=None,
               fields: Optional[Dict[str, torch.Tensor]] = None
               ) -> DistributedParticles:
    """The host-side 'global map' (paper: distributed read + global map),
    as each rank calls it with the same ``ps0``: every valid particle goes
    to its owner's slot block (rank d owns global slots ``[d·cap, (d+1)
    ·cap)``, as in ``repro``), with the ``id`` prop added; returns THIS
    rank's block, on ``ps0``'s device, with the replicated ``bounds``
    (default: uniform slabs) and this rank's rows of ``fields`` (full mesh
    arrays, leading axis the slab axis). Reads ``ps0`` on the host: a
    set-up function, not for a step.

    A ``(row, col)`` tuple ``axis_name`` is the pencil decomposition
    (DESIGN.md §13): rank (i, j) owns row slab i × the ``slab_axis + 1``
    column slab j, its slot block is the flat index ``i·ncols + j`` (the
    mesh's row-major order, as ``repro``'s ``P((row, col))``), and the
    state carries ``col_bounds`` (default: uniform). Mesh fields on more
    than one column raise, as in ``repro``."""
    from repro_torch import convert
    row_axis, col_axis, ndev_c = _axis_names(mesh, axis_name)
    if ndev_c > 1 and fields:
        raise NotImplementedError(
            "mesh fields on a 2-D device mesh need pencil GridOps (neither "
            "package has them); decompose field-carrying physics as "
            "(ndev, 1) slabs or use apps/vortex.py's pencil VIC step")
    spec = physics(cfg)
    col_space_axis = slab_axis + 1
    with RT.on_mesh(mesh):
        ndev = RT.axis_size(row_axis)
        me = RT.axis_index(row_axis if col_axis is None
                           else (row_axis, col_axis))

    def host(b):
        return np.asarray(b.cpu() if isinstance(b, torch.Tensor) else b,
                          np.float32)

    if bounds is None:
        bounds = dlb.uniform_bounds(ndev, float(spec.box_lo[slab_axis]),
                                    float(spec.box_hi[slab_axis]))
    bounds = host(bounds)
    if col_axis is not None:
        if col_bounds is None:
            col_bounds = dlb.uniform_bounds(
                ndev_c, float(spec.box_lo[col_space_axis]),
                float(spec.box_hi[col_space_axis]))
        col_bounds = host(col_bounds)
    x, valid, props = convert.particles_to_numpy(with_ids(ps0))
    X, V, PR = convert.scatter_to_slabs(x, valid, props, bounds, ndev,
                                        slab_axis=slab_axis,
                                        cap_per_dev=cap_per_dev,
                                        cap_factor=cap_factor,
                                        col_bounds=col_bounds)
    fnp = {k: v.cpu().numpy() for k, v in (fields or {}).items()}
    state = convert.dist_state_from_numpy(X, V, PR, bounds, me,
                                          ndev * ndev_c, fields=fnp,
                                          device=ps0.device)
    if col_axis is None:
        return state
    return dataclasses.replace(state, col_bounds=convert.field_from_numpy(
        col_bounds, ps0.device))
