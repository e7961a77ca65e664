"""The distributed runtime of the port (port of ``repro.core.runtime``,
DESIGN.md §2a).

``repro`` runs a distributed step as one program under ``shard_map``; the
port runs it SPMD by process: every rank calls the local function
(``repro``'s ``local_step``) on its own block, and the collectives below
are ``torch.distributed`` calls on the process group of a named mesh
axis. There is no ``shard_map`` counterpart: the per-rank call replaces
it.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` whose
``mesh_dim_names`` are ``repro``'s axis names (``"shards"``). Code inside
a step names axes as ``repro`` does (``axis_name=...``); a name resolves
to the process group of the mesh that :func:`on_mesh` installs (the
per-rank wrappers of the mappings, steps and solvers install theirs on
every call), as a name resolves inside ``repro``'s ``shard_map``.

Rules (as in ``repro``): every collective of the port comes from this
module, never from ``torch.distributed`` directly, anywhere else in the
port. Nothing here reads a device tensor on the host.

  * ``ppermute``   → one ``batch_isend_irecv`` batch; the receiver knows
                     the shape. A pair ``(i, i)`` of the permutation is a
                     local copy, never a message, so the ring of a 1-rank
                     axis (``shift_perms(1)``) moves nothing.
                     :func:`ppermute_many_start` returns a batch in
                     flight (:class:`InFlight`), which the split-phase
                     schedules run work under before they wait.
  * ``all_to_all`` → ``all_to_all_single`` with equal splits (the
                     fixed-capacity buckets of ``map()``, the slab FFT
                     transpose); :func:`all_to_all_many` sends several
                     tensors as one message of bytes.
  * ``psum``/``pmax``/``pmean`` → ``all_reduce`` of small device tensors
                     (``pmean`` is the sum over the axis size); a tuple
                     of axes (the pencil mesh's ``(rows, cols)``)
                     reduces over each axis in turn.
  * ``all_gather`` → ``all_gather_into_tensor`` (gloo takes it too); over
                     a tuple of axes, in row-major rank order.
  * ``broadcast``  → one rank's tensor on every rank of an axis (the
                     meshed fleet server's results).

Messages go as their bytes' dtype where the backends differ: bool as
uint8, complex as its real view.

Accounting (``repro``'s ``launch/hlo_analysis.py`` reads collectives out
of compiled HLO; the port has none): inside :func:`count_collectives`
every collective above appends a :class:`Collective` to the open
:class:`CollectiveLedger`, with its kind spelled as in HLO, its group
size and its result bytes counted from the caller's tensor as HLO counts
them (bool 1 byte, complex64 8). Sizes are host integers from shapes: an
open ledger reads no device tensor and syncs nothing, and with none open
a collective pays one context-variable lookup.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
import os
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

#: The mesh that names resolve against inside :func:`on_mesh`.
_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_mesh", default=None)

#: Default gloo timeout of the groups :func:`make_mesh` creates (seconds).
GLOO_TIMEOUT_S = 60


def _backend(device_type: str) -> str:
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh(device_type='cuda') needs a CUDA card, and "
                "torch.cuda.is_available() is False; pass device_type='cpu' "
                "for gloo ranks on the CPU")
        return "nccl"
    if device_type == "cpu":
        return "gloo"
    raise ValueError(f"unknown device_type {device_type!r}; want 'cuda' or "
                     "'cpu'")


def _init_group(backend: str) -> None:
    """A process group: from torchrun's environment when it is set,
    otherwise a 1-rank group on an in-process HashStore."""
    import datetime
    kw = {}
    if backend == "gloo":
        kw["timeout"] = datetime.timedelta(seconds=GLOO_TIMEOUT_S)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        if backend == "nccl":
            local = int(os.environ.get("LOCAL_RANK", 0))
            torch.cuda.set_device(local)
            kw["device_id"] = torch.device("cuda", local)
        dist.init_process_group(backend, **kw)
        return
    if backend == "nccl":
        torch.cuda.set_device(0)
        kw["device_id"] = torch.device("cuda", 0)
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1, **kw)


def make_mesh(shape: Sequence[int], names: Sequence[str], *,
              device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` with axis ``names``. When no process
    group exists it initialises one: from torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``...) when that is set,
    otherwise at world size 1 from an in-process ``HashStore``.
    ``"cuda"`` means NCCL and raises without a card (no fallback to gloo
    or the CPU); ``"cpu"`` means gloo."""
    from torch.distributed.device_mesh import init_device_mesh
    backend = _backend(device_type)
    shape = tuple(int(s) for s in shape)
    names = tuple(names)
    if not dist.is_initialized():
        _init_group(backend)
    have = dist.get_backend()
    if backend not in str(have):
        raise RuntimeError(
            f"the process group runs {have!r}; a {device_type!r} mesh needs "
            f"{backend!r}")
    if math.prod(shape) != dist.get_world_size():
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} ranks; the "
                         f"process group has {dist.get_world_size()}")
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def device_count() -> int:
    """Ranks of the process group (of torchrun's environment, or 1, when
    none exists yet): the devices a mesh over everything spans."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", 1))


@dataclasses.dataclass(frozen=True)
class DryMesh:
    """A mesh of shapes only: axis names and sizes, no process group.
    Collectives on it are recorded and return tensors of their result's
    shape (:func:`make_dry_mesh`); this rank is index 0 on every axis."""

    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]

    def size(self, dim: Optional[int] = None) -> int:
        return math.prod(self.shape) if dim is None else self.shape[dim]

    def get_local_rank(self, axis_name: str) -> int:
        return 0


def make_dry_mesh(shape: Sequence[int], names: Sequence[str]) -> DryMesh:
    """A :class:`DryMesh` of ``shape`` with axis ``names`` (the dry-run's
    stand-in for a production mesh of 256 or 512 ranks)."""
    shape = tuple(int(s) for s in shape)
    names = tuple(names)
    if len(shape) != len(names):
        raise ValueError(f"mesh shape {shape} and names {names} differ in "
                         "length")
    return DryMesh(shape, names)


def _is_dry(axis_name) -> bool:
    return isinstance(_mesh_of(_names(axis_name)[0]), DryMesh)


@contextlib.contextmanager
def on_mesh(mesh):
    """Resolve axis names against ``mesh`` inside the block (the per-rank
    wrappers of the mappings, steps and solvers enter it on each call)."""
    token = _CURRENT.set(mesh)
    try:
        yield mesh
    finally:
        _CURRENT.reset(token)


def _mesh_of(axis_name: str):
    mesh = _CURRENT.get()
    if mesh is None or axis_name not in (mesh.mesh_dim_names or ()):
        raise RuntimeError(
            f"no mesh with an axis named {axis_name!r} is in scope; call "
            "inside runtime.on_mesh(mesh)")
    return mesh


def _group(axis_name: str):
    mesh = _mesh_of(axis_name)
    if isinstance(mesh, DryMesh):
        raise RuntimeError(f"axis {axis_name!r} is on a shape-only mesh; "
                           "this collective has no dry form")
    return mesh.get_group(axis_name)


# --------------------------------------------------------------------------
# The collective ledger
# --------------------------------------------------------------------------

#: The ledger open in this context (None: nothing is recorded).
_LEDGER: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_ledger", default=None)
#: Whether the collectives issued now sit in a branch picked on the host
#: (:func:`conditional`).
_CONDITIONAL: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_conditional", default=False)

#: The profiler range a split-phase exchange is in flight under, from its
#: start to its wait (only while a ledger is open).
IN_FLIGHT_RANGE = "repro_torch::in_flight"


@dataclasses.dataclass
class Collective:
    """One collective as this rank issued it.

    ``result_bytes`` is the logical payload of the result on this rank,
    counted from the caller's tensor as ``repro``'s HLO counts it (bool
    1 byte, complex64 8), whatever the message carries. ``peer_bytes``
    are the bytes this rank sends to other ranks: a permute's message
    unless its edge is a self-edge (a local copy), ``(g-1)/g`` of an
    all-to-all, ``2 (g-1)/g`` of an all-reduce's message (ring), ``g-1``
    times an all-gather's input, a broadcast root's ``g-1`` copies.
    ``conditional``: issued inside :func:`conditional`. ``batch`` groups
    the permutes one :func:`ppermute_many_start` issued; ``t_start`` /
    ``t_wait`` (``time.perf_counter``) and ``work_start`` / ``work_wait``
    (the ledger's work counters) bracket the time it was in flight (equal
    for a blocking collective)."""

    seq: int
    kind: str                      # HLO spelling
    axis: str
    group_size: int
    result_bytes: int
    peer_bytes: int
    conditional: bool = False
    batch: Optional[int] = None
    t_start: float = 0.0
    t_wait: Optional[float] = None
    work_start: Dict[str, int] = dataclasses.field(default_factory=dict)
    work_wait: Optional[Dict[str, int]] = None


class CollectiveLedger:
    """The collectives issued while it is open (:func:`count_collectives`)
    in ``entries``, in issue order. ``work`` maps a name to a callable
    returning a host int (a launch counter); each entry snapshots them at
    its start and its wait."""

    def __init__(self, work: Optional[Dict[str, Callable[[], int]]] = None):
        self.entries: List[Collective] = []
        self.work = dict(work or {})
        self._batches = 0

    def _snapshot(self) -> Dict[str, int]:
        return {k: int(f()) for k, f in self.work.items()}


@contextlib.contextmanager
def count_collectives(work: Optional[Dict[str, Callable[[], int]]] = None):
    """Open a :class:`CollectiveLedger` for the block: every collective
    issued inside it (on any mesh) is appended to it."""
    led = CollectiveLedger(work)
    token = _LEDGER.set(led)
    try:
        yield led
    finally:
        _LEDGER.reset(token)


@contextlib.contextmanager
def conditional():
    """Mark the collectives issued inside the block as conditional: a
    branch the host picked (the reuse step's rebuild), which ``repro``
    compiles into a ``lax.cond`` branch."""
    token = _CONDITIONAL.set(True)
    try:
        yield
    finally:
        _CONDITIONAL.reset(token)


def _logical_bytes(x: torch.Tensor) -> int:
    """Bytes of ``x`` as HLO counts them: bool 1, complex64 8."""
    return x.numel() * x.element_size()


def _record(led: CollectiveLedger, kind: str, axis: str, group_size: int,
            result_bytes: int, peer_bytes: int,
            batched: bool = False) -> Collective:
    """Append one entry to ``led`` and return it. ``batched``: the entry
    belongs to the ledger's current permute batch."""
    e = Collective(seq=len(led.entries), kind=kind, axis=str(axis),
                   group_size=int(group_size), result_bytes=int(result_bytes),
                   peer_bytes=int(peer_bytes),
                   conditional=_CONDITIONAL.get(),
                   batch=led._batches if batched else None,
                   t_start=time.perf_counter(), work_start=led._snapshot())
    led.entries.append(e)
    return e


def _blocking(led: CollectiveLedger, *args) -> None:
    """Record a collective that returns its result: waited when issued."""
    e = _record(led, *args)
    e.t_wait = e.t_start
    e.work_wait = dict(e.work_start)


# --------------------------------------------------------------------------
# Axis queries: host integers, no device read
# --------------------------------------------------------------------------

def axis_index(axis_name) -> int:
    """This rank's index along the axis; for a tuple of axes, its
    row-major index over their product (``jax.lax.axis_index``)."""
    if isinstance(axis_name, tuple):
        i = 0
        for name in axis_name:
            i = i * axis_size(name) + axis_index(name)
        return i
    return _mesh_of(axis_name).get_local_rank(axis_name)


def axis_size(axis_name) -> int:
    """The axis's size (ranks along it); for a tuple, the product."""
    if isinstance(axis_name, tuple):
        return math.prod(axis_size(name) for name in axis_name)
    mesh = _mesh_of(axis_name)
    return mesh.size(mesh.mesh_dim_names.index(axis_name))


def shift_perms(ndev: int, hop: int = 1):
    """The two ring permutations of a 1-D mesh axis: (right, left) neighbor
    send lists, shared by every slab/ring exchange. ``hop`` generalises to
    the k-hop rings of the multi-hop ghost exchange (DESIGN.md §13)."""
    right = [(i, (i + hop) % ndev) for i in range(ndev)]
    left = [(i, (i - hop) % ndev) for i in range(ndev)]
    return right, left


# --------------------------------------------------------------------------
# Point to point: the ghost and halo shifts
# --------------------------------------------------------------------------

def _wire(x: torch.Tensor) -> torch.Tensor:
    """The tensor a message carries: bool as uint8, complex as its real
    view; contiguous."""
    if x.dtype == torch.bool:
        x = x.to(torch.uint8)
    elif x.is_complex():
        x = torch.view_as_real(x)
    return x.contiguous()


def _unwire(buf: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if like.dtype == torch.bool:
        return buf.to(torch.bool)
    if like.is_complex():
        return torch.view_as_complex(buf)
    return buf


class InFlight:
    """Messages in flight and what their arrival yields: ``wait()`` waits
    for them (on NCCL it makes the current stream wait, without blocking
    the host) and returns ``then(received)``. Objects made by ``then``
    share the messages, and each message is waited for once (a gloo send
    waited for twice blocks until its timeout). Under an open ledger the
    first wait stamps the batch's entries and closes its profiler range
    (:data:`IN_FLIGHT_RANGE`)."""

    def __init__(self, works: List, value, then: Optional[Callable] = None,
                 acct: Optional[List] = None):
        self._works = works
        self._value = value
        self._then = then
        self._acct = [] if acct is None else acct

    def then(self, fn: Callable) -> "InFlight":
        """The same messages, yielding ``fn`` of what this one yields."""
        prev = self._then
        return InFlight(self._works, self._value,
                        fn if prev is None else (lambda v: fn(prev(v))),
                        self._acct)

    def wait(self):
        while self._works:          # the list is shared: empty it in place
            self._works.pop(0).wait()
        if self._acct:              # shared too: stamped once
            led, entries, rf = self._acct.pop(0)
            t, work = time.perf_counter(), led._snapshot()
            for e in entries:
                e.t_wait, e.work_wait = t, work
            rf.__exit__(None, None, None)
        return self._value if self._then is None else self._then(
            self._value)


def wait(x):
    """``x.wait()`` for an :class:`InFlight`, ``x`` itself otherwise."""
    return x.wait() if isinstance(x, InFlight) else x


def ppermute_many_start(sends: Sequence[Tuple[Sequence[torch.Tensor],
                                              Sequence[Tuple[int, int]]]],
                        axis_name: str) -> InFlight:
    """Issue several collective permutes as ONE batch: ``sends`` is a list
    of ``(tensors, perm)``; each tensor goes along its perm as
    :func:`ppermute` would send it. The batch yields the received tensors
    in the same nesting. Every rank issues the messages in the same order
    and each carries its position as its tag, so two messages to one peer
    (the two directions of a 2-rank ring) cannot swap."""
    me = axis_index(axis_name)
    group = _group(axis_name)
    led = _LEDGER.get()
    ops, out, entries = [], [], []
    tag = 0
    for tensors, perm in sends:
        dst = [d for s, d in perm if s == me]
        src = [s for s, d in perm if d == me]
        if len(dst) > 1 or len(src) > 1:
            raise ValueError(f"perm {perm} is not a permutation")
        got = []
        for x in tensors:
            wire = _wire(x)
            if led is not None:
                to_peer = bool(dst) and dst[0] != me
                entries.append(_record(
                    led, "collective-permute", axis_name,
                    axis_size(axis_name), _logical_bytes(x),
                    _logical_bytes(wire) if to_peer else 0, batched=True))
            if dst and dst[0] == me:              # a self-edge: a copy
                got.append(_unwire(wire.clone(), x))
                tag += 1
                continue
            if dst:
                ops.append(dist.P2POp(dist.isend, wire,
                                      dist.get_global_rank(group, dst[0]),
                                      group, tag=tag))
            if src:
                buf = torch.empty_like(wire)
                ops.append(dist.P2POp(dist.irecv, buf,
                                      dist.get_global_rank(group, src[0]),
                                      group, tag=tag))
                got.append((buf, x))
            else:                                 # nothing arrives: zeros
                got.append(torch.zeros_like(x))
            tag += 1
        out.append(got)
    acct = []
    if entries:
        led._batches += 1
        rf = torch.autograd.profiler.record_function(IN_FLIGHT_RANGE)
        rf.__enter__()
        acct.append((led, entries, rf))
    works = dist.batch_isend_irecv(ops) if ops else []

    def unpack(received):
        return [[_unwire(*g) if isinstance(g, tuple) else g for g in row]
                for row in received]

    return InFlight(works, out, unpack, acct)


def ppermute(x: torch.Tensor, axis_name: str, perm) -> torch.Tensor:
    """Collective permute (``jax.lax.ppermute``): rank ``d`` receives what
    ``s`` sent for each ``(s, d)`` in ``perm``, zeros where nothing
    arrives."""
    return ppermute_many_start([([x], perm)], axis_name).wait()[0][0]


# --------------------------------------------------------------------------
# Collectives
# --------------------------------------------------------------------------

def _wants_grad(x) -> bool:
    return (torch.is_grad_enabled() and isinstance(x, torch.Tensor)
            and x.requires_grad)


def _scope():
    """The mesh and ledger in scope, for a backward to run under: the
    autograd engine runs a CUDA backward on its own thread, and any
    backward after the forward's ``on_mesh`` block has closed."""
    return _CURRENT.get(), _LEDGER.get()


@contextlib.contextmanager
def _in_scope(scope):
    mesh, led = scope
    t1 = _CURRENT.set(mesh)
    t2 = _LEDGER.set(_LEDGER.get() or led)
    try:
        yield
    finally:
        _LEDGER.reset(t2)
        _CURRENT.reset(t1)


class _AllToAll(torch.autograd.Function):
    """:func:`all_to_all` with its inverse as the backward."""

    @staticmethod
    def forward(ctx, x, axis_name, split_axis, concat_axis, tiled):
        ctx.args = (axis_name, split_axis, concat_axis, tiled)
        ctx.scope = _scope()
        return _all_to_all(x, axis_name, split_axis, concat_axis, tiled)

    @staticmethod
    def backward(ctx, g):
        axis_name, split_axis, concat_axis, tiled = ctx.args
        with _in_scope(ctx.scope):
            return (_all_to_all(g.contiguous(), axis_name, concat_axis,
                                split_axis, tiled), None, None, None, None)


def all_to_all(x: torch.Tensor, axis_name: str, *, split_axis: int = 0,
               concat_axis: int = 0, tiled: bool = False) -> torch.Tensor:
    """``jax.lax.all_to_all``: split ``x`` along ``split_axis`` into one
    equal chunk per rank, send chunk ``j`` to rank ``j``, and place what
    rank ``i`` sent at position ``i`` along ``concat_axis`` (a new axis
    of size ndev in place of the split one when ``tiled`` is False, and
    then ``split_axis == concat_axis`` and ``x.shape[split_axis] ==
    ndev``). Differentiable: the backward is the inverse exchange."""
    if _wants_grad(x):
        return _AllToAll.apply(x, axis_name, split_axis, concat_axis, tiled)
    return _all_to_all(x, axis_name, split_axis, concat_axis, tiled)


def _all_to_all(x, axis_name, split_axis, concat_axis, tiled):
    ndev = axis_size(axis_name)
    n = x.shape[split_axis]
    if n % ndev:
        raise ValueError(f"axis {split_axis} ({n}) does not split over "
                         f"{ndev} ranks")
    if not tiled and (split_axis != concat_axis or n != ndev):
        raise NotImplementedError(
            "untiled all_to_all takes split_axis == concat_axis over an "
            "axis of size ndev")
    # chunks along a new leading axis, in rank order
    shp = list(x.shape)
    chunked = x.reshape(shp[:split_axis] + [ndev, n // ndev]
                        + shp[split_axis + 1:]).movedim(split_axis, 0)
    wire = _wire(chunked)
    led = _LEDGER.get()
    if led is not None:
        _blocking(led, "all-to-all", axis_name, ndev, _logical_bytes(x),
                  _peer_share(wire, ndev))
    out = torch.empty_like(wire)
    if not _is_dry(axis_name):
        dist.all_to_all_single(out, wire, group=_group(axis_name))
    got = _unwire(out, x)                        # (ndev, ...chunk...)
    if not tiled:
        return got.movedim(0, split_axis).reshape(x.shape)
    # each chunk keeps x's rank (its split axis now n // ndev long); the
    # rank axis becomes the outer part of concat_axis
    got = got.movedim(0, concat_axis)
    shp = list(got.shape)
    shp[concat_axis:concat_axis + 2] = [shp[concat_axis]
                                        * shp[concat_axis + 1]]
    return got.reshape(shp)


def all_to_all_many(xs: Sequence[torch.Tensor],
                    axis_name: str) -> List[torch.Tensor]:
    """The untiled :func:`all_to_all` of several ``(ndev, ...)`` tensors as
    ONE message: each rank's rows are their bytes side by side (any
    dtypes), exchanged once and cut back apart."""
    ndev = axis_size(axis_name)
    for x in xs:
        if x.shape[0] != ndev:
            raise ValueError(f"leading axis {x.shape[0]} is not the axis "
                             f"size {ndev}")
    led = _LEDGER.get()
    if led is not None:          # an entry per tensor, as repro issues them
        for x in xs:
            _blocking(led, "all-to-all", axis_name, ndev, _logical_bytes(x),
                      _peer_share(x, ndev))
    parts = [x.contiguous().view(torch.uint8).reshape(ndev, -1)
             for x in xs]
    wire = torch.cat(parts, 1)
    out = torch.empty_like(wire)
    dist.all_to_all_single(out, wire, group=_group(axis_name))
    got, at = [], 0
    for x, p in zip(xs, parts):
        w = p.shape[1]
        # a fresh copy: at world 1 the (1, w) slice counts as contiguous
        # with its row stride, and a dtype view of it would fail
        got.append(out[:, at:at + w].clone(
            memory_format=torch.contiguous_format).view(x.dtype)
                   .reshape(x.shape))
        at += w
    return got


def _peer_share(x: torch.Tensor, ndev: int) -> int:
    """The bytes of ``x`` an all-to-all sends away: (ndev - 1) / ndev."""
    return x.numel() * x.element_size() * (ndev - 1) // ndev


def _names(axis_name) -> Tuple[str, ...]:
    return axis_name if isinstance(axis_name, tuple) else (axis_name,)


def _reduce(x, axis_name, op) -> torch.Tensor:
    t = torch.as_tensor(x)
    buf = t.to(torch.int32) if t.dtype == torch.bool else t.clone()
    # a tuple of axes reduces over each axis in turn: one all-reduce per
    # axis (repro's HLO has one over the product group)
    led = _LEDGER.get()
    for name in _names(axis_name):
        if led is not None:
            g = axis_size(name)
            _blocking(led, "all-reduce", name, g, _logical_bytes(t),
                      2 * (g - 1) * _logical_bytes(buf) // g)
        if not _is_dry(name):
            dist.all_reduce(buf, op=op, group=_group(name))
    return buf.to(torch.bool) if t.dtype == torch.bool else buf


class _PSum(torch.autograd.Function):
    """:func:`psum` with a ``psum`` of the cotangents as the backward."""

    @staticmethod
    def forward(ctx, x, axis_name):
        ctx.axis_name = axis_name
        ctx.scope = _scope()
        return _reduce(x, axis_name, dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, g):
        with _in_scope(ctx.scope):
            return _reduce(g, ctx.axis_name, dist.ReduceOp.SUM), None


def psum(x, axis_name) -> torch.Tensor:
    """The sum over the axis (a name, or a tuple of names).
    Differentiable: the backward sums the cotangents over the axis."""
    if _wants_grad(x):
        return _PSum.apply(x, axis_name)
    return _reduce(x, axis_name, dist.ReduceOp.SUM)


def pmax(x, axis_name) -> torch.Tensor:
    """The maximum over the axis (no gradient: callers pass detached
    values, as a softmax's shift)."""
    return _reduce(x, axis_name, dist.ReduceOp.MAX)


def pmin(x, axis_name) -> torch.Tensor:
    """The minimum over the axis (``-pmax(-x)``; no gradient)."""
    return -_reduce(-torch.as_tensor(x), axis_name, dist.ReduceOp.MAX)


def pmean(x, axis_name) -> torch.Tensor:
    return psum(x, axis_name) / axis_size(axis_name)


def broadcast(x: torch.Tensor, axis_name: str, src: int) -> torch.Tensor:
    """Rank ``src``'s ``x`` on every rank of the axis (each rank passes a
    tensor of the same shape and dtype; only ``src``'s values count)."""
    wire = _wire(x).clone()
    group = _group(axis_name)
    led = _LEDGER.get()
    if led is not None:
        g = axis_size(axis_name)
        root = axis_index(axis_name) == int(src)
        _blocking(led, "collective-broadcast", axis_name, g,
                  _logical_bytes(x),
                  (g - 1) * _logical_bytes(wire) if root else 0)
    dist.broadcast(wire, src=dist.get_global_rank(group, int(src)),
                   group=group)
    return _unwire(wire, x)


#: ``all_gather_into_tensor`` under its newer name where torch has it
_ALL_GATHER = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


def _gather_stacked(wire: torch.Tensor, axis_name) -> torch.Tensor:
    """Every rank's ``wire`` stacked on a new leading axis, in rank order
    (row-major over a tuple of axes: the last axis gathered first)."""
    led = _LEDGER.get()
    for name in reversed(_names(axis_name)):
        if led is not None:
            g, nbytes = axis_size(name), _logical_bytes(wire)
            _blocking(led, "all-gather", name, g, g * nbytes,
                      (g - 1) * nbytes)
        # the backends take the output as the inputs concatenated on dim 0
        src = wire.reshape((1,) + tuple(wire.shape))
        out = torch.empty((axis_size(name),) + tuple(wire.shape),
                          dtype=wire.dtype, device=wire.device)
        if not _is_dry(name):
            _ALL_GATHER(out, src, group=_group(name))
        wire = out
    n_ax = len(_names(axis_name))
    return wire.reshape((-1,) + tuple(wire.shape[n_ax:]))


class _AllGather(torch.autograd.Function):
    """:func:`all_gather` with :func:`reduce_scatter` as the backward."""

    @staticmethod
    def forward(ctx, x, axis_name, axis, tiled):
        ctx.args = (axis_name, axis, tiled)
        ctx.scope = _scope()
        return _all_gather(x, axis_name, axis, tiled)

    @staticmethod
    def backward(ctx, g):
        axis_name, axis, tiled = ctx.args
        with _in_scope(ctx.scope):
            if not tiled:            # the stacked axis: one slot per rank
                out = reduce_scatter(g.movedim(axis, 0).contiguous(),
                                     axis_name)
                return out[0], None, None, None
            return (reduce_scatter(g.contiguous(), axis_name, axis=axis),
                    None, None, None)


def all_gather(x, axis_name, *, axis: int = 0,
               tiled: bool = False) -> torch.Tensor:
    """``jax.lax.all_gather``: every rank's ``x`` in rank order, stacked on
    a new ``axis`` (``tiled``: concatenated along it). A tuple of axes
    gathers in their row-major rank order. Differentiable: the backward
    is a :func:`reduce_scatter` of the cotangents."""
    if _wants_grad(x):
        return _AllGather.apply(x, axis_name, axis, tiled)
    return _all_gather(x, axis_name, axis, tiled)


def reduce_scatter(x: torch.Tensor, axis_name, *, axis: int = 0
                   ) -> torch.Tensor:
    """The sum over the axis of ``x``, of which this rank keeps its block
    along ``axis`` (``x.shape[axis]`` split in rank order, row-major over
    a tuple of axes): ``jax.lax.psum_scatter(..., tiled=True)``, the
    adjoint of a tiled :func:`all_gather`. NCCL reduces and scatters in
    one call; gloo, which has no such call, all-reduces and slices."""
    names = _names(axis_name)
    n = axis_size(axis_name)
    if x.shape[axis] % n:
        raise ValueError(f"axis {axis} ({x.shape[axis]}) does not split "
                         f"over {n} ranks")
    blk = x.shape[axis] // n
    led = _LEDGER.get()
    if led is not None:
        g = axis_size(axis_name)
        nbytes = _logical_bytes(x) // g
        _blocking(led, "reduce-scatter", "+".join(names), g, nbytes,
                  (g - 1) * nbytes)
    if _is_dry(axis_name):
        return x.narrow(axis, 0, blk).clone()
    if len(names) == 1 and dist.get_backend(_group(names[0])) == "nccl":
        src = x.movedim(axis, 0).contiguous()
        out = torch.empty((blk,) + tuple(src.shape[1:]), dtype=x.dtype,
                          device=x.device)
        dist.reduce_scatter_tensor(out, src, group=_group(names[0]))
        return out.movedim(0, axis)
    buf = x.clone()
    for name in names:
        dist.all_reduce(buf, group=_group(name))
    return buf.narrow(axis, axis_index(axis_name) * blk, blk).clone()


def _all_gather(x, axis_name, axis, tiled):
    t = torch.as_tensor(x)
    wire = _wire(t.movedim(axis, 0) if tiled and t.dim() else t)
    out = _gather_stacked(wire, axis_name)
    got = _unwire(out, t)
    if tiled:
        got = got.reshape((-1,) + tuple(got.shape[2:])).movedim(0, axis)
        return got
    return got.movedim(0, axis)
