"""Cell-pair interaction engine (port of ``repro.kernels.cell_pair``; paper
§2/§4.1).

One engine serves every pairwise workload. PyTorch pre-gathers dense
per-cell candidate tiles (:func:`gather_cell_tiles`), applying the
per-neighbor-cell periodic box shift so the kernel's *direct* displacement
equals the minimum image for any grid size; the hand-written CUDA kernel
``csrc/cell_pair.cu`` sums a pair body over each (cc) x (K·cc) masked
tile (staging only the valid candidates, in fixed-size chunks, with each
functor's per-particle terms formed once per staged candidate); per-slot
sums are scattered back to particles (:func:`scatter_slots`).

:func:`cell_pair` is the tile-level entry. For CUDA tensors it launches the
kernel, or raises if the body cannot run there; for CPU tensors it runs
:func:`cell_pair_torch`, the plain PyTorch version of the same function
(the Pallas ``_pair_kernel`` rule: self-pairs are excluded by ``r2 >
1e-12``). Both take ``precision`` ``"fp32"``, ``"bf16x"`` or
``"bf16x:<names>"``. :data:`LAUNCHES` counts kernel launches. The
launch is the PyTorch operator ``repro_torch::cell_pair``, whose batching
rule lets ``torch.func.vmap`` (the fleet step) fold many members' tiles
into one launch.

The body protocol is that of ``repro_torch.core.interactions``. A body
that carries ``cuda_kind`` (one of the hand-written functors of
``csrc/cell_pair.cu``) and ``cuda_params`` (the functor's float fields,
in its order) runs that functor. Any other body runs a functor generated
from its plain form (:mod:`codegen`: traced at the call's dim, props and
outputs, emitted as C++ against the same engine, ``csrc/
cell_pair_engine.cuh``, and built at its first launch); a body with an op
the generator does not take raises NotImplementedError naming it. Either
way the functor is a :class:`Kind` of the registry :data:`KINDS`. The
kernel takes the props a functor reads as one packed fp32 tensor per
side, in the order its :class:`Kind` lists; under ``bf16x`` it rounds
them to bf16 where it uses them. A functor has any number of radial and
scalar outputs, which the kernel writes packed, ``(N_RADIAL, C, cc,
dim)`` and ``(N_SCALAR, C, cc)``, each kind in ``repro``'s sorted name
order.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib
import sys
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.cell_list import CellList, neighborhood
from repro_torch.core.interactions import (_mask0, cast_bf16, check_out_kind,
                                           parse_precision)
from repro_torch.core.particles import ParticleSet
from repro_torch.kernels import _build
from repro_torch.kernels.cell_pair import codegen

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "cell_pair.cu"

#: Number of CUDA kernel launches made by :func:`cell_pair` in this process.
LAUNCHES = 0


class Kind(NamedTuple):
    """What one CUDA functor computes: a hand-written one of
    ``csrc/cell_pair.cu`` (``gen`` None) or one generated from a body."""

    out: Dict[str, str]           # its outputs, name -> "radial" | "scalar"
    props: Tuple[str, ...]        # the props it reads, in packed order
    vector: Tuple[bool, ...]      # per prop: a (dim,) vector or a scalar
    dims: Tuple[int, ...]         # the DIMs it is built for
    n_params: int                 # its float params (``body.cuda_params``)
    precs: Tuple[str, ...]        # its precisions, as in the C entry names
    gen: Optional[codegen.Generated] = None   # a generated functor's code

    def width(self, dim: int) -> int:
        """Floats per particle in the packed props."""
        return sum(dim if vec else 1 for vec in self.vector)

    def names(self) -> Tuple[List[str], List[str]]:
        """(radial, scalar) output names in the kernel's order: sorted."""
        items = sorted(self.out.items())
        return ([n for n, k in items if k == "radial"],
                [n for n, k in items if k == "scalar"])


#: The CUDA functors: ``cuda_kind`` (or a generated ``gen_<hash>``) ->
#: :class:`Kind`. Vector props pack as their components, scalar props as
#: one float (SPH: v_0 .. v_{d-1}, rho). A precision names its C entry
#: ``cell_pair_<kind>_<prec>_d<dim>``: ``f32``, ``bf16x``, and
#: ``bf16x_<names>`` for ``"bf16x:<names>"``. A generated functor is added
#: at its body's first launch (:func:`_generated_kind`).
KINDS = {
    "lj": Kind({"f": "radial"}, (), (), (2, 3), 2, ("f32", "bf16x")),
    "sph": Kind({"a": "radial", "drho": "scalar"}, ("v", "rho"),
                (True, False), (2, 3), 12,
                ("f32", "bf16x", "bf16x_drho", "bf16x_a")),
    "dem": Kind({"f": "radial"}, ("v",), (True,), (3,), 4, ("f32", "bf16x")),
}


def launch_key(kind: str, prec: str) -> str:
    """The :data:`LAUNCHES_BY_KIND` key of a functor in one precision: the
    kind for fp32 (``"sph"``), else ``<kind>_<prec>`` (``"sph_bf16x"``)."""
    return kind if prec == "f32" else f"{kind}_{prec}"


#: Launches per functor and precision (keys from :func:`launch_key`; a
#: generated functor's are added with it); they add up to
#: :data:`LAUNCHES`.
LAUNCHES_BY_KIND = {launch_key(kind, prec): 0
                    for kind, spec in KINDS.items() for prec in spec.precs}


class CellTiles(NamedTuple):
    """Dense per-cell tiles: the engine's pre-gather product."""

    rows: torch.Tensor       # (n_cells, cc) int32 particle index per slot
    cell_x: torch.Tensor     # (n_cells, cc, dim) home-cell positions
    nbr_x: torch.Tensor      # (n_cells, K*cc, dim) candidates, shift-applied
    cell_mask: torch.Tensor  # (n_cells, cc) bool
    nbr_mask: torch.Tensor   # (n_cells, K*cc) bool
    props_i: Dict[str, torch.Tensor]
    props_j: Dict[str, torch.Tensor]


def gather_cell_tiles(ps: ParticleSet, cl: CellList, prop_names=(),
                      cells=None) -> CellTiles:
    """Dense per-cell tiles from a CellList, candidates in the K order of
    ``neighbor_offsets``. Periodic neighbor cells' positions are shifted by
    the box offset of the image they were reached through, so the direct
    displacement equals the periodic image displacement for any grid size.

    ``cells`` (an int32 tensor) restricts the gathered *home* cells;
    entries ``>= n_cells`` are inactive sentinels whose row slots come out
    masked. Candidates are still indexed from the full cell array, so a
    restricted tile equals the full one of its cell."""
    cap = ps.capacity
    xm = ps.masked_x()
    hood, shifts = neighborhood(cl)         # (n_cells, K), (n_cells, K, dim)
    n_cells, K = hood.shape
    cc = cl.cell_cap
    if cells is None:
        rows = cl.cells[:n_cells]                   # (n_cells, cc)
    else:
        sel = cells.long()
        safe = torch.clamp(sel, max=n_cells - 1)
        rows = cl.cells[safe]
        rows = torch.where((sel < n_cells)[:, None], rows,
                           torch.full_like(rows, cap))
        hood, shifts = hood[safe], shifts[safe]
        n_cells = sel.shape[0]
    cand = cl.cells[hood.long()].reshape(n_cells, K * cc)
    safe_r = rows.clamp(max=cap - 1).long()
    safe_c = cand.clamp(max=cap - 1).long()
    nbr_x = (xm[safe_c].reshape(n_cells, K, cc, ps.dim)
             + shifts[:, :, None, :]).reshape(n_cells, K * cc, ps.dim)
    return CellTiles(
        rows=rows, cell_x=xm[safe_r], nbr_x=nbr_x,
        cell_mask=rows < cap, nbr_mask=cand < cap,
        props_i={k: ps.props[k][safe_r] for k in prop_names},
        props_j={k: ps.props[k][safe_c] for k in prop_names})


def pack_props(props: Dict[str, torch.Tensor], names) -> torch.Tensor:
    """One contiguous fp32 ``(C, n, width)`` tile of the ``(C, n)`` scalar
    and ``(C, n, dim)`` vector prop tiles ``names``, in that order. A
    single vector prop that is already fp32 and contiguous is returned as
    it is. (The props are gathered one by one and packed here, as tiles:
    gathering packed 16-byte SPH rows per particle takes PyTorch's
    ``vectorized_gather_kernel`` path, which is many times slower on the
    H100; PERF.md §6.)"""
    parts = [props[k] if props[k].dim() == 3 else props[k][..., None]
             for k in names]
    if len(parts) == 1:
        return parts[0].to(torch.float32).contiguous()
    return torch.cat([p.to(torch.float32) for p in parts], dim=-1)


def cell_pair_torch(cell_x, nbr_x, cell_mask, nbr_mask, props_i=None,
                    props_j=None, *, body, out, r_cut: float,
                    precision: str = "fp32", cell_batch: int = 256):
    """Plain PyTorch version of the tile kernel, ``cell_batch`` cells at a
    time (a whole 216k-particle tile set is gigabytes per temporary).

    cell_x: (C, cc, dim); nbr_x: (C, Kcc, dim); masks (C, cc)/(C, Kcc);
    props_i/props_j: {name: (C, cc[, dim]) / (C, Kcc[, dim])}. ``out`` maps
    name -> "scalar" | "radial". Returns {name: (C, cc[, dim])} fp32
    per-slot sums. ``ok = mi & mj & r2 < r_cut² & r2 > 1e-12``; masking is
    a select, so FILL candidates never turn into NaN. ``precision`` as in
    ``repro``'s Pallas kernel: bf16 body operands, fp32 geometry and sums."""
    props_i = dict(props_i or {})
    props_j = dict(props_j or {})
    mode, sel = parse_precision(precision, out)
    C, cc, dim = cell_x.shape
    rc2 = r_cut * r_cut
    out_spec = tuple(sorted(out.items()))
    res = {name: torch.empty((C, cc, dim) if kind == "radial" else (C, cc),
                             dtype=torch.float32, device=cell_x.device)
           for name, kind in out_spec}
    use_bf16 = {name: mode == "bf16x" and (sel is None or name in sel)
                for name, _ in out_spec}
    for b0 in range(0, C, cell_batch):
        b = slice(b0, b0 + cell_batch)
        xi, xj = cell_x[b], nbr_x[b]
        mi, mj = cell_mask[b], nbr_mask[b]
        wi = {k: a[b][:, :, None] for k, a in props_i.items()}
        wj = {k: a[b][:, None, :] for k, a in props_j.items()}

        def dx(d):
            return xi[:, :, None, d] - xj[:, None, :, d]

        r2 = dx(0) * dx(0)
        for d in range(1, dim):
            dd = dx(d)
            r2 = r2 + dd * dd
        ok = mi[:, :, None] & mj[:, None, :] & (r2 < rc2) & (r2 > 1e-12)

        def eval_body(bf16: bool):
            """(dx_fn, body values) under one operand precision."""
            if bf16:
                dxb = lambda d: dx(d).to(torch.bfloat16)
                return dxb, body(dxb, r2.to(torch.bfloat16), ok,
                                 cast_bf16(wi), cast_bf16(wj))
            return dx, body(dx, r2, ok, wi, wj)

        evals = {}
        for name, _ in out_spec:
            if use_bf16[name] not in evals:
                evals[use_bf16[name]] = eval_body(use_bf16[name])
        for name, kind in out_spec:
            dx_k, vals = evals[use_bf16[name]]
            v = _mask0(ok, check_out_kind(name, kind, vals[name]))
            if kind == "radial":
                for d in range(dim):
                    res[name][b, :, d] = (v * dx_k(d)).sum(
                        dim=2, dtype=torch.float32)
            else:
                res[name][b] = v.sum(dim=2, dtype=torch.float32)
    return res


def _source(kind: str) -> pathlib.Path:
    """The CUDA source of functor ``kind`` (a generated one's is written
    under ``build/repro_torch/gen/`` first)."""
    gen = KINDS[kind].gen
    return SOURCE if gen is None else codegen.source_path(gen)


@functools.lru_cache(maxsize=None)
def _lib_of(src: pathlib.Path) -> ctypes.CDLL:
    """The library of ``src`` with its entries' C signatures set (built at
    first use; a generated functor's build prints its seconds)."""
    known = src in _build.BUILD_SECONDS
    lib = _build.load(src)
    if not known and src in _build.BUILD_SECONDS and src != SOURCE:
        print(f"repro_torch: built the cell-pair functor {src.name} in "
              f"{_build.BUILD_SECONDS[src]:.1f} s", file=sys.stderr)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for kind, spec in list(KINDS.items()):
        if (SOURCE if spec.gen is None
                else codegen.source_file(spec.gen)) != src:
            continue
        for prec in spec.precs:
            for dim in spec.dims:
                fn = getattr(lib, f"cell_pair_{kind}_{prec}_d{dim}")
                fn.argtypes = [p, p, p, p, p, p, p, p, i, i, i, f, p, p]
                fn.restype = i
                fn = getattr(lib, f"cell_pair_{kind}_{prec}_d{dim}_plan")
                fn.argtypes = [i, p]
                fn.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _lib(kind: str) -> ctypes.CDLL:
    """The library of functor ``kind`` (built at first use; looked up
    once, since a generated kind's source is written on the way)."""
    return _lib_of(_source(kind))


def plan(kind: str, prec: str, dim: int, cc: int) -> dict:
    """The launch plan of functor ``kind`` in precision ``prec`` (as in
    its C entry's name) for cell capacity ``cc``: threads per block,
    candidates per staging tile, rows per chunk and the dynamic shared
    memory of a block in bytes (builds the library)."""
    out = (ctypes.c_int * 4)()
    entry = f"cell_pair_{kind}_{prec}_d{dim}_plan"
    _build.check(getattr(_lib(kind), entry)(cc, out), entry)
    return dict(zip(("threads", "tile", "chunk", "smem_bytes"), out))


def stripes(n_home, threads: int):
    """Stripes per home of a cell with ``n_home`` >= 1 valid home slots in
    a block of ``threads`` lanes (an int, or a tensor of counts): the
    engine's ``stripes``, G = min(32, threads // n_home). Lane t walks
    stripe t % G of home t // G."""
    g = threads // n_home
    return torch.clamp(g, max=32) if torch.is_tensor(g) else min(g, 32)


def _check_tiles(cell_x, nbr_x, cell_mask, nbr_mask):
    C, cc, dim = cell_x.shape
    kcc = nbr_x.shape[1]
    for name, t, dtype, shape in (
            ("cell_x", cell_x, torch.float32, (C, cc, dim)),
            ("nbr_x", nbr_x, torch.float32, (C, kcc, dim)),
            ("cell_mask", cell_mask, torch.bool, (C, cc)),
            ("nbr_mask", nbr_mask, torch.bool, (C, kcc))):
        if t.device != cell_x.device:
            raise ValueError(f"{name} is on {t.device}, cell_x on "
                             f"{cell_x.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want "
                             f"{shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not 0 < cc <= 1024:
        raise ValueError(f"cell_cap {cc} must be in [1, 1024] (one thread "
                         "per home slot)")


def _check_packed(name, t, shape, device):
    if t.device != device or t.dtype != torch.float32 \
            or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous float32 tensor of "
                         f"shape {shape} on {device}; got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def _generated_kind(body, out, dim: int, props) -> Tuple[str, tuple]:
    """(kind, params) of the functor generated from ``body`` for these
    prop tiles ({name: (C, n) or (C, n, dim) tensor}), registered in
    :data:`KINDS` and :data:`LAUNCHES_BY_KIND` at its first use."""
    widths = {}
    for k, t in props.items():
        if not t.is_floating_point():
            raise NotImplementedError(
                f"prop {k!r} is {t.dtype}: a generated functor reads "
                "floating-point props (packed as fp32)")
        if t.dim() == 3 and t.shape[-1] != dim:
            raise NotImplementedError(
                f"prop {k!r} has {t.shape[-1]} components per particle; a "
                f"generated functor reads scalars and ({dim},) vectors")
        widths[k] = t.dim() == 3
    gen = codegen.generate(body, dict(out), dim, widths)
    if gen.kind not in KINDS:
        KINDS[gen.kind] = Kind(dict(gen.out), gen.props, gen.vector,
                               (gen.dim,), len(gen.params), gen.precs, gen)
        for prec in gen.precs:
            LAUNCHES_BY_KIND.setdefault(launch_key(gen.kind, prec), 0)
    return gen.kind, gen.params


def _kind_of(body, out, precision, dim: int,
             props=None) -> Tuple[str, str, tuple]:
    """(functor, precision of its C entry, its float params) for the body
    at ``dim`` with the prop tiles ``props``, checked against ``out`` and
    ``precision``: the body's hand-written functor if it names one
    (``cuda_kind``), else the one generated from it. Raises for anything
    the kernel does not run."""
    kind = getattr(body, "cuda_kind", None)
    mode, sel = parse_precision(precision, out)
    if kind is None:
        kind, params = _generated_kind(body, out, dim, dict(props or {}))
    else:
        if kind not in KINDS:
            raise NotImplementedError(f"unknown cuda_kind {kind!r}")
        params = tuple(float(v) for v in body.cuda_params)
    spec = KINDS[kind]
    if dict(out) != spec.out:
        raise ValueError(f"the {kind} functor has outputs {spec.out}; got "
                         f"out={dict(out)!r}")
    if dim not in spec.dims:
        raise ValueError(f"the {kind} functor is built for dim in "
                         f"{spec.dims}, got {dim}")
    prec = "f32" if mode == "fp32" \
        else "_".join(["bf16x", *sorted(sel or ())])
    if prec not in spec.precs:
        raise NotImplementedError(
            f"precision {precision!r} has no {kind} entry in the CUDA "
            f"cell-pair kernel (it has {spec.precs}; a generated functor "
            f"of more than {codegen.MAX_MIXED_OUTPUTS} outputs takes fp32 "
            "and bf16x); use backend='torch'")
    return kind, prec, params


def _launch(kind, body, cell_x, nbr_x, cell_mask, nbr_mask, packed_i,
            packed_j, r_cut, prec="f32"):
    """Launch hand-written functor ``kind`` in precision ``prec`` (one of
    its :data:`KINDS` precisions) on PyTorch's current stream (no sync)
    with the props already packed; returns {name: (C, cc[, dim])}."""
    return _launch_params(kind, body.cuda_params, cell_x, nbr_x, cell_mask,
                          nbr_mask, packed_i, packed_j, r_cut, prec)


def _launch_packed(kind, params, cell_x, nbr_x, cell_mask, nbr_mask,
                   packed_i, packed_j, r_cut, prec="f32"):
    """One launch of functor ``kind`` with its float params given as they
    are: the packed outputs (radial ``(N_RADIAL, C, cc, dim)`` or None,
    scalar ``(N_SCALAR, C, cc)`` or None)."""
    global LAUNCHES
    spec = KINDS[kind]
    _check_tiles(cell_x, nbr_x, cell_mask, nbr_mask)
    C, cc, dim = cell_x.shape
    kcc = nbr_x.shape[1]
    if dim not in spec.dims:
        raise ValueError(f"the {kind} functor is built for dim in "
                         f"{spec.dims}, got {dim}")
    dev = cell_x.device
    if spec.props:
        width = spec.width(dim)
        _check_packed("props_i", packed_i, (C, cc, width), dev)
        _check_packed("props_j", packed_j, (C, kcc, width), dev)
    params = tuple(float(v) for v in params)
    if len(params) != spec.n_params:
        raise ValueError(f"the {kind} functor takes {spec.n_params} params, "
                         f"the body gives {len(params)}")
    radial_names, scalar_names = spec.names()
    radial = torch.empty((len(radial_names), C, cc, dim), dtype=torch.float32,
                         device=dev) if radial_names else None
    scalar = torch.empty((len(scalar_names), C, cc), dtype=torch.float32,
                         device=dev) if scalar_names else None
    ptr = lambda t: None if t is None else t.data_ptr()
    c_params = (ctypes.c_float * max(len(params), 1))(*params)
    entry = f"cell_pair_{kind}_{prec}_d{dim}"
    lib = _lib(kind)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, entry)(
            cell_x.data_ptr(), nbr_x.data_ptr(), cell_mask.data_ptr(),
            nbr_mask.data_ptr(), ptr(packed_i), ptr(packed_j), ptr(radial),
            ptr(scalar), C, cc, kcc, r_cut * r_cut, c_params, stream)
    _build.check(err, entry)
    LAUNCHES += 1
    LAUNCHES_BY_KIND[launch_key(kind, prec)] += 1
    return radial, scalar


def _split(kind: str, radial, scalar) -> Dict[str, torch.Tensor]:
    """{name: (C, cc[, dim])} of the packed outputs of functor ``kind``."""
    radial_names, scalar_names = KINDS[kind].names()
    res = {n: radial[k] for k, n in enumerate(radial_names)}
    res.update({n: scalar[k] for k, n in enumerate(scalar_names)})
    return res


def _launch_params(kind, params, cell_x, nbr_x, cell_mask, nbr_mask,
                   packed_i, packed_j, r_cut, prec="f32"):
    """:func:`_launch` with the functor's float params given as they are
    (``body.cuda_params``, or a generated functor's)."""
    return _split(kind, *_launch_packed(kind, params, cell_x, nbr_x,
                                        cell_mask, nbr_mask, packed_i,
                                        packed_j, r_cut, prec))


# --------------------------------------------------------------------------
# The launch as a PyTorch operator, so that torch.func.vmap sees it
# --------------------------------------------------------------------------
#
# A ctypes launch is invisible to torch.func.vmap. As the operator
# ``repro_torch::cell_pair`` (CUDA only), the launch has a batching rule:
# under vmap (the fleet step, fleet/batch.py) the members' tiles fold into
# the cell axis, (B, C, ...) -> (B·C, ...), and ONE launch serves all B
# members — the kernel gives each cell its own block and indexes in
# size_t, so the folded launch computes each member's cells exactly as
# its own launch would. The outputs unfold to (B, N·C, cc[, dim]).

#: The folded tiles' elements must stay below 2^31 (the C entry takes the
#: cell count as an int; every index inside is size_t).
_FOLD_LIMIT = 2 ** 31


@torch.library.custom_op("repro_torch::cell_pair", mutates_args=(),
                         device_types="cuda")
def _cell_pair_op(cell_x: torch.Tensor, nbr_x: torch.Tensor,
                  cell_mask: torch.Tensor, nbr_mask: torch.Tensor,
                  packed_i: Optional[torch.Tensor],
                  packed_j: Optional[torch.Tensor], kind: str, prec: str,
                  params: List[float], r_cut: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of functor ``kind``: its (radial, scalar) per-slot sums,
    the outputs of a kind stacked along the cell axis as the kernel writes
    them, ``(N_RADIAL·C, cc, dim)`` and ``(N_SCALAR·C, cc)`` (rows k·C ..
    (k+1)·C - 1 hold output k); a kind the functor lacks is an empty
    tensor."""
    radial, scalar = _launch_packed(kind, params, cell_x, nbr_x, cell_mask,
                                    nbr_mask, packed_i, packed_j, r_cut,
                                    prec)
    empty = cell_x.new_empty((0,))
    return (empty if radial is None else radial.view(-1, *radial.shape[2:]),
            empty if scalar is None else scalar.view(-1, scalar.shape[2]))


def _fold(t, bdim, batch: int):
    """(B, C, ...) with the batch axis ``bdim`` (None: shared by every
    member) as a contiguous (B·C, ...) tensor."""
    if t is None:
        return None
    t = t.expand((batch,) + tuple(t.shape)) if bdim is None \
        else t.movedim(bdim, 0)
    return t.reshape((batch * t.shape[1],) + tuple(t.shape[2:])).contiguous()


@_cell_pair_op.register_vmap
def _cell_pair_vmap(info, in_dims, cell_x, nbr_x, cell_mask, nbr_mask,
                    packed_i, packed_j, kind, prec, params, r_cut):
    """The batching rule: fold, launch once, unfold. ``kind``, ``prec``,
    ``params`` and ``r_cut`` are the same for every member (one ``cfg``
    per fleet). A kind's N outputs come back (N, B, C, ...) and each
    member's (N·C, ...) rows are gathered (a view for N = 1)."""
    B = info.batch_size
    tiles = [_fold(t, d, B) for t, d in zip(
        (cell_x, nbr_x, cell_mask, nbr_mask, packed_i, packed_j),
        in_dims[:6])]
    if tiles[1].numel() >= _FOLD_LIMIT:
        raise ValueError(
            f"the folded candidate tiles of {B} members hold "
            f"{tiles[1].numel()} elements, above the kernel's 2^31")
    outs = _cell_pair_op(*tiles, kind, prec, params, r_cut)
    res, dims = [], []
    for t, names in zip(outs, KINDS[kind].names()):
        if t.numel():
            n = len(names)
            t = t.view((n, B, -1) + tuple(t.shape[1:])).transpose(0, 1)
            res.append(t.reshape((B, -1) + tuple(t.shape[3:])))
            dims.append(0)
        else:
            res.append(t)
            dims.append(None)
    return tuple(res), tuple(dims)


def _cell_pair_cuda(cell_x, nbr_x, cell_mask, nbr_mask, props_i, props_j,
                    *, body, out, r_cut, precision):
    """Pack the tile props in the functor's order and launch it through
    ``repro_torch::cell_pair``."""
    kind, prec, params = _kind_of(body, out, precision, cell_x.shape[-1],
                                  props_i)
    spec = KINDS[kind]
    names = spec.props
    if spec.gen is None and (sorted(props_i) != sorted(names)
                             or sorted(props_j) != sorted(names)):
        raise ValueError(f"the {kind} functor reads props {names}; got "
                         f"{sorted(props_i)} / {sorted(props_j)}")
    missing = [k for k in names if k not in props_i or k not in props_j]
    if missing:
        raise ValueError(f"the {kind} functor reads props {missing}, which "
                         "the tiles do not carry")
    packed_i = pack_props(props_i, names) if names else None
    packed_j = pack_props(props_j, names) if names else None
    radial, scalar = _cell_pair_op(
        cell_x, nbr_x, cell_mask, nbr_mask, packed_i, packed_j, kind, prec,
        [float(v) for v in params], float(r_cut))
    C = cell_x.shape[0]
    radial_names, scalar_names = spec.names()
    if radial_names:
        radial = radial.view((len(radial_names), C) + tuple(radial.shape[1:]))
    if scalar_names:
        scalar = scalar.view((len(scalar_names), C) + tuple(scalar.shape[1:]))
    return _split(kind, radial, scalar)


def cell_pair(cell_x, nbr_x, cell_mask, nbr_mask, props_i=None,
              props_j=None, *, body, out, r_cut: float,
              precision: str = "fp32"):
    """Tile-level engine entry (``repro``'s ``cell_pair_pallas``). CUDA
    tensors launch the kernel: the body's hand-written functor
    (``cuda_kind``) or the one generated from it (NotImplementedError for
    a body with an op the generator does not take, or a precision without
    an entry — never a quiet fallback); CPU tensors run
    :func:`cell_pair_torch`. Returns {name: (C, cc[, dim])}."""
    if cell_x.is_cuda:
        return _cell_pair_cuda(cell_x, nbr_x, cell_mask, nbr_mask,
                               dict(props_i or {}), dict(props_j or {}),
                               body=body, out=out, r_cut=r_cut,
                               precision=precision)
    return cell_pair_torch(cell_x, nbr_x, cell_mask, nbr_mask, props_i,
                           props_j, body=body, out=out, r_cut=r_cut,
                           precision=precision)

#: Dump rows past ``cap`` that :func:`scatter_slots` spreads sentinel slots
#: over. One dump row would take every sentinel's atomic add at a single
#: address (about 368k of them at the 216k MD size, 0.69 ms on the H100).
_DUMP_ROWS = 1024


def scatter_slots(rows: torch.Tensor, val: torch.Tensor,
                  cap: int) -> torch.Tensor:
    """Slot→particle scatter-back: (n_cells, cc, ...) per-slot sums into a
    (cap, ...) per-particle array. Sentinel rows (``cap``) land on dump
    rows past ``cap`` that are dropped, spread over :data:`_DUMP_ROWS`
    rows; a valid particle's sum is the same either way."""
    flat_rows = rows.reshape(-1).long()
    flat = val.reshape((flat_rows.shape[0],) + tuple(val.shape[2:]))
    spread = cap + torch.arange(flat_rows.shape[0], device=flat.device) \
        % _DUMP_ROWS
    dest = torch.where(flat_rows < cap, flat_rows, spread)
    # out-of-place (the fleet step runs this under torch.func.vmap)
    buf = torch.zeros((cap + _DUMP_ROWS,) + tuple(flat.shape[1:]),
                      dtype=flat.dtype, device=flat.device
                      ).index_add(0, dest, flat)
    return buf[:cap]


def apply_kernel_cuda(ps: ParticleSet, cl: CellList, body, *, out,
                      r_cut: float, prop_names=(), precision: str = "fp32",
                      cells=None):
    """End-to-end kernel path: gather → CUDA kernel → scatter (use
    ``apply_pair_kernel(..., backend="cuda")``). ``cells`` restricts the
    launch to those home cells' tiles (``gather_cell_tiles``), and the
    scatter writes only their slots. Raises RuntimeError on CPU
    tensors."""
    if not ps.x.is_cuda:
        raise RuntimeError(
            f"backend='cuda' needs CUDA tensors; the particles are on "
            f"{ps.device} (use backend='auto' or 'torch' on the CPU)")
    t = gather_cell_tiles(ps, cl, prop_names, cells=cells)
    res = cell_pair(t.cell_x, t.nbr_x, t.cell_mask, t.nbr_mask, t.props_i,
                    t.props_j, body=body, out=out, r_cut=r_cut,
                    precision=precision)
    cap = ps.capacity
    return {name: _mask0(ps.valid, scatter_slots(t.rows, v, cap))
            for name, v in res.items()}
