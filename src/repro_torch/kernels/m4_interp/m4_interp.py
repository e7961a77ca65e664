"""Cell-bucketed M'4 particle–mesh interpolation (port of
``repro.kernels.m4_interp.m4_interp``; paper §2/§4.4, the vortex-in-cell
interpolation and remeshing path).

Particles are pre-bucketed into interpolation cells of ``cb`` mesh nodes
per axis (``ops.bucket_particles``), so every node has one owner:

* **P2M** (:func:`p2m_cells`) — each interpolation cell owns its disjoint
  ``cb^dim`` node patch and gathers every contribution from the 3^dim
  surrounding particle buckets (the M'4 support is 2h and cb >= 2, so
  those buckets hold every particle that can reach the patch). The
  periodic image of a wrapped neighbour bucket is resolved by a per-axis
  shift, -L below the grid and +L above it:
  ``w = mask · Π_d M'4((node_d − x_d − shift_d) / h_d)``. The CUDA
  kernel computes the same sums as a scatter: a block owns a patch of
  cells, streams the particles that reach it and adds their
  contributions in shared memory (any bucket capacity; the fp32 sums in
  an order that varies from run to run).
* **M2P** (:func:`m2p_cells`) — each bucket gathers from the 3^dim
  neighbouring field blocks, with node coordinates formed from the
  *unwrapped* block index ``((cell + off)·cb + i)·h + lo``:
  ``w = mask · Π_d M'4((x_d − node_d) / h_d)``. Several fields ride in
  one channel axis (u and the RHS in one pass). The CUDA kernel is a
  patch gather: a block stages the field nodes that a patch of buckets
  reaches, and each valid particle forms its per-axis weights once and
  sums the nodes of its support in registers (any bucket capacity; a
  fixed summation order).

On CUDA tensors both launch the hand-written kernels of
``csrc/m4_interp.cu``; on CPU tensors they run the plain PyTorch versions
:func:`p2m_cells_torch` / :func:`m2p_cells_torch`, which compute the same
sums with tensor ops, a batch of cells at a time. The kernels are
periodic-only; both forms take ``precision="fp32"`` or ``"bf16x"`` (bf16
weight and value operands, exact fp32 products, fp32 sums), each kernel
with its own C entry. :data:`LAUNCHES` counts kernel launches per kernel
and precision.
"""
from __future__ import annotations

import ctypes
import functools
import itertools
import pathlib

import numpy as np
import torch

from repro_torch.core.interp import m4_prime
from repro_torch.kernels import _build

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "m4_interp.cu"

#: CUDA kernel launches made in this process, per kernel and precision:
#: "p2m" and "m2p" (fp32), "p2m_bf16x" and "m2p_bf16x".
LAUNCHES = {"p2m": 0, "m2p": 0, "p2m_bf16x": 0, "m2p_bf16x": 0}

#: The C entry of each (kernel, precision).
_ENTRIES = {(kind, prec): f"m4_{kind}_{'f32' if prec == 'fp32' else prec}"
            for kind in ("p2m", "m2p") for prec in ("fp32", "bf16x")}

#: Largest channel count and cells per axis the CUDA kernels are built
#: for; both take any bucket capacity.
MAX_CHANNELS = 8
MAX_CB = 8

#: Cells per batch of the plain versions, which bounds their temporaries
#: at the one-card vortex size (500,000 cells).
_CELL_BATCH = 8192


def _offsets(dim: int):
    return list(itertools.product((-1, 0, 1), repeat=dim))


def _geometry(grid_cells, cb, box_lo, box_hi):
    """(shape, lo, h, lengths) as Python floats: ``h = L/n`` in float64,
    used as float32, as the Pallas kernels take them."""
    shape = tuple(cb * g for g in grid_cells)
    lo = tuple(float(v) for v in box_lo)
    lengths = tuple(float(hi) - float(l) for l, hi in zip(box_lo, box_hi))
    h = tuple(L / n for L, n in zip(lengths, shape))
    return shape, lo, h, lengths


def _check_precision(precision: str) -> bool:
    if precision not in ("fp32", "bf16x"):
        raise ValueError(f"precision {precision!r}: want 'fp32' or 'bf16x'")
    return precision == "bf16x"


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """Round to bf16 and back: bf16 operands, exact fp32 products."""
    return t.to(torch.bfloat16).to(torch.float32)


def _cell_coords(idx: torch.Tensor, grid_cells) -> torch.Tensor:
    """(B, dim) int64 coordinates of flat C-order cell ids."""
    out = []
    rem = idx
    for g in reversed(grid_cells):
        out.append(rem % g)
        rem = rem // g
    return torch.stack(out[::-1], dim=-1)


def _flat_wrapped(coords: torch.Tensor, grid_cells) -> torch.Tensor:
    flat = torch.zeros_like(coords[:, 0])
    for d, g in enumerate(grid_cells):
        flat = flat * g + torch.remainder(coords[:, d], g)
    return flat


def _outer(ws, lead):
    """Product over axes of per-axis weights ``ws[d]`` (B, cb, lead...)
    laid out as (B, cb, ..., cb, lead...), axis 0 first."""
    dim = len(ws)
    w = None
    for d, wd in enumerate(ws):
        shape = ((wd.shape[0],) + (1,) * d + (wd.shape[1],)
                 + (1,) * (dim - 1 - d) + tuple(wd.shape[2:]))
        w = wd.reshape(shape) if w is None else w * wd.reshape(shape)
    return w


def _patches_to_field(out, grid_cells, cb, n_ch):
    """(n_cells, cb^dim, C) node patches → the mesh ``shape + (C,)``."""
    dim = len(grid_cells)
    out = out.reshape(tuple(grid_cells) + (cb,) * dim + (n_ch,))
    perm = [p for d in range(dim) for p in (d, dim + d)] + [2 * dim]
    return out.permute(perm).reshape(
        tuple(cb * g for g in grid_cells) + (n_ch,))


def _field_to_patches(field, grid_cells, cb):
    """The mesh ``shape + (C,)`` → (n_cells, cb^dim, C) node blocks."""
    dim = len(grid_cells)
    n_ch = field.shape[-1]
    split = [s for g in grid_cells for s in (g, cb)] + [n_ch]
    perm = [2 * d for d in range(dim)] + [2 * d + 1 for d in range(dim)] \
        + [2 * dim]
    return field.reshape(split).permute(perm).reshape(
        int(np.prod(grid_cells)), cb ** dim, n_ch)


def p2m_cells_torch(cell_x, cell_val, cell_mask, *, grid_cells, cb: int,
                    box_lo, box_hi, precision: str = "fp32") -> torch.Tensor:
    """Plain PyTorch version of the P2M kernel, ``_CELL_BATCH`` owner
    cells at a time.

    cell_x: (n_cells, cc, dim) slot positions, flat C-order cell index;
    cell_val: (n_cells, cc, C); cell_mask: (n_cells, cc) bool.
    Returns the mesh field ``tuple(cb*g for g in grid_cells) + (C,)``,
    fp32."""
    bf16 = _check_precision(precision)
    grid_cells = tuple(int(g) for g in grid_cells)
    dim = len(grid_cells)
    n_cells, cc, _ = cell_x.shape
    n_ch = cell_val.shape[-1]
    dev = cell_x.device
    _, lo, h, lengths = _geometry(grid_cells, cb, box_lo, box_hi)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
    h_t, lo_t, L_t = f32(h), f32(lo), f32(lengths)
    g_t = torch.tensor(grid_cells, device=dev)
    iota = torch.arange(cb, device=dev)
    cx = cell_x.to(torch.float32)
    cv = cell_val.to(torch.float32)
    cm = cell_mask.to(torch.float32)
    out = torch.empty((n_cells, cb ** dim, n_ch), dtype=torch.float32,
                      device=dev)
    for b0 in range(0, n_cells, _CELL_BATCH):
        home = _cell_coords(torch.arange(b0, min(b0 + _CELL_BATCH, n_cells),
                                         device=dev), grid_cells)
        B = home.shape[0]
        # patch node coordinates (B, dim, cb), fixed for every neighbour
        nodes = (home[:, :, None] * cb + iota).to(torch.float32) \
            * h_t[:, None] + lo_t[:, None]
        acc = torch.zeros((B, cb ** dim, n_ch), dtype=torch.float32,
                          device=dev)
        for off in _offsets(dim):
            cell = home + torch.tensor(off, device=dev)
            nb = _flat_wrapped(cell, grid_cells)
            shift = torch.where(cell < 0, -L_t, torch.where(
                cell >= g_t, L_t, torch.zeros_like(L_t)))      # (B, dim)
            xp, vp, mp = cx[nb], cv[nb], cm[nb]
            ws = [m4_prime((nodes[:, d, :, None] - xp[:, None, :, d]
                            - shift[:, d, None, None]) / h_t[d])
                  for d in range(dim)]                         # (B, cb, cc)
            w = mp.reshape((B,) + (1,) * dim + (cc,)) * _outer(ws, ())
            wt = w.reshape(B, cb ** dim, cc)
            if bf16:
                wt, vp = _bf16(wt), _bf16(vp)
            acc += torch.bmm(wt, vp)
        out[b0:b0 + B] = acc
    return _patches_to_field(out, grid_cells, cb, n_ch)


def m2p_cells_torch(field, cell_x, cell_mask, *, grid_cells, cb: int,
                    box_lo, box_hi, precision: str = "fp32") -> torch.Tensor:
    """Plain PyTorch version of the fused M2P kernel, ``_CELL_BATCH``
    buckets at a time. ``field``: mesh ``shape + (C,)``. Returns per-slot
    values (n_cells, cc, C), fp32; masked slots read 0."""
    bf16 = _check_precision(precision)
    grid_cells = tuple(int(g) for g in grid_cells)
    dim = len(grid_cells)
    n_cells, cc, _ = cell_x.shape
    n_ch = field.shape[-1]
    dev = cell_x.device
    shape, lo, h, _ = _geometry(grid_cells, cb, box_lo, box_hi)
    if tuple(field.shape[:-1]) != shape:
        raise ValueError(f"field shape {tuple(field.shape[:-1])} is not "
                         f"{shape} = cb * grid_cells")
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
    h_t, lo_t = f32(h), f32(lo)
    iota = torch.arange(cb, device=dev)
    blocks = _field_to_patches(field.to(torch.float32), grid_cells, cb)
    cx = cell_x.to(torch.float32)
    cm = cell_mask.to(torch.float32)
    out = torch.empty((n_cells, cc, n_ch), dtype=torch.float32, device=dev)
    for b0 in range(0, n_cells, _CELL_BATCH):
        home = _cell_coords(torch.arange(b0, min(b0 + _CELL_BATCH, n_cells),
                                         device=dev), grid_cells)
        B = home.shape[0]
        xp, mp = cx[b0:b0 + B], cm[b0:b0 + B]
        acc = torch.zeros((B, cc, n_ch), dtype=torch.float32, device=dev)
        for off in _offsets(dim):
            cell = home + torch.tensor(off, device=dev)
            fb = blocks[_flat_wrapped(cell, grid_cells)]   # (B, cb^dim, C)
            # unwrapped node coordinates (B, dim, cb) of this block
            nodes = (cell[:, :, None] * cb + iota).to(torch.float32) \
                * h_t[:, None] + lo_t[:, None]
            ws = [m4_prime((xp[:, :, d, None] - nodes[:, d, None, :])
                           / h_t[d]).permute(0, 2, 1)
                  for d in range(dim)]                      # (B, cb, cc)
            w = mp.reshape((B,) + (1,) * dim + (cc,)) * _outer(ws, ())
            wt = w.reshape(B, cb ** dim, cc).transpose(1, 2)
            if bf16:
                wt, fb = _bf16(wt), _bf16(fb)
            acc += torch.bmm(wt, fb)
        out[b0:b0 + B] = acc
    return out


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    geom = [i] * 6 + [f] * 9             # dim, C, grid[3], cb; lo, h, L
    for entry in _ENTRIES.values():
        fn = getattr(lib, entry)
        fn.argtypes = [p, p, p, p, *geom, i, p]
        fn.restype = i
    lib.m4_plan.argtypes = [i] * 7 + [p]
    lib.m4_plan.restype = i
    return lib


def plan(kind: str, grid_cells, cb: int, n_ch: int) -> dict:
    """The launch plan the CUDA kernel ``kind`` ("p2m" or "m2p") takes for
    this geometry: the patch side ``T`` in buckets and the dynamic shared
    memory of a block in bytes (builds the library)."""
    if kind not in ("p2m", "m2p"):
        raise ValueError(f"kind must be 'p2m' or 'm2p', got {kind!r}")
    grid_cells = tuple(int(g) for g in grid_cells)
    out = (ctypes.c_int * 2)()
    g = grid_cells + (1,) * (3 - len(grid_cells))
    _build.check(_lib().m4_plan(int(kind == "m2p"), len(grid_cells), n_ch,
                                *g, cb, out), f"m4_plan({kind})")
    return {"T": out[0], "smem_bytes": out[1]}


def _check_cuda_args(tensors, *, grid_cells, cb, n_ch, cc, precision):
    _check_precision(precision)
    dev = tensors[0][1].device
    for name, t, dtype, shape in tensors:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, not {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want "
                             f"{tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    dim = len(grid_cells)
    if dim not in (2, 3):
        raise ValueError(f"the CUDA M'4 kernels take dim 2 or 3, got {dim}")
    if not 1 <= n_ch <= MAX_CHANNELS:
        raise ValueError(f"{n_ch} channels: the CUDA M'4 kernels take 1 to "
                         f"{MAX_CHANNELS}")
    if not 2 <= cb <= MAX_CB:
        raise ValueError(f"cb={cb}: the CUDA M'4 kernels take 2 to {MAX_CB}")
    if cc < 1:
        raise ValueError(f"cell_cap {cc}: want at least 1")


def _geom_args(grid_cells, cb, box_lo, box_hi, n_ch):
    _, lo, h, lengths = _geometry(grid_cells, cb, box_lo, box_hi)
    pad = lambda t, v: tuple(t) + (v,) * (3 - len(t))
    return (len(grid_cells), n_ch, *pad(grid_cells, 1), cb,
            *pad(lo, 0.0), *pad(h, 1.0), *pad(lengths, 1.0))


def _p2m_cuda(cell_x, cell_val, cell_mask, *, grid_cells, cb, box_lo,
              box_hi, precision):
    n_cells = int(np.prod(grid_cells))
    dim = len(grid_cells)
    cc = cell_x.shape[1]
    n_ch = cell_val.shape[-1]
    _check_cuda_args((("cell_x", cell_x, torch.float32, (n_cells, cc, dim)),
                      ("cell_val", cell_val, torch.float32,
                       (n_cells, cc, n_ch)),
                      ("cell_mask", cell_mask, torch.bool, (n_cells, cc))),
                     grid_cells=grid_cells, cb=cb, n_ch=n_ch, cc=cc,
                     precision=precision)
    shape = tuple(cb * g for g in grid_cells)
    out = torch.empty(shape + (n_ch,), dtype=torch.float32,
                      device=cell_x.device)
    entry = _ENTRIES["p2m", precision]
    with torch.cuda.device(cell_x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(_lib(), entry)(
            cell_x.data_ptr(), cell_val.data_ptr(),
            cell_mask.data_ptr(), out.data_ptr(),
            *_geom_args(grid_cells, cb, box_lo, box_hi, n_ch), cc, stream)
    _build.check(err, entry)
    LAUNCHES["p2m" if precision == "fp32" else "p2m_bf16x"] += 1
    return out


def _m2p_cuda(field, cell_x, cell_mask, *, grid_cells, cb, box_lo, box_hi,
              precision):
    n_cells = int(np.prod(grid_cells))
    dim = len(grid_cells)
    cc = cell_x.shape[1]
    n_ch = field.shape[-1]
    shape = tuple(cb * g for g in grid_cells)
    _check_cuda_args((("cell_x", cell_x, torch.float32, (n_cells, cc, dim)),
                      ("field", field, torch.float32, shape + (n_ch,)),
                      ("cell_mask", cell_mask, torch.bool, (n_cells, cc))),
                     grid_cells=grid_cells, cb=cb, n_ch=n_ch, cc=cc,
                     precision=precision)
    out = torch.empty((n_cells, cc, n_ch), dtype=torch.float32,
                      device=cell_x.device)
    entry = _ENTRIES["m2p", precision]
    with torch.cuda.device(cell_x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(_lib(), entry)(
            field.data_ptr(), cell_x.data_ptr(),
            cell_mask.data_ptr(), out.data_ptr(),
            *_geom_args(grid_cells, cb, box_lo, box_hi, n_ch), cc, stream)
    _build.check(err, entry)
    LAUNCHES["m2p" if precision == "fp32" else "m2p_bf16x"] += 1
    return out


def p2m_cells(cell_x, cell_val, cell_mask, *, grid_cells, cb: int, box_lo,
              box_hi, precision: str = "fp32") -> torch.Tensor:
    """Conflict-free P2M over pre-bucketed particle tiles (``repro``'s
    ``p2m_cells``). CUDA tensors launch the kernel of ``precision`` (or
    raise, never a quiet fallback); CPU tensors run
    :func:`p2m_cells_torch`. Returns the field ``shape + (C,)``."""
    grid_cells = tuple(int(g) for g in grid_cells)
    if cell_x.is_cuda:
        return _p2m_cuda(cell_x, cell_val, cell_mask, grid_cells=grid_cells,
                         cb=cb, box_lo=box_lo, box_hi=box_hi,
                         precision=precision)
    return p2m_cells_torch(cell_x, cell_val, cell_mask,
                           grid_cells=grid_cells, cb=cb, box_lo=box_lo,
                           box_hi=box_hi, precision=precision)


def m2p_cells(field, cell_x, cell_mask, *, grid_cells, cb: int, box_lo,
              box_hi, precision: str = "fp32") -> torch.Tensor:
    """Fused M2P gather over pre-bucketed particle tiles (``repro``'s
    ``m2p_cells``). Dispatch as :func:`p2m_cells`. Returns per-slot values
    (n_cells, cc, C)."""
    grid_cells = tuple(int(g) for g in grid_cells)
    if cell_x.is_cuda:
        return _m2p_cuda(field, cell_x, cell_mask, grid_cells=grid_cells,
                         cb=cb, box_lo=box_lo, box_hi=box_hi,
                         precision=precision)
    return m2p_cells_torch(field, cell_x, cell_mask, grid_cells=grid_cells,
                           cb=cb, box_lo=box_lo, box_hi=box_hi,
                           precision=precision)
