"""Pairwise particle interaction engine (port of ``repro.core.interactions``;
``applyKernel_in``, paper Listing 4.1 lines 50-51).

Two execution paths over the same dense cell tiles:

  * :func:`apply_kernel_cells` — plain PyTorch: for each cell, its
    ≤cell_cap particles against the 3^dim-neighborhood candidates as one
    masked tile, streamed over batches of cells so peak memory stays
    bounded. The oracle path, and the one the CPU runs.
  * ``backend="cuda"`` (via :func:`apply_pair_kernel`) — the hand-written
    cell-pair kernel (``kernels/cell_pair``) on CUDA tensors.

Interaction kernels are ``kernel(dx, r2, wi, wj) -> value`` with
``dx = x_i - x_j``. Workloads write the physics once as a *pair body*:

    body(dx, r2, ok, wi, wj) -> {name: per-pair value}

      dx(d)  -> displacement component d of x_i - x_j (callable)
      r2     -> squared pair distance
      ok     -> pair validity (cutoff + slot masks + self-exclusion)
      wi[k]  -> i-side property; wj[k] -> j-side property
      value  -> per-pair scalar (summed over j) or :class:`Radial` (the
                engine emits ``Σ_j mag · dx`` — forces, accelerations)

A body that the CUDA kernel can run also carries ``cuda_kind`` (the
functor it maps to) and ``cuda_params``; see ``apps.md.lj_pair_body``.

The Verlet-list paths (:func:`apply_kernel_verlet`, the symmetric
half-list :func:`apply_kernel_verlet_sym`) evaluate a kernel over a
``cell_list.VerletList`` in plain PyTorch, as ``repro`` evaluates them in
jnp.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from .cell_list import CellList, VerletList, _min_image, neighborhood
from .particles import ParticleSet

KernelFn = Callable[..., Any]


@dataclasses.dataclass(frozen=True)
class Radial:
    """Marker for a radially-directed per-pair value: the contribution of
    pair (i, j) is ``mag * (x_i - x_j)``."""

    mag: Any


def check_out_kind(name: str, kind: str, value):
    """Validate a body's returned value against its declared ``out`` kind.
    Returns the magnitude for radial outputs, the value itself for scalar
    ones."""
    if kind == "radial":
        if not isinstance(value, Radial):
            raise TypeError(
                f"pair-body output {name!r} is declared 'radial' but the "
                f"body returned a bare value; wrap it in Radial(mag)")
        return value.mag
    if isinstance(value, Radial):
        raise TypeError(
            f"pair-body output {name!r} is declared {kind!r} but the body "
            f"returned Radial; declare it 'radial' or return the array")
    return value


def cast_bf16(w):
    """bf16x operand cast: floating-point properties to bfloat16, integer
    properties (ids, kinds) untouched."""
    return {k: a.to(torch.bfloat16) if a.is_floating_point() else a
            for k, a in w.items()}


def weak(value: float, like: torch.Tensor):
    """A Python number as an operand of an op on ``like``, taken as JAX's
    weak typing takes it in ``repro``'s bodies: unchanged beside an fp32
    tensor, and beside a bf16 one a 0-d bf16 tensor on like's device, so
    the number is rounded to bf16 before the op on the CPU and on the card
    alike. (PyTorch alone keeps a Python scalar at fp32 in a bf16 op,
    except in an add or subtract on the CPU.)"""
    if like.dtype != torch.bfloat16:
        return value
    return torch.full((), value, dtype=like.dtype, device=like.device)


def div_scalar(t: torch.Tensor, value: float):
    """``t / value`` for a Python number, as the bodies take it. fp32: the
    product with the reciprocal, which is what PyTorch's card kernel makes
    of a division by a Python scalar, so the CPU and the card round alike.
    bf16: the true division by the number rounded to bf16, as ``repro``
    runs it (a 0-d tensor on t's device, so the card divides too)."""
    if t.dtype != torch.bfloat16:
        return t * (1.0 / value)
    return t / weak(value, t)


def parse_precision(precision: str, out):
    """Parse a pair-engine precision mode: ``"fp32"`` | ``"bf16x"`` (all
    outputs) or ``"bf16x:<name>[,<name>...]"`` (only the listed outputs
    get bf16 operands). Returns ``(mode, selection)`` where selection is a
    frozenset of output names or None (all outputs)."""
    mode, _, names = precision.partition(":")
    if mode not in ("fp32", "bf16x"):
        raise ValueError(f"unknown precision {precision!r}; want 'fp32', "
                         "'bf16x', or 'bf16x:<out,...>'")
    if not names:
        return mode, None
    if mode != "bf16x":
        raise ValueError(f"precision {precision!r}: per-output selection "
                         "only applies to 'bf16x'")
    sel = frozenset(names.split(","))
    unknown = sel - set(out)
    if unknown:
        raise ValueError(
            f"precision {precision!r} selects unknown pair outputs "
            f"{sorted(unknown)}; declared outputs are {sorted(out)}")
    if sel >= set(out):
        return mode, None      # every output selected == pure bf16x
    return mode, sel


def as_torch_kernel(body, out, r_cut: float,
                    precision: str = "fp32") -> KernelFn:
    """Adapt a pair *body* into a ``kernel(dx, r2, wi, wj)`` for
    :func:`apply_kernel_cells`. ``out`` maps result name -> "scalar" |
    "radial"; ``r_cut`` rebuilds the engine's cutoff mask so the body sees
    the same ``ok``. ``precision="bf16x"``: geometry stays fp32, the body
    sees bf16 operands, per-pair values are cast to fp32 before the sum."""
    mode, sel = parse_precision(precision, out)
    rc2 = r_cut * r_cut

    def kernel(dx_arr, r2, wi, wj):
        ok = (r2 < rc2) & (r2 > 1e-12)

        def eval_all(bf16: bool):
            if bf16:
                dxa = dx_arr.to(torch.bfloat16)
                r2a = r2.to(torch.bfloat16)
                wia, wja = cast_bf16(wi), cast_bf16(wj)
            else:
                dxa, r2a, wia, wja = dx_arr, r2, wi, wj
            dx = lambda d: dxa[..., d]
            vals = body(dx, r2a, ok, wia, wja)
            res = {}
            for name, kind in sorted(out.items()):
                v = check_out_kind(name, kind, vals[name])
                v = torch.where(ok, v, torch.zeros_like(v))
                if kind == "radial":
                    v = v[..., None] * dxa
                res[name] = v.to(torch.float32)
            return res

        if sel is None:
            return eval_all(mode == "bf16x")
        bf, fp = eval_all(True), eval_all(False)
        return {name: bf[name] if name in sel else fp[name] for name in fp}

    return kernel


def apply_pair_kernel(ps: ParticleSet, cl: CellList, body, *, out,
                      r_cut: float, prop_names=(), backend: str = "auto",
                      cell_batch: int = 256, precision: str = "fp32"):
    """Uniform front door over the cell-blocked execution paths.

    ``backend="auto"`` launches the CUDA kernel for CUDA tensors and runs
    the plain PyTorch path for CPU tensors; ``"torch"`` forces the plain
    path (:func:`apply_kernel_cells`); ``"cuda"`` forces the kernel and
    raises on CPU tensors. Returns {name: (cap, ...) per-particle sums}.
    (``repro``'s ``cells`` restriction serves split-phase overlap stepping
    and arrives with it, ROADMAP A14.)
    """
    if backend == "auto":
        backend = "cuda" if ps.x.is_cuda else "torch"
    if backend == "torch":
        kern = as_torch_kernel(body, out, r_cut, precision=precision)
        return apply_kernel_cells(ps, cl, kern, r_cut=r_cut,
                                  prop_names=prop_names,
                                  cell_batch=cell_batch)
    if backend == "cuda":
        # deferred import: core stays importable without kernels/
        from repro_torch.kernels.cell_pair.cell_pair import apply_kernel_cuda
        return apply_kernel_cuda(ps, cl, body, out=out, r_cut=r_cut,
                                 prop_names=prop_names, precision=precision)
    raise ValueError(
        f"unknown backend {backend!r}; want 'auto', 'torch' or 'cuda'")


def _bmask(mask: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Broadcast a leading-dims mask against v's trailing dims."""
    return mask.reshape(mask.shape + (1,) * (v.dim() - mask.dim()))


def _mask0(mask: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``v`` where ``mask``, else 0 — a select, never a product, so a
    masked inf or NaN does not leak into the result."""
    return torch.where(_bmask(mask, v), v, torch.zeros_like(v))


def _gather_props(props, idx, cap):
    safe = idx.clamp(max=cap - 1).long()
    return {k: a[safe] for k, a in props.items()}


def _tree_map(fn, val):
    """``fn`` over a kernel result: a tensor or a dict of tensors."""
    if isinstance(val, dict):
        return {k: fn(v) for k, v in val.items()}
    return fn(val)


def apply_kernel_verlet(ps: ParticleSet, vl: VerletList, cl: CellList,
                        kernel: KernelFn, prop_names=(),
                        batch_size: int = 2048):
    """result_i = sum_j kernel(x_i - x_j, r2, w_i, w_j) over Verlet
    neighbors, ``batch_size`` particles at a time (``repro``'s
    ``lax.map(batch_size=...)``). ``kernel`` sees (B, k_max, ...) pair
    arrays, with ``w_i`` broadcast over the neighbor axis."""
    cap = ps.capacity
    dev = ps.device
    xm = ps.masked_x()
    props = {k: ps.props[k] for k in prop_names}
    parts = []
    for b0 in range(0, cap, batch_size):
        i = torch.arange(b0, min(b0 + batch_size, cap), device=dev)
        nbr = vl.nbr[i]                                  # (B, k_max)
        ok = nbr < cap
        xj = xm[nbr.clamp(max=cap - 1).long()]
        dx = _min_image(xm[i][:, None, :] - xj, cl)
        r2 = (dx * dx).sum(-1)
        wi = {k: a[i][:, None] for k, a in props.items()}
        wj = _gather_props(props, nbr, cap)
        val = kernel(dx, r2, wi, wj)                     # (B, k_max, ...)
        parts.append(_tree_map(lambda v: _mask0(ok, v).sum(dim=1), val))
    if isinstance(parts[0], dict):
        out = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
    else:
        out = torch.cat(parts)
    return _tree_map(lambda v: _mask0(ps.valid, v), out)


def apply_kernel_verlet_sym(ps: ParticleSet, vl: VerletList, cl: CellList,
                            kernel: KernelFn, prop_names=(),
                            antisymmetric: bool = True):
    """Symmetric half-list evaluation: pairs (i, j>i) computed once; the
    reverse contribution is scattered to j (sign-flipped if
    ``antisymmetric``, e.g. forces; plain for symmetric scalars like SPH
    density). The ghost_put(sum)-style path of ``repro``."""
    cap, k_max = vl.nbr.shape
    dev = ps.device
    xm = ps.masked_x()
    props = {k: ps.props[k] for k in prop_names}
    i_idx = torch.arange(cap, device=dev).repeat_interleave(k_max)
    j_idx = vl.nbr.reshape(-1).long()
    ok = j_idx < cap
    j_safe = j_idx.clamp(max=cap - 1)
    dx = _min_image(xm[i_idx] - xm[j_safe], cl)
    r2 = (dx * dx).sum(-1)
    wi = _gather_props(props, i_idx, cap)
    wj = _gather_props(props, j_safe, cap)
    val = _tree_map(lambda v: _mask0(ok, v), kernel(dx, r2, wi, wj))
    sign = -1.0 if antisymmetric else 1.0
    j_dest = torch.where(ok, j_idx, torch.full_like(j_idx, cap))

    def reduce(v):
        zeros = lambda n: torch.zeros((n,) + tuple(v.shape[1:]),
                                      dtype=v.dtype, device=dev)
        fwd = zeros(cap).index_add_(0, i_idx, v)
        rev = zeros(cap + 1).index_add_(0, j_dest, sign * v)[:cap]
        return fwd + rev

    return _tree_map(lambda v: _mask0(ps.valid, v), _tree_map(reduce, val))


def apply_kernel_cells(ps: ParticleSet, cl: CellList, kernel: KernelFn,
                       r_cut: float, prop_names=(), cell_batch: int = 256):
    """Cell-blocked dense-tile evaluation in plain PyTorch. For each cell:
    a (cell_cap) x (3^dim * cell_cap) masked pair tile, with each neighbor
    cell's positions shifted by its box offset (exact for any grid size).
    Cells are processed ``cell_batch`` at a time (``repro``'s
    ``lax.map(batch_size=cell_batch)``). Self-pairs are excluded by slot
    identity, as in ``repro``. Returns per-particle sums.
    """
    cap = ps.capacity
    dev = ps.device
    cell_cap = cl.cell_cap
    hood, shifts = neighborhood(cl)         # (n_cells, K), (n_cells, K, dim)
    n_cells, K = hood.shape
    xm = ps.masked_x()
    props = {k: ps.props[k] for k in prop_names}
    rc2 = r_cut * r_cut
    slot_rows, slot_sums = [], {}
    for b0 in range(0, n_cells, cell_batch):
        c = torch.arange(b0, min(b0 + cell_batch, n_cells), device=dev)
        rows = cl.cells[c]                               # (B, cc)
        cand2 = cl.cells[hood[c].long()]                 # (B, K, cc)
        B = c.shape[0]
        cand = cand2.reshape(B, K * cell_cap)
        row_ok = rows < cap
        cand_ok = cand < cap
        safe_r = rows.clamp(max=cap - 1).long()
        safe_c = cand.clamp(max=cap - 1).long()
        xi = xm[safe_r]                                  # (B, cc, dim)
        xj = (xm[safe_c].reshape(B, K, cell_cap, -1)
              + shifts[c][:, :, None, :]).reshape(B, K * cell_cap, -1)
        dx = xi[:, :, None, :] - xj[:, None, :, :]       # (B, cc, Kcc, dim)
        r2 = dx[..., 0] * dx[..., 0]
        for d in range(1, dx.shape[-1]):
            r2 = r2 + dx[..., d] * dx[..., d]
        pair_ok = (row_ok[:, :, None] & cand_ok[:, None, :]
                   & (rows[:, :, None] != cand[:, None, :]) & (r2 < rc2))
        wi = {k: a[safe_r][:, :, None] for k, a in props.items()}
        wj = {k: a[safe_c][:, None, :] for k, a in props.items()}
        val = kernel(dx, r2, wi, wj)                     # (B, cc, Kcc, ...)
        if not isinstance(val, dict):
            val = {None: val}
        slot_rows.append(rows.reshape(-1).long())
        for name, v in val.items():
            s = _mask0(pair_ok, v).sum(dim=2)            # (B, cc, ...)
            slot_sums.setdefault(name, []).append(
                _mask0(row_ok, s).reshape((-1,) + tuple(s.shape[2:])))
    # slot -> particle in one out-of-place index_add (the fleet step runs
    # this under vmap): a particle fills one slot, so its row takes one
    # addition onto zero; sentinel slots land on the dropped row ``cap``
    dest = torch.cat(slot_rows)
    out = {}
    for name, parts in slot_sums.items():
        flat = torch.cat(parts)
        s = torch.zeros((cap + 1,) + tuple(flat.shape[1:]), dtype=flat.dtype,
                        device=dev).index_add(0, dest, flat)
        out[name] = _mask0(ps.valid, s[:cap])
    return out[None] if list(out) == [None] else out
