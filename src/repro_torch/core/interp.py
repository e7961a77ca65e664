"""Moment-conserving particle-mesh / mesh-particle interpolation with the
M'4 kernel (port of the serial part of ``repro.core.interp``; paper §2,
§4.4).

M'4 (Monaghan): W(s) =
    1 - 5/2 s^2 + 3/2 s^3          0 <= s < 1
    1/2 (2 - s)^2 (1 - s)          1 <= s < 2
    0                              s >= 2

Support is 4 nodes per axis. P2M is a scatter-add (``index_add_``) over
the 4^dim stencil; M2P is the corresponding gather. Grids are
node-centered: node i sits at ``lo + i*h`` with h = L/n on periodic axes
and h = L/(n-1) otherwise.

These plain PyTorch versions are the oracles of ``kernels/m4_interp`` and
the ``interp="scatter"`` path of the vortex app. (``repro``'s local-block
legs ``p2m_block``/``m2p_block`` and their pencil forms serve the
distributed VIC step and arrive with it, ROADMAP A14.)
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .particles import const_tensor


def m4_prime(s: torch.Tensor) -> torch.Tensor:
    s = s.abs()
    s2 = s * s
    w_inner = 1.0 - 2.5 * s2 + 1.5 * (s2 * s)
    t = 2.0 - s
    w_outer = 0.5 * (t * t) * (1.0 - s)
    return torch.where(s < 1.0, w_inner,
                       torch.where(s < 2.0, w_outer, torch.zeros_like(s)))


def _stencil_offsets(dim: int) -> np.ndarray:
    rng = [(-1, 0, 1, 2)] * dim
    return np.stack(np.meshgrid(*rng, indexing="ij"), axis=-1).reshape(-1, dim)


def _node_spacing(shape, box_lo, box_hi, periodic):
    """(lo, h) per axis in float64 numpy; callers cast at use."""
    lo = np.asarray(box_lo, np.float64)
    hi = np.asarray(box_hi, np.float64)
    n = np.asarray(shape, np.float64)
    per = np.asarray(periodic, bool)
    h = np.where(per, (hi - lo) / n, (hi - lo) / np.maximum(n - 1, 1))
    return lo, h


def _base_and_frac(x, shape, box_lo, box_hi, periodic):
    lo, h = _node_spacing(shape, box_lo, box_hi, periodic)
    lo_t = const_tensor(tuple(float(v) for v in lo), x.dtype, x.device)
    h_t = const_tensor(tuple(float(v) for v in h), x.dtype, x.device)
    s = (x - lo_t) / h_t
    base = torch.floor(s).to(torch.int32)
    frac = s - base.to(x.dtype)
    return base, frac


def _wrap_index(idx, shape, periodic):
    out = []
    for d, n in enumerate(shape):
        i = idx[..., d]
        if periodic[d]:
            i = torch.remainder(i, n)
        else:
            i = torch.clamp(i, 0, n - 1)
        out.append(i)
    return tuple(out)


def _flat_index(idx: Tuple[torch.Tensor, ...], shape) -> torch.Tensor:
    flat = idx[0].long()
    for d in range(1, len(shape)):
        flat = flat * shape[d] + idx[d].long()
    return flat


def _stencil_weight(frac, off):
    w = torch.ones(frac.shape[0], dtype=frac.dtype, device=frac.device)
    for d in range(frac.shape[1]):
        w = w * m4_prime(frac[:, d] - float(off[d]))
    return w


def p2m(x: torch.Tensor, value: torch.Tensor, valid: torch.Tensor, *,
        shape: Tuple[int, ...], box_lo, box_hi, periodic) -> torch.Tensor:
    """Particle→mesh: scatter ``value`` (N,) or (N, C) onto the grid with
    M'4 weights. Returns a tensor of ``shape`` (+ trailing C)."""
    shape = tuple(int(n) for n in shape)
    dim = len(shape)
    base, frac = _base_and_frac(x, shape, box_lo, box_hi, periodic)
    vec = value.dim() == 2
    n_ch = value.shape[1] if vec else 1
    out = torch.zeros((int(np.prod(shape)), n_ch), dtype=value.dtype,
                      device=value.device)
    vm = valid.to(value.dtype)
    val2 = value if vec else value[:, None]
    for off in _stencil_offsets(dim):
        idx = base + torch.as_tensor(off, dtype=torch.int32,
                                     device=x.device)
        w = (_stencil_weight(frac, off) * vm).to(value.dtype)
        flat = _flat_index(_wrap_index(idx, shape, periodic), shape)
        out.index_add_(0, flat, val2 * w[:, None])
    out = out.reshape(shape + (n_ch,))
    return out if vec else out[..., 0]


def m2p(field: torch.Tensor, x: torch.Tensor, valid: torch.Tensor, *,
        shape: Tuple[int, ...], box_lo, box_hi, periodic) -> torch.Tensor:
    """Mesh→particle: gather the field at particle positions with M'4
    weights. ``field`` has shape ``shape`` (+ trailing C)."""
    shape = tuple(int(n) for n in shape)
    dim = len(shape)
    base, frac = _base_and_frac(x, shape, box_lo, box_hi, periodic)
    vec = field.dim() == dim + 1
    flat_field = field.reshape((int(np.prod(shape)),) + tuple(
        field.shape[dim:]))
    out = torch.zeros(x.shape[:1] + tuple(field.shape[dim:]),
                      dtype=field.dtype, device=field.device)
    for off in _stencil_offsets(dim):
        idx = base + torch.as_tensor(off, dtype=torch.int32,
                                     device=x.device)
        w = _stencil_weight(frac, off).to(field.dtype)
        v = flat_field[_flat_index(_wrap_index(idx, shape, periodic), shape)]
        out = out + v * (w[:, None] if vec else w)
    vm = valid.reshape(valid.shape + (1,) * (out.dim() - 1))
    return torch.where(vm, out, torch.zeros_like(out))
