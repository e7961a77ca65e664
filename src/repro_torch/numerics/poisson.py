"""Poisson solves on a periodic box (port of the serial part of
``repro.numerics.poisson``; the PetSc replacement of paper §4.4).

The vortex-in-cell step solves ∆ψ = -ω on a periodic Cartesian mesh with
:func:`fft_poisson`: ``torch.fft.fftn``/``ifftn`` in complex64, as the JAX
package leaves them to XLA's FFT outside any Pallas kernel.
:func:`multigrid_poisson` is the geometric V-cycle alternative (damped
Jacobi smoothing of the 2·dim+1-point Laplacian), with
:func:`residual_norm`. The slab and pencil solvers are the multi-device
layer, ROADMAP A14.
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


def _k2_axes(shape, lengths, discrete: bool):
    """Per-axis 1-D eigenvalue vectors of the (continuous or discrete)
    Laplacian on a periodic box; the full operator is their broadcast
    sum."""
    ks = []
    for n, L in zip(shape, lengths):
        h = L / n
        k = 2 * np.pi * np.fft.fftfreq(n, d=h)
        if discrete:
            # eigenvalue of the 3-point stencil: (2 cos(kh) - 2)/h^2
            lam = (2.0 * np.cos(k * h) - 2.0) / h**2
        else:
            lam = -k**2
        ks.append(lam)
    return ks


def _k2_np(shape, lengths, discrete: bool) -> np.ndarray:
    grids = np.meshgrid(*_k2_axes(shape, lengths, discrete), indexing="ij")
    return sum(grids)


@functools.lru_cache(maxsize=8)
def _k2(shape, lengths, discrete: bool, dtype: torch.dtype,
        device: torch.device) -> torch.Tensor:
    """Eigenvalues of the Laplacian on a periodic box, kept on ``device``
    per geometry (an eager step must not rebuild them on the host)."""
    return torch.from_numpy(_k2_np(shape, lengths, discrete)).to(
        dtype).to(device)


def fft_poisson(rhs: torch.Tensor, lengths: Tuple[float, ...],
                discrete: bool = True) -> torch.Tensor:
    """Solve ∆u = rhs with periodic BCs; zero-mean gauge. ``rhs`` may have a
    trailing component axis (vector Poisson, solved per component)."""
    lengths = tuple(float(v) for v in lengths)
    dim = len(lengths)
    vec = rhs.dim() == dim + 1
    axes = tuple(range(dim))
    lam = _k2(tuple(rhs.shape[:dim]), lengths, discrete,
              torch.float64 if rhs.dtype == torch.float64 else torch.float32,
              rhs.device)
    if vec:
        lam = lam[..., None]
    rh = torch.fft.fftn(rhs.to(torch.complex64), dim=axes)
    zero = lam == 0
    uh = torch.where(zero, torch.zeros_like(rh),
                     rh / torch.where(zero, torch.ones_like(lam), lam))
    del rh
    return torch.fft.ifftn(uh, dim=axes).real.to(rhs.dtype)


# --------------------------------------------------------------------------
# Geometric multigrid
# --------------------------------------------------------------------------

def _laplacian(u, h2s):
    out = torch.zeros_like(u)
    for d, h2 in enumerate(h2s):
        out = out + (torch.roll(u, 1, d) + torch.roll(u, -1, d)
                     - 2.0 * u) / h2
    return out


def _jacobi(u, rhs, h2s, n_iter, omega=0.8):
    diag = sum(-2.0 / h2 for h2 in h2s)
    for _ in range(n_iter):
        r = rhs - _laplacian(u, h2s)
        u = u + omega * r / diag
    return u


def _restrict(r, dim):
    # full-weighting by averaging 2^dim children
    for d in range(dim):
        r = torch.movedim(r, d, 0)
        r = 0.5 * (r[0::2] + r[1::2])
        r = torch.movedim(r, 0, d)
    return r


def _prolong(e, dim):
    for d in range(dim):
        e = torch.repeat_interleave(e, 2, dim=d)
    return e


def _vcycle(u, rhs, lengths, level, n_smooth=3):
    dim = len(lengths)
    shape = rhs.shape[:dim]
    h2s = tuple((L / n) ** 2 for L, n in zip(lengths, shape))
    u = _jacobi(u, rhs, h2s, n_smooth)
    if level > 0 and min(shape) >= 4:
        r = rhs - _laplacian(u, h2s)
        r2 = _restrict(r, dim)
        e2 = _vcycle(torch.zeros_like(r2), r2, lengths, level - 1, n_smooth)
        u = u + _prolong(e2, dim)
    u = _jacobi(u, rhs, h2s, n_smooth)
    return u


def multigrid_poisson(rhs: torch.Tensor, lengths: Tuple[float, ...],
                      cycles: int = 8, n_smooth: int = 3) -> torch.Tensor:
    """Periodic V-cycle multigrid for ∆u = rhs (zero-mean gauge). ``rhs``
    may have a trailing component axis (solved per component)."""
    lengths = tuple(float(v) for v in lengths)
    dim = len(lengths)
    vec = rhs.dim() == dim + 1

    def solve_scalar(r):
        r = r - r.mean()
        levels = int(np.log2(min(r.shape))) - 1
        u = torch.zeros_like(r)
        for _ in range(cycles):
            u = _vcycle(u, r, lengths, levels, n_smooth)
            u = u - u.mean()
        return u

    if vec:
        return torch.stack([solve_scalar(rhs[..., c])
                            for c in range(rhs.shape[-1])], dim=-1)
    return solve_scalar(rhs)


def residual_norm(u, rhs, lengths) -> torch.Tensor:
    """RMS of the zero-mean residual ``rhs − ∆u`` (a 0-d tensor)."""
    lengths = tuple(float(v) for v in lengths)
    dim = len(lengths)
    h2s = tuple((L / n) ** 2 for L, n in zip(lengths, u.shape[:dim]))
    if u.dim() == dim + 1:
        r = torch.stack([rhs[..., c] - _laplacian(u[..., c], h2s)
                         for c in range(u.shape[-1])], dim=-1)
    else:
        r = rhs - _laplacian(u, h2s)
    r = r - r.mean()
    return torch.sqrt((r * r).mean())
