"""Spectral Poisson solve on a periodic box (port of ``repro.numerics.
poisson.fft_poisson``; the PetSc replacement of paper §4.4).

The vortex-in-cell step solves ∆ψ = -ω on a periodic Cartesian mesh. The
transforms are ``torch.fft.fftn``/``ifftn`` in complex64, as the JAX
package leaves them to XLA's FFT outside any Pallas kernel. (``repro``'s
``multigrid_poisson`` and its slab and pencil solvers are not ported yet,
ROADMAP A10/A14.)
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
