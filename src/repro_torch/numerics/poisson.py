"""Poisson solves on a periodic box (port of ``repro.numerics.poisson``;
the PetSc replacement of paper §4.4).

The vortex-in-cell step solves ∆ψ = -ω on a periodic Cartesian mesh with
:func:`fft_poisson`: ``torch.fft.fftn``/``ifftn`` in complex64, as the JAX
package leaves them to XLA's FFT outside any Pallas kernel.
:func:`fft_poisson_slab_local` / :func:`make_fft_poisson_slab` solve on a
mesh sharded along its leading axis (DESIGN.md §10): local 2-D FFTs, ONE
``all_to_all`` transpose, a local 1-D FFT and the spectral division, and
back; one slab degenerates to :func:`fft_poisson`.
:func:`fft_poisson_pencil_local` / :func:`make_fft_poisson_pencil` solve
on a mesh sharded along axes 0 and 1 over a 2-D device mesh (DESIGN.md
§13): two tiled ``all_to_all`` transposes each way, each over one mesh
axis. :func:`multigrid_poisson` is the geometric V-cycle
alternative (damped Jacobi smoothing of the 2·dim+1-point Laplacian),
with :func:`residual_norm`.
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from repro_torch.core import runtime as RT


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
# Slab-decomposed spectral solve (sharded leading axis, one transpose)
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def _slab_lam(shape, lengths, discrete: bool, me: int, ndev: int,
              device: torch.device) -> torch.Tensor:
    """The eigenvalues of this rank's k1 rows, ``(n0, n1 / ndev, n2)``
    float32, as ``repro`` forms them (per-axis float32 vectors summed), kept
    on ``device`` per geometry."""
    l0, l1, l2 = (torch.from_numpy(v).to(torch.float32)
                  for v in _k2_axes(shape, lengths, discrete))
    n1l = shape[1] // ndev
    l1 = l1[me * n1l:(me + 1) * n1l]
    return (l0[:, None, None] + l1[None, :, None]
            + l2[None, None, :]).to(device)


def fft_poisson_slab_local(rhs: torch.Tensor, lengths: Tuple[float, ...],
                           axis_name: str, discrete: bool = True
                           ) -> torch.Tensor:
    """Solve ∆u = rhs on a slab-sharded 3-D periodic mesh, per rank.

    ``rhs`` is this rank's block ``(n0/ndev, n1, n2[, C])``. FFT the two
    complete axes, ``all_to_all``-transpose so axis 0 is complete (axis 1
    sharded instead), FFT axis 0, divide by this rank's eigenvalues, and
    invert the path. Needs ``n1 % ndev == 0``."""
    lengths = tuple(float(v) for v in lengths)
    if len(lengths) != 3:
        raise ValueError("the slab decomposition is 3-D")
    ndev = RT.axis_size(axis_name)
    me = RT.axis_index(axis_name)
    vec = rhs.dim() == 4
    n0l, n1, n2 = rhs.shape[:3]
    if n1 % ndev:
        raise ValueError(f"axis 1 ({n1}) must divide over {ndev} shards "
                         "for the FFT transpose")
    rh = torch.fft.fftn(rhs.to(torch.complex64), dim=(1, 2))
    # transpose: scatter my axis-1 columns, gather everyone's axis-0 rows
    rh = RT.all_to_all(rh, axis_name, split_axis=1, concat_axis=0,
                       tiled=True)
    rh = torch.fft.fft(rh, dim=0)                   # (n0, n1l, n2[, C])
    lam = _slab_lam((n0l * ndev, n1, n2), lengths, discrete, me, ndev,
                    rhs.device)
    if vec:
        lam = lam[..., None]
    zero = lam == 0
    uh = torch.where(zero, torch.zeros_like(rh),
                     rh / torch.where(zero, torch.ones_like(lam), lam))
    del rh
    uh = torch.fft.ifft(uh, dim=0)
    uh = RT.all_to_all(uh, axis_name, split_axis=0, concat_axis=1,
                       tiled=True)
    return torch.fft.ifftn(uh, dim=(1, 2)).real.to(rhs.dtype)


def make_fft_poisson_slab(mesh, axis_name: str, lengths: Tuple[float, ...],
                          discrete: bool = True):
    """``solve(rhs_block) -> u_block`` over a leading-axis-sharded rhs, as
    each rank calls it (the global values of :func:`fft_poisson` up to FFT
    round-off). A 1-slab mesh returns the serial solver itself: the slab
    path degenerates to it."""
    lengths = tuple(float(v) for v in lengths)
    with RT.on_mesh(mesh):
        ndev = RT.axis_size(axis_name)
    if ndev == 1:
        return lambda rhs: fft_poisson(rhs, lengths, discrete)

    def solve(rhs):
        with RT.on_mesh(mesh):
            return fft_poisson_slab_local(rhs, lengths, axis_name, discrete)

    return solve


# --------------------------------------------------------------------------
# Pencil-decomposed spectral solve (2-D device mesh, two tiled transposes)
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def _pencil_lam(shape, lengths, discrete: bool, me_r: int, r: int,
                me_c: int, c: int, device: torch.device) -> torch.Tensor:
    """The eigenvalues of this pencil's (k1, k2) rows, ``(n0, n1 / r, n2 /
    c)`` float32, formed as ``repro`` forms them (per-axis float32
    vectors summed), kept on ``device`` per geometry."""
    l0, l1, l2 = (torch.from_numpy(v).to(torch.float32)
                  for v in _k2_axes(shape, lengths, discrete))
    n1r, n2c = shape[1] // r, shape[2] // c
    l1 = l1[me_r * n1r:(me_r + 1) * n1r]
    l2 = l2[me_c * n2c:(me_c + 1) * n2c]
    return (l0[:, None, None] + l1[None, :, None]
            + l2[None, None, :]).to(device)


def fft_poisson_pencil_local(rhs: torch.Tensor, lengths: Tuple[float, ...],
                             row_axis: str, col_axis: str,
                             discrete: bool = True) -> torch.Tensor:
    """Solve ∆u = rhs on a pencil-sharded 3-D periodic mesh, per rank of an
    ``(r, c)`` device mesh (DESIGN.md §13).

    ``rhs`` is this rank's pencil ``(n0/r, n1/c, n2[, C])``. FFT the
    complete axis 2; ``all_to_all`` over the column axis (split axis 2,
    concat axis 1) so axis 1 is complete; FFT axis 1; ``all_to_all`` over
    the row axis (split axis 1, concat axis 0) so axis 0 is complete; FFT
    axis 0; divide by this pencil's eigenvalues; and invert the path.
    Needs ``n2 % c == 0`` and ``n1 % r == 0`` (the transpose tilings); a
    size-1 axis makes its transposes the identity."""
    lengths = tuple(float(v) for v in lengths)
    if len(lengths) != 3:
        raise ValueError("the pencil decomposition is 3-D")
    r, c = RT.axis_size(row_axis), RT.axis_size(col_axis)
    me_r, me_c = RT.axis_index(row_axis), RT.axis_index(col_axis)
    vec = rhs.dim() == 4
    n0l, n1l, n2 = rhs.shape[:3]
    n1 = n1l * c
    if n2 % c:
        raise ValueError(f"axis 2 ({n2}) must divide over {c} column shards "
                         "for the first FFT transpose")
    if n1 % r:
        raise ValueError(f"axis 1 ({n1}) must divide over {r} row shards "
                         "for the second FFT transpose")
    rh = torch.fft.fft(rhs.to(torch.complex64), dim=2)
    # transpose 1 (columns): complete axis 1, shard axis 2
    rh = RT.all_to_all(rh, col_axis, split_axis=2, concat_axis=1,
                       tiled=True)
    rh = torch.fft.fft(rh, dim=1)                   # (n0l, n1, n2c[, C])
    # transpose 2 (rows): complete axis 0, shard axis 1
    rh = RT.all_to_all(rh, row_axis, split_axis=1, concat_axis=0,
                       tiled=True)
    rh = torch.fft.fft(rh, dim=0)                   # (n0, n1r, n2c[, C])
    lam = _pencil_lam((n0l * r, n1, n2), lengths, discrete, me_r, r, me_c,
                      c, rhs.device)
    if vec:
        lam = lam[..., None]
    zero = lam == 0
    uh = torch.where(zero, torch.zeros_like(rh),
                     rh / torch.where(zero, torch.ones_like(lam), lam))
    del rh
    uh = torch.fft.ifft(uh, dim=0)
    uh = RT.all_to_all(uh, row_axis, split_axis=0, concat_axis=1,
                       tiled=True)
    uh = torch.fft.ifft(uh, dim=1)                  # (n0l, n1, n2c[, C])
    uh = RT.all_to_all(uh, col_axis, split_axis=1, concat_axis=2,
                       tiled=True)
    return torch.fft.ifft(uh, dim=2).real.to(rhs.dtype)


def make_fft_poisson_pencil(mesh, axis_names: Tuple[str, str],
                            lengths: Tuple[float, ...],
                            discrete: bool = True):
    """``solve(rhs_block) -> u_block`` over a pencil-sharded rhs (axes 0
    and 1 over an ``(r, c)`` device mesh), as each rank calls it. The
    degenerate meshes reuse the narrower solvers, as in ``repro``: 1 × 1
    returns the serial :func:`fft_poisson`, ``(r, 1)`` runs
    :func:`fft_poisson_slab_local` over the row axis (bit for bit the slab
    path), anything else the two-transpose pencil plan."""
    row_axis, col_axis = axis_names
    lengths = tuple(float(v) for v in lengths)
    with RT.on_mesh(mesh):
        r, c = RT.axis_size(row_axis), RT.axis_size(col_axis)
    if r == 1 and c == 1:
        return lambda rhs: fft_poisson(rhs, lengths, discrete)
    if c == 1:
        def local(rhs):
            return fft_poisson_slab_local(rhs, lengths, row_axis, discrete)
    else:
        def local(rhs):
            return fft_poisson_pencil_local(rhs, lengths, row_axis,
                                            col_axis, discrete)

    def solve(rhs):
        with RT.on_mesh(mesh):
            return local(rhs)

    return solve


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
