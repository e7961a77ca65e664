"""d-dimensional Hilbert space-filling curve (Skilling's algorithm); the
port's own copy of ``repro.core.hilbert``, which is NumPy only.

OpenFPM offers Hilbert-curve assignment of sub-sub-domains to processors as an
alternative to graph partitioning (paper §3.2). This module provides the curve
index used for that assignment, for arbitrary dimension — matching OpenFPM's
arbitrary-dimension support.

Host-side NumPy only (control plane).
"""
from __future__ import annotations

import numpy as np


def _transpose_to_axes(x: np.ndarray, b: int, n: int) -> np.ndarray:
    """Inverse of Skilling's axes→transpose: x is (..., n) transposed-form."""
    x = x.copy()
    N = 2 << (b - 1)
    # Gray decode by H ^ (H/2)
    t = x[..., n - 1] >> 1
    for i in range(n - 1, 0, -1):
        x[..., i] ^= x[..., i - 1]
    x[..., 0] ^= t
    # Undo excess work
    q = 2
    while q != N:
        p = q - 1
        for i in range(n - 1, -1, -1):
            cond = (x[..., i] & q).astype(bool)
            # invert low bits of x[0] where cond
            x[..., 0] = np.where(cond, x[..., 0] ^ p, x[..., 0])
            # exchange low bits of x[i] and x[0] where not cond
            t = (x[..., 0] ^ x[..., i]) & p
            t = np.where(cond, 0, t)
            x[..., 0] ^= t
            x[..., i] ^= t
        q <<= 1
    return x


def _axes_to_transpose(x: np.ndarray, b: int, n: int) -> np.ndarray:
    x = x.copy()
    M = 1 << (b - 1)
    # Inverse undo
    q = M
    while q > 1:
        p = q - 1
        for i in range(n):
            cond = (x[..., i] & q).astype(bool)
            x[..., 0] = np.where(cond, x[..., 0] ^ p, x[..., 0])
            t = (x[..., 0] ^ x[..., i]) & p
            t = np.where(cond, 0, t)
            x[..., 0] ^= t
            x[..., i] ^= t
        q >>= 1
    # Gray encode
    for i in range(1, n):
        x[..., i] ^= x[..., i - 1]
    t = np.zeros(x.shape[:-1], dtype=x.dtype)
    q = M
    while q > 1:
        t = np.where((x[..., n - 1] & q).astype(bool), t ^ (q - 1), t)
        q >>= 1
    for i in range(n):
        x[..., i] ^= t
    return x


def hilbert_index(coords: np.ndarray, bits: int) -> np.ndarray:
    """Map integer grid coordinates (..., dim) in [0, 2**bits) to the Hilbert
    curve index. Returns an array of shape (...) of python-int-safe uint64
    (object dtype is avoided; dim*bits must fit in 64 bits — asserted)."""
    coords = np.asarray(coords, dtype=np.uint64)
    n = coords.shape[-1]
    if n * bits > 63:
        raise ValueError(f"dim*bits={n * bits} exceeds 63; reduce grid resolution")
    tr = _axes_to_transpose(coords, bits, n)
    # Interleave bits of the transpose: bit (bits-1-b) of axis i goes to
    # position (bits-1-b)*n + (n-1-i).
    out = np.zeros(coords.shape[:-1], dtype=np.uint64)
    for b in range(bits):
        for i in range(n):
            bit = (tr[..., i] >> np.uint64(b)) & np.uint64(1)
            pos = np.uint64(b * n + (n - 1 - i))
            out |= bit << pos
    return out


def hilbert_order(coords: np.ndarray, bits: int) -> np.ndarray:
    """Return the permutation that sorts grid cells along the Hilbert curve."""
    return np.argsort(hilbert_index(coords, bits), kind="stable")
