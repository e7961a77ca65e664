"""DC-PSE: Discretization-Corrected Particle Strength Exchange operators
(port of ``repro.core.dcpse``; Schrader, Reboux & Sbalzarini, JCP 2010,
the paper's ref [37] and §5 future work).

For a derivative multi-index α, DC-PSE builds per-particle kernel weights
w_ij such that Σ_j w_ij (f_j - f_i) reproduces D^α f at x_i to order r, by
solving a small moment system per particle:

    A_i c_i = b,   A_i[m, n] = Σ_j  z_ij^{β_m} z_ij^{β_n} W(z_ij)
    (z_ij = (x_j - x_i)/ε, β over monomials with 1 <= |β| <= |α| + r - 1,
     b_m = α!·δ_{β_m,α})

and w_ij = Σ_m c_m z_ij^{β_m} W(z_ij) / ε^{|α|}. The systems of all
particles are one batched solve (``torch.linalg.solve_ex``: no host read
of its error flags), over the neighbors of a ``cell_list.VerletList``.
"""
from __future__ import annotations

import itertools
from typing import Tuple

import numpy as np
import torch

from .cell_list import VerletList
from .particles import ParticleSet, const_tensor


def multi_indices(dim: int, max_order: int) -> np.ndarray:
    """All multi-indices β with 1 <= |β| <= max_order (the constant term
    is excluded: DC-PSE operators annihilate constants by construction)."""
    out = [b for b in itertools.product(range(max_order + 1), repeat=dim)
           if 1 <= sum(b) <= max_order]
    out.sort(key=lambda b: (sum(b), b))
    return np.asarray(out, np.int32)


def _factorial(n: int) -> int:
    return int(np.prod(range(1, n + 1))) if n > 1 else 1


def dcpse_apply(ps: ParticleSet, vl: VerletList, f: torch.Tensor, *,
                alpha: Tuple[int, ...], order: int = 2,
                epsilon: float | None = None) -> torch.Tensor:
    """Apply D^alpha to the particle field ``f`` (cap,) at every particle.

    alpha: derivative multi-index, e.g. (1, 0) = ∂/∂x. order: the
    approximation order r. epsilon: the kernel scale; by default each
    particle's mean neighbor distance (adaptive resolution)."""
    cap = ps.capacity
    dev = ps.device
    a_order = int(sum(alpha))
    betas = multi_indices(ps.dim, a_order + order - 1)
    n_m = len(betas)
    betas_t = const_tensor(tuple(tuple(float(v) for v in b) for b in betas),
                           torch.float32, dev)            # (n_m, dim)

    xm = ps.masked_x()
    nbr = vl.nbr.long()
    ok = nbr < cap
    safe = nbr.clamp(max=cap - 1)
    dx = xm[safe] - xm[:, None, :]                      # (cap, k_max, dim)

    if epsilon is None:
        dist = torch.sqrt((dx * dx).sum(-1))
        n_ok = ok.sum(-1).clamp(min=1).to(dist.dtype)
        eps = torch.where(ok, dist, torch.zeros_like(dist)).sum(-1) / n_ok
        eps = torch.clamp(eps, min=1e-12)[:, None]
    else:
        eps = torch.full((cap, 1), epsilon, dtype=torch.float32, device=dev)

    z = dx / eps[..., None]                             # (cap, k_max, dim)
    w_gauss = torch.exp(-(z * z).sum(-1))               # (cap, k_max)
    w_gauss = torch.where(ok, w_gauss, torch.zeros_like(w_gauss))

    # monomials z^beta: (cap, k_max, n_m)
    zb = torch.prod(z[:, :, None, :] ** betas_t[None, None], dim=-1)

    # moment system A (cap, n_m, n_m); with the (f_j - f_i) form the
    # consistency condition is Σ_j w z^β W = α!·δ_{β,α}
    A = torch.bmm((zb * w_gauss[..., None]).transpose(1, 2), zb)
    match = np.all(betas == np.asarray(alpha, np.int32), axis=1)
    coef = float(np.prod([_factorial(a) for a in alpha]))
    b = const_tensor(tuple(coef if m else 0.0 for m in match),
                     torch.float32, dev)

    # regularized solve (scattered neighborhoods can be near-degenerate)
    A = A + 1e-8 * torch.eye(n_m, dtype=A.dtype, device=dev)[None]
    c = torch.linalg.solve_ex(A, b.expand(cap, n_m)[..., None])[0][..., 0]

    w = torch.bmm(zb, c[..., None])[..., 0] * w_gauss   # (cap, k_max)
    df = torch.where(ok, f[safe] - f[:, None], torch.zeros_like(w))
    out = (w * df).sum(-1) / eps[:, 0] ** a_order
    return torch.where(ps.valid, out, torch.zeros_like(out))


def laplacian(ps: ParticleSet, vl: VerletList, f: torch.Tensor, *,
              order: int = 2, epsilon: float | None = None) -> torch.Tensor:
    """Σ_d ∂²f/∂x_d² at every particle."""
    dim = ps.dim
    out = torch.zeros_like(f)
    for d in range(dim):
        alpha = tuple(2 if i == d else 0 for i in range(dim))
        out = out + dcpse_apply(ps, vl, f, alpha=alpha, order=order,
                                epsilon=epsilon)
    return out


def gradient(ps: ParticleSet, vl: VerletList, f: torch.Tensor, *,
             order: int = 2, epsilon: float | None = None) -> torch.Tensor:
    """(cap, dim) ∇f at every particle."""
    dim = ps.dim
    comps = [dcpse_apply(ps, vl, f,
                         alpha=tuple(1 if i == d else 0 for i in range(dim)),
                         order=order, epsilon=epsilon)
             for d in range(dim)]
    return torch.stack(comps, dim=-1)
