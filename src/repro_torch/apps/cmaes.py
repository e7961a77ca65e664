"""Particle-swarm CMA-ES (port of ``repro.apps.cmaes``; paper §4.6) —
high-dimensional, non-simulation use of the particle abstractions.

Each OpenFPM "particle" is one full CMA-ES instance (mean, step size,
covariance, evolution paths) in an n-dimensional box (n = 10..50).
Instances interact by migrating the global best mean into the worst
instance — the particle-swarm coupling of Müller et al. [77] (pCMAlib),
expressed through the same reductions as a simulation. Validation mirrors
the paper: the success rate on shifted Rastrigin (the dominant component
of CEC2005 f15), PS-CMA-ES against independent runs, at a fixed budget.

Two engines share this file, as in ``repro``:

  * the **numpy** loop (``cma_generation`` / ``ps_cma_es``) — the float64
    reference, copied from ``repro`` as it is; the test oracle;
  * the **torch batched engine** (``cma_update`` / ``ps_cma_es_torch``) —
    the population as one fleet: a :class:`CMAStateT` of ``(B, ...)``
    tensors advanced by batched ops (``torch.linalg.eigh`` on ``(B, n,
    n)``, ``bmm``, a stable ``argsort``), in float32 as ``repro``'s jax
    engine runs, with draws from an explicit ``torch.Generator`` on the
    device. ``cma_update`` takes the sample block ``z`` explicitly, so a
    test feeds every engine the same draws (``torch`` and ``jax.random``
    draw different numbers from one seed).

CMA-ES has no TPU kernel: ``eigh`` and the products are library calls
here, as ``repro`` leaves them to XLA. With a 1-D device mesh
(``ps_cma_es_torch(mesh=)``) the population is sharded as the fleet is:
rank ``d`` owns instances ``[d·B/ndev, (d+1)·B/ndev)``, each rank draws
the whole population's samples from the same seeded generator and keeps
its own rows (so the sharded run draws what the serial run draws), and
:func:`migrate` spans the shards through the ``Reduce`` collectives.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import runtime as RT
from repro_torch.core import simulation as SIM
from repro_torch.core.particles import resolve_device


def rastrigin(x: np.ndarray) -> np.ndarray:
    """Shifted Rastrigin: global optimum f=0 at x = 1.23 (multi-funnel
    stand-in for CEC2005 f15)."""
    z = x - 1.23
    return 10.0 * z.shape[-1] + np.sum(
        z * z - 10.0 * np.cos(2 * np.pi * z), axis=-1)


@dataclasses.dataclass
class CMAState:
    mean: np.ndarray
    sigma: float
    C: np.ndarray
    p_sigma: np.ndarray
    p_c: np.ndarray
    best_f: float
    best_x: np.ndarray
    evals: int = 0
    gen: int = 0


def cma_init(dim: int, rng: np.random.Generator, lo=-5.0, hi=5.0,
             sigma0: float = 2.0) -> CMAState:
    mean = rng.uniform(lo, hi, dim)
    return CMAState(mean=mean, sigma=sigma0, C=np.eye(dim),
                    p_sigma=np.zeros(dim), p_c=np.zeros(dim),
                    best_f=np.inf, best_x=mean.copy())


def cma_generation(st: CMAState, f: Callable, rng: np.random.Generator,
                   lam: int | None = None) -> CMAState:
    """One standard CMA-ES generation (Hansen's tutorial formulation)."""
    n = st.mean.size
    lam = lam or 4 + int(3 * np.log(n))
    mu = lam // 2
    w = np.log(mu + 0.5) - np.log(np.arange(1, mu + 1))
    w = w / w.sum()
    mu_eff = 1.0 / np.sum(w ** 2)
    c_sigma = (mu_eff + 2) / (n + mu_eff + 5)
    d_sigma = 1 + 2 * max(0.0, math.sqrt((mu_eff - 1) / (n + 1)) - 1) + c_sigma
    c_c = (4 + mu_eff / n) / (n + 4 + 2 * mu_eff / n)
    c_1 = 2 / ((n + 1.3) ** 2 + mu_eff)
    c_mu = min(1 - c_1, 2 * (mu_eff - 2 + 1 / mu_eff)
               / ((n + 2) ** 2 + mu_eff))
    chi_n = math.sqrt(n) * (1 - 1 / (4 * n) + 1 / (21 * n * n))

    # eigendecomposition (C is kept symmetric); canonical eigenvector signs
    # (largest-|component| positive) so the sampled y is a deterministic
    # function of (C, z) — LAPACK's sign choice is arbitrary and differs
    # across precisions/backends, which would make the jax engine
    # incomparable against this reference
    D2, B = np.linalg.eigh(st.C)
    B = B * np.sign(B[np.argmax(np.abs(B), axis=0), np.arange(n)])
    D = np.sqrt(np.maximum(D2, 1e-20))
    z = rng.standard_normal((lam, n))
    y = z @ np.diag(D) @ B.T
    xs = st.mean + st.sigma * y
    fs = f(xs)
    order = np.argsort(fs)
    xs, y, fs = xs[order], y[order], fs[order]

    y_w = w @ y[:mu]
    mean = st.mean + st.sigma * y_w
    # step-size path
    C_inv_sqrt = B @ np.diag(1.0 / D) @ B.T
    p_sigma = (1 - c_sigma) * st.p_sigma + math.sqrt(
        c_sigma * (2 - c_sigma) * mu_eff) * (C_inv_sqrt @ y_w)
    sigma = st.sigma * math.exp(
        (c_sigma / d_sigma) * (np.linalg.norm(p_sigma) / chi_n - 1))
    sigma = float(np.clip(sigma, 1e-12, 1e4))
    # covariance path
    h_sigma = 1.0 if (np.linalg.norm(p_sigma)
                      / math.sqrt(1 - (1 - c_sigma) ** (2 * (st.gen + 1)))
                      < (1.4 + 2 / (n + 1)) * chi_n) else 0.0
    p_c = (1 - c_c) * st.p_c + h_sigma * math.sqrt(
        c_c * (2 - c_c) * mu_eff) * y_w
    rank_mu = sum(wi * np.outer(yi, yi) for wi, yi in zip(w, y[:mu]))
    C = ((1 - c_1 - c_mu) * st.C
         + c_1 * (np.outer(p_c, p_c)
                  + (1 - h_sigma) * c_c * (2 - c_c) * st.C)
         + c_mu * rank_mu)
    C = 0.5 * (C + C.T)

    best_idx = 0
    best_f, best_x = st.best_f, st.best_x
    if fs[best_idx] < best_f:
        best_f, best_x = float(fs[best_idx]), xs[best_idx].copy()
    return CMAState(mean=mean, sigma=sigma, C=C, p_sigma=p_sigma, p_c=p_c,
                    best_f=best_f, best_x=best_x,
                    evals=st.evals + lam, gen=st.gen + 1)


def ps_cma_es(f: Callable, dim: int, n_particles: int, max_evals: int,
              seed: int = 0, migrate_every: int = 20,
              swarm: bool = True) -> Tuple[float, np.ndarray, int]:
    """Particle-swarm CMA-ES: n_particles instances; every
    ``migrate_every`` generations the globally best mean migrates into the
    worst instance (with a sigma re-excitation), the pCMAlib-style swarm
    coupling. ``swarm=False`` runs independent instances (the baseline the
    paper's refs compare against)."""
    rng = np.random.default_rng(seed)
    parts = [cma_init(dim, rng) for _ in range(n_particles)]
    total = 0
    gen = 0
    while total < max_evals:
        for i, st in enumerate(parts):
            before = st.evals
            parts[i] = cma_generation(st, f, rng)
            total += parts[i].evals - before
            if total >= max_evals:
                break
        gen += 1
        if swarm and gen % migrate_every == 0:
            best = min(parts, key=lambda s: s.best_f)
            worst_i = int(np.argmax([s.best_f for s in parts]))
            if parts[worst_i].best_f > best.best_f:
                st = parts[worst_i]
                # migrate: re-center on the global best, re-excite sigma
                parts[worst_i] = dataclasses.replace(
                    st, mean=best.best_x.copy(), sigma=max(st.sigma, 0.5),
                    C=np.eye(dim), p_sigma=np.zeros(dim), p_c=np.zeros(dim))
        # restart collapsed instances (sigma underflow)
        for i, st in enumerate(parts):
            if st.sigma < 1e-10:
                fresh = cma_init(dim, rng)
                fresh.best_f, fresh.best_x = st.best_f, st.best_x
                parts[i] = fresh
    best = min(parts, key=lambda s: s.best_f)
    return best.best_f, best.best_x, total


def success_rate(f, dim, n_runs, max_evals, *, n_particles=4, swarm=True,
                 f_target=1e-2, seed0=0) -> float:
    ok = 0
    for r in range(n_runs):
        bf, _, _ = ps_cma_es(f, dim, n_particles, max_evals,
                             seed=seed0 + r, swarm=swarm)
        ok += bf < f_target
    return ok / n_runs


# ==========================================================================
# torch batched engine — the population as one fleet
# ==========================================================================

def rastrigin_t(x: torch.Tensor) -> torch.Tensor:
    """:func:`rastrigin` in torch, over the last axis."""
    z = x - 1.23
    return 10.0 * z.shape[-1] + torch.sum(
        z * z - 10.0 * torch.cos((2 * math.pi) * z), dim=-1)


@dataclasses.dataclass(frozen=True)
class CMAStateT:
    """A population of ``B`` CMA-ES instances as ``(B, ...)`` tensors (the
    CMA mirror of ``fleet.batch.EnsembleState``; ``repro``'s stacked
    ``CMAStateJ``)."""

    mean: torch.Tensor      # (B, n)
    sigma: torch.Tensor     # (B,)
    C: torch.Tensor         # (B, n, n)
    p_sigma: torch.Tensor   # (B, n)
    p_c: torch.Tensor       # (B, n)
    best_f: torch.Tensor    # (B,)
    best_x: torch.Tensor    # (B, n)
    evals: torch.Tensor     # (B,) int32
    gen: torch.Tensor       # (B,) int32

    @property
    def batch(self) -> int:
        return self.mean.shape[0]


@functools.lru_cache(maxsize=None)
def cma_consts(n: int, lam: Optional[int] = None):
    """Hansen's strategy constants for dimension ``n`` (Python floats; the
    weights as a tuple, so the whole dict caches)."""
    lam = lam or 4 + int(3 * np.log(n))
    mu = lam // 2
    w = np.log(mu + 0.5) - np.log(np.arange(1, mu + 1))
    w = w / w.sum()
    mu_eff = 1.0 / np.sum(w ** 2)
    c_sigma = (mu_eff + 2) / (n + mu_eff + 5)
    d_sigma = 1 + 2 * max(0.0, math.sqrt((mu_eff - 1) / (n + 1)) - 1) + c_sigma
    c_c = (4 + mu_eff / n) / (n + 4 + 2 * mu_eff / n)
    c_1 = 2 / ((n + 1.3) ** 2 + mu_eff)
    c_mu = min(1 - c_1, 2 * (mu_eff - 2 + 1 / mu_eff)
               / ((n + 2) ** 2 + mu_eff))
    chi_n = math.sqrt(n) * (1 - 1 / (4 * n) + 1 / (21 * n * n))
    return dict(lam=lam, mu=mu, w=tuple(float(x) for x in w),
                mu_eff=float(mu_eff), c_sigma=float(c_sigma),
                d_sigma=float(d_sigma), c_c=float(c_c), c_1=float(c_1),
                c_mu=float(c_mu), chi_n=float(chi_n))


def cma_init_t(generator: torch.Generator, dim: int, batch: int = 1,
               lo=-5.0, hi=5.0, sigma0: float = 2.0) -> CMAStateT:
    """``batch`` fresh instances on the generator's device: means drawn
    uniformly in ``[lo, hi)^dim``, ``C = I``, zero paths."""
    dev = generator.device
    f32 = dict(dtype=torch.float32, device=dev)
    mean = lo + (hi - lo) * torch.rand((batch, dim), generator=generator,
                                       **f32)
    eye = torch.eye(dim, **f32).expand(batch, dim, dim).clone()
    return CMAStateT(
        mean=mean, sigma=torch.full((batch,), sigma0, **f32), C=eye,
        p_sigma=torch.zeros((batch, dim), **f32),
        p_c=torch.zeros((batch, dim), **f32),
        best_f=torch.full((batch,), math.inf, **f32), best_x=mean.clone(),
        evals=torch.zeros((batch,), dtype=torch.int32, device=dev),
        gen=torch.zeros((batch,), dtype=torch.int32, device=dev))


def _canonical_eig(C: torch.Tensor):
    """(D2, B) of each symmetric ``C`` in the batch, each eigenvector's
    sign fixed so its largest-|component| entry is positive (mirroring
    ``cma_generation``: LAPACK's and cuSOLVER's sign choices are
    arbitrary)."""
    D2, Bm = torch.linalg.eigh(C)
    idx = Bm.abs().argmax(dim=1, keepdim=True)            # (B, 1, n)
    return D2, Bm * torch.sign(torch.gather(Bm, 1, idx))


def cma_update(st: CMAStateT, z: torch.Tensor, f: Callable) -> CMAStateT:
    """One CMA-ES generation of every instance given the sample block
    ``z`` of shape ``(B, lam, n)`` explicitly — :func:`cma_generation`'s
    math, batched over the population, in float32."""
    n = st.mean.shape[-1]
    lam = z.shape[1]
    c = cma_consts(n, lam)
    mu = c["mu"]
    w = torch.tensor(c["w"], dtype=torch.float32, device=z.device)

    D2, Bm = _canonical_eig(st.C)
    D = torch.sqrt(torch.clamp(D2, min=1e-20))
    y = torch.bmm(z * D[:, None, :], Bm.transpose(1, 2))  # z diag(D) B^T
    xs = st.mean[:, None, :] + st.sigma[:, None, None] * y
    fs = f(xs)                                            # (B, lam)
    order = torch.argsort(fs, dim=1, stable=True)
    xs = torch.gather(xs, 1, order[..., None].expand_as(xs))
    y = torch.gather(y, 1, order[..., None].expand_as(y))
    fs = torch.gather(fs, 1, order)

    y_mu = y[:, :mu]
    y_w = torch.matmul(w, y_mu)                           # (B, n)
    mean = st.mean + st.sigma[:, None] * y_w
    C_inv_sqrt = torch.bmm(Bm * (1.0 / D)[:, None, :], Bm.transpose(1, 2))
    p_sigma = ((1 - c["c_sigma"]) * st.p_sigma
               + math.sqrt(c["c_sigma"] * (2 - c["c_sigma"]) * c["mu_eff"])
               * torch.bmm(C_inv_sqrt, y_w[..., None])[..., 0])
    ps_norm = torch.linalg.norm(p_sigma, dim=-1)
    sigma = st.sigma * torch.exp(
        (c["c_sigma"] / c["d_sigma"]) * (ps_norm / c["chi_n"] - 1))
    sigma = torch.clamp(sigma, 1e-12, 1e4)
    decay = torch.pow(torch.full_like(ps_norm, 1 - c["c_sigma"]),
                      2.0 * (st.gen + 1).to(torch.float32))
    h_sigma = torch.where(
        ps_norm / torch.sqrt(1 - decay)
        < (1.4 + 2 / (n + 1)) * c["chi_n"], 1.0, 0.0)
    p_c = ((1 - c["c_c"]) * st.p_c
           + (h_sigma * math.sqrt(c["c_c"] * (2 - c["c_c"]) * c["mu_eff"])
              )[:, None] * y_w)
    rank_mu = torch.bmm(y_mu.transpose(1, 2) * w, y_mu)  # Σ w_i y_i y_iᵀ
    outer = p_c[:, :, None] * p_c[:, None, :]
    C = ((1 - c["c_1"] - c["c_mu"]) * st.C
         + c["c_1"] * (outer + ((1 - h_sigma) * c["c_c"] * (2 - c["c_c"])
                                )[:, None, None] * st.C)
         + c["c_mu"] * rank_mu)
    C = 0.5 * (C + C.transpose(1, 2))

    better = fs[:, 0] < st.best_f
    best_f = torch.where(better, fs[:, 0], st.best_f)
    best_x = torch.where(better[:, None], xs[:, 0], st.best_x)
    return CMAStateT(mean=mean, sigma=sigma, C=C, p_sigma=p_sigma, p_c=p_c,
                     best_f=best_f, best_x=best_x,
                     evals=st.evals + lam, gen=st.gen + 1)


def cma_generation_t(st: CMAStateT, generator: torch.Generator, f: Callable,
                     lam: Optional[int] = None,
                     shard: Tuple[int, int] = (0, 1)) -> CMAStateT:
    """Generator-threaded generation: draw ``z`` and :func:`cma_update`.
    ``shard = (me, ndev)``: ``st`` is block ``me`` of a population sharded
    ``ndev`` ways, and the whole population's ``z`` is drawn and this
    block's rows kept."""
    n = st.mean.shape[-1]
    lam = cma_consts(n, lam)["lam"]
    z = torch.randn((st.batch * shard[1], lam, n), generator=generator,
                    dtype=torch.float32, device=st.mean.device)
    return cma_update(st, _block(z, shard), f)


def _select(mask: torch.Tensor, new: torch.Tensor, old: torch.Tensor):
    """Instance-wise select with ``mask`` (B,) broadcast over the rest."""
    return torch.where(mask.reshape(mask.shape + (1,) * (old.dim() - 1)),
                       new, old)


def _block(t: torch.Tensor, shard: Tuple[int, int]) -> torch.Tensor:
    """Rows of block ``me`` of ``ndev`` equal blocks (``shard = (me,
    ndev)``)."""
    me, ndev = shard
    bl = t.shape[0] // ndev
    return t[me * bl:(me + 1) * bl]


def restart_collapsed(st: CMAStateT, generator: torch.Generator, lo=-5.0,
                      hi=5.0, sigma0: float = 2.0, tol: float = 1e-10,
                      shard: Tuple[int, int] = (0, 1)) -> CMAStateT:
    """Restart the sigma-collapsed instances (best-so-far survives), the
    select rendering of the numpy loop's restart branch. Fresh means are
    drawn for every instance, so the draws do not depend on which
    collapsed. ``shard = (me, ndev)``: ``st`` is block ``me`` of a
    population sharded ``ndev`` ways, and the whole population's means
    are drawn and this block's rows kept."""
    dead = st.sigma < tol
    fresh = cma_init_t(generator, st.mean.shape[-1], st.batch * shard[1],
                       lo, hi, sigma0)
    fresh = CMAStateT(**{k: _block(getattr(fresh, k), shard)
                         for k in CMAStateT.__dataclass_fields__})
    return CMAStateT(mean=_select(dead, fresh.mean, st.mean),
                     sigma=_select(dead, fresh.sigma, st.sigma),
                     C=_select(dead, fresh.C, st.C),
                     p_sigma=_select(dead, fresh.p_sigma, st.p_sigma),
                     p_c=_select(dead, fresh.p_c, st.p_c),
                     best_f=st.best_f, best_x=st.best_x,
                     evals=st.evals, gen=_select(dead, fresh.gen, st.gen))


def migrate(pop: CMAStateT, red: SIM.Reduce) -> CMAStateT:
    """PS-coupling through the simulation-layer reductions: the globally
    best mean migrates into the globally worst instance (sigma re-excited
    to at least 0.5, covariance and paths reset) when it is worse —
    :func:`ps_cma_es`'s swarm step as a batched rewrite. ``pop`` is this
    rank's block; with an axis ``red`` spans the shards (per-shard
    champions gathered, the worst instance hit on the shard that holds
    it), serially it is the identity."""
    bf = pop.best_f                                       # (B,)
    n = pop.mean.shape[-1]
    loc_best = torch.argmin(bf)
    g_f = red.gather(bf[loc_best])                        # (ndev,)
    g_x = red.gather(pop.best_x[loc_best])                # (ndev, n)
    shard_best = torch.argmin(g_f)
    best_f, best_x = g_f[shard_best], g_x[shard_best]
    loc_worst = torch.argmax(bf)
    g_worst = red.gather(bf[loc_worst])
    shard_worst = torch.argmax(g_worst)
    worst_f = g_worst[shard_worst]
    me = RT.axis_index(red.axis_name) if red.axis_name else 0
    hit = ((torch.arange(bf.shape[0], device=bf.device) == loc_worst)
           & (shard_worst == me) & (worst_f > best_f))
    eye = torch.eye(n, dtype=pop.C.dtype, device=pop.C.device)
    zero = torch.zeros_like(pop.p_sigma)
    return dataclasses.replace(
        pop,
        mean=_select(hit, best_x[None].expand_as(pop.mean), pop.mean),
        sigma=_select(hit, torch.clamp(pop.sigma, min=0.5), pop.sigma),
        C=_select(hit, eye.expand_as(pop.C), pop.C),
        p_sigma=_select(hit, zero, pop.p_sigma),
        p_c=_select(hit, zero, pop.p_c))


def ps_cma_es_torch(f: Callable, dim: int, n_particles: int, max_evals: int,
                    seed: int = 0, migrate_every: int = 20,
                    swarm: bool = True, lam: Optional[int] = None,
                    device="cuda", mesh=None,
                    axis_name: str = "fleet"
                    ) -> Tuple[float, np.ndarray, int]:
    """:func:`ps_cma_es` on the batched engine, on ``device``: each
    generation is one batched update of the population, a collapse
    restart and (every ``migrate_every`` generations, with ``swarm``) a
    migration — ``repro``'s round. Draws come from a ``torch.Generator``
    on the device seeded with ``seed``; the loop reads nothing back until
    it ends. Returns ``(best_f, best_x, evaluations)``.

    With a 1-D ``mesh`` every rank calls it with the same arguments and
    steps its block of the population (``n_particles % ndev == 0``): it
    draws the whole population's samples and keeps its rows, so the run
    draws what the serial run draws, and the migration spans the shards.
    The best is reduced over the ranks and returned on every rank."""
    dev = resolve_device(device)
    lam_c = cma_consts(dim, lam)["lam"]
    with RT.on_mesh(mesh):
        shard = (0, 1)
        if mesh is not None:
            shard = (RT.axis_index(axis_name), RT.axis_size(axis_name))
            if n_particles % shard[1]:
                raise ValueError(f"population {n_particles} not divisible "
                                 f"by {shard[1]} devices on axis "
                                 f"{axis_name!r}")
        red = SIM.Reduce(None if mesh is None else axis_name)
        gen_t = torch.Generator(device=dev).manual_seed(seed)
        pop = cma_init_t(gen_t, dim, n_particles)
        pop = CMAStateT(**{k: _block(getattr(pop, k), shard).clone()
                           for k in CMAStateT.__dataclass_fields__})
        total, gen = 0, 0
        while total < max_evals:
            pop = cma_generation_t(pop, gen_t, f, lam_c, shard=shard)
            pop = restart_collapsed(pop, gen_t, shard=shard)
            gen += 1
            if swarm and gen % migrate_every == 0:
                pop = migrate(pop, red)
            total += n_particles * lam_c
        bf, bx = pop.best_f, pop.best_x
        if mesh is not None:
            bf = RT.all_gather(bf, axis_name, tiled=True)
            bx = RT.all_gather(bx, axis_name, tiled=True)
    bf = bf.cpu().numpy()
    i = int(np.argmin(bf))
    return float(bf[i]), bx[i].cpu().numpy(), total


def success_rate_torch(f, dim, n_runs, max_evals, *, n_particles=4,
                       swarm=True, f_target=1e-2, seed0=0,
                       device="cuda", mesh=None) -> float:
    """The fraction of ``n_runs`` seeded runs whose best value falls below
    ``f_target`` (``mesh``: each run's population sharded over its
    "fleet" axis, as in :func:`ps_cma_es_torch`)."""
    ok = 0
    for r in range(n_runs):
        bf, _, _ = ps_cma_es_torch(f, dim, n_particles, max_evals,
                                   seed=seed0 + r, swarm=swarm,
                                   device=device, mesh=mesh)
        ok += bf < f_target
    return ok / n_runs
