"""Dynamic load balancing (port of ``repro.core.dlb``; paper §3.5).

Two cooperating layers, as in ``repro``:

  * **Cost model and repartitioning.** Per-sub-sub-domain compute costs
    (particle counts or measured times, :func:`ssd_costs_from_positions`)
    feed ``decomposition.rebalance`` on the host. For the adaptive-slab
    decomposition of the data plane, :func:`balanced_bounds` computes
    cost-equalizing slab boundaries from a particle histogram on the
    particles' device, with no host read.
  * **The SAR trigger** (Stop-At-Rise, Moon & Saltz) decides *when* to
    rebalance: when the time-averaged cost of going on with the current
    decomposition starts to rise above the amortized cost of
    re-decomposing (:class:`SARController`, host side).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


# --------------------------------------------------------------------------
# The adaptive-slab balancer, on tensors
# --------------------------------------------------------------------------

def _scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a 0-d tensor of ``like``'s dtype on its device: a
    true division by it, where a Python divisor would be a product with
    its reciprocal on the card."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


def balanced_bounds(x_axis: torch.Tensor, valid: torch.Tensor, ndev: int,
                    box_lo: float, box_hi: float, *, nbins: int = 256,
                    weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Cost-equalizing slab boundaries (ndev+1,) float32 from a weighted
    histogram of particle slab-coordinates (on their device)."""
    one = torch.ones_like(x_axis) if weights is None else weights
    w = torch.where(valid, one, torch.zeros_like(one))
    hist = histogram_cost(x_axis, w, box_lo, box_hi, nbins)
    return bounds_from_histogram(hist, ndev, box_lo, box_hi)


def histogram_cost(x_axis: torch.Tensor, w: torch.Tensor, box_lo: float,
                   box_hi: float, nbins: int) -> torch.Tensor:
    """(nbins,) float32 sums of ``w`` over equal bins of [box_lo,
    box_hi); coordinates outside fall into the edge bins."""
    frac = (x_axis - box_lo) / _scalar(box_hi - box_lo, x_axis)
    idx = torch.clamp((frac * nbins).to(torch.int32), 0, nbins - 1)
    hist = torch.zeros(nbins, dtype=torch.float32, device=x_axis.device)
    return hist.index_add_(0, idx, w.to(torch.float32))


def bounds_from_histogram(hist: torch.Tensor, ndev: int, box_lo: float,
                          box_hi: float) -> torch.Tensor:
    """Invert the cumulative cost to equal-cost quantile boundaries, with
    linear interpolation within bins (no degenerate empty slabs)."""
    nbins = hist.shape[0]
    # a tiny uniform floor keeps the cumulative strictly increasing (empty
    # regions get geometrically proportional slabs, not zero width)
    hist = hist + torch.clamp(hist.sum(), min=1.0) * (1e-6 / nbins)
    cum = torch.cat([hist.new_zeros(1), torch.cumsum(hist, 0)])
    total = cum[-1]
    targets = total * torch.arange(1, ndev, device=hist.device).to(
        hist.dtype) / _scalar(ndev, hist)
    hi_idx = torch.clamp(torch.searchsorted(cum, targets, side="left"), 1,
                         nbins)
    c0 = cum[hi_idx - 1]
    c1 = cum[hi_idx]
    frac = (targets - c0) / torch.clamp(c1 - c0, min=1e-30)
    pos_bins = (hi_idx - 1).to(hist.dtype) + frac
    inner = box_lo + pos_bins * ((box_hi - box_lo) / nbins)
    ends = lambda v: torch.full((1,), v, dtype=hist.dtype,
                                device=hist.device)
    return torch.cat([ends(box_lo), inner, ends(box_hi)]).to(torch.float32)


def uniform_bounds(ndev: int, box_lo: float, box_hi: float,
                   device="cpu") -> torch.Tensor:
    """Equal-width slab boundaries (ndev+1,) float32 on ``device``."""
    return torch.linspace(box_lo, box_hi, ndev + 1, dtype=torch.float32,
                          device=device)


def enforce_min_width(bounds: torch.Tensor,
                      min_width: float) -> torch.Tensor:
    """Project slab ``bounds`` onto {every slab >= min_width} while
    keeping the partition of [lo, hi] — the ghost contract (r_ghost <=
    slab width) as a constraint on the balancer. The identity when every
    slab already satisfies it; otherwise thin slabs are floored at
    ``min_width`` and the excess is taken proportionally from the slack of
    the wide ones. With ndev * min_width > the box length it is
    infeasible, and the uniform partition is returned."""
    ndev = bounds.shape[0] - 1
    lo, hi = bounds[0], bounds[-1]
    total = hi - lo
    w = bounds[1:] - bounds[:-1]
    excess = total - ndev * min_width
    slack = torch.clamp(w - min_width, min=0.0)
    scale = excess / torch.clamp(slack.sum(), min=1e-30)
    w_ok = min_width + slack * scale
    w_uniform = (total / _scalar(ndev, total)).expand_as(w)
    w_new = torch.where(excess >= 0.0, w_ok, w_uniform)
    inner = lo + torch.cumsum(w_new, 0)[:-1]
    return torch.cat([bounds[:1], inner, bounds[-1:]])


# --------------------------------------------------------------------------
# SAR heuristic (Stop-At-Rise) — when to rebalance
# --------------------------------------------------------------------------

@dataclasses.dataclass
class SARController:
    """Stop-At-Rise trigger (paper §3.5, ref [56]).

    After each step, feed the observed per-step imbalance cost
    ``I = t_max - t_mean`` (seconds). Let C be the measured cost of one
    re-decomposition. SAR rebalances when the running average

        W(n) = (C + sum_{i<=n} I_i) / n

    stops decreasing — the amortized cost of having rebalanced n steps ago
    has hit its minimum.
    """

    rebalance_cost: float = 0.05
    _sum_imb: float = 0.0
    _n: int = 0
    _w_prev: float = float("inf")

    def observe(self, t_max: float, t_mean: float) -> bool:
        self._sum_imb += max(t_max - t_mean, 0.0)
        self._n += 1
        w = (self.rebalance_cost + self._sum_imb) / self._n
        rise = w > self._w_prev
        self._w_prev = w
        if rise:
            self.reset()
            return True
        return False

    def reset(self) -> None:
        self._sum_imb = 0.0
        self._n = 0
        self._w_prev = float("inf")

    def update_rebalance_cost(self, measured: float, ema: float = 0.5) -> None:
        self.rebalance_cost = ema * measured + (1 - ema) * self.rebalance_cost


# --------------------------------------------------------------------------
# Host-side cost measurement for the graph repartitioner
# --------------------------------------------------------------------------

def ssd_costs_from_positions(dec, x, valid,
                             per_particle_cost: float = 1.0) -> np.ndarray:
    """Per-sub-sub-domain compute cost from particle counts (host side;
    ``x`` and ``valid`` may be tensors on any device or numpy arrays)."""
    host = lambda a: a.detach().cpu().numpy() if isinstance(
        a, torch.Tensor) else np.asarray(a)
    x = host(x)[host(valid)]
    cells = dec.cell_of_position(x)
    counts = np.bincount(cells, minlength=dec.n_ssd).astype(np.float64)
    # a cell with no particles still costs a little (cell-list traversal)
    return per_particle_cost * counts + 0.01
