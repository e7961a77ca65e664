"""ParticleSet — the particle container (port of ``repro.core.particles``).

OpenFPM's ``vector_dist`` (paper §3.1) holds positions plus an aggregate
of properties. As in the JAX package, the set has a fixed capacity with a
``valid`` slot mask, invalid slots hold the ``FILL`` sentinel coordinate,
and properties are a dict of tensors with leading dim ``capacity``. The
container is a frozen dataclass of tensors; updates return new sets.

Every tensor carries its device explicitly. Constructors take a
``device``; asking for ``"cuda"`` where no card is visible raises
:class:`RuntimeError` (:func:`resolve_device`) — there is no CPU fallback.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Mapping

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def const_tensor(values: tuple, dtype: torch.dtype,
                 device: torch.device) -> torch.Tensor:
    """A small constant tensor (box bounds, grid strides, ...) kept on
    ``device``. Cached per value, so a step never copies it from the host
    again: a copy from pageable host memory would wait for the stream.
    Callers must not modify the result."""
    return torch.tensor(values, dtype=dtype, device=device)


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; raises RuntimeError for a CUDA
    device when CUDA is not available (never falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    return dev


@dataclasses.dataclass(frozen=True)
class ParticleSet:
    """Fixed-capacity particle set.

    Attributes:
      x:     (cap, dim) positions. Invalid slots hold ``FILL``.
      props: dict of tensors with leading dim cap.
      valid: (cap,) bool slot-occupancy mask.
    """

    x: torch.Tensor
    props: Dict[str, torch.Tensor]
    valid: torch.Tensor

    FILL = 1.0e30

    # -- structure ---------------------------------------------------------
    @property
    def capacity(self) -> int:
        return self.x.shape[0]

    @property
    def dim(self) -> int:
        return self.x.shape[1]

    @property
    def device(self) -> torch.device:
        return self.x.device

    def count(self) -> torch.Tensor:
        return self.valid.sum()

    # -- functional updates --------------------------------------------------
    def replace(self, **kw) -> "ParticleSet":
        return dataclasses.replace(self, **kw)

    def with_prop(self, name: str, value: torch.Tensor) -> "ParticleSet":
        props = dict(self.props)
        props[name] = value
        return self.replace(props=props)

    def masked_x(self) -> torch.Tensor:
        """Positions with invalid slots pushed to the FILL sentinel."""
        return torch.where(self.valid[:, None], self.x,
                           torch.full_like(self.x, self.FILL))

    def compact(self) -> "ParticleSet":
        """Stable-sort valid slots to the front (paper §3.6)."""
        order = torch.argsort((~self.valid).to(torch.int8), stable=True)
        return self.gather(order)

    def gather(self, idx: torch.Tensor) -> "ParticleSet":
        return ParticleSet(x=self.x[idx],
                           props={k: a[idx] for k, a in self.props.items()},
                           valid=self.valid[idx])

    def where(self, keep: torch.Tensor) -> "ParticleSet":
        """Invalidate slots where ``keep`` is False (particle removal)."""
        return self.replace(valid=self.valid & keep)

    def add(self, other: "ParticleSet") -> "ParticleSet":
        """Insert ``other``'s valid particles into this set's free slots, in
        index order; the surplus is dropped (see :meth:`add_count`)."""
        ps, _ = self.add_count(other)
        return ps

    def add_count(self, other: "ParticleSet"):
        cap = self.capacity
        free = ~self.valid
        inc_rank = torch.cumsum(other.valid.to(torch.int64), 0) - 1
        n_free = free.sum()
        n_inc = other.valid.sum()
        # free slot indices in index order first (stable sort of ~free);
        # entries past n_free are never selected below
        free_slots = torch.argsort((~free).to(torch.int8), stable=True)
        take = other.valid & (inc_rank < n_free)
        dest = torch.where(take, free_slots[inc_rank.clamp(0, cap - 1)],
                           torch.full_like(inc_rank, cap))

        def scat(dst_arr, src_arr):
            # destination ``cap`` is a dump row, sliced off: the drop mode
            buf = torch.cat([dst_arr, dst_arr[:1]], 0)
            buf[dest] = src_arr
            return buf[:cap]

        new_x = scat(self.x, other.x)
        new_props = {k: scat(self.props[k], other.props[k])
                     for k in self.props}
        new_valid = scat(self.valid, torch.ones_like(other.valid))
        overflow = torch.clamp(n_inc - n_free, min=0)
        return ParticleSet(x=new_x, props=new_props, valid=new_valid), overflow


def zeros_like_props(prop_specs: Mapping[str, Any], cap: int,
                     device) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros((cap,) + tuple(shape), dtype=dtype, device=device)
            for k, (shape, dtype) in prop_specs.items()}


def empty(capacity: int, dim: int, prop_specs: Mapping[str, Any],
          dtype=torch.float32, device="cuda") -> ParticleSet:
    """An all-invalid particle set. ``prop_specs`` maps name -> (shape,
    dtype) for per-particle property trailing shapes."""
    dev = resolve_device(device)
    return ParticleSet(
        x=torch.full((capacity, dim), ParticleSet.FILL, dtype=dtype,
                     device=dev),
        props=zeros_like_props(prop_specs, capacity, dev),
        valid=torch.zeros((capacity,), dtype=torch.bool, device=dev))


def from_positions(x: torch.Tensor, capacity: int | None = None,
                   prop_specs: Mapping[str, Any] | None = None,
                   props: Dict[str, torch.Tensor] | None = None
                   ) -> ParticleSet:
    """Build a ParticleSet from dense positions (n, dim) on ``x``'s device,
    padding to capacity."""
    n, dim = x.shape
    dev = x.device
    cap = capacity or n
    if cap < n:
        raise ValueError(f"capacity {cap} < n {n}")
    pad = cap - n
    xx = torch.cat([x, torch.full((pad, dim), ParticleSet.FILL,
                                  dtype=x.dtype, device=dev)], 0)
    valid = torch.cat([torch.ones(n, dtype=torch.bool, device=dev),
                       torch.zeros(pad, dtype=torch.bool, device=dev)])
    p: Dict[str, torch.Tensor] = {}
    for k, v in (props or {}).items():
        v = torch.as_tensor(v, device=dev)
        p[k] = torch.cat([v, torch.zeros((pad,) + tuple(v.shape[1:]),
                                         dtype=v.dtype, device=dev)], 0)
    for k, (shape, dtype) in (prop_specs or {}).items():
        if k not in p:
            p[k] = torch.zeros((cap,) + tuple(shape), dtype=dtype, device=dev)
    return ParticleSet(x=xx, props=p, valid=valid)


def init_grid(domain_low, domain_high, sz, capacity: int | None = None,
              prop_specs: Mapping[str, Any] | None = None,
              dtype=torch.float32, jitter: float = 0.0,
              generator: torch.Generator | None = None,
              device="cuda") -> ParticleSet:
    """OpenFPM's ``Init_grid`` (Listing 4.1 line 37): particles on a regular
    Cartesian lattice inside the box. The lattice is built in float64 numpy
    and then cast, so it matches ``repro.core.particles.init_grid``
    bitwise. ``jitter`` draws from ``generator`` on the CPU (it does not
    reproduce ``jax.random``)."""
    dev = resolve_device(device)
    sz = tuple(int(s) for s in sz)
    dim = len(sz)
    lo = np.asarray(domain_low, np.float64)
    hi = np.asarray(domain_high, np.float64)
    axes = [lo[d] + (np.arange(sz[d]) + 0.5) * (hi[d] - lo[d]) / sz[d]
            for d in range(dim)]
    pts = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).reshape(-1, dim)
    x = torch.from_numpy(pts).to(dtype)
    if jitter > 0.0:
        u = torch.rand(x.shape, generator=generator, dtype=dtype)
        x = x + jitter * (2.0 * u - 1.0)
    return from_positions(x.to(dev), capacity=capacity, prop_specs=prop_specs)
