"""Simulation domain description: boxes, boundary conditions, ghost widths
(the port's own copy of ``repro.core.domain``, which is NumPy only).

This is the OpenFPM ``Box<dim, T>`` / ``Ghost<dim, T>`` / boundary-condition
triple (paper Listing 4.1, lines 28-30), rendered as plain dataclasses. These
objects are *control plane*: hashable static configuration read when a step
is built, never device values.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np

PERIODIC = "periodic"
NON_PERIODIC = "non_periodic"


@dataclasses.dataclass(frozen=True)
class Box:
    """Axis-aligned box in ``dim`` dimensions (arbitrary dim, like OpenFPM)."""

    low: Tuple[float, ...]
    high: Tuple[float, ...]

    def __post_init__(self):
        if len(self.low) != len(self.high):
            raise ValueError("low/high dimensionality mismatch")
        if any(h <= l for l, h in zip(self.low, self.high)):
            raise ValueError(f"degenerate box {self.low}..{self.high}")

    @property
    def dim(self) -> int:
        return len(self.low)

    @property
    def lengths(self) -> np.ndarray:
        return np.asarray(self.high, np.float64) - np.asarray(self.low, np.float64)

    @property
    def volume(self) -> float:
        return float(np.prod(self.lengths))

    def contains(self, x: np.ndarray) -> np.ndarray:
        lo = np.asarray(self.low)
        hi = np.asarray(self.high)
        return np.all((x >= lo) & (x < hi), axis=-1)

    @staticmethod
    def unit(dim: int) -> "Box":
        return Box((0.0,) * dim, (1.0,) * dim)


@dataclasses.dataclass(frozen=True)
class Ghost:
    """Ghost (halo) layer width — the particle interaction radius or stencil
    radius (paper Fig. 1, shaded area)."""

    width: float

    def __post_init__(self):
        if self.width < 0:
            raise ValueError("ghost width must be >= 0")


@dataclasses.dataclass(frozen=True)
class BoundaryConditions:
    """Per-axis boundary conditions."""

    kinds: Tuple[str, ...]

    def __post_init__(self):
        for k in self.kinds:
            if k not in (PERIODIC, NON_PERIODIC):
                raise ValueError(f"unknown bc kind {k!r}")

    @property
    def dim(self) -> int:
        return len(self.kinds)

    @property
    def periodic_mask(self) -> np.ndarray:
        return np.asarray([k == PERIODIC for k in self.kinds])

    @staticmethod
    def periodic(dim: int) -> "BoundaryConditions":
        return BoundaryConditions((PERIODIC,) * dim)

    @staticmethod
    def non_periodic(dim: int) -> "BoundaryConditions":
        return BoundaryConditions((NON_PERIODIC,) * dim)


@dataclasses.dataclass(frozen=True)
class Domain:
    """Box + boundary conditions + ghost width: the full spatial context a
    distributed data structure is defined over."""

    box: Box
    bc: BoundaryConditions
    ghost: Ghost

    def __post_init__(self):
        if self.box.dim != self.bc.dim:
            raise ValueError("box/bc dimensionality mismatch")

    @property
    def dim(self) -> int:
        return self.box.dim

    def wrap(self, x: np.ndarray) -> np.ndarray:
        """Wrap positions into the box on periodic axes (numpy, host-side)."""
        lo = np.asarray(self.box.low)
        lengths = self.box.lengths
        mask = self.bc.periodic_mask
        wrapped = lo + np.mod(x - lo, lengths)
        return np.where(mask, wrapped, x)


def make_domain(
    low: Sequence[float],
    high: Sequence[float],
    bc: Sequence[str] | None = None,
    ghost: float = 0.0,
) -> Domain:
    """Convenience constructor mirroring the OpenFPM client-code idiom."""
    low_t = tuple(float(v) for v in low)
    high_t = tuple(float(v) for v in high)
    if bc is None:
        bc = (NON_PERIODIC,) * len(low_t)
    return Domain(Box(low_t, high_t), BoundaryConditions(tuple(bc)), Ghost(float(ghost)))
