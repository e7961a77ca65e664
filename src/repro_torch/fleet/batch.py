"""Batched ensemble simulation — the fleet container and its step (port of
``repro.fleet.batch``; DESIGN.md §11).

The simulation engine (core/simulation.py) is fixed-capacity, so a batch
of independent simulations is one more leading axis:
:class:`EnsembleState` stacks ``B`` :class:`~repro_torch.core.simulation.
DistributedParticles` members leaf-wise, and :func:`make_fleet_step` runs
the serial step (``simulation.make_serial_step_fn``) under
``torch.func.vmap`` over that axis — every op of the step runs once for
the whole fleet. The cell-pair kernel (B1) is an operator with a batching
rule (``kernels/cell_pair``): the members' tiles fold into its cell axis,
so a fleet step makes ONE B1 launch per pair pass for all ``B`` members.
Serial single-sim is the batch=1 case of the same composition.

Per-member semantics, as in ``repro``:
  * per-member physics *parameters* ride in ``EnsembleState.params`` —
    ``(B, ...)`` tensors merged into each member's ``extras`` (they
    override ``extras`` keys);
  * per-member :class:`~repro_torch.core.simulation.StepFlags` with
    ``(B,)`` leaves: one member overflowing its capacity shows on its own
    row and leaves its siblings' trajectories untouched;
  * the ``active`` mask gates updates member-wise: inactive slots pass
    through with zeroed flags and scalars, which lets the server
    (fleet/server.py) join and leave simulations without a rebuild.

The mesh-sharded batch axis (``repro``'s ``shard_map`` over a device
mesh) is the multi-device layer, ROADMAP A14.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Sequence

import torch

from repro_torch import tree as T
from repro_torch.core import simulation as SIM


# --------------------------------------------------------------------------
# The container
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EnsembleState:
    """A batch of simulations: every leaf of ``member`` carries a leading
    batch axis ``B`` (slot-major; slot = one simulation). ``params`` holds
    per-member physics parameters (``(B, ...)`` tensors) merged into each
    member's ``extras``; ``active`` is the ``(B,)`` bool slot-occupancy
    mask — the batch-axis mirror of ``ParticleSet.valid``."""

    member: SIM.DistributedParticles
    params: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    active: torch.Tensor = None  # (B,) bool

    @property
    def batch(self) -> int:
        return self.active.shape[0]


def _device_of(state) -> torch.device:
    return T.flatten(state)[0][0].device


def stack_members(states: Sequence[SIM.DistributedParticles],
                  params: Optional[Dict[str, Any]] = None,
                  active=None) -> EnsembleState:
    """Stack per-simulation states (identical capacities and structure)
    into one :class:`EnsembleState` on the members' device."""
    if not states:
        raise ValueError("empty ensemble")
    member = T.tree_map(lambda *xs: torch.stack(xs), *states)
    dev = _device_of(states[0])
    B = len(states)
    if active is None:
        active = torch.ones((B,), dtype=torch.bool, device=dev)
    return EnsembleState(
        member=member,
        params={k: torch.as_tensor(v, device=dev)
                for k, v in (params or {}).items()},
        active=torch.as_tensor(active, dtype=torch.bool, device=dev))


def member_at(ens: EnsembleState, i: int) -> SIM.DistributedParticles:
    """Member ``i``'s state, copied out of the ensemble (a later
    :func:`set_member` of slot ``i`` does not reach it)."""
    return T.tree_map(lambda a: a[i].clone(), ens.member)


def set_member(ens: EnsembleState, i: int, state: SIM.DistributedParticles,
               active=True) -> EnsembleState:
    """Write member ``i`` (join or replace a slot) IN PLACE: one member's
    bytes are copied into slot ``i`` of every ensemble tensor, and
    ``active[i]`` is set. Returns ``ens`` (the same tensors)."""
    T.tree_map(lambda a, s: a[i].copy_(s), ens.member, state)
    ens.active[i] = bool(active)
    return ens


def shard_ensemble(ens: EnsembleState, mesh, axis_name: str = "fleet"
                   ) -> EnsembleState:
    """The batch axis sharded over a device mesh is the multi-device
    layer (ROADMAP A14)."""
    raise NotImplementedError(
        "shard_ensemble (the fleet's batch axis over a device mesh) arrives "
        "with the multi-device layer (ROADMAP A14)")


# --------------------------------------------------------------------------
# The batched step
# --------------------------------------------------------------------------

def _mask_tail(active: torch.Tensor):
    """Member-wise select with the mask broadcast over trailing dims."""
    def sel(new, old):
        m = active.reshape(active.shape + (1,) * (new.dim() - 1))
        return torch.where(m, new, old)
    return sel


def broadcast_extras(extras: Dict[str, Any],
                     batch: int) -> Dict[str, torch.Tensor]:
    """Lift shared per-step extras (e.g. SPH's ``euler`` flag, the same
    for every member) to the fleet convention: every extras entry carries
    a leading ``(B,)`` batch axis. (The fleet step moves entries that are
    not on the ensemble's device there.)"""
    out = {}
    for k, v in extras.items():
        t = torch.as_tensor(v)
        out[k] = t[None].expand((batch,) + tuple(t.shape))
    return out


def _signature(leaves) -> tuple:
    return tuple((tuple(t.shape), t.dtype, t.device) for t in leaves)


class FleetStep:
    """``fleet_step(ens, extras) -> (ens, flags, scalars)`` (see
    :func:`make_fleet_step`). :meth:`cache_size` counts the distinct input
    signatures (structure, shapes, dtypes, devices, extras keys) it has
    stepped — what a jit cache would hold; a server's joins and leaves
    keep it at 1."""

    def __init__(self, physics, cfg, slab_axis: int = 0):
        self._step_fn = SIM.make_serial_step_fn(physics, cfg,
                                                slab_axis=slab_axis)
        self._signatures = set()

    def cache_size(self) -> int:
        return len(self._signatures)

    def __call__(self, ens: EnsembleState, extras: Dict[str, Any]):
        merged = {**extras, **ens.params}
        keys = tuple(sorted(merged))
        m_leaves, m_def = T.flatten(ens.member)
        dev = m_leaves[0].device
        vals = [torch.as_tensor(merged[k], device=dev) for k in keys]
        self._signatures.add((m_def, keys, _signature(m_leaves),
                              _signature(vals)))
        out_def = []

        def member_step(m_leaves, vals):
            member = T.unflatten(m_def, m_leaves)
            out = self._step_fn(member, dict(zip(keys, vals)))
            leaves, d = T.flatten(out)
            out_def.append(d)
            return leaves

        leaves = torch.func.vmap(member_step)(m_leaves, vals)
        stepped, flags, scalars = T.unflatten(out_def[0], leaves)
        sel = _mask_tail(ens.active)
        member = T.tree_map(sel, stepped, ens.member)
        flags = T.tree_map(
            lambda f: torch.where(ens.active, f, torch.zeros_like(f)), flags)
        scalars = T.tree_map(lambda s: sel(s, torch.zeros_like(s)), scalars)
        return dataclasses.replace(ens, member=member), flags, scalars


@functools.lru_cache(maxsize=None)
def make_fleet_step(physics, cfg, mesh=None, *,
                    slab_axis: int = 0) -> FleetStep:
    """Build the batched step for a fleet of ``physics(cfg)`` simulations
    (cached on its arguments).

    Returns ``fleet_step(ens, extras) -> (ens, flags, scalars)`` over an
    :class:`EnsembleState`:

      * every ``extras`` entry carries a leading ``(B,)`` batch axis —
        member ``b`` sees row ``b`` (:func:`broadcast_extras` lifts values
        shared by the fleet); ``ens.params`` entries are merged the same
        way and override ``extras`` keys;
      * ``flags`` is a :class:`~repro_torch.core.simulation.StepFlags`
        with ``(B,)`` leaves — per-member overflow, zeroed on inactive
        slots;
      * ``scalars`` leaves gain a leading ``(B,)`` axis, zeroed on
        inactive slots.

    The step runs eagerly and out of place (``repro``'s jit with buffer
    donation has no counterpart here). ``mesh`` other than None is the
    multi-device layer (ROADMAP A14) and raises."""
    if mesh is not None:
        raise NotImplementedError(
            "make_fleet_step over a device mesh arrives with the "
            "multi-device layer (ROADMAP A14); pass mesh=None")
    return FleetStep(physics, cfg, slab_axis)
