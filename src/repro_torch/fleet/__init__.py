"""Fleet engine (port of ``repro.fleet``) — batched ensemble simulation and
steady-state serving.

Ensembles — parameter sweeps, Monte-Carlo repetitions, interactive
runs — are many independent fixed-capacity simulations, not one giant
run. The fleet layer turns the serial engine (core/simulation.py) into a
throughput machine:

  * :mod:`repro_torch.fleet.batch`   — the :class:`EnsembleState`
    container and :func:`make_fleet_step`: the serial step under
    ``torch.func.vmap`` over a batch axis, one B1 launch per pair pass for
    the whole fleet. Serial single-sim is the batch=1 case.
  * :mod:`repro_torch.fleet.server`  — the server: bounded request
    queue in, slot allocator over ONE batched step (join/leave via
    in-place slot writes and the active mask, never a rebuild), results
    streamed out through the async checkpoint writer.
  * :mod:`repro_torch.fleet.metrics` — throughput counters behind
    ``repro``'s JSON schema.
"""
from repro_torch.fleet.batch import (EnsembleState, make_fleet_step,
                                     member_at, set_member, stack_members)
from repro_torch.fleet.metrics import FleetMetrics
from repro_torch.fleet.server import FleetServer, SimRequest, SimResult

__all__ = [
    "EnsembleState", "make_fleet_step", "member_at", "set_member",
    "stack_members", "FleetMetrics", "FleetServer", "SimRequest",
    "SimResult",
]
