"""Fleet throughput metrics (port of ``repro.fleet.metrics``) — one JSON
schema for the server, benchmarks and dashboards.

The server (fleet/server.py) feeds a :class:`FleetMetrics` as it
runs; ``snapshot()`` renders the counters, gauges and rates into a plain
dict under the :data:`SCHEMA` tag, and :func:`emit` writes that dict as
JSON. The schema and its keys are ``repro``'s, so a reader of one reads
the other.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import sys
import time
from typing import Dict, List, Optional

#: Schema tag stamped into every emitted payload. Bump on breaking change.
SCHEMA = "repro-fleet-metrics/v1"


@dataclasses.dataclass
class FleetMetrics:
    """Running counters of a fleet (all host-side, no device sync beyond
    what the caller already does to observe a step).

    Counters: ``fleet_steps`` (batched step launches), ``member_steps``
    (active members advanced, summed over steps), ``sims_submitted`` /
    ``sims_completed`` (requests through the queue). Gauges:
    ``queue_depth``, ``slots_active``. Per-step wall times accumulate for
    the rate/percentile summary."""

    n_slots: int
    fleet_steps: int = 0
    member_steps: int = 0
    sims_submitted: int = 0
    sims_completed: int = 0
    queue_depth: int = 0
    slots_active: int = 0
    step_wall_s: List[float] = dataclasses.field(default_factory=list)
    t0: float = dataclasses.field(default_factory=time.perf_counter)

    # -- observers ---------------------------------------------------------
    def observe_step(self, wall_s: float, n_active: int) -> None:
        self.fleet_steps += 1
        self.member_steps += int(n_active)
        self.slots_active = int(n_active)
        self.step_wall_s.append(float(wall_s))

    def observe_submit(self, queue_depth: int) -> None:
        self.sims_submitted += 1
        self.queue_depth = int(queue_depth)

    def observe_complete(self, queue_depth: int) -> None:
        self.sims_completed += 1
        self.queue_depth = int(queue_depth)

    # -- rendering ---------------------------------------------------------
    def snapshot(self) -> Dict:
        """The schema'd dict: counters + gauges + derived rates."""
        elapsed = max(time.perf_counter() - self.t0, 1e-9)
        walls = sorted(self.step_wall_s)
        n = len(walls)
        return {
            "schema": SCHEMA,
            "elapsed_s": elapsed,
            "counters": {
                "fleet_steps": self.fleet_steps,
                "member_steps": self.member_steps,
                "sims_submitted": self.sims_submitted,
                "sims_completed": self.sims_completed,
            },
            "gauges": {
                "queue_depth": self.queue_depth,
                "slots_active": self.slots_active,
                "n_slots": self.n_slots,
                "slot_occupancy": (self.slots_active / self.n_slots
                                   if self.n_slots else 0.0),
            },
            "rates": {
                "steps_per_sec": self.fleet_steps / elapsed,
                "member_steps_per_sec": self.member_steps / elapsed,
                "sims_per_sec": self.sims_completed / elapsed,
            },
            "step_wall_s": {
                "mean": (sum(walls) / n) if n else 0.0,
                "p50": walls[n // 2] if n else 0.0,
                "max": walls[-1] if n else 0.0,
            },
        }


def emit(path, snapshot: Dict, *, rows: Optional[List[Dict]] = None,
         caveat: Optional[str] = None) -> None:
    """Write a schema'd payload as JSON. ``rows`` attaches benchmark CSV
    rows (name/us_per_call/derived dicts); ``caveat`` travels with the
    numbers so a consumer cannot miss it. Emitting must never kill the
    run — I/O errors are reported to stderr and swallowed."""
    payload = dict(snapshot)
    payload.setdefault("schema", SCHEMA)
    if rows is not None:
        payload["rows"] = rows
    if caveat is not None:
        payload["caveat"] = caveat
    out = pathlib.Path(path)
    try:
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(payload, indent=2) + "\n")
    except OSError as e:
        print(f"fleet.metrics: could not write {out}: {e}", file=sys.stderr)
