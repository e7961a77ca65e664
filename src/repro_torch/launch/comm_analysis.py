"""Collective accounting of a distributed step: the port's counterpart of
``repro``'s ``launch/hlo_analysis.py`` (its collective reports) and of
``launch/dryrun.py``'s ``collective_bytes``.

``repro`` reads its collectives out of the compiled HLO text of a step.
The port has no HLO: its input is the ledger that ``core/runtime.py``
keeps while :func:`runtime.count_collectives` is open (one entry per
collective this rank issued, with its kind spelled as in HLO, its group
size and its result bytes), and, on the card, a ``torch.profiler`` trace
of the same step. The functions keep ``repro``'s names and return keys.

Where the two differ:

* one ledger covers what ran, HLO what was compiled. ``repro``'s reuse
  step issues the update exchange every step and its rebuild exchange in
  a ``lax.cond`` branch (HLO: conditional); the port picks the branch on
  the host and issues only the chosen one's collectives, the rebuild's
  inside :func:`runtime.conditional`. So ``repro``'s
  ``unconditional_wire_bytes`` is the port's update step's permute
  bytes, and its ``conditional_wire_bytes`` the port's full step's
  conditional ones;
* XLA drops a collective whose result nothing reads and may merge
  several into one tuple op (counts differ, bytes do not); the port
  issues each tensor's collective as the code asks for it;
* a ``psum`` over a tuple of axes is one all-reduce over the product
  group in HLO and one per axis in the port;
* ``analyze`` and ``parse_hlo`` read XLA text; the dry-run's
  counterpart measures the step itself (``launch/cost_analysis.py``).
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, List

from repro_torch.core import runtime as RT

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute", "collective-broadcast")


def work_counters() -> Dict[str, Callable[[], int]]:
    """The work a ledger brackets each exchange with: B1's kernel launches
    (``kernels/cell_pair/cell_pair.LAUNCHES``) and the pair passes of
    either path (``core/interactions.PAIR_PASSES``)."""
    from repro_torch.core import interactions as I
    from repro_torch.kernels.cell_pair import cell_pair as CP
    return {"b1_launches": lambda: CP.LAUNCHES,
            "pair_passes": lambda: I.PAIR_PASSES}


@contextlib.contextmanager
def ledger():
    """``runtime.count_collectives`` with :func:`work_counters`."""
    with RT.count_collectives(work_counters()) as led:
        yield led


def _entries(led) -> List[RT.Collective]:
    return list(getattr(led, "entries", led))


def _name(e: RT.Collective) -> str:
    return f"{e.kind}.{e.seq}"


def collective_bytes(led) -> Dict[str, float]:
    """Per-rank communicated bytes per collective kind, ``repro``'s ring
    cost model (``launch/dryrun.py``): an all-reduce counts 2x its result
    bytes, every other kind its result bytes; ``_counts`` holds the
    number of each. ``_peer`` adds what this rank actually sent to other
    ranks (0 at world 1: a self-edge is a copy)."""
    out = {k: 0.0 for k in _COLLECTIVES}
    counts = {k: 0 for k in _COLLECTIVES}
    peer = {k: 0.0 for k in _COLLECTIVES}
    for e in _entries(led):
        out[e.kind] += (2.0 if e.kind == "all-reduce" else 1.0) \
            * e.result_bytes
        counts[e.kind] += 1
        peer[e.kind] += e.peer_bytes
    out["_counts"] = counts
    out["_peer"] = peer
    return out


def all_to_all_report(led) -> Dict[str, object]:
    """Every all-to-all with the wire bytes it moves per rank
    (``hlo_analysis.all_to_all_report``): entries ``{name, count,
    group_size, result_bytes, wire_bytes}`` with ``wire = count · result ·
    (g-1)/g``, their ``total_wire_bytes`` and ``max_wire_bytes`` (the
    largest single transpose), and ``peer_bytes``, what left the rank."""
    ops = []
    peer = 0
    for e in _entries(led):
        if e.kind != "all-to-all":
            continue
        g = e.group_size
        frac = (g - 1) / g if g else 1.0
        ops.append({"name": _name(e), "count": 1.0, "group_size": g,
                    "result_bytes": float(e.result_bytes),
                    "wire_bytes": e.result_bytes * frac})
        peer += e.peer_bytes
    return {
        "entry": "ledger",
        "ops": ops,
        "n_all_to_all": len(ops),
        "total_wire_bytes": sum(o["wire_bytes"] for o in ops),
        "max_wire_bytes": max((o["wire_bytes"] for o in ops), default=0.0),
        "peer_bytes": float(peer),
    }


def collective_permute_report(led) -> Dict[str, object]:
    """Every collective permute with its wire bytes per rank
    (``hlo_analysis.collective_permute_report``): a ring permute ships
    its whole buffer, ``wire = count · result``. ``conditional`` marks the
    entries issued inside :func:`runtime.conditional` (the reuse step's
    rebuild branch; ``repro`` marks those reached through a ``lax.cond``
    branch). Returns the entries, ``n_collective_permute``,
    ``total_wire_bytes``, the ``unconditional_wire_bytes`` /
    ``conditional_wire_bytes`` split, ``max_wire_bytes`` and
    ``peer_bytes`` (0 for self-edges)."""
    ops = []
    peer = 0
    for e in _entries(led):
        if e.kind != "collective-permute":
            continue
        ops.append({"name": _name(e), "count": 1.0,
                    "result_bytes": float(e.result_bytes),
                    "wire_bytes": float(e.result_bytes),
                    "conditional": e.conditional})
        peer += e.peer_bytes
    uncond = sum(o["wire_bytes"] for o in ops if not o["conditional"])
    cond = sum(o["wire_bytes"] for o in ops if o["conditional"])
    return {
        "entry": "ledger",
        "ops": ops,
        "n_collective_permute": len(ops),
        "total_wire_bytes": uncond + cond,
        "unconditional_wire_bytes": uncond,
        "conditional_wire_bytes": cond,
        "max_wire_bytes": max((o["wire_bytes"] for o in ops), default=0.0),
        "peer_bytes": float(peer),
    }


def _exchanges(entries: List[RT.Collective]) -> List[Dict[str, object]]:
    """The permute batches (one ``ppermute_many_start`` each), in issue
    order, with the work that ran while each was in flight."""
    by_batch: Dict[int, List[RT.Collective]] = {}
    for e in entries:
        if e.kind == "collective-permute" and e.batch is not None:
            by_batch.setdefault(e.batch, []).append(e)
    out = []
    for b, es in sorted(by_batch.items()):
        first = es[0]
        work = {}
        if first.work_wait is not None:
            work = {k: first.work_wait[k] - first.work_start.get(k, 0)
                    for k in first.work_wait}
        out.append({
            "batch": b, "first_seq": first.seq,
            "conditional": first.conditional,
            "n_permutes": len(es),
            "result_bytes": float(sum(e.result_bytes for e in es)),
            "peer_bytes": float(sum(e.peer_bytes for e in es)),
            "host_ms_in_flight": (None if first.t_wait is None else
                                  (first.t_wait - first.t_start) * 1e3),
            "work_in_flight": work})
    return out


def _interval_overlap(a0: float, a1: float, spans) -> float:
    """Length of [a0, a1] covered by the union of ``spans``."""
    total, at = 0.0, a0
    for s0, s1 in sorted(spans):
        lo, hi = max(s0, at), min(s1, a1)
        if hi > lo:
            total += hi - lo
            at = hi
    return total


def _trace_events(trace) -> List[Dict[str, object]]:
    """Events of a ``torch.profiler.profile`` (or a list of dicts with
    ``name``, ``start_us``, ``end_us``, ``device`` "cpu" or "cuda" and,
    for CPU ops, ``kernels`` [(name, us)]) as dicts."""
    if isinstance(trace, (list, tuple)):
        return [dict(e) for e in trace]
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in trace.events():
        dev = "cuda" if e.device_type == cuda else "cpu"
        out.append({"name": e.name, "start_us": float(e.time_range.start),
                    "end_us": float(e.time_range.end), "device": dev,
                    "kernels": [(k.name, float(k.duration))
                                for k in getattr(e, "kernels", [])]})
    return out


def trace_overlap(trace) -> Dict[str, object]:
    """What a profiler trace of a step shows of its exchanges.

    * In flight: the CPU ops issued inside each :data:`runtime.
      IN_FLIGHT_RANGE` range (a split-phase exchange's start to its
      wait), and the device kernels they launched (their time, and B1's
      launches by name);
    * NCCL: each NCCL kernel's device interval and the device time of
      the compute kernels inside it (compute overlapped with the wire);
      and c10d's device-side ranges of the collectives (``nccl:<op>``),
      which at world 1 hold a device-to-device copy and no NCCL kernel.

    On the device side the profiler also records annotation ranges (the
    collectives', and :data:`runtime.IN_FLIGHT_RANGE`); they are not
    compute, and neither are copies (``Memcpy``, ``Memset``)."""
    ev = _trace_events(trace)
    ranges = [(e["start_us"], e["end_us"]) for e in ev
              if e["device"] == "cpu" and e["name"] == RT.IN_FLIGHT_RANGE]
    ops_in = kernels_in = b1_in = 0
    k_us_in = 0.0
    for e in ev:
        if e["device"] != "cpu" or e["name"] == RT.IN_FLIGHT_RANGE:
            continue
        if any(r0 <= e["start_us"] < r1 for r0, r1 in ranges):
            ops_in += 1
            for name, us in e.get("kernels", []):
                kernels_in += 1
                k_us_in += us
                b1_in += "cell_pair" in name
    dev = [e for e in ev if e["device"] == "cuda"]
    colls = [e for e in dev if e["name"].startswith("nccl:")]
    nccl = [e for e in dev if "nccl" in e["name"].lower()
            and not e["name"].startswith("nccl:")]
    compute = [(e["start_us"], e["end_us"]) for e in dev
               if "nccl" not in e["name"].lower()
               and e["name"] != RT.IN_FLIGHT_RANGE
               and not e["name"].startswith(("Memcpy", "Memset"))]
    span = lambda es: sum(e["end_us"] - e["start_us"] for e in es) / 1e3
    inside = sum(_interval_overlap(e["start_us"], e["end_us"], compute)
                 for e in nccl)
    return {
        "in_flight_ranges": len(ranges),
        "ops_in_flight": ops_in,
        "kernels_in_flight": kernels_in,
        "b1_kernels_in_flight": b1_in,
        "kernel_ms_in_flight": k_us_in / 1e3,
        "nccl_kernels": len(nccl),
        "nccl_ms": span(nccl),
        "collective_ranges": len(colls),
        "collective_ms": span(colls),
        "compute_ms": sum(b - a for a, b in compute) / 1e3,
        "compute_in_nccl_ms": inside / 1e3,
    }


def overlap_report(led, trace=None) -> Dict[str, object]:
    """Whether a step ran work while its ghost exchanges were in flight
    (``hlo_analysis.overlap_report``, which reads the HLO schedule).

    From the ledger: each permute batch (``exchanges``) with the host time
    between its start and its wait and the work counters' advance in
    between (:func:`work_counters`: B1 launches on the card, pair passes
    on either path). ``independent`` lists ``(first_seq, conditional, pair
    passes)`` of the exchanges under which a pair pass ran (the
    split-phase interior pass), ``dependent`` those under which none did
    (a blocking chain); ``*_bytes`` are their result bytes.
    ``first_permute_index`` is the first permute's sequence number (None
    without one). With ``trace`` (a ``torch.profiler`` run of the same
    step), ``trace`` holds :func:`trace_overlap`."""
    entries = _entries(led)
    ex = _exchanges(entries)
    first = next((e.seq for e in entries if e.kind == "collective-permute"),
                 None)
    indep, dep = [], []
    for x in ex:
        n = x["work_in_flight"].get("pair_passes", 0)
        (indep if n > 0 else dep).append((x["first_seq"],
                                          x["conditional"], n))
    by_seq = {x["first_seq"]: x for x in ex}
    rep = {
        "entry": "ledger",
        "first_permute_index": first,
        "exchanges": ex,
        "independent": indep,
        "dependent": dep,
        "independent_bytes": sum(by_seq[s]["result_bytes"]
                                 for s, _, _ in indep),
        "dependent_bytes": sum(by_seq[s]["result_bytes"] for s, _, _ in dep),
        "pair_passes_in_flight": sum(x["work_in_flight"].get(
            "pair_passes", 0) for x in ex),
        "b1_launches_in_flight": sum(x["work_in_flight"].get(
            "b1_launches", 0) for x in ex),
    }
    if trace is not None:
        rep["trace"] = trace_overlap(trace)
    return rep


def per_step(led, n_steps: int) -> Dict[str, object]:
    """``collective_bytes`` over ``n_steps``: bytes a step per kind,
    ``_counts`` the collectives a step per kind, and ``peer`` the bytes
    a step that reached another rank."""
    cb = collective_bytes(led)
    out: Dict[str, object] = {k: cb[k] / n_steps for k in _COLLECTIVES}
    out["_counts"] = {k: v / n_steps for k, v in cb["_counts"].items()}
    out["peer"] = sum(cb["_peer"].values()) / n_steps
    return out
