"""Steady-state server (port of ``repro.fleet.server``): a bounded
request queue feeding a slot allocator over ONE batched step.

The throughput contract:

  * **join/leave never rebuild.** The server builds one fleet step
    (``fleet.batch.FleetStep``) and steps every batch through it:
    :meth:`FleetServer.step_cache_size` reports how many step signatures
    it has built and stays at 1 across any churn. A request joining slot
    ``i`` is an in-place write of one member's bytes into the ensemble
    (``set_member``); leaving flips the ``active`` mask only.
  * **bounded admission.** ``submit`` blocks (or raises ``queue.Full``)
    once ``queue_cap`` requests wait — backpressure instead of unbounded
    memory growth.
  * **streaming results.** Finished members stream out through the async
    checkpoint writer (io/checkpoint.py, ``block=False``); ``close()`` or
    the context manager joins the writer, so a crash-free exit leaves no
    ``.tmp`` directory behind.

Per-member per-step inputs (e.g. SPH's ``euler`` flag, which follows each
member's own step count) come from each request's ``extras_fn``; the
server stacks them into ``(B,)`` tensors on the ensemble's device each
step. The one host read of a step is the flags, after the step.
"""
from __future__ import annotations

import dataclasses
import queue
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.core import simulation as SIM
from repro_torch.fleet import batch as FB
from repro_torch.fleet.metrics import FleetMetrics
from repro_torch.io import checkpoint as CK


@dataclasses.dataclass
class SimRequest:
    """One simulation to run: an initial serial (1-slab) state, a step
    budget, and optional per-step inputs. ``extras_fn(i)`` returns the
    member's extras for its local step ``i`` (scalars; stacked across the
    batch by the server); ``params`` are per-member physics parameters
    constant over the run."""

    rid: Any
    state: SIM.DistributedParticles
    n_steps: int
    extras_fn: Optional[Callable[[int], Dict[str, Any]]] = None
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class SimResult:
    """What comes back: the final member state (on the ensemble's
    device), how far it ran, and the per-flag maxima over its run
    (nonzero = the member needs a capacity re-provision; siblings are
    unaffected)."""

    rid: Any
    state: SIM.DistributedParticles
    steps_done: int
    flags_max: Dict[str, int]
    wall_s: float


_FLAG_NAMES = ("cell", "neighbor", "bucket", "ghost", "ghost_contract")


@dataclasses.dataclass
class _Slot:
    rid: Any
    extras_fn: Optional[Callable[[int], Dict[str, Any]]]
    n_steps: int
    steps_done: int = 0
    t_join: float = 0.0
    flags_max: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {k: 0 for k in _FLAG_NAMES})


def _to_device(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A small host array on ``dev``. To a card it goes through pinned
    memory without blocking, so the copy waits for nothing queued before
    it."""
    t = torch.from_numpy(np.require(a, requirements="C"))
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


class FleetServer:
    """Steady-state ensemble server over one :class:`fleet.batch.FleetStep`
    of its own.

    ``template`` seeds every empty slot (any valid member state — inactive
    slots still flow through the batched step, masked out).
    ``param_template`` declares the per-member params (every request
    supplies the same keys); ``default_extras`` the extras of empty slots
    and of requests without ``extras_fn``. ``mesh`` other than None is the
    multi-device layer (ROADMAP A14) and raises."""

    def __init__(self, physics, cfg, n_slots: int,
                 template: SIM.DistributedParticles, *, mesh=None,
                 queue_cap: int = 64,
                 out_dir=None, param_template: Optional[Dict[str, Any]] = None,
                 default_extras: Optional[Dict[str, Any]] = None):
        if mesh is not None:
            raise NotImplementedError(
                "FleetServer over a device mesh arrives with the "
                "multi-device layer (ROADMAP A14); pass mesh=None")
        self.physics, self.cfg = physics, cfg
        self.n_slots = int(n_slots)
        self.out_dir = out_dir
        self.default_extras = dict(default_extras or {})
        self._queue: "queue.Queue[SimRequest]" = queue.Queue(maxsize=queue_cap)
        self._slots: Dict[int, Optional[_Slot]] = {
            i: None for i in range(self.n_slots)}
        self._results: List[SimResult] = []
        self.metrics = FleetMetrics(n_slots=self.n_slots)

        dev = T.flatten(template)[0][0].device
        self._device = dev
        params = {k: torch.stack([torch.as_tensor(v, device=dev)]
                                 * self.n_slots)
                  for k, v in (param_template or {}).items()}
        self._ens = FB.stack_members(
            [template] * self.n_slots, params=params,
            active=torch.zeros((self.n_slots,), dtype=torch.bool,
                               device=dev))
        self._step = FB.FleetStep(physics, cfg)

    # -- admission ---------------------------------------------------------
    def submit(self, req: SimRequest, block: bool = True,
               timeout: Optional[float] = None) -> None:
        """Enqueue a request; bounded — blocks or raises ``queue.Full``."""
        self._queue.put(req, block=block, timeout=timeout)
        self.metrics.observe_submit(self._queue.qsize())

    # -- serving loop ------------------------------------------------------
    def _free_slots(self) -> List[int]:
        return [i for i, s in self._slots.items() if s is None]

    def _admit(self) -> None:
        for i in self._free_slots():
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                return
            # join: one member's bytes written into slot i, in place
            FB.set_member(self._ens, i, req.state, True)
            for k, v in req.params.items():
                self._ens.params[k][i] = torch.as_tensor(v)
            self._slots[i] = _Slot(rid=req.rid, extras_fn=req.extras_fn,
                                   n_steps=int(req.n_steps),
                                   t_join=time.perf_counter())

    def _gather_extras(self) -> Dict[str, torch.Tensor]:
        """Stack per-member ``extras_fn`` outputs into (B,) tensors on the
        ensemble's device. Keys must agree across active slots; empty
        slots take the default."""
        names = set()
        per_slot = {}
        for i, s in self._slots.items():
            ex = dict(self.default_extras)
            if s is not None and s.extras_fn is not None:
                ex.update(s.extras_fn(s.steps_done))
            per_slot[i] = ex
            names |= set(ex)
        out = {}
        for k in sorted(names):
            vals = [per_slot[i].get(k, self.default_extras.get(k))
                    for i in range(self.n_slots)]
            if any(v is None for v in vals):
                raise ValueError(
                    f"extras key {k!r} missing on some slots and has no "
                    f"default (give FleetServer default_extras={{{k!r}: ...}})")
            out[k] = _to_device(np.stack([np.asarray(v) for v in vals]),
                                self._device)
        return out

    def _retire(self) -> None:
        for i, s in self._slots.items():
            if s is None or s.steps_done < s.n_steps:
                continue
            state = FB.member_at(self._ens, i)
            res = SimResult(rid=s.rid, state=state, steps_done=s.steps_done,
                            flags_max=dict(s.flags_max),
                            wall_s=time.perf_counter() - s.t_join)
            self._results.append(res)
            if self.out_dir is not None:
                CK.save_particles(f"{self.out_dir}/sim_{s.rid}", state.ps,
                                  step=s.steps_done,
                                  meta={"rid": str(s.rid)}, block=False)
            self._slots[i] = None
            # leave = active-mask flip only; the slot's stale state is
            # masked out of later steps
            self._ens.active[i] = False
            self.metrics.observe_complete(self._queue.qsize())

    def step_once(self) -> int:
        """Admit → one batched step → bookkeeping → retire. Returns the
        number of active members advanced (0 = nothing to do)."""
        self._admit()
        active_slots = [i for i, s in self._slots.items() if s is not None]
        if not active_slots:
            return 0
        extras = self._gather_extras()
        t0 = time.perf_counter()
        self._ens, flags, _ = self._step(self._ens, extras)
        # the step's one host read, which also waits for the step
        fl_host = torch.stack([getattr(flags, k).to(torch.int32)
                               for k in _FLAG_NAMES]).cpu().numpy()
        wall = time.perf_counter() - t0
        for i in active_slots:
            s = self._slots[i]
            s.steps_done += 1
            for j, k in enumerate(_FLAG_NAMES):
                s.flags_max[k] = max(s.flags_max[k], int(fl_host[j, i]))
        self.metrics.observe_step(wall, len(active_slots))
        self._retire()
        return len(active_slots)

    def run(self, max_steps: Optional[int] = None) -> List[SimResult]:
        """Drain: step until the queue and every slot are empty (or
        ``max_steps`` batched steps have run). Returns the results so far
        (also kept on ``self.results``)."""
        n = 0
        while (not self._queue.empty()
               or any(s is not None for s in self._slots.values())):
            if max_steps is not None and n >= max_steps:
                break
            self.step_once()
            n += 1
        return list(self._results)

    # -- results / lifecycle ----------------------------------------------
    @property
    def results(self) -> List[SimResult]:
        return list(self._results)

    def step_cache_size(self) -> int:
        """Step signatures built for this server's fleet step — the
        join/leave-without-rebuild contract is ``== 1`` after any churn."""
        return self._step.cache_size()

    def close(self) -> None:
        """Join the async result writer: after this, no ``.tmp`` remains
        for anything this server streamed out."""
        CK.flush()

    def __enter__(self) -> "FleetServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
