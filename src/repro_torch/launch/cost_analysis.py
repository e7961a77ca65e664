"""What one rank's step costs, measured by running it on ``meta`` tensors:
the port's counterpart of ``repro``'s ``launch/hlo_analysis.analyze``
(and its ``parse_hlo``), which reads FLOPs, bytes and collective bytes
out of a compiled, scan-aware HLO module. The port has no HLO: it runs
the step itself, on a shape-only mesh (``runtime.make_dry_mesh``), under
three instruments:

* FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` (matrix products,
  forward and backward, as ``repro`` counts ``dot`` ops);
* bytes: a dispatch mode that adds every op's tensor inputs and outputs,
  each op on its own (no fusion: an elementwise chain is counted link by
  link, where XLA's CPU fusion or a fused kernel would read and write
  once; ``repro`` notes its own CPU-fusion granularity the same way).
  View and bookkeeping ops (``is_view``, ``detach``, ``empty``...) move
  nothing and are skipped, as ``repro`` skips bitcasts and tuples;
* collective bytes: the ledger ``runtime.count_collectives`` keeps,
  priced by ``launch/comm_analysis.collective_bytes`` (``repro``'s ring
  model: an all-reduce 2× its result).

and a fourth for memory: the peak of live ``meta`` bytes, each storage
counted once from its first appearance to its release (saved
activations are held by the autograd graph, so the mode keeps the
Python tensors they are saved as alive through
``saved_tensors_hooks``).
"""
from __future__ import annotations

import weakref
from typing import Any, Callable, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core import runtime as RT
from repro_torch.launch import comm_analysis as CA

_aten = torch.ops.aten
#: Ops that move no bytes (allocation, metadata).
_FREE = {_aten.empty.memory_format, _aten.empty_like.default,
         _aten.empty_strided.default, _aten.detach.default,
         _aten.lift_fresh.default, _aten.alias.default,
         _aten.zeros.default, _aten.zeros_like.default,
         _aten.ones_like.default, _aten.scalar_tensor.default,
         _aten.arange.default, _aten.arange.start,
         _aten.arange.start_step, _aten.full.default,
         _aten.new_empty.default, _aten.new_zeros.default,
         _aten.new_full.default, _aten._local_scalar_dense.default}


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tensors(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _tensors(t)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Meter(TorchDispatchMode):
    """Bytes every op reads and writes, and the live-storage peak."""

    def __init__(self):
        super().__init__()
        self.bytes = 0.0
        self.bytes_by_op: Dict[str, float] = {}
        self.live = 0
        self.peak = 0
        self._seen: Dict[int, int] = {}

    def track(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage as live until it is released."""
        st = t.untyped_storage()
        key = id(st)
        if key in self._seen:
            return
        n = st.nbytes()
        self._seen[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._release, key)

    def _release(self, key: int) -> None:
        self.live -= self._seen.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func not in _FREE and not func.is_view:
            b = sum(_nbytes(t) for t in _tensors((args, kwargs))) \
                + sum(_nbytes(t) for t in _tensors(out))
            self.bytes += b
            name = func.overloadpacket.__name__
            self.bytes_by_op[name] = self.bytes_by_op.get(name, 0.0) + b
        for t in _tensors(out):
            self.track(t)
        return out


def analyze(step: Callable[[], Any], arguments=()) -> Dict[str, Any]:
    """Run ``step()`` (one rank's step on ``meta`` tensors, on a dry mesh
    in scope) under the instruments; ``arguments`` are the tensors it
    starts from (params, optimizer state, caches, batch), counted as
    live from the start. Returns ``repro``'s keys (``flops``, ``bytes``,
    ``collectives`` with ``_counts``, ``collective_total``,
    ``bytes_by_op``) and ``peak_bytes``."""
    from torch.utils.flop_counter import FlopCounterMode
    meter = _Meter()
    for t in _tensors(arguments):
        meter.track(t)
    flops = FlopCounterMode(display=False)
    # autograd keeps what a pack hook returns: the Python tensor, and
    # with it its storage's weak reference, lives as long as the graph
    hooks = torch.autograd.graph.saved_tensors_hooks(lambda t: t,
                                                     lambda t: t)
    with RT.count_collectives() as led, flops, meter, hooks:
        step()
    coll = CA.collective_bytes(led)
    coll.pop("_peer", None)
    total = sum(v for k, v in coll.items() if not k.startswith("_"))
    return {"flops": float(flops.get_total_flops()), "bytes": meter.bytes,
            "collectives": coll, "collective_total": total,
            "bytes_by_op": dict(meter.bytes_by_op),
            "peak_bytes": int(meter.peak)}
