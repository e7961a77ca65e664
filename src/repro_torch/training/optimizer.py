"""AdamW with a memory-adaptive state dtype (``repro``'s
``training/optimizer.py``): global-norm clipping, decoupled weight decay,
linear warmup then cosine decay, all computed in fp32 as ``repro`` does.

``repro`` maps its update over the whole tree in one jitted step, and
XLA fuses it. Here the update runs leaf by leaf and, within a leaf, in
flat chunks of :data:`CHUNK` elements, writing the parameters and the
moments IN PLACE: the stacked ``wi`` of llama3.2-3b alone is 704M
elements, and fp32 temporaries of the whole tree would take many GB of
the card. Every element sees ``repro``'s arithmetic.

Sharded (a ctx in ``training/train.py``): the moments are local like
their parameters (``repro``'s ``o_shard = p_shard``), the update is
local, and :func:`global_norm` sums each leaf's squares over the mesh
axes that shard it, so a replicated leaf counts once.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch import tree as TREE

#: Elements a chunk of the clip and the update: their fp32 temporaries
#: stay near 64 MB each.
CHUNK = 1 << 24


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    opt_dtype: str = "float32"


def schedule(opt: OptConfig, step):
    """The learning rate at ``step`` (a tensor or an int), fp32: a linear
    warmup over ``warmup_steps``, then a cosine from ``lr`` down to
    ``0.1·lr`` at ``total_steps``."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(opt.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - opt.warmup_steps)
                       / max(opt.total_steps - opt.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return opt.lr * warm * (0.1 + 0.9 * cos)


def init_opt_state(params, opt: OptConfig):
    """Zero first and second moments in ``opt.opt_dtype``, shaped and
    placed as the parameters, and a 0-d int32 step on their device."""
    dt = getattr(torch, opt.opt_dtype)
    dev = TREE.flatten(params)[0][0].device
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    return {"m": TREE.tree_map(zeros, params),
            "v": TREE.tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _chunks(t):
    """Flat views of ``t`` in CHUNK-element pieces (``t`` contiguous)."""
    return t.view(-1).split(CHUNK)


def global_norm(tree, specs=None, ctx=None):
    """sqrt of the sum of squares of every leaf, each squared in fp32.
    With ``specs`` (a tree of the leaves' specs) and a ctx the leaves are
    this rank's blocks: the squares of the leaves sharded over the same
    axes are summed, then ``psum``'d over those axes (one ``psum`` per
    set of axes), so each element counts once."""
    leaves = TREE.flatten(tree)[0]
    if ctx is None or specs is None:
        groups = {(): leaves}
    else:
        from repro_torch.sharding import specs as SP
        groups = {}
        for leaf, spec in zip(leaves, _spec_leaves(specs)):
            axes = tuple(a for e in spec for a in SP.flat_axes(e))
            groups.setdefault(axes, []).append(leaf)
    total = None
    for axes, group in groups.items():
        part = None
        for leaf in group:
            s = sum((c.to(torch.float32).square().sum()
                     for c in leaf.reshape(-1).split(CHUNK)),
                    torch.zeros((), device=leaf.device))
            part = s if part is None else part + s
        if axes:
            from repro_torch.core import runtime as RT
            with ctx.active():
                part = RT.psum(part, axes)
        total = part if total is None else total + part
    return torch.sqrt(total)


def _spec_leaves(specs):
    """The specs of a spec tree in ``tree.flatten`` order (sorted keys)."""
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in _spec_leaves(specs[k])]
    return [specs]


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float, specs=None, ctx=None):
    """Scale every gradient by ``min(1, max_norm / max(norm, 1e-9))`` in
    fp32, back in its dtype, IN PLACE. Returns ``(grads, norm)``
    (``specs``, ``ctx`` as in :func:`global_norm`)."""
    norm = global_norm(grads, specs, ctx)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for g in TREE.flatten(grads)[0]:
        for c in (_chunks(g) if g.is_contiguous() else [g]):
            c.copy_((c.to(torch.float32) * scale).to(g.dtype))
    return grads, norm


@torch.no_grad()
def adamw_update(params, grads, state, opt: OptConfig):
    """One AdamW step IN PLACE on ``params`` and ``state``'s moments, as
    ``repro``'s ``adamw_update``: fp32 moments (stored in their dtype),
    bias correction, decoupled weight decay on every leaf with
    ``ndim >= 2`` (the stacked norms ``(n_groups, D)`` included, as in
    ``repro``). Returns ``(params, state, lr)``."""
    step = state["step"] + 1
    lr = schedule(opt, step)
    b1, b2 = opt.b1, opt.b2
    c1 = 1.0 - b1 ** step.to(torch.float32)
    c2 = 1.0 - b2 ** step.to(torch.float32)
    for p, g, m, v in zip(*(TREE.flatten(t)[0] for t in (
            params, grads, state["m"], state["v"]))):
        decay = p.ndim >= 2
        whole = not (p.is_contiguous() and m.is_contiguous()
                     and v.is_contiguous())
        parts = zip(*([[p], [g], [m], [v]] if whole else
                      [_chunks(p), g.reshape(-1).split(CHUNK), _chunks(m),
                       _chunks(v)]))
        for pc, gc, mc, vc in parts:
            gf = gc.to(torch.float32)
            m_new = b1 * mc.to(torch.float32) + (1 - b1) * gf
            v_new = b2 * vc.to(torch.float32) + (1 - b2) * gf * gf
            delta = (m_new / c1) / (torch.sqrt(v_new / c2) + opt.eps)
            if decay:
                delta = delta + opt.weight_decay * pc.to(torch.float32)
            pc.copy_((pc.to(torch.float32) - lr * delta).to(pc.dtype))
            mc.copy_(m_new.to(mc.dtype))
            vc.copy_(v_new.to(vc.dtype))
    state["step"] = step
    return params, state, lr
