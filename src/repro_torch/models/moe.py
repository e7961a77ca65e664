"""Mixture-of-Experts (``repro``'s ``models/moe.py``): the router, the
expert FFNs, the dropless dense oracle and the expert-parallel map path.

The paper's ``map()`` (particles to their owning rank) is MoE token
dispatch (tokens to the rank that holds their expert): ``moe_map_local``
is a bucketed ``all_to_all`` over the ``model`` mesh axis whose
fixed-capacity per-destination buckets are sized as
``core/mappings.map_particles_local``'s, followed by a reverse
``all_to_all`` and a ``psum`` that play ``ghost_put(sum)`` (the
gate-weighted combine). It runs per rank on a ``runtime.make_mesh`` mesh,
every collective through ``core/runtime.py``, as the port's mappings do.

Two paths, as in ``repro``:
  * :func:`moe_map_local` — the expert-parallel map path above;
  * :func:`moe_dense` — every expert on every token, the dropless oracle
    (``repro`` takes it with no mesh, and so does the port's
    ``models/transformer._apply_moe``).

Capacity follows Switch/DeepSpeed: buckets of ``tokens·top_k/tp ·
capacity_factor``; tokens over capacity are dropped (the residual carries
them) and counted.

Top-k ties: ``jax.lax.top_k`` takes the lower index; ``torch.topk`` does
not promise an order among equal values, so :func:`router_probs` takes
the first k of a stable descending sort, which is the same choice.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.core import runtime as RT


def router_probs(x2d, w_router, *, top_k: int, n_real: Optional[int] = None):
    """x2d: ``(T, D)`` -> ``(gates (T, k), experts (T, k) int32, probs (T,
    E))``. Logits in fp32; ``n_real`` masks the padding experts
    (``n_real..E``) to -1e30 before the softmax; the top-k gates are
    renormalised with a 1e-9 floor."""
    logits = x2d.to(torch.float32) @ w_router.to(torch.float32)
    E = logits.shape[-1]
    if n_real is not None and n_real < E:
        pad = torch.arange(E, device=logits.device) >= n_real
        logits = torch.where(pad[None, :], torch.full_like(logits, -1e30),
                             logits)
    probs = torch.softmax(logits, dim=-1)
    # the lower index first among equal probabilities, as lax.top_k
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, experts = vals[:, :top_k], idx[:, :top_k]
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    return gates, experts.to(torch.int32), probs


def load_balance_loss(probs, experts, n_experts: int, batch_axes=()):
    """Switch's auxiliary loss: ``E · Σ_e f_e · P_e`` over the real
    experts. ``batch_axes``: mesh axes the tokens are split over (equal
    shares); the occupancy and the mean probability are then the whole
    batch's (``psum``'d), so the loss is the unsharded one."""
    E = probs.shape[-1]
    idx = experts.reshape(-1).to(torch.int64)
    occupancy = torch.zeros(E, dtype=torch.float32,
                            device=probs.device).index_add(
        0, idx, torch.ones(idx.shape, dtype=torch.float32,
                           device=probs.device))
    if batch_axes:
        n = RT.axis_size(tuple(batch_axes))
        f = RT.psum(occupancy, tuple(batch_axes)) / max(experts.numel() * n,
                                                        1)
        P = RT.psum(probs.sum(dim=0), tuple(batch_axes)) / (
            probs.shape[0] * n)
    else:
        f = occupancy / max(experts.numel(), 1)
        P = probs.mean(dim=0)
    return n_experts * torch.sum(f[:n_experts] * P[:n_experts])


def _gelu(x):
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu(x, approximate="tanh")


def expert_ffn(w, h, act: str):
    """h: ``(E, C, D)``; w: ``{wi (E, D, F), wg, wo (E, F, D)}`` -> ``(E, C,
    D)``, in h's dtype."""
    ct = h.dtype
    up = torch.bmm(h, w["wi"].to(ct))
    if act in ("swiglu", "geglu"):
        g = torch.bmm(h, w["wg"].to(ct))
        up = (F.silu(g) if act == "swiglu" else _gelu(g)) * up
    else:
        up = _gelu(up)
    return torch.bmm(up, w["wo"].to(ct))


# --------------------------------------------------------------------------
# The expert-parallel path: the paper's map() applied to tokens
# --------------------------------------------------------------------------

def _pack_by(dest, payload: Dict[str, torch.Tensor], n_buckets: int,
             cap: int):
    """Dense ``(n_buckets, cap, ...)`` packing by destination, with
    ``repro``'s slots: a stable sort by ``dest`` (clamped to
    ``n_buckets``, the discard bucket), the j-th row of bucket b in slot
    j, rows past ``cap`` dropped. Each slot gathers its row (the port's
    packers gather; ``repro`` scatters). Returns ``(packed, slot_src,
    dropped)``: ``slot_src`` holds each slot's source row (T when
    empty), ``dropped`` the count past capacity (0-d int32)."""
    T = dest.shape[0]
    dev = dest.device
    dest = torch.clamp(dest.to(torch.int64), max=n_buckets)
    order = torch.sort(dest, stable=True).indices
    sd = dest[order]
    buckets = torch.arange(n_buckets, device=dev)
    start = torch.searchsorted(sd, buckets, right=False)
    counts = torch.searchsorted(sd, buckets, right=True) - start
    col = torch.arange(cap, device=dev)
    filled = col[None, :] < counts[:, None]                  # (nb, cap)
    at = torch.clamp(start[:, None] + col[None, :], max=max(T - 1, 0))
    src = order[at]
    packed = {}
    for k, a in payload.items():
        got = a[src]
        m = filled.reshape(filled.shape + (1,) * (got.dim() - 2))
        packed[k] = torch.where(m, got, torch.zeros_like(got))
    slot_src = torch.where(filled, src, torch.full_like(src, T)).to(
        torch.int32)
    dropped = torch.clamp(counts - cap, min=0).sum().to(torch.int32)
    return packed, slot_src, dropped


def moe_map_local(x2d, w, *, cfg, axis_name: str = "model",
                  batch_axes=()):
    """The expert-parallel MoE, per rank (``repro`` calls it inside
    ``shard_map``). x2d: ``(T, D)``, the same tokens on every rank of
    ``axis_name``; the experts of ``w`` (``wi``, ``wg``, ``wo``) are this
    rank's ``E / tp`` block, ``router`` whole.

    Each rank dispatches the (token, k) assignments ``≡ rank (mod tp)``
    (striped before gathering, so every assignment goes once), packed by
    (destination rank, local expert) into sub-buckets of ``cap_se``
    slots, with one ``all_to_all`` each for the rows, gates and token
    ids; the expert FFN runs on the received tiles; three ``all_to_all``
    bring the weighted rows, token ids and the slot mask home; a
    scatter-add into the token rows and a ``psum`` over the axis combine
    them. Returns ``(out (T, D), aux, n_dropped)``, the last two the same
    on every rank (``aux`` this rank's router loss, as ``repro``; over
    the whole batch with ``batch_axes``, as :func:`load_balance_loss`).
    Differentiable: the exchanges carry their adjoints
    (``core/runtime.py``)."""
    tp = RT.axis_size(axis_name)
    me = RT.axis_index(axis_name)
    T, D = x2d.shape
    dev = x2d.device
    E = cfg.n_experts_eff
    E_local = E // tp
    k = cfg.top_k

    gates, experts, probs = router_probs(x2d, w["router"], top_k=k,
                                         n_real=cfg.n_experts)
    aux = load_balance_loss(probs, experts, cfg.n_experts, batch_axes)

    n_total = T * k
    n_mine = -(-n_total // tp)
    pad = n_mine * tp - n_total

    def take_col(a, fill):
        a = a.reshape(-1)
        if pad:
            a = torch.cat([a, torch.full((pad,), fill, dtype=a.dtype,
                                         device=dev)])
        return a.reshape(n_mine, tp)[:, me]

    a_exp = take_col(experts, E)                 # E: the padded sentinel
    a_gate = take_col(gates, 0.0)
    a_tok = take_col(torch.arange(T, dtype=torch.int32, device=dev)
                     .repeat_interleave(k), 0)
    real = a_exp < E
    dest_dev = torch.where(real, a_exp // E_local, torch.full_like(a_exp,
                                                                   tp))
    # one stage, packed by (dest rank, local expert): the received buffer
    # is already grouped by expert; capacity per (src, dst, expert)
    cap_se = max(int(math.ceil(n_mine / (tp * max(E_local, 1))
                               * cfg.capacity_factor)), 8)
    local_e = torch.where(real, a_exp % E_local,
                          torch.full_like(a_exp, E_local))
    joint = torch.where(real, dest_dev * E_local + local_e,
                        torch.full_like(a_exp, tp * E_local))
    payload = {"x": x2d[a_tok.long()], "gate": a_gate.to(x2d.dtype),
               "tok": a_tok}
    packed, _, dropped = _pack_by(joint, payload, tp * E_local, cap_se)
    recv = {}
    for name in sorted(packed):            # repro's pytree order
        a = packed[name]
        recv[name] = RT.all_to_all(
            a.reshape((tp, E_local * cap_se) + tuple(a.shape[2:])),
            axis_name, split_axis=0, concat_axis=0, tiled=False)

    def regroup(a):
        a = a.reshape((tp, E_local, cap_se) + tuple(a.shape[2:]))
        return a.transpose(0, 1).reshape((E_local, tp * cap_se)
                                         + tuple(a.shape[3:]))

    rx, rgate, rtok = (regroup(recv[n]) for n in ("x", "gate", "tok"))
    h = expert_ffn({"wi": w["wi"], "wg": w.get("wg"), "wo": w["wo"]}, rx,
                   cfg.act)                       # (E_local, tp*cap_se, D)
    h = h * rgate[..., None]

    def ungroup(a):
        a = a.reshape((E_local, tp, cap_se) + tuple(a.shape[2:]))
        return a.transpose(0, 1).reshape((tp, E_local * cap_se)
                                         + tuple(a.shape[3:]))

    home = RT.all_to_all(ungroup(h), axis_name, split_axis=0, concat_axis=0,
                         tiled=False)
    home_tok = RT.all_to_all(ungroup(rtok), axis_name, split_axis=0,
                             concat_axis=0, tiled=False)
    home_val = RT.all_to_all(ungroup(rgate != 0), axis_name, split_axis=0,
                             concat_axis=0, tiled=False)
    # ghost_put(sum): contributions into the token rows, then the psum
    # over the axis (each rank dispatched a disjoint stripe)
    val = home_val.reshape(-1)
    idx = torch.where(val, home_tok.reshape(-1).long(),
                      torch.full_like(home_tok.reshape(-1).long(), T))
    contrib = torch.where(val[:, None], home.reshape(-1, D),
                          torch.zeros((), dtype=home.dtype, device=dev))
    out = torch.zeros((T + 1, D), dtype=x2d.dtype, device=dev).index_add(
        0, idx, contrib)[:T]
    out = RT.psum(out, axis_name)
    n_dropped = RT.psum(dropped, axis_name)
    return out, aux, n_dropped


def moe_dense(x2d, w, *, cfg, first: int = 0, batch_axes=()):
    """The dropless dense oracle: every real expert runs on every token,
    weighted by its gate (0 where it is not in the token's top-k).
    Returns ``(out, aux, 0)``. ``first``: the global index of ``w``'s
    first expert when ``w`` holds a block of them (``router`` whole);
    ``out`` is then this block's share. ``batch_axes`` as in
    :func:`load_balance_loss`."""
    E = cfg.n_experts
    k = cfg.top_k
    gates, experts, probs = router_probs(x2d, w["router"], top_k=k,
                                         n_real=E)
    aux = load_balance_loss(probs, experts, E, batch_axes)
    out = torch.zeros_like(x2d)
    for j in range(min(w["wi"].shape[0], E - first)):
        e = first + j
        h = expert_ffn({"wi": w["wi"][j:j + 1],
                        "wg": None if w.get("wg") is None
                        else w["wg"][j:j + 1],
                        "wo": w["wo"][j:j + 1]}, x2d[None], cfg.act)[0]
        gate_e = torch.where(experts == e, gates,
                             torch.zeros((), device=gates.device)).sum(-1)
        out = out + h * gate_e[:, None].to(h.dtype)
    return out, aux, torch.zeros((), dtype=torch.int32, device=x2d.device)
