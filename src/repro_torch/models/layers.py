"""Transformer building blocks (``repro``'s ``models/layers.py``): norms,
RoPE, blocked (flash-style) attention, the attention layer with its KV
cache and its cross-attention forms (``kv_override``, ``kv_static``),
gated MLPs.

``repro`` computes attention blockwise with an online softmax in plain
JAX; :func:`blocked_attention` is the same function in plain PyTorch. On
the prefill and in a one-shot forward (no ``kv_len``, more than 8
queries; causal with positions from 0, or non-causal: the encoder's
self-attention and cross-attention) :func:`attention_layer` sends CUDA
tensors to the hand-written kernel B5 instead (``kernels/flash_attention``),
which computes that function too. B5 is forward only, as ``repro``'s
Pallas kernel: training passes ``backend="torch"`` and differentiates
:func:`blocked_attention`, as ``repro`` differentiates its own.

Sharded (``shard=``, a :class:`Shard`): the layer runs on this rank's
blocks, and the collectives sit where GSPMD puts them in ``repro``:
the attention on its local heads (and the KV heads they read), its
output projection ending in a ``psum`` over the heads' axis (under an
``attn_seq`` rule with ``cfg.attn_q_parallel``, on its rows of the
queries instead, B5 taking them at their offset); the MLP on
its local ``mlp`` columns, ending in a ``psum``. When the rules shard
the KV cache's sequence (decode with ``kv_seq`` on a mesh axis), decode
attention is a split softmax: each rank scores its own cache rows, the
ranks combine with a ``pmax`` of the maximum and ``psum``s of the
normaliser and of ``p·v``, and only the rank that owns a new token's row
writes it.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import runtime as RT
from repro_torch.sharding import specs as SP

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class Shard:
    """How one layer's blocks lie on the mesh: ``p`` the specs of its
    parameters and ``c`` those of its cache leaves (dicts of spec tuples,
    the stacked-groups dim dropped), under ``ctx``'s mesh."""

    ctx: Any
    p: Dict[str, Any]
    c: Optional[Dict[str, Any]] = None

    def axis(self, name: str, dim: int):
        """The mesh axes of dim ``dim`` of parameter ``name`` (or None)."""
        sp = self.p.get(name)
        return None if sp is None else sp[dim]


def psum_if(x, e):
    """``psum`` over spec entry ``e``'s axes, or ``x`` when it is None."""
    return x if e is None else RT.psum(x, SP.flat_axes(e))


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------

def rms_norm(x, gamma, eps: float):
    """RMS norm in fp32 with the ``1 + gamma`` scale; returns x's dtype."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + gamma.to(torch.float32))).to(x.dtype)


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, dtype=torch.float32,
               device=None):
    """Inverse frequencies, built in float64 numpy and cast, as ``repro``."""
    inv = 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))
    return torch.as_tensor(inv, dtype=dtype, device=device)


@functools.lru_cache(maxsize=None)
def _rope_freqs_on(head_dim: int, theta: float, device: torch.device):
    # once per device: a copy from host memory to the card waits for the
    # card to drain, which would stall every layer of a decode step
    return rope_freqs(head_dim, theta, device=device)


def apply_rope(x, positions, theta: float):
    """x: ``(B, S, H, hd)``; positions: ``(B, S)`` integers."""
    hd = x.shape[-1]
    inv = _rope_freqs_on(hd, theta, x.device)
    ang = positions[..., None].to(torch.float32) * inv     # (B, S, hd/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# Blocked attention with online softmax
# --------------------------------------------------------------------------

def _pad_axis_to(x, axis, mult):
    n = x.shape[axis]
    pad = (-n) % mult
    if pad == 0:
        return x, n
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=axis), n


def _group_scores(q, k):
    """fp32 ``q·kᵀ`` ``(B, K, rep, Sq, Sk)`` of q ``(B, Sq, H, hd)`` against
    its KV head of k ``(B, Sk, K, hd)``: the rep query heads of a KV head
    go in as rows of one product, so K is never repeated."""
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    rep = H // K
    qg = q.reshape(B, Sq, K, rep, hd).permute(0, 2, 3, 1, 4).reshape(
        B, K, rep * Sq, hd).to(torch.float32)
    s = torch.matmul(qg, k.to(torch.float32).permute(0, 2, 3, 1))
    return s.reshape(B, K, rep, Sq, -1)


def _group_pv(p, v):
    """fp32 ``p·v`` ``(B, K, rep, Sq, hd)`` of p ``(B, K, rep, Sq, Sk)``
    and v ``(B, Sk, K, hd)``, V not repeated either."""
    B, K, rep, Sq, Sk = p.shape
    o = torch.matmul(p.reshape(B, K, rep * Sq, Sk),
                     v.to(torch.float32).permute(0, 2, 1, 3))
    return o.reshape(B, K, rep, Sq, -1)


def _dense_attention(q, k, v, *, scale, causal, q_positions, kv_len):
    """``repro``'s ``Sq <= 8`` decode pass: one masked softmax over the
    whole cache; ``p`` is rounded to v's dtype before ``p·v``, as
    ``repro`` does (``layers.py:127``)."""
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    s = _group_scores(q, k) * scale                            # b g r q k
    kpos = torch.arange(Sk, device=q.device)
    mask = torch.ones((B, 1, 1, Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kpos[None, None, None, None, :]
                       <= q_positions[:, None, None, :, None])
    if kv_len is not None:
        mask = mask & (kpos[None, :] < kv_len.to(torch.int64)[:, None]
                       )[:, None, None, None, :]
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v.dtype).to(torch.float32)
    o = _group_pv(p, v)                                        # b g r q d
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).to(q.dtype)


def blocked_attention(q, k, v, *, causal: bool, q_positions=None,
                      kv_len=None, block_q: int = 512, block_k: int = 1024,
                      banded: bool = False, q_parallel: bool = False):
    """Flash-style attention in plain PyTorch.

    q: ``(B, Sq, H, hd)``; k, v: ``(B, Sk, K, hd)`` with ``H = K·rep``
    (GQA). q_positions: ``(B, Sq)`` global positions of the queries (for
    causal masking against a KV cache); defaults to ``arange(Sq)``.
    kv_len: ``(B,)`` valid KV length (decode against a partly filled
    cache). Returns ``(B, Sq, H, hd)`` in q's dtype.

    ``Sq <= 8`` takes ``repro``'s dense decode pass; otherwise queries go in
    ``block_q`` rows against ``block_k`` keys at a time with an online
    softmax in fp32, as ``repro``'s scanned path. ``banded`` (causal,
    ``Sq > block_q``) takes ``repro``'s causal-exact schedule instead
    (:func:`_banded_attention`). ``q_parallel`` is an XLA schedule of this
    same function in ``repro``; the port's form of it is the
    ``attn_seq`` split in :func:`attention_layer`.
    """
    del q_parallel
    B, Sq, H, hd = q.shape
    _, Sk, K, _ = k.shape
    rep = H // K
    scale = 1.0 / math.sqrt(hd)
    if q_positions is None:
        q_positions = torch.arange(Sq, device=q.device).expand(B, Sq)
    q_positions = q_positions.to(torch.int64)
    if banded and causal and Sq > block_q:
        return _banded_attention(q, k, v, scale=scale,
                                 q_positions=q_positions, block=block_q)
    if Sq <= 8:
        return _dense_attention(q, k, v, scale=scale, causal=causal,
                                q_positions=q_positions, kv_len=kv_len)

    block_q = min(block_q, Sq)
    block_k = min(block_k, Sk)
    qp, Sq0 = _pad_axis_to(q, 1, block_q)
    kp, Sk0 = _pad_axis_to(k, 1, block_k)
    vp, _ = _pad_axis_to(v, 1, block_k)
    pp, _ = _pad_axis_to(q_positions, 1, block_q)
    nq = qp.shape[1] // block_q
    nk = kp.shape[1] // block_k
    limit = (torch.full((B,), Sk0, device=q.device) if kv_len is None
             else kv_len.to(torch.int64))
    outs = []
    for i in range(nq):
        qb = qp[:, i * block_q:(i + 1) * block_q]
        pb = pp[:, i * block_q:(i + 1) * block_q]
        m = torch.full((B, K, rep, block_q), NEG_INF, device=q.device)
        l = torch.zeros((B, K, rep, block_q), device=q.device)
        acc = torch.zeros((B, K, rep, block_q, hd), device=q.device)
        for j in range(nk):
            sl = slice(j * block_k, (j + 1) * block_k)
            s = _group_scores(qb, kp[:, sl]) * scale      # b g r q k
            kpos = torch.arange(j * block_k, (j + 1) * block_k,
                                device=q.device)
            mask = (kpos[None, :] < limit[:, None])[:, None, None, None, :]
            if causal:
                mask = mask & (kpos[None, None, None, None, :]
                               <= pb[:, None, None, :, None])
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + _group_pv(p, vp[:, sl])
            m = m_new
        out = acc / torch.clamp_min(l[..., None], 1e-30)
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(B, block_q, H, hd))
    o = torch.cat(outs, dim=1)[:, :Sq0]
    return o.to(q.dtype)


def _banded_attention(q, k, v, *, scale, q_positions, block: int):
    """``repro``'s causal-exact unrolled schedule (``attn_banded``): query
    block ``i`` attends to keys ``[0, (i + 1)·block)`` only, with one exact
    fp32 softmax each, so the work is the causal triangle and half a block
    on the diagonal, not the whole square. Meant for self-attention from
    position 0 (prefill, training); like ``repro``'s it reads no
    ``kv_len``."""
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    qp, Sq0 = _pad_axis_to(q, 1, block)
    pp, _ = _pad_axis_to(q_positions, 1, block)
    outs = []
    for i in range(qp.shape[1] // block):
        qb = qp[:, i * block:(i + 1) * block]
        pb = pp[:, i * block:(i + 1) * block]
        hi = min((i + 1) * block, Sk)
        s = _group_scores(qb, k[:, :hi]) * scale              # b g r q k
        kpos = torch.arange(hi, device=q.device)
        s = torch.where(kpos[None, None, None, None, :]
                        <= pb[:, None, None, :, None], s, NEG_INF)
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        o = _group_pv(p, v[:, :hi]) / torch.clamp_min(
            p.sum(dim=-1)[..., None], 1e-30)
        outs.append(o.permute(0, 3, 1, 2, 4).reshape(B, block, H, hd))
    return torch.cat(outs, dim=1)[:, :Sq0].to(q.dtype)


# --------------------------------------------------------------------------
# Attention layer (projections + rope + attention)
# --------------------------------------------------------------------------

def _proj(x, w):
    """``einsum("bsd,dhk->bshk", x, w)`` as one matrix product."""
    B, S, D = x.shape
    return (x.reshape(B * S, D) @ w.reshape(D, -1)).reshape(
        B, S, *w.shape[1:])


def resolve_backend(backend: str, x) -> str:
    """``"auto"`` → ``"cuda"`` for CUDA tensors, ``"torch"`` otherwise;
    ``"cuda"`` on CPU tensors raises RuntimeError."""
    if backend == "auto":
        return "cuda" if x.is_cuda else "torch"
    if backend == "cuda" and not x.is_cuda:
        raise RuntimeError("backend='cuda' needs CUDA tensors; these are on "
                           f"{x.device}")
    if backend not in ("torch", "cuda"):
        raise ValueError(f"unknown backend {backend!r}; want 'auto', "
                         "'torch' or 'cuda'")
    return backend


def attention_layer(params, x, *, cfg, positions=None, cache=None,
                    cache_len=None, kv_override=None, kv_static=None,
                    causal: bool = True, backend: str = "auto",
                    shard: Optional[Shard] = None):
    """Attention layer: projections, RoPE, attention, output projection.

    params: ``{wq (D, H, hd), wk (D, K, hd), wv, wo (H, hd, D)}``.
    positions: ``(B, S)``, or None for ``arange(S)`` in every row (the
    prefill and a one-shot forward; only then can the kernel take a causal
    attention, since B5 counts positions from 0).
    cache: optional ``{k: (B, S_max, K, hd), v: ...}``: the new k and v are
    written into it at ``positions`` IN PLACE (``repro`` builds a new
    cache; the port updates the caller's tensors) and attention runs over
    the whole cache, ``cache_len`` entries of it valid.
    kv_override: cross-attention's source ``(B, Sk, D)`` (the encoder's
    output, the projected image tokens): k and v are projected from it in
    the compute dtype, RoPE is skipped and the attention is non-causal.
    kv_static: a precomputed ``(k, v)`` pair ``(B, Sk, K, hd)``, cast to
    the compute dtype (cross-attention's decode reads the projections
    cached at prefill); RoPE is skipped.
    backend: ``"auto"`` (B5 for CUDA tensors), ``"torch"`` (the plain
    path everywhere) or ``"cuda"`` (B5; raises on CPU tensors). B5 takes
    the attention when ``kv_len`` is None and ``Sq > 8``, if it is
    non-causal or ``positions`` is None (under an ``attn_seq`` rule, on
    this rank's rows at their offset); otherwise the plain
    :func:`blocked_attention` does (``repro``'s ``Sq <= 8`` dense pass at
    decode).
    shard: this rank's blocks (module docstring): ``params`` hold its
    heads, the cache its rows and KV heads, x its batch rows.
    Returns ``(out (B, S, D), cache)``.
    """
    backend = resolve_backend(backend, x)
    B, S, D = x.shape
    ct = x.dtype
    pos = (torch.arange(S, device=x.device).expand(B, S)
           if positions is None else positions)
    q = _proj(x, params["wq"].to(ct))
    if kv_static is not None:
        k, v = kv_static[0].to(ct), kv_static[1].to(ct)
    else:
        src = x if kv_override is None else kv_override.to(ct)
        k = _proj(src, params["wk"].to(ct))
        v = _proj(src, params["wv"].to(ct))
    if kv_override is None and kv_static is None:
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    causal = causal and kv_override is None
    heads_ax = None if shard is None else shard.axis("wq", 1)
    seq_ax = None
    if cache is not None and shard is not None and shard.c is not None:
        seq_ax = shard.c["k"][1]

    kv_len = None
    if cache is not None and seq_ax is not None:
        _write_rows(cache, k, v, pos, seq_ax)
        if S <= 8 and positions is not None:
            o = _split_decode_attention(q, cache, cfg=cfg, q_positions=pos,
                                        kv_len=cache_len, causal=causal,
                                        heads_ax=heads_ax, seq_ax=seq_ax)
            return _out_proj(o, params, heads_ax, B, S, D), cache
        # a prefill into a sequence-sharded cache attends to its own k, v
    elif cache is not None:
        bidx = torch.arange(B, device=x.device)[:, None]
        cache["k"][bidx, pos] = k.to(cache["k"].dtype)
        cache["v"][bidx, pos] = v.to(cache["v"].dtype)
        k, v = cache["k"].to(ct), cache["v"].to(ct)
        kv_len = cache_len
    if heads_ax is not None:
        k, v = _kv_for_heads(k, v, cfg, q.shape[2], heads_ax)
    # B5's causal mask counts the rows' positions from 0 (or from a run's
    # offset): it takes a causal attention only with positions None
    b5 = backend == "cuda" and (not causal or positions is None)
    seq_par = _seq_parallel_axis(cfg, shard, S, kv_len, heads_ax, causal)
    if seq_par is not None:
        return _seq_parallel_attention(q, k, v, params, cfg, pos, causal,
                                       seq_par, heads_ax, b5), cache

    if b5 and kv_len is None and S > 8:
        from repro_torch.kernels.flash_attention import ops
        o = ops.mha(q, k, v, causal=causal)
    else:
        o = blocked_attention(q, k, v, causal=causal, q_positions=pos,
                              kv_len=kv_len, block_q=cfg.attn_block_q,
                              block_k=cfg.attn_block_k,
                              banded=cfg.attn_banded)
    return _out_proj(o, params, heads_ax, B, S, D), cache


def _seq_parallel_axis(cfg, shard, S: int, kv_len, heads_ax, causal: bool):
    """The mesh axes of the ``attn_seq`` rule when ``cfg.attn_q_parallel``
    asks for ``repro``'s sequence-parallel schedule (§Perf B1) and it
    applies: a prefill or training pass (no ``kv_len``) of more than
    ``attn_block_q`` queries that split evenly over axes the heads are
    not already split over (``repro`` sets the rule where they cannot
    be), and not a causal one that ``attn_banded`` takes (``repro``'s
    banded schedule comes first)."""
    if shard is None or not cfg.attn_q_parallel or kv_len is not None \
            or S <= cfg.attn_block_q or (cfg.attn_banded and causal):
        return None
    e = shard.ctx.axis("attn_seq")
    if e is None or S % shard.ctx.n_shards(e) or set(
            SP.flat_axes(e)) & set(SP.flat_axes(heads_ax)):
        return None
    return e


def _seq_parallel_attention(q, k, v, params, cfg, pos, causal, seq_ax,
                            heads_ax, b5: bool):
    """``repro``'s ``attn_q_parallel`` schedule with an ``attn_seq`` rule:
    the queries are split over ``seq_ax`` (each rank attends its
    contiguous rows to the whole k and v, at their global positions),
    and the rows' outputs, projected by ``wo``, are all-gathered over
    ``seq_ax``; attention's work is shared by sequence where the heads
    do not divide the axis. With ``b5`` (CUDA tensors, positions from 0)
    B5 takes the rows, its causal mask shifted to their first position
    (``q_offset``); otherwise the plain attention does."""
    B, S, h, hd = q.shape
    D = params["wo"].shape[-1]
    axes = SP.flat_axes(seq_ax)
    n = S // RT.axis_size(axes)
    i = SP.block_index(seq_ax)
    rows = slice(i * n, (i + 1) * n)
    if b5:
        from repro_torch.kernels.flash_attention import ops
        o = ops.mha(q[:, rows], k, v, causal=causal, q_offset=i * n)
    else:
        o = blocked_attention(q[:, rows], k, v, causal=causal,
                              q_positions=pos[:, rows],
                              block_q=cfg.attn_block_q,
                              block_k=cfg.attn_block_k)
    out = _out_proj(o, params, heads_ax, B, n, D)
    return RT.all_gather(out, axes, axis=1, tiled=True)


def _out_proj(o, params, heads_ax, B, S, D):
    """``o·wo`` over this rank's heads, summed over the heads' axis."""
    wo = params["wo"].to(o.dtype)
    out = (o.reshape(B * S, -1) @ wo.reshape(-1, D)).reshape(B, S, D)
    return psum_if(out, heads_ax)


def _kv_for_heads(k, v, cfg, h_local: int, heads_ax):
    """The KV heads this rank's ``h_local`` query heads read, when the
    query heads are sharded and k, v hold every KV head (``kv_heads``
    replicated). A contiguous run that each of the local heads' groups
    shares evenly is sliced, so B5 and :func:`blocked_attention` map query
    head ``h`` to KV head ``h // rep`` in local indices; otherwise each
    query head gets its own copy (rep 1). k, v already local (``kv_heads``
    sharded like the heads) come back as they are."""
    K, H = cfg.n_kv_heads, cfg.n_heads
    if k.shape[2] != K or h_local == H:
        return k, v
    rep = H // K
    head0 = SP.block_index(heads_ax) * h_local
    kv = [(head0 + h) // rep for h in range(h_local)]
    lo, hi = kv[0], kv[-1] + 1
    n = hi - lo
    if h_local % n == 0 and kv == [lo + h // (h_local // n)
                                   for h in range(h_local)]:
        return k[:, :, lo:hi], v[:, :, lo:hi]
    idx = torch.tensor(kv, device=k.device)
    return k.index_select(2, idx), v.index_select(2, idx)


def _write_rows(cache, k, v, pos, seq_ax) -> None:
    """Write the new k, v ``(B, S, K, hd)`` at positions ``pos`` (``(B, S)``,
    consecutive in each row) into a cache whose sequence is sharded over
    ``seq_ax``, IN PLACE: each rank writes the rows it owns and keeps the
    rest (no host read: a token outside the block rewrites its old
    value)."""
    S_l = cache["k"].shape[1]
    B, S = pos.shape
    lo = SP.block_index(seq_ax) * S_l
    dev = pos.device
    bidx = torch.arange(B, device=dev)[:, None]
    if S == 1:
        row = pos - lo                                      # (B, 1)
        ok = ((row >= 0) & (row < S_l))[..., None, None]
        rc = row.clamp(0, S_l - 1)
        for name, new in (("k", k), ("v", v)):
            buf = cache[name]
            buf[bidx, rc] = torch.where(ok, new.to(buf.dtype), buf[bidx, rc])
        return
    t = lo + torch.arange(S_l, device=dev)[None, :] - pos[:, :1]  # (B, S_l)
    ok = ((t >= 0) & (t < S))[..., None, None]
    tc = t.clamp(0, S - 1)
    for name, new in (("k", k), ("v", v)):
        buf = cache[name]
        got = new[bidx, tc].to(buf.dtype)
        buf.copy_(torch.where(ok, got, buf))


def _split_decode_attention(q, cache, *, cfg, q_positions, kv_len, causal,
                            heads_ax, seq_ax):
    """``repro``'s ``Sq <= 8`` dense decode pass over a cache whose rows
    are sharded over ``seq_ax`` (every KV head on every rank): this rank
    scores its rows for every query head (the local heads gathered over
    ``heads_ax`` first), the maximum is ``pmax``'d and the normaliser and
    ``p·v`` ``psum``'d over ``seq_ax``; ``p`` is rounded to v's dtype
    before ``p·v`` as in the dense pass. Returns this rank's query heads'
    output ``(B, Sq, H_local, hd)``."""
    B, Sq, h_local, hd = q.shape
    ct = q.dtype
    if heads_ax is not None:
        q = RT.all_gather(q, SP.flat_axes(heads_ax), axis=2, tiled=True)
    k, v = cache["k"].to(ct), cache["v"].to(ct)
    S_l = k.shape[1]
    lo = SP.block_index(seq_ax) * S_l
    axes = SP.flat_axes(seq_ax)
    s = _group_scores(q, k) * (1.0 / math.sqrt(hd))            # b g r q k
    kpos = lo + torch.arange(S_l, device=q.device)
    mask = torch.ones((B, 1, 1, Sq, S_l), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kpos[None, None, None, None, :]
                       <= q_positions.to(torch.int64)[:, None, None, :, None])
    if kv_len is not None:
        mask = mask & (kpos[None, :] < kv_len.to(torch.int64)[:, None]
                       )[:, None, None, None, :]
    s = torch.where(mask, s, NEG_INF)
    m = RT.pmax(s.amax(dim=-1, keepdim=True), axes)
    e = torch.exp(s - m)
    l = RT.psum(e.sum(dim=-1, keepdim=True), axes)
    p = (e / l).to(v.dtype).to(torch.float32)
    o = RT.psum(_group_pv(p, v), axes)                          # b g r q d
    o = o.permute(0, 3, 1, 2, 4).reshape(B, Sq, -1, hd).to(ct)
    if heads_ax is not None:
        head0 = SP.block_index(heads_ax) * h_local
        o = o[:, :, head0:head0 + h_local]
    return o


# --------------------------------------------------------------------------
# MLP
# --------------------------------------------------------------------------

def _gelu(x):
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu(x, approximate="tanh")


def mlp_layer(params, x, *, act: str, shard: Optional[Shard] = None):
    """``wo(act(x·wi))``, gated for ``swiglu`` / ``geglu``; ``gelu`` and
    ``relu2`` (squared ReLU) ungated. Sharded: this rank's ``mlp``
    columns, the output ``psum``'d over their axis."""
    ct = x.dtype
    B, S, D = x.shape
    x2 = x.reshape(B * S, D)
    h = x2 @ params["wi"].to(ct)
    if act in ("swiglu", "geglu"):
        g = x2 @ params["wg"].to(ct)
        gate = F.silu(g) if act == "swiglu" else _gelu(g)
        h = gate * h
    elif act == "gelu":
        h = _gelu(h)
    elif act == "relu2":
        r = torch.relu(h)
        h = r * r
    else:
        raise ValueError(f"unknown act {act!r}")
    out = (h @ params["wo"].to(ct)).reshape(B, S, D)
    return out if shard is None else psum_if(out, shard.axis("wo", 0))
