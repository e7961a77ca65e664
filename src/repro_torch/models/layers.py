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

``repro``'s ``cons`` sharding callbacks have no counterpart here: the port
runs the LM on one device (ROADMAP A16f: the LM's sharding).
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

NEG_INF = -1e30


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
    softmax in fp32, as ``repro``'s scanned path. ``banded`` and
    ``q_parallel`` are XLA schedules of this same function in ``repro``;
    the port computes the function whatever they say.
    """
    del banded, q_parallel
    B, Sq, H, hd = q.shape
    _, Sk, K, _ = k.shape
    rep = H // K
    scale = 1.0 / math.sqrt(hd)
    if q_positions is None:
        q_positions = torch.arange(Sq, device=q.device).expand(B, Sq)
    q_positions = q_positions.to(torch.int64)
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
                    causal: bool = True, backend: str = "auto"):
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
    non-causal or ``positions`` is None; otherwise the plain
    :func:`blocked_attention` does (``repro``'s ``Sq <= 8`` dense pass at
    decode).
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

    kv_len = None
    if cache is not None:
        bidx = torch.arange(B, device=x.device)[:, None]
        cache["k"][bidx, pos] = k.to(cache["k"].dtype)
        cache["v"][bidx, pos] = v.to(cache["v"].dtype)
        k, v = cache["k"].to(ct), cache["v"].to(ct)
        kv_len = cache_len

    # positions matter only to a causal mask
    if (backend == "cuda" and kv_len is None and S > 8
            and (not causal or positions is None)):
        from repro_torch.kernels.flash_attention import ops
        o = ops.mha(q, k, v, causal=causal)
    else:
        o = blocked_attention(q, k, v, causal=causal, q_positions=pos,
                              kv_len=kv_len, block_q=cfg.attn_block_q,
                              block_k=cfg.attn_block_k)
    wo = params["wo"].to(ct)
    out = o.reshape(B * S, -1) @ wo.reshape(-1, D)
    return out.reshape(B, S, D), cache


# --------------------------------------------------------------------------
# MLP
# --------------------------------------------------------------------------

def _gelu(x):
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu(x, approximate="tanh")


def mlp_layer(params, x, *, act: str):
    """``wo(act(x·wi))``, gated for ``swiglu`` / ``geglu``; ``gelu`` and
    ``relu2`` (squared ReLU) ungated."""
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
    return (h @ params["wo"].to(ct)).reshape(B, S, D)
