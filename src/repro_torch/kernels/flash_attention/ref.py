"""Plain PyTorch versions of causal GQA attention, ``q`` ``(B, H, Sq, hd)``
and ``k``, ``v`` ``(B, K, Sk, hd)`` with ``H = K·rep``.

Two functions, which differ in where the causal diagonal sits when
``Sq != Sk``:

* :func:`attention_ref` is ``repro``'s oracle
  (``kernels/flash_attention/ref.py``): the mask is ``tril(k=Sk−Sq)``,
  aligned to the END, so query ``i`` sees keys ``0 … i + Sk − Sq``.
* :func:`flash_attention_ref` is what ``repro``'s Pallas kernel computes
  (``flash_attention.py:49-56``): the mask is ``kpos <= qpos`` with both
  counted from 0, aligned to the START, so query ``i`` sees keys
  ``0 … i``. That is the prefill's attention over a deeper, zeroed cache,
  and the function of the CUDA kernel B5.

The two agree only at ``Sq == Sk``. Both take the scores in fp32, set a
masked score to the finite ``NEG_INF`` and return q's dtype.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _scores(q, k):
    """fp32 products ``q·kᵀ`` ``(B, K, rep·Sq, Sk)``: the rep query heads
    of KV head ``h // rep`` go in as rows of one product, so K and V are
    never repeated."""
    B, H, Sq, hd = q.shape
    K = k.shape[1]
    qg = q.reshape(B, K, H // K * Sq, hd).to(torch.float32)
    return torch.matmul(qg, k.to(torch.float32).transpose(-1, -2))


def _pv(p, v, q):
    """``p·v`` in fp32, back to q's ``(B, H, Sq, hd)`` layout (fp32)."""
    B, H, Sq, hd = q.shape
    return torch.matmul(p, v.to(torch.float32)).reshape(B, H, Sq, hd)


def attention_ref(q, k, v, *, causal: bool = True):
    """``repro``'s oracle: exact softmax attention, the causal mask aligned
    to the end (``tril(k=Sk−Sq)``)."""
    s = _scores(q, k) / math.sqrt(q.shape[-1])
    if causal:
        Sq, Sk = q.shape[2], k.shape[2]
        mask = torch.ones((Sq, Sk), dtype=torch.bool,
                          device=s.device).tril(Sk - Sq)
        s = torch.where(mask.repeat(s.shape[2] // Sq, 1), s, NEG_INF)
    return _pv(torch.softmax(s, dim=-1), v, q).to(q.dtype)


def split_bf16x3(p):
    """fp32 ``p`` as three bf16 terms ``(p1, p2, p3)``: ``p1 = bf16(p)``,
    ``p2 = bf16(p − p1)``, ``p3 = bf16(p − p1 − p2)``, each difference
    exact in fp32. ``p1 + (p2 + p3) == p`` for every ``p >= ~2⁻¹⁰⁰``
    (below, the last term falls under bf16's subnormal step, far under
    fp32's resolution next to a softmax denominator >= 1). B5's bf16 form
    splits its fp32 softmax weights so, to run ``p·v`` as three bf16
    tensor-core products with fp32 sums: the same function as fp32 ``p·v``
    up to the summation order."""
    p = p.to(torch.float32)
    p1 = p.to(torch.bfloat16)
    rem = p - p1.to(torch.float32)
    p2 = rem.to(torch.bfloat16)
    p3 = (rem - p2.to(torch.float32)).to(torch.bfloat16)
    return p1, p2, p3


def flash_attention_ref(q, k, v, *, causal: bool = True, p_terms: int = 3):
    """B5's own function: scores ``(q·kᵀ)·(1/√hd)`` in fp32, the causal
    mask ``kpos <= qpos`` counted from 0 (aligned to the start), masked
    scores ``NEG_INF``, ``p = exp(s − max)``, ``(p·v) / max(Σp, 1e-30)``
    in fp32, the output in q's dtype. Whole rows at once where the kernel
    sweeps them tile by tile, so only the summation order differs.

    ``p_terms`` 1 or 2 is another function, a control for the bf16 form's
    split: ``p·v`` takes only the first one or two of
    :func:`split_bf16x3`'s terms of ``p`` (``Σp`` stays fp32). The default,
    3, is fp32 ``p`` itself."""
    if p_terms not in (1, 2, 3):
        raise ValueError(f"p_terms {p_terms}: want 1, 2 or 3")
    B, H, Sq, hd = q.shape
    s = _scores(q, k).mul_(1.0 / math.sqrt(hd))
    if causal:
        qpos = torch.arange(Sq, device=s.device).repeat(s.shape[2] // Sq)
        kpos = torch.arange(k.shape[2], device=s.device)
        s.masked_fill_(kpos[None, :] > qpos[:, None], NEG_INF)
    p = s.sub_(s.amax(dim=-1, keepdim=True)).exp_()
    den = p.sum(dim=-1, keepdim=True).clamp_min_(1e-30)
    if p_terms < 3:
        terms = split_bf16x3(p)[:p_terms]
        p = sum(t.to(torch.float32) for t in terms)
    return (_pv(p, v, q) / den.reshape(B, H, Sq, 1)).to(q.dtype)
