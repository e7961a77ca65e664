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


def flash_attention_ref(q, k, v, *, causal: bool = True):
    """B5's own function: scores ``(q·kᵀ)·(1/√hd)`` in fp32, the causal
    mask ``kpos <= qpos`` counted from 0 (aligned to the start), masked
    scores ``NEG_INF``, ``p = exp(s − max)``, ``(p·v) / max(Σp, 1e-30)``
    in fp32, the output in q's dtype. Whole rows at once where the kernel
    sweeps them tile by tile, so only the summation order differs."""
    B, H, Sq, hd = q.shape
    s = _scores(q, k).mul_(1.0 / math.sqrt(hd))
    if causal:
        qpos = torch.arange(Sq, device=s.device).repeat(s.shape[2] // Sq)
        kpos = torch.arange(k.shape[2], device=s.device)
        s.masked_fill_(kpos[None, :] > qpos[:, None], NEG_INF)
    p = s.sub_(s.amax(dim=-1, keepdim=True)).exp_()
    den = p.sum(dim=-1, keepdim=True).clamp_min_(1e-30)
    return (_pv(p, v, q) / den.reshape(B, H, Sq, 1)).to(q.dtype)
