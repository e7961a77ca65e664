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


#: The products ``x_a·y_b`` of the bf16 terms of two fp32 operands
#: (:func:`split_bf16x3`) that B5's fp32 form sums, by count, smallest
#: first as the kernel issues them: 6 is every product of order
#: ``a + b <= 2`` (the form's own set), 3 those of order <= 1 (a control).
SPLIT_PRODUCTS = {3: ((1, 0), (0, 1), (0, 0)),
                  6: ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0))}


def _matmul(a, b, terms):
    """fp32 ``a @ b``, or with ``terms`` the sum of those products of the
    three bf16 terms of a and b: each product of two bf16 values is exact
    in fp32, and the sums are fp32."""
    a, b = a.to(torch.float32), b.to(torch.float32)
    if terms is None:
        return torch.matmul(a, b)
    ta, tb = split_bf16x3(a), split_bf16x3(b)
    out = None
    for i, j in SPLIT_PRODUCTS[terms]:
        prod = torch.matmul(ta[i].to(torch.float32), tb[j].to(torch.float32))
        out = prod if out is None else out.add_(prod)
    return out


def _scores(q, k, terms=None):
    """fp32 products ``q·kᵀ`` ``(B, K, rep·Sq, Sk)``: the rep query heads
    of KV head ``h // rep`` go in as rows of one product, so K and V are
    never repeated."""
    B, H, Sq, hd = q.shape
    K = k.shape[1]
    qg = q.reshape(B, K, H // K * Sq, hd)
    return _matmul(qg, k.to(torch.float32).transpose(-1, -2), terms)


def _pv(p, v, q, terms=None):
    """``p·v`` in fp32, back to q's ``(B, H, Sq, hd)`` layout (fp32)."""
    B, H, Sq, hd = q.shape
    return _matmul(p, v, terms).reshape(B, H, Sq, hd)


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


def flash_attention_ref(q, k, v, *, causal: bool = True, p_terms: int = 3,
                        q_offset: int = 0, split_terms: int = 9):
    """B5's own function: scores ``(q·kᵀ)·(1/√hd)`` in fp32, the causal
    mask ``kpos <= qpos`` counted from 0 (aligned to the start; query row
    ``i`` at position ``q_offset + i``), masked
    scores ``NEG_INF``, ``p = exp(s − max)``, ``(p·v) / max(Σp, 1e-30)``
    in fp32, the output in q's dtype. Whole rows at once where the kernel
    sweeps them tile by tile, so only the summation order differs.

    ``p_terms`` 1 or 2 is another function, a control for the bf16 form's
    split: ``p·v`` takes only the first one or two of
    :func:`split_bf16x3`'s terms of ``p`` (``Σp`` stays fp32). The default,
    3, is fp32 ``p`` itself.

    ``split_terms`` 6 or 3 computes the fp32 form's products: ``q·kᵀ``
    from :data:`SPLIT_PRODUCTS` of the three bf16 terms of q and of k,
    and ``p·v`` likewise from those of p and of v. 6, the products of
    order <= 2, is what B5's fp32 form computes; 3, those of order <= 1,
    is a control. The default, 9 (all nine products, whose sum is each
    fp32 product exactly), is fp32 itself."""
    if p_terms not in (1, 2, 3):
        raise ValueError(f"p_terms {p_terms}: want 1, 2 or 3")
    if split_terms not in (3, 6, 9):
        raise ValueError(f"split_terms {split_terms}: want 3, 6 or 9")
    if p_terms < 3 and split_terms < 9:
        raise ValueError("p_terms and split_terms are two controls; give "
                         "one")
    terms = split_terms if split_terms < 9 else None
    B, H, Sq, hd = q.shape
    s = _scores(q, k, terms).mul_(1.0 / math.sqrt(hd))
    if causal:
        qpos = (q_offset + torch.arange(Sq, device=s.device)).repeat(
            s.shape[2] // Sq)
        kpos = torch.arange(k.shape[2], device=s.device)
        s.masked_fill_(kpos[None, :] > qpos[:, None], NEG_INF)
    p = s.sub_(s.amax(dim=-1, keepdim=True)).exp_()
    den = p.sum(dim=-1, keepdim=True).clamp_min_(1e-30)
    if p_terms < 3:
        p = sum(t.to(torch.float32) for t in split_bf16x3(p)[:p_terms])
    return (_pv(p, v, q, terms) / den.reshape(B, H, Sq, 1)).to(q.dtype)
