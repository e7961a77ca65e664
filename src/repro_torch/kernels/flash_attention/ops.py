"""Layout adapter between the model's ``(B, S, H, hd)`` and the kernel's
``(B, H, S, hd)`` (``repro``'s ``flash_attention/ops.py``)."""
from __future__ import annotations

from repro_torch.kernels.flash_attention.flash_attention import \
    flash_attention


def mha(q, k, v, *, causal: bool = True, q_offset: int = 0):
    """q: ``(B, Sq, H, hd)``; k, v: ``(B, Sk, K, hd)``; ``q_offset``: the
    causal mask's position of query row 0. Returns
    ``(B, Sq, H, hd)``: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors. The transposes are views: the kernel reads them
    through their strides and writes its output in q's layout, so the
    result comes back as a contiguous ``(B, Sq, H, hd)`` tensor."""
    o = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=causal,
                        q_offset=q_offset)
    return o.transpose(1, 2)
