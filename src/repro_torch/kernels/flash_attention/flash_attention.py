"""Causal GQA flash attention, forward only (port of
``repro.kernels.flash_attention.flash_attention``; the LM stack's hot spot).

:func:`flash_attention` launches the hand-written CUDA kernel
``csrc/flash_attention.cu`` for CUDA tensors and runs the plain version
(``ref.flash_attention_ref``) for CPU tensors. The dtype picks the
kernel, both counted in :data:`LAUNCHES`: bf16 runs on the tensor cores
(``wgmma``, tiles by TMA, ``p`` split into three bf16 terms,
``ref.split_bf16x3``), fp32 on the SIMT pipes (fp32 on tensor cores would
be TF32, another function). Both compute the Pallas
kernel's function: fp32 scores, the causal mask ``kpos <= qpos`` counted
from 0 (aligned to the start, unlike ``repro``'s oracle
``attention_ref``), online softmax in fp32, ``p·v`` in fp32, the output in
q's dtype. :data:`LAUNCHES` counts kernel launches.

Unlike ``repro``'s, the kernel takes any ``Sq`` and ``Sk`` (the ragged
edge is masked inside) and strided inputs, so ``ops.mha``'s transposed
views go in without a copy.
"""
from __future__ import annotations

import ctypes
import functools
import math
import pathlib

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / \
    "flash_attention.cu"

#: Number of CUDA kernel launches made by :func:`flash_attention`.
LAUNCHES = 0

#: Largest head dim the kernel takes (a multiple of 8 from 8 up).
MAX_HEAD_DIM = 256

_ENTRIES = {torch.float32: "flash_attention_f32",
            torch.bfloat16: "flash_attention_bf16"}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name in _ENTRIES.values():
        fn = getattr(lib, name)
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, f, p, p]
        fn.restype = i
    return lib


def _check_cuda(q, k, v):
    hd = q.shape[3]
    if hd % 8 or not 8 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head dim must be a multiple of 8 in [8, "
                         f"{MAX_HEAD_DIM}], got {hd}")
    if q.shape[0] > 65535 or q.shape[1] > 65535:
        raise ValueError(f"B and H must be <= 65535, got {q.shape[:2]}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in _ENTRIES:
            raise TypeError(f"{name} must be float32 or bfloat16 on the "
                            f"card, got {t.dtype}")
        if t.dtype != q.dtype:
            raise TypeError(f"q, k and v must share a dtype, got {q.dtype}, "
                            f"{k.dtype}, {v.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.stride(3) != 1:
            raise ValueError(f"{name}'s head axis must be contiguous, "
                             f"strides {t.stride()}")
        if any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"{name} needs strides that are multiples of 8 "
                             f"elements and a 16-byte aligned start, got "
                             f"strides {t.stride()}")


def _launch(q, k, v, causal: bool):
    global LAUNCHES
    _check_cuda(q, k, v)
    B, H, Sq, hd = q.shape
    K, Sk = k.shape[1], k.shape[2]
    # q's strides where q is dense (ops.mha's transposed view), else
    # contiguous: either way the head axis is contiguous and every other
    # stride a multiple of hd
    o = torch.empty_like(q)
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, o) for s in t.stride()[:3]))
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, _ENTRIES[q.dtype])(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, H, K,
            Sq, Sk, hd, int(causal), 1.0 / math.sqrt(hd),
            ctypes.cast(strides, ctypes.c_void_p), stream)
    _build.check(err, _ENTRIES[q.dtype])
    LAUNCHES += 1
    return o


def flash_attention(q, k, v, *, causal: bool = True):
    """q: ``(B, H, Sq, hd)``; k, v: ``(B, K, Sk, hd)``; ``H = K·rep``.
    Returns ``(B, H, Sq, hd)`` in q's dtype: the kernel for CUDA tensors
    (fp32 or bf16, hd a multiple of 8 up to 256; TypeError or ValueError
    otherwise), the plain version for CPU tensors."""
    if q.dim() != 4 or k.dim() != 4 or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"want q (B, H, Sq, hd) and k, v (B, K, Sk, hd), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, Sq, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or H % k.shape[1]:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)} (same B and hd, H % K == 0)")
    if Sq < 1 or k.shape[2] < 1:
        raise ValueError(f"empty sequence: Sq={Sq}, Sk={k.shape[2]}")
    if q.is_cuda:
        return _launch(q, k, v, causal)
    return flash_attention_ref(q, k, v, causal=causal)
