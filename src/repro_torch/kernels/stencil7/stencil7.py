"""Fused Gray–Scott 7-point stencil step (port of
``repro.kernels.stencil7.stencil7``; paper §4.3's hot loop).

One call computes both species' periodic diffusion, the ``u·v²``
reaction, the feed and kill terms and the explicit-Euler update.
:func:`gray_scott_step` launches the hand-written CUDA kernel
``csrc/stencil7.cu`` for CUDA tensors and runs the plain version
(``ref.gray_scott_step_ref``) for CPU tensors. The kernel takes
float32, bfloat16 and float16 fields, as ``repro``'s kernel computes in
the fields' dtype; it repeats the plain version's operations in its
order, each rounded as PyTorch rounds it on the card (in fp32, the
result rounded to the dtype), so on the card the two agree bit for bit.
:data:`LAUNCHES` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.stencil7.ref import gray_scott_step_ref

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "stencil7.cu"

#: Number of CUDA kernel launches made by :func:`gray_scott_step`.
LAUNCHES = 0

#: Largest extent of axes 0 and 1 (CUDA grid dimensions y and z).
_MAX_GRID_YZ = 65535

#: The kernel's C entry per field dtype (float64 stays on the plain
#: version: the TPU kernel has no fp64 either).
_ENTRIES = {torch.float32: "gray_scott_step_f32",
            torch.bfloat16: "gray_scott_step_bf16",
            torch.float16: "gray_scott_step_f16"}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name in _ENTRIES.values():
        fn = getattr(lib, name)
        fn.argtypes = [p, p, p, p, i, i, i, f, f, f, f, f, f, p]
        fn.restype = i
    return lib


def _step_cuda(u, v, *, Du, Dv, F, k, dt, inv_h2):
    global LAUNCHES
    for name, t in (("u", u), ("v", v)):
        if t.dtype not in _ENTRIES:
            raise TypeError(f"{name} must be float32, bfloat16 or float16 "
                            f"on the card, got {t.dtype}")
        if t.dtype != u.dtype:
            raise TypeError(f"u and v must share a dtype, got {u.dtype} "
                            f"and {v.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if v.device != u.device:
        raise ValueError(f"v is on {v.device}, u on {u.device}")
    nx, ny, nz = u.shape
    if max(nx, ny) > _MAX_GRID_YZ:
        raise ValueError(f"axes 0 and 1 must be <= {_MAX_GRID_YZ}, got "
                         f"{(nx, ny)}")
    un = torch.empty_like(u)
    vn = torch.empty_like(v)
    # each constant as the float PyTorch's scalar op uses; F + k summed in
    # double first, as the plain version's Python expression does
    consts = (Du, Dv, F, F + k, dt, inv_h2)
    entry = _ENTRIES[u.dtype]
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(_lib(), entry)(u.data_ptr(), v.data_ptr(),
                                     un.data_ptr(), vn.data_ptr(), nx, ny,
                                     nz, *(float(c) for c in consts), stream)
    _build.check(err, entry)
    LAUNCHES += 1
    return un, vn


def gray_scott_step(u, v, *, Du: float, Dv: float, F: float, k: float,
                    dt: float, inv_h2: float, block_x: int = 8):
    """One fused explicit-Euler step on periodic ``(nx, ny, nz)`` fields;
    returns new ``(u, v)`` of their dtype: the kernel for CUDA tensors
    (float32, bfloat16 or float16; TypeError otherwise), the plain
    version for CPU tensors.
    ``nx % block_x == 0`` is ``repro``'s input contract (ValueError
    otherwise); the kernel tiles as it likes."""
    if u.dim() != 3 or tuple(v.shape) != tuple(u.shape):
        raise ValueError(f"u and v must be 3-D fields of one shape, got "
                         f"{tuple(u.shape)} and {tuple(v.shape)}")
    if u.shape[0] % block_x:
        raise ValueError(f"nx={u.shape[0]} is not a multiple of "
                         f"block_x={block_x}")
    kw = dict(Du=Du, Dv=Dv, F=F, k=k, dt=dt, inv_h2=inv_h2)
    if u.is_cuda:
        return _step_cuda(u, v, **kw)
    return gray_scott_step_ref(u, v, **kw)
