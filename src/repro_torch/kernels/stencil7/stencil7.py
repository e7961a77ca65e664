"""Fused Gray–Scott 7-point stencil step (port of
``repro.kernels.stencil7.stencil7``; paper §4.3's hot loop).

One call computes both species' periodic diffusion, the ``u·v²``
reaction, the feed and kill terms and the explicit-Euler update.
:func:`gray_scott_step` launches the hand-written CUDA kernel
``csrc/stencil7.cu`` for CUDA tensors and runs the plain version
(``ref.gray_scott_step_ref``) for CPU tensors. The kernel repeats the
plain version's operations in its order, each rounded as PyTorch rounds
it, so on the card the two agree bit for bit. :data:`LAUNCHES` counts
kernel launches.
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


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.gray_scott_step_f32.argtypes = [p, p, p, p, i, i, i, f, f, f, f, f,
                                        f, p]
    lib.gray_scott_step_f32.restype = i
    return lib


def _step_cuda(u, v, *, Du, Dv, F, k, dt, inv_h2):
    global LAUNCHES
    for name, t in (("u", u), ("v", v)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 on the card, got "
                            f"{t.dtype}")
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
    lib = _lib()
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gray_scott_step_f32(u.data_ptr(), v.data_ptr(),
                                      un.data_ptr(), vn.data_ptr(), nx, ny,
                                      nz, *(float(c) for c in consts),
                                      stream)
    _build.check(err, "gray_scott_step_f32")
    LAUNCHES += 1
    return un, vn


def gray_scott_step(u, v, *, Du: float, Dv: float, F: float, k: float,
                    dt: float, inv_h2: float, block_x: int = 8):
    """One fused explicit-Euler step on periodic ``(nx, ny, nz)`` fields;
    returns new ``(u, v)``: the kernel for CUDA tensors (float32 only,
    TypeError otherwise), the plain version for CPU tensors.
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
