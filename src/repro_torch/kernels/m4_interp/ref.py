"""Oracles for the M'4 interpolation kernels — delegate to the plain
``core/interp.py`` implementations (one source of truth, as in the other
kernel packages' ref modules)."""
from __future__ import annotations

from repro_torch.core.interp import m2p as m2p_ref, p2m as p2m_ref  # noqa: F401


def m2p_fused_ref(fields, x, valid, **kw):
    """Fused-gather oracle: one independent m2p per field."""
    return tuple(m2p_ref(f, x, valid, **kw) for f in fields)
