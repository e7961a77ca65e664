"""Legacy-VTK ASCII writers (port of ``repro.io.vtk``; paper §3.7
``write()``) — particle sets as POLYDATA vertices, Cartesian grids as
STRUCTURED_POINTS, loadable in ParaView like OpenFPM's VTK output.

Inputs may be tensors on any device or numpy arrays: each is copied to
the host once. Float formatting is ``repro``'s, so the files are the same
bytes: every value is rounded through float32 and printed as
``f"{v:.5e}"`` (pinned against tests/data/golden_particles.vtk).
"""
from __future__ import annotations

import pathlib
from typing import Dict, Optional

import numpy as np
import torch


def _np(a) -> np.ndarray:
    """A host numpy array of a tensor (bf16 widened to fp32, which is
    exact) or of anything numpy takes."""
    if isinstance(a, torch.Tensor):
        a = a.detach()
        if a.dtype == torch.bfloat16:
            a = a.float()
        return a.cpu().numpy()
    return np.asarray(a)


def _fmt(v) -> str:
    """Deterministic fixed-width float: float32-rounded, 5 significant
    digits of scientific notation."""
    return f"{float(np.float32(v)):.5e}"


def _fmt_row(row) -> str:
    return " ".join(_fmt(v) for v in row)


def write_particles(path, x, props: Optional[Dict] = None,
                    valid=None) -> None:
    x = _np(x)
    if valid is not None:
        sel = _np(valid)
        x = x[sel]
        props = {k: _np(v)[sel] for k, v in (props or {}).items()}
    else:
        props = {k: _np(v) for k, v in (props or {}).items()}
    n, dim = x.shape
    if dim < 3:
        x = np.concatenate([x, np.zeros((n, 3 - dim))], axis=1)
    lines = ["# vtk DataFile Version 3.0", "repro particles", "ASCII",
             "DATASET POLYDATA", f"POINTS {n} float"]
    lines += [_fmt_row(row) for row in x]
    lines += [f"VERTICES {n} {2 * n}"]
    lines += [f"1 {i}" for i in range(n)]
    if props:
        lines.append(f"POINT_DATA {n}")
        for name, arr in props.items():
            if arr.ndim == 1:
                lines.append(f"SCALARS {name} float 1")
                lines.append("LOOKUP_TABLE default")
                lines += [_fmt(v) for v in arr]
            elif arr.ndim == 2 and arr.shape[1] <= 3:
                a = arr
                if a.shape[1] < 3:
                    a = np.concatenate(
                        [a, np.zeros((n, 3 - a.shape[1]))], axis=1)
                lines.append(f"VECTORS {name} float")
                lines += [_fmt_row(row) for row in a]
    pathlib.Path(path).write_text("\n".join(lines) + "\n")


def write_grid(path, field, origin=(0, 0, 0), spacing=(1, 1, 1),
               name="field") -> None:
    f = _np(field)
    dims = list(f.shape[:3]) + [1] * (3 - min(f.ndim, 3))
    lines = ["# vtk DataFile Version 3.0", "repro grid", "ASCII",
             "DATASET STRUCTURED_POINTS",
             f"DIMENSIONS {dims[0]} {dims[1]} {dims[2] if len(f.shape) > 2 else 1}",
             f"ORIGIN {origin[0]} {origin[1]} {origin[2] if len(origin) > 2 else 0}",
             f"SPACING {spacing[0]} {spacing[1]} {spacing[2] if len(spacing) > 2 else 1}",
             f"POINT_DATA {int(np.prod(f.shape[:3 if f.ndim >= 3 else f.ndim]))}",
             f"SCALARS {name} float 1", "LOOKUP_TABLE default"]
    flat = f.reshape(-1) if f.ndim <= 3 else f.reshape(-1, f.shape[-1])[:, 0]
    lines += [_fmt(v) for v in np.asarray(flat, np.float64)]
    pathlib.Path(path).write_text("\n".join(lines) + "\n")
