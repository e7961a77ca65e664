"""Helpers shared by the tests/test_torch_*.py parity tests: carry a
``repro`` (JAX) particle state into ``repro_torch`` through numpy, pull the
workload states out of benchmarks/backend_compare.py, and measure
divergence the way that module does, and build the M'4 interpolation cases
of tests/test_kernels.py from numpy draws."""
import inspect
import pathlib
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from repro_torch import convert  # noqa: E402


def to_torch(ps_jax, device="cpu"):
    """The port's ParticleSet holding the same state as a JAX one."""
    return convert.particles_from_numpy(
        np.asarray(ps_jax.x), np.asarray(ps_jax.valid),
        {k: np.asarray(v) for k, v in ps_jax.props.items()}, device=device)


def case_state(case):
    """(cfg, ps) of a backend_compare case: the state its jitted ``fn``
    closes over."""
    cfg, fn = case()
    return cfg, inspect.getclosurevars(fn.__wrapped__).nonlocals["ps"]


def np_(a):
    """numpy view of a torch tensor or a JAX array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def rel(a, b):
    """max-abs relative divergence of a against reference b
    (benchmarks/backend_compare.py's ``rel``)."""
    a, b = np_(a).astype(np.float64), np_(b).astype(np.float64)
    return float(np.abs(a - b).max()) / (float(np.abs(b).max()) + 1e-9)


def interp_case(dim, seed, n=400, edge_cluster=False):
    """tests/test_kernels.py::_interp_case with numpy draws: (kw, x, val,
    valid, field) on the (16, 8, 8)[:dim] mesh of a (2, 1, 1) box."""
    shape = (16, 8, 8)[:dim]
    box_hi = np.asarray((2.0, 1.0, 1.0)[:dim], np.float32)
    kw = dict(shape=shape, box_lo=(0.0,) * dim,
              box_hi=tuple(float(v) for v in box_hi), periodic=(True,) * dim)
    rng = np.random.default_rng(seed)
    x = (rng.uniform(size=(n, dim)) * box_hi).astype(np.float32)
    if edge_cluster:
        # hug the box faces so every M'4 stencil wraps
        x = np.mod(x * np.float32(0.04) - np.float32(0.02) * box_hi,
                   box_hi).astype(np.float32)
    val = rng.normal(size=(n, 3)).astype(np.float32)
    valid = rng.uniform(size=n) > 0.2
    field = rng.normal(size=shape + (3,)).astype(np.float32)
    return kw, x, val, valid, field
