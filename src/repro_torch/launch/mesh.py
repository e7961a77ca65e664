"""Production mesh construction (``repro``'s ``launch/mesh.py``).

Single pod:  (16, 16)    axes ("data", "model")          — 256 ranks
Multi-pod:   (2, 16, 16) axes ("pod", "data", "model")   — 512 ranks

Meshes are ``runtime.make_mesh`` meshes over the ranks of the process
group (one rank a card, NCCL). The dry-run prices these meshes without
them: ``launch/dryrun.py`` builds the same shapes with
``runtime.make_dry_mesh``.
"""
from __future__ import annotations

import math

from repro_torch.core import runtime as RT

SINGLE = ((16, 16), ("data", "model"))
MULTI = ((2, 16, 16), ("pod", "data", "model"))


def production_shape(multi_pod: bool = False):
    """``(shape, axis names)`` of the single- or multi-pod mesh."""
    return MULTI if multi_pod else SINGLE


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The production mesh over the process group's ranks; raises, naming
    the 256 or 512 ranks it needs, when the group is smaller."""
    shape, axes = production_shape(multi_pod)
    n = math.prod(shape)
    have = RT.device_count()
    if have < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} ranks (one a card), the process group "
            f"has {have}; run under torchrun with {n} processes, or price "
            "the cell without them: python -m repro_torch.launch.dryrun")
    return RT.make_mesh(shape, axes, device_type=device_type)


def make_local_mesh(shape=None, axes=("data", "model"), *,
                    device_type: str = "cuda"):
    """A mesh over whatever ranks there are (tests, examples): ``(1,
    world)`` over ``("data", "model")`` by default."""
    if shape is None:
        shape, axes = (1, RT.device_count()), ("data", "model")
    return RT.make_mesh(tuple(int(s) for s in shape), axes,
                        device_type=device_type)
