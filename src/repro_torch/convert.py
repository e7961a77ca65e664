"""Carry particle state, mesh fields, fleet ensembles, CMA-ES populations
and LM parameters between ``repro`` and ``repro_torch`` as numpy arrays.
A particle system's "weights" are its state: both packages step the same
state after the conversion.

Distributed state: ``repro`` holds a slab-decomposed container as global
arrays whose leading dim is sharded (rank d owns slots ``[d·cap,
(d+1)·cap)``); the port holds each rank's block.
:func:`scatter_to_slabs` lays global arrays out as ``repro``'s
``distribute`` does, :func:`dist_state_from_numpy` cuts one rank's block
out of them, and :func:`gather_dist_state` joins the blocks again.

The ``repro`` side is given as numpy (``np.asarray`` on each leaf of its
``ParticleSet`` or parameter pytree), so this module needs neither
package's other side."""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.core.particles import ParticleSet, resolve_device


def particles_from_numpy(x: np.ndarray, valid: np.ndarray,
                         props: Dict[str, np.ndarray],
                         device="cuda") -> ParticleSet:
    """A :class:`ParticleSet` on ``device`` from numpy leaves (copied)."""
    dev = resolve_device(device)
    t = lambda a: torch.from_numpy(np.array(a, copy=True)).to(dev)
    return ParticleSet(x=t(x), props={k: t(v) for k, v in props.items()},
                       valid=t(np.asarray(valid, bool)))


def particles_to_numpy(ps: ParticleSet
                       ) -> Tuple[np.ndarray, np.ndarray,
                                  Dict[str, np.ndarray]]:
    """(x, valid, props) as numpy arrays on the host."""
    n = lambda a: a.detach().cpu().numpy()
    return n(ps.x), n(ps.valid), {k: n(v) for k, v in ps.props.items()}


def field_from_numpy(a: np.ndarray, device="cuda") -> torch.Tensor:
    """A mesh field (e.g. the vortex app's vorticity ``w``, shape
    ``(nx, ny, nz, 3)``) on ``device`` from a numpy array (copied)."""
    dev = resolve_device(device)
    return torch.from_numpy(np.array(a, copy=True)).to(dev)


def fields_from_numpy(*arrays: np.ndarray, device="cuda"
                      ) -> Tuple[torch.Tensor, ...]:
    """Mesh fields (e.g. ``repro``'s Gray–Scott ``(u, v)``) on ``device``
    from numpy arrays (copied), one tensor per array."""
    return tuple(field_from_numpy(a, device=device) for a in arrays)


def _tensor(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":          # ml_dtypes' bfloat16 (JAX's)
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(dev)
    return torch.from_numpy(a).to(dev)


def lm_params_from_numpy(tree, device="cuda") -> Dict[str, Any]:
    """The port's LM parameter dict on ``device`` from ``repro``'s
    ``models.transformer.init_params`` pytree with numpy leaves (copied;
    bf16 leaves keep their bits). The two share names and layouts
    (blocks stacked ``(n_groups, ...)``; the MoE router and experts, the
    Mamba SSM's projections, conv taps and ``A_log``/``D``/``dt_bias``/
    ``norm`` too), so this is a map of the tree."""
    dev = resolve_device(device)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return _tensor(t, dev)

    return walk(tree)


def lm_params_sharded_from_numpy(tree, cfg, ctx, device="cuda"
                                 ) -> Dict[str, Any]:
    """This rank's blocks of ``repro``'s LM parameter pytree (numpy
    leaves) under the sharding ``ctx``: :func:`lm_params_from_numpy`
    after ``sharding.specs.shard_tree``'s cut, each leaf sliced on the
    host before it is copied to ``device`` (the layout
    ``models/transformer.param_specs`` gives, FSDP included)."""
    from repro_torch.models import transformer as T
    from repro_torch.sharding import specs as SP
    from repro_torch.core import runtime as RT
    dev = resolve_device(device)
    specs = T.param_specs(cfg, ctx)[0]

    def one(sp, a):
        with RT.on_mesh(ctx.mesh):
            return _tensor(np.asarray(a)[SP.local_slices(np.shape(a), sp,
                                                         ctx.mesh)], dev)

    return SP.tree_map2(one, specs, tree, is_leaf=SP.is_spec)


def ensemble_from_numpy(ens, device="cuda"):
    """The port's ``fleet.batch.EnsembleState`` on ``device`` from
    ``repro``'s (``jax.tree.map(np.asarray, ens)``: an object with
    ``member.ps.{x, valid, props}``, ``member.bounds``, ``member.fields``,
    ``params`` and ``active`` as numpy leaves with a leading batch axis;
    copied)."""
    from repro_torch.core.simulation import DistributedParticles
    from repro_torch.fleet.batch import EnsembleState
    dev = resolve_device(device)
    m = ens.member
    ps = particles_from_numpy(m.ps.x, m.ps.valid, dict(m.ps.props),
                              device=dev)
    member = DistributedParticles(
        ps=ps, bounds=_tensor(m.bounds, dev),
        fields={k: _tensor(v, dev) for k, v in dict(m.fields).items()})
    return EnsembleState(
        member=member,
        params={k: _tensor(v, dev) for k, v in dict(ens.params).items()},
        active=_tensor(np.asarray(ens.active, bool), dev))


def cma_state_from_numpy(st, device="cuda"):
    """The port's ``apps.cmaes.CMAStateT`` on ``device`` from ``repro``'s
    stacked ``CMAStateJ`` with numpy leaves (``(B, ...)``; float fields as
    float32, ``evals`` and ``gen`` as int32; copied)."""
    from repro_torch.apps.cmaes import CMAStateT
    dev = resolve_device(device)
    f32 = lambda a: torch.from_numpy(np.array(a, np.float32)).to(dev)
    i32 = lambda a: torch.from_numpy(np.array(a, np.int32)).to(dev)
    return CMAStateT(mean=f32(st.mean), sigma=f32(st.sigma), C=f32(st.C),
                     p_sigma=f32(st.p_sigma), p_c=f32(st.p_c),
                     best_f=f32(st.best_f), best_x=f32(st.best_x),
                     evals=i32(st.evals), gen=i32(st.gen))


def scatter_to_slabs(x: np.ndarray, valid: np.ndarray,
                     props: Dict[str, np.ndarray], bounds, ndev: int, *,
                     slab_axis: int = 0, cap_per_dev: int | None = None,
                     cap_factor: float = 3.0, col_bounds=None):
    """``repro``'s ``distribute`` layout of a particle set, as global numpy
    arrays ``(x, valid, props)`` with ``ndev * cap_per_dev`` rows: every
    valid particle in its owner's slot block (owner by ``bounds`` along
    ``slab_axis``), in index order. ``cap_per_dev`` defaults to
    ``ceil(n / ndev * cap_factor)``, with ``ndev`` counting every block.
    With ``col_bounds`` the layout is the pencil's: ``ndev`` row slabs
    times ``len(col_bounds) - 1`` column slabs along ``slab_axis + 1``,
    the owner of row i and column j the block ``i·ncols + j``."""
    val0 = np.asarray(valid, bool)
    xs = np.asarray(x)[val0]
    pr = {k: np.asarray(v)[val0] for k, v in props.items()}
    n = len(xs)
    owner = np.clip(np.searchsorted(np.asarray(bounds, np.float32),
                                    xs[:, slab_axis], "right") - 1,
                    0, ndev - 1)
    if col_bounds is not None:
        ncols = len(col_bounds) - 1
        owner_c = np.clip(np.searchsorted(np.asarray(col_bounds, np.float32),
                                          xs[:, slab_axis + 1], "right") - 1,
                          0, ncols - 1)
        owner = owner * ncols + owner_c
        ndev = ndev * ncols
    if cap_per_dev is None:
        cap_per_dev = int(np.ceil(n / ndev * cap_factor))
    cap = ndev * cap_per_dev
    X = np.full((cap, xs.shape[1]), ParticleSet.FILL, np.float32)
    PR = {k: np.zeros((cap,) + v.shape[1:], v.dtype) for k, v in pr.items()}
    V = np.zeros(cap, bool)
    for d in range(ndev):
        rows = np.nonzero(owner == d)[0]
        if len(rows) > cap_per_dev:
            raise ValueError(f"slab {d} holds {len(rows)} particles, above "
                             f"cap_per_dev={cap_per_dev}; raise it")
        b = d * cap_per_dev
        X[b:b + len(rows)] = xs[rows]
        for k in PR:
            PR[k][b:b + len(rows)] = pr[k][rows]
        V[b:b + len(rows)] = True
    return X, V, PR


def dist_state_from_numpy(x: np.ndarray, valid: np.ndarray,
                          props: Dict[str, np.ndarray], bounds, rank: int,
                          ndev: int, *,
                          fields: Dict[str, np.ndarray] | None = None,
                          device="cuda"):
    """Rank ``rank``'s block of a slab-sharded ``DistributedParticles``
    given as global numpy arrays (``repro``'s leaves, or
    :func:`scatter_to_slabs`): slots ``[rank·cap, (rank+1)·cap)`` with
    ``cap = len(x) // ndev``, the replicated ``bounds``, and the rank's
    uniform slab of each full mesh field in ``fields`` (copied)."""
    from repro_torch.core.simulation import DistributedParticles
    n = len(x)
    if n % ndev:
        raise ValueError(f"{n} slots do not split over {ndev} ranks")
    cap = n // ndev
    rows = slice(rank * cap, (rank + 1) * cap)
    ps = particles_from_numpy(x[rows], np.asarray(valid)[rows],
                              {k: np.asarray(v)[rows]
                               for k, v in props.items()}, device=device)
    blocks = {}
    for k, v in (fields or {}).items():
        if v.shape[0] % ndev:
            raise ValueError(f"mesh field {k!r}: leading axis {v.shape[0]} "
                             f"not divisible by {ndev} shards")
        nl = v.shape[0] // ndev
        blocks[k] = field_from_numpy(v[rank * nl:(rank + 1) * nl], device)
    return DistributedParticles(
        ps=ps, bounds=field_from_numpy(np.asarray(bounds, np.float32),
                                       device),
        fields=blocks)


def gather_dist_state(state, mesh, axis_name: str = "shards"):
    """The inverse of :func:`dist_state_from_numpy`, as every rank calls
    it: a ``DistributedParticles`` of the global arrays (the ranks'
    blocks in rank order, an all_gather) on each rank."""
    import dataclasses
    from repro_torch.core import runtime as RT

    def cat(a):
        return RT.all_gather(a, axis_name, tiled=True)

    with RT.on_mesh(mesh):
        ps = ParticleSet(x=cat(state.ps.x),
                         props={k: cat(v) for k, v in state.ps.props.items()},
                         valid=cat(state.ps.valid))
        fields = {k: cat(v) for k, v in state.fields.items()}
    return dataclasses.replace(state, ps=ps, fields=fields)
