"""Carry particle state, mesh fields, fleet ensembles, CMA-ES populations
and LM parameters between ``repro`` and ``repro_torch`` as numpy arrays.
A particle system's "weights" are its state: both packages step the same
state after the conversion.

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
    (blocks stacked ``(n_groups, ...)``), so this is a map of the tree."""
    dev = resolve_device(device)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return _tensor(t, dev)

    return walk(tree)


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
