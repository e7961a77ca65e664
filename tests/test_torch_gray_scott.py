"""repro_torch's Gray–Scott app (paper §4.3) against repro's on the CPU:
laplacian, gs_rhs and gs_step in 2-D and 3-D; gs_step_padded through the
serial apply_stencil_local; 300 steps of run from repro's init_fields
carried across; the port's own pattern-against-death ordering (repro's
tests/test_system.py); pattern_energy against jnp.std."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import np_, rel

from repro.apps import gray_scott as JGS
from repro_torch import convert
from repro_torch.apps import gray_scott as TGS
from repro_torch.core import grid as TG

ATOL = 1e-6     # repro's own Pallas-vs-ref bound (tests/test_kernels.py)
SHAPES = [(24, 16), (16, 12, 8)]


def _cfgs(shape, **kw):
    j = JGS.GSConfig(shape=shape, **kw)
    return j, TGS.GSConfig(shape=shape, device="cpu", **kw)


def _fields(shape, seed):
    """A Gray–Scott-like state: u in [0.3, 1], v in [0, 0.5]."""
    rng = np.random.default_rng(seed)
    return ((0.3 + 0.7 * rng.uniform(size=shape)).astype(np.float32),
            (0.5 * rng.uniform(size=shape)).astype(np.float32))


def _close(got, ref, atol=ATOL):
    for g, r in zip(got, ref):
        assert tuple(g.shape) == tuple(r.shape)
        np.testing.assert_allclose(np_(g), np_(r), rtol=0, atol=atol)


@pytest.mark.parametrize("shape", SHAPES)
def test_laplacian_rhs_step_match_repro(shape):
    u, v = _fields(shape, seed=len(shape))
    tu, tv = convert.fields_from_numpy(u, v, device="cpu")
    # inv_h2 = 1: Laplacian values of order 1, where 1e-6 is a few ulps
    _close([TGS.laplacian(tu, 1.0)], [JGS.laplacian(jnp.asarray(u), 1.0)])
    jc, tc = _cfgs(shape)
    _close(TGS.gs_rhs(tu, tv, tc), JGS.gs_rhs(jnp.asarray(u),
                                              jnp.asarray(v), jc))
    _close(TGS.gs_step(tu, tv, tc), JGS.gs_step(jnp.asarray(u),
                                                jnp.asarray(v), jc))


@pytest.mark.parametrize("shape", SHAPES)
def test_padded_step_through_serial_grid_equals_step(shape):
    u, v = _fields(shape, seed=5)
    jc, tc = _cfgs(shape)
    tu, tv = convert.fields_from_numpy(u, v, device="cpu")
    got = TG.apply_stencil_local(TGS.gs_step_padded(tc), 1)(tu, tv)
    for g, r in zip(got, TGS.gs_step(tu, tv, tc)):
        assert torch.equal(g, r)
    _close(got, JGS.gs_step(jnp.asarray(u), jnp.asarray(v), jc))


def test_run_matches_repro_from_its_init(monkeypatch):
    jc, tc = _cfgs((48, 48))
    ju, jv = JGS.init_fields(jc, seed=0)
    carried = convert.fields_from_numpy(np.asarray(ju), np.asarray(jv),
                                        device="cpu")
    monkeypatch.setattr(TGS, "init_fields", lambda cfg, seed=0: carried)
    ref = JGS.run(jc, 300)
    got = TGS.run(tc, 300)
    for g, r in zip(got, ref):
        assert rel(g, r) <= 1e-4


def test_init_fields_layout():
    tc = TGS.GSConfig(shape=(32, 32), device="cpu")
    u, v = TGS.init_fields(tc, seed=3)
    ju, jv = JGS.init_fields(JGS.GSConfig(shape=(32, 32)), seed=3)
    np.testing.assert_array_equal(np_(v), np.asarray(jv))   # no noise on v
    assert u.dtype == v.dtype == torch.float32
    assert float(np.abs(np_(u) - np.asarray(ju)).max()) <= 0.05
    u2, _ = TGS.init_fields(tc, seed=3)
    assert torch.equal(u, u2)                # the seed decides the noise
    # the slab run over every rank (one here: a 1-rank gloo mesh) is the
    # serial run, bit for bit
    ud, vd = TGS.run_distributed(tc, 2, seed=3)
    us, vs = TGS.run(tc, 2, seed=3)
    assert torch.equal(ud, us) and torch.equal(vd, vs)


def test_pattern_vs_death():
    """§4.3/Fig 6 (repro's tests/test_system.py): the pattern-forming
    (F, k) yields structure; the death regime decays to homogeneous."""
    pat = TGS.GSConfig(shape=(48, 48), F=0.030, k=0.055, dt=1.0,
                       device="cpu")
    _, v = TGS.run(pat, 1500)
    assert TGS.pattern_energy(v) > 1e-2, "expected a Turing pattern"
    dead = dataclasses.replace(pat, F=0.010, k=0.070)
    _, v2 = TGS.run(dead, 1500)
    assert TGS.pattern_energy(v2) < TGS.pattern_energy(v)


def test_pattern_energy_matches_jnp_std():
    _, v = _fields((20, 10, 6), seed=9)
    got = TGS.pattern_energy(torch.from_numpy(v))
    assert abs(got - float(jnp.std(jnp.asarray(v)))) <= 1e-6 * got
