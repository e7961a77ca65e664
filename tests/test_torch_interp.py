"""repro_torch M'4 interpolation oracle, FFT Poisson solve and remeshing
engine against repro: the same numpy inputs through core/interp p2m/m2p
(2-D and 3-D, interior and edge-clustered), fft_poisson, the Helmholtz
projection, node_positions and seed_from_mesh (exact), and remesh."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import interp_case, np_, rel

from repro.apps import vortex as JV
from repro.core import interp as JIP
from repro.core import remesh as JRM
from repro.numerics import poisson as JPS
from repro_torch.apps import vortex as TV
from repro_torch.core import interp as TIP
from repro_torch.core import remesh as TRM
from repro_torch.numerics import poisson as TPS

TOL = 1e-5      # fp32, only the summation order differs


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("dim,seed,edge", [(2, 0, False), (3, 1, False),
                                           (2, 2, True), (3, 3, True)])
def test_p2m_matches_repro(dim, seed, edge):
    kw, x, val, valid, _ = interp_case(dim, seed, edge_cluster=edge)
    ref = JIP.p2m(jnp.asarray(x), jnp.asarray(val), jnp.asarray(valid), **kw)
    got = TIP.p2m(*_t(x, val, valid), **kw)
    assert got.shape == ref.shape
    assert rel(got, ref) <= TOL
    # scalar values take the same path
    ref_s = JIP.p2m(jnp.asarray(x), jnp.asarray(val[:, 0]),
                    jnp.asarray(valid), **kw)
    got_s = TIP.p2m(*_t(x, val[:, 0], valid), **kw)
    assert rel(got_s, ref_s) <= TOL


@pytest.mark.parametrize("dim,seed,edge", [(2, 4, False), (3, 5, False),
                                           (2, 6, True), (3, 7, True)])
def test_m2p_matches_repro(dim, seed, edge):
    kw, x, _, valid, field = interp_case(dim, seed, edge_cluster=edge)
    ref = JIP.m2p(jnp.asarray(field), jnp.asarray(x), jnp.asarray(valid),
                  **kw)
    got = TIP.m2p(*_t(field, x, valid), **kw)
    assert got.shape == ref.shape
    assert rel(got, ref) <= TOL
    assert float(got[~torch.from_numpy(valid)].abs().max()) == 0.0


def test_m4_prime_matches_repro():
    s = np.linspace(-2.5, 2.5, 1001).astype(np.float32)
    np.testing.assert_allclose(np_(TIP.m4_prime(torch.from_numpy(s))),
                               np.asarray(JIP.m4_prime(jnp.asarray(s))),
                               atol=1e-7)


@pytest.mark.parametrize("vec", [False, True])
def test_fft_poisson_matches_repro(vec):
    rng = np.random.default_rng(8)
    shape = (16, 8, 8)
    lengths = (4.0, 2.0, 2.0)
    rhs = rng.normal(size=shape + ((3,) if vec else ())).astype(np.float32)
    ref = JPS.fft_poisson(jnp.asarray(rhs), lengths)
    got = TPS.fft_poisson(torch.from_numpy(rhs), lengths)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert rel(got, ref) <= TOL


def test_project_divfree_matches_repro():
    base = dict(shape=(16, 8, 8), lengths=(4.0, 2.0, 2.0))
    jc = JV.VortexConfig(**base)
    tc = TV.VortexConfig(device="cpu", **base)
    w_j = JV.init_ring(jc)
    w_t = TV.init_ring(tc)
    np.testing.assert_array_equal(np_(w_t), np.asarray(w_j))
    assert rel(TV.project_divfree(w_t, tc), JV.project_divfree(w_j, jc)) \
        <= TOL
    hs = [L / n for n, L in zip(base["shape"], base["lengths"])]
    u_t = TV.velocity_from_vorticity(w_t, tc)
    assert rel(u_t, JV.velocity_from_vorticity(w_j, jc)) <= TOL
    assert rel(TV.rhs_field(w_t, u_t, tc),
               JV.rhs_field(w_j, jnp.asarray(np_(u_t)), jc)) <= TOL
    assert rel(TV.divergence(w_t, hs), JV.divergence(w_j, hs)) <= TOL


def test_node_positions_exact():
    args = ((6, 4, 5), (0.0, -1.0, 0.5), (1.5, 1.0, 2.0), (True,) * 3)
    np.testing.assert_array_equal(np_(TRM.node_positions(*args)),
                                  np.asarray(JRM.node_positions(*args)))


@pytest.mark.parametrize("threshold,capacity", [(0.0, 0), (0.8, 0),
                                                (0.8, 300)])
def test_seed_from_mesh_matches_repro(threshold, capacity):
    """Dense branch and the threshold/compaction branch (with an overflow
    case): positions, values, validity and overflow exactly."""
    rng = np.random.default_rng(9)
    shape = (8, 8, 8)
    field = rng.normal(size=shape + (3,)).astype(np.float32)
    box = dict(box_lo=(0., 0., 0.), box_hi=(1., 2., 1.),
               periodic=(True, True, True))
    jps, jo = JRM.seed_from_mesh(jnp.asarray(field), threshold=threshold,
                                 capacity=capacity, **box)
    tps, to = TRM.seed_from_mesh(torch.from_numpy(field),
                                 threshold=threshold, capacity=capacity,
                                 **box)
    assert int(to) == int(jo)
    np.testing.assert_array_equal(np_(tps.valid), np.asarray(jps.valid))
    np.testing.assert_array_equal(np_(tps.x), np.asarray(jps.x))
    np.testing.assert_array_equal(np_(tps.props["w"]),
                                  np.asarray(jps.props["w"]))
    if capacity:
        assert int(to) > 0


@pytest.mark.parametrize("interp", ["scatter", "cells"])
def test_remesh_matches_repro(interp):
    """Off-lattice particles → P2M → re-seed, on both deposit paths."""
    kw, x, val, valid, _ = interp_case(3, 10)
    jps, jmesh, jo = JRM.remesh(jnp.asarray(x), jnp.asarray(val),
                                jnp.asarray(valid), **kw)
    tps, tmesh, to = TRM.remesh(*_t(x, val, valid), interp=interp,
                                cell_cap=256, **kw)
    assert int(to) == int(jo) == 0
    assert rel(tmesh, jmesh) <= TOL
    assert rel(tps.props["w"], jps.props["w"]) <= TOL
    np.testing.assert_array_equal(np_(tps.x), np.asarray(jps.x))
    # total vorticity is conserved by the deposit
    np.testing.assert_allclose(np_(tmesh.sum((0, 1, 2))),
                               val[valid].sum(0), rtol=1e-4, atol=1e-4)
