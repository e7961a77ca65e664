"""repro_torch's decomposition layer against repro, on the CPU: the
Hilbert curve, the three-phase domain decomposition and the graph
partitioner (NumPy copies, bit for bit), the DLB balancer on tensors and
the SAR trigger, and DC-PSE on tests/test_dcpse.py's scattered sets."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import np_, rel, to_torch

from repro.core import cell_list as JCL
from repro.core import dcpse as JDC
from repro.core import decomposition as JD
from repro.core import dlb as JDLB
from repro.core import domain as JDOM
from repro.core import graph_partition as JGP
from repro.core import hilbert as JH
from repro.core.particles import from_positions as j_from_positions
from repro_torch.core import cell_list as TCL
from repro_torch.core import dcpse as TDC
from repro_torch.core import decomposition as TD
from repro_torch.core import dlb as TDLB
from repro_torch.core import domain as TDOM
from repro_torch.core import graph_partition as TGP
from repro_torch.core import hilbert as TH

DLB_TOL = 1e-6     # slab bounds: float32 cumulative sums in another order
DCPSE_TOL = 1e-4   # batched moment solves (LU) against XLA's


@pytest.mark.parametrize("dim,bits", [(1, 5), (2, 4), (3, 3), (4, 2)])
def test_hilbert_matches_repro(dim, bits):
    n = 1 << bits
    coords = np.stack(np.meshgrid(*[np.arange(n)] * dim, indexing="ij"),
                      -1).reshape(-1, dim)
    idx = TH.hilbert_index(coords, bits)
    np.testing.assert_array_equal(idx, JH.hilbert_index(coords, bits))
    np.testing.assert_array_equal(TH.hilbert_order(coords, bits),
                                  JH.hilbert_order(coords, bits))
    assert len(np.unique(idx)) == len(coords)


def _same_decomposition(t, j):
    assert t.grid_shape == j.grid_shape and t.nparts == j.nparts
    np.testing.assert_array_equal(t.assignment, j.assignment)
    assert [vars(s) for s in t.subdomains] == [vars(s) for s in j.subdomains]
    for k in ("indptr", "indices", "vwgt", "ewgt"):
        np.testing.assert_array_equal(getattr(t.graph, k),
                                      getattr(j.graph, k))
    assert t.imbalance() == j.imbalance() and t.edge_cut() == j.edge_cut()


@pytest.mark.parametrize("nparts,dim,method,bc", [
    (2, 1, "graph", "periodic"), (5, 2, "hilbert", "periodic"),
    (4, 2, "graph", "non_periodic"), (7, 3, "graph", "periodic"),
    (9, 3, "hilbert", "non_periodic")])
def test_decomposition_matches_repro(nparts, dim, method, bc):
    """decompose and rebalance (the migration-cost soft constraint) give
    repro's assignment, sub-domains, graph, loads and cut, bit for bit;
    positions map to the same owners."""
    args = ([0.0] * dim, [1.0] * dim)
    kw = dict(bc=[bc] * dim, ghost=0.05)
    t = TD.decompose(TDOM.make_domain(*args, **kw), nparts, ssd_per_part=8,
                     method=method)
    j = JD.decompose(JDOM.make_domain(*args, **kw), nparts, ssd_per_part=8,
                     method=method)
    _same_decomposition(t, j)
    w = np.full(t.n_ssd, 0.01)
    w[:t.n_ssd // 8] = 10.0
    for steps in (1, 100):
        _same_decomposition(TD.rebalance(t, w, steps_since_rebalance=steps),
                            JD.rebalance(j, w, steps_since_rebalance=steps))
    x = np.random.default_rng(nparts).uniform(size=(500, dim))
    np.testing.assert_array_equal(t.owner_of_position(x),
                                  j.owner_of_position(x))
    valid = np.arange(500) % 3 > 0
    np.testing.assert_array_equal(
        TDLB.ssd_costs_from_positions(t, torch.from_numpy(x),
                                      torch.from_numpy(valid)),
        JDLB.ssd_costs_from_positions(j, x, valid))


def test_graph_partition_matches_repro():
    """partition, repartition, edge_cut and imbalance on a weighted,
    periodic 12 x 10 grid graph, bit for bit."""
    rng = np.random.default_rng(7)
    vw = rng.uniform(0.5, 2.0, 120)
    tg = TGP.grid_graph((12, 10), vw, np.array([True, False]))
    jg = JGP.grid_graph((12, 10), vw, np.array([True, False]))
    for k in ("indptr", "indices", "vwgt", "ewgt"):
        np.testing.assert_array_equal(getattr(tg, k), getattr(jg, k))
    order = TH.hilbert_order(np.stack(np.meshgrid(
        np.arange(12), np.arange(10), indexing="ij"), -1).reshape(-1, 2), 4)
    for nparts in (3, 6):
        tp = TGP.partition(tg, nparts, seed_order=order)
        jp = JGP.partition(jg, nparts, seed_order=order)
        np.testing.assert_array_equal(tp, jp)
        assert TGP.edge_cut(tg, tp) == JGP.edge_cut(jg, jp)
        assert TGP.imbalance(tg, tp, nparts) == JGP.imbalance(jg, jp, nparts)
        mig = rng.uniform(size=120)
        np.testing.assert_array_equal(
            TGP.repartition(tg, tp, nparts, mig, steps_since_rebalance=3),
            JGP.repartition(jg, jp, nparts, mig, steps_since_rebalance=3))


def test_domain_matches_repro():
    t = TDOM.make_domain([0, -1], [2, 1], bc=["periodic", "non_periodic"],
                         ghost=0.1)
    j = JDOM.make_domain([0, -1], [2, 1], bc=["periodic", "non_periodic"],
                         ghost=0.1)
    x = np.random.default_rng(3).uniform(-3, 3, (50, 2))
    np.testing.assert_array_equal(t.wrap(x), j.wrap(x))
    np.testing.assert_array_equal(t.box.contains(x), j.box.contains(x))
    assert t.box.volume == j.box.volume and t.dim == j.dim
    with pytest.raises(ValueError):
        TDOM.Box((0.0,), (0.0,))


@pytest.mark.parametrize("ndev,weighted", [(4, False), (8, True), (3, False)])
def test_balanced_bounds_match_repro(ndev, weighted):
    """Clustered particles (tests/test_core.py's case, numpy draws):
    the port's bounds within DLB_TOL of repro's and balancing the
    counts; enforce_min_width and uniform_bounds too."""
    rng = np.random.default_rng(ndev)
    x = np.concatenate([0.1 * rng.uniform(size=800),
                        0.9 + 0.1 * rng.uniform(size=200)]).astype(np.float32)
    valid = rng.uniform(size=1000) > 0.05
    w = rng.uniform(0.5, 2.0, 1000).astype(np.float32) if weighted else None
    jb = JDLB.balanced_bounds(jnp.asarray(x), jnp.asarray(valid), ndev, 0.0,
                              1.0, weights=None if w is None
                              else jnp.asarray(w))
    tb = TDLB.balanced_bounds(torch.from_numpy(x), torch.from_numpy(valid),
                              ndev, 0.0, 1.0, weights=None if w is None
                              else torch.from_numpy(w))
    assert tb.dtype == torch.float32
    np.testing.assert_allclose(np_(tb), np_(jb), atol=DLB_TOL)
    if not weighted:
        counts = np.histogram(x[valid], np_(tb))[0]
        assert counts.max() <= 1.5 * counts.mean(), counts
    for mw in (0.05, 0.2, 0.5):
        np.testing.assert_allclose(
            np_(TDLB.enforce_min_width(tb, mw)),
            np_(JDLB.enforce_min_width(jnp.asarray(np_(tb)), mw)),
            atol=DLB_TOL)
    np.testing.assert_allclose(np_(TDLB.uniform_bounds(ndev, -1.0, 2.0)),
                               np_(JDLB.uniform_bounds(ndev, -1.0, 2.0)),
                               atol=DLB_TOL)


def test_sar_fires_as_repro():
    """The same firing sequence over a degrading, then recovering,
    imbalance, with a rebalance-cost update in between."""
    seq = [0.001 * s for s in range(60)] + [0.05] * 10 + [0.0] * 10
    t, j = TDLB.SARController(0.5), JDLB.SARController(0.5)
    fired_t, fired_j = [], []
    for k, imb in enumerate(seq):
        if k == 40:
            t.update_rebalance_cost(0.2)
            j.update_rebalance_cost(0.2)
        fired_t.append(t.observe(1.0 + imb, 1.0))
        fired_j.append(j.observe(1.0 + imb, 1.0))
    assert fired_t == fired_j and any(fired_t) and not fired_t[0]
    assert t.rebalance_cost == j.rebalance_cost


def _scattered(n, seed):
    """tests/test_dcpse.py's scattered set with numpy jitter: a side x side
    lattice in the unit square, each point moved by up to 0.3 spacings;
    repro's and the port's particles, cell lists and Verlet lists."""
    side = int(np.sqrt(n))
    rng = np.random.default_rng(seed)
    g = (np.stack(np.meshgrid(np.arange(side), np.arange(side),
                              indexing="ij"), -1).reshape(-1, 2) + 0.5) / side
    x = (g + rng.uniform(-0.3, 0.3, g.shape) / side).astype(np.float32)
    jps = j_from_positions(jnp.asarray(x), capacity=side * side)
    tps = to_torch(jps)
    r_cut = 3.5 / side
    kw = dict(box_lo=(0., 0.), box_hi=(1., 1.),
              grid_shape=JCL.grid_shape_for((0, 0), (1, 1), r_cut),
              periodic=(False, False), cell_cap=64)
    jvl = JCL.build_verlet(jps, JCL.build_cell_list(jps, **kw), r_cut,
                           k_max=48)
    tvl = TCL.build_verlet(tps, TCL.build_cell_list(tps, **kw), r_cut,
                           k_max=48)
    assert int(jvl.overflow) == int(tvl.overflow) == 0
    return jps, jvl, tps, tvl


def _interior(x, margin=0.15):
    return ((x[:, 0] > margin) & (x[:, 0] < 1 - margin)
            & (x[:, 1] > margin) & (x[:, 1] < 1 - margin))


@pytest.mark.parametrize("n,seed", [(400, 0), (1600, 1)])
def test_dcpse_matches_repro(n, seed):
    """The port's operators against repro's to DCPSE_TOL (max-abs error
    over repro's max): the gradient of a linear, a quadratic and a smooth
    field at every particle, the mixed derivative of the smooth one at
    every particle, and the Laplacian of the quadratic and smooth ones at
    the interior particles (tests/test_dcpse.py's 0.15 margin). Near the
    non-periodic edges the one-sided second-derivative moment systems are
    ill-conditioned in float32, and both packages' Laplacians there differ
    by ~1e-3 of the max; where the exact derivative is 0 (the Laplacian of
    the linear field, the mixed one of the quadratic) both return
    rounding noise, so those are not compared. The interior errors stay
    within tests/test_dcpse.py's bounds."""
    jps, jvl, tps, tvl = _scattered(n, seed)
    jx, tx = jps.x, tps.x
    lin = (3.0 * jx[:, 0] - 2.0 * jx[:, 1] + 0.7,
           3.0 * tx[:, 0] - 2.0 * tx[:, 1] + 0.7)
    quad = (jx[:, 0] ** 2 + 2.0 * jx[:, 1] ** 2,
            tx[:, 0] ** 2 + 2.0 * tx[:, 1] ** 2)
    smooth = (jnp.sin(2 * jnp.pi * jx[:, 0]) * jnp.cos(2 * jnp.pi * jx[:, 1]),
              torch.sin(2 * np.pi * tx[:, 0])
              * torch.cos(2 * np.pi * tx[:, 1]))
    sel = _interior(np_(tx))
    for jf, tf in (lin, quad, smooth):
        assert rel(tf, jf) <= 1e-6
        assert rel(TDC.gradient(tps, tvl, tf),
                   JDC.gradient(jps, jvl, jf)) <= DCPSE_TOL
    for jf, tf in (quad, smooth):
        got = np_(TDC.laplacian(tps, tvl, tf))
        assert rel(got[sel], np_(JDC.laplacian(jps, jvl, jf))[sel]) \
            <= DCPSE_TOL
    jf, tf = smooth
    assert rel(TDC.dcpse_apply(tps, tvl, tf, alpha=(1, 1)),
               JDC.dcpse_apply(jps, jvl, jf, alpha=(1, 1))) <= DCPSE_TOL
    g = np_(TDC.gradient(tps, tvl, lin[1]))[sel]
    np.testing.assert_allclose(g[:, 0], 3.0, atol=2e-2)
    np.testing.assert_allclose(g[:, 1], -2.0, atol=2e-2)
    lap = np_(TDC.laplacian(tps, tvl, quad[1]))[sel]
    np.testing.assert_allclose(lap, 6.0, atol=0.5)
    np.testing.assert_array_equal(TDC.multi_indices(2, 3),
                                  JDC.multi_indices(2, 3))
