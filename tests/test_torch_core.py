"""repro_torch core against repro: particles, integrators, cell lists.
Inputs come from numpy with a fixed seed or from the workload states of
benchmarks/backend_compare.py, converted through repro_torch.convert."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import case_state, np_, to_torch
from benchmarks import backend_compare as BC

from repro.apps import md as jmd
from repro.apps import sph as jsph
from repro.core import cell_list as JCL
from repro.core import particles as JP
from repro.numerics import integrators as JTI
from repro_torch.core import cell_list as TCL
from repro_torch.core import particles as TP
from repro_torch.numerics import integrators as TTI


def _bits(a):
    return np_(a).view(np.int32)


def test_init_grid_matches_bitwise():
    spec_j = {"v": ((3,), jnp.float32)}
    spec_t = {"v": ((3,), torch.float32)}
    a = JP.init_grid((0.0, -0.5, 0.1), (1.0, 0.7, 0.9), (7, 5, 3),
                     capacity=120, prop_specs=spec_j)
    b = TP.init_grid((0.0, -0.5, 0.1), (1.0, 0.7, 0.9), (7, 5, 3),
                     capacity=120, prop_specs=spec_t, device="cpu")
    np.testing.assert_array_equal(_bits(b.x), _bits(a.x))
    np.testing.assert_array_equal(np_(b.valid), np_(a.valid))
    np.testing.assert_array_equal(np_(b.props["v"]), np_(a.props["v"]))


def _random_state(seed=0, n=64, cap=80, dim=3):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.2, 1.2, (cap, dim)).astype(np.float32)
    valid = rng.uniform(size=cap) < 0.8
    v = rng.normal(size=(cap, dim)).astype(np.float32)
    f = rng.normal(size=(cap, dim)).astype(np.float32) * 50
    jps = JP.ParticleSet(x=jnp.asarray(x), valid=jnp.asarray(valid),
                         props={"v": jnp.asarray(v), "f": jnp.asarray(f)})
    return jps, to_torch(jps)


@pytest.mark.parametrize("name", ["velocity_verlet_kick",
                                  "velocity_verlet_kick2", "leapfrog"])
def test_integrator_step_matches(name):
    jps, tps = _random_state()
    a = getattr(JTI, name)(jps, 0.003)
    b = getattr(TTI, name)(tps, 0.003)
    np.testing.assert_allclose(np_(b.x), np_(a.x), rtol=0, atol=1e-7)
    np.testing.assert_allclose(np_(b.props["v"]), np_(a.props["v"]),
                               rtol=0, atol=1e-7)


def test_wrap_periodic_matches_at_box_edge():
    """torch.remainder gives jnp.mod's float32 results, edge values
    included (just below 0, just below L, exactly L, -0.0)."""
    jps, _ = _random_state(seed=1)
    x = np_(jps.x).copy()
    edge = np.array([-1e-9, -0.0, 0.0, 1.0, 1.0 - 1e-8, 1.0 + 1e-8, 2.0,
                     -1.0, -1e-30, 0.9999999], np.float32)
    x[:len(edge), 0] = edge
    x[:len(edge), 1] = edge[::-1]
    jps = jps.replace(x=jnp.asarray(x))
    tps = to_torch(jps)
    for per in ((True, True, True), (True, False, True)):
        a = JTI.wrap_periodic(jps, (0.0,) * 3, (1.0,) * 3, per)
        b = TTI.wrap_periodic(tps, (0.0,) * 3, (1.0,) * 3, per)
        np.testing.assert_array_equal(_bits(b.x), _bits(a.x))


def test_particle_set_ops_match():
    jps, tps = _random_state(seed=2)
    np.testing.assert_array_equal(np_(tps.masked_x()), np_(jps.masked_x()))
    a, b = jps.compact(), tps.compact()
    np.testing.assert_array_equal(np_(b.x), np_(a.x))
    np.testing.assert_array_equal(np_(b.valid), np_(a.valid))
    jo, to = _random_state(seed=3)
    (a, ovf_a), (b, ovf_b) = jps.add_count(jo), tps.add_count(to)
    assert int(ovf_a) == int(ovf_b) > 0
    np.testing.assert_array_equal(np_(b.x), np_(a.x))
    np.testing.assert_array_equal(np_(b.valid), np_(a.valid))
    np.testing.assert_array_equal(np_(b.props["v"]), np_(a.props["v"]))
    assert int(tps.count()) == int(jps.count())


def _overflow_cloud():
    rng = np.random.default_rng(4)
    x = np.concatenate([rng.uniform(0, 1, (60, 3)),
                        rng.uniform(0.30, 0.45, (40, 3))]).astype(np.float32)
    ps = JP.from_positions(jnp.asarray(x), capacity=110)
    kw = dict(box_lo=(0.0,) * 3, box_hi=(1.0,) * 3, grid_shape=(4, 4, 4),
              periodic=(True,) * 3, cell_cap=6)
    return kw, ps


def _cell_case(name):
    if name == "md":
        cfg, ps = case_state(BC.md_case)
        return jmd._cl_kw(cfg), ps
    if name == "sph":
        cfg, ps = case_state(BC.sph_case)
        return jsph._cl_kw(cfg), ps
    return _overflow_cloud()


@pytest.mark.parametrize("name", ["md", "sph", "overflow"])
def test_build_cell_list_identical(name):
    kw, jps = _cell_case(name)
    a = JCL.build_cell_list(jps, **kw)
    b = TCL.build_cell_list(to_torch(jps), **kw)
    for field in ("cells", "counts", "cell_id"):
        np.testing.assert_array_equal(np_(getattr(b, field)),
                                      np_(getattr(a, field)), err_msg=field)
        assert np_(getattr(b, field)).dtype == np.int32
    assert int(b.overflow) == int(a.overflow)
    if name == "overflow":
        assert int(b.overflow) > 0


@pytest.mark.parametrize("geom", [
    dict(grid_shape=(3, 4, 5), periodic=(True, True, True)),
    dict(grid_shape=(2, 3, 1), periodic=(True, False, True)),
    dict(grid_shape=(4, 2), periodic=(False, True)),
])
def test_neighborhood_identical(geom):
    dim = len(geom["grid_shape"])
    kw = dict(box_lo=(0.0,) * dim, box_hi=(1.0, 0.5, 2.0)[:dim],
              cell_cap=4, **geom)
    x = np.full((5, dim), 0.25, np.float32)
    jps = JP.from_positions(jnp.asarray(x), capacity=5)
    a = JCL.neighborhood(JCL.build_cell_list(jps, **kw))
    b = TCL.neighborhood(TCL.build_cell_list(to_torch(jps), **kw))
    np.testing.assert_array_equal(np_(b[0]), np_(a[0]))
    np.testing.assert_array_equal(np_(b[1]), np_(a[1]))


def test_min_image_and_moved_beyond_match():
    kw, jps = _overflow_cloud()
    kw = dict(kw, periodic=(True, False, True))
    jcl = JCL.build_cell_list(jps, **kw)
    tcl = TCL.build_cell_list(to_torch(jps), **kw)
    rng = np.random.default_rng(5)
    dx = rng.uniform(-1.5, 1.5, (50, 3)).astype(np.float32)
    dx[0] = 1e30
    np.testing.assert_array_equal(
        np_(TCL._min_image(torch.from_numpy(dx), tcl)),
        np_(JCL._min_image(jnp.asarray(dx), jcl)))
    x0 = np_(jps.x).copy()
    valid = np_(jps.valid).copy()
    for step in (0.01, 0.2):
        x1 = x0 + step
        a = JCL.moved_beyond(jnp.asarray(x1), jnp.asarray(x0),
                             jnp.asarray(valid), 0.1)
        b = TCL.moved_beyond(torch.from_numpy(x1), torch.from_numpy(x0),
                             torch.from_numpy(valid), 0.1)
        assert bool(a) == bool(b)
