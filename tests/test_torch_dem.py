"""repro_torch DEM (the avalanche of paper §4.5, on the CPU) against repro:
Verlet (contact) lists bit for bit, the normal forces, the walls, one full
engine step with its id-keyed springs, and the skin-amortized cached
stepper."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from _torch_bridge import case_state, np_, rel, to_torch
from benchmarks import backend_compare as BC

from repro.apps import dem as jdem
from repro.apps import md as jmd
from repro.core import cell_list as JCL
from repro_torch.apps import dem as tdem
from repro_torch.core import cell_list as TCL
from repro_torch.kernels.cell_pair import cell_pair as TCP

TOL = 1e-4       # benchmarks/backend_compare.py::TOL, repro's jnp vs Pallas
SMALL = dict(box=(2.0, 0.6, 1.0), fill=(0.8, 0.66, 0.5))


def _tcfg(cfg, **kw):
    """The port's DEMConfig with the same physics as a repro one."""
    return tdem.DEMConfig(box=cfg.box, fill=cfg.fill, k_max=cfg.k_max,
                          cell_cap=cfg.cell_cap, device="cpu", **kw)


@functools.lru_cache(maxsize=1)
def _settled():
    """repro's settled avalanche state (20 steps from 0.3·N(0, 1)
    velocities) and the port's copy of it."""
    cfg, jps = BC.dem_settled()
    return cfg, jps, to_torch(jps)


def _verlet_case(name):
    """(repro ps, port ps, cell-list kwargs, r_verlet, k_max)."""
    if name == "dem_settled":
        cfg, jps, tps = _settled()
        return jps, tps, jdem._cl_kw(cfg), cfg.r_cut, cfg.k_full
    cfg, jps = case_state(BC.md_case)
    return jps, to_torch(jps), jmd._cl_kw(cfg), cfg.r_cut, 40


@pytest.mark.parametrize("half", [False, True])
@pytest.mark.parametrize("case", ["dem_settled", "md_lattice"])
def test_build_verlet_exact(case, half, monkeypatch):
    """build_verlet (full and half lists) equals repro's bit for bit:
    neighbour indices, counts and overflow, and a k_max too small for
    the rows reports the same overflow with the same first hits. Batches
    of 64 particles, so the batch loop runs."""
    monkeypatch.setattr(TCL, "_VERLET_BATCH", 64)
    jps, tps, kw, rv, k = _verlet_case(case)
    jcl = JCL.build_cell_list(jps, **kw)
    tcl = TCL.build_cell_list(tps, **kw)
    for k_max in (k, 2):
        jv = JCL.build_verlet(jps, jcl, rv, k_max, half=half)
        tv = TCL.build_verlet(tps, tcl, rv, k_max, half=half)
        np.testing.assert_array_equal(np_(tv.nbr), np_(jv.nbr))
        np.testing.assert_array_equal(np_(tv.n_nbr), np_(jv.n_nbr))
        assert int(tv.overflow) == int(jv.overflow)
        assert tv.nbr.dtype == torch.int32 and tv.k_max == k_max
    assert int(jv.overflow) > 0                   # k_max = 2 overflows
    assert (np_(tv.nbr) < tps.capacity).any()


def test_dem_normal_and_wall_forces_match():
    """Hertzian normal forces through the engine (plain path) to 1e-4 of
    repro's, on the settled state; the walls to 1e-6."""
    cfg, jps, tps = _settled()
    tcfg = _tcfg(cfg)
    f_j, o_j = jdem.normal_forces(jps, cfg)
    f_t, o_t = tdem.normal_forces(tps, tcfg)
    assert float(np.abs(np_(f_j)).max()) > 1.0, "no contacts to test"
    assert rel(f_t, f_j) <= TOL
    assert int(o_t) == int(o_j) == 0
    assert rel(tdem.wall_forces(tps, tcfg), jdem.wall_forces(jps, cfg)) \
        <= 1e-6
    body = tdem.dem_normal_body(tcfg)
    assert body.cuda_kind == "dem"
    assert len(body.cuda_params) == TCP.KINDS["dem"].n_params


def test_dem_step_matches():
    """One full engine step from the settled state: f, v, w and the
    springs ct_ut to 1e-4; the contact partner ids ct_id exactly."""
    cfg, jps, tps = _settled()
    j1, jf = jdem.dem_step(jps, cfg)
    t1, tf = tdem.dem_step(tps, _tcfg(cfg))
    assert int(tf.any()) == int(jf.any()) == 0
    valid = np_(j1.valid)
    assert (np_(t1.valid) == valid).all()
    for k in ("f", "v", "w", "ct_ut"):
        assert rel(np_(t1.props[k])[valid],
                   np_(j1.props[k])[valid]) <= TOL, k
    assert (np_(j1.props["ct_id"]) >= 0).any(), "no springs to carry"
    np.testing.assert_array_equal(np_(t1.props["ct_id"]),
                                  np_(j1.props["ct_id"]))
    assert rel(np_(t1.x)[valid], np_(j1.x)[valid]) <= TOL


def _moving_block(scale, seed):
    """The small avalanche block with numpy velocities scale·N(0, 1)."""
    cfg = tdem.DEMConfig(device="cpu", **SMALL)
    ps = tdem.init_block(cfg)
    rng = np.random.default_rng(seed)
    v = torch.from_numpy((scale * rng.normal(size=tuple(ps.props["v"].shape)))
                         .astype(np.float32))
    return cfg, ps.with_prop("v", torch.where(ps.valid[:, None], v,
                                              torch.zeros_like(v)))


def test_dem_cached_stepper_matches_rebuild_every_step():
    """tests/test_simulation.py's cached-stepper check in the port: the
    cached list is reused at least once (build positions stay pinned) and
    the trajectory matches the rebuild-every-step one to 1e-5."""
    cfg, ps = _moving_block(0.05, seed=2)
    ps_ref = ps
    cached = tdem.make_cached_stepper(cfg)
    cache = None
    builds = []
    for _ in range(10):
        ps_ref, flags_ref = tdem.dem_step(ps_ref, cfg)
        assert int(flags_ref.any()) == 0
        ps, flags, cache = cached(ps, cache)
        assert int(flags.any()) == 0
        builds.append(np_(cache["ct_xb"]).copy())
    reused = sum(np.array_equal(a, b) for a, b in zip(builds, builds[1:]))
    assert reused >= 1, "cache never reused"
    val = np_(ps.valid)
    assert np.array_equal(val, np_(ps_ref.valid))
    for name in ("v", "w"):
        err = np.abs(np_(ps.props[name]) - np_(ps_ref.props[name])).max()
        assert err <= 1e-5, (name, err)
    err_x = np.abs(np_(ps.x)[val] - np_(ps_ref.x)[val]).max()
    assert err_x <= 1e-5, err_x


def test_dem_cached_stepper_rebuilds_after_skin_crossing():
    """Once a grain moved more than skin/2 since the cached build, the
    next step rebuilds (ct_xb re-pins to new positions)."""
    cfg, ps = _moving_block(10.0, seed=3)
    cached = tdem.make_cached_stepper(cfg)
    ps, flags, cache = cached(ps, None)
    xb0 = np_(cache["ct_xb"]).copy()
    for _ in range(6):
        ps, flags, cache = cached(ps, cache)
    assert not np.array_equal(xb0, np_(cache["ct_xb"]))


def test_dem_init_and_run():
    """init_block equals repro's bitwise (numpy lattice, ids, springs);
    run() steps the block with zero flags and raises on a contact-slot
    overflow."""
    cfg = jdem.DEMConfig(**SMALL)
    jps = jdem.init_block(cfg)
    tps = tdem.init_block(_tcfg(cfg))
    np.testing.assert_array_equal(np_(tps.x), np_(jps.x))
    assert sorted(tps.props) == sorted(jps.props)
    for k in jps.props:
        np.testing.assert_array_equal(np_(tps.props[k]), np_(jps.props[k]),
                                      err_msg=k)
    ps = tdem.run(_tcfg(cfg), 3)
    assert bool(torch.isfinite(ps.x[ps.valid]).all())
    with pytest.raises(RuntimeError, match="overflow"):
        tdem.run(_tcfg(dataclasses.replace(cfg, k_max=1)), 1)
