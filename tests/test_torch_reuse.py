"""repro_torch's serial reuse engine (the skin-amortized cadence,
DESIGN.md §14) against repro's, on the CPU: the exact skin/2 oracle of
tests/_reuse_probe.py (the boundary cadence and the fast pair, with
reuse="update" as the negative control), MD and DEM reuse steps against
repro's and against the port's every-step paths, skin validation, and
md.run(reuse=...)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _reuse_probe as RP
from _torch_bridge import ProbeCfg, np_, probe_physics, to_torch

from repro.apps import dem as jdem
from repro.apps import md as jmd
from repro.core import cell_list as JCL
from repro.core import simulation as JSIM
from repro_torch.apps import dem as tdem
from repro_torch.apps import md as tmd
from repro_torch.core import cell_list as TCL
from repro_torch.core import simulation as TSIM

TOL = 1e-5       # reuse vs every-step and port vs repro, after 10 steps


def test_probe_geometry_is_the_oracle_s():
    cfg = ProbeCfg()
    assert (cfg.rc, cfg.box, cfg.cell_cap) == (RP.RC, RP.BOX,
                                               RP.ProbeCfg().cell_cap)


def _run_probe(scenario, n_steps, reuse):
    """(stale flags, nc of the probe pair) per step, in the port and in
    repro, from the same probe particles."""
    out = []
    jps = RP.make_ps(scenario)
    for S, physics, cfg, ps in (
            (TSIM, probe_physics, ProbeCfg(), to_torch(jps)),
            (JSIM, RP.physics, RP.ProbeCfg(), jps)):
        step = S.make_sim_step(physics, cfg, reuse=reuse, skin=RP.SKIN)
        rs = S.reuse_state(S.serial_state(ps, physics, cfg), physics, cfg,
                           skin=RP.SKIN)
        stales, nc = [], []
        for _ in range(n_steps):
            rs, flags, _ = step(rs, {})
            assert int(flags.any()) == 0
            stales.append(int(flags.stale))
            pair = np_(rs.inner.ps.props["nc"])[:2]
            assert pair[0] == pair[1]
            nc.append(float(pair[0]))
        out.append((stales, nc))
    return out


def test_reuse_probe_boundary_cadence():
    """Displacement driven to exactly skin/2: the strict tripwire must not
    fire there, the pair entering r_cut at step 4 is served from the
    cached binning, and the rebuild fires at step 6 — nc exact."""
    n = 6
    (stales, nc), (j_stales, j_nc) = _run_probe("boundary", n, "skin")
    assert stales == j_stales == RP.boundary_cadence(n) == [1, 0, 0, 0, 0, 1]
    want = [RP.true_nc("boundary", k) for k in range(1, n + 1)]
    assert nc == j_nc == want
    assert want[3] == 1.0 and stales[3] == 0   # contact before the re-trip


def test_reuse_probe_fast_pair():
    """reuse="skin" never misses the fast pair's contacts; the negative
    control reuse="update" (no tripwire) misses every contact step, as
    repro's does."""
    n = 10
    want = [RP.true_nc("fast", k) for k in range(1, n + 1)]
    (stales, nc), (j_stales, j_nc) = _run_probe("fast", n, "skin")
    assert nc == j_nc == want and stales == j_stales
    assert sum(stales) > 1
    (_, nc_u), (_, j_nc_u) = _run_probe("fast", n, "update")
    contact = [k for k in range(n) if want[k] == 1.0]
    assert contact and all(nc_u[k] == 0.0 for k in contact)
    assert nc_u == j_nc_u


def _md_hot_state():
    """tests/test_simulation.py's hot MD reuse case with numpy velocities
    (1.5·N(0, 1), so the tripwire fires again mid-run):
    (repro cfg, port cfg, repro ps, port ps) after the initial forces."""
    cfg = jmd.MDConfig(n_per_side=5, sigma=0.1, dt=0.002, cell_cap=64)
    jps = jmd.init_particles(cfg)
    rng = np.random.default_rng(2)
    v = 1.5 * rng.normal(size=tuple(jps.x.shape)).astype(np.float32)
    v = v - v[np.asarray(jps.valid)].mean(0, keepdims=True)
    jps = jps.with_prop("v", jnp.where(jps.valid[:, None], jnp.asarray(v),
                                       0.0))
    jps, _ = jmd.compute_forces(jps, cfg)
    tcfg = tmd.MDConfig(n_per_side=5, sigma=0.1, dt=0.002, cell_cap=64,
                        device="cpu")
    return cfg, tcfg, jps, to_torch(jps)


def test_md_reuse_matches_repro_and_every_step():
    """10 reuse="skin" steps through a mixed rebuild/update cadence: the
    same stale sequence as repro's, positions within TOL of repro's reuse
    step and of the port's every-step path."""
    cfg, tcfg, jps, tps = _md_hot_state()
    t_step = TSIM.make_sim_step(tmd.physics, tcfg, reuse="skin")
    j_step = JSIM.make_sim_step(jmd.physics, cfg, reuse="skin")
    trs = TSIM.reuse_state(TSIM.serial_state(tps, tmd.physics, tcfg),
                           tmd.physics, tcfg)
    jrs = JSIM.reuse_state(JSIM.serial_state(jps, jmd.physics, cfg),
                           jmd.physics, cfg)
    every = TSIM.make_sim_step(tmd.physics, tcfg)
    st = TSIM.serial_state(tps, tmd.physics, tcfg)
    t_st, j_st = [], []
    for _ in range(10):
        trs, tf, _ = t_step(trs, {})
        jrs, jf, _ = j_step(jrs, {})
        st, ef, _ = every(st, {})
        assert int(tf.any()) == int(jf.any()) == int(ef.any()) == 0
        t_st.append(int(tf.stale))
        j_st.append(int(jf.stale))
    assert t_st == j_st and t_st[0] == 1 and 0 in t_st and sum(t_st) > 1
    valid = np_(jps.valid)
    x = np_(trs.inner.ps.x)[valid]
    assert np.abs(x - np_(jrs.inner.ps.x)[valid]).max() <= TOL
    assert np.abs(x - np_(st.ps.x)[valid]).max() <= TOL


def test_md_run_reuse_matches_every_step():
    """md.run(reuse="skin") against md.run on the every-step path (the same
    seeded velocities): positions within TOL after 10 steps, both
    conserving energy; reuse="update" runs too."""
    tcfg = tmd.MDConfig(n_per_side=5, sigma=0.1, dt=0.002, cell_cap=64,
                        device="cpu")
    ps_r, log_r = tmd.run(tcfg, 10, thermal_v=0.5, seed=3, log_every=9,
                          reuse="skin")
    ps_e, log_e = tmd.run(tcfg, 10, thermal_v=0.5, seed=3, log_every=9)
    valid = np_(ps_e.valid)
    assert np.abs(np_(ps_r.x)[valid] - np_(ps_e.x)[valid]).max() <= TOL
    for log in (log_r, log_e):
        e = [k + p for _, k, p in log]
        assert abs(e[-1] - e[0]) / abs(e[0]) < 0.05
    ps_u, _ = tmd.run(tcfg, 2, thermal_v=0.5, seed=3, reuse="update",
                      skin=0.5 * tcfg.r_cut)
    assert bool(torch.isfinite(ps_u.x[ps_u.valid]).all())


# the small avalanche 1.5x wider in y: the reuse grid (cells >= r_cut +
# skin = 0.21) then has 4 cells along the periodic y axis. build_verlet
# resolves periodic images by minimum image, which needs >= 3 cells on a
# periodic axis; at y = 0.6 the reuse grid has 2 and lists pairs twice,
# in repro as in the port.
DEM_REUSE = dict(box=(2.0, 0.9, 1.0), fill=(0.8, 0.96, 0.5))


def _dem_settled_wide():
    """repro's avalanche on the DEM_REUSE box settled for 12 every-step
    engine steps from numpy velocities 0.3·N(0, 1), as
    benchmarks/backend_compare.py's dem_settled does (20 steps) on the
    smaller box."""
    cfg = jdem.DEMConfig(**DEM_REUSE)
    jps = jdem.init_block(cfg)
    rng = np.random.default_rng(1)
    v = 0.3 * rng.normal(size=tuple(jps.props["v"].shape))
    jps = jps.with_prop("v", jnp.where(jps.valid[:, None],
                                       jnp.asarray(v, jnp.float32), 0.0))
    for _ in range(12):
        jps, flags = jdem.dem_step(jps, cfg)
        assert int(flags.any()) == 0
    return cfg, jps


def test_dem_reuse_matches_repro():
    """10 reuse="skin" DEM steps from a settled avalanche: the same stale
    sequence as repro's, the contact cache (lists, counts, build
    positions) and the springs' partner ids equal, positions and
    velocities within TOL of repro's, and within TOL of the port's cached
    stepper (the same contact-list rebuild steps)."""
    cfg, jps = _dem_settled_wide()
    tcfg = tdem.DEMConfig(box=cfg.box, fill=cfg.fill, k_max=cfg.k_max,
                          cell_cap=cfg.cell_cap, device="cpu")
    tps = to_torch(jps)
    t_step = TSIM.make_sim_step(tdem.physics, tcfg, reuse="skin")
    j_step = JSIM.make_sim_step(jdem.physics, cfg, reuse="skin")
    trs = TSIM.reuse_state(TSIM.serial_state(tps, tdem.physics, tcfg),
                           tdem.physics, tcfg)
    jrs = JSIM.reuse_state(JSIM.serial_state(jps, jdem.physics, cfg),
                           jdem.physics, cfg)
    stepper = tdem.make_cached_stepper(tcfg)
    ps_c, cache = tps, None
    t_st, j_st = [], []
    for _ in range(10):
        trs, tf, ts = t_step(trs, {})
        jrs, jf, js = j_step(jrs, {})
        ps_c, cf, cache = stepper(ps_c, cache)
        assert int(tf.any()) == int(jf.any()) == int(cf.any()) == 0
        assert set(ts) == set(js) == set()    # the cache keys were lifted
        t_st.append(int(tf.stale))
        j_st.append(int(jf.stale))
        for k in tdem.CACHE_KEYS:
            np.testing.assert_array_equal(np_(trs.cache.phys[k]),
                                          np_(jrs.cache.phys[k]), err_msg=k)
        # the contact list rebuilds on the cached stepper's steps
        np.testing.assert_array_equal(np_(trs.cache.phys["ct_xb"]),
                                      np_(cache["ct_xb"]))
    assert t_st == j_st and t_st[0] == 1
    t1, j1 = trs.inner.ps, jrs.inner.ps
    valid = np_(j1.valid)
    assert (np_(j1.props["ct_id"]) >= 0).any(), "no springs to carry"
    np.testing.assert_array_equal(np_(t1.props["ct_id"]),
                                  np_(j1.props["ct_id"]))
    for got, ref in ((t1, j1), (t1, ps_c)):
        assert np.abs(np_(got.x)[valid] - np_(ref.x)[valid]).max() <= TOL
        for k in ("v", "w"):
            assert np.abs(np_(got.props[k])[valid]
                          - np_(ref.props[k])[valid]).max() <= TOL, k


def test_reuse_skin_validation_matches_repro():
    """An out-of-range skin and an unknown reuse mode raise ValueError
    with repro's messages; a skin without reuse is ignored, as there."""
    cfg = jmd.MDConfig(n_per_side=3)
    tcfg = tmd.MDConfig(n_per_side=3, device="cpu")
    for kw in (dict(reuse="skin", skin=2.0 * cfg.r_cut),
               dict(reuse="update", skin=0.0), dict(reuse="verlet")):
        with pytest.raises(ValueError) as j_err:
            JSIM.make_sim_step(jmd.physics, cfg, **kw)
        with pytest.raises(ValueError) as t_err:
            TSIM.make_sim_step(tmd.physics, tcfg, **kw)
        assert str(t_err.value) == str(j_err.value)
    with pytest.raises(ValueError, match="skin"):
        TSIM.reuse_state(TSIM.serial_state(tmd.init_particles(tcfg),
                                           tmd.physics, tcfg),
                         tmd.physics, tcfg, skin=-1.0)
    assert TSIM.make_sim_step(tmd.physics, tcfg, skin=0.1) \
        is TSIM.make_sim_step(tmd.physics, tcfg)


@pytest.mark.parametrize("shift", [0.0, 0.0124, 0.0126])
def test_needs_rebuild_matches_repro(shift):
    """The Verlet skin criterion (skin 0.05: a move past 0.025 rebuilds)
    on the MD lattice with one particle moved by 2·shift."""
    cfg = jmd.MDConfig(n_per_side=5, sigma=0.1)
    jps = jmd.init_particles(cfg)
    kw = jmd._cl_kw(cfg)
    jvl = JCL.build_verlet(jps, JCL.build_cell_list(jps, **kw), cfg.r_cut,
                           40)
    tps = to_torch(jps)
    tvl = TCL.build_verlet(tps, TCL.build_cell_list(tps, **kw), cfg.r_cut,
                           40)
    jmoved = jps.replace(x=jps.x.at[3, 0].add(2.0 * shift))
    got = bool(TCL.needs_rebuild(to_torch(jmoved), tvl, 0.05))
    assert got == bool(JCL.needs_rebuild(jmoved, jvl, 0.05))
    assert got == (2.0 * shift > 0.025)
