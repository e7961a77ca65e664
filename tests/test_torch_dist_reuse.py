"""The reuse cadence and dynamic load balancing on the port's 1-D slab mesh
(``make_sim_step(mesh, reuse=...)``, ``reuse_state(mesh)``,
``make_rebalance``, ``sph.run_distributed``, ``vortex.run_distributed``'s
control plane): on 4 gloo ranks against repro on 4 forced host devices and
against the port's every-step slab step and serial paths, and the control
loops at world 1 in this process.

Tolerances, as tests/distributed/test_dist_reuse.py and
test_dist_sph_dlb.py hold repro: reuse against every step by id 1e-5 (MD,
SPH, the MD reuse step against repro's), 1e-4 for DEM's springs against
every step and for the DLB driver against the serial steps; the
rebalance's bounds and map() slots exactly; the probe's contact counts
exactly.

The module's fixture starts its 4 ranks once (tests/_torch_dist.py's
``reuse_dlb`` body) beside one repro subprocess."""
import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _reuse_probe as RP
import _torch_dist as TD
from _torch_bridge import ProbeCfg, np_, probe_physics, to_torch
from benchmarks.xla_env import ensure_forced_host_devices
from repro.core import simulation as JSIM
from repro_torch import convert
from repro_torch.apps import dem, md, sph, vortex as V
from repro_torch.core import runtime as RT
from repro_torch.core import simulation as SIM

WORLD = 4
TOL = 1e-5          # reuse vs every step, port vs repro (MD, SPH)
TOL_DEM = 1e-4      # DEM reuse (carried springs) vs every step
TOL_DLB = 1e-4      # the DLB driver vs the serial steps


def _cat(got, prefix):
    """The ranks' blocks of one particle state, in rank order."""
    return {k[len(prefix):]: np.concatenate([g[k] for g in got])
            for k in got[0] if k.startswith(prefix) and got[0][k].ndim}


def _by_id(d, key="x"):
    """Values of the valid rows, ordered by id."""
    val = d["valid"]
    order = np.argsort(d["p_id"][val])
    return (d["x"] if key == "x" else d[f"p_{key}"])[val][order]


def _serial_by_id(ps, key="x"):
    val = np_(ps.valid)
    order = np.argsort(np_(ps.props["id"])[val])
    return np_(ps.x if key == "x" else ps.props[key])[val][order]


def _save_scattered(path, ps, bounds, cap_per_dev=None):
    x, valid, props = convert.particles_to_numpy(ps)
    X, Vd, PR = convert.scatter_to_slabs(x, valid, props, bounds, WORLD,
                                         cap_per_dev=cap_per_dev)
    np.savez(path, x=X, valid=Vd, bounds=bounds,
             **{f"p_{k}": v for k, v in PR.items()})


def _dlb_input(path):
    """240 particles, 70% of them clustered in x < 0.3, on uniform slabs:
    rank 0 starts with most of them."""
    rng = np.random.default_rng(11)
    n = 240
    x = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    k = int(0.7 * n)
    x[:k, 0] = rng.uniform(0, 0.3, k).astype(np.float32)
    ps = SIM.with_ids(convert.particles_from_numpy(
        x, np.ones(n, bool),
        {"v": rng.normal(size=(n, 3)).astype(np.float32)}, device="cpu"))
    bounds = np.linspace(0, 1, WORLD + 1).astype(np.float32)
    _save_scattered(path, ps, bounds, cap_per_dev=200)
    return np.histogram(x[:, 0], bounds)[0]


def _md_start():
    """md_reuse_config's lattice with numpy velocities 0.3·N(0, 1) and ids
    (the serial slot is the id)."""
    cfg = TD.md_reuse_config(md)
    ps = md.init_particles(cfg, capacity=cfg.n_particles)
    rng = np.random.default_rng(4)
    v = (0.3 * rng.standard_normal((cfg.n_particles, 3))).astype(np.float32)
    return cfg, SIM.with_ids(ps.with_prop("v", torch.from_numpy(
        v - v.mean(0))))


def _dem_start():
    """The avalanche of dem_reuse_config settled 20 serial steps from
    numpy velocities 0.3·N(0, 1), as dist_common.dem_settled_start."""
    cfg = TD.dem_reuse_config(dem)
    ps = dem.init_block(cfg)
    rng = np.random.default_rng(1)
    v = (0.3 * rng.standard_normal(tuple(ps.props["v"].shape))).astype(
        np.float32)
    ps = ps.with_prop("v", torch.where(ps.valid[:, None],
                                       torch.from_numpy(v), 0.0))
    for _ in range(20):
        ps, flags = dem.dem_step(ps, cfg)
        assert int(flags.any()) == 0
    return cfg, SIM.with_ids(ps)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_reuse")
    dlb_in, md_in = tmp / "dlb_in.npz", tmp / "md_in.npz"
    probe_in, dem_in = tmp / "probe_in.npz", tmp / "dem_in.npz"
    start_counts = _dlb_input(dlb_in)
    _, ps = _md_start()
    _save_scattered(md_in, ps, np.linspace(0, 1, WORLD + 1).astype(
        np.float32), cap_per_dev=96)
    probe = {"skin": np.float32(RP.SKIN)}
    for scenario in ("boundary", "fast"):
        x, valid, props = convert.particles_to_numpy(
            to_torch(RP.make_ps(scenario)))
        probe.update({f"{scenario}_x": x, f"{scenario}_valid": valid,
                      f"{scenario}_u": props["u"],
                      f"{scenario}_nc": props["nc"]})
    np.savez(probe_in, **probe)
    dcfg, dps = _dem_start()
    _save_scattered(dem_in, dps, np.linspace(0, dcfg.box[0], WORLD + 1)
                    .astype(np.float32))
    ref = tmp / "repro.npz"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    # one XLA thread: the child shares the CPU with the 4 ranks
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_cpu_multi_thread_eigen=false").strip()
    ensure_forced_host_devices(env)
    env["PYTHONPATH"] = str(TD.ROOT / "src")
    child = subprocess.Popen(
        [sys.executable, TD.__file__, "--repro-reuse", str(dlb_in),
         str(md_in), str(ref)], env=env, cwd=TD.ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        got = TD.run_ranks("reuse_dlb", WORLD, tmp, timeout=150,
                           dlb_in=str(dlb_in), md_in=str(md_in),
                           probe_in=str(probe_in), dem_in=str(dem_in))
        log, _ = child.communicate(timeout=240)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    assert child.returncode == 0, log[-4000:]
    want = dict(np.load(ref), rb_start_counts=start_counts)
    return got, want


# --------------------------------------------------------------------------
# make_rebalance
# --------------------------------------------------------------------------

def test_rebalance_matches_repro_on_four_devices(runs):
    """make_rebalance from a skewed start (rank 0 holds 168 of 240): the
    new bounds equal repro's bit for bit on every rank and move the
    particles off the fullest slab within the min-width projection, and
    map() under them leaves the same particles in the same slots as
    repro's; overflow equal."""
    got, want = runs
    for g in got:
        assert np.array_equal(g["rb_bounds"], want["rb_bounds"]), (
            g["rb_bounds"], want["rb_bounds"])
        assert int(g["rb_ovf"]) == int(want["rb_ovf"]) == 0
    # the balanced bounds floored at r_cut·1.001 (MD's r_cut 0.18)
    b = want["rb_bounds"]
    assert np.diff(b).min() >= 0.18 * 1.0009, b
    assert not np.allclose(b, np.linspace(0, 1, WORLD + 1))
    cat = _cat(got, "rb_")
    for k in ("x", "valid", "p_v", "p_id"):
        assert np.array_equal(cat[k], want[f"rb_{k}"]), k
    counts = cat["valid"].reshape(WORLD, -1).sum(1)
    start = want["rb_start_counts"]
    assert counts.sum() == start.sum() == 240
    # the fullest slab sheds particles (the floor keeps the cluster's
    # slabs from splitting it evenly)
    assert counts.max() < start.max(), (start, counts)


def test_rebalance_at_world_one_keeps_everything():
    """At world 1 the balanced bounds are the box [lo, hi] and map()
    moves nothing: the particles stay slot for slot."""
    mesh = RT.make_mesh((1,), (TD.AXIS,), device_type="cpu")
    cfg, ps = _md_start()
    st = SIM.distribute(ps, md.physics, cfg, mesh, cap_per_dev=300)
    st2, ovf = SIM.make_rebalance(md.physics, cfg, mesh)(st)
    assert torch.equal(st2.bounds, torch.tensor([0.0, 1.0]))
    assert int(ovf) == 0
    assert torch.equal(st2.ps.x, st.ps.x)
    assert torch.equal(st2.ps.valid, st.ps.valid)
    for k in st.ps.props:
        assert torch.equal(st2.ps.props[k], st.ps.props[k]), k


# --------------------------------------------------------------------------
# The reuse slab step against every step and against repro
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(TD.MD_REUSE_CASES))
def test_md_reuse_matches_every_step_and_repro(runs, name):
    """12 reuse="skin" MD steps on 4 ranks against the port's every-step
    slab step by id within 1e-5, zero flags, the cold step full and some
    update step: at skin 0.06 with overlap on (the split-phase update
    steps) and off, and at the default skin (two ghost hops, blocking);
    the overlap case also within 1e-5 of repro's reuse step on 4 devices,
    with the same stale sequence."""
    got, want = runs
    assert all(int(g["md_full_worst"]) == 0 == int(g[f"md_{name}_worst"])
               for g in got)
    stale = got[0][f"md_{name}_stale"]
    assert all(np.array_equal(g[f"md_{name}_stale"], stale) for g in got)
    assert stale[0] == 1 and 0 in stale
    mine = _by_id(_cat(got, f"md_{name}_"))
    every = _by_id(_cat(got, "md_full_"))
    assert mine.shape == (216, 3)
    assert np.abs(mine - every).max() <= TOL, np.abs(mine - every).max()
    if name == "ov1":
        assert np.array_equal(stale, want["md_stale"])
        val = want["md_valid"]
        theirs = want["md_x"][val][np.argsort(want["md_id"][val])]
        assert np.abs(mine - theirs).max() <= TOL


def test_sph_reuse_matches_every_step(runs):
    """8 reuse="skin" SPH steps (the dam break) against the every-step
    slab step by id: x within 1e-5, some update step, zero flags."""
    got, _ = runs
    assert all(int(g["sph_full_worst"]) == 0 == int(g["sph_reuse_worst"])
               for g in got)
    assert 0 in got[0]["sph_reuse_stale"]
    a = _by_id(_cat(got, "sph_reuse_"))
    b = _by_id(_cat(got, "sph_full_"))
    assert np.abs(a - b).max() <= TOL, np.abs(a - b).max()


def _serial_probe(S, physics, cfg, ps, scenario, n, reuse):
    step = S.make_sim_step(physics, cfg, reuse=reuse, skin=RP.SKIN)
    rs = S.reuse_state(S.serial_state(ps, physics, cfg), physics, cfg,
                       skin=RP.SKIN)
    stales, nc = [], []
    for _ in range(n):
        rs, flags, _ = step(rs, {})
        stales.append(int(flags.stale))
        nc.append(float(np_(rs.inner.ps.props["nc"])[0]))
    return stales, nc


def _dist_probe(got, name):
    """(stale, nc of probe ids 0 and 1 per step) of a 4-rank probe run."""
    nc = np.concatenate([g[f"probe_{name}_nc"] for g in got], 1)
    ids = np.concatenate([g[f"probe_{name}_id"] for g in got], 1)
    assert all(int(g[f"probe_{name}_worst"]) == 0 for g in got)
    pair = []
    for row_nc, row_id in zip(nc, ids):
        a = row_nc[row_id == 0]
        b = row_nc[row_id == 1]
        assert a.shape == b.shape == (1,) and a[0] == b[0]
        pair.append(float(a[0]))
    return list(got[0][f"probe_{name}_stale"]), pair


def test_probe_boundary_cadence_on_four_ranks(runs):
    """The exact skin/2 probe with the pair straddling a slab face: the
    4-rank cadence equals the serial port's and repro's serial cadence,
    [1, 0, 0, 0, 0, 1]; the contact at step 4 is served from the cached
    ghost layer; nc exact."""
    got, _ = runs
    scenario, n, reuse = TD.PROBE_RUNS["boundary"]
    stales, nc = _dist_probe(got, "boundary")
    t = _serial_probe(SIM, probe_physics, ProbeCfg(),
                      to_torch(RP.make_ps(scenario)), scenario, n, reuse)
    j = _serial_probe(JSIM, RP.physics, RP.ProbeCfg(), RP.make_ps(scenario),
                      scenario, n, reuse)
    assert stales == t[0] == j[0] == RP.boundary_cadence(n) \
        == [1, 0, 0, 0, 0, 1]
    want = [RP.true_nc(scenario, k) for k in range(1, n + 1)]
    assert nc == t[1] == j[1] == want
    assert want[3] == 1.0 and stales[3] == 0


def test_probe_fast_pair_on_four_ranks(runs):
    """reuse="skin" serves every contact step of the fast pair across the
    slab face; the negative control reuse="update" misses every one."""
    got, _ = runs
    n = TD.PROBE_RUNS["fast_skin"][1]
    want = [RP.true_nc("fast", k) for k in range(1, n + 1)]
    stales, nc = _dist_probe(got, "fast_skin")
    assert nc == want and sum(stales) > 1
    _, nc_u = _dist_probe(got, "fast_update")
    contact = [k for k in range(n) if want[k] == 1.0]
    assert contact and all(nc_u[k] == 0.0 for k in contact)


def test_dem_contact_cache_carried_and_repinned(runs):
    """20 reuse steps of the avalanche (skin = cfg.skin): within 1e-4 of
    the every-step slab step by id; the contact cache stays warm, is
    carried through update steps (its build positions unchanged or moved
    less than the skin) and re-pinned at a rebuild."""
    got, _ = runs
    assert all(int(g["dem_full_worst"]) == 0 == int(g["dem_reuse_worst"])
               for g in got)
    a, b = _cat(got, "dem_reuse_"), _cat(got, "dem_full_")
    for key in ("x", "v", "w"):
        err = np.abs(_by_id(a, key) - _by_id(b, key)).max()
        assert err <= TOL_DEM, (key, err)
    assert (a["p_ct_id"][a["valid"]] >= 0).any()     # springs in play
    stales = got[0]["dem_reuse_stale"]
    assert 0 in stales
    dcfg = TD.dem_reuse_config(dem)
    for g in got:
        assert np.array_equal(g["dem_reuse_stale"], stales)
        assert g["dem_reuse_ok"].all(), "contact cache went cold mid-run"
        xb = g["dem_reuse_xb"]
        upd = list(stales).index(0)
        rebuilds = [k for k in range(upd + 1, len(stales)) if stales[k]]
        if rebuilds and g["dem_reuse_valid"].any():
            k = rebuilds[0]
            assert not np.array_equal(xb[k], xb[k - 1]), "not re-pinned"
        for k in range(1, len(stales)):
            if stales[k] == 0 and stales[k - 1] == 0:
                moved = np.abs(xb[k] - xb[k - 1]).max()
                assert moved == 0.0 or moved < dcfg.skin


# --------------------------------------------------------------------------
# sph.run_distributed
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sph_serial():
    cfg = TD.sph_reuse_config(sph)
    ps = SIM.with_ids(sph.init_dam_break(cfg, capacity_factor=1.05))
    st = SIM.serial_state(ps, sph.physics, cfg)
    step = SIM.make_sim_step(sph.physics, cfg)
    t = 0.0
    for i in range(TD.DLB_STEPS):
        st, flags, scal = step(st, {"euler": i % cfg.verlet_reset == 0})
        assert int(flags.any()) == 0
        t += float(scal["dt"])
    return st.ps, t


@pytest.mark.parametrize("reuse", ["none", "skin"])
def test_sph_run_distributed_rebalances(runs, sph_serial, reuse):
    """The DLB driver on 4 ranks with the threshold trigger (imbalance
    0.3, gap 4), reuse off and on: it rebalances, the imbalance falls,
    every rank returns the same trace, and the final positions by id are
    within 1e-4 of the serial steps (DLB moves the decomposition, not the
    physics); the simulated time within 1e-4 relative."""
    got, _ = runs
    key = f"dlb_{reuse}_"
    n_reb = int(got[0][key + "n_reb"])
    imb = got[0][key + "imb"]
    assert n_reb >= 1 and imb[-1] < imb[0], (n_reb, imb)
    for g in got:
        assert int(g[key + "n_reb"]) == n_reb
        assert np.array_equal(g[key + "imb"], imb)
    ps, t = sph_serial
    d = _cat(got, key)
    assert int(d["valid"].sum()) == int(ps.valid.sum())
    err = np.abs(_by_id(d) - _serial_by_id(ps)).max()
    assert err <= TOL_DLB, err
    assert abs(float(got[0][key + "t"]) - t) <= TOL_DLB * t


def test_sph_run_distributed_sar_is_the_same_on_every_rank(runs):
    """SAR on, each rank's scripted clock advancing its own time a step
    (so the ranks' own wall times differ, and SAR's inputs are the same
    on every run): the pmax'd wall time makes every rank take the same
    rebalance decisions, and the run ends (a rank-local decision would
    pair a rank's rebalance collectives with another's step)."""
    got, _ = runs
    n = {int(g["sar_n_reb"]) for g in got}
    assert len(n) == 1 and n.pop() >= 1
    assert all(np.array_equal(g["sar_imb"], got[0]["sar_imb"]) for g in got)


def _window_factory(need, calls):
    """A step factory whose step flags window excess until interior_rows
    reaches ``need``; it returns the state unchanged."""
    def make_step(w):
        calls.append(w)

        def step(state, extras):
            ps = state.ps
            z = torch.zeros((), dtype=torch.int32)
            flags = SIM.StepFlags(
                cell=z, neighbor=z, bucket=z, ghost=z, ghost_contract=z,
                window=torch.tensor(max(need - w, 0), dtype=torch.int32),
                stale=z)
            scal = {"dt": torch.tensor(1e-4),
                    "load": ps.valid.sum().reshape(1)}
            return state, flags, scal

        return step

    return make_step


def test_sph_window_loop_grows_and_raises_at_the_ceiling():
    """The window control loop at world 1 with an injected step factory
    (``ndev`` 4 sets the default window): the window grows by the
    reported excess and the step is redone from the pre-step state, once;
    a need beyond the grid's rows raises RuntimeError at the geometric
    ceiling."""
    mesh = RT.make_mesh((1,), (TD.AXIS,), device_type="cpu")
    cfg = TD.sph_reuse_config(sph)
    n_rows = int(SIM._grid_kw(sph.physics(cfg), (0,))["grid_shape"][0])
    w0 = -(-n_rows // 4) + 4
    assert w0 + 2 < n_rows
    calls = []
    _, t, n_reb, _ = sph.run_distributed(
        cfg, 2, mesh, 4, use_sar=False, imb_threshold=10.0,
        _make_step=_window_factory(w0 + 2, calls))
    assert calls == [w0, w0 + 2] and n_reb == 0
    assert t == pytest.approx(2e-4)
    calls = []
    with pytest.raises(RuntimeError, match="geometric ceiling"):
        sph.run_distributed(cfg, 1, mesh, 4, use_sar=False,
                            _make_step=_window_factory(10 ** 6, calls))
    assert calls == [w0, n_rows], calls


def _vic_factory(need_halo, calls):
    def factory(mesh, cfg, axis_name):
        calls.append(cfg.mesh_halo)

        def step(f):
            ovf = 0 if cfg.mesh_halo >= need_halo else 1
            return f, torch.tensor(ovf, dtype=torch.int32)

        return step

    return factory


def test_vortex_auto_reprovision_grows_halo_and_raises():
    """vortex.run_distributed(auto_reprovision=True) at world 1 with an
    injected step factory (tests/test_fleet.py's): the halo doubles 2 → 4
    → 8, the grown cfg comes back; a need beyond the slab height raises at
    the geometric ceiling."""
    mesh = RT.make_mesh((1,), (TD.AXIS,), device_type="cpu")
    cfg = V.VortexConfig(shape=(16, 8, 8), lengths=(4.0, 2.0, 2.0),
                         mesh_halo=2, device="cpu")
    calls = []
    w, z0, z1, cfg_out = V.run_distributed(
        cfg, 2, mesh, TD.AXIS, auto_reprovision=True,
        _make_step=_vic_factory(8, calls))
    assert calls == [2, 4, 8] and cfg_out.mesh_halo == 8
    assert tuple(w.shape) == (16, 8, 8, 3) and z0 == z1
    with pytest.raises(RuntimeError, match="geometric ceiling"):
        V.run_distributed(cfg, 1, mesh, TD.AXIS, auto_reprovision=True,
                          _make_step=_vic_factory(10 ** 9, []))
