"""The pencil forms of the port's multi-device layer on 2-D ("rows",
"cols") meshes (DESIGN.md §13): the MD pencil step (two-stage map, the
column ghost exchange relaying the corners, one pair pass), its reuse
fallback, the 2-D ``make_rebalance``, the pencil FFT Poisson solve and
the pencil VIC step, on 4 gloo ranks against the port's serial paths and
repro on 4 forced host devices; and every (ndev, 1) form against its slab
form; the pencil grid layer (distribute_field2, halo_pad2, halo_reduce2,
apply_stencil_local2), the pencil Poisson solve on every mesh shape and
the pencil VIC step against repro's too. The sizes are
tests/distributed/test_dist_pencil.py's on a 2×2 mesh where repro used
2×4.

Tolerances, as repro's suite: the MD pencil step within 1e-4 of serial
by id, within 1e-5 of repro's pencil step; the Poisson solves within
2e-5 of the serial solve and of repro's relative to the max; the VIC
step within 1e-4 relative of serial and of repro's; the rebalance's
bounds and slots, the grid layer and every (ndev, 1) form bit for
bit.

The module's fixture starts its 4 ranks once (tests/_torch_dist.py's
``pencil`` body) beside one repro subprocess."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_dist as TD
from _torch_bridge import np_
from benchmarks.xla_env import ensure_forced_host_devices
from repro_torch import convert
from repro_torch.apps import md, vortex as V
from repro_torch.core import simulation as SIM
from repro_torch.numerics import poisson as PS

WORLD = 4
TOL = 1e-4          # the pencil vs serial (MD by id, VIC relative)
TOL_REPRO = 1e-5    # the MD pencil step vs repro's, by id
TOL_POISSON = 2e-5  # tests/distributed/test_dist_pencil.py
TOL_STENCIL = 1e-6  # the grid layer's stencil vs repro's, relative


def _cat(got, prefix):
    """The ranks' blocks of one particle state, in rank order."""
    return {k[len(prefix):]: np.concatenate([g[k] for g in got])
            for k in got[0] if k.startswith(prefix) and got[0][k].ndim}


def _by_id(x, valid, ids):
    """(sorted ids, x of the valid rows in id order)."""
    order = np.argsort(ids[valid])
    return ids[valid][order], x[valid][order]


def _save(path, ps):
    x, valid, props = convert.particles_to_numpy(ps)
    np.savez(path, x=x, valid=valid, **{f"p_{k}": v for k, v in props.items()})


def _md_start():
    """md_pencil_config's lattice with numpy velocities 0.3·N(0, 1) and
    ids (the serial slot is the id)."""
    cfg = TD.md_pencil_config(md)
    ps = md.init_particles(cfg, capacity=cfg.n_particles)
    v = np.random.default_rng(2).standard_normal((cfg.n_particles, 3))
    v = (0.3 * (v - v.mean(0))).astype(np.float32)
    return cfg, SIM.with_ids(ps.with_prop("v", torch.from_numpy(v)))


def _rb_start():
    """240 particles, 70% in x < 0.3 and 60% in y < 0.4: uniform pencils
    start far from balanced on both axes."""
    rng = np.random.default_rng(13)
    n = 240
    x = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    x[:int(0.7 * n), 0] = rng.uniform(0, 0.3, int(0.7 * n))
    x[n - int(0.6 * n):, 1] = rng.uniform(0, 0.4, int(0.6 * n))
    return SIM.with_ids(convert.particles_from_numpy(
        x, np.ones(n, bool), {"v": rng.normal(size=(n, 3)).astype(
            np.float32), "f": np.zeros((n, 3), np.float32)}, device="cpu"))


def _serial(cfg, ps, n):
    step = SIM.make_sim_step(md.physics, cfg)
    st = SIM.serial_state(ps, md.physics, cfg)
    for _ in range(n):
        st, flags, _ = step(st, {})
        assert int(flags.any()) == 0
    return st.ps


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_pencil")
    md_in, rb_in = tmp / "md_in.npz", tmp / "rb_in.npz"
    rhs_in, ref = tmp / "rhs.npz", tmp / "repro.npz"
    cfg, ps = _md_start()
    _save(md_in, ps)
    _save(rb_in, _rb_start())
    rhs = np.random.default_rng(0).standard_normal(
        (32, 16, 16)).astype(np.float32)
    rhs -= rhs.mean()
    np.save(rhs_in, rhs)
    rhs_in = str(rhs_in) + ".npy"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    # one XLA thread: the child shares the CPU with the 4 ranks
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_cpu_multi_thread_eigen=false").strip()
    ensure_forced_host_devices(env)
    env["PYTHONPATH"] = str(TD.ROOT / "src")
    child = subprocess.Popen(
        [sys.executable, TD.__file__, "--repro-pencil", str(md_in),
         str(rb_in), rhs_in, str(ref)], env=env, cwd=TD.ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        got = TD.run_ranks("pencil", WORLD, tmp, timeout=150,
                           md_in=str(md_in), rb_in=str(rb_in),
                           rhs_in=rhs_in)
        log, _ = child.communicate(timeout=240)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    assert child.returncode == 0, log[-4000:]
    serial = {n: _serial(cfg, ps, n) for n in (TD.PEN_STEPS,
                                               TD.PEN_STEPS + 1)}
    return got, dict(np.load(ref)), serial, rhs


def _blocks2(got, key, ncols=2):
    """The 2×2 ranks' blocks of ``key`` joined as repro's P(rows, cols)
    output joins them (rank i·ncols + j holds block (i, j))."""
    nrows = len(got) // ncols
    return np.concatenate([np.concatenate(
        [got[i * ncols + j][key] for j in range(ncols)], 1)
        for i in range(nrows)], 0)


def _check_serial(d, ps, tol=TOL):
    ids, x = _by_id(d["x"], d["valid"], d["p_id"])
    rv = np_(ps.valid)
    ids_s, x_s = _by_id(np_(ps.x), rv, np_(ps.props["id"]))
    np.testing.assert_array_equal(ids, ids_s)
    assert np.abs(x - x_s).max() <= tol


def test_md_pencil_matches_serial(runs):
    """2×2: the two-stage map and ghost_get (corner ghosts relayed by the
    column exchange of locals + row ghosts) reproduce the serial
    trajectory, ids equal and x within 1e-4, with zero flags."""
    got, _, serial, _ = runs
    assert all(int(g["pen_worst"]) == 0 for g in got)
    np.testing.assert_array_equal(got[0]["pen_col_bounds"],
                                  np.asarray([0.0, 0.5, 1.0], np.float32))
    _check_serial(_cat(got, "pen_"), serial[TD.PEN_STEPS])


def test_md_pencil_matches_repro_by_id(runs):
    """The same 5 steps against repro's pencil step on a 2×2 mesh: the
    same ids, x within 1e-5."""
    got, want, _, _ = runs
    d = _cat(got, "pen_")
    ids, x = _by_id(d["x"], d["valid"], d["p_id"])
    ids_r, x_r = _by_id(want["pen_x"], want["pen_valid"], want["pen_id"])
    np.testing.assert_array_equal(ids, ids_r)
    assert np.abs(x - x_r).max() <= TOL_REPRO


def test_md_tuple_with_one_column_is_the_slab_step_bit_for_bit(runs):
    """(4, 1) with the ("rows", "cols") tuple runs the slab step over the
    rows, carrying col_bounds: bit for bit the "shards" step."""
    got, _, _, _ = runs
    for g in got:
        assert bool(g["t41_has_cols"]) and not bool(g["slab_has_cols"])
        for k in ("x", "valid", "p_v", "p_id"):
            np.testing.assert_array_equal(g[f"t41_{k}"], g[f"slab_{k}"])


def test_rebalance_2d_matches_repro(runs):
    """The 2-D make_rebalance of a set crowded toward low x and low y:
    the row and column bounds and every rank's slots equal repro's bit
    for bit, both moved off uniform, no overflow."""
    got, want, _, _ = runs
    for g in got:
        np.testing.assert_array_equal(g["rb_bounds"], want["rb_bounds"])
        np.testing.assert_array_equal(g["rb_col_bounds"],
                                      want["rb_col_bounds"])
        assert int(g["rb_ovf"]) == 0 == int(want["rb_ovf"])
    assert want["rb_bounds"][1] < 0.5 and want["rb_col_bounds"][1] < 0.5
    d = _cat(got, "rb_")
    np.testing.assert_array_equal(d["valid"], want["rb_valid"])
    np.testing.assert_array_equal(d["x"], want["rb_x"])
    np.testing.assert_array_equal(d["p_id"], want["rb_id"])


def test_rebalance_2d_keeps_the_trajectory(runs):
    """A rebalance after step 3 of 6 moves the row and column bounds and
    the trajectory stays within 1e-4 of serial."""
    got, _, serial, _ = runs
    assert all(int(g["reb_worst"]) == 0 for g in got)
    assert not np.array_equal(got[0]["reb_bounds"],
                              np.asarray([0.0, 0.5, 1.0], np.float32))
    assert all(np.array_equal(g["reb_col_bounds"], got[0]["reb_col_bounds"])
               for g in got)
    _check_serial(_cat(got, "reb_"), serial[TD.PEN_STEPS + 1])


def test_pencil_reuse_is_the_inert_fallback(runs):
    """reuse="skin" on a pencil mesh: stale == 1 every step, and the
    states equal the pencil step's bit for bit."""
    got, _, _, _ = runs
    for g in got:
        assert g["reu_stale"].tolist() == [1] * TD.PEN_REUSE_STEPS
        assert int(g["reu_worst"]) == 0
        for k in ("x", "valid", "p_v"):
            np.testing.assert_array_equal(g[f"reu_{k}"], g[f"pen3_{k}"])


@pytest.mark.parametrize("name", sorted(TD.POISSON_MESHES))
def test_pencil_poisson_matches_serial(runs, name):
    """Each mesh shape reproduces the serial spectral solve (the
    transposes move data only); (4, 1) is the slab solve bit for bit, and
    on 1 × 1 the generic two-transpose plan matches too."""
    got, _, _, rhs = runs
    lengths = TD.POISSON_LENGTHS
    ref = np_(PS.fft_poisson(torch.from_numpy(rhs), lengths))
    outs = [got[0][f"poisson_{name}"]]
    if name == "11":
        outs.append(got[0]["poisson_11_plan"])
    if name == "41":
        np.testing.assert_array_equal(outs[0], got[0]["poisson_slab"])
    for out in outs:
        assert np.abs(out - ref).max() <= TOL_POISSON * np.abs(ref).max()
    for g in got:
        np.testing.assert_array_equal(g[f"poisson_{name}"], outs[0])


def test_pencil_grid_layer_matches_repro(runs):
    """distribute_field2's bounds, halo_pad2 (corners relayed through the
    edge neighbours) and halo_reduce2 of the padded blocks on 2×2 against
    repro's on the same field bit for bit; a halo-1 stencil through
    apply_stencil_local2 within 1e-6 of repro's max (XLA contracts the
    stencil's multiply-adds on the CPU)."""
    got, want, _, _ = runs
    for g in got:
        np.testing.assert_array_equal(g["f2_bounds"], want["f2_bounds"])
        np.testing.assert_array_equal(g["f2_col_bounds"],
                                      want["f2_col_bounds"])
    for key in ("h2_pad", "h2_red"):
        np.testing.assert_array_equal(_blocks2(got, key), want[key])
    lap = want["h2_lap"]
    assert np.abs(_blocks2(got, "h2_lap") - lap).max() <= (
        TOL_STENCIL * np.abs(lap).max())


@pytest.mark.parametrize("name", sorted(TD.POISSON_MESHES))
def test_pencil_poisson_matches_repro(runs, name):
    """Each mesh shape's pencil solve against repro's
    make_fft_poisson_pencil on the same mesh shape and rhs: within 2e-5
    of repro's max (the two packages' FFTs round differently)."""
    got, want, _, _ = runs
    ref = want[f"poisson_{name}"]
    assert np.abs(got[0][f"poisson_{name}"] - ref).max() <= (
        TOL_POISSON * np.abs(ref).max())


def test_vortex_pencil_matches_repro(runs):
    """The pencil VIC step on 2×2, 3 steps, against repro's
    make_distributed_vic_step on a 2×2 mesh of the same config: within
    1e-4 relative to repro's max, neither overflowing."""
    got, want, _, _ = runs
    ref = want["vic_pen"]
    assert int(want["vic_pen_ovf"]) == 0
    for g in got:
        assert int(g["vic_pen_ovf"]) == 0
        assert np.abs(g["vic_pen"] - ref).max() <= TOL * np.abs(ref).max()


def test_vortex_pencil_matches_serial(runs):
    """The pencil VIC step on 2×2 ((16, 8) blocks): 3 steps within 1e-4
    of the port's serial vic_step relative to the max, no overflow."""
    got, _, _, _ = runs
    cfg = TD.vic_pencil_config(V)
    w = V.project_divfree(V.init_ring(cfg), cfg)
    for _ in range(TD.VIC_PEN_STEPS):
        w, ovf = V.vic_step(w, cfg)
        assert int(ovf) == 0
    w = np_(w)
    for g in got:
        assert g["vic_block"].tolist() == [16, 8]
        assert int(g["vic_pen_ovf"]) == 0
        assert np.abs(g["vic_pen"] - w).max() <= TOL * np.abs(w).max()


def test_vortex_tuple_with_one_column_is_the_slab_run_bit_for_bit(runs):
    """run_distributed on (4, 1) with the tuple: the slab run bit for
    bit."""
    got, _, _, _ = runs
    for g in got:
        np.testing.assert_array_equal(g["vic_t41"], g["vic_slab"])
