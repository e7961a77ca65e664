"""The sharded fleet, its server and PS-CMA-ES on the port's 1-D
("fleet",) mesh (``fleet.batch.shard_ensemble``, ``make_fleet_step(mesh)``,
``FleetServer(mesh=)``, ``ps_cma_es_torch(mesh=)``, ``cmaes.migrate``
across shards): on 4 gloo ranks against the port's serial paths in the
same rank process, and ``migrate`` against repro's on 4 forced host
devices. Sizes are tests/distributed/test_dist_fleet.py's at 4 ranks
instead of 8: 8 MD members (2 a rank), 8 server slots, a population of 8.

Members do not interact, so the sharded fleet and the server equal the
serial runs bit for bit, as the port's fleet does on one rank; the
sharded PS-CMA-ES draws what the serial run draws and its best equals
the serial best; ``migrate`` moves data only, so it equals repro's
exactly.

The module's fixture starts its 4 ranks once (tests/_torch_dist.py's
``fleet`` body) beside one repro subprocess."""
import os
import subprocess
import sys

import numpy as np
import pytest

import _torch_dist as TD
from benchmarks.xla_env import ensure_forced_host_devices

WORLD = 4


def _population(path):
    """A stacked population of 8 instances in d = 10 whose best (index 1,
    shard 0) and worst (index 5, shard 2) lie on different shards."""
    rng = np.random.default_rng(7)
    b, n = 8, 10
    a = rng.normal(size=(b, n, n)).astype(np.float32)
    best_f = rng.uniform(1.0, 50.0, b).astype(np.float32)
    best_f[1], best_f[5] = 0.25, 99.0
    pop = dict(mean=rng.normal(size=(b, n)).astype(np.float32),
               sigma=rng.uniform(0.1, 2.0, b).astype(np.float32),
               C=(a @ a.transpose(0, 2, 1) / n
                  + np.eye(n, dtype=np.float32)),
               p_sigma=rng.normal(size=(b, n)).astype(np.float32),
               p_c=rng.normal(size=(b, n)).astype(np.float32),
               best_f=best_f,
               best_x=rng.normal(size=(b, n)).astype(np.float32),
               evals=np.full(b, 40, np.int32), gen=np.full(b, 4, np.int32))
    np.savez(path, **pop)
    return pop


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_fleet")
    pop_in, ref, out_dir = tmp / "pop.npz", tmp / "repro.npz", tmp / "srv"
    pop = _population(pop_in)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    # one XLA thread: the child shares the CPU with the 4 ranks
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_cpu_multi_thread_eigen=false").strip()
    ensure_forced_host_devices(env)
    env["PYTHONPATH"] = str(TD.ROOT / "src")
    child = subprocess.Popen(
        [sys.executable, TD.__file__, "--repro-fleet", str(pop_in),
         str(ref)], env=env, cwd=TD.ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        got = TD.run_ranks("fleet", WORLD, tmp, timeout=150,
                           pop_in=str(pop_in), out_dir=str(out_dir))
        log, _ = child.communicate(timeout=240)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    assert child.returncode == 0, log[-4000:]
    return got, dict(np.load(ref)), pop, out_dir


def test_sharded_fleet_matches_serial_loop_bit_for_bit(runs):
    """Rank r steps members [2r, 2r + 2) of the 8: each equals its serial
    run bit for bit, flags are the rank's (2,) rows, one step
    signature."""
    got, _, _, _ = runs
    bl = TD.FLEET_B // WORLD
    for r, g in enumerate(got):
        rows = slice(r * bl, (r + 1) * bl)
        np.testing.assert_array_equal(g["fleet_x"], g["serial_x"][rows])
        np.testing.assert_array_equal(g["fleet_v"], g["serial_v"][rows])
        assert g["fleet_cell"].shape == (bl,)
        assert int(g["fleet_cell"].max()) == 0
        assert int(g["fleet_cache"]) == 1


def test_batch_that_does_not_divide_raises(runs):
    """shard_ensemble of 6 members over 4 ranks, and the meshed step over
    blocks of unequal size, raise ValueError on every rank; so does a
    PS-CMA-ES population of 6."""
    got, _, _, _ = runs
    for g in got:
        assert bool(g["shard_raises"]) and bool(g["step_raises"])
        assert bool(g["cma_raises"])


def test_meshed_server_churn_matches_independent_runs(runs):
    """12 requests through 8 slots sharded 2 a rank: one step signature
    across the churn, every result on every rank equal to its independent
    serial run bit for bit, zero flags, and one checkpoint per request
    (written by the slot's owner), with no .tmp left."""
    got, _, _, out_dir = runs
    n = len(TD.SRV_REQS)
    for g in got:
        assert int(g["srv_cache"]) == 1
        assert g["srv_rids"].tolist() == list(range(n))
        np.testing.assert_array_equal(g["srv_x"], g["srv_ref_x"])
        np.testing.assert_array_equal(g["srv_x"], got[0]["srv_x"])
        assert int(g["srv_flags"].max()) == 0
        assert int(g["srv_completed"]) == n
    assert sorted(p.name for p in out_dir.iterdir()) == sorted(
        f"sim_{r}" for r in range(n))


def test_sharded_cmaes_matches_serial(runs):
    """ps_cma_es_torch(rastrigin, 10, 8, 16000) with the population
    sharded 2 a rank: the best equals the serial run's on every rank (the
    migration is the only traffic between the shards)."""
    got, _, _, _ = runs
    for g in got:
        assert int(g["cma_evals"]) >= TD.CMA_EVALS
        assert float(g["cma_bf"]) == float(g["cma_bf_serial"])
        np.testing.assert_array_equal(g["cma_bx"], g["cma_bx_serial"])


def test_migrate_matches_repro_across_four_shards(runs):
    """migrate on a fixed population of 8, 2 a shard: the best mean
    (shard 0) moves into the worst instance (shard 2), as repro's migrate
    does on 4 devices, with the same values everywhere."""
    got, want, pop, _ = runs
    for k in ("mean", "sigma", "C", "p_sigma", "p_c"):
        mine = np.concatenate([g[f"mig_{k}"] for g in got])
        np.testing.assert_array_equal(mine, want[k])
    hit = [i for i in range(8)
           if not np.array_equal(want["mean"][i], pop["mean"][i])]
    assert hit == [5]
    np.testing.assert_array_equal(want["mean"][5], pop["best_x"][1])
