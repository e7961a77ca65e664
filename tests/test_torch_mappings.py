"""The port's runtime and mappings (core/runtime.py, core/mappings.py)
against ``repro``'s and against numpy: bucket packing, map(), ghost_get,
ghost_update and ghost_put at world 1 in this process (a 1-rank gloo
group against repro on a 1-device mesh) and on 4 gloo ranks against
repro on 4 forced host devices; the runtime's collectives on 1, 2 and 4
ranks; the pair engine's ``cells=`` restriction; and the overflow flags.
Slots, ``valid`` and ``src_slot`` are compared exactly, float payloads
bit for bit (copies, or one ±L add); the 4-rank MD steps by id within
1e-4 (tests/distributed/test_dist_equivalence.py's TOL)."""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import _torch_dist as TD
from _torch_bridge import np_
from benchmarks.xla_env import ensure_forced_host_devices
from repro.apps import md as jmd
from repro.core import cell_list as JCL
from repro.core import interactions as JI
from repro.core import mappings as JM
from repro.core import runtime as JRT
from repro.core.particles import ParticleSet as JPS
from repro_torch import convert
from repro_torch.apps import md as tmd
from repro_torch.core import cell_list as TCL
from repro_torch.core import interactions as TI
from repro_torch.core import mappings as TM
from repro_torch.core import runtime as TRT
from repro_torch.core import simulation as TSIM

AXIS = TD.AXIS
TOL = 1e-4


def _same(got, want, what=""):
    got, want = np_(got), np_(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    assert np.array_equal(got, want), (what, got, want)


# --------------------------------------------------------------------------
# Bucket packing
# --------------------------------------------------------------------------

@pytest.mark.parametrize("ndev,bucket_cap,seed", [
    (1, 8, 0),       # everything fits
    (2, 3, 1),       # overflow
    (4, 5, 2),       # discards, overflow, empty buckets
    (4, 16, 3)])
def test_bucket_pack_and_owner_of_match_repro(ndev, bucket_cap, seed):
    rng = np.random.default_rng(seed)
    n = 24
    # discards (dest >= ndev) and a destination that nobody picks
    dest = rng.choice(np.r_[np.arange(max(ndev - 1, 1)), ndev, ndev + 2],
                      n).astype(np.int32)
    payload = {"x": rng.normal(size=(n, 3)).astype(np.float32),
               "k": np.arange(n, dtype=np.int32)}
    jb, jv, jo = JM.bucket_pack(jnp.asarray(dest),
                                {k: jnp.asarray(v) for k, v in
                                 payload.items()}, ndev, bucket_cap)
    tb, tv, to = TM.bucket_pack(torch.from_numpy(dest),
                                {k: torch.from_numpy(v) for k, v in
                                 payload.items()}, ndev, bucket_cap)
    for k in payload:
        _same(tb[k], jb[k], k)
    _same(tv, jv, "slot_valid")
    _same(to, jo, "overflow")
    bounds = np.sort(rng.uniform(0, 1, ndev + 1)).astype(np.float32)
    bounds[0], bounds[-1] = 0.0, 1.0
    xs = np.r_[rng.uniform(-0.1, 1.1, 40), bounds].astype(np.float32)
    _same(TM.owner_of(torch.from_numpy(xs), torch.from_numpy(bounds)),
          JM.owner_of(jnp.asarray(xs), jnp.asarray(bounds)))


@pytest.mark.parametrize("n_in", [24, 200])
def test_add_count_with_another_capacity_matches_repro(n_in):
    """ParticleSet.add_count of an incoming set whose capacity differs
    from the receiver's (map()'s buckets: ndev * bucket_cap rows), with
    and without slot overflow."""
    rng = np.random.default_rng(n_in)

    def sets(n):
        x = rng.normal(size=(n, 3)).astype(np.float32)
        valid = rng.uniform(size=n) > 0.4
        v = rng.normal(size=(n, 3)).astype(np.float32)
        return (JPS(x=jnp.asarray(x), props={"v": jnp.asarray(v)},
                    valid=jnp.asarray(valid)),
                convert.particles_from_numpy(x, valid, {"v": v},
                                             device="cpu"))

    (jps, tps), (jin, tin) = sets(64), sets(n_in)
    (a, ovf_a), (b, ovf_b) = jps.add_count(jin), tps.add_count(tin)
    _same(b.x, a.x)
    _same(b.valid, a.valid)
    _same(b.props["v"], a.props["v"])
    assert int(ovf_b) == int(ovf_a)
    assert (int(ovf_a) > 0) == (n_in == 200)


# --------------------------------------------------------------------------
# World 1 in this process: a 1-rank gloo group against a 1-device mesh
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def meshes():
    jmesh = JRT.make_mesh((1,), (AXIS,), devices=jax.devices()[:1])
    tmesh = TRT.make_mesh((1,), (AXIS,), device_type="cpu")
    return jmesh, tmesh


@pytest.fixture(scope="module")
def world1_sets():
    """The same slab-sharded particle set in both packages (1 rank)."""
    x, valid, props, bounds = TD.mapping_input(7, 1, 160, 120)
    jps = JPS(x=jnp.asarray(x), props={k: jnp.asarray(v)
                                       for k, v in props.items()},
              valid=jnp.asarray(valid))
    tps = convert.particles_from_numpy(x, valid, props, device="cpu")
    return jps, tps, jnp.asarray(bounds), torch.from_numpy(bounds)


def _same_ps(tps, jps, what):
    _same(tps.x, jps.x, what + " x")
    _same(tps.valid, jps.valid, what + " valid")
    for k in jps.props:
        _same(tps.props[k], jps.props[k], f"{what} {k}")


def test_world1_map_matches_repro(meshes, world1_sets):
    jmesh, tmesh = meshes
    jps, tps, jb, tb = world1_sets
    # an inner box: particles outside it are owned by no slab but the
    # clamp keeps them home, as in repro
    jb2, tb2 = jb * 0.5 + 0.25, tb * 0.5 + 0.25
    j, jo = JM.make_map_fn(jmesh, jps, AXIS, 64)(jps, jb2)
    t, to = TM.make_map_fn(tmesh, AXIS, 64)(tps, tb2)
    _same_ps(t, j, "map")
    _same(to, jo, "overflow")


@pytest.mark.parametrize("name,hops,periodic,names,rg", [
    ("h1_periodic_all", 1, True, None, 0.15),
    ("h2_periodic_v", 2, True, ("v",), 0.15),
    ("h1_open_subset", 1, False, ("m", "id"), 0.2),
    ("h2_open_small_cap", 2, False, ("m",), 0.4)])
def test_world1_ghost_get_matches_repro(meshes, world1_sets, name, hops,
                                        periodic, names, rg):
    jmesh, tmesh = meshes
    jps, tps, jb, tb = world1_sets
    cap = 16 if name.endswith("small_cap") else 128
    kw = dict(periodic=periodic, box_len=1.0, prop_names=names,
              n_hops=hops)
    jg, jo = JM.make_ghost_get_fn(jmesh, jps, AXIS, cap, rg, **kw)(jps, jb)
    tg, to = TM.make_ghost_get_fn(tmesh, AXIS, cap, rg, **kw)(tps, tb)
    _same(tg.x, jg.x, "x")
    _same(tg.valid, jg.valid, "valid")
    _same(tg.src_slot, jg.src_slot, "src_slot")
    assert sorted(tg.props) == sorted(jg.props)
    for k in jg.props:
        _same(tg.props[k], jg.props[k], k)
    _same(to, jo, "overflow")
    # one slab: the periodic ghosts are its own faces at ±L; a closed box
    # has none (the wrap link carries no ghosts)
    assert (int(tg.valid.sum()) > 0) == periodic
    if name.endswith("small_cap"):
        assert int(to) > 0


def test_world1_ghost_update_and_put_match_repro(meshes, world1_sets):
    """ghost_update_local after a drift, and ghost_put_local (sum, max,
    min, a float and an int channel) of per-ghost contributions."""
    jmesh, tmesh = meshes
    jps, tps, jb, tb = world1_sets
    rg, cap = 0.2, 128
    kw = dict(periodic=True, box_len=1.0, n_hops=2)
    drift = np.float32(0.01)
    jspec = JM.ps_specs(jps, AXIS)

    def j_local(p, b):
        g, _ = JM.ghost_get_local(p, b, rg, AXIS, cap, prop_names=("v",),
                                  **kw)
        moved = p.replace(x=p.x + drift)
        up = JM.ghost_update_local(moved, p.x, b, rg, AXIS, cap,
                                   prop_names=("m",), **kw)
        contrib = {"c": g.x[..., 0] * 2.0 + 1.0,
                   "n": (g.x[..., 1] * 100).astype(jnp.int32)}
        puts = {op: JM.ghost_put_local(contrib, g, p, AXIS, op=op)
                for op in ("sum", "max", "min")}
        return up, puts

    jup, jputs = jax.jit(JRT.shard_map(
        j_local, jmesh, in_specs=(jspec, P()), out_specs=P(AXIS),
        check_vma=False))(jps, jb)
    with TRT.on_mesh(tmesh):
        g, _ = TM.ghost_get_local(tps, tb, rg, AXIS, cap, prop_names=("v",),
                                  **kw)
        moved = tps.replace(x=tps.x + torch.tensor(drift))
        tup = TM.ghost_update_local(moved, tps.x, tb, rg, AXIS, cap,
                                    prop_names=("m",), **kw)
        contrib = {"c": g.x[..., 0] * 2.0 + 1.0,
                   "n": (g.x[..., 1] * 100).to(torch.int32)}
        tputs = {op: TM.ghost_put_local(contrib, g, tps, AXIS, op=op)
                 for op in ("sum", "max", "min")}
    assert sorted(tup) == sorted(jup)
    for k in jup:
        _same(tup[k], jup[k], f"update {k}")
    for op in jputs:
        for k in jputs[op]:
            _same(tputs[op][k], jputs[op][k], f"put {op} {k}")
    with pytest.raises(ValueError, match="unknown ghost_put op"):
        TM.ghost_put_local(contrib, g, tps, AXIS, op="avg")


# --------------------------------------------------------------------------
# The pair engine's cells= restriction
# --------------------------------------------------------------------------

def test_cells_restriction_matches_repro_and_the_full_pass():
    rng = np.random.default_rng(11)
    n, rc, sigma = 300, 0.2, 0.06
    x = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    valid = rng.uniform(size=n) > 0.1
    gs = (5, 5, 5)
    kw = dict(box_lo=(0.0,) * 3, box_hi=(1.0,) * 3, grid_shape=gs,
              periodic=(True,) * 3, cell_cap=16)
    n_cells = int(np.prod(gs))
    cells = np.r_[rng.choice(n_cells, 30, replace=False),
                  [n_cells, n_cells + 4]].astype(np.int32)
    jps = JPS(x=jnp.asarray(x), props={}, valid=jnp.asarray(valid))
    tps = convert.particles_from_numpy(x, valid, {}, device="cpu")
    jcl = JCL.build_cell_list(jps, **kw)
    tcl = TCL.build_cell_list(tps, **kw)
    pk = dict(out={"f": "radial"}, r_cut=rc)
    j = JI.apply_pair_kernel(jps, jcl, jmd.lj_pair_body(sigma, 1.0),
                             cells=jnp.asarray(cells), **pk)["f"]
    body = tmd.lj_pair_body(sigma, 1.0)
    t = TI.apply_pair_kernel(tps, tcl, body, cells=torch.from_numpy(cells),
                             cell_batch=8, **pk)["f"]
    full = TI.apply_pair_kernel(tps, tcl, body, **pk)["f"]
    scale = float(np.abs(np_(full)).max())
    assert float(np.abs(np_(t) - np.asarray(j)).max()) <= 1e-6 * scale
    homed = np.isin(np_(tcl.cell_id), cells) & valid
    assert homed.sum() > 10
    _same(t[torch.from_numpy(homed)], full[torch.from_numpy(homed)])
    assert not np_(t)[~homed].any()
    assert np.abs(np_(t)[homed]).max() > 1e-2


# --------------------------------------------------------------------------
# The runtime's collectives against numpy, on 1, 2 and 4 ranks
# --------------------------------------------------------------------------

def _expected_collectives(world):
    x = [np.arange(6, dtype=np.float32).reshape(2, 3) + 100 * r
         for r in range(world)]
    a = [np.arange(world * 2, dtype=np.int32).reshape(world, 2) + 10 * r
         for r in range(world)]
    b = [np.arange(2 * world * 3, dtype=np.float32).reshape(2, world * 3)
         + 1000 * r for r in range(world)]
    c = [np.arange(world * 2 * 3, dtype=np.float32).reshape(world * 2, 3)
         + 1000 * r for r in range(world)]
    exp = []
    for d in range(world):
        e = {}
        for hop in (1, 2):
            e[f"right{hop}"] = x[(d - hop) % world]
            e[f"left{hop}"] = x[(d + hop) % world]
        e["both_r"] = x[(d - 1) % world]
        e["both_l"] = 2 * x[(d + 1) % world]
        e["bool_r"] = x[(d - 1) % world] > 102
        e["self"] = x[d]
        e["partial"] = x[0] if d == world - 1 else np.zeros_like(x[0])
        e["a2a"] = np.stack([a[i][d] for i in range(world)])
        e["a2a_t10"] = np.concatenate([b[i][:, 3 * d:3 * d + 3]
                                       for i in range(world)], 0)
        e["a2a_t01"] = np.concatenate([c[i][2 * d:2 * d + 2]
                                       for i in range(world)], 1)
        e["a2a_cplx"] = (e["a2a_t10"] - 1j * e["a2a_t10"]).astype(
            np.complex64)
        e["psum"] = np.int32(world * (world + 1) // 2)
        e["pmax"] = np.int32(world)
        e["pmean"] = np.float32((world + 1) / 2)
        e["pmax_bool"] = np.bool_(True)
        e["gather0"] = np.arange(1, world + 1, dtype=np.int32)
        e["gather"] = np.stack(x)
        e["gather_tiled"] = np.concatenate(x, 0)
        e["gather_ax1"] = np.concatenate(x, 1)
        exp.append(e)
    return exp


@pytest.mark.parametrize("world", [1, 2, 4])
def test_runtime_collectives_on_ranks(world, tmp_path, meshes):
    """ppermute ring shifts at hops 1 and 2 (the self-edge at world 1, the
    double neighbour at world 2), two messages to one peer in one batch,
    bool and complex payloads, all_to_all (untiled and tiled both ways),
    psum/pmax/pmean, all_gather (stacked, tiled, on axis 1): exact.
    World 1 runs in this process."""
    if world == 1:
        with TRT.on_mesh(meshes[1]):
            got = [TD.collectives(meshes[1], 0, 1)]
    else:
        got = TD.run_ranks("collectives", world, tmp_path, timeout=90)
    for d, (g, e) in enumerate(zip(got, _expected_collectives(world))):
        assert sorted(g) == sorted(e)
        for k in e:
            want = np.asarray(e[k])
            assert np.array_equal(g[k], want), (d, k, g[k], want)
            assert g[k].dtype == want.dtype, (d, k)


# --------------------------------------------------------------------------
# Four ranks against repro on four forced host devices
# --------------------------------------------------------------------------

def _md_start(path):
    """The 4-rank MD start of md_repro_config: the lattice (equal to
    repro's bit for bit), numpy velocities, ids, laid out as repro's
    distribute lays it over 4 uniform slabs (400 slots each)."""
    cfg = TD.md_repro_config(tmd)
    ps = tmd.init_particles(cfg, capacity=cfg.n_particles)
    rng = np.random.default_rng(5)
    v = (0.3 * rng.standard_normal((cfg.n_particles, 3))).astype(np.float32)
    ps = TSIM.with_ids(ps.with_prop("v", torch.from_numpy(v - v.mean(0))))
    x, valid, props = convert.particles_to_numpy(ps)
    bounds = np.linspace(0, 1, 5).astype(np.float32)
    X, V, PR = convert.scatter_to_slabs(x, valid, props, bounds, 4,
                                        cap_per_dev=400)
    np.savez(path, x=X, valid=V, bounds=bounds,
             **{f"p_{k}": v for k, v in PR.items()})


def test_four_ranks_match_repro_on_four_devices(tmp_path):
    """map(), ghost_get (1 and 2 hops, periodic or not, prop subsets) and
    ghost_put (sum, max) on 4 gloo ranks equal repro's shard_map on 4
    forced host devices slot for slot; 5 MD steps at dist_common's
    md_config(n_per_side=10, sigma=0.04) (cell_cap 8) leave the same ids
    in the same slots, with x and v within 1e-4."""
    inp, md_in = tmp_path / "map_in.npz", tmp_path / "md_in.npz"
    ref = tmp_path / "repro.npz"
    x, valid, props, bounds = TD.mapping_input(3, 4, TD.MAP_CAP,
                                               TD.MAP_FILLED)
    np.savez(inp, x=x, valid=valid, bounds=bounds,
             **{f"p_{k}": v for k, v in props.items()})
    _md_start(md_in)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    # one XLA thread: the child shares the CPU with the 4 ranks
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_cpu_multi_thread_eigen=false").strip()
    ensure_forced_host_devices(env)
    env["PYTHONPATH"] = str(TD.ROOT / "src")
    child = subprocess.Popen(
        [sys.executable, TD.__file__, "--repro", str(inp), str(md_in),
         str(ref)], env=env, cwd=TD.ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        got = TD.run_ranks("mappings", 4, tmp_path, timeout=150,
                           inp=str(inp), md_in=str(md_in))
        log, _ = child.communicate(timeout=240)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    assert child.returncode == 0, log[-4000:]
    want = dict(np.load(ref))
    cat = {k: np.concatenate([g[k] for g in got]) for k in got[0]
           if got[0][k].ndim}
    for k in [k for k in want if not k.startswith("md_")
              and want[k].ndim]:
        assert np.array_equal(cat[k], want[k]), k
        assert cat[k].dtype == want[k].dtype, k
    for k in ("map_ovf", "h1_per_all_ovf", "h2_per_v_ovf", "h1_np_mid_ovf"):
        assert all(int(g[k]) == int(want[k]) for g in got), k
    assert int(want["h2_per_v_valid"].sum()) > 0
    assert int(want["map_valid"].sum()) == 4 * TD.MAP_FILLED
    # MD: the same ids in the same slots, x and v by id within TOL
    assert int(want["md_worst"]) == 0
    assert all(int(g["md_worst"]) == 0 for g in got)
    _same(cat["md_valid"], want["md_valid"], "md valid")
    val = want["md_valid"]
    _same(cat["md_p_id"][val], want["md_p_id"][val], "md ids")
    err_x = np.abs(cat["md_x"][val] - want["md_x"][val]).max()
    err_v = np.abs(cat["md_p_v"][val] - want["md_p_v"][val]).max()
    assert err_x <= TOL and err_v <= TOL, (err_x, err_v)
    assert np.abs(cat["md_p_f"][val]).max() > 1e-2


# --------------------------------------------------------------------------
# Overflow: every capacity raises its own flag on every rank
# --------------------------------------------------------------------------

def test_overflow_flags_on_every_rank(tmp_path):
    """bucket_cap 8 with every particle starting on rank 0, ghost_cap 4,
    and cell_cap 1: each raises its flag (and only the matching ones) on
    all four ranks — nothing is dropped silently."""
    rng = np.random.default_rng(9)
    v = (0.3 * rng.standard_normal((512, 3))).astype(np.float32)
    np.savez(tmp_path / "ovf_in.npz", v=v)
    got = TD.run_ranks("overflow", 4, tmp_path, timeout=90,
                       inp=str(tmp_path / "ovf_in.npz"))
    for g in got:
        assert int(g["bucket_flag_bucket"]) > 0
        assert int(g["ghost_flag_ghost"]) > 0
        assert int(g["ghost_flag_bucket"]) == 0
        assert int(g["cell_flag_cell"]) > 0
        assert int(g["cell_flag_ghost"]) == 0 == int(g["cell_flag_bucket"])
    for name in ("bucket", "ghost", "cell"):
        assert len({int(g[f"{name}_flag_{name}"]) for g in got}) == 1
