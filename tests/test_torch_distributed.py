"""The port's 1-D slab layer against its own serial paths (which the other
test_torch_* files hold against repro): the distributed MD, SPH and DEM
steps on 4 gloo ranks (overlap and blocking bit for bit, a thin-slab
2-hop case), the grid halo layer against numpy, the split-phase stencil,
gray_scott.run_distributed, the slab FFT Poisson solve, the distributed
VIC step and a mesh-field physics riding the mesh step. Tolerances: 1e-4
(absolute on positions and velocities, relative to the max on fields), as
repro's tests/distributed suite; bit for bit where the arithmetic is the
same. A test marked gpu runs the world-1 NCCL MD step on the card.

Each fixture below starts its ranks once (tests/_torch_dist.py) and
several tests read the result."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_dist as TD
from _torch_bridge import ToyCfg, np_, toy_physics
from repro_torch import convert
from repro_torch.apps import dem, gray_scott as GS, md, sph, vortex as V
from repro_torch.core import runtime as RT
from repro_torch.core import simulation as SIM
from repro_torch.core.particles import from_positions
from repro_torch.numerics import poisson as PS

TOL = 1e-4
WORLD = 4


def _serial(physics, cfg, ps, n, extras_at=None):
    step = SIM.make_sim_step(physics, cfg)
    st = SIM.serial_state(ps, physics, cfg)
    out = []
    for i in range(n):
        st, flags, scal = step(st, extras_at(i) if extras_at else {})
        assert int(flags.any()) == 0
        out.append(scal)
    return st.ps, out


def _cat(got, prefix):
    """The ranks' blocks of one particle state, in rank order."""
    return {k[len(prefix):]: np.concatenate([g[k] for g in got])
            for k in got[0] if k.startswith(prefix) and got[0][k].ndim}


def _by_id(dist, ref, key):
    """(distributed values, the serial values of the same ids)."""
    val = dist["valid"]
    serial = np_(ref.x if key == "x" else ref.props[key])
    rv = np_(ref.valid)
    by_id = np.zeros_like(serial)
    by_id[np_(ref.props["id"])[rv]] = serial[rv]
    mine = dist["x"] if key == "x" else dist[f"p_{key}"]
    return mine[val], by_id[dist["p_id"][val]]


# --------------------------------------------------------------------------
# MD on 4 ranks
# --------------------------------------------------------------------------

#: name -> (n_per_side, sigma, cell_cap, steps, overlap, n_hops, cap)
MD_CASES = {
    "main": (10, 0.04, 8, 10, True, None, 400),
    "blocking": (10, 0.04, 8, 10, False, None, 400),
    # slabs 0.25 wide under r_cut 0.255: the second hop is needed
    "thin": (8, 0.085, 32, 10, True, 2, 300),
}


def _md_start(nps, sigma, cc, seed):
    cfg = md.MDConfig(n_per_side=nps, sigma=sigma, dt=0.0005, cell_cap=cc,
                      device="cpu")
    rng = np.random.default_rng(seed)
    v = (0.3 * rng.standard_normal((cfg.n_particles, 3))).astype(np.float32)
    v = v - v.mean(0)
    ps = md.init_particles(cfg, capacity=cfg.n_particles)
    return cfg, SIM.with_ids(ps.with_prop("v", torch.from_numpy(v))), v


@pytest.fixture(scope="module")
def md_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("md")
    vs, refs = {}, {}
    for name, (nps, sigma, cc, n, _, _, _) in MD_CASES.items():
        cfg, ps, vs[f"{name}_v"] = _md_start(nps, sigma, cc,
                                             seed=int(name == "thin"))
        if name != "blocking":
            refs[name], _ = _serial(md.physics, cfg, ps, n)
    refs["blocking"] = refs["main"]
    np.savez(tmp / "md_in.npz", **vs)
    got = TD.run_ranks("md_steps", WORLD, tmp, timeout=150,
                       inp=str(tmp / "md_in.npz"),
                       cases={k: list(v) for k, v in MD_CASES.items()})
    return got, refs


@pytest.mark.parametrize("name", ["main", "thin"])
def test_md_distributed_matches_serial(md_runs, name):
    """map() + ghost_get + the pair pass on 4 ranks, 10 steps, against
    the serial md step by id: x and v within 1e-4, LJ engaged, every
    flag 0 on every rank; the thin case exchanges 2 ghost hops."""
    got, refs = md_runs
    assert all(int(g[f"{name}_worst"]) == 0 for g in got)
    d = _cat(got, f"{name}_")
    nps = MD_CASES[name][0]
    assert int(d["valid"].sum()) == nps ** 3
    for key in ("x", "v"):
        a, b = _by_id(d, refs[name], key)
        assert np.abs(a - b).max() <= TOL, (key, np.abs(a - b).max())
    assert np.abs(d["p_f"][d["valid"]]).max() > 1e-2


def test_md_overlap_equals_blocking_bit_for_bit(md_runs):
    got, _ = md_runs
    a, b = _cat(got, "main_"), _cat(got, "blocking_")
    assert sorted(a) == sorted(b)
    for k in a:
        assert np.array_equal(a[k], b[k]), k


def test_gather_dist_state_joins_the_blocks(md_runs):
    """convert.gather_dist_state gives every rank the blocks in rank
    order: the global state repro holds."""
    got, _ = md_runs
    blocks = _cat(got, "main_")
    for g in got:
        for k in blocks:
            assert np.array_equal(g[f"gathered_{k}"], blocks[k]), k


# --------------------------------------------------------------------------
# SPH and DEM on 4 ranks
# --------------------------------------------------------------------------

SPH_STEPS = 20
DEM_STEPS = 10


@pytest.fixture(scope="module")
def sph_dem_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sph_dem")
    dcfg = TD.dem_test_config(dem)
    ps = dem.init_block(dcfg)
    rng = np.random.default_rng(1)
    v = (0.3 * rng.standard_normal(tuple(ps.props["v"].shape))).astype(
        np.float32)
    ps = ps.with_prop("v", torch.where(ps.valid[:, None],
                                       torch.from_numpy(v), 0.0))
    ps, _ = _serial(dem.physics, dcfg, ps, 20)     # settle: real contacts
    ps = SIM.with_ids(ps)
    x, valid, props = convert.particles_to_numpy(ps)
    np.savez(tmp / "dem_in.npz", x=x, valid=valid,
             **{f"p_{k}": a for k, a in props.items()})
    got = TD.run_ranks("sph_dem", WORLD, tmp, timeout=150,
                       sph_steps=SPH_STEPS, dem_in=str(tmp / "dem_in.npz"),
                       dem_steps=DEM_STEPS)
    scfg = TD.sph_test_config(sph)
    sps = SIM.with_ids(sph.init_dam_break(scfg, capacity_factor=1.05))
    sref, scal = _serial(sph.physics, scfg, sps, SPH_STEPS,
                         lambda i: {"euler": i % scfg.verlet_reset == 0})
    dref, _ = _serial(dem.physics, dcfg, ps, DEM_STEPS)
    return got, sref, [float(s["dt"]) for s in scal], dref


def test_sph_distributed_matches_serial(sph_dem_runs):
    """The dam break (ghost_get of the ("v", "rho", "kind") subset, the
    pmax'd global dt) on 4 ranks against the serial steps by id, 20
    steps: x, v within 1e-4, rho within 1e-4 of rho0, the dt of every
    step within 1e-4 relative."""
    got, ref, dts, _ = sph_dem_runs
    cfg = TD.sph_test_config(sph)
    assert all(int(g["sph_worst"]) == 0 for g in got)
    for g in got:
        assert np.allclose(g["sph_dt"], dts, rtol=1e-4, atol=0)
        assert g["sph_load"].shape == (WORLD,)
    d = _cat(got, "sph_")
    assert int(d["valid"].sum()) == int(ref.valid.sum())
    assert int(got[0]["sph_load"].sum()) == int(ref.valid.sum())
    for key, scale in (("x", 1.0), ("v", 1.0), ("rho", cfg.rho0)):
        a, b = _by_id(d, ref, key)
        assert np.abs(a - b).max() / scale <= TOL, (key, np.abs(a - b).max())


def test_dem_distributed_matches_serial(sph_dem_runs):
    """The avalanche on 4 ranks (id-keyed tangential history across
    ghosts) against the serial steps by id: x, v, w within 1e-4."""
    got, _, _, ref = sph_dem_runs
    assert all(int(g["dem_worst"]) == 0 for g in got)
    d = _cat(got, "dem_")
    assert int(d["valid"].sum()) == int(ref.valid.sum())
    for key in ("x", "v", "w"):
        a, b = _by_id(d, ref, key)
        assert np.abs(a - b).max() <= TOL, (key, np.abs(a - b).max())
    assert (d["p_ct_id"][d["valid"]] >= 0).any()     # springs in play


# --------------------------------------------------------------------------
# The grid layer on 4 ranks
# --------------------------------------------------------------------------

GS_STEPS = 10


@pytest.fixture(scope="module")
def grid_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("grid")
    rng = np.random.default_rng(3)
    f = rng.normal(size=(32, 5)).astype(np.float32)
    rhs = rng.normal(size=(16, 8, 12, 3)).astype(np.float32)
    np.save(tmp / "halo.npy", f)
    np.save(tmp / "rhs.npy", rhs)
    got = TD.run_ranks("grid", WORLD, tmp, timeout=150,
                       halo_f=str(tmp / "halo.npy"), gs_steps=GS_STEPS,
                       rhs=str(tmp / "rhs.npy"))
    return got, f, rhs


def _np_pad(f, halo, periodic, fill, world):
    """Each rank's padded block, from a numpy pad of the global array."""
    if periodic:
        g = np.concatenate([f[-halo:], f, f[:halo]])
    elif fill is None:
        g = np.concatenate([f[:1].repeat(halo, 0), f, f[-1:].repeat(halo, 0)])
    else:
        pad = np.full((halo,) + f.shape[1:], fill, f.dtype)
        g = np.concatenate([pad, f, pad])
    nl = f.shape[0] // world
    return [g[d * nl:(d + 1) * nl + 2 * halo] for d in range(world)]


def _np_reduce(f, halo, periodic, world):
    """halo_reduce of the padded blocks: every owned edge row gets its
    copy back from the neighbour's halo, except on a closed box's ends."""
    nl = f.shape[0] // world
    out = []
    for d in range(world):
        blk = f[d * nl:(d + 1) * nl].copy()
        if periodic or d > 0:
            blk[:halo] += f[d * nl:d * nl + halo]
        if periodic or d < world - 1:
            blk[-halo:] += f[(d + 1) * nl - halo:(d + 1) * nl]
        out.append(blk)
    return out


@pytest.mark.parametrize("mode", range(len(TD.HALO_MODES)))
def test_halo_pad_and_reduce_match_numpy(grid_runs, mode):
    """halo_pad (periodic, a fill value, fill=None edge replication) and
    halo_reduce against numpy oracles; the start/finish halves equal the
    blocking forms bit for bit."""
    got, f, _ = grid_runs
    periodic, fill = TD.HALO_MODES[mode]
    for d, (g, want) in enumerate(zip(got, _np_pad(f, 2, periodic, fill,
                                                   WORLD))):
        assert np.array_equal(g[f"pad{mode}"], want), d
        assert np.array_equal(g[f"pad_split{mode}"], g[f"pad{mode}"]), d
    for d, (g, want) in enumerate(zip(got, _np_reduce(f, 2, periodic,
                                                      WORLD))):
        assert np.array_equal(g[f"red{mode}"], want), d
        assert np.array_equal(g[f"red_split{mode}"], g[f"red{mode}"]), d


def test_stencil_overlap_equals_blocking_bit_for_bit(grid_runs):
    got, _, _ = grid_runs
    for g in got:
        assert np.array_equal(g["stencil_ov1"], g["stencil_ov0"])


def test_gray_scott_distributed_matches_run(grid_runs):
    got, _, _ = grid_runs
    cfg = GS.GSConfig(shape=(8 * WORLD, 8, 8), device="cpu")
    u, v = GS.run(cfg, GS_STEPS, seed=5)
    for g in got:           # every rank holds the gathered fields
        assert np.abs(g["gs_u"] - np_(u)).max() <= TOL
        assert np.abs(g["gs_v"] - np_(v)).max() <= TOL


def test_slab_poisson_matches_fft_poisson(grid_runs):
    """The slab solve (one all_to_all transpose) on 4 ranks, and at world
    1 (this process), against fft_poisson: 1e-4 of the max."""
    got, _, rhs = grid_runs
    ref = np_(PS.fft_poisson(torch.from_numpy(rhs), (2.0, 1.0, 1.5)))
    u = np.concatenate([g["poisson"] for g in got])
    assert np.abs(u - ref).max() <= TOL * np.abs(ref).max()
    mesh = RT.make_mesh((1,), (TD.AXIS,), device_type="cpu")
    with RT.on_mesh(mesh):
        u1 = PS.fft_poisson_slab_local(torch.from_numpy(rhs),
                                       (2.0, 1.0, 1.5), TD.AXIS)
    assert np.abs(np_(u1) - ref).max() <= TOL * np.abs(ref).max()
    solve = PS.make_fft_poisson_slab(mesh, TD.AXIS, (2.0, 1.0, 1.5))
    assert torch.equal(solve(torch.from_numpy(rhs)),
                       PS.fft_poisson(torch.from_numpy(rhs),
                                      (2.0, 1.0, 1.5)))


# --------------------------------------------------------------------------
# VIC and mesh fields on 4 ranks
# --------------------------------------------------------------------------

TOY_STEPS = 6


@pytest.fixture(scope="module")
def vic_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("vic")
    cfg = TD.vic_test_config(V, "cells")
    w = V.project_divfree(V.init_ring(cfg), cfg)
    np.save(tmp / "w.npy", np_(w))
    tcfg = ToyCfg()
    rng = np.random.default_rng(21)
    x = (rng.uniform(0, 1, (tcfg.n, 3)) * np.asarray(tcfg.box)).astype(
        np.float32)
    np.save(tmp / "toy.npy", x)
    got = TD.run_ranks("vic_mesh", WORLD, tmp, timeout=150,
                       w_in=str(tmp / "w.npy"), toy_in=str(tmp / "toy.npy"),
                       toy_steps=TOY_STEPS)
    return got, w, x


@pytest.mark.parametrize("interp", ["cells", "scatter"])
def test_vic_distributed_step_matches_serial(vic_runs, interp):
    """One make_distributed_vic_step step (slab FFT, halo stencils, the
    1-D block legs, the halo reduce) on 4 ranks against vic_step: 1e-4 of
    the max, no overflow."""
    got, w, _ = vic_runs
    cfg = TD.vic_test_config(V, interp)
    ref, ovf = V.vic_step(w, cfg)
    assert int(ovf) == 0
    assert all(int(g[f"vic_{interp}_ovf"]) == 0 for g in got)
    wd = np.concatenate([g[f"vic_{interp}"] for g in got])
    ref = np_(ref)
    assert np.abs(wd - ref).max() <= TOL * np.abs(ref).max()


def test_toy_mesh_physics_on_mesh_matches_serial(vic_runs):
    """repro's toy mesh physics (deposit by ghost_put, diffusion by
    ghost_get through ctx.grid) riding make_sim_step on 4 ranks against
    its serial run: rho within 1e-4 of its max, flags 0."""
    got, _, x = vic_runs
    cfg = ToyCfg()
    ps0 = SIM.with_ids(from_positions(torch.from_numpy(x)))
    st = SIM.serial_state(ps0, toy_physics, cfg,
                          fields={"rho": torch.zeros(cfg.shape)})
    step = SIM.make_sim_step(toy_physics, cfg)
    for _ in range(TOY_STEPS):
        st, flags, _ = step(st, {})
        assert int(flags.any()) == 0
    ref = np_(st.fields["rho"])
    assert all(int(g["toy_worst"]) == 0 for g in got)
    rho = np.concatenate([g["toy_rho"] for g in got])
    assert ref.sum() > cfg.n * 5
    assert np.abs(rho - ref).max() <= TOL * np.abs(ref).max()


# --------------------------------------------------------------------------
# No fallback, and the card
# --------------------------------------------------------------------------

def test_make_mesh_cuda_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        RT.make_mesh((1,), (TD.AXIS,), device_type="cuda")
    with pytest.raises(ValueError, match="device_type"):
        RT.make_mesh((1,), (TD.AXIS,), device_type="tpu")


def _nccl_md(launcher, timeout, what="--nccl-md"):
    env = dict(os.environ, PYTHONPATH=str(TD.ROOT / "src"))
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    r = subprocess.run(launcher + [TD.__file__, what], cwd=TD.ROOT,
                       env=env, capture_output=True, text=True,
                       timeout=timeout)
    print(r.stdout[-8000:])
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]


@pytest.mark.gpu
def test_world1_nccl_md_step_matches_serial():
    """The MD step on a 1-rank NCCL mesh on the card (its own process)
    against the serial step: x and v by id within 1e-4, flags 0, B1 twice
    a step with overlap and once without."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is "
                    "False)")
    _nccl_md([sys.executable], 600)


@pytest.mark.gpu
def test_four_card_nccl_md_step_matches_serial():
    """The same on 4 cards, one NCCL rank each under torchrun (the ghost
    exchange as batch_isend_irecv between cards, the map's all_to_all,
    the gathered state checked on every rank), and the slab step's
    ms/step at 216,000 particles printed, with each rank's bytes a step
    (the collective ledger) and NCCL kernel time a step (torch.profiler)."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA cards (torch.cuda.device_count() is "
                    f"{torch.cuda.device_count()})")
    _nccl_md([sys.executable, "-m", "torch.distributed.run", "--standalone",
              "--nproc_per_node=4"], 900)


@pytest.mark.gpu
def test_four_card_nccl_reuse_and_dlb_match_serial():
    """The reuse cadence and DLB on 4 cards, one NCCL rank each under
    torchrun: the MD reuse slab step (overlap on and off) within 1e-4 of
    the serial step by id, and sph.run_distributed with the threshold
    trigger, whose rebalance moves the bounds off uniform, within 1e-4 of
    the serial steps (tests/_torch_dist.py --nccl-reuse)."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA cards (torch.cuda.device_count() is "
                    f"{torch.cuda.device_count()})")
    _nccl_md([sys.executable, "-m", "torch.distributed.run", "--standalone",
              "--nproc_per_node=4"], 900, "--nccl-reuse")


@pytest.mark.gpu
def test_four_card_nccl_fleet_and_pencil_match_serial():
    """The sharded fleet, PS-CMA-ES and the pencil forms on 4 cards, one
    NCCL rank each under torchrun: the meshed fleet step against the
    members' serial runs, the sharded PS-CMA-ES best against the serial
    run's, and on a 2×2 mesh the MD pencil step (by id within 1e-4 of
    md_step; its ms/step at 216,000 particles printed, with each rank's
    bytes a step and NCCL kernel time a step) and the pencil VIC step
    (within 1e-4 of vic_step) (tests/_torch_dist.py --nccl-fleet-pencil)."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA cards (torch.cuda.device_count() is "
                    f"{torch.cuda.device_count()})")
    _nccl_md([sys.executable, "-m", "torch.distributed.run", "--standalone",
              "--nproc_per_node=4"], 900, "--nccl-fleet-pencil")
