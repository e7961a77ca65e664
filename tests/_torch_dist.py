"""Rank bodies of the multi-rank CPU tests (tests/test_torch_mappings.py,
tests/test_torch_distributed.py, tests/test_torch_dist_reuse.py) and the
runner that starts them.

:func:`run_ranks` starts ``world`` Python processes of this file, each a
gloo rank on the CPU: they meet through a ``file://`` store under the
test's ``tmp_path`` (no port to collide with another worker), run with
one thread each and a 60 s gloo timeout, and each calls one rank body
here and saves what it returns (numpy arrays) as an npz. The runner waits
for them against a deadline: when a rank fails, or the deadline passes,
it kills every rank and fails, so a hung collective fails its test
instead of stalling the suite.

A rank body is ``body(mesh, rank, world, **args) -> {name: array}``; it
imports neither jax nor repro. :func:`repro_reference` and
:func:`repro_reuse_reference` are the functions here that run ``repro``
(each in its own process, on forced host devices); they write the
references that the 4-rank mapping and reuse bodies are held against.
"""
from __future__ import annotations

import dataclasses
import datetime
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
AXIS = "shards"

# --- the 4-rank mapping case shared by repro_reference and `mappings` ----
MAP_CAP = 96           # slots per rank
MAP_FILLED = 60        # valid particles a rank starts with
MAP_BUCKET = 64
GHOST_CAP = 128
#: name -> (n_hops, periodic, prop subset or None, r_ghost)
GHOST_CASES = {
    "h1_per_all": (1, True, None, 0.1),
    "h2_per_v": (2, True, ("v",), 0.3),
    "h1_np_mid": (1, False, ("m", "id"), 0.1),
}
MD_REPRO_STEPS = 5


def mapping_input(seed: int, ndev: int, cap: int, filled: int):
    """Global arrays of a slab-sharded set whose particles sit at random
    positions in the unit cube, so ``map()`` has work: ``filled`` valid
    particles per rank block (the rest invalid), props v (3,), m, id."""
    rng = np.random.default_rng(seed)
    n = ndev * cap
    x = np.full((n, 3), 1e30, np.float32)
    valid = np.zeros(n, bool)
    for d in range(ndev):
        rows = d * cap + rng.choice(cap, filled, replace=False)
        valid[rows] = True
    x[valid] = rng.uniform(0, 1, (int(valid.sum()), 3)).astype(np.float32)
    props = {"v": rng.normal(size=(n, 3)).astype(np.float32),
             "m": rng.uniform(1, 2, n).astype(np.float32),
             "id": np.arange(n, dtype=np.int32)}
    bounds = np.linspace(0, 1, ndev + 1).astype(np.float32)
    return x, valid, props, bounds


# --------------------------------------------------------------------------
# The runner
# --------------------------------------------------------------------------

def run_ranks(body: str, world: int, tmp_path, *, timeout: float = 120.0,
              **args):
    """Run ``body`` on ``world`` gloo ranks; returns each rank's results
    (a list of dicts of numpy arrays, in rank order)."""
    d = pathlib.Path(tmp_path) / f"{body}_{world}"
    d.mkdir(parents=True)
    (d / "args.json").write_text(json.dumps(args))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    procs = []
    for r in range(world):
        log = open(d / f"rank{r}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, __file__, body, str(r), str(world), str(d)],
            stdout=log, stderr=subprocess.STDOUT, env=env, cwd=ROOT), log))
    deadline = time.monotonic() + timeout
    failed = None
    try:
        while True:
            codes = [p.poll() for p, _ in procs]
            if all(c == 0 for c in codes):
                break
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                failed = f"rank {bad[0]} exited with {codes[bad[0]]}"
                break
            if time.monotonic() > deadline:
                failed = f"ranks still running after {timeout} s"
                break
            time.sleep(0.05)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            log.close()
    if failed:
        logs = "\n".join(f"--- rank {r} ---\n"
                         + (d / f"rank{r}.log").read_text()[-3000:]
                         for r in range(world))
        raise AssertionError(f"{body} on {world} ranks: {failed}\n{logs}")
    out = []
    for r in range(world):
        with np.load(d / f"rank{r}.npz") as z:
            out.append({k: z[k] for k in z.files})
    return out


def _main(argv) -> None:
    body, rank, world, d = argv[1], int(argv[2]), int(argv[3]), argv[4]
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    sys.path.insert(0, str(ROOT / "src"))
    d = pathlib.Path(d)
    dist.init_process_group("gloo", init_method=f"file://{d / 'store'}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    from repro_torch.core import runtime as RT
    mesh = RT.make_mesh((world,), (AXIS,), device_type="cpu")
    args = json.loads((d / "args.json").read_text())
    with RT.on_mesh(mesh):
        out = globals()[body](mesh, rank, world, **args)
    np.savez(d / f"rank{rank}.npz", **{k: np.asarray(v)
                                       for k, v in out.items()})
    dist.destroy_process_group()


def _np(t):
    return t.detach().cpu().numpy()


def _ps_arrays(prefix: str, ps):
    out = {f"{prefix}x": _np(ps.x), f"{prefix}valid": _np(ps.valid)}
    out.update({f"{prefix}p_{k}": _np(v) for k, v in ps.props.items()})
    return out


def _flags(prefix: str, flags):
    return {f"{prefix}flag_{f.name}": _np(getattr(flags, f.name))
            for f in dataclasses.fields(flags)}


# --------------------------------------------------------------------------
# Rank bodies
# --------------------------------------------------------------------------

def collectives(mesh, rank, world):
    """Every collective of the runtime on small tensors."""
    import torch
    from repro_torch.core import runtime as RT
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 100 * rank
    out = {}
    for hop in (1, 2):
        right, left = RT.shift_perms(world, hop)
        out[f"right{hop}"] = RT.ppermute(x, AXIS, right)
        out[f"left{hop}"] = RT.ppermute(x, AXIS, left)
    right, left = RT.shift_perms(world)
    both = RT.ppermute_many_start([([x], right), ([x * 2], left)],
                                  AXIS).wait()
    out["both_r"], out["both_l"] = both[0][0], both[1][0]
    out["bool_r"] = RT.ppermute(x > 102, AXIS, right)
    out["self"] = RT.ppermute(x, AXIS, [(i, i) for i in range(world)])
    out["partial"] = RT.ppermute(x, AXIS, [(0, world - 1)])
    a = torch.arange(world * 2, dtype=torch.int32).reshape(world, 2) \
        + 10 * rank
    out["a2a"] = RT.all_to_all(a, AXIS)
    b = torch.arange(2 * world * 3, dtype=torch.float32).reshape(
        2, world * 3) + 1000 * rank
    out["a2a_t10"] = RT.all_to_all(b, AXIS, split_axis=1, concat_axis=0,
                                   tiled=True)
    c = torch.arange(world * 2 * 3, dtype=torch.float32).reshape(
        world * 2, 3) + 1000 * rank
    out["a2a_t01"] = RT.all_to_all(c, AXIS, split_axis=0, concat_axis=1,
                                   tiled=True)
    z = torch.complex(b, -b)
    out["a2a_cplx"] = RT.all_to_all(z, AXIS, split_axis=1, concat_axis=0,
                                    tiled=True)
    s = torch.tensor(rank + 1, dtype=torch.int32)
    out["psum"] = RT.psum(s, AXIS)
    out["pmax"] = RT.pmax(s, AXIS)
    out["pmean"] = RT.pmean(s.to(torch.float32), AXIS)
    out["pmax_bool"] = RT.pmax(torch.tensor(rank == world - 1), AXIS)
    out["gather0"] = RT.all_gather(s, AXIS)
    out["gather"] = RT.all_gather(x, AXIS)
    out["gather_tiled"] = RT.all_gather(x, AXIS, tiled=True)
    out["gather_ax1"] = RT.all_gather(x, AXIS, axis=1, tiled=True)
    return {k: _np(v) for k, v in out.items()}


def mappings(mesh, rank, world, inp, md_in):
    """map(), ghost_get (GHOST_CASES), ghost_put and MD_REPRO_STEPS MD
    steps from the inputs ``repro_reference`` reads: this rank's
    blocks."""
    import torch
    from repro_torch import convert
    from repro_torch.apps import md
    from repro_torch.core import mappings as M
    from repro_torch.core import simulation as SIM
    z = dict(np.load(inp))
    props = {k[2:]: z[k] for k in z if k.startswith("p_")}
    st = convert.dist_state_from_numpy(z["x"], z["valid"], props,
                                       z["bounds"], rank, world,
                                       device="cpu")
    out = {}
    mp = M.make_map_fn(mesh, AXIS, MAP_BUCKET)
    ps, ovf = mp(st.ps, st.bounds)
    out.update(_ps_arrays("map_", ps))
    out["map_ovf"] = _np(ovf)
    for name, (hops, periodic, names, rg) in GHOST_CASES.items():
        gg = M.make_ghost_get_fn(mesh, AXIS, GHOST_CAP, rg,
                                 periodic=periodic, box_len=1.0,
                                 prop_names=names, n_hops=hops)
        g, o = gg(ps, st.bounds)
        out[f"{name}_x"], out[f"{name}_valid"] = _np(g.x), _np(g.valid)
        out[f"{name}_src"], out[f"{name}_ovf"] = _np(g.src_slot), _np(o)
        out.update({f"{name}_p_{k}": _np(v) for k, v in g.props.items()})
        if name == "h1_per_all":
            from repro_torch.core import runtime as RT
            with RT.on_mesh(mesh):
                # repro_reference sends the same contributions
                contrib = {"c": g.x[..., 0] * 2.0 + 1.0,
                           "n": (g.x[..., 1] * 100).to(torch.int32)}
                for op in ("sum", "max"):
                    put = M.ghost_put_local(contrib, g, ps, AXIS, op=op)
                    out.update({f"put_{op}_{k}": _np(v)
                                for k, v in put.items()})
    z = dict(np.load(md_in))
    props = {k[2:]: z[k] for k in z if k.startswith("p_")}
    st = convert.dist_state_from_numpy(z["x"], z["valid"], props,
                                       z["bounds"], rank, world,
                                       device="cpu")
    cfg = md_repro_config(md)
    step = SIM.make_sim_step(md.physics, cfg, mesh)
    worst = torch.zeros((), dtype=torch.int32)
    for _ in range(MD_REPRO_STEPS):
        st, flags, _ = step(st, {})
        worst = torch.maximum(worst, flags.any())
    out.update(_ps_arrays("md_", st.ps))
    out["md_worst"] = _np(worst)
    return out


def md_repro_config(md):
    """benchmarks/dist_common.md_config(n_per_side=10, sigma=0.04) with
    cell_cap 8 (either package's module ``md``)."""
    return dataclasses.replace(
        md.MDConfig(n_per_side=10, sigma=0.04, dt=0.0005), cell_cap=8,
        **({"device": "cpu"} if "device" in md.MDConfig.__dataclass_fields__
           else {}))


def md_steps(mesh, rank, world, inp, cases):
    """The MD cases: ``cases`` maps a name to (n_per_side, sigma,
    cell_cap, n_steps, overlap, n_hops, cap_per_dev); each starts from
    ``inp``'s ``<name>_v`` velocities on the lattice."""
    import torch
    from repro_torch import convert
    from repro_torch.apps import md
    from repro_torch.core import simulation as SIM
    z = dict(np.load(inp))
    out = {}
    for name, (nps, sigma, cc, n_steps, overlap, hops, cap) in \
            cases.items():
        cfg = md.MDConfig(n_per_side=nps, sigma=sigma, dt=0.0005,
                          cell_cap=cc, device="cpu")
        ps0 = md.init_particles(cfg, capacity=cfg.n_particles)
        ps0 = ps0.with_prop("v", torch.from_numpy(z[f"{name}_v"]))
        st = SIM.distribute(ps0, md.physics, cfg, mesh, cap_per_dev=cap)
        step = SIM.make_sim_step(md.physics, cfg, mesh, overlap=overlap,
                                 n_hops=hops)
        worst = torch.zeros((), dtype=torch.int32)
        for _ in range(n_steps):
            st, flags, _ = step(st, {})
            worst = torch.maximum(worst, flags.any())
        out.update(_ps_arrays(f"{name}_", st.ps))
        out[f"{name}_worst"] = _np(worst)
        if name == "main":
            g = convert.gather_dist_state(st, mesh, AXIS)
            out.update(_ps_arrays("gathered_", g.ps))
    return out


def sph_dem(mesh, rank, world, sph_steps, dem_in, dem_steps):
    """The SPH dam break and the DEM avalanche of benchmarks/dist_common
    on the mesh: the final blocks, SPH's dt per step, the worst flags."""
    import torch
    from repro_torch.apps import dem, sph
    from repro_torch.core import simulation as SIM
    out = {}
    cfg = sph_test_config(sph)
    ps0 = sph.init_dam_break(cfg, capacity_factor=1.05)
    st = SIM.distribute(ps0, sph.physics, cfg, mesh)
    step = SIM.make_sim_step(sph.physics, cfg, mesh)
    worst = torch.zeros((), dtype=torch.int32)
    dts = []
    for i in range(sph_steps):
        euler = torch.tensor(i % cfg.verlet_reset == 0)
        st, flags, scal = step(st, {"euler": euler})
        worst = torch.maximum(worst, flags.any())
        dts.append(_np(scal["dt"]))
    out.update(_ps_arrays("sph_", st.ps))
    out["sph_worst"], out["sph_dt"] = _np(worst), np.stack(dts)
    out["sph_load"] = _np(scal["load"])
    cfg = dem_test_config(dem)
    z = dict(np.load(dem_in))
    from repro_torch import convert
    ps0 = convert.particles_from_numpy(
        z["x"], z["valid"], {k[2:]: z[k] for k in z if k.startswith("p_")},
        device="cpu")
    st = SIM.distribute(ps0, dem.physics, cfg, mesh)
    step = SIM.make_sim_step(dem.physics, cfg, mesh)
    worst = torch.zeros((), dtype=torch.int32)
    for _ in range(dem_steps):
        st, flags, _ = step(st, {})
        worst = torch.maximum(worst, flags.any())
    out.update(_ps_arrays("dem_", st.ps))
    out["dem_worst"] = _np(worst)
    return out


def sph_test_config(sph):
    """benchmarks/dist_common.sph_config() on the CPU, cell_cap 16."""
    return sph.SPHConfig(dp=0.05, box=(1.2, 0.6), fluid=(0.25, 0.25),
                         cell_cap=16, device="cpu")


def dem_test_config(dem):
    """benchmarks/dist_common.dem_config() on the CPU, cell_cap 8 (its
    cells hold ~2 grains; the flags hold it)."""
    return dem.DEMConfig(box=(2.4, 0.6, 1.0), fill=(2.0, 0.66, 0.5),
                         cell_cap=8, device="cpu")


def grid(mesh, rank, world, halo_f, gs_steps, rhs):
    """The grid layer: halo_pad / halo_reduce of this rank's block of
    ``halo_f`` in each (periodic, fill) mode, start/finish against the
    blocking forms, a stencil's overlap schedule against its blocking one,
    gray_scott.run_distributed and the slab FFT solve of ``rhs``."""
    import torch
    from repro_torch.apps import gray_scott as GS
    from repro_torch.core import grid as G
    from repro_torch.core import runtime as RT
    from repro_torch.numerics import poisson as PS
    out = {}
    f = torch.from_numpy(np.load(halo_f))
    nl = f.shape[0] // world
    blk = f[rank * nl:(rank + 1) * nl]
    with RT.on_mesh(mesh):
        for i, (periodic, fill) in enumerate(HALO_MODES):
            out[f"pad{i}"] = G.halo_pad(blk, 2, AXIS, periodic=periodic,
                                        fill=fill)
            fl, fr = G.halo_pad_start(blk, 2, AXIS, periodic=periodic,
                                      fill=fill)
            busy = (blk * 3.0).sum()          # work while the slots fly
            out[f"pad_split{i}"] = G.halo_pad_finish(blk, fl, fr)
            padded = G.halo_pad(blk, 2, AXIS, periodic=periodic, fill=fill)
            out[f"red{i}"] = G.halo_reduce(padded, 2, AXIS,
                                           periodic=periodic)
            fl, fr = G.halo_reduce_start(padded, 2, AXIS, periodic=periodic)
            out[f"red_split{i}"] = G.halo_reduce_finish(padded, 2, fl, fr)
        del busy
        cfg = GS.GSConfig(shape=(8 * world, 8, 8), device="cpu")
        u, v = GS.init_fields(cfg, seed=5)
        ub, vb = (a[rank * 8:(rank + 1) * 8] for a in (u, v))
        for ov in (False, True):
            run = G.apply_stencil_local(GS.gs_step_padded(cfg), 1, AXIS,
                                        overlap=ov)
            out[f"stencil_ov{int(ov)}"] = torch.stack(run(ub, vb))
    ud, vd = GS.run_distributed(cfg, gs_steps, mesh, seed=5)
    out["gs_u"], out["gs_v"] = ud, vd
    r = torch.from_numpy(np.load(rhs))
    rl = r.shape[0] // world
    solve = PS.make_fft_poisson_slab(mesh, AXIS, (2.0, 1.0, 1.5))
    out["poisson"] = solve(r[rank * rl:(rank + 1) * rl])
    return {k: _np(v) for k, v in out.items()}


#: (periodic, fill) of the halo checks
HALO_MODES = ((True, 0.0), (False, 0.0), (False, None), (False, 1.5))


def vic_mesh(mesh, rank, world, w_in, toy_in, toy_steps):
    """One distributed VIC step from ``w_in`` on each interp path, and the
    toy mesh physics riding the mesh step."""
    import torch
    from _torch_bridge import ToyCfg, toy_physics
    from repro_torch.apps import vortex as V
    from repro_torch.core import grid as G
    from repro_torch.core import simulation as SIM
    from repro_torch.core.particles import from_positions
    out = {}
    w = torch.from_numpy(np.load(w_in))
    for interp in ("cells", "scatter"):
        cfg = vic_test_config(V, interp)
        step = V.make_distributed_vic_step(mesh, cfg)
        f, ovf = step(G.distribute_field(w, mesh, AXIS))
        out[f"vic_{interp}"], out[f"vic_{interp}_ovf"] = f.data, ovf
    cfg = ToyCfg()
    x = torch.from_numpy(np.load(toy_in))
    ps0 = SIM.with_ids(from_positions(x))
    st = SIM.distribute(ps0, toy_physics, cfg, mesh,
                        fields={"rho": torch.zeros(cfg.shape)})
    step = SIM.make_sim_step(toy_physics, cfg, mesh)
    worst = torch.zeros((), dtype=torch.int32)
    for _ in range(toy_steps):
        st, flags, _ = step(st, {})
        worst = torch.maximum(worst, flags.any())
    out["toy_rho"], out["toy_worst"] = st.fields["rho"], worst
    return {k: _np(v) for k, v in out.items()}


def vic_test_config(V, interp):
    """A small VIC box whose axes 0 and 1 split over 4 ranks."""
    return V.VortexConfig(shape=(16, 8, 8), lengths=(4.0, 2.0, 2.0),
                          interp=interp, device="cpu")


def overflow(mesh, rank, world, inp):
    """One MD step each with bucket_cap, ghost_cap and cell_cap too small:
    every rank's flags."""
    import torch
    from repro_torch.apps import md
    from repro_torch.core import dlb
    from repro_torch.core import simulation as SIM
    z = dict(np.load(inp))
    cfg = md.MDConfig(n_per_side=8, sigma=0.04, dt=0.0005, cell_cap=8,
                      device="cpu")
    ps0 = md.init_particles(cfg, capacity=cfg.n_particles)
    ps0 = ps0.with_prop("v", torch.from_numpy(z["v"]))
    out = {}
    uniform = dlb.uniform_bounds(world, 0.0, 1.0)
    # every particle starts on rank 0: map() must move 3/4 of them
    skew = torch.tensor([0.0] + [1.0] * world)
    cases = {"bucket": (dict(bucket_cap=8), skew),
             "ghost": (dict(ghost_cap=4), uniform),
             "cell": (dict(), uniform)}
    for name, (kw, start_bounds) in cases.items():
        # cells of ~0.25 hold ~8 lattice particles: cell_cap 1 overflows
        c = dataclasses.replace(cfg, cell_cap=1, sigma=0.085) \
            if name == "cell" else cfg
        st = SIM.distribute(ps0, md.physics, c, mesh, bounds=start_bounds,
                            cap_per_dev=cfg.n_particles)
        st = dataclasses.replace(st, bounds=uniform)
        st, flags, _ = SIM.make_sim_step(md.physics, c, mesh, **kw)(st, {})
        out.update(_flags(f"{name}_", flags))
    return out


# --------------------------------------------------------------------------
# The reuse cadence and DLB on the slab mesh
# --------------------------------------------------------------------------

REUSE_MD_STEPS = 12
#: MD reuse cases: name -> (overlap, skin). At skin 0.06 the ghost band
#: (r_cut 0.18 + skin) fits a 0.25-wide slab, one hop: the split-phase
#: update steps; at the default skin (r_cut / 2) it needs two hops, where
#: the step runs the blocking schedule.
MD_REUSE_CASES = {"ov1": (True, 0.06), "ov0": (False, 0.06),
                  "hop2": (True, None)}
REUSE_SPH_STEPS = 8
REUSE_DEM_STEPS = 20
DLB_BUCKET = 128       # map() buckets of the rebalance check
#: probe runs: name -> (scenario, steps, reuse)
PROBE_RUNS = {"boundary": ("boundary", 6, "skin"),
              "fast_skin": ("fast", 10, "skin"),
              "fast_update": ("fast", 10, "update")}
DLB_STEPS = 10         # sph.run_distributed steps (threshold trigger)
DLB_GAP = 4            # its min_rebalance_gap
SAR_STEPS = 6          # sph.run_distributed steps with SAR on


def md_reuse_config(md):
    """benchmarks/dist_common.md_config(n_per_side=6, sigma=0.06) (either
    package's module ``md``) with cell_cap 16: tests/distributed/
    test_dist_reuse.py's 64 makes the plain pair pass 16x slower on the
    CPU, and the skin grid's cells (>= 0.24, lattice spacing 1/6) hold at
    most 8 particles; the cell flag holds it."""
    return dataclasses.replace(
        md.MDConfig(n_per_side=6, sigma=0.06, dt=0.0005), cell_cap=16,
        **({"device": "cpu"} if "device" in md.MDConfig.__dataclass_fields__
           else {}))


def sph_reuse_config(sph):
    """benchmarks/dist_common.sph_config() on the CPU (cell_cap 64: the
    skin grid's cells are r_cut + skin wide)."""
    return sph.SPHConfig(dp=0.05, box=(1.2, 0.6), fluid=(0.25, 0.25),
                         device="cpu")


def dem_reuse_config(dem):
    """benchmarks/dist_common.dem_config() on the CPU, cell_cap 12 (at
    skin = cfg.skin the reuse cells are 0.16 wide, 3 along the periodic
    y axis)."""
    return dem.DEMConfig(box=(2.4, 0.6, 1.0), fill=(2.0, 0.66, 0.5),
                         cell_cap=12, device="cpu")


def _load_state(path, rank, world):
    from repro_torch import convert
    z = dict(np.load(path))
    props = {k[2:]: z[k] for k in z if k.startswith("p_")}
    return convert.dist_state_from_numpy(z["x"], z["valid"], props,
                                         z["bounds"], rank, world,
                                         device="cpu")


def _steps(step, st, n, extras_at=None):
    """``n`` steps; (state, stale flags, worst error flag)."""
    stales, worst = [], 0
    for i in range(n):
        st, flags, _ = step(st, extras_at(i) if extras_at else {})
        stales.append(int(flags.stale))
        worst = max(worst, int(flags.any()))
    return st, np.asarray(stales, np.int32), np.int32(worst)


def reuse_dlb(mesh, rank, world, dlb_in, md_in, probe_in, dem_in):
    """The reuse cadence and DLB on the slab mesh: ``make_rebalance`` of
    ``dlb_in``; REUSE_MD_STEPS MD steps from ``md_in`` every step and
    under reuse="skin" (overlap on and off); the SPH dam break every step
    and under reuse; the probe runs of PROBE_RUNS from ``probe_in``; DEM
    every step and under reuse from ``dem_in`` (the contact cache per
    step); ``sph.run_distributed`` with a threshold trigger (reuse off and
    on) and with SAR on, each rank's scripted clock advancing its own
    time a step."""
    import time
    from _torch_bridge import ProbeCfg, probe_physics
    from repro_torch.apps import dem, md, sph
    from repro_torch.core import simulation as SIM
    out = {}
    cfg = md_reuse_config(md)
    st, ovf = SIM.make_rebalance(md.physics, cfg, mesh,
                                 bucket_cap=DLB_BUCKET)(
        _load_state(dlb_in, rank, world))
    out.update(_ps_arrays("rb_", st.ps))
    out["rb_bounds"], out["rb_ovf"] = _np(st.bounds), _np(ovf)

    st0 = _load_state(md_in, rank, world)
    st, _, out["md_full_worst"] = _steps(
        SIM.make_sim_step(md.physics, cfg, mesh), st0, REUSE_MD_STEPS)
    out.update(_ps_arrays("md_full_", st.ps))
    for name, (overlap, skin) in MD_REUSE_CASES.items():
        step = SIM.make_sim_step(md.physics, cfg, mesh, reuse="skin",
                                 overlap=overlap, skin=skin)
        rs = SIM.reuse_state(st0, md.physics, cfg, mesh, overlap=overlap,
                             skin=skin)
        rs, out[f"md_{name}_stale"], out[f"md_{name}_worst"] = _steps(
            step, rs, REUSE_MD_STEPS)
        out.update(_ps_arrays(f"md_{name}_", rs.inner.ps))

    scfg = sph_reuse_config(sph)
    st0 = SIM.distribute(sph.init_dam_break(scfg, capacity_factor=1.05),
                         sph.physics, scfg, mesh)
    ex = lambda i: {"euler": i % scfg.verlet_reset == 0}
    st, _, out["sph_full_worst"] = _steps(
        SIM.make_sim_step(sph.physics, scfg, mesh), st0, REUSE_SPH_STEPS, ex)
    out.update(_ps_arrays("sph_full_", st.ps))
    rs = SIM.reuse_state(st0, sph.physics, scfg, mesh)
    rs, out["sph_reuse_stale"], out["sph_reuse_worst"] = _steps(
        SIM.make_sim_step(sph.physics, scfg, mesh, reuse="skin"), rs,
        REUSE_SPH_STEPS, ex)
    out.update(_ps_arrays("sph_reuse_", rs.inner.ps))

    from repro_torch import convert
    z = dict(np.load(probe_in))
    pcfg = ProbeCfg()
    skin = float(z["skin"])
    for name, (scenario, n, reuse) in PROBE_RUNS.items():
        ps0 = convert.particles_from_numpy(
            z[f"{scenario}_x"], z[f"{scenario}_valid"],
            {"u": z[f"{scenario}_u"], "nc": z[f"{scenario}_nc"]},
            device="cpu")
        st0 = SIM.distribute(ps0, probe_physics, pcfg, mesh, cap_per_dev=8)
        step = SIM.make_sim_step(probe_physics, pcfg, mesh, reuse=reuse,
                                 skin=skin)
        rs = SIM.reuse_state(st0, probe_physics, pcfg, mesh, skin=skin)
        stales, nc, ids, worst = [], [], [], 0
        for _ in range(n):
            rs, flags, _ = step(rs, {})
            stales.append(int(flags.stale))
            worst = max(worst, int(flags.any()))
            ps = rs.inner.ps
            nc.append(_np(_valid_or(ps, ps.props["nc"], 0.0)))
            ids.append(_np(_valid_or(ps, ps.props["id"], -1)))
        out[f"probe_{name}_stale"] = np.asarray(stales, np.int32)
        out[f"probe_{name}_nc"], out[f"probe_{name}_id"] = (np.stack(nc),
                                                           np.stack(ids))
        out[f"probe_{name}_worst"] = np.int32(worst)

    dcfg = dem_reuse_config(dem)
    st0 = _load_state(dem_in, rank, world)
    st, _, out["dem_full_worst"] = _steps(
        SIM.make_sim_step(dem.physics, dcfg, mesh), st0, REUSE_DEM_STEPS)
    out.update(_ps_arrays("dem_full_", st.ps))
    step = SIM.make_sim_step(dem.physics, dcfg, mesh, reuse="skin",
                             skin=dcfg.skin)
    rs = SIM.reuse_state(st0, dem.physics, dcfg, mesh, skin=dcfg.skin)
    stales, xb, ok, worst = [], [], [], 0
    for _ in range(REUSE_DEM_STEPS):
        rs, flags, _ = step(rs, {})
        stales.append(int(flags.stale))
        worst = max(worst, int(flags.any()))
        xb.append(_np(rs.cache.phys["ct_xb"]))
        ok.append(bool(rs.cache.phys["ct_ok"]))
    out["dem_reuse_stale"], out["dem_reuse_worst"] = (
        np.asarray(stales, np.int32), np.int32(worst))
    out["dem_reuse_xb"], out["dem_reuse_ok"] = np.stack(xb), np.asarray(ok)
    out.update(_ps_arrays("dem_reuse_", rs.inner.ps))

    for reuse in (None, "skin"):
        ps, t, n_reb, imb = sph.run_distributed(
            scfg, DLB_STEPS, mesh, world, use_sar=False, imb_threshold=0.3,
            min_rebalance_gap=DLB_GAP, reuse=reuse)
        key = f"dlb_{reuse or 'none'}_"
        out.update(_ps_arrays(key, ps))
        out[key + "t"], out[key + "n_reb"] = np.float64(t), np.int32(n_reb)
        out[key + "imb"] = np.asarray(imb)

    # a scripted clock per rank: each step advances it by 0.01·k·(1 +
    # rank) s (k the step's number), so every rank's own wall times differ
    # from every other rank's, grow each step (SAR's imbalance cost rises
    # and it fires) and are the same on every run, whatever the load
    clock = [0.0]
    calls = [0]

    def slow_factory(w):
        inner = SIM.make_sim_step(sph.physics, scfg, mesh, interior_rows=w)

        def step(state, extras):
            calls[0] += 1
            clock[0] += 0.01 * calls[0] * (1 + rank)
            return inner(state, extras)

        return step

    real = time.perf_counter
    time.perf_counter = lambda: clock[0]
    try:
        _, _, n_reb, imb = sph.run_distributed(
            scfg, SAR_STEPS, mesh, world, use_sar=True, imb_threshold=10.0,
            _make_step=slow_factory)
    finally:
        time.perf_counter = real
    out["sar_n_reb"], out["sar_imb"] = np.int32(n_reb), np.asarray(imb)
    return out


def _valid_or(ps, a, fill):
    """``a`` where the particle is valid, ``fill`` elsewhere."""
    import torch
    return torch.where(ps.valid, a, torch.full_like(a, fill))


# --------------------------------------------------------------------------
# repro's side of the 4-rank mapping check (its own process)
# --------------------------------------------------------------------------

def repro_reference(inp: str, md_in: str, out: str) -> None:
    """On 4 of the forced host devices: repro's map(), ghost_get
    (GHOST_CASES) and ghost_put of ``inp``, and MD_REPRO_STEPS MD steps of
    ``md_repro_config`` from ``md_in``; the global arrays go to ``out``."""
    import jax
    import jax.numpy as jnp
    sys.path.insert(0, str(ROOT))
    from benchmarks import dist_common as DC
    from jax.sharding import PartitionSpec as P
    from repro.apps import md
    from repro.core import mappings as M
    from repro.core import runtime as JRT
    from repro.core import simulation as SIM
    from repro.core.particles import ParticleSet
    mesh = DC.make_submesh(4)

    def load(path):
        z = dict(np.load(path))
        props = {k[2:]: jnp.asarray(z[k]) for k in z if k.startswith("p_")}
        ps = DC.shard_over(ParticleSet(x=jnp.asarray(z["x"]), props=props,
                                       valid=jnp.asarray(z["valid"])), mesh)
        return ps, jnp.asarray(z["bounds"])

    ps, bounds = load(inp)
    res = {}
    ps2, ovf = M.make_map_fn(mesh, ps, AXIS, MAP_BUCKET)(ps, bounds)
    res.update({"map_x": ps2.x, "map_valid": ps2.valid, "map_ovf": ovf})
    res.update({f"map_p_{k}": v for k, v in ps2.props.items()})
    for name, (hops, periodic, names, rg) in GHOST_CASES.items():
        g, o = M.make_ghost_get_fn(mesh, ps2, AXIS, GHOST_CAP, rg,
                                   periodic=periodic, box_len=1.0,
                                   prop_names=names, n_hops=hops)(ps2,
                                                                  bounds)
        res.update({f"{name}_x": g.x, f"{name}_valid": g.valid,
                    f"{name}_src": g.src_slot, f"{name}_ovf": o})
        res.update({f"{name}_p_{k}": v for k, v in g.props.items()})
    hops, periodic, names, rg = GHOST_CASES["h1_per_all"]
    spec = M.ps_specs(ps2, AXIS)
    for op in ("sum", "max"):
        def put(p, b, op=op):
            g, _ = M.ghost_get_local(p, b, rg, AXIS, GHOST_CAP,
                                     periodic=periodic, box_len=1.0,
                                     prop_names=names, n_hops=hops)
            contrib = {"c": g.x[..., 0] * 2.0 + 1.0,
                       "n": (g.x[..., 1] * 100).astype(jnp.int32)}
            return M.ghost_put_local(contrib, g, p, AXIS, op=op)
        fn = jax.jit(JRT.shard_map(put, mesh, in_specs=(spec, P()),
                                   out_specs=P(AXIS), check_vma=False))
        res.update({f"put_{op}_{k}": v for k, v in fn(ps2, bounds).items()})
    cfg = md_repro_config(md)
    ps, bounds = load(md_in)
    state = SIM.DistributedParticles(ps=ps, bounds=bounds)
    step = SIM.make_sim_step(md.physics, cfg, mesh, axis_name=AXIS)
    worst = 0
    for _ in range(MD_REPRO_STEPS):
        state, flags, _ = step(state, {})
        worst = max(worst, int(flags.any()))
    res.update({"md_x": state.ps.x, "md_valid": state.ps.valid,
                "md_worst": np.int32(worst)})
    res.update({f"md_p_{k}": v for k, v in state.ps.props.items()})
    np.savez(out, **{k: np.asarray(v) for k, v in res.items()})


def repro_reuse_reference(dlb_in: str, md_in: str, out: str) -> None:
    """On 4 of the forced host devices: repro's ``make_rebalance`` of
    ``dlb_in`` (md_reuse_config's physics, bucket_cap DLB_BUCKET) and
    REUSE_MD_STEPS reuse="skin" MD steps (MD_REUSE_CASES' "ov1") from
    ``md_in``; the global arrays go to ``out``."""
    import jax.numpy as jnp
    sys.path.insert(0, str(ROOT))
    from benchmarks import dist_common as DC
    from repro.apps import md
    from repro.core import simulation as SIM
    from repro.core.particles import ParticleSet
    mesh = DC.make_submesh(4)

    def load(path):
        z = dict(np.load(path))
        props = {k[2:]: jnp.asarray(z[k]) for k in z if k.startswith("p_")}
        ps = DC.shard_over(ParticleSet(x=jnp.asarray(z["x"]), props=props,
                                       valid=jnp.asarray(z["valid"])), mesh)
        return SIM.DistributedParticles(ps=ps, bounds=jnp.asarray(
            z["bounds"]))

    cfg = md_reuse_config(md)
    st, ovf = SIM.make_rebalance(md.physics, cfg, mesh, axis_name=AXIS,
                                 bucket_cap=DLB_BUCKET)(load(dlb_in))
    res = {"rb_x": st.ps.x, "rb_valid": st.ps.valid, "rb_ovf": ovf,
           "rb_bounds": st.bounds}
    res.update({f"rb_p_{k}": v for k, v in st.ps.props.items()})
    overlap, skin = MD_REUSE_CASES["ov1"]
    step = SIM.make_sim_step(md.physics, cfg, mesh, axis_name=AXIS,
                             reuse="skin", overlap=overlap, skin=skin)
    rs = SIM.reuse_state(load(md_in), md.physics, cfg, mesh,
                         axis_name=AXIS, overlap=overlap, skin=skin)
    stales = []
    for _ in range(REUSE_MD_STEPS):
        rs, flags, _ = step(rs, {})
        assert int(flags.any()) == 0
        stales.append(int(flags.stale))
    res.update({"md_x": rs.inner.ps.x, "md_valid": rs.inner.ps.valid,
                "md_id": rs.inner.ps.props["id"],
                "md_stale": np.asarray(stales, np.int32)})
    np.savez(out, **{k: np.asarray(v) for k, v in res.items()})


# --------------------------------------------------------------------------
# The sharded fleet, server and PS-CMA-ES on a ("fleet",) mesh
# --------------------------------------------------------------------------

FLEET = "fleet"
FLEET_B = 8            # members of the sharded fleet (2 a rank on 4)
FLEET_STEPS = 3
#: the meshed server: slots, and (seed, steps) of each request
SRV_SLOTS = 8
SRV_REQS = [(seed, 2 + seed % 3) for seed in range(12)]
#: ps_cma_es_torch(rastrigin_t, CMA_DIM, CMA_POP, CMA_EVALS, seed=CMA_SEED)
CMA_DIM, CMA_POP, CMA_EVALS, CMA_SEED = 10, 8, 16000, 3


def fleet_md_member(md, SIM, cfg, seed: int):
    """A serial MD member: the lattice with 0.05·N(0, 1) numpy velocities
    (tests/test_torch_fleet.py's ``_md_state``)."""
    import torch
    ps = md.init_particles(cfg)
    v = np.random.default_rng(seed).normal(size=tuple(ps.x.shape))
    v = torch.from_numpy((0.05 * v).astype(np.float32)).to(ps.x.device)
    ps = ps.with_prop("v", torch.where(ps.valid[:, None], v, 0.0))
    return SIM.serial_state(ps, md.physics, cfg)


def fleet(mesh, rank, world, pop_in, out_dir):
    """The sharded fleet on a ("fleet",) mesh: FLEET_B members stepped
    FLEET_STEPS times by the meshed step (this rank's block) and by the
    port's serial loop in this process; the meshed server draining
    SRV_REQS through SRV_SLOTS slots beside independent serial runs; the
    sharded PS-CMA-ES beside the serial run; ``migrate`` of this rank's
    block of ``pop_in``; and the ValueErrors of batches that do not
    divide."""
    import torch
    from repro_torch.apps import cmaes, md
    from repro_torch.core import runtime as RT
    from repro_torch.core import simulation as SIM
    from repro_torch.fleet import FleetServer, SimRequest
    from repro_torch.fleet import batch as FB
    fmesh = RT.make_mesh((world,), (FLEET,), device_type="cpu")
    cfg = md.MDConfig(n_per_side=3, device="cpu")
    out = {}
    states = [fleet_md_member(md, SIM, cfg, s) for s in range(FLEET_B)]
    ens = FB.shard_ensemble(FB.stack_members(states), fmesh)
    step = FB.make_fleet_step(md.physics, cfg, fmesh)
    serial = SIM.make_sim_step(md.physics, cfg)
    for _ in range(FLEET_STEPS):
        ens, flags, _ = step(ens, {})
        states = [serial(s, {})[0] for s in states]
    out["fleet_x"], out["fleet_v"] = (_np(ens.member.ps.x),
                                      _np(ens.member.ps.props["v"]))
    out["fleet_cell"] = _np(flags.cell)
    out["serial_x"] = np.stack([_np(s.ps.x) for s in states])
    out["serial_v"] = np.stack([_np(s.ps.props["v"]) for s in states])
    out["fleet_cache"] = np.int32(step.cache_size())
    try:
        FB.shard_ensemble(FB.stack_members(states[:6]), fmesh)
        out["shard_raises"] = np.bool_(False)
    except ValueError as e:
        out["shard_raises"] = np.bool_(FLEET in str(e))
    # 3 members on rank 0, 1 on the others: a block size no rank has
    # stepped, so every rank's first call of it checks the blocks
    uneven = FB.stack_members(states[:1 + 2 * (rank == 0)])
    try:
        FB.make_fleet_step(md.physics, cfg, fmesh)(uneven, {})
        out["step_raises"] = np.bool_(False)
    except ValueError as e:
        out["step_raises"] = np.bool_("divisible" in str(e))

    srv = FleetServer(md.physics, cfg, n_slots=SRV_SLOTS,
                      template=fleet_md_member(md, SIM, cfg, 0), mesh=fmesh,
                      out_dir=out_dir)
    for rid, (seed, n) in enumerate(SRV_REQS):
        srv.submit(SimRequest(rid=rid,
                              state=fleet_md_member(md, SIM, cfg, seed),
                              n_steps=n))
    with srv:
        results = {r.rid: r for r in srv.run()}
    out["srv_cache"] = np.int32(srv.step_cache_size())
    out["srv_rids"] = np.asarray(sorted(results), np.int32)
    out["srv_x"] = np.stack([_np(results[r].state.ps.x)
                             for r in sorted(results)])
    out["srv_flags"] = np.asarray([max(results[r].flags_max.values())
                                   for r in sorted(results)], np.int32)
    ref = []
    for seed, n in SRV_REQS:
        st = fleet_md_member(md, SIM, cfg, seed)
        for _ in range(n):
            st = serial(st, {})[0]
        ref.append(_np(st.ps.x))
    out["srv_ref_x"] = np.stack(ref)
    out["srv_completed"] = np.int32(
        srv.metrics.snapshot()["counters"]["sims_completed"])

    args = (cmaes.rastrigin_t, CMA_DIM, CMA_POP, CMA_EVALS)
    bf, bx, ev = cmaes.ps_cma_es_torch(*args, seed=CMA_SEED, device="cpu",
                                       mesh=fmesh)
    bf_s, bx_s, _ = cmaes.ps_cma_es_torch(*args, seed=CMA_SEED,
                                          device="cpu")
    out.update(cma_bf=np.float32(bf), cma_bx=bx, cma_evals=np.int64(ev),
               cma_bf_serial=np.float32(bf_s), cma_bx_serial=bx_s)
    try:
        cmaes.ps_cma_es_torch(*args[:2], 6, 60, device="cpu", mesh=fmesh)
        out["cma_raises"] = np.bool_(False)
    except ValueError as e:
        out["cma_raises"] = np.bool_("divisible" in str(e))

    z = dict(np.load(pop_in))
    bl = z["mean"].shape[0] // world
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    i32 = lambda a: torch.from_numpy(np.asarray(a, np.int32))
    blk = {k: v[rank * bl:(rank + 1) * bl] for k, v in z.items()}
    pop = cmaes.CMAStateT(
        mean=f32(blk["mean"]), sigma=f32(blk["sigma"]), C=f32(blk["C"]),
        p_sigma=f32(blk["p_sigma"]), p_c=f32(blk["p_c"]),
        best_f=f32(blk["best_f"]), best_x=f32(blk["best_x"]),
        evals=i32(blk["evals"]), gen=i32(blk["gen"]))
    with RT.on_mesh(fmesh):
        mig = cmaes.migrate(pop, SIM.Reduce(FLEET))
    out.update({f"mig_{k}": _np(getattr(mig, k))
                for k in ("mean", "sigma", "C", "p_sigma", "p_c")})
    return out


def repro_fleet_reference(pop_in: str, out: str) -> None:
    """On 4 of the forced host devices: repro's ``migrate`` of ``pop_in``
    (a stacked population, sharded one block a device, under
    ``shard_map``); the migrated population goes to ``out``."""
    import jax
    import jax.numpy as jnp
    sys.path.insert(0, str(ROOT))
    from benchmarks import dist_common as DC
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.apps import cmaes
    from repro.core import runtime as JRT
    from repro.core import simulation as SIM
    mesh = DC.make_submesh(4)
    z = dict(np.load(pop_in))
    pop = cmaes.CMAStateJ(**{k: jnp.asarray(v) for k, v in z.items()})
    sh = NamedSharding(mesh, P(DC.AXIS))
    pop = jax.device_put(pop, jax.tree.map(lambda _: sh, pop))
    fn = jax.jit(JRT.shard_map(
        lambda p: cmaes.migrate(p, SIM.Reduce(DC.AXIS)), mesh,
        in_specs=(P(DC.AXIS),), out_specs=P(DC.AXIS), check_vma=False))
    mig = fn(pop)
    np.savez(out, **{k: np.asarray(getattr(mig, k))
                     for k in ("mean", "sigma", "C", "p_sigma", "p_c")})


# --------------------------------------------------------------------------
# The pencil forms on 2-D (rows, cols) meshes
# --------------------------------------------------------------------------

PENCIL = ("rows", "cols")
PEN_STEPS = 5          # MD pencil steps (tests/distributed/test_dist_pencil)
PEN_REB_AT = 2         # the rebalance after this step, in a 6-step run
PEN_REUSE_STEPS = 3
PEN_BUCKET = 128       # map() buckets of the rebalance check
VIC_PEN_STEPS = 3
POISSON_LENGTHS = (8.0, 4.0, 4.0)
#: the Poisson meshes: name -> shape of the 2-D mesh
POISSON_MESHES = {"11": (1, 1), "41": (4, 1), "14": (1, 4), "22": (2, 2)}
HALO2 = 2              # halo_pad2 / halo_reduce2 width of the grid check


def md_pencil_config(md):
    """benchmarks/dist_common.md_config(n_per_side=8, sigma=0.04) with
    cell_cap 8 (its ~0.12-wide cells hold about one lattice particle)
    (either package's module ``md``)."""
    return dataclasses.replace(
        md.MDConfig(n_per_side=8, sigma=0.04, dt=0.0005), cell_cap=8,
        **({"device": "cpu"} if "device" in md.MDConfig.__dataclass_fields__
           else {}))


def vic_pencil_config(V):
    """tests/distributed/test_dist_pencil.py's VIC box (the port's
    interp="scatter" on the CPU is repro's jnp path) (either package's
    module ``vortex``)."""
    return V.VortexConfig(
        shape=(32, 16, 16), lengths=POISSON_LENGTHS, dt=0.02,
        **({"interp": "scatter", "device": "cpu"}
           if "device" in V.VortexConfig.__dataclass_fields__ else {}))


def lap7(p, xp):
    """The periodic 7-point sum -6 p + the ± neighbours on axes 0-2 of a
    padded block, in one order for both packages (``xp`` is torch or
    jax.numpy)."""
    out = -6.0 * p
    for d in range(3):
        out = out + xp.roll(p, 1, d) + xp.roll(p, -1, d)
    return out


def _ps_from_npz(path):
    from repro_torch import convert
    z = dict(np.load(path))
    return convert.particles_from_numpy(
        z["x"], z["valid"], {k[2:]: z[k] for k in z if k.startswith("p_")},
        device="cpu")


def pencil(mesh, rank, world, md_in, rb_in, rhs_in):
    """The pencil forms on 4 ranks: the MD pencil step on a 2×2 mesh
    (PEN_STEPS steps from ``md_in``; a PEN_REUSE_STEPS-step run under the
    reuse fallback; a run with a rebalance after step PEN_REB_AT), the
    MD step on a (4, 1) tuple mesh beside the "shards" slab step, the
    2-D ``make_rebalance`` of ``rb_in``, the pencil Poisson solve of
    ``rhs_in`` on each of POISSON_MESHES (and the slab solve), the pencil
    VIC step on the 2×2 mesh and ``vortex.run_distributed`` on (4, 1)
    beside the slab run."""
    import torch
    from repro_torch.apps import md, vortex as V
    from repro_torch.core import grid as G
    from repro_torch.core import runtime as RT
    from repro_torch.core import simulation as SIM
    from repro_torch.numerics import poisson as PS
    meshes = {name: RT.make_mesh(shape, PENCIL, device_type="cpu")
              for name, shape in POISSON_MESHES.items() if name != "11"}
    # a 1 × 1 mesh of this rank alone: the last two axes of (4, 1, 1)
    meshes["11"] = RT.make_mesh((world, 1, 1), ("rep",) + PENCIL,
                                device_type="cpu")[PENCIL]
    m22, m41 = meshes["22"], meshes["41"]
    out = {}
    cfg = md_pencil_config(md)
    ps0 = _ps_from_npz(md_in)
    st0 = SIM.distribute(ps0, md.physics, cfg, m22, axis_name=PENCIL,
                         cap_per_dev=256)
    out["pen_col_bounds"] = _np(st0.col_bounds)
    step = SIM.make_sim_step(md.physics, cfg, m22, axis_name=PENCIL)
    st, worst = st0, 0
    for i in range(PEN_STEPS):
        st, flags, _ = step(st, {})
        worst = max(worst, int(flags.any()))
        if i + 1 == PEN_REUSE_STEPS:
            out.update(_ps_arrays("pen3_", st.ps))
    out.update(_ps_arrays("pen_", st.ps))
    out["pen_worst"] = np.int32(worst)

    rstep = SIM.make_sim_step(md.physics, cfg, m22, axis_name=PENCIL,
                              reuse="skin")
    rs = SIM.reuse_state(st0, md.physics, cfg, m22, axis_name=PENCIL)
    rs, out["reu_stale"], out["reu_worst"] = _steps(rstep, rs,
                                                    PEN_REUSE_STEPS)
    out.update(_ps_arrays("reu_", rs.inner.ps))

    rebalance = SIM.make_rebalance(md.physics, cfg, m22, axis_name=PENCIL)
    st, worst = st0, 0
    for i in range(PEN_STEPS + 1):
        st, flags, _ = step(st, {})
        worst = max(worst, int(flags.any()))
        if i == PEN_REB_AT:
            st, ovf = rebalance(st)
            worst = max(worst, int(ovf))
    out.update(_ps_arrays("reb_", st.ps))
    out["reb_worst"] = np.int32(worst)
    out["reb_bounds"], out["reb_col_bounds"] = (_np(st.bounds),
                                                _np(st.col_bounds))

    for name, (m, axis_name) in {"t41": (m41, PENCIL),
                                 "slab": (mesh, AXIS)}.items():
        st = SIM.distribute(ps0, md.physics, cfg, m, axis_name=axis_name,
                            cap_per_dev=160)
        step1 = SIM.make_sim_step(md.physics, cfg, m, axis_name=axis_name)
        for _ in range(PEN_STEPS):
            st, flags, _ = step1(st, {})
        out.update(_ps_arrays(f"{name}_", st.ps))
        out[f"{name}_has_cols"] = np.bool_(st.col_bounds is not None)

    st = SIM.distribute(_ps_from_npz(rb_in), md.physics, cfg, m22,
                        axis_name=PENCIL, cap_per_dev=200)
    st, ovf = SIM.make_rebalance(md.physics, cfg, m22, axis_name=PENCIL,
                                 bucket_cap=PEN_BUCKET)(st)
    out.update(_ps_arrays("rb_", st.ps))
    out["rb_bounds"], out["rb_col_bounds"] = (_np(st.bounds),
                                              _np(st.col_bounds))
    out["rb_ovf"] = _np(ovf)

    rhs = torch.from_numpy(np.load(rhs_in))
    for name, m in meshes.items():
        f = G.distribute_field2(rhs, m, *PENCIL)
        solve = PS.make_fft_poisson_pencil(m, PENCIL, POISSON_LENGTHS)
        u = dataclasses.replace(f, data=solve(f.data))
        out[f"poisson_{name}"] = _np(G.gather_field2(u, m, *PENCIL))
    with RT.on_mesh(meshes["11"]):
        # the generic two-transpose plan on one rank (1 × 1 short-cuts
        # to the serial solver above)
        out["poisson_11_plan"] = _np(PS.fft_poisson_pencil_local(
            rhs, POISSON_LENGTHS, *PENCIL))
    # the pencil grid layer on 2×2: the container's bounds, halo_pad2 of
    # this rank's block, halo_reduce2 of the padded block and a halo-1
    # stencil through apply_stencil_local2
    f = G.distribute_field2(rhs, m22, *PENCIL)
    out["f2_bounds"], out["f2_col_bounds"] = (_np(f.node_bounds),
                                              _np(f.col_bounds))
    with RT.on_mesh(m22):
        pad = G.halo_pad2(f.data, HALO2, *PENCIL)
        out["h2_pad"] = _np(pad)
        out["h2_red"] = _np(G.halo_reduce2(pad, HALO2, *PENCIL))
        (lap,) = G.apply_stencil_local2(lambda p: lap7(p, torch), 1,
                                        *PENCIL)(f.data)
        out["h2_lap"] = _np(lap)
    nl = rhs.shape[0] // world
    slab = PS.make_fft_poisson_slab(mesh, AXIS, POISSON_LENGTHS)(
        rhs[rank * nl:(rank + 1) * nl])
    out["poisson_slab"] = _np(RT.all_gather(slab, AXIS, tiled=True))

    vcfg = vic_pencil_config(V)
    vstep = V.make_distributed_vic_step(m22, vcfg, axis_name=PENCIL)
    f = G.distribute_field2(V.project_divfree(V.init_ring(vcfg), vcfg),
                            m22, *PENCIL)
    out["vic_block"] = np.asarray(f.data.shape[:2], np.int32)
    ovf = torch.zeros((), dtype=torch.int32)
    for _ in range(VIC_PEN_STEPS):
        f, o = vstep(f)
        ovf = ovf + o
    out["vic_pen"], out["vic_pen_ovf"] = (_np(G.gather_field2(f, m22,
                                                              *PENCIL)),
                                          _np(ovf))
    out["vic_t41"] = _np(V.run_distributed(vcfg, 2, m41, PENCIL)[0])
    out["vic_slab"] = _np(V.run_distributed(vcfg, 2, mesh, AXIS)[0])
    return out


def repro_pencil_reference(md_in: str, rb_in: str, rhs_in: str,
                           out: str) -> None:
    """On 4 of the forced host devices as a 2×2 mesh: repro's MD pencil
    step (PEN_STEPS steps of ``md_pencil_config`` from ``md_in``), its
    2-D ``make_rebalance`` of ``rb_in``, the pencil grid layer on
    ``rhs_in`` (as ``pencil`` runs it), its pencil Poisson solve of
    ``rhs_in`` on each of POISSON_MESHES and VIC_PEN_STEPS steps of its
    pencil VIC step on ``vic_pencil_config``; the global arrays go to
    ``out``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    sys.path.insert(0, str(ROOT))
    from repro.apps import md
    from repro.apps import vortex as V
    from repro.core import grid as G
    from repro.core import runtime as JRT
    from repro.core import simulation as SIM
    from repro.core.particles import ParticleSet
    from repro.numerics import poisson as PS
    mesh = JRT.make_mesh((2, 2), PENCIL, devices=jax.devices()[:4])

    def load(path):
        z = dict(np.load(path))
        return ParticleSet(
            x=jnp.asarray(z["x"]), valid=jnp.asarray(z["valid"]),
            props={k[2:]: jnp.asarray(z[k]) for k in z
                   if k.startswith("p_")})

    cfg = md_pencil_config(md)
    st = SIM.distribute(load(md_in), md.physics, cfg, mesh,
                        axis_name=PENCIL, cap_per_dev=256)
    step = SIM.make_sim_step(md.physics, cfg, mesh, axis_name=PENCIL)
    for _ in range(PEN_STEPS):
        st, flags, _ = step(st, {})
        assert int(flags.any()) == 0
    res = {"pen_x": st.ps.x, "pen_valid": st.ps.valid,
           "pen_id": st.ps.props["id"]}
    st = SIM.distribute(load(rb_in), md.physics, cfg, mesh,
                        axis_name=PENCIL, cap_per_dev=200)
    st, ovf = SIM.make_rebalance(md.physics, cfg, mesh, axis_name=PENCIL,
                                 bucket_cap=PEN_BUCKET)(st)
    res.update({"rb_x": st.ps.x, "rb_valid": st.ps.valid,
                "rb_id": st.ps.props["id"], "rb_ovf": ovf,
                "rb_bounds": st.bounds, "rb_col_bounds": st.col_bounds})

    rhs = jnp.asarray(np.load(rhs_in))
    f = G.distribute_field2(rhs, mesh, *PENCIL)
    res["f2_bounds"], res["f2_col_bounds"] = f.node_bounds, f.col_bounds

    def grid_local(a):
        pad = G.halo_pad2(a, HALO2, *PENCIL)
        (lap,) = G.apply_stencil_local2(lambda p: lap7(p, jnp), 1,
                                        *PENCIL)(a)
        return pad, G.halo_reduce2(pad, HALO2, *PENCIL), lap

    spec = P(*PENCIL)
    res["h2_pad"], res["h2_red"], res["h2_lap"] = jax.jit(JRT.shard_map(
        grid_local, mesh, in_specs=(spec,), out_specs=(spec,) * 3,
        check_vma=False))(f.data)
    for name, shape in POISSON_MESHES.items():
        m = JRT.make_mesh(shape, PENCIL,
                          devices=jax.devices()[:shape[0] * shape[1]])
        solve = PS.make_fft_poisson_pencil(m, PENCIL, POISSON_LENGTHS)
        res[f"poisson_{name}"] = solve(
            G.distribute_field2(rhs, m, *PENCIL).data)

    vcfg = vic_pencil_config(V)
    step = V.make_distributed_vic_step(mesh, vcfg, PENCIL)
    f = G.distribute_field2(V.project_divfree(V.init_ring(vcfg), vcfg),
                            mesh, *PENCIL)
    ovf = 0
    for _ in range(VIC_PEN_STEPS):
        f, o = step(f)
        ovf += int(o)
    res["vic_pen"], res["vic_pen_ovf"] = f.data, ovf
    np.savez(out, **{k: np.asarray(v) for k, v in res.items()})


# --------------------------------------------------------------------------
# Collective accounting (launch/comm_analysis.py against repro's HLO)
# --------------------------------------------------------------------------

COMM_MD_CAP = 750       # slots per rank of the MD slab step (1000 particles)
COMM_REUSE_CAP = 160    # slots per rank of the MD reuse step (216)
COMM_RHS = (32, 16, 16)
MOE_ARCH = "qwen2-moe-a2.7b"
MOE_TOKENS = (2, 12)    # (B, S) of the moe_map_local input
MOE_TP = 4


def _reports_json(cp, a2a, cb):
    """The numbers of the three reports that the comm test compares."""
    return {
        "cp_total": float(cp["total_wire_bytes"]),
        "cp_uncond": float(cp["unconditional_wire_bytes"]),
        "cp_cond": float(cp["conditional_wire_bytes"]),
        "cp_n": int(cp["n_collective_permute"]),
        "a2a_total": float(a2a["total_wire_bytes"]),
        "a2a_max": float(a2a["max_wire_bytes"]),
        "a2a_n": int(a2a["n_all_to_all"]),
        "a2a_groups": sorted({int(o["group_size"]) for o in a2a["ops"]}),
        "bytes": {k: float(cb[k]) for k in cb if not k.startswith("_")},
        "counts": {k: int(v) for k, v in cb["_counts"].items()},
    }


def moe_test_config(cfg, capacity_factor=None):
    """MOE_ARCH's REDUCED config (either package's), capacity factor
    ``capacity_factor`` when given."""
    if capacity_factor is None:
        return cfg
    return dataclasses.replace(cfg, capacity_factor=float(capacity_factor))


def moe_inputs(seed: int = 3, n_tokens: int = MOE_TOKENS[0] * MOE_TOKENS[1]):
    """numpy ``(x2d (n_tokens, D), {router, wi, wg, wo})`` of MOE_ARCH's
    REDUCED width (d_model 64, 8 experts of 64) from a fixed seed."""
    rng = np.random.default_rng(seed)
    T, D, E, F = n_tokens, 64, 8, 64
    f = lambda *s, sc: (sc * rng.standard_normal(s)).astype(np.float32)
    w = {"router": f(D, E, sc=0.3), "wi": f(E, D, F, sc=D ** -0.5),
         "wg": f(E, D, F, sc=D ** -0.5), "wo": f(E, F, D, sc=F ** -0.5)}
    return f(T, D, sc=1.0), w


def comm(mesh, rank, world, moe_in):
    """The ledgers (``launch/comm_analysis``) of repro_comm_reference's
    cases on 4 ranks: one MD slab step blocking and one with overlap,
    the MD reuse step's cold (full) step and its next (update) step, the
    slab and 2×2 pencil Poisson solves and ``moe_map_local`` at tp
    MOE_TP on ``moe_in``. Returns each case's report numbers as JSON
    bytes (``json``) and the overlap reports' in-flight counts."""
    import torch
    from repro_torch.apps import md
    from repro_torch.configs import registry as TR
    from repro_torch.core import runtime as RT
    from repro_torch.core import simulation as SIM
    from repro_torch.launch import comm_analysis as CA
    from repro_torch.models import moe as TMOE
    from repro_torch.numerics import poisson as PS

    def reports(led):
        return _reports_json(CA.collective_permute_report(led),
                             CA.all_to_all_report(led),
                             CA.collective_bytes(led))

    def md_start(cfg, cap):
        ps0 = md.init_particles(cfg, capacity=cfg.n_particles)
        v = np.random.default_rng(0).standard_normal(
            (cfg.n_particles, 3)).astype(np.float32)
        ps0 = ps0.with_prop("v", torch.from_numpy(0.3 * v))
        return SIM.distribute(ps0, md.physics, cfg, mesh, cap_per_dev=cap)

    res, out = {}, {}
    cfg = md_repro_config(md)
    for overlap in (False, True):
        st = md_start(cfg, COMM_MD_CAP)
        step = SIM.make_sim_step(md.physics, cfg, mesh, overlap=overlap)
        with CA.ledger() as led:
            st, flags, _ = step(st, {})
        assert int(flags.any()) == 0
        ov = CA.overlap_report(led)
        name = "md_overlap" if overlap else "md"
        res[name] = reports(led)
        out[f"{name}_pairs_in_flight"] = np.int32(
            ov["pair_passes_in_flight"])
        out[f"{name}_n_independent"] = np.int32(len(ov["independent"]))
        out[f"{name}_n_dependent"] = np.int32(len(ov["dependent"]))
    rcfg = md_reuse_config(md)
    overlap, skin = MD_REUSE_CASES["ov1"]
    rs = SIM.reuse_state(md_start(rcfg, COMM_REUSE_CAP), md.physics, rcfg,
                         mesh, overlap=overlap, skin=skin)
    step = SIM.make_sim_step(md.physics, rcfg, mesh, reuse="skin",
                             overlap=overlap, skin=skin)
    for name in ("reuse_full", "reuse_update"):
        with CA.ledger() as led:
            rs, flags, _ = step(rs, {})
        out[f"{name}_stale"] = np.int32(int(flags.stale))
        res[name] = reports(led)
    rhs = np.random.default_rng(0).standard_normal(COMM_RHS).astype(
        np.float32)
    n0 = COMM_RHS[0] // world
    solve = PS.make_fft_poisson_slab(mesh, AXIS, POISSON_LENGTHS)
    with CA.ledger() as led:
        solve(torch.from_numpy(rhs[rank * n0:(rank + 1) * n0]))
    res["poisson_slab"] = reports(led)
    m22 = RT.make_mesh((2, 2), PENCIL, device_type="cpu")
    i, j = divmod(rank, 2)
    blk = rhs[i * COMM_RHS[0] // 2:(i + 1) * COMM_RHS[0] // 2,
              j * COMM_RHS[1] // 2:(j + 1) * COMM_RHS[1] // 2]
    solve = PS.make_fft_poisson_pencil(m22, PENCIL, POISSON_LENGTHS)
    with CA.ledger() as led:
        solve(torch.from_numpy(np.ascontiguousarray(blk)))
    res["poisson_pencil"] = reports(led)
    mm = RT.make_mesh((MOE_TP,), ("model",), device_type="cpu")
    mcfg = TR.get_config(MOE_ARCH, reduced=True)
    z = dict(np.load(moe_in))
    el = z["wi"].shape[0] // MOE_TP
    w = {k: torch.from_numpy(z[k] if k == "router"
                             else z[k][rank * el:(rank + 1) * el])
         for k in ("router", "wi", "wg", "wo")}
    with CA.ledger() as led, RT.on_mesh(mm):
        TMOE.moe_map_local(torch.from_numpy(z["x"]), w, cfg=mcfg,
                           axis_name="model")
    res["moe"] = reports(led)
    out["json"] = np.frombuffer(json.dumps(res).encode(), np.uint8)
    return out


#: moe_map_local's capacity factors on 4 ranks: no drops (the dense
#: oracle's result) and one that drops (MOE_DROP_TOKENS tokens, 8-slot
#: sub-buckets for 8 assignments each on average)
MOE_CAPACITIES = {"cap8": 8.0, "drop": 1.0}
MOE_DROP_TOKENS = 128
MAMBA_ARCH = "mamba2-780m"
MAMBA_SHAPE = (2, 64)    # (B, S): 4 shards of 16, two 8-chunks each
SEQ = "seq"


def moe_mamba(mesh, rank, world, moe_in, mamba_in):
    """``moe_map_local`` at tp MOE_TP for each of MOE_CAPACITIES on
    ``moe_in`` (this rank's experts of the whole ``wi``, ``wg``, ``wo``),
    and ``mamba_prefill_seq_sharded`` of ``mamba_in``'s layer on this
    rank's shard of its sequence."""
    import torch
    from repro_torch.configs import registry as TR
    from repro_torch.core import runtime as RT
    from repro_torch.models import mamba as TM
    from repro_torch.models import moe as TMOE
    out = {}
    mm = RT.make_mesh((MOE_TP,), ("model",), device_type="cpu")
    z = dict(np.load(moe_in))
    el = z["wi"].shape[0] // MOE_TP
    w = {k: torch.from_numpy(z[k] if k == "router"
                             else z[k][rank * el:(rank + 1) * el])
         for k in ("router", "wi", "wg", "wo")}
    base = TR.get_config(MOE_ARCH, reduced=True)
    with RT.on_mesh(mm):
        for name, cf in MOE_CAPACITIES.items():
            o, aux, dropped = TMOE.moe_map_local(
                torch.from_numpy(z["x"]), w,
                cfg=moe_test_config(base, cf), axis_name="model")
            out.update({f"{name}_out": _np(o), f"{name}_aux": _np(aux),
                        f"{name}_dropped": _np(dropped)})
    sm = RT.make_mesh((world,), (SEQ,), device_type="cpu")
    z = dict(np.load(mamba_in))
    p = {k[2:]: torch.from_numpy(v) for k, v in z.items()
         if k.startswith("p_")}
    n = z["x"].shape[1] // world
    x = torch.from_numpy(np.ascontiguousarray(
        z["x"][:, rank * n:(rank + 1) * n]))
    with RT.on_mesh(sm):
        y, h = TM.mamba_prefill_seq_sharded(
            p, x, cfg=TR.get_config(MAMBA_ARCH, reduced=True), axis_name=SEQ)
    out.update({"mamba_y": _np(y), "mamba_h": _np(h)})
    return out


def repro_moe_mamba_reference(moe_in: str, mamba_in: str, out: str) -> None:
    """On 4 of the forced host devices: repro's ``moe_map_local`` at tp
    MOE_TP for each of MOE_CAPACITIES on ``moe_in``, and its
    ``mamba_prefill_seq_sharded`` over a 4-device "seq" axis on
    ``mamba_in`` (``mamba_error`` holds the message if it does not run)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.configs import registry as JR
    from repro.core import runtime as JRT
    from repro.models import mamba as JM
    from repro.models import moe as JMOE
    res = {}
    mm = JRT.make_mesh((MOE_TP,), ("model",), devices=jax.devices()[:4])
    z = dict(np.load(moe_in))
    base = JR.get_config(MOE_ARCH, reduced=True)
    wspec = {"router": P(), "wi": P("model"), "wg": P("model"),
             "wo": P("model")}
    w = {k: jnp.asarray(z[k]) for k in wspec}
    for name, cf in MOE_CAPACITIES.items():
        cfg = moe_test_config(base, cf)
        fn = jax.jit(JRT.shard_map(
            lambda x2d, wl, cfg=cfg: JMOE.moe_map_local(
                x2d, wl, cfg=cfg, axis_name="model"),
            mm, in_specs=(P(), wspec), out_specs=(P(), P(), P()),
            check_vma=False))
        o, aux, dropped = fn(jnp.asarray(z["x"]), w)
        res.update({f"{name}_out": o, f"{name}_aux": aux,
                    f"{name}_dropped": dropped})
    z = dict(np.load(mamba_in))
    p = {k[2:]: jnp.asarray(v) for k, v in z.items() if k.startswith("p_")}
    cfg = JR.get_config(MAMBA_ARCH, reduced=True)
    try:
        sm = JRT.make_mesh((4,), (SEQ,), devices=jax.devices()[:4])
        fn = jax.jit(JRT.shard_map(
            lambda xs: tuple(a if i == 0 else a[None] for i, a in enumerate(
                JM.mamba_prefill_seq_sharded(p, xs, cfg=cfg,
                                             axis_name=SEQ))),
            sm, in_specs=(P(None, SEQ),), out_specs=(P(None, SEQ), P(SEQ)),
            check_vma=False))
        y, h = fn(jnp.asarray(z["x"]))
        res.update({"mamba_y": y, "mamba_h": h})
    except Exception as e:          # recorded: the test reports it
        res["mamba_error"] = np.frombuffer(
            f"{type(e).__name__}: {e}"[:2000].encode(), np.uint8)
    np.savez(out, **{k: np.asarray(v) for k, v in res.items()})


def repro_comm_reference(out: str) -> None:
    """On 4 of the forced host devices: repro's HLO reports
    (``launch/hlo_analysis``, ``launch/dryrun.collective_bytes``) of the
    compiled MD slab step (blocking), both branches of the MD reuse slab
    step (MD_REUSE_CASES' "ov1"), the slab and 2×2 pencil Poisson solves
    and ``moe_map_local`` at tp MOE_TP; JSON to ``out``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    sys.path.insert(0, str(ROOT))
    from benchmarks import dist_common as DC
    from repro.apps import md
    from repro.configs import registry as JR
    from repro.core import runtime as JRT
    from repro.core import simulation as SIM
    from repro.launch import dryrun as DR
    from repro.launch import hlo_analysis as HA
    from repro.models import moe as JMOE
    from repro.numerics import poisson as PS

    def reports(text):
        return _reports_json(HA.collective_permute_report(text),
                             HA.all_to_all_report(text),
                             DR.collective_bytes(text))

    res = {}
    mesh = DC.make_submesh(4)
    cfg = md_repro_config(md)
    st = DC.md_distributed_start(mesh, cfg, 4, cap_per_dev=COMM_MD_CAP)
    step = SIM.make_sim_step(md.physics, cfg, mesh, axis_name=AXIS,
                             overlap=False)
    res["md"] = reports(step.lower(st, {}).compile().as_text())
    rcfg = md_reuse_config(md)
    overlap, skin = MD_REUSE_CASES["ov1"]
    st = DC.md_distributed_start(mesh, rcfg, 4, cap_per_dev=COMM_REUSE_CAP)
    rs = SIM.reuse_state(st, md.physics, rcfg, mesh, axis_name=AXIS,
                         overlap=overlap, skin=skin)
    step = SIM.make_sim_step(md.physics, rcfg, mesh, axis_name=AXIS,
                             reuse="skin", overlap=overlap, skin=skin)
    res["reuse"] = reports(step.lower(rs, {}).compile().as_text())
    rhs = jnp.zeros(COMM_RHS, jnp.float32)
    solve = PS.make_fft_poisson_slab(mesh, AXIS, POISSON_LENGTHS)
    res["poisson_slab"] = reports(solve.lower(rhs).compile().as_text())
    m22 = JRT.make_mesh((2, 2), PENCIL, devices=jax.devices()[:4])
    solve = PS.make_fft_poisson_pencil(m22, PENCIL, POISSON_LENGTHS)
    res["poisson_pencil"] = reports(solve.lower(rhs).compile().as_text())
    mm = JRT.make_mesh((MOE_TP,), ("model",), devices=jax.devices()[:4])
    mcfg = JR.get_config(MOE_ARCH, reduced=True)
    x, w = moe_inputs()
    wspec = {"router": P(), "wi": P("model"), "wg": P("model"),
             "wo": P("model")}
    fn = jax.jit(JRT.shard_map(
        lambda x2d, wl: JMOE.moe_map_local(x2d, wl, cfg=mcfg,
                                           axis_name="model"),
        mm, in_specs=(P(), wspec), out_specs=(P(), P(), P()),
        check_vma=False))
    res["moe"] = reports(fn.lower(jnp.asarray(x), {
        k: jnp.asarray(v) for k, v in w.items()}).compile().as_text())
    pathlib.Path(out).write_text(json.dumps(res, indent=1))


# --- the sharded LM stack (tests/test_torch_dist_lm.py) -------------------
LM_ARCHS = ("llama3.2-3b", "gemma-2b", "qwen2-moe-a2.7b", "mamba2-780m",
            "jamba-1.5-large-398b", "whisper-medium", "llama-3.2-vision-11b")
LM_MESHES = ((1, 4), (2, 2))
#: batch, prompt, cache rows, new tokens: gemma's 16 rows are 4 a rank at
#: tp 4, and 6 + 8 tokens cross the shard boundaries at rows 8 and 12
LM_B, LM_S, LM_SMAX, LM_NEW = 4, 6, 16, 8
LM_TRAIN = ("llama3.2-3b", "qwen2-moe-a2.7b")
LM_TRAIN_MESH = (2, 2)
LM_TRAIN_S = 8
LM_SEQ_MESH = (1, 4)     # the sequence-parallel attention's mesh
LM_AXES = ("data", "model")


def lm_case(arch: str):
    """``(cfg, params, prompt, stubs, train_batch)`` of ``arch``'s REDUCED
    model, all torch on the CPU from seeded generators: the parameters,
    an ``(LM_B, LM_S)`` prompt, seeded 0.1·N(0, 1) stub embeddings (zeros
    would make every cross-attention zero) and a training batch of
    ``LM_TRAIN_S`` tokens and their targets."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.models import transformer as T
    cfg = registry.get_config(arch, reduced=True)
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    g = torch.Generator().manual_seed(1)
    prompt = torch.randint(0, cfg.vocab, (LM_B, LM_S), generator=g)
    stubs = {}
    if cfg.kind == "encdec":
        stubs["enc_embed"] = 0.1 * torch.randn(
            (LM_B, cfg.enc_seq, cfg.d_model), generator=g)
    if cfg.kind == "vlm":
        stubs["img_embed"] = 0.1 * torch.randn(
            (LM_B, cfg.n_img_tokens, cfg.vision_dim), generator=g)
    toks = torch.randint(0, cfg.vocab, (LM_B, LM_TRAIN_S + 1), generator=g)
    train = dict(stubs, tokens=toks[:, :-1], targets=toks[:, 1:])
    return cfg, params, prompt, stubs, train


def lm_ctx(cfg, mesh, mode: str, seq_len: int, *, fsdp: bool = False):
    """A ShardingContext with the dry-run's rules for a ``mode`` cell of
    ``LM_B`` rows and ``seq_len`` positions on ``mesh``."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun as DR
    from repro_torch.sharding import specs as SP
    shape = ShapeConfig(mode, seq_len, LM_B, mode)
    return SP.ShardingContext.create(
        mesh, DR.effective_rules(cfg, mesh, shape), fsdp=fsdp)


def lm_serve_run(cfg, params, prompt, stubs, ctx=None):
    """The serve path of one model, sharded (``ctx``: this rank's blocks
    in, the whole results out) or not: the one-shot forward's logits
    ``fwd`` (B, S, V), the prefill's last logits ``pre``, the greedy
    tokens ``tok`` of prefill + LM_NEW - 1 decode steps from the seeded
    stubs with each step's logits ``dec`` (steps, B, V), and
    ``greedy_generate``'s tokens ``gen`` (zero stubs, as ``repro``)."""
    import torch
    from repro_torch.core import runtime as RT
    from repro_torch.models import transformer as T
    from repro_torch.sharding import specs as SP
    from repro_torch.training import serve as S
    rows = slice(None)
    lp = params
    if ctx is not None:
        with ctx.active():
            rows = SP.local_slices((LM_B,), (ctx.axis("batch"),),
                                   ctx.mesh)[0]
        lp = SP.shard_tree(params, T.params_logical(cfg), ctx,
                           T.param_specs(cfg, ctx)[0])

    def whole(logits):
        if ctx is None:
            return logits
        with ctx.active():
            return SP.gather_block(logits, T.logits_spec(cfg, ctx))

    def whole_rows(t):
        if ctx is None or ctx.axis("batch") is None:
            return t
        with ctx.active():
            return RT.all_gather(t, SP.flat_axes(ctx.axis("batch")), axis=0,
                                 tiled=True)

    batch = {k: v[rows] for k, v in dict(stubs, tokens=prompt).items()}
    with torch.no_grad():
        hidden, _, _ = T.forward(lp, batch, cfg, ctx, backend="torch")
        out = {"fwd": whole(T.logits_from_hidden(lp, hidden, cfg, ctx))}
        logits, caches = S.make_prefill_step(cfg, LM_SMAX, ctx)(lp, batch)
        out["pre"] = whole(logits)[:, -1]
        decode = S.make_decode_step(cfg, ctx)
        tok = S.greedy_pick(logits[:, -1], cfg, ctx)
        toks, decs = [tok], []
        pos = torch.full((tok.shape[0],), LM_S, dtype=torch.int64)
        for _ in range(LM_NEW - 1):
            logits, caches = decode(lp, caches, {"tokens": tok[:, None],
                                                 "position": pos})
            decs.append(whole(logits)[:, -1])
            tok = S.greedy_pick(logits[:, -1], cfg, ctx)
            toks.append(tok)
            pos = pos + 1
        out["tok"] = whole_rows(torch.stack(toks, 1))
        out["dec"] = torch.stack(decs)
        out["gen"] = whole_rows(S.greedy_generate(
            cfg, lp, prompt[rows], LM_NEW, LM_SMAX, ctx))
    return {k: v.numpy() for k, v in out.items()}


LM_OPT = dict(lr=1e-3, warmup_steps=0)


def lm_train_run(cfg, params, batch, ctx=None, grads=None):
    """One training step, sharded or not: the gradients ``g/<path>`` and
    the parameters after one AdamW step ``p/<path>`` (whole), the loss
    and the gradient norm. With ``grads`` (whole, the same on every
    rank): the parameters after the clip and one AdamW update from those
    gradients, ``u/<path>``, and their norm ``u_norm``: the update alone,
    free of the gradients' last-bit differences (Adam's first step
    divides a gradient by its own magnitude)."""
    import torch
    from repro_torch import tree as TREE
    from repro_torch.models import transformer as T
    from repro_torch.sharding import specs as SP
    from repro_torch.training import optimizer as O
    from repro_torch.training import train as TR
    lp, rows, specs = params, slice(None), None
    if ctx is not None:
        specs = T.param_specs(cfg, ctx)[0]
        with ctx.active():
            rows = SP.local_slices((LM_B,), (ctx.axis("batch"),),
                                   ctx.mesh)[0]
        lp = SP.shard_tree(params, T.params_logical(cfg), ctx, specs)
    batch = {k: v[rows] for k, v in batch.items()}

    def whole(tree):
        if ctx is None:
            return tree
        with ctx.active():
            return SP.tree_map2(lambda sp, x: SP.gather_block(x, sp),
                                specs, tree, is_leaf=SP.is_spec)

    (loss, _), got = TR.make_grad_fn(cfg, ctx)(lp, batch)
    out = {f"g{k}": v for k, v in TREE.flatten_with_path(whole(got))[0]}
    opt = O.OptConfig(**LM_OPT)
    p1 = TREE.tree_map(torch.clone, lp)
    p1, _, m = TR.make_train_step(cfg, opt, ctx)(p1, O.init_opt_state(p1,
                                                                     opt),
                                                 batch)
    out.update({f"p{k}": v for k, v in
                TREE.flatten_with_path(whole(p1))[0]})
    out.update(loss=loss, grad_norm=m["grad_norm"], step_loss=m["loss"])
    if grads is not None:
        g = grads if ctx is None else SP.shard_tree(
            grads, T.params_logical(cfg), ctx, specs)
        p2 = TREE.tree_map(torch.clone, lp)
        g, norm = O.clip_by_global_norm(TREE.tree_map(torch.clone, g),
                                        opt.clip_norm, specs=specs, ctx=ctx)
        O.adamw_update(p2, g, O.init_opt_state(p2, opt), opt)
        out.update({f"u{k}": v for k, v in
                    TREE.flatten_with_path(whole(p2))[0]})
        out["u_norm"] = norm
    return {k: v.detach().numpy() for k, v in out.items()}


def lm_shard(mesh, rank, world, archs, meshes):
    """The serve path of every arch of ``archs`` on each mesh shape of
    ``meshes`` (dry-run rules of a prefill cell and of a decode cell of
    LM_SMAX rows), and one training step of LM_TRAIN on LM_TRAIN_MESH
    with FSDP weights; keys ``serve/<arch>/<mesh>/<mode>/<name>``,
    ``train/<arch>/<name>``, and ``moe/<mesh>/<mode>/{calls,dropped}``
    (the ``moe_map_local`` calls of qwen2-moe's serve run)."""
    from repro_torch.core import runtime as RT
    from repro_torch.models import moe as TMOE
    calls = []
    real = TMOE.moe_map_local

    def spy(*a, **k):
        out = real(*a, **k)
        calls.append(int(out[2]))
        return out

    TMOE.moe_map_local = spy
    out = {}
    for shape in meshes:
        m = RT.make_mesh(tuple(shape), LM_AXES, device_type="cpu")
        tag = "x".join(map(str, shape))
        for arch in archs:
            cfg, params, prompt, stubs, _ = lm_case(arch)
            for mode, seq in (("prefill", LM_S), ("decode", LM_SMAX)):
                calls.clear()
                got = lm_serve_run(cfg, params, prompt, stubs,
                                   lm_ctx(cfg, m, mode, seq))
                out.update({f"serve/{arch}/{tag}/{mode}/{k}": v
                            for k, v in got.items()})
                if cfg.kind == "moe":
                    out[f"moe/{tag}/{mode}/calls"] = np.int64(len(calls))
                    out[f"moe/{tag}/{mode}/dropped"] = np.int64(sum(calls))
    m = RT.make_mesh(LM_TRAIN_MESH, LM_AXES, device_type="cpu")
    for arch in LM_TRAIN:
        cfg, params, _, _, batch = lm_case(arch)
        from repro_torch.training import train as TR
        _, grads = TR.make_grad_fn(cfg)(params, batch)
        got = lm_train_run(cfg, params, batch,
                           lm_ctx(cfg, m, "train", LM_TRAIN_S, fsdp=True),
                           grads)
        out.update({f"train/{arch}/{k}": v for k, v in got.items()})
    # repro's sequence-parallel schedule: attention's queries over "model"
    cfg, params, _, _, batch = lm_case(LM_TRAIN[0])
    qcfg = dataclasses.replace(cfg, attn_q_parallel=True, attn_block_q=4)
    m = RT.make_mesh(LM_SEQ_MESH, LM_AXES, device_type="cpu")
    # the heads stay whole, as where repro sets the rule (heads % tp)
    rules = dict(lm_ctx(qcfg, m, "train", LM_TRAIN_S).rules_dict,
                 attn_seq="model", heads=None, kv_heads=None)
    from repro_torch.sharding import specs as SP
    got = lm_train_run(qcfg, params, batch, SP.ShardingContext.create(
        m, rules))
    out.update({f"qpar/{k}": v for k, v in got.items()})
    out.update(qpar_prefill_b5(qcfg, params, batch["tokens"],
                               SP.ShardingContext.create(m, rules)))
    TMOE.moe_map_local = real
    return out


def qpar_prefill_b5(cfg, params, tokens, ctx):
    """The sequence-parallel schedule's prefill on the card's route, shown
    on the CPU: the layer's backend forced to "cuda" and B5's wrapper
    (its plain version on these CPU tensors) spied on. Keys ``qpar/pre``
    (the whole last logits) and ``qpar/b5`` (one ``(causal, q_offset,
    rows)`` row per B5 call on this rank)."""
    import numpy as np
    import torch
    from repro_torch.kernels.flash_attention import ops as FOPS
    from repro_torch.models import layers as TL
    from repro_torch.models import transformer as T
    from repro_torch.sharding import specs as SP
    from repro_torch.training import serve as S
    calls, real_mha, real_backend = [], FOPS.mha, TL.resolve_backend

    def mha_spy(q, k, v, *, causal=True, q_offset=0):
        calls.append((int(causal), int(q_offset), q.shape[1]))
        return real_mha(q, k, v, causal=causal, q_offset=q_offset)

    FOPS.mha = mha_spy
    TL.resolve_backend = lambda backend, x: ("cuda" if backend == "auto"
                                             else real_backend(backend, x))
    try:
        with ctx.active():
            rows = SP.local_slices((LM_B,), (ctx.axis("batch"),),
                                   ctx.mesh)[0]
        lp = SP.shard_tree(params, T.params_logical(cfg), ctx,
                           T.param_specs(cfg, ctx)[0])
        with torch.no_grad():
            logits, _ = S.make_prefill_step(cfg, LM_SMAX, ctx)(
                lp, {"tokens": tokens[rows]})
        with ctx.active():
            pre = SP.gather_block(logits, T.logits_spec(cfg, ctx))
    finally:
        FOPS.mha, TL.resolve_backend = real_mha, real_backend
    return {"qpar/pre": pre.numpy(),
            "qpar/b5": np.array(calls, np.int64).reshape(-1, 3)}


def repro_lm_reference(out: str) -> None:
    """repro's one-shot forward logits (B, S, V) of the dense and moe
    archs of LM_TRAIN under a ShardingContext on 4 of the forced host
    devices, for each of LM_MESHES (the prefill rules of the port's
    dry-run, which are repro's), on the port's parameters as numpy."""
    import jax
    import jax.numpy as jnp
    from repro.configs import registry as JR
    from repro.core import runtime as JRT
    from repro.models import transformer as JT
    from repro.sharding import specs as JSP
    from repro_torch.core import runtime as RT
    from repro_torch.launch import dryrun as DR
    from repro_torch.configs.base import ShapeConfig

    def np_tree(t):
        if isinstance(t, dict):
            return {k: np_tree(v) for k, v in t.items()}
        return jnp.asarray(t.numpy())

    res = {}
    for arch in LM_TRAIN:
        _, params, prompt, _, _ = lm_case(arch)
        cfg = JR.get_config(arch, reduced=True)
        jp = np_tree(params)
        for shape in LM_MESHES:
            mesh = JRT.make_mesh(shape, LM_AXES, devices=jax.devices()[:4])
            rules = DR.effective_rules(
                cfg, RT.make_dry_mesh(shape, LM_AXES),
                ShapeConfig("prefill", LM_S, LM_B, "prefill"))
            ctx = JSP.ShardingContext.create(mesh, rules)

            def fwd(p, toks, ctx=ctx, cfg=cfg):
                h, _, _ = JT.forward(p, {"tokens": toks}, cfg, ctx)
                return JT.logits_from_hidden(p, h, cfg, ctx)

            tag = "x".join(map(str, shape))
            res[f"{arch}/{tag}"] = np.asarray(jax.jit(fwd)(
                jp, jnp.asarray(prompt.numpy().astype(np.int32))))
    np.savez(out, **res)


def repro_spec_dump(out: str) -> None:
    """repro's layout of every ``registry.cells()`` cell on both
    production meshes, as ``launch/dryrun.build_cell`` makes it (its
    rules, its FSDP choice): each parameter's and (prefill, decode) each
    cache leaf's PartitionSpec, shape and itemsize, and the inputs'
    shapes and itemsizes; JSON to ``out``. Importing repro's dryrun
    forces 512 host devices: run only in a process of its own."""
    from repro.launch import dryrun as DR
    import jax
    from repro.configs import registry
    from repro.configs.base import SHAPES, input_specs
    from repro.launch.mesh import make_production_mesh
    from repro.models import transformer as JT

    def spec(sh):
        return [None if e is None else (e if isinstance(e, str) else list(e))
                for e in tuple(sh.spec)]

    def leaves(shard_tree, shape_tree):
        out = {}
        for path, sh in jax.tree_util.tree_leaves_with_path(shard_tree):
            sds = shape_tree
            for k in path:
                sds = sds[k.key]
            out[jax.tree_util.keystr(path)] = {
                "spec": spec(sh), "shape": list(sds.shape),
                "itemsize": int(sds.dtype.itemsize)}
        return out

    res = {}
    p_shapes = {}
    for kind in ("single", "multi"):
        mesh = make_production_mesh(multi_pod=(kind == "multi"))
        tp = dict(zip(mesh.axis_names, mesh.devices.shape)).get("model", 1)
        for arch, shape_name in registry.cells():
            cfg = registry.get_config(arch)
            shape = SHAPES[shape_name]
            rules = DR.effective_rules(cfg, mesh, shape)
            if arch not in p_shapes:
                p_shapes[arch] = jax.eval_shape(
                    lambda: JT.init_params(cfg, jax.random.PRNGKey(0)))
            ps = p_shapes[arch]
            pbytes = sum(int(np.prod(x.shape)) * x.dtype.itemsize
                         for x in jax.tree.leaves(ps))
            fsdp = not (shape.mode == "decode" and pbytes / tp <= 4 * 2 ** 30)
            rec = {"fsdp": fsdp, "rules": {k: v if not isinstance(v, tuple)
                                           else list(v)
                                           for k, v in rules.items()},
                   "params": leaves(DR.param_shardings(cfg, mesh, rules, ps,
                                                       fsdp=fsdp), ps),
                   "inputs": {k: {"shape": list(v.shape),
                                  "itemsize": int(v.dtype.itemsize)}
                              for k, v in input_specs(cfg, shape).items()}}
            if shape.mode != "train":
                cs = jax.eval_shape(lambda: JT.init_caches(
                    cfg, shape.global_batch, shape.seq_len))
                rec["caches"] = leaves(DR.cache_shardings(cfg, mesh, rules,
                                                          cs), cs)
            res[f"{kind}/{arch}/{shape_name}"] = rec
    pathlib.Path(out).write_text(json.dumps(res))


def exchange_cost(step, st, n: int, what: str):
    """``n`` steps of ``step`` under the collective ledger
    (``launch/comm_analysis``) and torch.profiler, on every rank: each
    rank prints the bytes it issues a step by kind (the ring model), the
    bytes it sent to other ranks a step, and the NCCL kernels' device ms
    a step with the compute inside them. Returns the state."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import comm_analysis as CA
    rank = torch.distributed.get_rank()
    torch.cuda.synchronize()
    torch.distributed.barrier()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with CA.ledger() as led:
            for _ in range(n):
                st, flags, _ = step(st, {})
        torch.cuda.synchronize()
    assert int(flags.any()) == 0, flags
    per = CA.per_step(led, n)
    tr = CA.trace_overlap(prof)
    print(f"rank {rank}, {what}: bytes a step "
          + ", ".join(f"{k} {per[k]:.0f}" for k, n in per["_counts"].items()
                      if n)
          + f"; sent to other ranks {per['peer']:.0f} B/step; NCCL kernels "
          f"{tr['nccl_kernels'] / n:.0f} a step, {tr['nccl_ms'] / n:.4f} "
          f"ms/step, compute inside them {tr['compute_in_nccl_ms'] / n:.4f} "
          f"ms/step of {tr['compute_ms'] / n:.4f}; collective ranges on the "
          f"device {tr['collective_ms'] / n:.4f} ms/step (torch.profiler)",
          flush=True)
    return st


def nccl_md(n_steps: int = 10) -> None:
    """The MD slab step over NCCL on every rank of the process group (one
    card per rank: world 1 in this process, or torchrun's ranks), against
    the serial step on the same card, for both schedules: x and v by id
    within 1e-4 (the gathered state), zero flags, B1 launched twice a
    step with overlap and once without. Then, across several cards, rank
    0 prints the slab step's ms/step at the 216,000-particle MD size.
    Raises on a mismatch."""
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import convert
    from repro_torch.apps import md
    from repro_torch.core import runtime as RT
    from repro_torch.core import simulation as SIM
    from repro_torch.kernels.cell_pair import cell_pair as CP
    world = RT.device_count()
    mesh = RT.make_mesh((world,), (AXIS,), device_type="cuda")
    rank = torch.distributed.get_rank()

    def start(cfg, seed):
        rng = np.random.default_rng(seed)
        v = (0.3 * rng.standard_normal((cfg.n_particles, 3))).astype(
            np.float32)
        ps = md.init_particles(cfg, capacity=cfg.n_particles)
        return SIM.with_ids(ps.with_prop("v", torch.from_numpy(v).cuda()))

    cfg = md.MDConfig(n_per_side=16, sigma=0.03, dt=0.0005, cell_cap=16,
                      device="cuda")
    ps0 = start(cfg, 0)
    ref = ps0
    for _ in range(n_steps):
        ref, ovf = md.md_step(ref, cfg)
        assert int(ovf) == 0
    for overlap in (True, False):
        st = SIM.distribute(ps0, md.physics, cfg, mesh)
        step = SIM.make_sim_step(md.physics, cfg, mesh, overlap=overlap)
        CP.LAUNCHES = 0
        for _ in range(n_steps):
            st, flags, _ = step(st, {})
            assert int(flags.any()) == 0, flags
        assert CP.LAUNCHES == n_steps * (2 if overlap else 1), CP.LAUNCHES
        g = convert.gather_dist_state(st, mesh, AXIS).ps
        val = g.valid
        assert int(val.sum()) == cfg.n_particles
        ids = g.props["id"][val].long()
        for a, b in ((g.x, ref.x), (g.props["v"], ref.props["v"])):
            err = float((a[val] - b[ids]).abs().max())
            assert err <= 1e-4, (overlap, err)
    if world > 1:
        big = md.MDConfig(n_per_side=60, sigma=0.085 / 6, dt=0.0005 / 6,
                          cell_cap=48, device="cuda")
        ps0 = start(big, 1)
        ghost_cap = int(1.5 * big.n_particles * big.r_cut / big.box) + 64
        for overlap in (True, False):
            st = SIM.distribute(ps0, md.physics, big, mesh,
                                cap_per_dev=int(1.3 * big.n_particles
                                                / world))
            step = SIM.make_sim_step(md.physics, big, mesh, overlap=overlap,
                                     ghost_cap=ghost_cap)
            for _ in range(3):
                st, flags, _ = step(st, {})
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            torch.distributed.barrier()
            t0.record()
            for _ in range(20):
                st, flags, _ = step(st, {})
            t1.record()
            torch.cuda.synchronize()
            assert int(flags.any()) == 0, flags
            if rank == 0:
                print(f"{world} cards, MD slab step at {big.n_particles} "
                      f"particles, overlap={overlap}: "
                      f"{t0.elapsed_time(t1) / 20:.4f} ms/step "
                      f"(rank 0, CUDA events)", flush=True)
            st = exchange_cost(step, st, 5, f"{world} cards, MD slab step "
                               f"at {big.n_particles}, overlap={overlap}")
    torch.distributed.destroy_process_group()


def nccl_reuse(n_steps: int = 12) -> None:
    """The reuse cadence and DLB over NCCL on every rank of the process
    group (one card per rank): the MD reuse slab step (overlap on and
    off) against the serial step on the same card, x and v by id within
    1e-4 (the gathered state), zero flags, the cold step full and some
    update step; ``make_rebalance`` of the dam break's start moving the
    bounds off uniform; ``sph.run_distributed`` with the threshold
    trigger (reuse off and on) rebalancing, within 1e-4 of the serial
    steps by id. Raises on a mismatch."""
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import convert
    from repro_torch.apps import md, sph
    from repro_torch.core import dlb
    from repro_torch.core import runtime as RT
    from repro_torch.core import simulation as SIM
    world = RT.device_count()
    mesh = RT.make_mesh((world,), (AXIS,), device_type="cuda")
    rank = torch.distributed.get_rank()

    def check_by_id(block, ref, keys, what):
        g = convert.gather_dist_state(SIM.DistributedParticles(
            ps=block, bounds=ref.x.new_zeros(2)), mesh, AXIS).ps
        val = g.valid
        assert int(val.sum()) == int(ref.valid.sum()), what
        ids = g.props["id"][val].long()
        by_id = {}
        for k in keys:
            b = ref.x if k == "x" else ref.props[k]
            full = torch.zeros_like(b)
            full[ref.props["id"][ref.valid].long()] = b[ref.valid]
            by_id[k] = full
        for k in keys:
            a = g.x if k == "x" else g.props[k]
            err = float((a[val] - by_id[k][ids]).abs().max())
            assert err <= 1e-4, (what, k, err)

    cfg = md.MDConfig(n_per_side=16, sigma=0.03, dt=0.0005, cell_cap=32,
                      device="cuda")
    rng = np.random.default_rng(0)
    v = (0.3 * rng.standard_normal((cfg.n_particles, 3))).astype(np.float32)
    ps0 = SIM.with_ids(md.init_particles(cfg, capacity=cfg.n_particles)
                       .with_prop("v", torch.from_numpy(v).cuda()))
    ref = ps0
    for _ in range(n_steps):
        ref, ovf = md.md_step(ref, cfg)
        assert int(ovf) == 0
    for overlap in (True, False):
        st = SIM.distribute(ps0, md.physics, cfg, mesh)
        step = SIM.make_sim_step(md.physics, cfg, mesh, reuse="skin",
                                 overlap=overlap)
        rs = SIM.reuse_state(st, md.physics, cfg, mesh, overlap=overlap)
        stale = []
        for _ in range(n_steps):
            rs, flags, _ = step(rs, {})
            assert int(flags.any()) == 0, flags
            stale.append(int(flags.stale))
        assert stale[0] == 1 and 0 in stale, stale
        check_by_id(rs.inner.ps, ref, ("x", "v"), f"MD reuse {overlap}")
        if rank == 0:
            print(f"{world} cards, MD reuse slab step overlap={overlap}: "
                  f"stale {stale}, within 1e-4 of md_step", flush=True)

    scfg = sph.SPHConfig(dp=0.05, box=(1.2, 0.6), fluid=(0.25, 0.25),
                         device="cuda")
    ps0 = SIM.with_ids(sph.init_dam_break(scfg, capacity_factor=1.05))
    st = SIM.distribute(ps0, sph.physics, scfg, mesh)
    st2, ovf = SIM.make_rebalance(sph.physics, scfg, mesh)(st)
    uniform = dlb.uniform_bounds(world, 0.0, scfg.box[0], device="cuda")
    assert int(ovf) == 0 and (world == 1 or not torch.allclose(
        st2.bounds, uniform)), st2.bounds
    sref = SIM.serial_state(ps0, sph.physics, scfg)
    serial = SIM.make_sim_step(sph.physics, scfg)
    for i in range(10):
        sref, flags, _ = serial(sref, {"euler": i % scfg.verlet_reset == 0})
        assert int(flags.any()) == 0
    for reuse in (None, "skin"):
        ps, t, n_reb, imb = sph.run_distributed(
            scfg, 10, mesh, world, use_sar=False, imb_threshold=0.3,
            min_rebalance_gap=4, reuse=reuse)
        assert world == 1 or (n_reb >= 1 and imb[-1] < imb[0]), (n_reb, imb)
        check_by_id(ps, sref.ps, ("x", "v"), f"SPH DLB reuse={reuse}")
        if rank == 0:
            print(f"{world} cards, sph.run_distributed reuse={reuse}: "
                  f"{n_reb} rebalances, imbalance {imb[0]:.3f} -> "
                  f"{imb[-1]:.3f}, bounds after make_rebalance "
                  f"{[round(b, 4) for b in st2.bounds.tolist()]}; within "
                  "1e-4 of the serial steps", flush=True)
    torch.distributed.destroy_process_group()


def nccl_fleet_pencil() -> None:
    """The sharded fleet, PS-CMA-ES and the pencil forms over NCCL on
    every rank of the process group (one card per rank; the pencil needs
    4 ranks, as a 2×2 mesh): 2 MD members a rank stepped by the meshed
    fleet step against their serial runs on the same card (within 1e-6;
    whether bit for bit is printed); ps_cma_es_torch with the population
    sharded against the serial run (the best equal); on 4 ranks the MD
    pencil step (x by id within 1e-4 of ``md_step``; its ms/step at
    216,000 particles printed) and the pencil VIC step (within 1e-4 of
    ``vic_step`` relative to the max). Raises on a mismatch."""
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.apps import cmaes, md, vortex as V
    from repro_torch.core import grid as G
    from repro_torch.core import runtime as RT
    from repro_torch.core import simulation as SIM
    from repro_torch.fleet import batch as FB
    world = RT.device_count()
    fmesh = RT.make_mesh((world,), (FLEET,), device_type="cuda")
    rank = torch.distributed.get_rank()
    say = (lambda *a: print(*a, flush=True)) if rank == 0 else (
        lambda *a: None)

    cfg = md.MDConfig(n_per_side=16, sigma=0.03, dt=0.0005, cell_cap=16,
                      device="cuda")
    states = [fleet_md_member(md, SIM, cfg, s) for s in range(2 * world)]
    ens = FB.shard_ensemble(FB.stack_members(states), fmesh)
    step = FB.make_fleet_step(md.physics, cfg, fmesh)
    serial = SIM.make_sim_step(md.physics, cfg)
    mine = states[2 * rank:2 * rank + 2]
    for _ in range(5):
        ens, flags, _ = step(ens, {})
        mine = [serial(s, {})[0] for s in mine]
    assert int(flags.cell.max()) == 0
    ref = torch.stack([s.ps.x for s in mine])
    err = float((ens.member.ps.x - ref).abs().max())
    assert err <= 1e-6, err
    say(f"{world} cards, sharded fleet of {2 * world} MD members: "
        f"{'bit-equal to' if err == 0 else f'within {err:.3e} of'} their "
        "serial runs")
    args = (cmaes.rastrigin_t, 10, 4 * world, 16000)
    bf, _, _ = cmaes.ps_cma_es_torch(*args, seed=3, device="cuda",
                                     mesh=fmesh)
    bf_s, _, _ = cmaes.ps_cma_es_torch(*args, seed=3, device="cuda")
    say(f"{world} cards, sharded PS-CMA-ES (10-D, {4 * world} instances): "
        f"best {bf!r}, serial {bf_s!r}")
    assert bf == bf_s, (bf, bf_s)
    if world != 4:
        torch.distributed.destroy_process_group()
        return

    m22 = RT.make_mesh((2, 2), PENCIL, device_type="cuda")
    rng = np.random.default_rng(0)
    v = (0.3 * rng.standard_normal((cfg.n_particles, 3))).astype(np.float32)
    ps0 = SIM.with_ids(md.init_particles(cfg, capacity=cfg.n_particles)
                       .with_prop("v", torch.from_numpy(v).cuda()))
    ref = ps0
    for _ in range(10):
        ref, ovf = md.md_step(ref, cfg)
        assert int(ovf) == 0
    st = SIM.distribute(ps0, md.physics, cfg, m22, axis_name=PENCIL)
    step = SIM.make_sim_step(md.physics, cfg, m22, axis_name=PENCIL)
    for _ in range(10):
        st, flags, _ = step(st, {})
        assert int(flags.any()) == 0, flags
    with RT.on_mesh(m22):
        gx, val, gid = (RT.all_gather(a, PENCIL, tiled=True) for a in
                        (st.ps.x, st.ps.valid, st.ps.props["id"]))
    assert int(val.sum()) == cfg.n_particles
    err = float((gx[val] - ref.x[gid[val].long()]).abs().max())
    assert err <= 1e-4, err
    say(f"4 cards, MD pencil step (2×2): x within {err:.3e} of md_step")

    big = md.MDConfig(n_per_side=60, sigma=0.085 / 6, dt=0.0005 / 6,
                      cell_cap=48, device="cuda")
    v = (0.3 * rng.standard_normal((big.n_particles, 3))).astype(np.float32)
    ps0 = SIM.with_ids(md.init_particles(big, capacity=big.n_particles)
                       .with_prop("v", torch.from_numpy(v).cuda()))
    ghost_cap = int(1.8 * big.n_particles * big.r_cut / big.box) + 64
    st = SIM.distribute(ps0, md.physics, big, m22, axis_name=PENCIL,
                        cap_per_dev=int(1.3 * big.n_particles / 4))
    step = SIM.make_sim_step(md.physics, big, m22, axis_name=PENCIL,
                             ghost_cap=ghost_cap)
    for _ in range(3):
        st, flags, _ = step(st, {})
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.distributed.barrier()
    t0.record()
    for _ in range(20):
        st, flags, _ = step(st, {})
    t1.record()
    torch.cuda.synchronize()
    assert int(flags.any()) == 0, flags
    say(f"4 cards, MD pencil step (2×2) at {big.n_particles} particles: "
        f"{t0.elapsed_time(t1) / 20:.4f} ms/step (rank 0, CUDA events)")
    st = exchange_cost(step, st, 5, f"4 cards, MD pencil step (2×2) at "
                       f"{big.n_particles}")

    vcfg = V.VortexConfig(shape=(64, 32, 32), lengths=(8.0, 4.0, 4.0),
                          dt=0.02, interp="scatter", device="cuda")
    w = V.project_divfree(V.init_ring(vcfg), vcfg)
    vstep = V.make_distributed_vic_step(m22, vcfg, axis_name=PENCIL)
    f = G.distribute_field2(w, m22, *PENCIL)
    for _ in range(3):
        w, ovf = V.vic_step(w, vcfg)
        f, ovf_d = vstep(f)
        assert int(ovf) == 0 and int(ovf_d) == 0
    full = G.gather_field2(f, m22, *PENCIL)
    err = float((full - w).abs().max() / w.abs().max())
    assert err <= 1e-4, err
    say(f"4 cards, pencil VIC step (2×2, 64×32×32): within {err:.3e} of "
        "vic_step (relative)")
    torch.distributed.destroy_process_group()


def _device_ms(fn, n: int) -> float:
    """Device time a call of ``fn`` (torch.profiler: every kernel's
    self time, NCCL's included), over ``n`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    tot = 0.0
    for e in prof.key_averages():
        tot += getattr(e, "self_device_time_total", None) \
            or getattr(e, "self_cuda_time_total", 0.0)
    return tot / 1e3 / n


def nccl_lm() -> None:
    """The sharded LM stack on every rank of the process group (one card a
    rank, NCCL; 4 under torchrun), each part against one card (every
    rank runs the one-card reference on its own card from the same seeded
    generator): llama3.2-3b FULL fp32 at (1, world) (prefill logits within
    1e-4 relative, 16 greedy tokens equal), and again under repro's
    sequence-parallel attention (``attn_q_parallel``, the queries over
    "model": B5 on each rank's rows at their offset); gemma-2b FULL fp32
    at (1, world), s_max 1024, decoding past its first cache shard (each
    step's
    logits within 1e-4); qwen2-moe-a2.7b FULL bf16 through
    ``moe_map_local`` at capacity factor 8 against the dense oracle (the
    logits within 5e-2, nothing dropped, the share of equal tokens, and
    the decode step's device time); jamba-1.5-large's 2-layer
    full-width cut against one card, then one FULL 8-layer period, too big
    for one card, drawn as blocks on each rank: prefill and 16 decode
    steps; one training step of llama3.2-3b's 2-layer fp32 cut at (2,
    world / 2) with FSDP weights (gradients within 1e-4, the AdamW update
    from the same gradients within 1e-6). Each serving part counts one
    B5 launch per attention layer on a rank's prefill. Raises on a
    mismatch."""
    import dataclasses
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import registry as R
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import runtime as RT
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.launch import dryrun as DR
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as T
    from repro_torch.sharding import specs as SP
    from repro_torch.training import serve as S
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    world = RT.device_count()
    m1w = RT.make_mesh((1, world), LM_AXES, device_type="cuda")
    m22 = RT.make_mesh((2, world // 2) if world % 2 == 0 else (1, world),
                       LM_AXES, device_type="cuda")
    rank = dist.get_rank()

    def say(msg):
        if rank == 0:
            print(msg, flush=True)

    def gen(seed):
        return torch.Generator(device="cuda").manual_seed(seed)

    def ctx_for(cfg, mesh, mode, seq, B, fsdp=False):
        return SP.ShardingContext.create(mesh, DR.effective_rules(
            cfg, mesh, ShapeConfig(mode, seq, B, mode)), fsdp=fsdp)

    def stream(cfg, params, prompt, toks, s_max, ctx=None):
        """Prefill logits and each decode step's, feeding ``toks``."""
        with torch.no_grad():
            lg, caches = S.make_prefill_step(cfg, s_max, ctx)(
                params, {"tokens": prompt})
            out = [lg[:, -1]]
            dec = S.make_decode_step(cfg, ctx)
            pos = torch.full((prompt.shape[0],), prompt.shape[1],
                             dtype=torch.int64, device="cuda")
            for i in range(toks.shape[1] - 1):
                lg, caches = dec(params, caches, {"tokens": toks[:, i:i + 1],
                                                  "position": pos + i})
                out.append(lg[:, -1])
        if ctx is not None:
            spec = T.logits_spec(cfg, ctx)
            with ctx.active():
                out = [SP.gather_block(o, spec[:1] + spec[2:]) for o in out]
        return torch.stack(out, 1).float()

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    b5 = {}

    def compare(tag, arch, mesh, B, S0, s_max, n_new, tol, rules=None,
                **over):
        """``arch`` with ``over`` sharded on ``mesh`` (the decode rules,
        ``rules`` over them) against one card; ``b5["n"]``: the B5
        launches of a rank's prefill."""
        cfg = dataclasses.replace(R.get_config(arch), **over)
        params = T.init_params(cfg, gen(0), "cuda")
        prompt = torch.randint(0, cfg.vocab, (B, S0), device="cuda",
                               generator=gen(1))
        with torch.no_grad():
            ref_tok = S.greedy_generate(cfg, params, prompt, n_new, s_max)
        ref = stream(cfg, params, prompt, ref_tok, s_max)
        ctx = ctx_for(cfg, mesh, "decode", s_max, B)
        if rules:
            ctx = SP.ShardingContext.create(mesh, dict(ctx.rules_dict,
                                                       **rules))
        lp = SP.shard_tree(params, T.params_logical(cfg), ctx,
                           T.param_specs(cfg, ctx)[0])
        del params
        torch.cuda.empty_cache()
        FA.LAUNCHES = 0
        with torch.no_grad():
            tok = S.greedy_generate(cfg, lp, prompt, n_new, s_max, ctx)
        b5["n"] = FA.LAUNCHES
        got = stream(cfg, lp, prompt, ref_tok, s_max, ctx)
        err = rel(got, ref)
        same = float((tok == ref_tok).float().mean())
        say(f"{tag}: {arch} {cfg.param_dtype} at {tuple(mesh.shape)}, "
            f"{B} x {S0} prompt, s_max {s_max}, {n_new} tokens: logits "
            f"(prefill and every decode step) rel {err:.3e} of one card "
            f"(tol {tol:g}); greedy tokens equal {same:.4f}; {b5['n']} B5 "
            f"launches on a rank's prefill (rules kv_seq "
            f"{ctx.rules_dict['kv_seq']!r})")
        return cfg, lp, ctx, prompt, ref_tok, tok, err, same

    # llama3.2-3b FULL fp32 at (1, world)
    cfg, *_, err, same = compare("lm-a", "llama3.2-3b", m1w, 4, 256, 288,
                                 16, 1e-4, param_dtype="float32",
                                 compute_dtype="float32")
    assert err <= 1e-4 and same == 1.0 and b5["n"] == \
        T.n_attention_layers(cfg), (err, same, b5)
    torch.cuda.empty_cache()
    # the same with repro's sequence-parallel attention (attn_q_parallel,
    # the queries over "model", the heads whole): B5 takes each rank's
    # 64 rows at their offset
    cfg, *_, err, same = compare(
        "lm-g", "llama3.2-3b", m1w, 4, 256, 288, 16, 1e-4,
        rules=dict(attn_seq="model", heads=None, kv_heads=None),
        param_dtype="float32", compute_dtype="float32",
        attn_q_parallel=True, attn_block_q=64)
    assert err <= 1e-4 and same == 1.0 and b5["n"] == \
        T.n_attention_layers(cfg), (err, same, b5)
    torch.cuda.empty_cache()
    # gemma-2b FULL fp32, 256 cache rows a rank: decode crosses row 256
    cfg, *_, err, same = compare("lm-b", "gemma-2b", m1w, 4, 250, 1024, 16,
                                 1e-4, param_dtype="float32",
                                 compute_dtype="float32")
    assert err <= 1e-4 and same == 1.0 and b5["n"] == \
        T.n_attention_layers(cfg), (err, same, b5)
    torch.cuda.empty_cache()

    # qwen2-moe FULL bf16 through moe_map_local, against the dense oracle
    calls = []
    real = MOE.moe_map_local

    def spy(*a, **k):
        out = real(*a, **k)
        calls.append(out[2])
        return out

    MOE.moe_map_local = spy
    # capacity 8 (repro's own map-vs-oracle test): the dropless oracle's
    # function; at the config's 1.25 the prefill drops a few assignments
    cfg, lp, ctx, prompt, ref_tok, tok, err, same = compare(
        "lm-c", "qwen2-moe-a2.7b", m1w, 4, 32, 64, 16, 5e-2,
        capacity_factor=8.0)
    MOE.moe_map_local = real
    dropped = int(sum(int(c) for c in calls))
    # at world 1 the expert axis has one rank: repro's dense oracle
    assert (bool(calls) == (world > 1) and dropped == 0 and err <= 5e-2
            and b5["n"] == T.n_attention_layers(cfg)), (len(calls), dropped,
                                                        err, b5)
    say(f"lm-c: {len(calls)} moe_map_local calls, {dropped} dropped")
    dec = S.make_decode_step(cfg, ctx)
    with torch.no_grad():
        _, caches = S.make_prefill_step(cfg, 64, ctx)(lp, {"tokens": prompt})
    pos = torch.full((4,), 32, dtype=torch.int64, device="cuda")

    def one():
        with torch.no_grad():
            dec(lp, caches, {"tokens": tok[:, :1], "position": pos})

    one()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    dist.barrier()
    t0.record()
    for _ in range(5):
        one()
    t1.record()
    torch.cuda.synchronize()
    wall = t0.elapsed_time(t1) / 5
    busy = _device_ms(one, 3)
    say(f"lm-c: decode step at tp {world}, batch 4, position 32: "
        f"{wall:.3f} ms (CUDA events, rank 0), device {busy:.3f} ms a step "
        f"(profiler, rank 0; NCCL kernels waiting for peers included)")
    del lp, caches
    torch.cuda.empty_cache()

    # jamba: the 2-layer full-width cut against one card, then one period
    cfg, lp, *_, err, same = compare("lm-d", "jamba-1.5-large-398b", m1w, 4,
                                     64, 96, 16, 5e-2, n_layers=2,
                                     attn_every=2)
    assert err <= 5e-2 and b5["n"] == T.n_attention_layers(cfg), (err, b5)
    del lp
    torch.cuda.empty_cache()
    cfg = R.get_config("jamba-1.5-large-398b")
    cfg = dataclasses.replace(cfg, n_layers=len(cfg.block_pattern()))
    if world < 4:
        say(f"lm-e: skipped: one FULL jamba period is 88 GB in bf16, "
            f"{88 / world:.0f} GB a card on {world}")
    else:
        _jamba_period(cfg, m1w, ctx_for, gen, say, rank)
    _lm_train_check(m22, ctx_for, gen, say)
    dist.destroy_process_group()


def _jamba_period(cfg, mesh, ctx_for, gen, say, rank):
    """nccl_lm's lm-e: one FULL jamba period drawn as blocks, served."""
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.training import serve as S
    ctx = ctx_for(cfg, mesh, "decode", 96, 4)
    t_init = time.perf_counter()
    lp = T.init_params(cfg, gen(2 + rank), "cuda", ctx=ctx)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t_init
    nbytes = sum(t.numel() * t.element_size() for t in T.leaves(lp))
    prompt = torch.randint(0, cfg.vocab, (4, 64), device="cuda",
                           generator=gen(1))
    t0 = time.perf_counter()
    with torch.no_grad():
        tok = S.greedy_generate(cfg, lp, prompt, 16, 96, ctx)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    assert tok.shape == (4, 16) and int(tok.min()) >= 0 \
        and int(tok.max()) < cfg.vocab
    say(f"lm-e: jamba-1.5-large FULL period ({cfg.n_layers} layers, "
        f"{cfg.block_pattern()}), {cfg.param_dtype} at {tuple(mesh.shape)}: "
        f"{nbytes / 1e9:.2f} GB of blocks a rank (drawn in {t_init:.1f} s), "
        f"4 x 64 prompt + 16 tokens in {gen_s:.2f} s; peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on rank 0")
    del lp
    torch.cuda.empty_cache()


def _lm_train_check(m22, ctx_for, gen, say):
    """nccl_lm's lm-f: llama3.2-3b's 2-layer fp32 cut at (2, world / 2)
    with FSDP weights against one card."""
    import dataclasses
    import torch
    from repro_torch import tree as TREE
    from repro_torch.configs import registry as R
    from repro_torch.models import transformer as T
    from repro_torch.sharding import specs as SP
    from repro_torch.training import optimizer as O
    from repro_torch.training import train as TR
    cfg = dataclasses.replace(R.get_config("llama3.2-3b"), n_layers=2,
                              param_dtype="float32", compute_dtype="float32")
    params = T.init_params(cfg, gen(7), "cuda")
    toks = torch.randint(0, cfg.vocab, (4, 65), device="cuda",
                         generator=gen(8))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    (loss, _), g = TR.make_grad_fn(cfg)(params, batch)
    ctx = ctx_for(cfg, m22, "train", 64, 4, fsdp=True)
    specs = T.param_specs(cfg, ctx)[0]
    lp = SP.shard_tree(params, T.params_logical(cfg), ctx, specs)
    with ctx.active():
        rows = SP.local_slices((4,), (ctx.axis("batch"),), ctx.mesh)[0]
    (loss_s, _), gs = TR.make_grad_fn(cfg, ctx)({k: v for k, v in lp.items()},
                                              {k: v[rows] for k, v in
                                               batch.items()})
    with ctx.active():
        gs = SP.tree_map2(lambda sp, x: SP.gather_block(x, sp), specs, gs,
                          is_leaf=SP.is_spec)
    pairs = list(zip(TREE.flatten(gs)[0], TREE.flatten(g)[0]))
    gap = max(float((a - b).abs().max()) for a, b in pairs)
    scale = max(float(b.abs().max()) for _, b in pairs)
    opt = O.OptConfig(lr=1e-3, warmup_steps=0)
    p_ref = TREE.tree_map(torch.clone, params)
    g_ref, n_ref = O.clip_by_global_norm(TREE.tree_map(torch.clone, g),
                                         opt.clip_norm)
    O.adamw_update(p_ref, g_ref, O.init_opt_state(p_ref, opt), opt)
    g_loc = SP.shard_tree(g, T.params_logical(cfg), ctx, specs)
    g_loc, n_loc = O.clip_by_global_norm(g_loc, opt.clip_norm, specs=specs,
                                         ctx=ctx)
    O.adamw_update(lp, g_loc, O.init_opt_state(lp, opt), opt)
    with ctx.active():
        lp = SP.tree_map2(lambda sp, x: SP.gather_block(x, sp), specs, lp,
                          is_leaf=SP.is_spec)
    upd = max(float((a - b).abs().max()) for a, b in
              zip(TREE.flatten(lp)[0], TREE.flatten(p_ref)[0]))
    say(f"lm-f: training {cfg.name} 2-layer fp32 cut at "
        f"{tuple(m22.shape)}, FSDP, batch 4 x 64: loss {float(loss_s):.6f} "
        f"vs {float(loss):.6f}; gradients max abs gap {gap:.3e} of "
        f"{scale:.3e} (tol 1e-4 of it); norm {float(n_loc):.6f} vs "
        f"{float(n_ref):.6f}; AdamW update from the same gradients max "
        f"gap {upd:.3e} (tol 1e-6)")
    assert gap <= 1e-4 * scale and upd <= 1e-6, (gap, upd)
    assert abs(float(loss_s) - float(loss)) <= 1e-4 * abs(float(loss))


if __name__ == "__main__":
    if sys.argv[1] == "--repro":
        repro_reference(*sys.argv[2:5])
    elif sys.argv[1] == "--repro-reuse":
        repro_reuse_reference(*sys.argv[2:5])
    elif sys.argv[1] == "--repro-fleet":
        repro_fleet_reference(*sys.argv[2:4])
    elif sys.argv[1] == "--repro-pencil":
        repro_pencil_reference(*sys.argv[2:6])
    elif sys.argv[1] == "--repro-comm":
        repro_comm_reference(sys.argv[2])
    elif sys.argv[1] == "--repro-specs":
        repro_spec_dump(sys.argv[2])
    elif sys.argv[1] == "--repro-lm":
        repro_lm_reference(sys.argv[2])
    elif sys.argv[1] == "--repro-moe-mamba":
        repro_moe_mamba_reference(*sys.argv[2:5])
    elif sys.argv[1] == "--nccl-lm":
        try:
            nccl_lm()
        except BaseException:
            import traceback
            traceback.print_exc(file=sys.stdout)
            sys.stdout.flush()
            raise
    elif sys.argv[1] == "--nccl-md":
        nccl_md()
    elif sys.argv[1] == "--nccl-reuse":
        nccl_reuse()
    elif sys.argv[1] == "--nccl-fleet-pencil":
        nccl_fleet_pencil()
    else:
        _main(sys.argv)
