"""repro_torch.fleet against repro.fleet (tests/test_fleet.py's contract,
on the CPU): the port's fleet step against repro's make_fleet_step on the
same stacked members (MD; SPH with per-member euler flags; 1e-4, as
tests/test_torch_md.py's trajectories), fleet against the port's own
serial loop (1e-6), batch=1 is serial bit for bit, member overflow stays
on its row, inactive slots pass through, the server drains churn through
one step signature with results equal to serial runs, bounded admission,
the meshed step and server on a 1-rank mesh equal to the unmeshed ones,
per-member extras, the metrics snapshot's keys; the SPH euler flag as a
0-d tensor against the Python bool bit for bit; and B1's batching rule:
the members' tiles fold into one launch."""
import dataclasses
import queue

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import np_, rel

from repro.apps import md as jmd
from repro.apps import sph as jsph
from repro.core import particles as JP
from repro.core import simulation as JSIM
from repro.fleet import batch as JFB
from repro.fleet import metrics as JFM
from repro_torch import convert
from repro_torch.apps import md as tmd
from repro_torch.apps import sph as tsph
from repro_torch.core import cell_list as TCL
from repro_torch.core import simulation as TSIM
from repro_torch.fleet import FleetServer, SimRequest
from repro_torch.fleet import batch as FB
from repro_torch.fleet import metrics as FM
from repro_torch.io import checkpoint as CK
from repro_torch.kernels.cell_pair import cell_pair as TCP

PARITY_TOL = 1e-4     # port vs repro over steps (test_torch_md.py:68)
LOOP_TOL = 1e-6       # fleet vs the port's serial loop (test_fleet.py)
SPH_SMALL = dict(dp=0.05, box=(1.0, 0.5), fluid=(0.25, 0.25))


def _md_cfg(**kw):
    return tmd.MDConfig(n_per_side=3, device="cpu", **kw)


def _md_state(cfg, seed):
    ps = tmd.init_particles(cfg)
    v = np.random.default_rng(seed).normal(size=tuple(ps.x.shape))
    v = torch.from_numpy((0.05 * v).astype(np.float32))
    ps = ps.with_prop("v", torch.where(ps.valid[:, None], v, 0.0))
    return TSIM.serial_state(ps, tmd.physics, cfg)


def _sph_state(cfg, seed):
    ps = tsph.init_dam_break(cfg)
    v = np.random.default_rng(seed).normal(size=tuple(ps.props["v"].shape))
    v = torch.from_numpy((0.01 * v).astype(np.float32))
    ps = ps.with_prop("v", torch.where(ps.valid[:, None], v, 0.0))
    return TSIM.serial_state(ps, tsph.physics, cfg)


def _to_jax_state(state, jphysics, jcfg):
    p = state.ps
    jps = JP.ParticleSet(x=jnp.asarray(np_(p.x)),
                         props={k: jnp.asarray(np_(v))
                                for k, v in p.props.items()},
                         valid=jnp.asarray(np_(p.valid)))
    return JSIM.serial_state(jps, jphysics, jcfg)


def _err(a, b):
    return float((a.double() - b.double()).abs().max())


# --------------------------------------------------------------------------
# parity with repro's fleet step
# --------------------------------------------------------------------------

def test_fleet_matches_repro_md():
    """3 members, 3 steps: the port's fleet step (from repro's stacked
    ensemble, converted) against repro's make_fleet_step."""
    jcfg = jmd.MDConfig(n_per_side=3)
    cfg = _md_cfg()
    jstates = [_to_jax_state(_md_state(cfg, s), jmd.physics, jcfg)
               for s in range(3)]
    jens = JFB.stack_members(jstates)
    ens = convert.ensemble_from_numpy(jax.tree.map(np.asarray, jens),
                                      device="cpu")
    jstep = JFB.make_fleet_step(jmd.physics, jcfg)
    fstep = FB.make_fleet_step(tmd.physics, cfg)
    for _ in range(3):
        jens, jflags, _ = jstep(jens, {})
        ens, flags, _ = fstep(ens, {})
    assert flags.cell.shape == (3,)
    np.testing.assert_array_equal(np_(flags.cell), np.asarray(jflags.cell))
    valid = np.asarray(jens.member.ps.valid)
    assert (np_(ens.member.ps.valid) == valid).all()
    assert rel(np_(ens.member.ps.x)[valid],
               np.asarray(jens.member.ps.x)[valid]) <= PARITY_TOL
    assert rel(np_(ens.member.ps.props["v"])[valid],
               np.asarray(jens.member.ps.props["v"])[valid]) <= PARITY_TOL


def test_fleet_matches_repro_sph_per_member_euler():
    """2 SPH members whose euler flags differ per step, 3 steps, against
    repro's fleet step; dt per member."""
    jcfg = jsph.SPHConfig(**SPH_SMALL)
    cfg = tsph.SPHConfig(**SPH_SMALL, device="cpu")
    states = [_sph_state(cfg, s) for s in range(2)]
    jens = JFB.stack_members([_to_jax_state(s, jsph.physics, jcfg)
                              for s in states])
    ens = FB.stack_members(states)
    jstep = JFB.make_fleet_step(jsph.physics, jcfg)
    fstep = FB.make_fleet_step(tsph.physics, cfg)
    for i in range(3):
        euler = np.array([i == 0, i == 1])
        jens, _, jscal = jstep(jens, {"euler": jnp.asarray(euler)})
        ens, _, scal = fstep(ens, {"euler": torch.from_numpy(euler)})
        assert rel(scal["dt"], jscal["dt"]) <= PARITY_TOL
    assert scal["dt"].shape == (2,)
    valid = np.asarray(jens.member.ps.valid)
    for name in ("v", "rho"):
        assert rel(np_(ens.member.ps.props[name])[valid],
                   np.asarray(jens.member.ps.props[name])[valid]) \
            <= PARITY_TOL
    assert rel(np_(ens.member.ps.x)[valid],
               np.asarray(jens.member.ps.x)[valid]) <= PARITY_TOL


# --------------------------------------------------------------------------
# fleet against the port's serial loop
# --------------------------------------------------------------------------

def test_fleet_matches_loop_md():
    cfg = _md_cfg()
    states = [_md_state(cfg, s) for s in range(3)]
    ens = FB.stack_members(states)
    fstep = FB.make_fleet_step(tmd.physics, cfg)
    sstep = TSIM.make_sim_step(tmd.physics, cfg)
    for _ in range(3):
        ens, flags, _ = fstep(ens, {})
        states = [sstep(s, {})[0] for s in states]
    for b, s in enumerate(states):
        m = FB.member_at(ens, b)
        assert _err(m.ps.x, s.ps.x) <= LOOP_TOL
        assert _err(m.ps.props["v"], s.ps.props["v"]) <= LOOP_TOL


def test_fleet_matches_loop_sph():
    """SPH with every extras entry carrying a (B,) axis: shared flags
    through broadcast_extras."""
    cfg = tsph.SPHConfig(**SPH_SMALL, device="cpu")
    states = [_sph_state(cfg, s) for s in range(2)]
    ens = FB.stack_members(states)
    fstep = FB.make_fleet_step(tsph.physics, cfg)
    sstep = TSIM.make_sim_step(tsph.physics, cfg)
    for i in range(3):
        ens, _, scal = fstep(ens, FB.broadcast_extras({"euler": i == 0}, 2))
        states = [sstep(s, {"euler": i == 0})[0] for s in states]
    assert scal["dt"].shape == (2,)
    for b, s in enumerate(states):
        m = FB.member_at(ens, b)
        assert _err(m.ps.x, s.ps.x) <= LOOP_TOL
        assert _err(m.ps.props["v"], s.ps.props["v"]) <= LOOP_TOL


def test_batch_one_degenerates_to_serial():
    cfg = _md_cfg()
    st = _md_state(cfg, 7)
    ens = FB.stack_members([st])
    fstep = FB.make_fleet_step(tmd.physics, cfg)
    sstep = TSIM.make_sim_step(tmd.physics, cfg)
    for _ in range(3):
        ens, flags, _ = fstep(ens, {})
        st, sflags, _ = sstep(st, {})
    assert torch.equal(FB.member_at(ens, 0).ps.x, st.ps.x)
    assert int(flags.cell[0]) == int(sflags.cell)


def test_member_overflow_is_isolated():
    """Member 0 crammed into one corner cell with a tiny cell_cap
    overflows; member 1 sees a zero flag row and its solo trajectory bit
    for bit."""
    cfg = _md_cfg(cell_cap=8)
    bad = _md_state(cfg, 0)
    bad = dataclasses.replace(bad, ps=bad.ps.replace(x=torch.where(
        bad.ps.valid[:, None], 0.01 + 0.05 * bad.ps.x * cfg.r_cut,
        bad.ps.x)))
    good = _md_state(cfg, 1)
    ens = FB.stack_members([bad, good])
    fstep = FB.make_fleet_step(tmd.physics, cfg)
    sstep = TSIM.make_sim_step(tmd.physics, cfg)
    solo = good
    for _ in range(2):
        ens, flags, _ = fstep(ens, {})
        solo, solo_flags, _ = sstep(solo, {})
        assert int(flags.cell[0]) > 0
        assert int(flags.cell[1]) == int(solo_flags.cell) == 0
    assert torch.equal(FB.member_at(ens, 1).ps.x, solo.ps.x)


def test_inactive_slots_pass_through():
    cfg = _md_cfg()
    states = [_md_state(cfg, s) for s in range(2)]
    ens = FB.stack_members(states, active=torch.tensor([True, False]))
    fstep = FB.make_fleet_step(tmd.physics, cfg)
    ens2, flags, _ = fstep(ens, {})
    assert torch.equal(FB.member_at(ens2, 1).ps.x, FB.member_at(ens, 1).ps.x)
    assert not torch.equal(FB.member_at(ens2, 0).ps.x,
                           FB.member_at(ens, 0).ps.x)
    assert int(flags.cell[1]) == 0


def test_set_member_writes_slot_in_place():
    cfg = _md_cfg()
    ens = FB.stack_members([_md_state(cfg, s) for s in range(3)],
                           active=torch.tensor([True, False, True]))
    x_buf = ens.member.ps.x
    new = _md_state(cfg, 9)
    out = FB.set_member(ens, 1, new)
    assert out is ens and ens.member.ps.x is x_buf     # no new ensemble
    assert torch.equal(ens.member.ps.props["v"][1], new.ps.props["v"])
    assert ens.active.tolist() == [True, True, True]
    got = FB.member_at(ens, 1)
    FB.set_member(ens, 1, _md_state(cfg, 4), active=False)
    assert torch.equal(got.ps.props["v"], new.ps.props["v"])  # a copy
    assert ens.active.tolist() == [True, False, True]


def _world1_fleet():
    """A 1-rank gloo mesh with a ("fleet",) axis in this process."""
    from repro_torch.core import runtime as TRT
    return TRT.make_mesh((1,), ("fleet",), device_type="cpu")


def test_world1_meshed_fleet_step_equals_unmeshed():
    """The sharded fleet on a 1-rank mesh: shard_ensemble keeps every
    member, and the meshed step equals the unmeshed one bit for bit (a
    batch that does not divide is shard_ensemble's ValueError on more
    ranks: tests/test_torch_dist_fleet.py)."""
    cfg = _md_cfg()
    mesh = _world1_fleet()
    ens = FB.stack_members([_md_state(cfg, s) for s in range(3)])
    local = FB.shard_ensemble(ens, mesh)
    assert local.batch == 3
    ref_step = FB.make_fleet_step(tmd.physics, cfg)
    step = FB.make_fleet_step(tmd.physics, cfg, mesh)
    assert step is FB.make_fleet_step(tmd.physics, cfg, mesh)
    for _ in range(3):
        ens, rflags, _ = ref_step(ens, {})
        local, flags, _ = step(local, {})
    assert torch.equal(local.member.ps.x, ens.member.ps.x)
    assert torch.equal(local.member.ps.props["v"], ens.member.ps.props["v"])
    assert torch.equal(flags.cell, rflags.cell)
    assert step.cache_size() == 1


# --------------------------------------------------------------------------
# the SPH euler flag as a tensor (a select, not a host read)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("euler", [True, False])
def test_sph_euler_tensor_flag_equals_bool(euler):
    cfg = tsph.SPHConfig(**SPH_SMALL, device="cpu")
    st = _sph_state(cfg, 3)
    step = TSIM.make_sim_step(tsph.physics, cfg)
    st = step(st, {"euler": True})[0]       # v_prev != v from here on
    ref, _, rs = step(st, {"euler": euler})
    got, _, gs = step(st, {"euler": torch.tensor(euler)})
    for name in ("v", "rho", "v_prev", "rho_prev"):
        assert torch.equal(got.ps.props[name], ref.ps.props[name]), name
    assert torch.equal(got.ps.x, ref.ps.x)
    assert torch.equal(gs["dt"], rs["dt"])


# --------------------------------------------------------------------------
# the server
# --------------------------------------------------------------------------

def test_server_churn_without_rebuild(tmp_path):
    """5 requests through 2 slots: one step signature across the churn,
    results equal to serial runs bit for bit, streamed checkpoints with no
    .tmp left, readable by both packages."""
    cfg = _md_cfg()
    reqs = [(seed, 3 + seed % 3) for seed in range(5)]
    srv = FleetServer(tmd.physics, cfg, n_slots=2,
                      template=_md_state(cfg, 0), out_dir=str(tmp_path))
    for rid, (seed, n) in enumerate(reqs):
        srv.submit(SimRequest(rid=rid, state=_md_state(cfg, seed),
                              n_steps=n))
    with srv:
        results = srv.run()
    assert srv.step_cache_size() == 1
    assert sorted(r.rid for r in results) == list(range(5))
    sstep = TSIM.make_sim_step(tmd.physics, cfg)
    for rid, (seed, n) in enumerate(reqs):
        st = _md_state(cfg, seed)
        for _ in range(n):
            st, _, _ = sstep(st, {})
        res = next(r for r in results if r.rid == rid)
        assert res.steps_done == n
        assert torch.equal(st.ps.x, res.state.ps.x)
        assert all(v == 0 for v in res.flags_max.values())
    assert list(tmp_path.glob("*.tmp")) == []
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        f"sim_{r}" for r in range(5)]
    res0 = next(r for r in results if r.rid == 0)
    ps, step, meta = CK.load_particles(tmp_path / "sim_0",
                                       capacity=cfg.n_particles,
                                       device="cpu")
    assert step == 3 and meta["rid"] == "0"
    assert torch.equal(ps.x[ps.valid], res0.state.ps.x[res0.state.ps.valid])
    from repro.io import checkpoint as JCK
    jps, jstep, _ = JCK.load_particles(tmp_path / "sim_0",
                                       capacity=cfg.n_particles)
    assert jstep == 3
    np.testing.assert_array_equal(np.asarray(jps.x)[np.asarray(jps.valid)],
                                  np_(ps.x[ps.valid]))
    snap = srv.metrics.snapshot()
    assert snap["schema"] == "repro-fleet-metrics/v1"
    assert snap["counters"]["sims_completed"] == 5
    assert snap["counters"]["sims_submitted"] == 5
    assert snap["gauges"]["n_slots"] == 2
    assert snap["rates"]["sims_per_sec"] > 0


def test_server_bounded_queue():
    cfg = _md_cfg()
    srv = FleetServer(tmd.physics, cfg, n_slots=1,
                      template=_md_state(cfg, 0), queue_cap=1)
    srv.submit(SimRequest(rid=0, state=_md_state(cfg, 0), n_steps=1))
    with pytest.raises(queue.Full):
        srv.submit(SimRequest(rid=1, state=_md_state(cfg, 1), n_steps=1),
                   block=False)


def test_server_per_member_extras():
    """SPH through the server: each request's extras_fn sees its own step
    count (staggered joins), matching per-run serial loops."""
    cfg = tsph.SPHConfig(**SPH_SMALL, device="cpu")

    def extras_fn(i):
        return {"euler": i == 0}

    srv = FleetServer(tsph.physics, cfg, n_slots=2,
                      template=_sph_state(cfg, 0),
                      default_extras={"euler": False})
    runs = [(0, 2), (1, 4), (2, 3)]
    for rid, n in runs:
        srv.submit(SimRequest(rid=rid, state=_sph_state(cfg, rid),
                              n_steps=n, extras_fn=extras_fn))
    results = srv.run()
    assert srv.step_cache_size() == 1
    sstep = TSIM.make_sim_step(tsph.physics, cfg)
    for rid, n in runs:
        st = _sph_state(cfg, rid)
        for i in range(n):
            st, _, _ = sstep(st, extras_fn(i))
        res = next(r for r in results if r.rid == rid)
        assert _err(st.ps.x, res.state.ps.x) <= LOOP_TOL


def test_world1_meshed_server_equals_unmeshed(tmp_path):
    """The meshed server on a 1-rank mesh: one step signature across the
    churn, and every result equal to the unmeshed server's bit for bit,
    its checkpoint written by the owner (the only rank)."""
    cfg = _md_cfg()
    reqs = [(seed, 2 + seed % 3) for seed in range(4)]
    got = []
    for mesh, out in ((None, None), (_world1_fleet(), str(tmp_path))):
        srv = FleetServer(tmd.physics, cfg, n_slots=2,
                          template=_md_state(cfg, 0), mesh=mesh,
                          out_dir=out)
        for rid, (seed, n) in enumerate(reqs):
            srv.submit(SimRequest(rid=rid, state=_md_state(cfg, seed),
                                  n_steps=n))
        with srv:
            got.append({r.rid: r for r in srv.run()})
        assert srv.step_cache_size() == 1
    ref, meshed = got
    assert sorted(meshed) == sorted(ref) == list(range(4))
    for rid in ref:
        assert meshed[rid].steps_done == ref[rid].steps_done
        assert torch.equal(meshed[rid].state.ps.x, ref[rid].state.ps.x)
        assert meshed[rid].flags_max == ref[rid].flags_max
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        f"sim_{r}" for r in range(4)]


def _keys(d, prefix=""):
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= _keys(v, prefix + k + ".")
    return out


def test_metrics_snapshot_keys_equal_repro(tmp_path):
    ours, theirs = FM.FleetMetrics(n_slots=4), JFM.FleetMetrics(n_slots=4)
    for m in (ours, theirs):
        m.observe_submit(2)
        m.observe_step(0.01, 3)
        m.observe_complete(1)
    a, b = ours.snapshot(), theirs.snapshot()
    assert FM.SCHEMA == JFM.SCHEMA == a["schema"]
    assert _keys(a) == _keys(b)
    assert a["counters"] == b["counters"] and a["gauges"] == b["gauges"]
    FM.emit(tmp_path / "m.json", a, rows=[{"name": "x"}], caveat="cpu")
    import json
    assert json.loads((tmp_path / "m.json").read_text())["caveat"] == "cpu"


# --------------------------------------------------------------------------
# B1's batching rule: the members' tiles fold into one launch
# --------------------------------------------------------------------------

_FOLD_CALLS = []


@pytest.fixture(scope="module")
def cpu_stand_in():
    """A CPU kernel for ``repro_torch::cell_pair`` (the operator is CUDA
    only) that runs the plain tile function and records each call's cell
    count, so the batching rule's fold runs here."""
    bodies = {}

    def kernel(cell_x, nbr_x, cell_mask, nbr_mask, pi, pj, kind, prec,
               params, r_cut):
        _FOLD_CALLS.append(cell_x.shape[0])
        spec = TCP.KINDS[kind]
        dim = cell_x.shape[-1]

        def unpack(p):
            out, o = {}, 0
            for name, vec in zip(spec.props, spec.vector):
                out[name] = p[..., o:o + dim] if vec else p[..., o]
                o += dim if vec else 1
            return out

        res = TCP.cell_pair_torch(
            cell_x, nbr_x, cell_mask, nbr_mask,
            unpack(pi) if pi is not None else {},
            unpack(pj) if pj is not None else {},
            body=bodies[kind], out=spec.out, r_cut=r_cut)
        by = {k: res[n] for n, k in spec.out.items()}
        return (by.get("radial", cell_x.new_empty((0,))),
                by.get("scalar", cell_x.new_empty((0,))))

    TCP._cell_pair_op.register_kernel("cpu")(kernel)
    return bodies


def _pair_pass(ps, cl_kw, body, out, r_cut, props=()):
    cl = TCL.build_cell_list(ps, **cl_kw)
    t = TCP.gather_cell_tiles(ps, cl, props)
    res = TCP._cell_pair_cuda(t.cell_x, t.nbr_x, t.cell_mask, t.nbr_mask,
                              t.props_i, t.props_j, body=body, out=out,
                              r_cut=r_cut, precision="fp32")
    return {k: TCP.scatter_slots(t.rows, v, ps.capacity)
            for k, v in res.items()}


def test_b1_folds_members_into_one_launch(cpu_stand_in):
    """Under torch.func.vmap, B members' LJ and SPH pair passes make ONE
    operator call over B·C cells, and each member's sums equal its own
    call's bit for bit."""
    B = 3
    cfg = tmd.MDConfig(n_per_side=5, device="cpu")
    body = tmd.lj_pair_body(cfg.sigma, cfg.epsilon)
    cpu_stand_in["lj"] = body
    base = tmd.init_particles(cfg)
    xs = torch.stack([
        torch.where(base.valid[:, None], base.x + 0.01 * torch.from_numpy(
            np.random.default_rng(b).normal(size=tuple(base.x.shape))
            .astype(np.float32)), base.x) for b in range(B)])
    kw = tmd._cl_kw(cfg)

    def lj(x):
        return _pair_pass(base.replace(x=x), kw, body, {"f": "radial"},
                          cfg.r_cut)["f"]

    _FOLD_CALLS.clear()
    got = torch.func.vmap(lj)(xs)
    n_cells = int(np.prod(kw["grid_shape"]))
    assert _FOLD_CALLS == [B * n_cells]
    for b in range(B):
        assert torch.equal(got[b], lj(xs[b]))

    scfg = tsph.SPHConfig(**SPH_SMALL, device="cpu")
    sbody = tsph.sph_pair_body(scfg)
    cpu_stand_in["sph"] = sbody
    sps = tsph.init_dam_break(scfg)
    vs = torch.stack([torch.where(sps.valid[:, None], torch.from_numpy(
        np.random.default_rng(b).normal(size=tuple(sps.props["v"].shape))
        .astype(np.float32)) * 0.1, 0.0) for b in range(B)])
    skw = tsph._cl_kw(scfg)

    def sph_pass(v):
        r = _pair_pass(sps.with_prop("v", v), skw, sbody,
                       {"a": "radial", "drho": "scalar"}, scfg.r_cut,
                       ("v", "rho"))
        return r["a"], r["drho"]

    _FOLD_CALLS.clear()
    a, drho = torch.func.vmap(sph_pass)(vs)
    assert _FOLD_CALLS == [B * int(np.prod(skw["grid_shape"]))]
    for b in range(B):
        ra, rd = sph_pass(vs[b])
        assert torch.equal(a[b], ra) and torch.equal(drho[b], rd)
