"""repro_torch's serial leftovers against repro, on the CPU: the 1-D
block legs of M'4 interpolation (core/interp p2m_block/m2p_block, the
cell path kernels/m4_interp/ops p2m_block/m2p_fused_block) and
seed_from_block, and their pencil forms (p2m_block2/m2p_block2/
seed_from_block2, at the seam of both axes); mesh fields in the serial
step (repro's toy mesh
physics of tests/distributed/test_dist_field.py); multigrid_poisson; the
Verlet-list kernels; and the LJ cell-tile oracle."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import (ToyCfg, case_state, interp_case, np_, rel,
                           to_torch, toy_physics)
from benchmarks import backend_compare as BC

from repro.apps import md as jmd
from repro.core import cell_list as JCL
from repro.core import interactions as JI
from repro.core import interp as JIP
from repro.core import remesh as JRM
from repro.core import simulation as JSIM
from repro.core.particles import from_positions as j_from_positions
from repro.kernels.lj_cell import ref as JLJ
from repro.kernels.m4_interp import ops as JM4
from repro.numerics import poisson as JPS
from repro_torch.core import cell_list as TCL
from repro_torch.core import grid as TG
from repro_torch.core import interactions as TI
from repro_torch.core import interp as TIP
from repro_torch.core import remesh as TRM
from repro_torch.core import simulation as TSIM
from repro_torch.kernels.cell_pair import cell_pair as TCP
from repro_torch.kernels.lj_cell import lj_cell as TLJ
from repro_torch.kernels.lj_cell import ref as TLJR
from repro_torch.kernels.m4_interp import ops as TM4
from repro_torch.numerics import poisson as TPS

TOL = 1e-5      # fp32, only the summation order differs
MG_TOL = 1e-4   # multigrid: 8+ V-cycles of smoothing, repro's jnp vs Pallas


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _block_case(seed, ndev, me, H=2):
    """tests/test_kernels.py's _block_case with numpy draws: the 3-D
    interpolation case's block of slab ``me`` of ``ndev`` (owned rows ± H
    halo rows) and the particles that slab owns. ndev 1 is the serial
    1-slab block (the whole axis and both halos)."""
    kw, x, val, valid, field = interp_case(3, seed)
    n0 = kw["shape"][0]
    n0l = n0 // ndev
    h0 = kw["box_hi"][0] / n0
    row = np.floor(x[:, 0] / np.float32(h0)).astype(np.int32)
    mine = valid & ((row // n0l) == me)
    return kw, x, val, mine, field, n0l + 2 * H, me * n0l - H


# (ndev, me): blocks of 8 rows (2 buckets of cb 4) in the interior and at
# the seam (row0 < 0), of 12 rows (3 buckets) at the seam, and the serial
# 1-slab block of 20 rows (5 buckets)
BLOCKS = [(4, 1), (4, 0), (2, 0), (1, 0)]


@pytest.mark.parametrize("ndev,me", BLOCKS)
def test_p2m_block_matches_repro(ndev, me):
    kw, x, val, mine, _, rows, row0 = _block_case(11 + me, ndev, me)
    ref, drop_ref = JIP.p2m_block(
        jnp.asarray(x), jnp.asarray(val), jnp.asarray(mine),
        jnp.asarray(row0, jnp.int32), block_rows=rows, **kw)
    tx, tval, tmine = _t(x, val, mine)
    got, drop = TIP.p2m_block(tx, tval, tmine,
                              torch.tensor(row0, dtype=torch.int32),
                              block_rows=rows, **kw)
    assert got.shape == ref.shape and int(drop) == int(drop_ref) == 0
    assert rel(got, ref) <= TOL
    # the cell path on the block's local torus (the plain version of B3)
    cells, ovf = TM4.p2m_block(tx, tval, tmine, row0, block_rows=rows,
                               cell_cap=256, **kw)
    assert int(ovf) == 0 and rel(cells, ref) <= TOL
    # scalar values: the first channel's deposit
    got_s, _ = TM4.p2m_block(tx, tval[:, 0].contiguous(), tmine, row0,
                             block_rows=rows, cell_cap=256, **kw)
    assert rel(got_s, np_(ref)[..., 0]) <= TOL


@pytest.mark.parametrize("ndev,me", BLOCKS)
def test_m2p_block_matches_repro(ndev, me):
    kw, x, _, mine, field, rows, row0 = _block_case(13 + me, ndev, me)
    n0 = kw["shape"][0]
    # the ghost_get-padded slab blocks the distributed step would hold
    idx = np.mod(np.arange(row0, row0 + rows), n0)
    u_blk = field[idx]
    r_blk = field[idx][..., 0] * np.float32(-0.5)
    ur, dru = JIP.m2p_block(jnp.asarray(u_blk), jnp.asarray(x),
                            jnp.asarray(mine), jnp.asarray(row0, jnp.int32),
                            **kw)
    tx, tmine, tu, tr = _t(x, mine, u_blk, r_blk)
    got_u, dr = TIP.m2p_block(tu, tx, tmine, row0, **kw)
    assert int(dr) == int(dru) == 0 and rel(got_u, ur) <= TOL
    # a scalar block: the port's oracle, held to repro's by the line above
    rr, _ = TIP.m2p_block(tr, tx, tmine, row0, **kw)
    (uk, rk), ovf = TM4.m2p_fused_block((tu, tr), tx, tmine, row0,
                                        cell_cap=256, **kw)
    assert int(ovf) == 0
    assert rel(uk, ur) <= TOL and rel(rk, rr) <= TOL


def test_block_support_leaving_the_block_is_dropped_whole():
    """A particle two slabs away that claims to be owned is dropped and
    counted, never clamped into the block edge: the same block and count
    as repro's, on the scatter and the cell path."""
    kw, x, val, mine, _, rows, row0 = _block_case(14, 4, 1)
    mine = mine.copy()
    mine[0] = True
    x = x.copy()
    x[0, 0] = 0.01
    ref, drop_ref = JIP.p2m_block(
        jnp.asarray(x), jnp.asarray(val), jnp.asarray(mine),
        jnp.asarray(row0, jnp.int32), block_rows=rows, **kw)
    assert int(drop_ref) >= 1
    tx, tval, tmine = _t(x, val, mine)
    got, drop = TIP.p2m_block(tx, tval, tmine, row0, block_rows=rows, **kw)
    cells, ovf = TM4.p2m_block(tx, tval, tmine, row0, block_rows=rows,
                               cell_cap=256, **kw)
    assert int(drop) == int(ovf) == int(drop_ref)
    assert rel(got, ref) <= TOL and rel(cells, ref) <= TOL
    vals, drop_m = TIP.m2p_block(tx.new_ones((rows, 8, 8)), tx, tmine, row0,
                                 **kw)
    assert int(drop_m) == int(drop_ref) and float(vals[0]) == 0.0


def test_block_legs_match_repro_pallas_interpret():
    """One interpret-mode call of repro's Pallas block deposit (M4.
    p2m_block) against the port's cell path on the same block."""
    kw, x, val, mine, _, rows, row0 = _block_case(12, 4, 1)
    ref, ovf_ref = JM4.p2m_block(
        jnp.asarray(x), jnp.asarray(val), jnp.asarray(mine),
        jnp.asarray(row0, jnp.int32), block_rows=rows, cell_cap=256,
        interpret=True, **kw)
    got, ovf = TM4.p2m_block(*_t(x, val, mine), row0, block_rows=rows,
                             cell_cap=256, **kw)
    assert int(ovf) == int(ovf_ref) == 0 and rel(got, ref) <= TOL


def test_serial_block_legs_equal_the_global_ones():
    """The serial degenerate: p2m onto the whole axis as one block, then
    halo_reduce_local, equals the global p2m; m2p from the halo-padded
    field equals the global m2p (tests/test_core.py:351, :366)."""
    kw, x, val, valid, field = interp_case(3, 5, n=300)
    H, n0 = 2, kw["shape"][0]
    tx, tval, tvalid, tf = _t(x, val, valid, field)
    blk, drop = TIP.p2m_block(tx, tval, tvalid, -H, block_rows=n0 + 2 * H,
                              **kw)
    assert int(drop) == 0
    got = TG.halo_reduce_local(blk, H, periodic=True)
    assert float((got - TIP.p2m(tx, tval, tvalid, **kw)).abs().max()) <= TOL
    pad = TG.halo_pad_local(tf, H, periodic=True)
    g, drop = TIP.m2p_block(pad, tx, tvalid, -H, **kw)
    assert int(drop) == 0
    assert float((g - TIP.m2p(tf, tx, tvalid, **kw)).abs().max()) <= TOL


@pytest.mark.parametrize("threshold", [0.0, 0.8])
def test_seed_from_block_matches_repro(threshold):
    """The per-slab re-seed: validity and values exact against repro's,
    positions within repro's own 1e-6 (repro adds the block origin in
    float32); the dense re-seed equals the rows of the port's
    seed_from_mesh bit for bit, at the seam's far side too."""
    kw = dict(box_lo=(0.0, 0.0), box_hi=(2.0, 1.0), periodic=(True, True))
    field = np.random.default_rng(4).normal(size=(16, 8)).astype(np.float32)
    for row0 in (4, 12):
        blk = field[row0:row0 + 4]
        jps, jovf = JRM.seed_from_block(jnp.asarray(blk),
                                        jnp.asarray(row0, jnp.int32),
                                        shape=(16, 8), threshold=threshold,
                                        **kw)
        tps, tovf = TRM.seed_from_block(torch.from_numpy(blk),
                                        torch.tensor(row0), shape=(16, 8),
                                        threshold=threshold, **kw)
        assert int(tovf) == int(jovf) == 0
        np.testing.assert_array_equal(np_(tps.valid), np_(jps.valid))
        np.testing.assert_array_equal(np_(tps.props["w"]),
                                      np_(jps.props["w"]))
        np.testing.assert_allclose(np_(tps.x), np_(jps.x), atol=1e-6)
        if threshold == 0.0:
            all_ps, _ = TRM.seed_from_mesh(torch.from_numpy(field), dim=2,
                                           **kw)
            sel = slice(row0 * 8, (row0 + 4) * 8)
            np.testing.assert_array_equal(np_(tps.x), np_(all_ps.x[sel]))
            np.testing.assert_array_equal(np_(tps.props["w"]),
                                          np_(all_ps.props["w"][sel]))


# --------------------------------------------------------------------------
# The pencil-block legs (p2m_block2, m2p_block2, seed_from_block2)
# --------------------------------------------------------------------------

PEN_KW = dict(shape=(16, 16, 8), box_lo=(0.0, 0.0, 0.0),
              box_hi=(2.0, 2.0, 1.0), periodic=(True, True, True))


def _pencil_case(seed, mesh, me, H=2):
    """Particles of a (16, 16, 8) mesh in a (2, 2, 1) box and the pencil
    block (owned rows and columns ± H halo nodes) of pencil ``me`` of a
    ``mesh`` = (rows, cols) decomposition: (x, val, mine, field, block
    rows, block cols, row0, col0)."""
    shape = PEN_KW["shape"]
    box_hi = np.asarray(PEN_KW["box_hi"], np.float32)
    rng = np.random.default_rng(seed)
    n = 600
    x = (rng.uniform(size=(n, 3)) * box_hi).astype(np.float32)
    val = rng.normal(size=(n, 3)).astype(np.float32)
    valid = rng.uniform(size=n) > 0.2
    field = rng.normal(size=shape + (3,)).astype(np.float32)
    n0l, n1l = shape[0] // mesh[0], shape[1] // mesh[1]
    h = box_hi[:2] / np.asarray(shape[:2], np.float32)
    node = np.floor(x[:, :2] / h).astype(np.int32)
    mine = (valid & (node[:, 0] // n0l == me[0])
            & (node[:, 1] // n1l == me[1]))
    return (x, val, mine, field, n0l + 2 * H, n1l + 2 * H,
            me[0] * n0l - H, me[1] * n1l - H)


# (mesh, pencil): a 2 × 2 pencil at the seam of both axes (row0 and col0
# < 0), one at the seam of the columns only, one inside both, and a 4 × 2
# pencil at the far side of the rows
PENCILS = [((2, 2), (0, 0)), ((2, 2), (1, 0)), ((2, 2), (1, 1)),
           ((4, 2), (3, 1))]


@pytest.mark.parametrize("mesh,me", PENCILS)
def test_pencil_block_legs_match_repro(mesh, me):
    """p2m_block2 onto the pencil's padded block and m2p_block2 from the
    halo_pad2-padded block (the periodic wrap of the global field) against
    repro's on the same inputs: rel <= 1e-5, no drops."""
    x, val, mine, field, rows, cols, row0, col0 = _pencil_case(
        21 + me[0] + 2 * me[1], mesh, me)
    j0, j1 = jnp.asarray(row0, jnp.int32), jnp.asarray(col0, jnp.int32)
    ref, drop_ref = JIP.p2m_block2(
        jnp.asarray(x), jnp.asarray(val), jnp.asarray(mine), j0, j1,
        block_rows=rows, block_cols=cols, **PEN_KW)
    tx, tval, tmine = _t(x, val, mine)
    t0, t1 = torch.tensor(row0), torch.tensor(col0)
    got, drop = TIP.p2m_block2(tx, tval, tmine, t0, t1, block_rows=rows,
                               block_cols=cols, **PEN_KW)
    assert got.shape == ref.shape and int(drop) == int(drop_ref) == 0
    assert rel(got, ref) <= TOL
    n0, n1 = PEN_KW["shape"][:2]
    blk = field[np.mod(np.arange(row0, row0 + rows), n0)][
        :, np.mod(np.arange(col0, col0 + cols), n1)]
    ur, dru = JIP.m2p_block2(jnp.asarray(blk), jnp.asarray(x),
                             jnp.asarray(mine), j0, j1, **PEN_KW)
    got_u, dr = TIP.m2p_block2(torch.from_numpy(blk), tx, tmine, t0, t1,
                               **PEN_KW)
    assert int(dr) == int(dru) == 0 and rel(got_u, ur) <= TOL
    # a scalar block
    sr, _ = JIP.m2p_block2(jnp.asarray(blk[..., 1]), jnp.asarray(x),
                           jnp.asarray(mine), j0, j1, **PEN_KW)
    got_s, _ = TIP.m2p_block2(torch.from_numpy(blk[..., 1].copy()), tx,
                              tmine, t0, t1, **PEN_KW)
    assert rel(got_s, sr) <= TOL


def test_pencil_support_leaving_the_block_is_dropped_whole():
    """A particle a pencil away on the column axis that claims to be owned
    is dropped and counted by both legs, as repro drops it."""
    x, val, mine, field, rows, cols, row0, col0 = _pencil_case(
        25, (2, 2), (1, 1))
    x, mine = x.copy(), mine.copy()
    k = int(np.flatnonzero(mine)[0])
    x[k, 1] = 0.3            # column 2: pencil column 0, not 1
    kw = dict(block_rows=rows, block_cols=cols, **PEN_KW)
    j0, j1 = jnp.asarray(row0, jnp.int32), jnp.asarray(col0, jnp.int32)
    ref, drop_ref = JIP.p2m_block2(jnp.asarray(x), jnp.asarray(val),
                                   jnp.asarray(mine), j0, j1, **kw)
    assert int(drop_ref) >= 1
    tx, tval, tmine = _t(x, val, mine)
    got, drop = TIP.p2m_block2(tx, tval, tmine, row0, col0, **kw)
    assert int(drop) == int(drop_ref) and rel(got, ref) <= TOL
    vals, drop_m = TIP.m2p_block2(tx.new_ones((rows, cols, 8)), tx, tmine,
                                  row0, col0, **PEN_KW)
    assert int(drop_m) == int(drop_ref) and float(vals[k]) == 0.0


@pytest.mark.parametrize("threshold", [0.0, 0.8])
def test_seed_from_block2_matches_repro(threshold):
    """The per-pencil re-seed of the pencil at the origin of both axes,
    of one at the far side of both and of one inside: validity and values
    exact against repro's, positions within repro's own 1e-6; the dense
    re-seed equals the nodes of the port's seed_from_mesh bit for bit."""
    shape = (16, 8, 4)
    kw = dict(shape=shape, box_lo=(0.0, 0.0, 0.0), box_hi=(2.0, 1.0, 0.5),
              periodic=(True, True, True))
    field = np.random.default_rng(6).normal(size=shape).astype(np.float32)
    for row0, col0 in ((0, 0), (12, 4), (4, 4)):
        blk = field[row0:row0 + 4, col0:col0 + 4]
        jps, jovf = JRM.seed_from_block2(
            jnp.asarray(blk), jnp.asarray(row0, jnp.int32),
            jnp.asarray(col0, jnp.int32), threshold=threshold, **kw)
        tps, tovf = TRM.seed_from_block2(
            torch.from_numpy(blk.copy()), torch.tensor(row0),
            torch.tensor(col0), threshold=threshold, **kw)
        assert int(tovf) == int(jovf) == 0
        np.testing.assert_array_equal(np_(tps.valid), np_(jps.valid))
        np.testing.assert_array_equal(np_(tps.props["w"]),
                                      np_(jps.props["w"]))
        np.testing.assert_allclose(np_(tps.x), np_(jps.x), atol=1e-6)
        if threshold == 0.0:
            all_ps, _ = TRM.seed_from_mesh(
                torch.from_numpy(field), dim=3,
                **{k: v for k, v in kw.items() if k != "shape"})
            sel = np.arange(np.prod(shape)).reshape(shape)[
                row0:row0 + 4, col0:col0 + 4].ravel()
            np.testing.assert_array_equal(np_(tps.x), np_(all_ps.x)[sel])
            np.testing.assert_array_equal(np_(tps.props["w"]),
                                          np_(all_ps.props["w"])[sel])


# --------------------------------------------------------------------------
# Mesh fields in the serial step
# --------------------------------------------------------------------------

def _j_toy_physics(cfg: ToyCfg):
    """repro's toy mesh physics (tests/distributed/test_dist_field.py),
    verbatim but for ``cell_cap`` (from the config)."""
    kw = dict(shape=cfg.shape, box_lo=(0.0, 0.0, 0.0), box_hi=cfg.box,
              periodic=(True, True, True))
    H = 2

    def body(dx, r2, ok, wi, wj):
        return {"f": JI.Radial(jnp.zeros_like(r2))}

    def advance(ps, red, extras):
        x = ps.x.at[:, 0].add(cfg.dt)
        x = jnp.mod(x, jnp.asarray(cfg.box, x.dtype))
        return ps.replace(x=jnp.where(ps.valid[:, None], x, ps.x))

    def finish(ctx):
        rho = ctx.fields["rho"]
        n_local = rho.shape[0]
        row0 = ctx.grid.first_row(n_local) - H
        mass = jnp.where(ctx.ps.valid, 1.0, 0.0)
        blk, drop = JIP.p2m_block(ctx.ps.x, mass, ctx.ps.valid, row0,
                                  block_rows=n_local + 2 * H, **kw)
        deposit = ctx.grid.ghost_put(blk, H)
        pad = ctx.grid.ghost_get(rho, 1)
        lap = (jnp.roll(pad, 1, 0) + jnp.roll(pad, -1, 0) - 2 * pad)[1:-1]
        rho = rho + cfg.diff * lap + deposit
        return ctx.ps, {}, ctx.red.max(drop), {"rho": rho}

    return JSIM.PhysicsSpec(
        name="toy_mesh", box_lo=(0.0, 0.0, 0.0), box_hi=cfg.box,
        periodic=(True, True, True), r_cut=0.5, cell_cap=cfg.cell_cap,
        pair_out={"f": "radial"}, make_body=lambda: body,
        advance=advance, finish=finish, mesh_props=("rho",))


def test_mesh_props_step_builds_serially():
    """make_sim_step for a physics with mesh_props and mesh=None builds
    (it raised before the mesh half was in), with the declared field in
    the state and first_row on the particles' device."""
    cfg = ToyCfg()
    step = TSIM.make_sim_step(toy_physics, cfg)
    assert TSIM.make_sim_step(toy_physics, cfg) is step
    ps = TSIM.with_ids(to_torch(j_from_positions(jnp.zeros((4, 3)))))
    st = TSIM.serial_state(ps, toy_physics, cfg,
                           fields={"rho": torch.zeros(cfg.shape)})
    st, flags, _ = step(st, {})
    assert int(flags.any()) == 0 and float(st.fields["rho"].sum()) > 3.99
    grid = TG.GridOps(None, device=ps.device)
    assert grid.first_row(8).device == ps.device


def test_toy_mesh_physics_matches_repro():
    """repro's toy mesh physics run serially for 6 steps in both packages
    from the same numpy particles: rho within 1e-5 (relative to its max),
    zero flags, deposits landed."""
    cfg = ToyCfg()
    rng = np.random.default_rng(21)
    x = (rng.uniform(0, 1, (cfg.n, 3)) * np.asarray(cfg.box)).astype(
        np.float32)
    jps = JSIM.with_ids(j_from_positions(jnp.asarray(x)))
    tps = to_torch(jps)
    js = JSIM.serial_state(jps, _j_toy_physics, cfg,
                           fields={"rho": jnp.zeros(cfg.shape, jnp.float32)})
    ts = TSIM.serial_state(tps, toy_physics, cfg,
                           fields={"rho": torch.zeros(cfg.shape)})
    j_step = JSIM.make_sim_step(_j_toy_physics, cfg)
    t_step = TSIM.make_sim_step(toy_physics, cfg)
    for _ in range(6):
        js, jf, _ = j_step(js, {})
        ts, tf, _ = t_step(ts, {})
        assert int(jf.any()) == int(tf.any()) == 0
    rho_j, rho_t = np_(js.fields["rho"]), np_(ts.fields["rho"])
    assert rho_t.sum() > cfg.n * 5
    assert np.abs(rho_t - rho_j).max() / np.abs(rho_j).max() <= TOL
    np.testing.assert_array_equal(np_(ts.ps.x), np_(js.ps.x))


# --------------------------------------------------------------------------
# Multigrid Poisson
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape,lengths,cycles", [
    ((32, 32), (1.0, 1.0), 20), ((16, 16, 8, 2), (2.0, 2.0, 1.0), 4)])
def test_multigrid_matches_repro(shape, lengths, cycles):
    """multigrid_poisson and residual_norm against repro's to MG_TOL
    (relative to the solution's max), a vector rhs solved per component;
    the solution agrees with fft_poisson(discrete=True) as repro's test
    asks."""
    rhs = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    dim = len(lengths)
    rhs = rhs - rhs.reshape((-1,) + shape[dim:]).mean(0)
    ref = JPS.multigrid_poisson(jnp.asarray(rhs), lengths, cycles=cycles)
    got = TPS.multigrid_poisson(torch.from_numpy(rhs), lengths,
                                cycles=cycles)
    assert got.shape == ref.shape and rel(got, ref) <= MG_TOL
    r_ref = float(JPS.residual_norm(ref, jnp.asarray(rhs), lengths))
    r_got = float(TPS.residual_norm(got, torch.from_numpy(rhs), lengths))
    assert abs(r_got - r_ref) <= MG_TOL * float(np.std(rhs)) + 1e-3 * r_ref
    if len(shape) == dim:
        fft = TPS.fft_poisson(torch.from_numpy(rhs), lengths, discrete=True)
        assert r_got < 1e-2 * float(np.std(rhs))
        np.testing.assert_allclose(np_(got - got.mean()),
                                   np_(fft - fft.mean()), atol=5e-3)


# --------------------------------------------------------------------------
# Verlet-list kernels and the LJ tile oracle
# --------------------------------------------------------------------------

def _verlet_inputs(n, seed):
    """tests/test_core.py's interaction-paths case with numpy draws."""
    x = np.random.default_rng(seed).uniform(size=(n, 2)).astype(np.float32)
    jps = j_from_positions(jnp.asarray(x), capacity=n + 7)
    jps = jps.with_prop("m", jnp.asarray(
        np.linspace(0.5, 1.5, n + 7).astype(np.float32)))
    kw = dict(box_lo=(0., 0.), box_hi=(1., 1.),
              grid_shape=JCL.grid_shape_for((0, 0), (1, 1), 0.25),
              periodic=(True, True), cell_cap=n + 7)
    return jps, to_torch(jps), kw


@pytest.mark.parametrize("n,seed", [(5, 0), (30, 1), (50, 2)])
def test_verlet_kernels_match_repro(n, seed, monkeypatch):
    """apply_kernel_verlet (in batches of 16) and apply_kernel_verlet_sym
    against repro's to 1e-5, a vector kernel and a dict kernel reading a
    prop; both agree with the cell path."""
    jps, tps, kw = _verlet_inputs(n, seed)
    jcl, tcl = JCL.build_cell_list(jps, **kw), TCL.build_cell_list(tps, **kw)
    kern_j = lambda dx, r2, wi, wj: dx * jnp.exp(-8 * r2)[..., None]
    kern_t = lambda dx, r2, wi, wj: dx * torch.exp(-8 * r2)[..., None]
    dkern_j = lambda dx, r2, wi, wj: {"s": wi["m"] * wj["m"]
                                      * jnp.exp(-8 * r2)}
    dkern_t = lambda dx, r2, wi, wj: {"s": wi["m"] * wj["m"]
                                      * torch.exp(-8 * r2)}
    for half in (False, True):
        jvl = JCL.build_verlet(jps, jcl, 0.25, k_max=n + 7, half=half)
        tvl = TCL.build_verlet(tps, tcl, 0.25, k_max=n + 7, half=half)
        if half:
            ref = JI.apply_kernel_verlet_sym(jps, jvl, jcl, kern_j)
            got = TI.apply_kernel_verlet_sym(tps, tvl, tcl, kern_t)
            dref = JI.apply_kernel_verlet_sym(jps, jvl, jcl, dkern_j, ("m",),
                                              antisymmetric=False)
            dgot = TI.apply_kernel_verlet_sym(tps, tvl, tcl, dkern_t, ("m",),
                                              antisymmetric=False)
        else:
            ref = JI.apply_kernel_verlet(jps, jvl, jcl, kern_j)
            got = TI.apply_kernel_verlet(tps, tvl, tcl, kern_t,
                                         batch_size=16)
            dref = JI.apply_kernel_verlet(jps, jvl, jcl, dkern_j, ("m",))
            dgot = TI.apply_kernel_verlet(tps, tvl, tcl, dkern_t, ("m",),
                                          batch_size=16)
        assert rel(got, ref) <= TOL and rel(dgot["s"], dref["s"]) <= TOL
        cells = TI.apply_kernel_cells(tps, tcl, kern_t, r_cut=0.25)
        assert float((got - cells).abs().max()) <= TOL


def test_lj_cell_forces_ref_matches_repro():
    """The LJ tile oracle against repro's on the MD case's tiles, and the
    lj_cell wrapper (the plain cell-pair version here) against it."""
    cfg, jps = case_state(BC.md_case)
    tps = to_torch(jps)
    t = TCP.gather_cell_tiles(tps, TCL.build_cell_list(tps,
                                                       **jmd._cl_kw(cfg)))
    kw = dict(sigma=cfg.sigma, epsilon=cfg.epsilon, r_cut=cfg.r_cut)
    got = TLJR.lj_cell_forces_ref(t.cell_x, t.nbr_x, t.cell_mask,
                                  t.nbr_mask, **kw)
    ref = JLJ.lj_cell_forces_ref(*(jnp.asarray(np_(a)) for a in (
        t.cell_x, t.nbr_x, t.cell_mask, t.nbr_mask)), **kw)
    assert rel(got, ref) <= TOL
    wrapped = TLJ.lj_cell_forces(t.cell_x, t.nbr_x, t.cell_mask, t.nbr_mask,
                                 **kw)
    assert rel(wrapped, got) <= TOL
