"""repro_torch M'4 cell path against repro: bucketing (exact integer
structures, overflow included), the plain P2M/M2P tile versions against
the Pallas kernels in interpret mode on the same tiles (the (4, 2, 2)
bucket grid aliases neighbours), the ops layer against the scatter oracle,
the fused gather and moment conservation. The CUDA kernels are held
against these plain versions in tests/test_torch_gpu.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import interp_case, np_, rel

from repro.core import interp as JIP
from repro.kernels.m4_interp import m4_interp as JK
from repro.kernels.m4_interp import ops as JM4
from repro_torch.core import interp as TIP
from repro_torch.core import remesh as TRM
from repro_torch.kernels.m4_interp import m4_interp as TK
from repro_torch.kernels.m4_interp import ops as TM4
from repro_torch.kernels.m4_interp import ref as TREF

TOL = 1e-5      # fp32, only the summation order differs
CB = 4


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _tiles(dim, seed, edge=False, cell_cap=256):
    """Both packages' inputs from one numpy case: the reference's buckets
    (as numpy) and the kernel-layer keyword arguments."""
    kw, x, val, valid, field = interp_case(dim, seed, edge_cluster=edge)
    jb = JM4.bucket_particles(jnp.asarray(x), jnp.asarray(valid),
                              cell_cap=cell_cap, cb=CB, **kw)
    safe = np.asarray(jb.safe)
    tiles = dict(cell_x=np.asarray(jb.cell_x),
                 cell_mask=np.asarray(jb.cell_mask),
                 cell_val=val[safe], field=field)
    kk = dict(grid_cells=tuple(n // CB for n in kw["shape"]), cb=CB,
              box_lo=kw["box_lo"], box_hi=kw["box_hi"])
    return kw, x, val, valid, tiles, kk


@pytest.mark.parametrize("dim,cell_cap", [(2, 0), (3, 0), (3, 256), (3, 6),
                                          (2, 4)])
def test_bucket_particles_exact(dim, cell_cap):
    """safe, cell_mask, cell_x and overflow equal repro's exactly; a small
    cell_cap drops the same count."""
    kw, x, _, valid, _ = interp_case(dim, 20 + dim)
    jb = JM4.bucket_particles(jnp.asarray(x), jnp.asarray(valid),
                              cell_cap=cell_cap, cb=CB, **kw)
    tb = TM4.bucket_particles(*_t(x, valid), cell_cap=cell_cap, cb=CB, **kw)
    for name in ("safe", "cell_mask", "cell_x"):
        np.testing.assert_array_equal(np_(getattr(tb, name)),
                                      np.asarray(getattr(jb, name)),
                                      err_msg=name)
    assert int(tb.overflow) == int(jb.overflow)
    if cell_cap and cell_cap < 10:
        assert int(tb.overflow) > 0


@pytest.mark.parametrize("dim,seed,edge", [(2, 0, False), (3, 1, False),
                                           (3, 2, True)])
def test_p2m_cells_torch_matches_pallas(dim, seed, edge):
    _, _, _, _, t, kk = _tiles(dim, seed, edge)
    ref = JK.p2m_cells(jnp.asarray(t["cell_x"]), jnp.asarray(t["cell_val"]),
                       jnp.asarray(t["cell_mask"]), interpret=True, **kk)
    got = TK.p2m_cells_torch(*_t(t["cell_x"], t["cell_val"],
                                 t["cell_mask"]), **kk)
    assert got.shape == ref.shape
    assert rel(got, ref) <= TOL
    # the dispatching entry takes the plain version for CPU tensors
    n0 = dict(TK.LAUNCHES)
    got2 = TK.p2m_cells(*_t(t["cell_x"], t["cell_val"], t["cell_mask"]),
                        **kk)
    assert torch.equal(got, got2) and TK.LAUNCHES == n0


@pytest.mark.parametrize("dim,seed,edge", [(2, 3, False), (3, 4, False),
                                           (3, 5, True)])
def test_m2p_cells_torch_matches_pallas(dim, seed, edge):
    _, _, _, _, t, kk = _tiles(dim, seed, edge)
    rng = np.random.default_rng(seed)
    field = np.concatenate(
        [t["field"], rng.normal(size=t["field"].shape[:-1] + (1,))
         .astype(np.float32)], -1)                       # C = 4
    ref = JK.m2p_cells(jnp.asarray(field), jnp.asarray(t["cell_x"]),
                       jnp.asarray(t["cell_mask"]), interpret=True, **kk)
    got = TK.m2p_cells_torch(*_t(field, t["cell_x"], t["cell_mask"]), **kk)
    assert got.shape == ref.shape
    assert rel(got, ref) <= TOL


@pytest.mark.parametrize("kernel", ["p2m", "m2p"])
def test_cells_torch_batch_loop_matches_pallas(kernel, monkeypatch):
    """The plain versions' batch loop: 16 cells in batches of 5 (the last
    one short) against the Pallas kernels on the same tiles."""
    _, _, _, _, t, kk = _tiles(3, 9, edge=True)
    assert t["cell_x"].shape[0] > 2 * 5
    monkeypatch.setattr(TK, "_CELL_BATCH", 5)
    if kernel == "p2m":
        args = (t["cell_x"], t["cell_val"], t["cell_mask"])
        ref = JK.p2m_cells(*map(jnp.asarray, args), interpret=True, **kk)
        got = TK.p2m_cells_torch(*_t(*args), **kk)
    else:
        args = (t["field"], t["cell_x"], t["cell_mask"])
        ref = JK.m2p_cells(*map(jnp.asarray, args), interpret=True, **kk)
        got = TK.m2p_cells_torch(*_t(*args), **kk)
    assert got.shape == ref.shape
    assert rel(got, ref) <= TOL


def test_p2m_cells_torch_large_cell_cap_matches_pallas():
    """cell_cap 2048 at cb 8 (cb 8's first re-provision doubles its
    default 2·8^3): the plain P2M against repro's Pallas kernel, which
    sets no capacity limit; the CUDA P2M kernel takes it too (held
    against the plain version in tests/test_torch_gpu.py)."""
    kw, x, val, valid, _ = interp_case(3, 31, n=3000)
    jb = JM4.bucket_particles(jnp.asarray(x), jnp.asarray(valid),
                              cell_cap=2048, cb=8, **kw)
    assert int(jb.overflow) == 0
    assert int(np.asarray(jb.cell_mask).sum(1).max()) > 1024
    args = (np.asarray(jb.cell_x), val[np.asarray(jb.safe)],
            np.asarray(jb.cell_mask))
    kk = dict(grid_cells=tuple(n // 8 for n in kw["shape"]), cb=8,
              box_lo=kw["box_lo"], box_hi=kw["box_hi"])
    ref = JK.p2m_cells(*map(jnp.asarray, args), interpret=True, **kk)
    got = TK.p2m_cells_torch(*_t(*args), **kk)
    assert got.shape == ref.shape
    assert rel(got, ref) <= TOL


def test_cells_torch_bf16x_matches_pallas():
    """bf16x: bf16 weight and value operands, fp32 sums, as the Pallas
    kernels. An operand one fp32 ulp apart on the two sides may round to
    neighbouring bf16 values (relative 2^-8), so the bound is 4e-3."""
    _, _, _, _, t, kk = _tiles(3, 6)
    ref = JK.p2m_cells(jnp.asarray(t["cell_x"]), jnp.asarray(t["cell_val"]),
                       jnp.asarray(t["cell_mask"]), interpret=True,
                       precision="bf16x", **kk)
    got = TK.p2m_cells_torch(*_t(t["cell_x"], t["cell_val"],
                                 t["cell_mask"]), precision="bf16x", **kk)
    assert rel(got, ref) <= 4e-3
    ref = JK.m2p_cells(jnp.asarray(t["field"]), jnp.asarray(t["cell_x"]),
                       jnp.asarray(t["cell_mask"]), interpret=True,
                       precision="bf16x", **kk)
    got = TK.m2p_cells_torch(*_t(t["field"], t["cell_x"], t["cell_mask"]),
                             precision="bf16x", **kk)
    assert rel(got, ref) <= 4e-3


@pytest.mark.parametrize("dim,seed,edge", [(2, 0, False), (3, 1, False),
                                           (2, 2, True), (3, 3, True)])
def test_ops_p2m_m2p_match_oracle(dim, seed, edge):
    """The cell path against the scatter oracle, as
    tests/test_kernels.py::test_m4_p2m_matches_oracle / m2p."""
    kw, x, val, valid, field = interp_case(dim, seed, edge_cluster=edge)
    tx, tv, tvalid, tf = _t(x, val, valid, field)
    f_ref = JIP.p2m(jnp.asarray(x), jnp.asarray(val), jnp.asarray(valid),
                    **kw)
    f_got = TM4.p2m(tx, tv, tvalid, cell_cap=256, **kw)
    assert rel(f_got, f_ref) <= TOL
    assert rel(f_got, TREF.p2m_ref(tx, tv, tvalid, **kw)) <= TOL
    g_ref = JIP.m2p(jnp.asarray(field), jnp.asarray(x), jnp.asarray(valid),
                    **kw)
    g_got, ovf = TM4.m2p(tf, tx, tvalid, cell_cap=256, return_overflow=True,
                         **kw)
    assert int(ovf) == 0
    assert rel(g_got, g_ref) <= TOL
    assert rel(g_got, TREF.m2p_ref(tf, tx, tvalid, **kw)) <= TOL


def test_m2p_fused_matches_per_field_oracle():
    """One fused pass over (vector u, scalar r) == two oracle gathers."""
    kw, x, _, valid, u = interp_case(3, 7)
    r = np.random.default_rng(7).normal(size=kw["shape"]).astype(np.float32)
    tx, tvalid, tu, tr = _t(x, valid, u, r)
    up, rp = TM4.m2p_fused((tu, tr), tx, tvalid, cell_cap=256, **kw)
    assert up.shape == (x.shape[0], 3) and rp.shape == (x.shape[0],)
    ur, rr = TREF.m2p_fused_ref((tu, tr), tx, tvalid, **kw)
    np.testing.assert_allclose(np_(up), np_(ur), atol=1e-5)
    np.testing.assert_allclose(np_(rp), np_(rr), atol=1e-5)
    for got, f in ((up, u), (rp, r)):
        ref = JIP.m2p(jnp.asarray(f), jnp.asarray(x), jnp.asarray(valid),
                      **kw)
        assert rel(got, ref) <= TOL


@pytest.mark.parametrize("interp", ["scatter", "cells"])
def test_p2m_moment_conservation(interp):
    """Σ mesh == Σ particle values (0th) and Σ x·m matches (1st); interior
    particles, as tests/test_kernels.py::test_m4_p2m_moment_conservation."""
    dim = 3
    shape = (16, 8, 8)
    box_hi = (2.0, 1.0, 1.0)
    kw = dict(shape=shape, box_lo=(0.0,) * dim, box_hi=box_hi,
              periodic=(True,) * dim)
    rng = np.random.default_rng(11)
    x = ((0.3 + 0.4 * rng.uniform(size=(300, dim)))
         * np.asarray(box_hi)).astype(np.float32)
    val = (1.0 + rng.uniform(size=300)).astype(np.float32)
    tx, tv = _t(x, val)
    valid = torch.ones(300, dtype=torch.bool)
    if interp == "scatter":
        f = TIP.p2m(tx, tv, valid, **kw)
    else:
        f = TM4.p2m(tx, tv, valid, cell_cap=256, **kw)
    np.testing.assert_allclose(float(f.sum()), float(val.sum()), rtol=1e-5)
    nodes = TRM.node_positions(shape, kw["box_lo"], box_hi, kw["periodic"])
    m1_mesh = np_(nodes.T.double() @ f.reshape(-1).double())
    m1_part = x.T.astype(np.float64) @ val.astype(np.float64)
    np.testing.assert_allclose(m1_mesh, m1_part, rtol=1e-4)


def test_layout_errors_match_repro():
    kw, x, val, valid, _ = interp_case(3, 8)
    tx, tv, tvalid = _t(x, val, valid)
    with pytest.raises(ValueError, match="cb=1"):
        TM4.p2m(tx, tv, tvalid, cb=1, **kw)
    with pytest.raises(ValueError, match="not divisible"):
        TM4.p2m(tx, tv, tvalid, cb=3, **kw)
    with pytest.raises(NotImplementedError, match="periodic"):
        TM4.p2m(tx, tv, tvalid, **dict(kw, periodic=(True, False, True)))
    with pytest.raises(ValueError, match="unknown backend"):
        TM4.p2m(tx, tv, tvalid, backend="pallas", **kw)
