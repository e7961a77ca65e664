"""repro_torch cell-pair engine against repro: tile gather, the plain tile
version against the Pallas kernel (interpret mode), the generic pair-body
engine against the jnp oracle, the self-exclusion rule, the precision
grammar, and (on a card only) the CUDA kernel against its plain version."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import case_state, np_, rel, to_torch
from benchmarks import backend_compare as BC

from repro.apps import md as jmd
from repro.core import cell_list as JCL
from repro.core import interactions as JI
from repro.core import particles as JP
from repro.kernels.cell_pair import cell_pair as JCP
from repro_torch.apps import md as tmd
from repro_torch.core import cell_list as TCL
from repro_torch.core import interactions as TI
from repro_torch.kernels.cell_pair import cell_pair as TCP

LJ_OUT = {"f": "radial"}


def _md_tiles(prop_names=()):
    cfg, jps = case_state(BC.md_case)
    kw = jmd._cl_kw(cfg)
    tps = to_torch(jps)
    jt = JCP.gather_cell_tiles(jps, JCL.build_cell_list(jps, **kw),
                               prop_names)
    tt = TCP.gather_cell_tiles(tps, TCL.build_cell_list(tps, **kw),
                               prop_names)
    return cfg, jt, tt


def test_gather_cell_tiles_exact():
    _, jt, tt = _md_tiles(prop_names=("v",))
    for field in ("rows", "cell_x", "nbr_x", "cell_mask", "nbr_mask"):
        np.testing.assert_array_equal(np_(getattr(tt, field)),
                                      np_(getattr(jt, field)), err_msg=field)
    np.testing.assert_array_equal(np_(tt.props_i["v"]), np_(jt.props_i["v"]))
    np.testing.assert_array_equal(np_(tt.props_j["v"]), np_(jt.props_j["v"]))


def test_scatter_slots_matches():
    """Slot→particle scatter equals repro's, radial and scalar layouts."""
    _, jt, tt = _md_tiles()
    rng = np.random.default_rng(6)
    cap = 280
    for shape in (tuple(jt.cell_x.shape), tuple(jt.cell_mask.shape)):
        val = rng.normal(size=shape).astype(np.float32)
        ref = JCP.scatter_slots(jt.rows, jnp.asarray(val), cap)
        got = TCP.scatter_slots(tt.rows, torch.from_numpy(val), cap)
        np.testing.assert_array_equal(np_(got), np_(ref))


def test_cell_pair_torch_matches_pallas_lj():
    cfg, jt, tt = _md_tiles()
    ref = JCP.cell_pair_pallas(
        jt.cell_x, jt.nbr_x, jt.cell_mask, jt.nbr_mask,
        body=jmd.lj_pair_body(cfg.sigma, cfg.epsilon), out=LJ_OUT,
        r_cut=cfg.r_cut, interpret=True)["f"]
    got = TCP.cell_pair_torch(
        tt.cell_x, tt.nbr_x, tt.cell_mask, tt.nbr_mask,
        body=tmd.lj_pair_body(cfg.sigma, cfg.epsilon), out=LJ_OUT,
        r_cut=cfg.r_cut, cell_batch=5)["f"]
    assert got.shape == tuple(ref.shape)
    assert rel(got, ref) <= 1e-5


def _gauss_jax(dx, r2, ok, wi, wj):
    w = wi["q"] * wj["q"] * jnp.exp(-8.0 * r2)
    return {"f": JI.Radial(w), "rho": w}


def _gauss_torch(dx, r2, ok, wi, wj):
    w = wi["q"] * wj["q"] * torch.exp(-8.0 * r2)
    return {"f": TI.Radial(w), "rho": w}


@pytest.mark.parametrize("grid_r_cut,n", [(0.26, 40), (0.45, 25)])
def test_engine_generic_body_matches_jnp(grid_r_cut, n):
    """tests/test_cell_pair.py's Gaussian body on a periodic 2-D box (the
    0.45 cutoff gives a 2x2 grid): the port's plain engine and its tile
    path both match repro's jnp oracle, radial and scalar outputs."""
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    q = (1.0 + rng.uniform(0, 1, n)).astype(np.float32)
    jps = JP.from_positions(jnp.asarray(x), capacity=n + 6,
                            props={"q": jnp.asarray(q)})
    tps = to_torch(jps)
    gs = JCL.grid_shape_for((0, 0), (1, 1), grid_r_cut)
    ckw = dict(box_lo=(0., 0.), box_hi=(1., 1.), grid_shape=gs,
               periodic=(True, True), cell_cap=n + 6)
    kw = dict(out={"f": "radial", "rho": "scalar"}, r_cut=grid_r_cut,
              prop_names=("q",))
    ref = JI.apply_pair_kernel(jps, JCL.build_cell_list(jps, **ckw),
                               _gauss_jax, backend="jnp", **kw)
    tcl = TCL.build_cell_list(tps, **ckw)
    got = TI.apply_pair_kernel(tps, tcl, _gauss_torch, backend="torch",
                               cell_batch=3, **kw)
    t = TCP.gather_cell_tiles(tps, tcl, ("q",))
    tiles = TCP.cell_pair(t.cell_x, t.nbr_x, t.cell_mask, t.nbr_mask,
                          t.props_i, t.props_j, body=_gauss_torch,
                          out=kw["out"], r_cut=grid_r_cut)
    for name in ("f", "rho"):
        assert rel(got[name], ref[name]) <= 1e-5
        via_tiles = TCP.scatter_slots(t.rows, tiles[name], tps.capacity)
        via_tiles = torch.where(TI._bmask(tps.valid, via_tiles), via_tiles,
                                torch.zeros_like(via_tiles))
        assert rel(via_tiles, ref[name]) <= 1e-5


def test_coincident_distinct_particles_excluded():
    """Two distinct particles at one position: the tile engine excludes the
    pair by r2 > 1e-12 (the Pallas rule), as does every pair-body path;
    a raw kernel through apply_kernel_cells counts it (slot identity
    only), in repro and in the port alike."""
    x = np.array([[0.5, 0.5, 0.5], [0.5, 0.5, 0.5], [0.6, 0.5, 0.5],
                  [0.2, 0.3, 0.4]], np.float32)
    jps = JP.from_positions(jnp.asarray(x), capacity=6)
    tps = to_torch(jps)
    ckw = dict(box_lo=(0.,) * 3, box_hi=(1.,) * 3, grid_shape=(3, 3, 3),
               periodic=(True,) * 3, cell_cap=8)
    jcl, tcl = JCL.build_cell_list(jps, **ckw), TCL.build_cell_list(tps, **ckw)
    out = {"f": "radial", "n": "scalar"}
    jbody = lambda dx, r2, ok, wi, wj: {"f": JI.Radial(jnp.exp(-4.0 * r2)),
                                        "n": jnp.ones_like(r2)}
    tbody = lambda dx, r2, ok, wi, wj: {"f": TI.Radial(torch.exp(-4.0 * r2)),
                                        "n": torch.ones_like(r2)}
    pallas = JI.apply_pair_kernel(jps, jcl, jbody, out=out, r_cut=0.3,
                                  backend="pallas", interpret=True)
    t = TCP.gather_cell_tiles(tps, tcl)
    tiles = TCP.cell_pair(t.cell_x, t.nbr_x, t.cell_mask, t.nbr_mask,
                          body=tbody, out=out, r_cut=0.3)
    n_tiles = TCP.scatter_slots(t.rows, tiles["n"], tps.capacity)
    np.testing.assert_array_equal(np_(n_tiles), np_(pallas["n"]))
    assert np_(n_tiles)[:4].tolist() == [1.0, 1.0, 2.0, 0.0]
    f_tiles = TCP.scatter_slots(t.rows, tiles["f"], tps.capacity)
    np.testing.assert_allclose(np_(f_tiles), np_(pallas["f"]), atol=1e-6)
    plain = TI.apply_pair_kernel(tps, tcl, tbody, out=out, r_cut=0.3,
                                 backend="torch")
    np.testing.assert_array_equal(np_(plain["n"]), np_(pallas["n"]))

    jraw = lambda dx, r2, wi, wj: jnp.where(r2 < 0.09, 1.0, 0.0)
    traw = lambda dx, r2, wi, wj: torch.where(r2 < 0.09, 1.0, 0.0)
    a = JI.apply_kernel_cells(jps, jcl, jraw, r_cut=0.3)
    b = TI.apply_kernel_cells(tps, tcl, traw, r_cut=0.3)
    np.testing.assert_array_equal(np_(b), np_(a))
    assert np_(b)[:4].tolist() == [2.0, 2.0, 2.0, 0.0]


@pytest.mark.parametrize("precision", [
    "fp64", "fp32:f", "bf16x:nope", "bf16x:f,nope", "bf16x:f",
    "bf16x:rho", "bf16x", "fp32"])
def test_parse_precision_same_grammar(precision):
    out = {"f": "radial", "rho": "scalar"}
    try:
        ref = JI.parse_precision(precision, out)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            TI.parse_precision(precision, out)
        assert str(got.value) == str(e)
    else:
        assert TI.parse_precision(precision, out) == ref


def test_bf16x_plain_matches_jax_bf16x():
    """bf16 rounds at other places in the two frameworks: 1e-2."""
    cfg, jps = case_state(BC.md_case)
    ref = jmd.compute_forces(jps, dataclasses.replace(
        cfg, precision="bf16x"))[0]
    tcfg = tmd.MDConfig(n_per_side=cfg.n_per_side, device="cpu",
                        precision="bf16x")
    got = tmd.compute_forces(to_torch(jps), tcfg)[0]
    assert rel(got.props["f"], ref.props["f"]) <= 1e-2
    fp32 = tmd.compute_forces(to_torch(jps), tmd.MDConfig(
        n_per_side=cfg.n_per_side, device="cpu"))[0]
    assert rel(got.props["f"], fp32.props["f"]) > 0   # bf16 really used


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_on_card():
    """The CUDA kernel against cell_pair_torch on md_case's tiles, on the
    card, in fp32 and in bf16x; a body without a hand functor (the
    Gaussian) launches the functor generated from it and matches plain,
    and a body with an op the generator does not take raises there."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    cfg, _, tt = _md_tiles()
    args = [a.cuda() for a in (tt.cell_x, tt.nbr_x, tt.cell_mask,
                               tt.nbr_mask)]
    body = tmd.lj_pair_body(cfg.sigma, cfg.epsilon)
    n0 = TCP.LAUNCHES
    got = TCP.cell_pair(*args, body=body, out=LJ_OUT, r_cut=cfg.r_cut)["f"]
    assert TCP.LAUNCHES == n0 + 1
    ref = TCP.cell_pair_torch(*args, body=body, out=LJ_OUT,
                              r_cut=cfg.r_cut)["f"]
    torch.cuda.synchronize()
    assert rel(got, ref) <= 1e-5
    q = torch.linspace(1.0, 2.0, tt.cell_x.shape[0] * tt.cell_x.shape[1]
                       ).reshape(tt.cell_mask.shape).cuda()
    qj = torch.linspace(1.0, 2.0, tt.nbr_x.shape[0] * tt.nbr_x.shape[1]
                        ).reshape(tt.nbr_mask.shape).cuda()
    gkw = dict(body=_gauss_torch, out={"f": "radial", "rho": "scalar"},
               r_cut=cfg.r_cut)
    n0 = TCP.LAUNCHES
    gen = TCP.cell_pair(*args, {"q": q}, {"q": qj}, **gkw)
    assert TCP.LAUNCHES == n0 + 1
    gref = TCP.cell_pair_torch(*args, {"q": q}, {"q": qj}, **gkw)
    torch.cuda.synchronize()
    assert rel(gen["f"], gref["f"]) <= 1e-5
    assert rel(gen["rho"], gref["rho"]) <= 1e-5

    def cum(dx, r2, ok, wi, wj):
        return {"f": TI.Radial(torch.cumsum(r2, -1))}

    with pytest.raises(NotImplementedError, match="aten.cumsum"):
        TCP.cell_pair(*args, body=cum, out=LJ_OUT, r_cut=cfg.r_cut)
    n0 = TCP.LAUNCHES_BY_KIND["lj_bf16x"]
    got16 = TCP.cell_pair(*args, body=body, out=LJ_OUT, r_cut=cfg.r_cut,
                          precision="bf16x")["f"]
    assert TCP.LAUNCHES_BY_KIND["lj_bf16x"] == n0 + 1
    ref16 = TCP.cell_pair_torch(*args, body=body, out=LJ_OUT,
                                r_cut=cfg.r_cut, precision="bf16x")["f"]
    torch.cuda.synchronize()
    assert rel(got16, ref16) <= 1e-5    # the same roundings: sum order only
    assert rel(got16, got) > 0          # bf16 really used
