"""The CUDA kernels against their plain PyTorch versions, on the card
(B1 with the LJ, SPH and DEM functors, B3, B4).
Imports neither jax nor repro, so it runs on the GPU machine:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Every test skips where torch.cuda.is_available() is False."""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_bridge import interp_case, rel

from repro_torch.apps import vortex as TV
from repro_torch.kernels.m4_interp import m4_interp as TK
from repro_torch.kernels.m4_interp import ops as TM4

TOL = 1e-5      # fp32, only the summation order differs
CB = 4

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    torch.backends.cuda.matmul.allow_tf32 = False


def _tiles(dim, seed, edge):
    """Cell tiles of tests/test_kernels.py's interpolation case, bucketed
    on the card; (4, 2, 2) buckets in 3-D, so neighbours alias."""
    kw, x, val, valid, field = interp_case(dim, seed, edge_cluster=edge)
    t = lambda a: torch.from_numpy(np.array(a)).cuda()
    b = TM4.bucket_particles(t(x), t(valid), cell_cap=256, cb=CB, **kw)
    kk = dict(grid_cells=tuple(n // CB for n in kw["shape"]), cb=CB,
              box_lo=kw["box_lo"], box_hi=kw["box_hi"])
    return b, t(val)[b.safe.long()].contiguous(), t(field), kk


@pytest.mark.parametrize("dim,seed,edge", [(2, 0, False), (3, 1, False),
                                           (3, 2, True)])
def test_cuda_p2m_matches_plain(card, dim, seed, edge):
    b, cell_val, _, kk = _tiles(dim, seed, edge)
    n0 = TK.LAUNCHES["p2m"]
    got = TK.p2m_cells(b.cell_x, cell_val, b.cell_mask, **kk)
    assert TK.LAUNCHES["p2m"] == n0 + 1
    ref = TK.p2m_cells_torch(b.cell_x, cell_val, b.cell_mask, **kk)
    torch.cuda.synchronize()
    assert rel(got, ref) <= TOL
    with pytest.raises(NotImplementedError, match="B3/B4"):
        TK.p2m_cells(b.cell_x, cell_val, b.cell_mask, precision="bf16x",
                     **kk)


@pytest.mark.parametrize("dim,seed,edge", [(2, 3, False), (3, 4, False),
                                           (3, 5, True)])
def test_cuda_m2p_matches_plain(card, dim, seed, edge):
    b, _, field, kk = _tiles(dim, seed, edge)
    field = torch.cat([field, field[..., :1] * 2.0], -1).contiguous()  # C=4
    n0 = TK.LAUNCHES["m2p"]
    got = TK.m2p_cells(field, b.cell_x, b.cell_mask, **kk)
    assert TK.LAUNCHES["m2p"] == n0 + 1
    ref = TK.m2p_cells_torch(field, b.cell_x, b.cell_mask, **kk)
    torch.cuda.synchronize()
    assert rel(got, ref) <= TOL
    with pytest.raises(NotImplementedError, match="B3/B4"):
        TK.m2p_cells(field, b.cell_x, b.cell_mask, precision="bf16x", **kk)


def test_vortex_kernel_path_matches_plain_path(card):
    """5 steps at (16, 8, 8): the CUDA kernels (backend auto) against the
    plain versions (backend torch), and 2 + 2 launches per step."""
    cfg = TV.VortexConfig(shape=(16, 8, 8), lengths=(4.0, 2.0, 2.0),
                          dt=0.02, device="cuda")
    n0 = dict(TK.LAUNCHES)
    redo0 = TV.REDOS
    wk, _, _ = TV.run(cfg, 5)
    per = 10 + 2 * (TV.REDOS - redo0)
    assert TK.LAUNCHES["p2m"] - n0["p2m"] == per
    assert TK.LAUNCHES["m2p"] - n0["m2p"] == per
    wp, _, _ = TV.run(dataclasses.replace(cfg, backend="torch"), 5)
    torch.cuda.synchronize()
    assert rel(wk, wp) <= 1e-4


def test_cuda_cell_pair_matches_plain(card):
    """B1 against cell_pair_torch on the tiles of a small MD state stepped
    on the card (tests/test_torch_cell_pair.py holds the same check on
    repro's md_case state, where jax is installed)."""
    from repro_torch.apps import md
    from repro_torch.core import cell_list as CL
    from repro_torch.kernels.cell_pair import cell_pair as CP
    cfg = md.MDConfig(n_per_side=6, sigma=0.085, device="cuda")
    ps, _ = md.run(cfg, 5, thermal_v=0.4, seed=3)
    t = CP.gather_cell_tiles(ps, CL.build_cell_list(ps, **md._cl_kw(cfg)))
    args = (t.cell_x, t.nbr_x, t.cell_mask, t.nbr_mask)
    kw = dict(body=md.lj_pair_body(cfg.sigma, cfg.epsilon),
              out={"f": "radial"}, r_cut=cfg.r_cut)
    n0 = CP.LAUNCHES
    got = CP.cell_pair(*args, **kw)["f"]
    assert CP.LAUNCHES == n0 + 1
    ref = CP.cell_pair_torch(*args, **kw)["f"]
    torch.cuda.synchronize()
    assert rel(got, ref) <= TOL


def _pair_tiles(dim, C, cc, K, box, seed):
    """Random cell tiles (numpy draws) on the card: positions in a small
    box so most pairs are inside the cutoff, velocities N(0, 1),
    densities rho0 (1 + 0.02 N(0, 1)), about 20% of slots empty."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()
    f32 = lambda *s: rng.uniform(size=s).astype(np.float32)
    return dict(
        cell_x=t(box * f32(C, cc, dim)), nbr_x=t(box * f32(C, K * cc, dim)),
        cell_mask=t(f32(C, cc) > 0.2), nbr_mask=t(f32(C, K * cc) > 0.2),
        cell_v=t(rng.normal(size=(C, cc, dim)).astype(np.float32)),
        nbr_v=t(rng.normal(size=(C, K * cc, dim)).astype(np.float32)),
        cell_rho=t((1000.0 * (1 + 0.02 * rng.normal(size=(C, cc))))
                   .astype(np.float32)),
        nbr_rho=t((1000.0 * (1 + 0.02 * rng.normal(size=(C, K * cc))))
                  .astype(np.float32)))


@pytest.mark.parametrize("dim,C,cc", [(2, 6, 16), (3, 4, 16), (3, 3, 128)])
def test_cuda_sph_functor_matches_plain(card, dim, C, cc):
    """B1-SPH against cell_pair_torch on random tiles; cc=128 at dim 3 is
    the card size's 110.6 KB of staged candidates (above the 48 KB
    default)."""
    from repro_torch.apps import sph
    from repro_torch.kernels.cell_pair import cell_pair as CP
    cfg = sph.SPHConfig(dim=dim, dp=0.05, box=(1.0, 0.5, 0.5)[:dim],
                        fluid=(0.25,) * dim, device="cuda")
    tl = _pair_tiles(dim, C, cc, 3 ** dim, 0.2, seed=10 + dim + cc)
    args = (tl["cell_x"], tl["nbr_x"], tl["cell_mask"], tl["nbr_mask"],
            {"v": tl["cell_v"], "rho": tl["cell_rho"]},
            {"v": tl["nbr_v"], "rho": tl["nbr_rho"]})
    kw = dict(body=sph.sph_pair_body(cfg),
              out={"a": "radial", "drho": "scalar"}, r_cut=cfg.r_cut)
    n0 = dict(CP.LAUNCHES_BY_KIND)
    got = CP.cell_pair(*args, **kw)
    assert CP.LAUNCHES_BY_KIND["sph"] == n0["sph"] + 1
    ref = CP.cell_pair_torch(*args, **kw)
    torch.cuda.synchronize()
    for name in ("a", "drho"):
        assert rel(got[name], ref[name]) <= TOL, name
    with pytest.raises(NotImplementedError, match="fp32 only"):
        CP.cell_pair(*args, precision="bf16x:drho", **kw)


def test_cuda_dem_functor_matches_plain(card):
    """B1-DEM against cell_pair_torch on random tiles of overlapping
    grains (2R = 0.12 in a 0.3 box)."""
    from repro_torch.apps import dem
    from repro_torch.kernels.cell_pair import cell_pair as CP
    cfg = dem.DEMConfig(device="cuda")
    tl = _pair_tiles(3, 5, 24, 27, 0.3, seed=3)
    args = (tl["cell_x"], tl["nbr_x"], tl["cell_mask"], tl["nbr_mask"],
            {"v": tl["cell_v"]}, {"v": tl["nbr_v"]})
    kw = dict(body=dem.dem_normal_body(cfg), out={"f": "radial"},
              r_cut=cfg.r_cut)
    n0 = dict(CP.LAUNCHES_BY_KIND)
    got = CP.cell_pair(*args, **kw)["f"]
    assert CP.LAUNCHES_BY_KIND["dem"] == n0["dem"] + 1
    ref = CP.cell_pair_torch(*args, **kw)["f"]
    torch.cuda.synchronize()
    assert float(ref.abs().max()) > 1.0
    assert rel(got, ref) <= TOL
    with pytest.raises(NotImplementedError, match="fp32 only"):
        CP.cell_pair(*args, precision="bf16x", **kw)


def test_sph_and_dem_kernel_path_match_plain_path(card):
    """A few steps of the small 2-D dam break and the small avalanche
    through the kernels (backend auto) against the plain path, one launch
    per step."""
    from repro_torch.apps import dem, sph
    from repro_torch.kernels.cell_pair import cell_pair as CP
    cfg = sph.SPHConfig(dp=0.04, box=(1.0, 0.5), fluid=(0.25, 0.25),
                        device="cuda")
    n0 = CP.LAUNCHES_BY_KIND["sph"]
    pk, tk = sph.run(cfg, 5)
    assert CP.LAUNCHES_BY_KIND["sph"] == n0 + 5
    pp, tp = sph.run(dataclasses.replace(cfg, backend="torch"), 5)
    assert rel(pk.props["v"], pp.props["v"]) <= 1e-4
    assert rel(pk.props["rho"], pp.props["rho"]) <= 1e-4
    assert abs(tk - tp) <= 1e-5 * tp
    dcfg = dem.DEMConfig(box=(2.0, 0.6, 1.0), fill=(0.8, 0.66, 0.5),
                         device="cuda")
    ps = dem.init_block(dcfg)
    rng = np.random.default_rng(1)
    v = torch.from_numpy(0.3 * rng.normal(size=tuple(ps.props["v"].shape))
                         .astype(np.float32)).cuda()
    ps = ps.with_prop("v", torch.where(ps.valid[:, None], v,
                                       torch.zeros_like(v)))
    pk, pp = ps, ps
    n0 = CP.LAUNCHES_BY_KIND["dem"]
    for _ in range(5):
        pk, fk = dem.dem_step(pk, dcfg)
        pp, fp = dem.dem_step(pp, dataclasses.replace(dcfg, backend="torch"))
        assert int(fk.any()) == 0 and int(fp.any()) == 0
    assert CP.LAUNCHES_BY_KIND["dem"] == n0 + 5
    for name in ("v", "w"):
        assert rel(pk.props[name], pp.props[name]) <= 1e-4, name
