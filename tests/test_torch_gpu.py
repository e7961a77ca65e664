"""The CUDA kernels against their plain PyTorch versions, on the card
(B1 with the LJ, SPH and DEM functors, B2, B3, B4; fp32 and bf16x; B5,
the flash attention, in fp32 and bf16, and the dense LM path through it).
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
# bf16x: the same bf16 roundings, in the same order, on both paths, so
# only the summation order differs, as in fp32
BF16_TOL = TOL
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
    n0, n0_bf16 = TK.LAUNCHES["p2m"], TK.LAUNCHES["p2m_bf16x"]
    got = TK.p2m_cells(b.cell_x, cell_val, b.cell_mask, **kk)
    assert TK.LAUNCHES["p2m"] == n0 + 1
    ref = TK.p2m_cells_torch(b.cell_x, cell_val, b.cell_mask, **kk)
    torch.cuda.synchronize()
    assert rel(got, ref) <= TOL
    got16 = TK.p2m_cells(b.cell_x, cell_val, b.cell_mask, precision="bf16x",
                         **kk)
    assert TK.LAUNCHES["p2m_bf16x"] == n0_bf16 + 1
    ref16 = TK.p2m_cells_torch(b.cell_x, cell_val, b.cell_mask,
                               precision="bf16x", **kk)
    torch.cuda.synchronize()
    assert rel(got16, ref16) <= BF16_TOL
    assert rel(got16, got) > 0          # bf16 really used


@pytest.mark.parametrize("dim,seed,edge", [(2, 3, False), (3, 4, False),
                                           (3, 5, True)])
def test_cuda_m2p_matches_plain(card, dim, seed, edge):
    b, _, field, kk = _tiles(dim, seed, edge)
    field = torch.cat([field, field[..., :1] * 2.0], -1).contiguous()  # C=4
    n0, n0_bf16 = TK.LAUNCHES["m2p"], TK.LAUNCHES["m2p_bf16x"]
    got = TK.m2p_cells(field, b.cell_x, b.cell_mask, **kk)
    assert TK.LAUNCHES["m2p"] == n0 + 1
    ref = TK.m2p_cells_torch(field, b.cell_x, b.cell_mask, **kk)
    torch.cuda.synchronize()
    assert rel(got, ref) <= TOL
    got16 = TK.m2p_cells(field, b.cell_x, b.cell_mask, precision="bf16x",
                         **kk)
    assert TK.LAUNCHES["m2p_bf16x"] == n0_bf16 + 1
    ref16 = TK.m2p_cells_torch(field, b.cell_x, b.cell_mask,
                               precision="bf16x", **kk)
    torch.cuda.synchronize()
    assert rel(got16, ref16) <= BF16_TOL
    assert rel(got16, got) > 0          # bf16 really used


def _dense_tiles(shape, lengths, cb, n, cell_cap, seed):
    """Uniform particles (numpy draws) in a periodic box, bucketed on the
    card with ``cell_cap`` slots, and C = 3 values per particle."""
    rng = np.random.default_rng(seed)
    dim = len(shape)
    x = (rng.uniform(size=(n, dim)) * np.asarray(lengths)).astype(np.float32)
    val = rng.normal(size=(n, 3)).astype(np.float32)
    valid = rng.uniform(size=n) > 0.1
    kw = dict(shape=shape, box_lo=(0.0,) * dim, box_hi=tuple(lengths),
              periodic=(True,) * dim)
    t = lambda a: torch.from_numpy(a).cuda()
    b = TM4.bucket_particles(t(x), t(valid), cell_cap=cell_cap, cb=cb, **kw)
    assert int(b.overflow) == 0
    kk = dict(grid_cells=tuple(m // cb for m in shape), cb=cb,
              box_lo=kw["box_lo"], box_hi=kw["box_hi"])
    return b, t(val)[b.safe.long()].contiguous(), kk


def _p2m_both_precisions(b, cell_val, kk):
    """B3 against its plain version in fp32 and bf16x (unlike fp32)."""
    got = TK.p2m_cells(b.cell_x, cell_val, b.cell_mask, **kk)
    ref = TK.p2m_cells_torch(b.cell_x, cell_val, b.cell_mask, **kk)
    torch.cuda.synchronize()
    assert float(ref.abs().max()) > 0
    assert rel(got, ref) <= TOL
    got16 = TK.p2m_cells(b.cell_x, cell_val, b.cell_mask, precision="bf16x",
                         **kk)
    ref16 = TK.p2m_cells_torch(b.cell_x, cell_val, b.cell_mask,
                               precision="bf16x", **kk)
    torch.cuda.synchronize()
    assert rel(got16, ref16) <= BF16_TOL
    assert rel(got16, got) > 0


@pytest.mark.parametrize("dim", [2, 3])
def test_cuda_p2m_takes_any_cell_cap(card, dim):
    """B3 at cell_cap 2048 and cb 8 (cb 8's first re-provision doubles
    its default 2·8^3 = 1024): the patch scatter streams slots and has no
    capacity limit; M2P keeps its one thread per slot and raises."""
    shape = (16, 8, 8)[:dim]
    b, cell_val, kk = _dense_tiles(shape, (2.0, 1.0, 1.0)[:dim], cb=8,
                                   n=3000, cell_cap=2048, seed=40 + dim)
    assert b.cell_x.shape[1] == 2048 and int(b.cell_mask.sum(1).max()) > 1024
    n0 = TK.LAUNCHES["p2m"]
    _p2m_both_precisions(b, cell_val, kk)
    assert TK.LAUNCHES["p2m"] == n0 + 1
    field = torch.zeros(shape + (3,), device="cuda")
    with pytest.raises(ValueError, match="M2P"):
        TK.m2p_cells(field, b.cell_x, b.cell_mask, **kk)


@pytest.mark.parametrize("shape,lengths", [
    ((8, 24, 12), (1.0, 3.0, 1.5)),     # 2 x 6 x 3 cells
    ((24, 8), (3.0, 1.0)),              # 6 x 2 cells
])
def test_cuda_p2m_two_cells_on_an_axis(card, shape, lengths):
    """A grid with 2 cells along an axis: two offsets fetch the same
    bucket, each with its own periodic image, and both count."""
    b, cell_val, kk = _dense_tiles(shape, lengths, cb=4, n=1500,
                                   cell_cap=256, seed=sum(shape))
    _p2m_both_precisions(b, cell_val, kk)


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
    # bf16x: both outputs bf16; the mixed forms: the named output bf16,
    # the other the fp32 evaluation
    for prec, key, bf16_outs in (("bf16x", "sph_bf16x", ("a", "drho")),
                                 ("bf16x:drho", "sph_bf16x_drho", ("drho",)),
                                 ("bf16x:a", "sph_bf16x_a", ("a",))):
        n0 = CP.LAUNCHES_BY_KIND[key]
        got16 = CP.cell_pair(*args, precision=prec, **kw)
        assert CP.LAUNCHES_BY_KIND[key] == n0 + 1
        ref16 = CP.cell_pair_torch(*args, precision=prec, **kw)
        torch.cuda.synchronize()
        for name in ("a", "drho"):
            assert rel(got16[name], ref16[name]) <= BF16_TOL, (prec, name)
            if name in bf16_outs:
                assert rel(got16[name], got[name]) > 0, (prec, name)
            else:
                assert rel(got16[name], got[name]) <= TOL, (prec, name)


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
    n0 = CP.LAUNCHES_BY_KIND["dem_bf16x"]
    got16 = CP.cell_pair(*args, precision="bf16x", **kw)["f"]
    assert CP.LAUNCHES_BY_KIND["dem_bf16x"] == n0 + 1
    ref16 = CP.cell_pair_torch(*args, precision="bf16x", **kw)["f"]
    torch.cuda.synchronize()
    assert rel(got16, ref16) <= BF16_TOL
    assert rel(got16, got) > 0          # bf16 really used


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


def test_bf16x_kernel_paths_match_plain_paths(card):
    """A few bf16x steps of MD, the small 2-D dam break, the small
    avalanche and VIC through the kernels against the plain path in
    bf16x, with each app's bf16x launches per step."""
    from repro_torch.apps import dem, md, sph
    from repro_torch.kernels.cell_pair import cell_pair as CP
    tol = 1e-2
    cfg = md.MDConfig(n_per_side=6, sigma=0.085, device="cuda",
                      precision="bf16x")
    n0 = CP.LAUNCHES_BY_KIND["lj_bf16x"]
    pk, _ = md.run(cfg, 5, thermal_v=0.4, seed=2)
    assert CP.LAUNCHES_BY_KIND["lj_bf16x"] == n0 + 6
    pp, _ = md.run(dataclasses.replace(cfg, backend="torch"), 5,
                   thermal_v=0.4, seed=2)
    assert rel(pk.props["v"], pp.props["v"]) <= tol
    scfg = sph.SPHConfig(dp=0.04, box=(1.0, 0.5), fluid=(0.25, 0.25),
                         device="cuda", precision="bf16x:drho")
    n0 = CP.LAUNCHES_BY_KIND["sph_bf16x_drho"]
    pk, _ = sph.run(scfg, 5)
    assert CP.LAUNCHES_BY_KIND["sph_bf16x_drho"] == n0 + 5
    pp, _ = sph.run(dataclasses.replace(scfg, backend="torch"), 5)
    assert rel(pk.props["v"], pp.props["v"]) <= tol
    assert rel(pk.props["rho"], pp.props["rho"]) <= tol
    dcfg = dem.DEMConfig(box=(2.0, 0.6, 1.0), fill=(0.8, 0.66, 0.5),
                         device="cuda", precision="bf16x")
    n0 = CP.LAUNCHES_BY_KIND["dem_bf16x"]
    pk = dem.run(dcfg, 5)
    assert CP.LAUNCHES_BY_KIND["dem_bf16x"] == n0 + 5
    pp = dem.run(dataclasses.replace(dcfg, backend="torch"), 5)
    assert rel(pk.props["v"], pp.props["v"]) <= tol
    vcfg = TV.VortexConfig(shape=(16, 8, 8), lengths=(4.0, 2.0, 2.0),
                           dt=0.02, device="cuda", precision="bf16x")
    n0 = dict(TK.LAUNCHES)
    wk, _, _ = TV.run(vcfg, 2)
    assert TK.LAUNCHES["p2m_bf16x"] - n0["p2m_bf16x"] >= 4
    assert TK.LAUNCHES["p2m"] == n0["p2m"]
    wp, _, _ = TV.run(dataclasses.replace(vcfg, backend="torch"), 2)
    assert rel(wk, wp) <= tol


@pytest.mark.parametrize("shape", [(16, 16, 16), (32, 16, 8), (8, 32, 40)])
def test_cuda_stencil7_matches_plain(card, shape):
    """B2 against its plain version on the card, bit for bit, through
    gray_scott_step and through ops.step against the app's gs_step."""
    from repro_torch.apps import gray_scott as GS
    from repro_torch.kernels.stencil7 import ops as SOPS
    from repro_torch.kernels.stencil7 import stencil7 as SK
    from repro_torch.kernels.stencil7.ref import gray_scott_step_ref
    rng = np.random.default_rng(sum(shape))
    u, v = (torch.from_numpy(rng.uniform(size=shape).astype(np.float32))
            .cuda() for _ in range(2))
    args = dict(Du=2e-5, Dv=1e-5, F=0.03, k=0.06, dt=1.0, inv_h2=100.0)
    n0 = SK.LAUNCHES
    got = SK.gray_scott_step(u, v, **args)
    assert SK.LAUNCHES == n0 + 1
    ref = gray_scott_step_ref(u, v, **args)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    cfg = GS.GSConfig(shape=shape, L=shape[0] / 3.0)
    for g, r in zip(SOPS.step(u, v, cfg), GS.gs_step(u, v, cfg)):
        assert torch.equal(g, r)
    with pytest.raises(TypeError, match="float32"):
        SK.gray_scott_step(u.double(), v.double(), **args)


def test_bf16_scalar_ops_round_as_the_functors_assume(card):
    """B1's bf16x functors mirror the plain bodies' bf16 ops on the card
    (csrc/cell_pair.cu, Ops<P>): a tensor op computes in fp32 and rounds
    the result, and a constant taken through ``interactions.weak`` (a 0-d
    bf16 tensor on the card) enters it rounded to bf16, as JAX's weak
    typing rounds it; ``div_scalar`` divides by it. A bare Python scalar
    would enter unrounded, and a 0-d CPU divisor as its reciprocal."""
    from repro_torch.core import interactions as I
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(0.0, 4.0, 1 << 16).astype(np.float32)
                         ).cuda().to(torch.bfloat16)
    y = torch.from_numpy(rng.uniform(0.5, 4.0, 1 << 16).astype(np.float32)
                         ).cuda().to(torch.bfloat16)
    bf = lambda t: t.to(torch.bfloat16).float()
    xf, yf = x.float(), y.float()
    for s in (1.01, 0.1234567, 3.3333333, 0.12, 1e-6):
        w = I.weak(s, x)
        assert w.dtype == torch.bfloat16 and w.is_cuda and w.dim() == 0
        sb = torch.tensor(s, dtype=torch.float32, device="cuda")
        sb = bf(sb)                               # s rounded to bf16
        cases = {"x * w": ((x * w).float(), bf(xf * sb)),
                 "w * x": ((w * x).float(), bf(sb * xf)),
                 "x + w": ((x + w).float(), bf(xf + sb)),
                 "w - x": ((w - x).float(), bf(sb - xf)),
                 "x - w": ((x - w).float(), bf(xf - sb)),
                 "x / w": ((x / w).float(), bf(xf / sb)),
                 "div_scalar": (I.div_scalar(x, s).float(), bf(xf / sb))}
        for name, (got, want) in cases.items():
            assert torch.equal(got, want), (name, s)
    assert I.weak(0.12, xf) == 0.12               # fp32 keeps the number
    assert torch.equal((x / y).float(), bf(xf / yf))
    assert torch.equal((x * y).float(), bf(xf * yf))
    assert torch.equal(torch.sqrt(x).float(), bf(torch.sqrt(xf)))
    assert torch.equal(torch.pow(x, 7.0).float(), bf(torch.pow(xf, 7.0)))
    assert torch.equal(torch.clamp(x, min=1e-12).float(),
                       bf(torch.clamp(xf, min=1e-12)))


def test_bf16x_plain_on_card_equals_plain_on_cpu(card):
    """The plain bf16x bodies round alike on the card and on the CPU: B1's
    plain version on the same DEM and SPH (2-D, 3-D) tiles on both, in
    bf16x, to the summation order."""
    from repro_torch.apps import dem, sph
    from repro_torch.kernels.cell_pair import cell_pair as CP
    cases = [(dem.dem_normal_body(dem.DEMConfig(device="cuda")),
              {"f": "radial"}, dem.DEMConfig().r_cut, ("v",),
              _pair_tiles(3, 5, 24, 27, 0.3, seed=3))]
    for dim in (2, 3):
        cfg = sph.SPHConfig(dim=dim, dp=0.05, box=(1.0, 0.5, 0.5)[:dim],
                            fluid=(0.25,) * dim, device="cuda")
        cases.append((sph.sph_pair_body(cfg),
                      {"a": "radial", "drho": "scalar"}, cfg.r_cut,
                      ("v", "rho"), _pair_tiles(dim, 4, 16, 3 ** dim, 0.2,
                                                seed=30 + dim)))
    for body, out, r_cut, names, tl in cases:
        args = [tl["cell_x"], tl["nbr_x"], tl["cell_mask"], tl["nbr_mask"],
                {k: tl[f"cell_{k}"] for k in names},
                {k: tl[f"nbr_{k}"] for k in names}]
        on_card = CP.cell_pair_torch(*args, body=body, out=out, r_cut=r_cut,
                                     precision="bf16x")
        cpu = lambda a: ({k: t.cpu() for k, t in a.items()}
                         if isinstance(a, dict) else a.cpu())
        on_cpu = CP.cell_pair_torch(*map(cpu, args), body=body, out=out,
                                    r_cut=r_cut, precision="bf16x")
        for name in out:
            assert float(on_cpu[name].abs().max()) > 0, name
            assert rel(on_card[name], on_cpu[name]) <= TOL, \
                (body.cuda_kind, name)


# B5 against its plain version: fp32 within TOL (only the summation order
# differs); bf16 within 1e-2 of the plain output's max-abs (one bf16
# rounding of the output is 2^-8 relative, and another summation order can
# flip it)
B5_BF16_TOL = 1e-2


@pytest.mark.parametrize("B,H,K,Sq,Sk,hd,causal", [
    (2, 4, 4, 128, 128, 64, True),       # rep 1
    (1, 16, 4, 200, 200, 128, True),     # rep 4, ragged
    (2, 12, 1, 77, 131, 128, True),      # rep 12, Sq < Sk, ragged
    (1, 4, 2, 96, 160, 256, True),       # gemma-style head dim
    (1, 24, 2, 65, 300, 64, False),      # rep 12, non-causal
    (3, 6, 3, 1, 9, 32, True),           # one query
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_matches_plain(card, B, H, K, Sq, Sk, hd,
                                            causal, dtype):
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    rng = np.random.default_rng(Sq * 7 + Sk + hd)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .cuda().to(dtype) for s in ((B, H, Sq, hd), (B, K, Sk, hd),
                                           (B, K, Sk, hd)))
    n0 = FA.LAUNCHES
    got = FA.flash_attention(q, k, v, causal=causal)
    assert FA.LAUNCHES == n0 + 1
    ref = flash_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    assert bool(torch.isfinite(got).all())
    assert rel(got.float(), ref.float()) <= (TOL if dtype == torch.float32
                                             else B5_BF16_TOL)


@pytest.mark.parametrize("B,H,K,Sq,Sk,hd,causal", [
    (2, 4, 2, 77, 77, 8, True),          # the narrowest head, ragged
    (1, 6, 3, 130, 200, 24, True),       # product depth 24: padded to 32
    (1, 12, 1, 33, 70, 24, False),       # rep 12, non-causal
    (2, 4, 2, 190, 190, 256, True),      # the widest head, one warpgroup
    (1, 8, 8, 300, 300, 200, True),      # hd 200: four boxes, one short
])
def test_cuda_flash_attention_bf16_head_dims(card, B, H, K, Sq, Sk, hd,
                                             causal):
    """B5's bf16 (wgmma) form at head dims whose product depth is not a
    multiple of 16 or that need one consumer warpgroup, with ragged Sq."""
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    rng = np.random.default_rng(Sq + hd)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .cuda().to(torch.bfloat16)
               for s in ((B, H, Sq, hd), (B, K, Sk, hd), (B, K, Sk, hd)))
    n0 = FA.LAUNCHES
    got = FA.flash_attention(q, k, v, causal=causal)
    assert FA.LAUNCHES == n0 + 1
    ref = flash_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got).all())
    assert rel(got.float(), ref.float()) <= B5_BF16_TOL


# The bf16 form's split of p must be exact: the share of bf16 outputs that
# differ from plain (fp32 p) stays under half of what plain with only the
# first one or two bf16 terms of p gives. Few keys, so that the summation
# order flips few outputs (at 2176 keys it flips about as many as dropping
# the third term does).
B5_SPLIT_FRAC = 0.5


@pytest.mark.parametrize("B,H,K,Sq,Sk,hd,causal", [
    (8, 32, 4, 64, 16, 128, False),
    (4, 16, 2, 128, 128, 64, True),
])
def test_cuda_flash_attention_bf16_split_is_exact(card, B, H, K, Sq, Sk, hd,
                                                  causal):
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    rng = np.random.default_rng(Sk + hd)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .cuda().to(torch.bfloat16)
               for s in ((B, H, Sq, hd), (B, K, Sk, hd), (B, K, Sk, hd)))
    ref = flash_attention_ref(q, k, v, causal=causal)
    share = lambda x: float((x != ref).float().mean())
    got = share(FA.flash_attention(q, k, v, causal=causal))
    for n in (1, 2):
        control = share(flash_attention_ref(q, k, v, causal=causal,
                                            p_terms=n))
        assert got < B5_SPLIT_FRAC * control, (n, got, control)


def test_cuda_mha_takes_strided_views(card):
    """ops.mha hands the kernel transposed views: no copy in, the output
    written in q's layout."""
    from repro_torch.kernels.flash_attention import ops as FOPS
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((2, 150, 8, 64)).astype(
        np.float32)).cuda()
    cache = torch.from_numpy(rng.standard_normal((2, 2, 192, 2, 64)).astype(
        np.float32)).cuda()
    k, v = cache[0], cache[1]                  # slices of a stacked cache
    got = FOPS.mha(q, k, v)
    assert got.is_contiguous()
    ref = flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2)).transpose(1, 2)
    torch.cuda.synchronize()
    assert rel(got, ref) <= TOL
    from repro_torch.kernels.flash_attention import flash_attention as FA
    with pytest.raises(ValueError, match="multiple of 8"):
        FA.flash_attention(q[..., :12].transpose(1, 2).contiguous(),
                           k[..., :12].transpose(1, 2).contiguous(),
                           v[..., :12].transpose(1, 2).contiguous())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        FA.flash_attention(*(t.transpose(1, 2).half() for t in (q, k, v)))


def test_lm_backends_on_the_card(card):
    """A CUDA tensor given backend="torch" runs the plain path (no B5
    launch); "auto" and "cuda" launch B5 once per layer of the prefill and
    never in decode, and agree with the plain path."""
    from repro_torch.configs import registry as TR
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.models import transformer as TT
    from repro_torch.training import serve as TS
    cfg = TR.get_config("starcoder2-15b", reduced=True)
    params = TT.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                            device="cuda")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, size=(2, 40))).cuda()
    n0 = FA.LAUNCHES
    plain, _, _ = TT.forward(params, {"tokens": toks}, cfg, backend="torch")
    assert FA.LAUNCHES == n0
    for backend in ("auto", "cuda"):
        got, _, _ = TT.forward(params, {"tokens": toks}, cfg,
                               backend=backend)
        torch.cuda.synchronize()
        assert rel(got, plain) <= 1e-4
    assert FA.LAUNCHES == n0 + 2 * cfg.n_layers
    n1 = FA.LAUNCHES
    out = TS.greedy_generate(cfg, params, toks, 5, s_max=48)
    assert FA.LAUNCHES == n1 + cfg.n_layers        # the prefill only
    ref = TS.greedy_generate(cfg, params, toks, 5, s_max=48,
                             backend="torch")
    assert out.shape == (2, 5) and torch.equal(out, ref)
