"""The CUDA kernels against their plain PyTorch versions, on the card
(B1 with the LJ (DIM 2 and 3), SPH and DEM functors and with functors
generated from bodies without cuda_kind, integer and width-4 props, five
outputs under bf16x:<names> and every newer op among them, every
elementwise op repro's kernel takes, one output each, its striped pair
walk at every home count, the fleet's folded launch and cells= subsets
bit for bit, B2 in fp32, bf16 and fp16, B3, B4; fp32 and bf16x; B5, the
flash attention, in fp32 (its split products against a three-term
control, a launch plan per head-dim bucket), bf16 and fp16, and the
dense, moe, ssm, hybrid, encdec and vlm LM paths through it; B5's guard
under autograd and the training step on the card against the CPU; the
block legs of B3/B4, the MD reuse step and the mesh-field step).
Imports neither jax nor repro, so it runs on the GPU machine:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Every test skips where torch.cuda.is_available() is False."""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_bridge import (DSF_OUT, OPS_OUT, QUAT_OUT, DSFBody, KABody,
                           NewOpsBody, OpsBody, QuatBody, ToyCfg,
                           interp_case, new_ops_props, rel, toy_physics)

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


def _m2p_both_precisions(b, kk, seed):
    """B4 against its plain version in fp32 and bf16x (unlike fp32) on a
    normal(0, 1) field of C = 3 channels (numpy draws)."""
    shape = tuple(g * kk["cb"] for g in kk["grid_cells"])
    rng = np.random.default_rng(seed)
    field = torch.from_numpy(rng.normal(size=shape + (3,))
                             .astype(np.float32)).cuda()
    n0, n0_bf16 = TK.LAUNCHES["m2p"], TK.LAUNCHES["m2p_bf16x"]
    got = TK.m2p_cells(field, b.cell_x, b.cell_mask, **kk)
    ref = TK.m2p_cells_torch(field, b.cell_x, b.cell_mask, **kk)
    torch.cuda.synchronize()
    assert TK.LAUNCHES["m2p"] == n0 + 1
    assert float(ref.abs().max()) > 0
    assert rel(got, ref) <= TOL
    assert bool((got[~b.cell_mask] == 0).all())      # empty slots read 0
    got16 = TK.m2p_cells(field, b.cell_x, b.cell_mask, precision="bf16x",
                         **kk)
    ref16 = TK.m2p_cells_torch(field, b.cell_x, b.cell_mask,
                               precision="bf16x", **kk)
    torch.cuda.synchronize()
    assert TK.LAUNCHES["m2p_bf16x"] == n0_bf16 + 1
    assert rel(got16, ref16) <= BF16_TOL
    assert rel(got16, got) > 0


@pytest.mark.parametrize("dim", [2, 3])
def test_cuda_p2m_takes_any_cell_cap(card, dim):
    """B3 at cell_cap 2048 and cb 8 (cb 8's first re-provision doubles
    its default 2·8^3 = 1024): the patch scatter streams slots and has no
    capacity limit (test_cuda_m2p_takes_any_cell_cap holds M2P there)."""
    shape = (16, 8, 8)[:dim]
    b, cell_val, kk = _dense_tiles(shape, (2.0, 1.0, 1.0)[:dim], cb=8,
                                   n=3000, cell_cap=2048, seed=40 + dim)
    assert b.cell_x.shape[1] == 2048 and int(b.cell_mask.sum(1).max()) > 1024
    n0 = TK.LAUNCHES["p2m"]
    _p2m_both_precisions(b, cell_val, kk)
    assert TK.LAUNCHES["p2m"] == n0 + 1


@pytest.mark.parametrize("dim", [2, 3])
def test_cuda_m2p_takes_any_cell_cap(card, dim):
    """B4 at cell_cap 2048 and cb 8, more than 1024 particles in a
    bucket: the patch gather gives a thread to each valid particle, not to
    each slot, so it has no capacity limit."""
    shape = (16, 8, 8)[:dim]
    b, _, kk = _dense_tiles(shape, (2.0, 1.0, 1.0)[:dim], cb=8, n=3000,
                            cell_cap=2048, seed=50 + dim)
    assert b.cell_x.shape[1] == 2048 and int(b.cell_mask.sum(1).max()) > 1024
    _m2p_both_precisions(b, kk, seed=60 + dim)


@pytest.mark.parametrize("shape,lengths", [
    ((8, 24, 12), (1.0, 3.0, 1.5)),     # 2 x 6 x 3 cells
    ((24, 8), (3.0, 1.0)),              # 6 x 2 cells
    ((8, 8, 8), (1.0, 1.0, 1.0)),       # 2 x 2 x 2 cells
])
def test_cuda_m2p_two_cells_on_an_axis(card, shape, lengths):
    """B4 on a grid with 2 buckets along an axis: the two offsets that
    fetch the same field block, each with its own periodic image, both
    count, in fp32 and bf16x."""
    b, _, kk = _dense_tiles(shape, lengths, cb=4, n=1500, cell_cap=256,
                            seed=7 + sum(shape))
    _m2p_both_precisions(b, kk, seed=len(shape))


def test_cuda_m2p_particles_across_their_bucket_face(card):
    """B4 where positions are pushed up to 1.6 h off the ones they were
    bucketed by, so many supports leave the patch's staged nodes: those
    particles take the kernel's general walk, which must cover the same
    nodes of the 3^dim-block window as the plain version, in fp32 and
    bf16x."""
    b, _, kk = _dense_tiles((16, 8, 8), (2.0, 1.0, 1.0), cb=4, n=1500,
                            cell_cap=256, seed=21)
    rng = np.random.default_rng(22)
    h = torch.tensor([2.0 / 16, 1.0 / 8, 1.0 / 8], device="cuda")
    push = torch.from_numpy(rng.uniform(-1.6, 1.6, size=tuple(
        b.cell_x.shape)).astype(np.float32)).cuda()
    b = b._replace(cell_x=(b.cell_x + push * h).contiguous())
    _m2p_both_precisions(b, kk, seed=23)


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


def test_vortex_reprovision_redo_at_cb8(card):
    """vortex.run at cb 8 from a bucket capacity below the 512 nodes of a
    bucket: step_reprovision doubles interp_cell_cap and redoes the step
    on the card (2 + 2 launches per attempt), and the run agrees with the
    plain path's."""
    cfg = TV.VortexConfig(shape=(16, 8, 8), lengths=(4.0, 2.0, 2.0),
                          dt=0.02, interp_cb=8, interp_cell_cap=256,
                          device="cuda")
    n0, redo0 = dict(TK.LAUNCHES), TV.REDOS
    wk, _, _ = TV.run(cfg, 3)
    redos = TV.REDOS - redo0
    assert redos >= 1
    assert TK.LAUNCHES["p2m"] - n0["p2m"] == 2 * (3 + redos)
    assert TK.LAUNCHES["m2p"] - n0["m2p"] == 2 * (3 + redos)
    wp, _, _ = TV.run(dataclasses.replace(cfg, backend="torch"), 3)
    torch.cuda.synchronize()
    assert rel(wk, wp) <= 1e-4


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


def _gauss_body(dx, r2, ok, wi, wj):
    """``repro``'s Gaussian body (tests/test_cell_pair.py): no
    cuda_kind."""
    from repro_torch.core.interactions import Radial
    w = wi["q"] * wj["q"] * torch.exp(-8.0 * r2)
    return {"f": Radial(w), "rho": w}


@dataclasses.dataclass(frozen=True)
class _Hidden:
    """A body with its cuda_kind hidden: the generated route."""

    body: object

    def __call__(self, dx, r2, ok, wi, wj):
        return self.body(dx, r2, ok, wi, wj)


def _gauss_tiles(dim, n, r_cut, seed):
    """Tiles of n seeded particles with a per-particle q in a periodic
    unit box, on the card."""
    from repro_torch.core import cell_list as CL
    from repro_torch.core import particles as P
    from repro_torch.kernels.cell_pair import cell_pair as CP
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.uniform(0.0, 1.0, (n, dim)).astype(np.float32))
    q = torch.from_numpy(rng.uniform(1.0, 2.0, n).astype(np.float32))
    ps = P.from_positions(x.cuda(), capacity=n + 6, props={"q": q.cuda()})
    gs = CL.grid_shape_for((0.0,) * dim, (1.0,) * dim, r_cut)
    cl = CL.build_cell_list(ps, box_lo=(0.0,) * dim, box_hi=(1.0,) * dim,
                            grid_shape=gs, periodic=(True,) * dim,
                            cell_cap=64)
    return CP.gather_cell_tiles(ps, cl, ("q",))


@pytest.mark.parametrize("dim,n,r_cut", [(2, 400, 0.26), (3, 900, 0.3)])
@pytest.mark.parametrize("prec", ["fp32", "bf16x", "bf16x:rho"])
def test_cuda_generated_gauss_functor_matches_plain(card, dim, n, r_cut,
                                                    prec):
    """A body without cuda_kind launches the functor generated from it
    (one launch, counted under its own key) and matches cell_pair_torch on
    the card in every precision; bf16x is unlike fp32."""
    from repro_torch.kernels.cell_pair import cell_pair as CP
    t = _gauss_tiles(dim, n, r_cut, seed=dim)
    args = (t.cell_x, t.nbr_x, t.cell_mask, t.nbr_mask, t.props_i,
            t.props_j)
    out = {"f": "radial", "rho": "scalar"}
    kw = dict(body=_gauss_body, out=out, r_cut=r_cut)
    kind, key_prec, _ = CP._kind_of(_gauss_body, out, prec, dim, t.props_i)
    assert kind.startswith("gen_")
    key = CP.launch_key(kind, key_prec)
    n0, k0 = CP.LAUNCHES, CP.LAUNCHES_BY_KIND[key]
    got = CP.cell_pair(*args, precision=prec, **kw)
    assert CP.LAUNCHES == n0 + 1 and CP.LAUNCHES_BY_KIND[key] == k0 + 1
    ref = CP.cell_pair_torch(*args, precision=prec, **kw)
    f32 = CP.cell_pair(*args, **kw)
    torch.cuda.synchronize()
    for k in out:
        assert rel(got[k], ref[k]) <= TOL, k
    if prec != "fp32":
        assert rel(got["rho"], f32["rho"]) > 0      # bf16 really used


def _typed_tiles(n, r_cut, seed):
    """Tiles of n seeded particles in a periodic unit box on the card,
    with an int32 ``species`` (ids up to 2^26), an int32 ``kind`` in
    [-50, 50), a +-1 charge ``q`` of zero sum and unit quaternions
    ``q4`` (width 4)."""
    from repro_torch.core import cell_list as CL
    from repro_torch.core import particles as P
    from repro_torch.kernels.cell_pair import cell_pair as CP
    rng = np.random.default_rng(seed)
    q4 = rng.normal(size=(n, 4))
    props = {"species": rng.integers(0, 2 ** 26, n).astype(np.int32),
             "kind": rng.integers(-50, 50, n).astype(np.int32),
             "q": rng.permutation(np.repeat([-1.0, 1.0], n // 2)).astype(
                 np.float32),
             "q4": (q4 / np.linalg.norm(q4, axis=1, keepdims=True)).astype(
                 np.float32)}
    x = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    ps = P.from_positions(torch.from_numpy(x).cuda(), capacity=n + 6,
                          props={k: torch.from_numpy(v).cuda()
                                 for k, v in props.items()})
    gs = CL.grid_shape_for((0.0,) * 3, (1.0,) * 3, r_cut)
    cl = CL.build_cell_list(ps, box_lo=(0.0,) * 3, box_hi=(1.0,) * 3,
                            grid_shape=gs, periodic=(True,) * 3,
                            cell_cap=64)
    return CP.gather_cell_tiles(ps, cl, tuple(props))


_TYPED = {"ka": (KABody(0.06), {"f": "radial"}, ("species",)),
          "dsf": (DSFBody(0.2 / 0.06, 0.18), DSF_OUT, ("q",)),
          "w4": (QuatBody(60.0), QUAT_OUT, ("q4",)),
          "ops": (OpsBody(20.0), OPS_OUT, ("kind",))}


@pytest.mark.parametrize("case,prec", [
    ("ka", "fp32"), ("ka", "bf16x"), ("dsf", "fp32"), ("dsf", "bf16x"),
    ("w4", "fp32"), ("w4", "bf16x:twist,dens"), ("ops", "fp32"),
    ("ops", "bf16x")])
def test_cuda_generated_typed_bodies_match_plain(card, case, prec):
    """Bodies the generated route gained, through their generated
    functors (one launch each, under their own key): the Kob–Andersen
    mixture (int32 species, table lookups), damped shifted-force
    electrostatics (erfc), five outputs of a width-4 prop (bf16x on two
    of them) and a body of every integer op and newer float op; each
    within TOL of cell_pair_torch on the card, bf16x unlike fp32."""
    from repro_torch.kernels.cell_pair import cell_pair as CP
    body, out, names = _TYPED[case]
    t = _typed_tiles(1500, 0.18, seed=len(case))
    pi = {k: t.props_i[k] for k in names}
    pj = {k: t.props_j[k] for k in names}
    args = (t.cell_x, t.nbr_x, t.cell_mask, t.nbr_mask, pi, pj)
    kw = dict(body=body, out=out, r_cut=0.18)
    kind, key_prec, _ = CP._kind_of(body, out, prec, 3, pi)
    assert kind.startswith("gen_")
    key = CP.launch_key(kind, key_prec)
    n0, k0 = CP.LAUNCHES, CP.LAUNCHES_BY_KIND[key]
    got = CP.cell_pair(*args, precision=prec, **kw)
    assert CP.LAUNCHES == n0 + 1 and CP.LAUNCHES_BY_KIND[key] == k0 + 1
    ref = CP.cell_pair_torch(*args, precision=prec, **kw)
    f32 = CP.cell_pair(*args, **kw)
    torch.cuda.synchronize()
    for k in out:
        assert float(ref[k].abs().max()) > 0.0, k
        assert rel(got[k], ref[k]) <= TOL, k
    if prec != "fp32":
        lowered = ("twist", "dens") if ":" in prec else tuple(out)
        assert all(rel(got[k], f32[k]) > 0 for k in lowered)


@pytest.mark.parametrize("prec", ["fp32", "bf16x"])
def test_cuda_generated_new_ops_match_plain(card, prec):
    """Every elementwise op the generated route took last (remainder,
    fmod, floor and trunc division by tensors and by numbers, round with
    decimals, integer pow, hypot, copysign, log2, exp2, log10, tan, asin,
    acos, atan, sinh, cosh, asinh, acosh, atanh, lgamma, and amax, amin,
    sum, prod and max.dim over stacks), one scalar output each, with a
    radial force, through one generated functor (one launch) against
    cell_pair_torch on the card: each output within TOL, in fp32 and in
    bf16x (the card's bf16 ops, each rounded as the functor rounds it)."""
    from repro_torch.core import cell_list as CL
    from repro_torch.core import particles as P
    from repro_torch.kernels.cell_pair import cell_pair as CP
    n, r_cut = 1500, 0.18
    rng = np.random.default_rng(30)
    x = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    props = {k: torch.from_numpy(v).cuda()
             for k, v in new_ops_props(rng, (n,)).items()}
    ps = P.from_positions(torch.from_numpy(x).cuda(), capacity=n + 6,
                          props=props)
    cl = CL.build_cell_list(ps, box_lo=(0.0,) * 3, box_hi=(1.0,) * 3,
                            grid_shape=CL.grid_shape_for(
                                (0.0,) * 3, (1.0,) * 3, r_cut),
                            periodic=(True,) * 3, cell_cap=64)
    t = CP.gather_cell_tiles(ps, cl, tuple(props))
    body = NewOpsBody(k_f=60.0)
    out = body.out()
    args = (t.cell_x, t.nbr_x, t.cell_mask, t.nbr_mask, t.props_i,
            t.props_j)
    kind, key_prec, _ = CP._kind_of(body, out, prec, 3, t.props_i)
    key = CP.launch_key(kind, key_prec)
    n0, k0 = CP.LAUNCHES, CP.LAUNCHES_BY_KIND[key]
    got = CP.cell_pair(*args, body=body, out=out, r_cut=r_cut,
                       precision=prec)
    assert CP.LAUNCHES == n0 + 1 and CP.LAUNCHES_BY_KIND[key] == k0 + 1
    ref = CP.cell_pair_torch(*args, body=body, out=out, r_cut=r_cut,
                             precision=prec)
    torch.cuda.synchronize()
    bad = {}
    for k in out:
        assert float(ref[k].abs().max()) > 0.0, k
        if not rel(got[k], ref[k]) <= TOL:
            bad[k] = rel(got[k], ref[k])
    assert not bad, bad


@pytest.mark.parametrize("prec", ["fp32", "bf16x"])
def test_cuda_generated_register_bounds_match_plain(card, prec):
    """Generated functors under their register bounds
    (codegen.entry_bound): the new-op body (37 output floats) keeps the
    wide bound, DSF (4) takes 256 threads in fp32 and (256, 4) in bf16x
    at cell capacity 48 (64-thread blocks) and the wide bound at 300 (320
    threads); each launch within TOL of cell_pair_torch and within its
    bound's register cap."""
    from repro_torch.core import cell_list as CL
    from repro_torch.core import particles as P
    from repro_torch.kernels.cell_pair import cell_pair as CP
    from repro_torch.kernels.cell_pair import codegen as CG
    n, r_cut = 1500, 0.18
    rng = np.random.default_rng(31)
    x = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    props = {k: torch.from_numpy(v).cuda()
             for k, v in new_ops_props(rng, (n,)).items()}
    props["q"] = torch.from_numpy(rng.choice([-1.0, 1.0], n).astype(
        np.float32)).cuda()
    ps = P.from_positions(torch.from_numpy(x).cuda(), capacity=n + 6,
                          props=props)
    key_prec = "f32" if prec == "fp32" else "bf16x"
    cases = ((NewOpsBody(k_f=60.0), ("a", "b", "k"), 48, -1),
             (DSFBody(alpha=4.0, rc=r_cut), ("q",), 48,
              CG.entry_bound(4, key_prec)),
             (DSFBody(alpha=4.0, rc=r_cut), ("q",), 300, -1))
    for body, names, cc, fit in cases:
        out = body.out() if hasattr(body, "out") else DSF_OUT
        cl = CL.build_cell_list(ps, box_lo=(0.0,) * 3, box_hi=(1.0,) * 3,
                                grid_shape=CL.grid_shape_for(
                                    (0.0,) * 3, (1.0,) * 3, r_cut),
                                periodic=(True,) * 3, cell_cap=cc)
        t = CP.gather_cell_tiles(ps, cl, names)
        args = (t.cell_x, t.nbr_x, t.cell_mask, t.nbr_mask, t.props_i,
                t.props_j)
        kind, kp, _ = CP._kind_of(body, out, prec, 3, t.props_i)
        a = CP.attrs(kind, kp, 3, cc)
        want = (1024, 0) if fit < 0 else (256, fit)
        assert (a["bound"], a["min_blocks"]) == want, (cc, a)
        cap = 65536 // (a["bound"] * max(a["min_blocks"], 1))
        assert a["registers"] <= min(255, cap), (cc, a)
        n0 = CP.LAUNCHES
        got = CP.cell_pair(*args, body=body, out=out, r_cut=r_cut,
                           precision=prec)
        assert CP.LAUNCHES == n0 + 1
        ref = CP.cell_pair_torch(*args, body=body, out=out, r_cut=r_cut,
                                 precision=prec)
        torch.cuda.synchronize()
        bad = {k: rel(got[k], ref[k]) for k in out
               if not rel(got[k], ref[k]) <= TOL}
        assert not bad, (cc, bad)


@pytest.mark.parametrize("prec", ["fp32", "bf16x"])
@pytest.mark.parametrize("dim", [2, 3])
def test_cuda_lj_hand_and_generated_match_plain(card, dim, prec):
    """LJ at DIM 2 and 3 through its hand functor and, with its cuda_kind
    hidden, through the generated one: both match cell_pair_torch."""
    from repro_torch.apps import md
    from repro_torch.core import cell_list as CL
    from repro_torch.kernels.cell_pair import cell_pair as CP
    side = 20 if dim == 2 else 6
    cfg = md.MDConfig(n_per_side=side, sigma=0.85 / side, dim=dim,
                      dt=0.005 / side, device="cuda")
    ps, _ = md.run(cfg, 5, thermal_v=0.4, seed=3)
    t = CP.gather_cell_tiles(ps, CL.build_cell_list(ps, **md._cl_kw(cfg)))
    args = (t.cell_x, t.nbr_x, t.cell_mask, t.nbr_mask)
    body = md.lj_pair_body(cfg.sigma, cfg.epsilon)
    kw = dict(out={"f": "radial"}, r_cut=cfg.r_cut, precision=prec)
    ref = CP.cell_pair_torch(*args, body=body, **kw)["f"]
    n0 = CP.LAUNCHES_BY_KIND[CP.launch_key("lj", "f32" if prec == "fp32"
                                           else "bf16x")]
    hand = CP.cell_pair(*args, body=body, **kw)["f"]
    assert CP.LAUNCHES_BY_KIND[CP.launch_key(
        "lj", "f32" if prec == "fp32" else "bf16x")] == n0 + 1
    gen = CP.cell_pair(*args, body=_Hidden(body), **kw)["f"]
    torch.cuda.synchronize()
    assert rel(hand, ref) <= TOL and rel(gen, ref) <= TOL


def test_cuda_generated_body_with_unsupported_op_raises(card):
    """A body with an op the generator does not take raises on CUDA
    tensors, naming the op; nothing falls back to the plain version."""
    from repro_torch.kernels.cell_pair import cell_pair as CP
    t = _gauss_tiles(3, 200, 0.3, seed=5)

    def cum(dx, r2, ok, wi, wj):
        return {"n": torch.cumsum(r2, -1)}

    n0 = CP.LAUNCHES
    with pytest.raises(NotImplementedError, match="aten.cumsum"):
        CP.cell_pair(t.cell_x, t.nbr_x, t.cell_mask, t.nbr_mask,
                     body=cum, out={"n": "scalar"}, r_cut=0.3)
    assert CP.LAUNCHES == n0


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


@pytest.mark.parametrize("dim,C,cc", [(2, 6, 16), (3, 4, 16), (3, 3, 128),
                                      (3, 2, 320)])
def test_cuda_sph_functor_matches_plain(card, dim, C, cc):
    """B1-SPH against cell_pair_torch on random tiles, in every precision;
    cc=128 at dim 3 is the card size's cell capacity, and cc=320 at dim 3
    asks for more shared memory than a block has (27 x 320 candidates of
    32 bytes) under the first version's whole-cell staging: the chunked
    staging takes it."""
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


@pytest.mark.parametrize("prec", ["fp32", "bf16x:drho"])
def test_cuda_cell_pair_partial_chunks(card, prec):
    """B1-SPH on a tile whose valid candidates fill several chunks and a
    last, partial one (a count that is no multiple of the chunk), beside a
    cell with particles but no valid candidate and a cell with no
    particle; fp32 and the mixed bf16x:drho form."""
    from repro_torch.apps import sph
    from repro_torch.kernels.cell_pair import cell_pair as CP
    cfg = sph.SPHConfig(dim=3, dp=0.05, box=(1.0, 0.5, 0.5),
                        fluid=(0.25,) * 3, device="cuda")
    cc = 96
    plan = CP.plan("sph", "f32" if prec == "fp32" else "bf16x_drho", 3, cc)
    tl = _pair_tiles(3, 4, cc, 27, 0.2, seed=77)
    n_valid = 2 * plan["chunk"] + 37
    assert n_valid < 27 * cc and n_valid % plan["chunk"] != 0
    nm = torch.zeros_like(tl["nbr_mask"])
    rng = np.random.default_rng(78)
    for c in (0, 1):
        pick = rng.choice(27 * cc, size=n_valid, replace=False)
        nm[c, torch.from_numpy(pick).cuda()] = True
    tl["cell_mask"][3] = False               # a cell with no particle
    args = (tl["cell_x"], tl["nbr_x"], tl["cell_mask"], nm,
            {"v": tl["cell_v"], "rho": tl["cell_rho"]},
            {"v": tl["nbr_v"], "rho": tl["nbr_rho"]})
    kw = dict(body=sph.sph_pair_body(cfg),
              out={"a": "radial", "drho": "scalar"}, r_cut=cfg.r_cut,
              precision=prec)
    got = CP.cell_pair(*args, **kw)
    ref = CP.cell_pair_torch(*args, **kw)
    torch.cuda.synchronize()
    for name in ("a", "drho"):
        assert float(ref[name][:2].abs().max()) > 0, name
        assert rel(got[name], ref[name]) <= TOL, name
        assert bool((got[name][2:] == 0).all()), name


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


# homes per cell for the lane-map tiles (cc = LANE_CC, 64 lanes a block):
# none, one (32 stripes), a few, 17 (3 stripes), 33 (one stripe), full
LANE_CC = 48
LANE_HOMES = (0, 1, 3, 7, 17, 33, LANE_CC)


def _lane_tiles(dim, homes, a, seed):
    """Tiles whose cell c holds ``homes[c]`` valid home slots at seeded,
    scattered slots (a cell with 0 < n < LANE_CC holds no prefix): each
    cell's 3^dim·LANE_CC candidates on a jittered lattice of spacing
    ``a`` (±0.15a), about 80% valid; its home slots at candidates'
    positions (so self-pairs are met and excluded); a vector prop v ~
    N(0, 1) and a scalar q in [1, 2) per slot. Returns the tile dict and
    each cell's home slots."""
    rng = np.random.default_rng(seed)
    cc, kcc = LANE_CC, 3 ** dim * LANE_CC
    C = len(homes)
    side = int(np.ceil(kcc ** (1.0 / dim)))
    grid = np.stack(np.meshgrid(*[np.arange(side)] * dim, indexing="ij"),
                    -1).reshape(-1, dim)
    nbr_x = np.empty((C, kcc, dim), np.float32)
    cell_x = np.empty((C, cc, dim), np.float32)
    cell_mask = np.zeros((C, cc), bool)
    slots = []
    for c in range(C):
        pts = (grid[rng.permutation(len(grid))[:kcc]]
               + rng.uniform(-0.15, 0.15, (kcc, dim))) * a
        nbr_x[c] = pts
        cell_x[c] = pts[rng.choice(kcc, cc, replace=False)]
        s = np.sort(rng.choice(cc, homes[c], replace=False))
        cell_mask[c, s] = True
        slots.append(s)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).cuda()
    f32 = lambda *s: rng.uniform(1.0, 2.0, s).astype(np.float32)
    return dict(
        cell_x=t(cell_x), nbr_x=t(nbr_x), cell_mask=t(cell_mask),
        nbr_mask=t(rng.uniform(size=(C, kcc)) < 0.8),
        props_i={"v": t(rng.normal(size=(C, cc, dim)).astype(np.float32)),
                 "q": t(f32(C, cc))},
        props_j={"v": t(rng.normal(size=(C, kcc, dim)).astype(np.float32)),
                 "q": t(f32(C, kcc))}), slots


def _lane_case(name, dim):
    """(body, out, r_cut, lattice spacing, the props it reads) of a lane
    test: LJ at sigma 0.85a, DEM's default grains (2R = 0.12) at spacing
    0.1 so that neighbours overlap, the Gaussian body at repro's 0.26."""
    from repro_torch.apps import dem, md
    if name == "lj":
        a = 0.01
        return (md.lj_pair_body(0.85 * a, 1.0), {"f": "radial"},
                2.5 * 0.85 * a, a, ())
    if name == "dem":
        cfg = dem.DEMConfig(device="cuda")
        return dem.dem_normal_body(cfg), {"f": "radial"}, cfg.r_cut, 0.1, \
            ("v",)
    return _gauss_body, {"f": "radial", "rho": "scalar"}, 0.26, 0.1, ("q",)


@pytest.mark.parametrize("name,dim,prec", [
    ("lj", 2, "fp32"), ("lj", 2, "bf16x"), ("lj", 3, "fp32"),
    ("lj", 3, "bf16x"), ("dem", 3, "fp32"), ("dem", 3, "bf16x"),
    ("gauss", 2, "fp32"), ("gauss", 3, "fp32"), ("gauss", 3, "bf16x")])
def test_cuda_cell_pair_home_counts(card, name, dim, prec):
    """B1's striped walk on cells of 0, 1, 3, 7, 17, 33 and cc valid homes
    (1 to 32 stripes a home, homes scattered over the slots) against
    cell_pair_torch: each cell within TOL of its own largest output, the
    slots without a particle and the empty cell exactly zero; for the LJ
    and DEM hand functors and the generated Gaussian one."""
    from repro_torch.kernels.cell_pair import cell_pair as CP
    body, out, r_cut, a, props = _lane_case(name, dim)
    tl, slots = _lane_tiles(dim, LANE_HOMES, a, seed=40 + dim)
    assert any(len(s) and s[-1] >= len(s) for s in slots)   # no prefix
    pi = {k: tl["props_i"][k] for k in props}
    pj = {k: tl["props_j"][k] for k in props}
    args = (tl["cell_x"], tl["nbr_x"], tl["cell_mask"], tl["nbr_mask"], pi,
            pj)
    kw = dict(body=body, out=out, r_cut=r_cut, precision=prec)
    n0 = CP.LAUNCHES
    got = CP.cell_pair(*args, **kw)
    assert CP.LAUNCHES == n0 + 1
    ref = CP.cell_pair_torch(*args, **kw)
    torch.cuda.synchronize()
    off = ~tl["cell_mask"]
    for k in out:
        assert float(ref[k].abs().max()) > 0, k
        assert bool((got[k][off] == 0).all()), k
        for c, n in enumerate(LANE_HOMES):
            assert rel(got[k][c], ref[k][c]) <= TOL, (k, c, n)


@pytest.mark.parametrize("name,dim", [("lj", 2), ("gauss", 3)])
def test_cuda_cell_pair_fleet_fold_is_bit_equal(card, name, dim):
    """Four members' tiles of the lane test through one folded launch
    (torch.func.vmap over cell_pair) give each member the bits of its own
    launch: a cell's stripe count depends on that cell alone."""
    from repro_torch.kernels.cell_pair import cell_pair as CP
    body, out, r_cut, a, props = _lane_case(name, dim)
    members = [_lane_tiles(dim, LANE_HOMES, a, seed=60 + b)[0]
               for b in range(4)]
    stack = lambda f: torch.stack([f(m) for m in members])
    cols = ("cell_x", "nbr_x", "cell_mask", "nbr_mask")
    batched = [stack(lambda m, k=k: m[k]) for k in cols]
    pi = {k: stack(lambda m, k=k: m["props_i"][k]) for k in props}
    pj = {k: stack(lambda m, k=k: m["props_j"][k]) for k in props}
    kw = dict(body=body, out=out, r_cut=r_cut)
    n0 = CP.LAUNCHES
    folded = torch.func.vmap(lambda cx, nx, cm, nm, wi, wj: CP.cell_pair(
        cx, nx, cm, nm, wi, wj, **kw))(*batched, pi, pj)
    assert CP.LAUNCHES == n0 + 1
    for b, m in enumerate(members):
        own = CP.cell_pair(*[m[k] for k in cols],
                           {k: m["props_i"][k] for k in props},
                           {k: m["props_j"][k] for k in props}, **kw)
        for k in out:
            assert torch.equal(folded[k][b], own[k]), (b, k)


@pytest.mark.parametrize("dim", [2, 3])
def test_cuda_cells_subset_is_bit_equal(card, dim):
    """apply_kernel_cuda with ``cells=`` (a few cells, the last an inactive
    sentinel) gives the particles of those cells the bits of the full
    launch, and every other particle zero."""
    from repro_torch.apps import md
    from repro_torch.core import cell_list as CL
    from repro_torch.kernels.cell_pair import cell_pair as CP
    side = 20 if dim == 2 else 8
    cfg = md.MDConfig(n_per_side=side, sigma=0.85 / side, dim=dim,
                      dt=0.005 / side, device="cuda")
    ps, _ = md.run(cfg, 5, thermal_v=0.4, seed=3)
    cl = CL.build_cell_list(ps, **md._cl_kw(cfg))
    kw = dict(body=md.lj_pair_body(cfg.sigma, cfg.epsilon),
              out={"f": "radial"}, r_cut=cfg.r_cut)
    full = CP.apply_kernel_cuda(ps, cl, **kw)["f"]
    n_cells = cl.n_cells
    pick = [0, 3, n_cells // 2, n_cells - 1]
    cells = torch.tensor(pick + [n_cells], dtype=torch.int32, device="cuda")
    sub = CP.apply_kernel_cuda(ps, cl, cells=cells, **kw)["f"]
    rows = cl.cells[pick].reshape(-1).long()
    rows = rows[rows < ps.capacity]
    assert rows.numel() > 0
    assert torch.equal(sub[rows], full[rows])
    inside = torch.zeros(ps.capacity, dtype=torch.bool, device="cuda")
    inside[rows] = True
    assert bool((sub[~inside] == 0).all())
    assert float(full[rows].abs().max()) > 0


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
    gray_scott_step and through ops.step against the app's gs_step; in
    bf16 and fp16 too (two nodes a thread, and one where nz is odd or the
    fields sit at an odd offset); float64 refused."""
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
    ref = ref_f32 = gray_scott_step_ref(u, v, **args)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    cfg = GS.GSConfig(shape=shape, L=shape[0] / 3.0)
    for g, r in zip(SOPS.step(u, v, cfg), GS.gs_step(u, v, cfg)):
        assert torch.equal(g, r)
    # bf16 and fp16 through their own entries, bit-equal to plain as well
    for dtype in (torch.bfloat16, torch.float16):
        u16, v16 = u.to(dtype), v.to(dtype)
        n0 = SK.LAUNCHES
        got = SK.gray_scott_step(u16, v16, **args)
        assert SK.LAUNCHES == n0 + 1
        ref = gray_scott_step_ref(u16, v16, **args)
        torch.cuda.synchronize()
        for g, r in zip(got, ref):
            assert g.dtype == dtype and torch.equal(g, r), dtype
        assert not torch.equal(got[0].float(), ref_f32[0])
        # the one-node form: an odd nz, and fields at an odd element offset
        odd = [t[..., :7].contiguous().to(dtype) for t in (u, v)]
        shifted = []
        for t in (u16, v16):
            buf = torch.empty(t.numel() + 1, dtype=dtype, device="cuda")
            shifted.append(buf[1:].view(t.shape).copy_(t))
        assert shifted[0].data_ptr() % 4
        for a, b in (odd, shifted):
            for g, r in zip(SK.gray_scott_step(a, b, **args),
                            gray_scott_step_ref(a, b, **args)):
                assert torch.equal(g, r), (dtype, tuple(a.shape))
    # float64 stays refused (the TPU kernel has no fp64)
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
# flip it); fp16 within 1e-3 (its output rounding is 2^-11 relative)
B5_BF16_TOL = 1e-2
B5_F16_TOL = 1e-3


@pytest.mark.parametrize("B,H,K,Sq,Sk,hd,causal", [
    (2, 4, 4, 128, 128, 64, True),       # rep 1
    (1, 16, 4, 200, 200, 128, True),     # rep 4, ragged
    (2, 12, 1, 77, 131, 128, True),      # rep 12, Sq < Sk, ragged
    (1, 4, 2, 96, 160, 256, True),       # gemma-style head dim
    (1, 24, 2, 65, 300, 64, False),      # rep 12, non-causal
    (3, 6, 3, 1, 9, 32, True),           # one query
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
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
    assert rel(got.float(), ref.float()) <= {
        torch.float32: TOL, torch.bfloat16: B5_BF16_TOL,
        torch.float16: B5_F16_TOL}[dtype]


@pytest.mark.parametrize("q_offset,Sq,Sk,hd", [
    (64, 64, 256, 128),      # one tile's rows, tile-aligned
    (37, 100, 300, 128),     # unaligned rows, ragged keys
    (192, 64, 256, 64),      # the last quarter of a 256-row prompt
    (500, 77, 600, 256),     # the widest head, one warpgroup
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_q_offset(card, q_offset, Sq, Sk, hd, dtype):
    """B5 on a run of query rows at ``q_offset`` (a sequence-parallel
    prefill's rows): against its plain version with the same offset, and
    against the same rows of one call on every row from 0."""
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    B, H, K = 2, 8, 2
    rng = np.random.default_rng(q_offset + Sq + hd)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .cuda().to(dtype) for s in ((B, H, q_offset + Sq, hd),
                                           (B, K, Sk, hd), (B, K, Sk, hd)))
    rows = q[:, :, q_offset:]
    n0 = FA.LAUNCHES
    got = FA.flash_attention(rows, k, v, q_offset=q_offset)
    whole = FA.flash_attention(q, k, v)[:, :, q_offset:]
    assert FA.LAUNCHES == n0 + 2
    ref = flash_attention_ref(rows, k, v, q_offset=q_offset)
    torch.cuda.synchronize()
    tol = TOL if dtype == torch.float32 else B5_BF16_TOL
    assert bool(torch.isfinite(got).all())
    assert rel(got.float(), ref.float()) <= tol
    assert rel(got.float(), whole.float()) <= tol


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


@pytest.mark.parametrize("B,H,K,Sq,Sk,hd,causal,q_offset", [
    (2, 8, 2, 128, 128, 64, True, 0),
    (2, 8, 2, 150, 150, 64, False, 0),
    (1, 8, 2, 96, 160, 128, True, 0),       # ragged, Sq < Sk
    (2, 8, 2, 77, 300, 128, True, 37),      # rows at q_offset 37
    (1, 4, 2, 130, 190, 256, True, 0),      # the widest head
    (1, 4, 2, 64, 200, 256, False, 0),
])
def test_cuda_flash_attention_f16_form(card, B, H, K, Sq, Sk, hd, causal,
                                       q_offset):
    """B5's fp16 form (fp16 wgmma for q·kᵀ, p·v on three fp16 terms of
    p·2¹⁵, no split pass): within 1e-3 of plain, the same function up to
    the summation order, so fewer outputs differ from plain than under a
    control that keeps one fp16 term of p; and no scratch: the call
    allocates the output alone."""
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    rng = np.random.default_rng(Sq + Sk + hd + q_offset)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .cuda().half() for s in ((B, H, q_offset + Sq, hd),
                                        (B, K, Sk, hd), (B, K, Sk, hd)))
    rows = q[:, :, q_offset:]
    FA.flash_attention(rows, k, v, causal=causal, q_offset=q_offset)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    n0 = FA.LAUNCHES
    got = FA.flash_attention(rows, k, v, causal=causal, q_offset=q_offset)
    torch.cuda.synchronize()
    assert FA.LAUNCHES == n0 + 1 and got.dtype == torch.float16
    out_bytes = -(-got.numel() * 2 // 512) * 512
    assert torch.cuda.max_memory_allocated() - before <= out_bytes
    ref = flash_attention_ref(rows, k, v, causal=causal, q_offset=q_offset)
    assert bool(torch.isfinite(got).all())
    assert rel(got.float(), ref.float()) <= B5_F16_TOL
    share = lambda x: float((x != ref).float().mean())
    control = flash_attention_ref(rows, k, v, causal=causal,
                                  q_offset=q_offset, f16_terms=1)
    assert share(got) < B5_SPLIT_FRAC * share(control), \
        (share(got), share(control))


# B5's fp32 form sums six products of three exact bf16 terms of q, k, v
# and p; a control that keeps only the three of order <= 1 is farther from
# plain (fp32). The kernel's error stays under B5_SPLIT_FRAC of the
# control's, and at scores up to ~40-50 the control is over TOL while the
# kernel is within it.
@pytest.mark.parametrize("B,H,K,Sq,Sk,hd,causal,sigma", [
    (2, 8, 2, 192, 320, 128, True, 1.0),
    (1, 12, 4, 150, 150, 64, False, 1.0),
    (1, 8, 2, 256, 512, 64, True, 10.0),
    (1, 8, 2, 256, 512, 128, False, 8.0),
    (1, 4, 2, 128, 256, 256, True, 6.0),
])
def test_cuda_flash_attention_fp32_split_products(card, B, H, K, Sq, Sk, hd,
                                                  causal, sigma):
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    rng = np.random.default_rng(Sq + Sk + hd)
    q = torch.from_numpy((rng.standard_normal((B, H, Sq, hd)) * sigma)
                         .astype(np.float32)).cuda()
    k, v = (torch.from_numpy(rng.standard_normal((B, K, Sk, hd))
                             .astype(np.float32)).cuda() for _ in range(2))
    got = FA.flash_attention(q, k, v, causal=causal)
    ref = flash_attention_ref(q, k, v, causal=causal)
    control = flash_attention_ref(q, k, v, causal=causal, split_terms=3)
    torch.cuda.synchronize()
    err, err3 = rel(got, ref), rel(control, ref)
    assert bool(torch.isfinite(got).all())
    assert err <= TOL and err < B5_SPLIT_FRAC * err3, (err, err3)
    if sigma > 1:
        assert err3 > TOL, err3


@pytest.mark.parametrize("hd,want", [
    (64, dict(threads=288, warpgroups=2, slots=4, boxes=1)),
    (128, dict(threads=288, warpgroups=2, slots=2, boxes=2)),
    (192, dict(threads=160, warpgroups=1, slots=2, boxes=3)),
    (256, dict(threads=160, warpgroups=1, slots=1, boxes=4)),
])
def test_cuda_flash_attention_fp32_plan(card, hd, want):
    """Each hd bucket of the fp32 form: its launch plan (the Q planes of
    every consumer warpgroup and the K/V ring within the 227 KB a block
    may use), then a ragged causal call at the bucket's widest head
    against plain."""
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    plan = FA.plan(hd)
    assert {key: plan[key] for key in want} == want
    assert plan["smem_bytes"] <= 232448
    rng = np.random.default_rng(hd)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .cuda() for s in ((2, 6, 70, hd), (2, 3, 140, hd),
                                 (2, 3, 140, hd)))
    got = FA.flash_attention(q, k, v, causal=True)
    ref = flash_attention_ref(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert rel(got, ref) <= TOL
    with pytest.raises(RuntimeError, match="plan"):
        FA.plan(hd + 4)


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
    # fp16 goes through the kernel (the bf16 form's, on fp16 operands) too
    q16, k16, v16 = (t.transpose(1, 2).half() for t in (q, k, v))
    n0 = FA.LAUNCHES
    got16 = FA.flash_attention(q16, k16, v16)
    assert FA.LAUNCHES == n0 + 1 and got16.dtype == torch.float16
    ref16 = flash_attention_ref(q16, k16, v16)
    torch.cuda.synchronize()
    assert rel(got16.float(), ref16.float()) <= B5_F16_TOL
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        FA.flash_attention(*(t.transpose(1, 2).double() for t in (q, k, v)))


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


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "qwen3-moe-235b-a22b",
                                  "mamba2-780m", "jamba-1.5-large-398b"])
def test_lm_kinds_on_the_card(card, arch):
    """The moe, ssm and hybrid kinds (REDUCED, fp32) on CUDA tensors: B5
    once per attention layer of the prefill and never in decode; the
    kernel path's forward within 1e-4 of the plain path's and the same
    greedy tokens."""
    from repro_torch.configs import registry as TR
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.models import transformer as TT
    from repro_torch.training import serve as TS
    cfg = TR.get_config(arch, reduced=True)
    n_attn = sum(k in TT.ATTN_KINDS for k in cfg.block_pattern()) \
        * cfg.n_groups()
    params = TT.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                            device="cuda")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, size=(2, 40))).cuda()
    plain, _, _ = TT.forward(params, {"tokens": toks}, cfg, backend="torch")
    n0 = FA.LAUNCHES
    got, _, _ = TT.forward(params, {"tokens": toks}, cfg)
    torch.cuda.synchronize()
    assert FA.LAUNCHES == n0 + n_attn
    assert rel(got, plain) <= 1e-4
    n1 = FA.LAUNCHES
    out = TS.greedy_generate(cfg, params, toks, 5, s_max=48)
    assert FA.LAUNCHES == n1 + n_attn              # the prefill only
    ref = TS.greedy_generate(cfg, params, toks, 5, s_max=48,
                             backend="torch")
    assert out.shape == (2, 5) and torch.equal(out, ref)


@pytest.mark.parametrize("arch", ["whisper-medium", "llama-3.2-vision-11b"])
def test_encdec_vlm_on_the_card(card, arch):
    """The encdec and vlm kinds (REDUCED, fp32) on CUDA tensors with
    non-zero stub embeddings: B5 once per attention layer of the prefill
    (the encoder's and the cross-attention's non-causal), never in
    decode; the kernel path's prefill within 1e-4 of the plain path's and
    the same greedy tokens over 4 decode steps; greedy_generate's tokens
    equal too."""
    from repro_torch.configs import registry as TR
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.models import transformer as TT
    from repro_torch.training import serve as TS
    cfg = TR.get_config(arch, reduced=True)
    params = TT.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                            device="cuda")
    rng = np.random.default_rng(3)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, size=(2, 40))).cuda()}
    if cfg.kind == "encdec":
        shape, key = (2, cfg.enc_seq, cfg.d_model), "enc_embed"
    else:
        shape, key = (2, cfg.n_img_tokens, cfg.vision_dim), "img_embed"
    batch[key] = torch.from_numpy(
        (0.1 * rng.standard_normal(shape)).astype(np.float32)).cuda()
    want = TT.n_attention_layers(cfg)
    toks = {}
    for backend in ("torch", "auto"):
        n0 = FA.LAUNCHES
        logits, caches = TS.make_prefill_step(cfg, 48, backend=backend)(
            params, batch)
        assert FA.LAUNCHES - n0 == (want if backend == "auto" else 0)
        toks[backend] = [logits[:, -1].argmax(-1)]
        decode = TS.make_decode_step(cfg, backend=backend)
        for t in range(4):
            logits, caches = decode(params, caches, {
                "tokens": toks[backend][-1][:, None],
                "position": torch.full((2,), 40 + t, device="cuda")})
            toks[backend].append(logits[:, -1].argmax(-1))
        assert FA.LAUNCHES - n0 == (want if backend == "auto" else 0)
        toks[backend + "_logits"] = logits
    torch.cuda.synchronize()
    assert rel(toks["auto_logits"], toks["torch_logits"]) <= 1e-4
    assert all(torch.equal(a, b) for a, b in zip(toks["auto"],
                                                  toks["torch"]))
    out = TS.greedy_generate(cfg, params, batch["tokens"], 5, s_max=48)
    ref = TS.greedy_generate(cfg, params, batch["tokens"], 5, s_max=48,
                             backend="torch")
    assert torch.equal(out, ref)


def test_flash_attention_raises_under_grad_on_the_card(card):
    """ROADMAP C9: B5 has no backward, so on tensors that require grad it
    raises (naming backend="torch") instead of returning an output with no
    grad_fn; under no_grad it launches."""
    from repro_torch.kernels.flash_attention import flash_attention as FA
    q = torch.randn(1, 4, 32, 64, device="cuda", requires_grad=True)
    k = torch.randn(1, 2, 32, 64, device="cuda")
    n0 = FA.LAUNCHES
    with pytest.raises(RuntimeError, match="forward only"):
        FA.flash_attention(q, k, k)
    assert FA.LAUNCHES == n0
    with torch.no_grad():
        out = FA.flash_attention(q, k, k)
    assert FA.LAUNCHES == n0 + 1 and out.grad_fn is None


def test_train_step_on_the_card_matches_cpu(card):
    """One make_grad_fn of llama3.2-3b REDUCED (fp32) on the card against
    the CPU from the same weights and batch: the loss and the gradients
    within 1e-4 of the max-abs gradient, and no B5 launch (training
    differentiates the plain attention)."""
    from repro_torch.configs import registry as TR
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.models import transformer as TT
    from repro_torch.training import data as TD
    from repro_torch.training import train as TTR
    cfg = TR.get_config("llama3.2-3b", reduced=True)
    params = TT.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                            device="cuda")
    batch = TD.synthetic_batch(TD.DataConfig(cfg.vocab, 32, 4), 0,
                               device="cuda")
    n0 = FA.LAUNCHES
    (lc, _), gc = TTR.make_grad_fn(cfg)(params, batch)
    host = lambda tree: {k: host(v) if isinstance(v, dict) else v.cpu()
                         for k, v in tree.items()}
    (lh, _), gh = TTR.make_grad_fn(cfg)(host(params), host(batch))
    assert FA.LAUNCHES == n0
    assert abs(float(lc) - float(lh)) <= 1e-4 * abs(float(lh))
    pairs = list(zip(TT.leaves(host(gc)), TT.leaves(gh)))
    scale = max(float(b.abs().max()) for _, b in pairs)
    assert max(float((a - b).abs().max()) for a, b in pairs) <= 1e-4 * scale


# --------------------------------------------------------------------------
# The block legs, the reuse engine and mesh fields on the card
# --------------------------------------------------------------------------

def _slab_case(n0, n_own, H, row0, seed):
    """A (n0, 8, 8) mesh of an (n0 / 8, 1, 1) box, 3000 particles, and the
    block of global rows [row0, row0 + n_own + 2H); the particles whose
    row lies in the block (owned and halo rows, so some supports leave
    the block and are dropped)."""
    rng = np.random.default_rng(seed)
    kw = dict(shape=(n0, 8, 8), box_lo=(0.0, 0.0, 0.0),
              box_hi=(n0 / 8.0, 1.0, 1.0), periodic=(True, True, True))
    x = (rng.uniform(size=(3000, 3)) * np.asarray(kw["box_hi"])).astype(
        np.float32)
    rows = n_own + 2 * H
    rel_row = np.mod(np.floor(x[:, 0] * 8.0).astype(np.int64) - row0, n0)
    mine = rel_row < rows
    val = rng.normal(size=(3000, 3)).astype(np.float32)
    blk = rng.normal(size=(rows, 8, 8, 4)).astype(np.float32)
    t = lambda a: torch.from_numpy(a).cuda()
    return kw, t(x), t(val), t(mine), t(blk), rows, \
        torch.tensor(row0, dtype=torch.int32, device="cuda")


# (n0, owned rows, halo, row0): local tori of rows_k / cb = 2 and 3 buckets
# at the seam (row0 < 0), 8 buckets inside and at the seam
@pytest.mark.parametrize("n0,n_own,H,row0", [
    (16, 4, 2, -2), (16, 8, 2, -2), (64, 28, 2, 20), (64, 28, 2, -2),
    (64, 26, 3, 30)])
def test_cuda_block_legs_match_plain(card, n0, n_own, H, row0):
    """ops.p2m_block / m2p_fused_block launch B3 / B4 once each on the
    block's local torus and agree with their plain versions there and
    with the plain core.interp block legs (<= TOL; at these few rows the
    local torus's float32 re-origin is far below it), with the same drop
    counts."""
    from repro_torch.core import interp as TIP
    kw, x, val, mine, blk, rows, r0 = _slab_case(n0, n_own, H, row0,
                                                 seed=n0 + row0)
    assert -(-rows // CB) in (2, 3, 8)
    n_p2m, n_m2p = TK.LAUNCHES["p2m"], TK.LAUNCHES["m2p"]
    got, ovf = TM4.p2m_block(x, val, mine, r0, block_rows=rows,
                             cell_cap=256, **kw)
    (gu, gr), ovf_m = TM4.m2p_fused_block((blk[..., :3], blk[..., 3]), x,
                                          mine, r0, cell_cap=256, **kw)
    assert TK.LAUNCHES["p2m"] == n_p2m + 1 and TK.LAUNCHES["m2p"] == n_m2p + 1
    pb, _ = TM4.p2m_block(x, val, mine, r0, block_rows=rows, cell_cap=256,
                          backend="torch", **kw)
    (pu, pr), _ = TM4.m2p_fused_block((blk[..., :3], blk[..., 3]), x, mine,
                                      r0, cell_cap=256, backend="torch",
                                      **kw)
    assert rel(got, pb) <= TOL and rel(gu, pu) <= TOL and rel(gr, pr) <= TOL
    ref, drop = TIP.p2m_block(x, val, mine, r0, block_rows=rows, **kw)
    ru, drop_m = TIP.m2p_block(blk[..., :3].contiguous(), x, mine, r0, **kw)
    rr, _ = TIP.m2p_block(blk[..., 3].contiguous(), x, mine, r0, **kw)
    torch.cuda.synchronize()
    assert int(drop) > 0 and int(ovf) == int(drop) == int(ovf_m) \
        == int(drop_m)
    assert rel(got, ref) <= TOL
    assert rel(gu, ru) <= TOL and rel(gr, rr) <= TOL


def test_cuda_md_reuse_matches_plain(card):
    """md.run(reuse="skin") through B1 (1 + 1 launch per step) against the
    same run on the plain path (backend torch), and the every-step kernel
    path after 20 steps."""
    from repro_torch.apps import md
    from repro_torch.kernels.cell_pair import cell_pair as CP
    cfg = md.MDConfig(n_per_side=6, sigma=0.085, cell_cap=96, device="cuda")
    n0 = CP.LAUNCHES_BY_KIND["lj"]
    pk, _ = md.run(cfg, 20, thermal_v=0.4, seed=2, reuse="skin")
    assert CP.LAUNCHES_BY_KIND["lj"] == n0 + 21
    pp, _ = md.run(dataclasses.replace(cfg, backend="torch"), 20,
                   thermal_v=0.4, seed=2, reuse="skin")
    pe, _ = md.run(cfg, 20, thermal_v=0.4, seed=2)
    torch.cuda.synchronize()
    vm = pk.valid
    assert rel(pk.x[vm], pp.x[vm]) <= 1e-4
    assert rel(pk.props["v"][vm], pp.props["v"][vm]) <= 1e-4
    assert rel(pk.x[vm], pe.x[vm]) <= 1e-4


def test_mesh_field_step_on_the_card(card, monkeypatch):
    """The toy mesh-field physics with the card's bodies (the LJ functor
    at epsilon 0 through B1, the deposit through B3 on the block's local
    torus): the step's first_row is on the card, each step launches B1
    and B3 once, and 4 steps agree with the plain path (backend torch)."""
    from repro_torch.core import grid as G
    from repro_torch.core import particles as P
    from repro_torch.core import simulation as SIM
    from repro_torch.kernels.cell_pair import cell_pair as CP
    seen = []
    first_row = G.GridOps.first_row

    def spy(self, n_local):
        row = first_row(self, n_local)
        seen.append(row.device)
        return row

    monkeypatch.setattr(G.GridOps, "first_row", spy)
    cfg = ToyCfg(kernel=True)
    rng = np.random.default_rng(21)
    x = torch.from_numpy((rng.uniform(0, 1, (cfg.n, 3))
                          * np.asarray(cfg.box)).astype(np.float32)).cuda()
    ps = SIM.with_ids(P.from_positions(x))
    rho0 = torch.zeros(cfg.shape, device="cuda")
    out = {}
    for backend in ("auto", "torch"):
        c = dataclasses.replace(cfg, backend=backend)
        st = SIM.serial_state(ps, toy_physics, c, fields={"rho": rho0})
        step = SIM.make_sim_step(toy_physics, c)
        n_b1, n_b3 = CP.LAUNCHES_BY_KIND["lj"], TK.LAUNCHES["p2m"]
        for _ in range(4):
            st, flags, _ = step(st, {})
            assert int(flags.any()) == 0
        launched = (CP.LAUNCHES_BY_KIND["lj"] - n_b1,
                    TK.LAUNCHES["p2m"] - n_b3)
        assert launched == ((4, 4) if backend == "auto" else (0, 0))
        out[backend] = st.fields["rho"]
    assert len(seen) == 8 and all(d.type == "cuda" for d in seen)
    assert float(out["auto"].sum()) > cfg.n * 3.99
    assert rel(out["auto"], out["torch"]) <= TOL


def test_four_card_sharded_lm_matches_one_card():
    """The sharded LM stack on 4 cards, one NCCL rank each under torchrun
    (tests/_torch_dist.py --nccl-lm): llama3.2-3b and gemma-2b FULL fp32
    at (1, 4) against one card (gemma decoding past its first 256-row
    cache shard), llama3.2-3b again under repro's sequence-parallel
    attention (B5 on each rank's rows at their offset; every part counts
    one B5 launch per attention layer on a rank's prefill),
    qwen2-moe-a2.7b FULL bf16 through moe_map_local
    (capacity factor 8: nothing dropped) against the dense oracle, with
    its decode step's device time,
    jamba-1.5-large's 2-layer cut against one card and one FULL 8-layer
    period (88 GB in bf16) served as 22 GB blocks, and a training step of
    llama3.2-3b's 2-layer cut at (2, 2) with FSDP weights."""
    import os
    import subprocess
    import sys
    import _torch_dist as TD
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA cards (torch.cuda.device_count() is "
                    f"{torch.cuda.device_count()})")
    env = dict(os.environ, PYTHONPATH=str(TD.ROOT / "src"))
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    r = subprocess.run([sys.executable, "-m", "torch.distributed.run",
                        "--standalone", "--nproc_per_node=4", TD.__file__,
                        "--nccl-lm"], cwd=TD.ROOT, env=env,
                       capture_output=True, text=True, timeout=1500)
    print(r.stdout[-20000:])
    assert r.returncode == 0, r.stdout[-6000:] + r.stderr[-12000:]
