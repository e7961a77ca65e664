"""The CUDA kernels against their plain PyTorch versions, on the card.
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
