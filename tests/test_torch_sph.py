"""repro_torch SPH (the dam break of paper §4.2, on the CPU) against repro:
the SPH pair body over cell tiles against repro's tile oracle and its
Pallas kernel (interpret mode), the rates on a developed dam-break state,
the initial lattice, a 5-step trajectory, and the engine's scalars."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import case_state, np_, rel, to_torch
from benchmarks import backend_compare as BC

from repro.apps import sph as jsph
from repro.core import simulation as JSIM
from repro.kernels.sph_forces.ref import sph_cell_forces_ref as jref
from repro.kernels.sph_forces.sph_forces import sph_cell_forces as jpallas
from repro_torch.apps import sph as tsph
from repro_torch.core import simulation as TSIM
from repro_torch.kernels.cell_pair import cell_pair as TCP
from repro_torch.kernels.sph_forces import ops as tops
from repro_torch.kernels.sph_forces import ref as tref
from repro_torch.kernels.sph_forces import sph_forces as tsf

TOL = 1e-4       # benchmarks/backend_compare.py::TOL, repro's jnp vs Pallas


def _tcfg(cfg, **kw):
    """The port's SPHConfig with the same physics as a repro one."""
    return tsph.SPHConfig(dim=cfg.dim, dp=cfg.dp, box=cfg.box,
                          fluid=cfg.fluid, cell_cap=cfg.cell_cap,
                          device="cpu", **kw)


def _tiles(dim, C, cc, seed):
    """tests/test_kernels.py::test_sph_cell_matches_ref's tiles with numpy
    draws: K = 3^dim neighbour cells, positions in a 0.2 box."""
    rng = np.random.default_rng(seed)
    K = 3 ** dim
    u = lambda *s: rng.uniform(size=s).astype(np.float32)
    nrm = lambda *s: rng.normal(size=s).astype(np.float32)
    return (0.2 * u(C, cc, dim), 0.2 * u(C, K * cc, dim), nrm(C, cc, dim),
            nrm(C, K * cc, dim),
            (1000.0 * (1 + 0.02 * nrm(C, cc))).astype(np.float32),
            (1000.0 * (1 + 0.02 * nrm(C, K * cc))).astype(np.float32),
            u(C, cc) > 0.2, u(C, K * cc) > 0.2)


@pytest.mark.parametrize("dim,C,cc,seed", [(2, 4, 8, 0), (2, 3, 16, 1),
                                           (3, 2, 8, 2)])
def test_sph_tiles_match_ref_and_pallas(dim, C, cc, seed):
    """The port's SPH body through cell_pair_torch (and its sph_forces
    wrappers) against repro's tile oracle and its Pallas kernel in
    interpret mode; atol 2e-5 after scaling by max + 1, as in
    tests/test_kernels.py."""
    cfg = jsph.SPHConfig(dim=dim, dp=0.05, box=(1.0, 0.5, 0.5)[:dim],
                         fluid=(0.25,) * dim)
    tcfg = _tcfg(cfg)
    arrs = _tiles(dim, C, cc, seed)
    a_ref, d_ref = jref(*map(jnp.asarray, arrs), cfg=cfg)
    a_pal, d_pal = jpallas(*map(jnp.asarray, arrs), cfg=cfg, interpret=True)
    tt = [torch.from_numpy(a) for a in arrs]
    a_t, d_t = tsf.sph_cell_forces(*tt, cfg=tcfg)
    a_r, d_r = tref.sph_cell_forces_ref(*tt, cfg=tcfg)
    sa = float(jnp.abs(a_ref).max()) + 1.0
    sd = float(jnp.abs(d_ref).max()) + 1.0
    for a, d in ((a_t, d_t), (a_r, d_r), (a_pal, d_pal)):
        np.testing.assert_allclose(np_(a) / sa, np_(a_ref) / sa, atol=2e-5)
        np.testing.assert_allclose(np_(d) / sd, np_(d_ref) / sd, atol=2e-5)
    np.testing.assert_allclose(np_(a_t) / sa, np_(a_pal) / sa, atol=2e-5)


def test_sph_rates_match():
    """compute_rates on backend_compare's developed dam break: a and drho
    to 1e-4, the same overflow; the kernel-backed op agrees too."""
    cfg, jps = case_state(BC.sph_case)
    a_j, d_j, o_j = jsph.compute_rates(jps, cfg)
    tps = to_torch(jps)
    a_t, d_t, o_t = tsph.compute_rates(tps, _tcfg(cfg))
    assert rel(a_t, a_j) <= TOL
    assert rel(d_t, d_j) <= TOL
    assert int(o_t) == int(o_j) == 0
    a_o, d_o, _ = tops.compute_rates(tps, _tcfg(cfg))
    assert rel(a_o, a_t) == 0.0 and rel(d_o, d_t) == 0.0


def test_sph_bf16x_drho_on_plain_path():
    """precision="bf16x:drho" on the plain path: the force pass keeps
    fp32 (a bit for bit), the density rate runs on bf16 operands (close
    to fp32, not equal) and stays near repro's bf16x:drho."""
    cfg, jps = case_state(BC.sph_case)
    tps = to_torch(jps)
    a32, d32, _ = tsph.compute_rates(tps, _tcfg(cfg))
    a16, d16, _ = tsph.compute_rates(tps, _tcfg(cfg, precision="bf16x:drho"))
    assert rel(a16, a32) == 0.0
    assert 0.0 < rel(d16, d32) <= 2e-2
    _, d_j, _ = jsph.compute_rates(
        jps, dataclasses.replace(cfg, precision="bf16x:drho"))
    assert rel(d16, d_j) <= 2e-2


def test_sph_init_and_trajectory_match():
    """init_dam_break equals repro's bitwise (a numpy lattice); 5
    sph_steps (an Euler step, then Verlet) match: x, v, rho to 1e-4, dt to
    1e-5; run() sums the same simulated time."""
    cfg = jsph.SPHConfig(dp=0.04, box=(1.0, 0.5), fluid=(0.25, 0.25))
    tcfg = _tcfg(cfg)
    jps = jsph.init_dam_break(cfg)
    tps = tsph.init_dam_break(tcfg)
    np.testing.assert_array_equal(np_(tps.x), np_(jps.x))
    np.testing.assert_array_equal(np_(tps.valid), np_(jps.valid))
    assert sorted(tps.props) == sorted(jps.props)
    for k in jps.props:
        np.testing.assert_array_equal(np_(tps.props[k]), np_(jps.props[k]),
                                      err_msg=k)
    t_j = t_t = 0.0
    for i in range(5):
        jps, dt_j, _ = jsph.sph_step(jps, cfg, euler=(i == 0))
        tps, dt_t, flag = tsph.sph_step(tps, tcfg, euler=(i == 0))
        assert int(flag) == 0
        assert abs(float(dt_t) - float(dt_j)) <= 1e-5 * float(dt_j)
        t_j += float(dt_j)
        t_t += float(dt_t)
    valid = np_(jps.valid)
    assert (np_(tps.valid) == valid).all()
    assert rel(np_(tps.x)[valid], np_(jps.x)[valid]) <= TOL
    for k in ("v", "rho"):
        assert rel(np_(tps.props[k])[valid],
                   np_(jps.props[k])[valid]) <= TOL, k
    _, t_run = tsph.run(tcfg, 5)
    assert isinstance(t_run, float)
    assert abs(t_run - t_t) <= 1e-6 * t_t and abs(t_run - t_j) <= 1e-5 * t_j


def test_sph_scalars_from_engine():
    """Per-step scalars (dt, load) flow out of make_sim_step, as in
    tests/test_simulation.py::test_sph_scalars_from_engine, and agree
    with repro's."""
    cfg = jsph.SPHConfig(dp=0.05, box=(1.0, 0.5), fluid=(0.25, 0.25))
    tcfg = _tcfg(cfg)
    jps = jsph.init_dam_break(cfg)
    tps = tsph.init_dam_break(tcfg)
    step = TSIM.make_sim_step(tsph.physics, tcfg)
    _, flags, scal = step(TSIM.serial_state(tps, tsph.physics, tcfg),
                          {"euler": True})
    assert int(flags.any()) == 0
    assert float(scal["dt"]) > 0.0
    assert tuple(scal["load"].shape) == (1,)
    assert int(scal["load"][0]) == int(tps.count())
    jstep = JSIM.make_sim_step(jsph.physics, cfg)
    _, _, jscal = jstep(JSIM.serial_state(jps, jsph.physics, cfg),
                        {"euler": jnp.asarray(True)})
    assert abs(float(scal["dt"]) - float(jscal["dt"])) \
        <= 1e-5 * float(jscal["dt"])
    assert int(scal["load"][0]) == int(jscal["load"][0])


def test_sph_kernel_body_carries_its_functor():
    """The pair body names the SPH functor with its 12 params in the
    functor's order."""
    cfg = tsph.SPHConfig(dim=3, dp=0.006, box=(1.6, 0.67, 0.4),
                         fluid=(0.4, 0.6, 0.3), cell_cap=128, device="cpu")
    body = tsph.sph_pair_body(cfg)
    assert body.cuda_kind == "sph"
    h, alpha_d = tsph.kernel_consts(cfg)
    assert body.cuda_params == (h, 1.0 / h, alpha_d, -0.75 * alpha_d,
                                1000.0, 1e-3, 7.0, cfg.b_eos, cfg.eta2,
                                -cfg.alpha * cfg.c_sound, -cfg.mass,
                                cfg.mass)
    assert len(body.cuda_params) == TCP.KINDS["sph"].n_params
