"""repro_torch MD (the slice's main path, on the CPU) against repro: forces,
a 50-step trajectory from a converted JAX state, energies, energy
conservation, and the step flags."""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_bridge import case_state, np_, rel, to_torch
from benchmarks import backend_compare as BC

from repro.apps import md as jmd
from repro.core import simulation as JSIM
from repro_torch.apps import md as tmd
from repro_torch.core import simulation as TSIM
from repro_torch.kernels.lj_cell import lj_cell, ops as lj_ops
from repro_torch.kernels.cell_pair import cell_pair as TCP
from repro_torch.core import cell_list as TCL


def _tcfg(cfg, **kw):
    """The port's MDConfig with the same physics as a repro one."""
    return tmd.MDConfig(n_per_side=cfg.n_per_side, sigma=cfg.sigma,
                        epsilon=cfg.epsilon, dt=cfg.dt, box=cfg.box,
                        cell_cap=cfg.cell_cap,
                        capacity_factor=cfg.capacity_factor, dim=cfg.dim,
                        device="cpu", **kw)


def test_compute_forces_matches_jnp():
    cfg, jps = case_state(BC.md_case)
    ref, ovf_ref = jmd.compute_forces(jps, cfg)
    got, ovf = tmd.compute_forces(to_torch(jps), _tcfg(cfg))
    assert rel(got.props["f"], ref.props["f"]) <= 1e-5
    assert int(ovf) == int(ovf_ref) == 0
    f_ops, _ = lj_ops.forces(to_torch(jps), _tcfg(cfg))
    assert rel(f_ops, ref.props["f"]) <= 1e-5


def test_lj_cell_forces_wrapper_matches_tiles():
    cfg, jps = case_state(BC.md_case)
    tps = to_torch(jps)
    t = TCP.gather_cell_tiles(tps, TCL.build_cell_list(tps,
                                                      **jmd._cl_kw(cfg)))
    f = lj_cell.lj_cell_forces(t.cell_x, t.nbr_x, t.cell_mask, t.nbr_mask,
                               sigma=cfg.sigma, epsilon=cfg.epsilon,
                               r_cut=cfg.r_cut)
    ref, _ = jmd.compute_forces(jps, cfg)
    valid = np_(jps.valid)
    assert rel(np_(TCP.scatter_slots(t.rows, f, tps.capacity))[valid],
               np_(ref.props["f"])[valid]) <= 1e-5


def test_trajectory_and_energies_match():
    """From repro's md.run(cfg, 0, thermal_v=0.4) state, 50 md_steps in
    both packages agree to 1e-4 in x and v; energies agree to 1e-5."""
    cfg = jmd.MDConfig(n_per_side=6, sigma=0.085)
    jps, _ = jmd.run(cfg, 0, thermal_v=0.4)
    tps = to_torch(jps)
    tcfg = _tcfg(cfg)
    for _ in range(50):
        jps, _ = jmd.md_step(jps, cfg)
        tps, flag = tmd.md_step(tps, tcfg)
        assert int(flag) == 0
    valid = np_(jps.valid)
    assert (np_(tps.valid) == valid).all()
    assert rel(np_(tps.x)[valid], np_(jps.x)[valid]) <= 1e-4
    assert rel(np_(tps.props["v"])[valid],
               np_(jps.props["v"])[valid]) <= 1e-4
    ek_j, ep_j = jmd.energies(jps, cfg)
    ek_t, ep_t = tmd.energies(tps, tcfg)
    # same state for the energy comparison: the converted JAX state
    ek_s, ep_s = tmd.energies(to_torch(jps), tcfg)
    assert abs(float(ek_s) - float(ek_j)) <= 1e-5 * abs(float(ek_j))
    assert abs(float(ep_s) - float(ep_j)) <= 1e-5 * abs(float(ep_j))
    assert abs(float(ek_t) - float(ek_j)) <= 1e-3 * abs(float(ek_j))
    assert abs(float(ep_t) - float(ep_j)) <= 1e-3 * abs(float(ep_j))


def test_md_energy_conservation():
    """§4.1 criterion, as test_md_energy_conservation_pallas_backend."""
    cfg = tmd.MDConfig(n_per_side=5, dt=0.0005, device="cpu")
    ps, log = tmd.run(cfg, 30, thermal_v=0.5, log_every=10)
    es = [k + p for _, k, p in log]
    assert len(log) == 4 and np.isfinite(es).all()
    drift = abs(es[-1] - es[0]) / (abs(es[0]) + 1e-9)
    assert drift < 0.05, f"energy drift {drift}"


def _flags(step_out):
    _, flags, _ = step_out
    return {f.name: int(getattr(flags, f.name))
            for f in dataclasses.fields(flags)}


@pytest.mark.parametrize("cell_cap", [48, 4])
def test_serial_flags_match(cell_cap):
    """Serial flags are zero on a healthy state; cell overflow surfaces in
    StepFlags.cell with repro's value."""
    cfg = dataclasses.replace(case_state(BC.md_case)[0], cell_cap=cell_cap)
    _, jps = case_state(BC.md_case)
    tcfg = _tcfg(cfg)
    a = _flags(JSIM.make_sim_step(jmd.physics, cfg)(
        JSIM.serial_state(jps, jmd.physics, cfg), {}))
    b = _flags(TSIM.make_sim_step(tmd.physics, tcfg)(
        TSIM.serial_state(to_torch(jps), tmd.physics, tcfg), {}))
    assert b == a
    if cell_cap == 4:
        assert b["cell"] > 0
        with pytest.raises(RuntimeError, match="overflow"):
            tmd.run(tcfg, 2)
    else:
        assert max(b.values()) == 0


def test_unported_engine_options_raise():
    """What still raises on a 2-D (pencil) mesh, as in repro: mesh fields
    (make_sim_step and distribute name the pencil VIC step instead), and
    a pencil over a physics with no second space axis. The serial step
    ignores the mesh options (overlap, n_hops), as repro's does, and
    Reduce takes an axis name or a tuple of them."""
    from _torch_bridge import ToyCfg, toy_physics
    from repro_torch.apps import sph as tsph
    from repro_torch.core import runtime as TRT

    class Pencil:
        """What the engine reads of a 2-D (1, 2) mesh."""
        mesh_dim_names = ("rows", "cols")

        def size(self, i):
            return (1, 2)[i]

    pencil = Pencil()
    axes = ("rows", "cols")
    for kw in (dict(), dict(reuse="skin")):
        with pytest.raises(NotImplementedError, match="pencil VIC"):
            TSIM.make_sim_step(toy_physics, ToyCfg(), pencil,
                               axis_name=axes, **kw)
    tcfg = tmd.MDConfig(n_per_side=3, device="cpu")
    with pytest.raises(NotImplementedError, match="pencil VIC"):
        TSIM.distribute(tmd.init_particles(tcfg), tmd.physics, tcfg, pencil,
                        axis_name=axes, fields={"rho": torch.zeros(4)})
    scfg = tsph.SPHConfig(dp=0.05, box=(1.0, 0.5), fluid=(0.25, 0.25),
                          device="cpu")
    with TRT.on_mesh(pencil), pytest.raises(ValueError, match="space axis"):
        TSIM.make_sim_step(tsph.physics, scfg, pencil, axis_name=axes,
                           slab_axis=1)
    serial = TSIM.make_sim_step(tmd.physics, tcfg)
    for kw in (dict(overlap=False), dict(n_hops=2)):
        assert TSIM.make_sim_step(tmd.physics, tcfg, **kw) is serial
    assert TSIM.Reduce("shards").distributed
    assert TSIM.Reduce(axes).distributed


def test_with_ids_and_serial_state():
    tps = tmd.init_particles(tmd.MDConfig(n_per_side=3, device="cpu"))
    ids = TSIM.with_ids(tps).props["id"]
    assert ids.dtype == torch.int32
    assert np_(ids)[:27].tolist() == list(range(27))
    st = TSIM.serial_state(tps, tmd.physics, tmd.MDConfig(device="cpu"))
    assert st.n_slabs == 1 and np_(st.bounds).tolist() == [0.0, 1.0]
