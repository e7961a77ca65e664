"""repro_torch vortex-in-cell against repro: the same projected ring state
(carried across with convert.field_from_numpy) through one vic_step on the
cell path (against use_pallas=True, interpret mode) and on the scatter
path (against use_pallas=False), a 6-step run against the reference's jnp
path, the interp_cell_cap re-provision loop and the diagnostics."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import np_, rel

from repro.apps import vortex as JV
from repro_torch import convert
from repro_torch.apps import vortex as TV

BASE = dict(shape=(16, 8, 8), lengths=(4.0, 2.0, 2.0), dt=0.02)
TOL = 1e-4      # the reference's own jnp-vs-Pallas bound for the app


def _start():
    """The projected ring, as numpy, from the reference."""
    jc = JV.VortexConfig(**BASE)
    return np.asarray(JV.project_divfree(JV.init_ring(jc), jc))


@pytest.mark.parametrize("interp,use_pallas", [("cells", True),
                                               ("scatter", False)])
def test_vic_step_matches_repro(interp, use_pallas):
    w0 = _start()
    jw, jo = JV.vic_step(jnp.asarray(w0),
                         JV.VortexConfig(use_pallas=use_pallas, **BASE))
    tw, to = TV.vic_step(convert.field_from_numpy(w0, device="cpu"),
                         TV.VortexConfig(interp=interp, device="cpu", **BASE))
    assert int(to) == int(jo) == 0
    assert tw.shape == jw.shape and tw.dtype == torch.float32
    assert rel(tw, jw) <= TOL


def test_run_matches_reference_jnp_path():
    """As tests/test_kernels.py::test_m4_vortex_pallas_path_matches_jnp:
    the port's default (cell) path over 6 steps against the reference's
    jnp path — centroid advance within 1%, field within 1e-4."""
    w0, z0, z1 = JV.run(JV.VortexConfig(**BASE), 6)
    tw, tz0, tz1 = TV.run(TV.VortexConfig(device="cpu", **BASE), 6)
    adv, tadv = z1 - z0, tz1 - tz0
    assert abs(tadv - adv) <= 0.01 * abs(adv) + 1e-6, (adv, tadv)
    assert rel(tw, w0) <= TOL
    assert bool(torch.isfinite(tw).all())


def test_step_reprovision_grows_cap_as_repro():
    """A tiny interp_cell_cap is doubled until no particle is dropped, to
    the same cap as the reference; the redone step matches."""
    w0 = _start()
    jw, jcfg = JV.step_reprovision(
        jnp.asarray(w0),
        JV.VortexConfig(use_pallas=True, interp_cell_cap=48, **BASE))
    n0 = TV.REDOS
    tw, tcfg = TV.step_reprovision(
        convert.field_from_numpy(w0, device="cpu"),
        TV.VortexConfig(interp_cell_cap=48, device="cpu", **BASE))
    assert tcfg.interp_cell_cap == jcfg.interp_cell_cap > 48
    n_redos = int(np.log2(tcfg.interp_cell_cap // 48))
    assert TV.REDOS == n0 + n_redos
    assert rel(tw, jw) <= TOL


def test_diagnostics_match_repro():
    w0 = _start()
    tc = TV.VortexConfig(device="cpu", **BASE)
    tw = convert.field_from_numpy(w0, device="cpu")
    jc = JV.VortexConfig(**BASE)
    np.testing.assert_allclose(float(TV.centroid_z(tw, tc)),
                               float(JV.centroid_z(jnp.asarray(w0), jc)),
                               rtol=1e-6)
    np.testing.assert_allclose(float(TV.enstrophy(tw)),
                               float(JV.enstrophy(jnp.asarray(w0))),
                               rtol=1e-6)
    np.testing.assert_array_equal(np_(TV._mesh_particles(tc)),
                                  np.asarray(JV._mesh_particles(jc)))


def test_unknown_interp_raises():
    tc = TV.VortexConfig(device="cpu", interp="pallas", **BASE)
    with pytest.raises(ValueError, match="unknown interp"):
        TV.vic_step(TV.init_ring(tc), tc)
