"""The bf16x forms of the port's pair bodies against repro's (the
mixed-precision mode of repro's core/interactions.py: fp32 geometry, bf16
body operands, fp32 sums), on the CPU: the plain path against repro's jnp
path and its Pallas kernel in interpret mode.

repro's bodies run under jnp, whose weak typing rounds a Python number to
bf16 before the op; the port's bodies do the same through
``interactions.weak`` and ``interactions.div_scalar``. XLA keeps excess
precision through some bf16 roundings by default
(``--xla_allow_excess_precision``), so in this process the two differ by
flipped roundings, held at 4e-3 of the largest value. In a process where
XLA rounds every op they agree to the summation order, and the DEM forces
bit for bit (the last test)."""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import pytest
import torch

from _torch_bridge import case_state, rel, to_torch
from benchmarks import backend_compare as BC
from test_torch_sph import _tiles

from repro.apps import dem as jdem
from repro.apps import sph as jsph
from repro.kernels.cell_pair import cell_pair as JCP
from repro_torch.apps import dem as tdem
from repro_torch.apps import sph as tsph
from repro_torch.kernels.sph_forces import sph_forces as tsf

BF16_TOL = 4e-3
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _tdem(cfg, **kw):
    return tdem.DEMConfig(box=cfg.box, fill=cfg.fill, k_max=cfg.k_max,
                          cell_cap=cfg.cell_cap, device="cpu", **kw)


def _tsph(cfg, **kw):
    return tsph.SPHConfig(dim=cfg.dim, dp=cfg.dp, box=cfg.box,
                          fluid=cfg.fluid, cell_cap=cfg.cell_cap,
                          device="cpu", **kw)


def test_dem_bf16x_normal_forces_match():
    """DEM normal forces in bf16x on the settled avalanche: the plain path
    against repro's jnp path and its Pallas kernel, and unlike fp32."""
    cfg, jps = BC.dem_settled()
    tps = to_torch(jps)
    c16 = dataclasses.replace(cfg, precision="bf16x")
    f_t, _ = tdem.normal_forces(tps, _tdem(cfg, precision="bf16x"))
    f_j, _ = jdem.normal_forces(jps, c16)
    f_p, _ = jdem.normal_forces(jps, c16, backend="pallas", interpret=True)
    assert rel(f_t, f_j) <= BF16_TOL
    assert rel(f_t, f_p) <= BF16_TOL
    f32, _ = tdem.normal_forces(tps, _tdem(cfg))
    assert rel(f_t, f32) > 0            # bf16 really used


@pytest.mark.parametrize("precision", ["bf16x", "bf16x:drho"])
def test_sph_bf16x_rates_match(precision):
    """SPH rates in bf16x and bf16x:drho on backend_compare's developed
    dam break: a and drho against repro's jnp path."""
    cfg, jps = case_state(BC.sph_case)
    tps = to_torch(jps)
    a_t, d_t, _ = tsph.compute_rates(tps, _tsph(cfg, precision=precision))
    a_j, d_j, _ = jsph.compute_rates(
        jps, dataclasses.replace(cfg, precision=precision))
    assert rel(a_t, a_j) <= BF16_TOL
    assert rel(d_t, d_j) <= BF16_TOL


@pytest.mark.parametrize("dim,precision", [(2, "bf16x"), (3, "bf16x"),
                                           (2, "bf16x:drho")])
def test_sph_bf16x_tiles_match_pallas(dim, precision):
    """The SPH body over cell tiles in bf16x: the port's plain tile version
    against repro's Pallas kernel in interpret mode, per output."""
    cfg = jsph.SPHConfig(dim=dim, dp=0.05, box=(1.0, 0.5, 0.5)[:dim],
                         fluid=(0.25,) * dim)
    cx, nx, cv, nv, cr, nr, cm, nm = _tiles(dim, 4, 8, 20 + dim)
    out = JCP.cell_pair_pallas(
        *map(jnp.asarray, (cx, nx, cm, nm)),
        {"v": jnp.asarray(cv), "rho": jnp.asarray(cr)},
        {"v": jnp.asarray(nv), "rho": jnp.asarray(nr)},
        body=jsph.sph_pair_body(cfg), out={"a": "radial", "drho": "scalar"},
        r_cut=cfg.r_cut, interpret=True, precision=precision)
    tt = [torch.from_numpy(a) for a in (cx, nx, cv, nv, cr, nr, cm, nm)]
    a_t, d_t = tsf.sph_cell_forces(*tt, cfg=_tsph(cfg, precision=precision))
    assert rel(a_t, out["a"]) <= BF16_TOL
    assert rel(d_t, out["drho"]) <= BF16_TOL
    a32, d32 = tsf.sph_cell_forces(*tt, cfg=_tsph(cfg))
    assert rel(d_t, d32) > 0            # bf16 really used


# Run in a process of its own: XLA reads XLA_FLAGS once, at start-up.
_NO_EXCESS = r"""
import dataclasses, json
from _torch_bridge import case_state, rel, to_torch
from benchmarks import backend_compare as BC
from repro.apps import dem as jdem, md as jmd, sph as jsph
from repro_torch.apps import dem as tdem, md as tmd, sph as tsph
from test_torch_bf16x import _tdem, _tsph
gaps = {}
cfg, jps = BC.dem_settled()
f_t, _ = tdem.normal_forces(to_torch(jps), _tdem(cfg, precision="bf16x"))
f_j, _ = jdem.normal_forces(jps, dataclasses.replace(cfg, precision="bf16x"))
gaps["dem"] = rel(f_t, f_j)
cfg, jps = case_state(BC.sph_case)
a_t, d_t, _ = tsph.compute_rates(to_torch(jps), _tsph(cfg, precision="bf16x"))
a_j, d_j, _ = jsph.compute_rates(jps, dataclasses.replace(cfg,
                                                          precision="bf16x"))
gaps["sph_a"], gaps["sph_drho"] = rel(a_t, a_j), rel(d_t, d_j)
cfg, jps = case_state(BC.md_case)
f_j = jmd.compute_forces(jps, dataclasses.replace(cfg, precision="bf16x"))[0]
f_t = tmd.compute_forces(to_torch(jps), tmd.MDConfig(
    n_per_side=cfg.n_per_side, device="cpu", precision="bf16x"))[0]
gaps["lj"] = rel(f_t.props["f"], f_j.props["f"])
print(json.dumps(gaps))
"""


def test_bf16x_equals_repro_when_xla_rounds_every_op():
    """With --xla_allow_excess_precision=false, repro rounds every bf16 op
    as the port does: the DEM forces agree bit for bit, SPH and LJ to the
    fp32 summation order."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "") +
                          " --xla_allow_excess_precision=false").strip(),
               PYTHONPATH=os.pathsep.join(
                   str(ROOT / p) for p in ("src", "tests", ".")))
    r = subprocess.run([sys.executable, "-c", _NO_EXCESS], env=env,
                       cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    gaps = json.loads(r.stdout.strip().splitlines()[-1])
    assert gaps["dem"] == 0.0, gaps
    for name in ("sph_a", "sph_drho", "lj"):
        assert gaps[name] <= 1e-6, gaps
