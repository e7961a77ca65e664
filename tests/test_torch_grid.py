"""repro_torch's serial grid layer against repro's: halo_pad_local (periodic,
fill, edge replication; halo 1 and 2), pad_axis, halo_reduce_local,
GridOps() ghost_get/ghost_put (and on 1-rank meshes the slab and pencil
exchanges), serial_field, apply_stencil_local and grid_coords on
numpy-seeded fields. The work is data movement and at most
one add per element, so every result is equal bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import np_

from repro.core import grid as JG
from repro_torch.core import grid as TG
from repro_torch.core import runtime as TRT
from repro_torch.core import simulation as TSIM


def _world1():
    """A 1-rank gloo mesh in this process."""
    return TRT.make_mesh((1,), ("shards",), device_type="cpu")


def _field(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _same(got, ref):
    got, ref = np_(got), np_(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


MODES = [dict(periodic=True), dict(periodic=False, fill=0.0),
         dict(periodic=False, fill=-1.5), dict(periodic=False, fill=None)]


@pytest.mark.parametrize("halo", [0, 1, 2])
@pytest.mark.parametrize("mode", MODES, ids=["periodic", "fill0", "fill",
                                             "edge"])
def test_halo_pad_local_matches_repro(halo, mode):
    a = _field((7, 5, 3), seed=halo)
    _same(TG.halo_pad_local(torch.from_numpy(a), halo, **mode),
          JG.halo_pad_local(jnp.asarray(a), halo, **mode))


@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("mode", MODES[:2] + MODES[3:],
                         ids=["periodic", "fill0", "edge"])
def test_pad_axis_matches_repro(axis, mode):
    a = _field((6, 5, 4), seed=10 + axis)
    _same(TG.pad_axis(torch.from_numpy(a), axis, 2, **mode),
          JG.pad_axis(jnp.asarray(a), axis, 2, **mode))


@pytest.mark.parametrize("halo", [1, 2])
@pytest.mark.parametrize("periodic", [True, False])
def test_halo_reduce_local_matches_repro(halo, periodic):
    a = _field((9, 4, 3), seed=20 + halo)
    t = torch.from_numpy(a.copy())
    _same(TG.halo_reduce_local(t, halo, periodic=periodic),
          JG.halo_reduce_local(jnp.asarray(a), halo, periodic=periodic))
    np.testing.assert_array_equal(t.numpy(), a)       # input untouched


@pytest.mark.parametrize("fill", [0.0, None])
def test_gridops_ghost_get_put_match_repro(fill):
    a = _field((8, 6), seed=30)
    for periodic in (True, False):
        j = JG.GridOps(periodic=periodic, fill=fill)
        t = TG.GridOps(periodic=periodic, fill=fill)
        assert not t.distributed
        _same(t.ghost_get(torch.from_numpy(a), 2),
              j.ghost_get(jnp.asarray(a), 2))
        _same(t.ghost_put(torch.from_numpy(a), 2),
              j.ghost_put(jnp.asarray(a), 2))
        _same(t.first_row(8), j.first_row(8))
        # the distributed ops on one rank (a 1-rank gloo mesh) are the
        # serial ones
        d = TG.GridOps(axis_name="shards", periodic=periodic, fill=fill)
        assert d.distributed
        with TRT.on_mesh(_world1()):
            _same(d.ghost_get(torch.from_numpy(a), 2),
                  j.ghost_get(jnp.asarray(a), 2))
            _same(d.ghost_put(torch.from_numpy(a), 2),
                  j.ghost_put(jnp.asarray(a), 2))
            _same(d.first_row(8), j.first_row(8))
    # the pencil forms on a 1 x 1 mesh: the serial pad and reduce on axis
    # 0, then on axis 1 (reduce: columns first)
    with TRT.on_mesh(TRT.make_mesh((1, 1), ("rows", "cols"),
                                   device_type="cpu")):
        for periodic in (True, False):
            kw = dict(periodic=periodic, fill=fill)
            pad = TG.halo_pad2(torch.from_numpy(a), 2, "rows", "cols", **kw)
            ja = JG.pad_axis(JG.pad_axis(jnp.asarray(a), 0, 2, **kw), 1, 2,
                             **kw)
            _same(pad, ja)
            red = JG.halo_reduce_local(jnp.moveaxis(ja, 1, 0), 2,
                                       periodic=periodic)
            red = JG.halo_reduce_local(jnp.moveaxis(red, 0, 1), 2,
                                       periodic=periodic)
            _same(TG.halo_reduce2(pad, 2, "rows", "cols",
                                  periodic=periodic), red)


def test_serial_field_and_step_ctx_grid():
    a = _field((12, 3), seed=31)
    f = TG.serial_field(torch.from_numpy(a))
    j = JG.serial_field(jnp.asarray(a))
    _same(f.node_bounds, j.node_bounds)
    assert f.n_slabs == j.n_slabs == 1 and f.col_bounds is None
    assert TSIM.StepCtx.__dataclass_fields__["grid"].default \
        == TG.GridOps()


def _lap_stencil(u, v):
    """A halo-1 leading-axis stencil with a padded-shape output (trimmed)
    and an interior-shape one (kept as it is)."""
    if isinstance(u, torch.Tensor):
        lu = torch.roll(u, 1, dims=0) + torch.roll(u, -1, dims=0) - 2.0 * u
    else:
        lu = jnp.roll(u, 1, axis=0) + jnp.roll(u, -1, axis=0) - 2.0 * u
    return lu, v[1:-1] * 2.0


@pytest.mark.parametrize("periodic,fill", [(True, 0.0), (False, 0.5),
                                           (False, None)])
def test_apply_stencil_local_matches_repro(periodic, fill):
    u, v = _field((10, 4), seed=40), _field((10, 4), seed=41)
    kw = dict(periodic=periodic, fill=fill)
    ref = JG.apply_stencil_local(_lap_stencil, 1, **kw)(jnp.asarray(u),
                                                        jnp.asarray(v))
    for overlap in (False, True):     # serially the blocking path
        got = TG.apply_stencil_local(_lap_stencil, 1, overlap=overlap, **kw)(
            torch.from_numpy(u), torch.from_numpy(v))
        for g, r in zip(got, ref):
            _same(g, r)
    # on one rank (a 1-rank gloo mesh) the distributed engine is the
    # serial one; its overlap schedule needs an n-rows-to-n-rows stencil
    with TRT.on_mesh(_world1()):
        got = TG.apply_stencil_local(_lap_stencil, 1, "shards", **kw)(
            torch.from_numpy(u), torch.from_numpy(v))
        for g, r in zip(got, ref):
            _same(g, r)
        with pytest.raises(ValueError, match="n-rows-to-n-rows"):
            TG.apply_stencil_local(_lap_stencil, 1, "shards", overlap=True,
                                   **kw)(torch.from_numpy(u),
                                         torch.from_numpy(v))


@pytest.mark.parametrize("shape,lo,hi", [((4, 6), (0.0, -1.0), (1.0, 2.5)),
                                         ((5, 3, 7), (0.1, 0.0, -0.3),
                                          (2.2, 1.0, 0.7))])
def test_grid_coords_matches_repro(shape, lo, hi):
    _same(TG.grid_coords(shape, lo, hi, device="cpu"),
          JG.grid_coords(shape, lo, hi))
