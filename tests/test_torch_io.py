"""repro_torch.io against repro.io: the VTK writers byte for byte (the
golden sample, write_grid), the checkpoint contract (round trip, async
then load, flush leaves no .tmp, corruption detected, bf16 bits, elastic
particle restart), and checkpoints read across the two packages in both
directions, rows equal exactly."""
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import particles as JP
from repro.io import checkpoint as JCK
from repro.io import vtk as JV
from repro_torch.core import particles as TP
from repro_torch.io import checkpoint as CK
from repro_torch.io import vtk as V

GOLDEN = pathlib.Path(__file__).parent / "data" / "golden_particles.vtk"


def _golden_state():
    """tests/test_io_numerics.py::test_vtk_particles_deterministic_golden's
    state."""
    rng = np.random.default_rng(42)
    x = rng.uniform(size=(8, 3)).astype(np.float32)
    v = rng.normal(size=(8, 3)).astype(np.float32)
    rho = rng.uniform(1.0, 2.0, size=8).astype(np.float32)
    valid = np.array([True] * 6 + [False] * 2)
    return x, v, rho, valid


@pytest.mark.parametrize("as_tensor", [False, True],
                         ids=["numpy", "tensor"])
def test_vtk_particles_golden_bytes(tmp_path, as_tensor):
    x, v, rho, valid = _golden_state()
    conv = torch.from_numpy if as_tensor else (lambda a: a)
    out = tmp_path / "p.vtk"
    V.write_particles(out, conv(x), {"v": conv(v), "rho": conv(rho)},
                      valid=conv(valid))
    assert out.read_bytes() == GOLDEN.read_bytes()


@pytest.mark.parametrize("shape", [(4, 3, 2), (5, 6), (3, 2, 2, 3)])
def test_vtk_grid_equals_repro(tmp_path, shape):
    f = np.random.default_rng(3).normal(size=shape).astype(np.float32)
    JV.write_grid(tmp_path / "j.vtk", f, origin=(0.5, 0, 1),
                  spacing=(0.1, 0.2, 0.3), name="u")
    V.write_grid(tmp_path / "t.vtk", torch.from_numpy(f), origin=(0.5, 0, 1),
                 spacing=(0.1, 0.2, 0.3), name="u")
    assert (tmp_path / "t.vtk").read_bytes() == \
        (tmp_path / "j.vtk").read_bytes()


def test_vtk_2d_particles_equal_repro(tmp_path):
    """2-D positions and vectors padded to 3, an int prop, a validity
    mask: the same bytes as repro's writer."""
    rng = np.random.default_rng(5)
    x = rng.uniform(size=(7, 2)).astype(np.float32)
    v = rng.normal(size=(7, 2)).astype(np.float32)
    kind = rng.integers(0, 2, size=7).astype(np.int32)
    valid = rng.uniform(size=7) > 0.3
    JV.write_particles(tmp_path / "j.vtk", x, {"v": v, "kind": kind},
                       valid=valid)
    V.write_particles(tmp_path / "t.vtk", torch.from_numpy(x),
                      {"v": torch.from_numpy(v),
                       "kind": torch.from_numpy(kind)},
                      valid=torch.from_numpy(valid))
    assert (tmp_path / "t.vtk").read_bytes() == \
        (tmp_path / "j.vtk").read_bytes()


def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(10.0),
            "b": {"c": torch.ones((3, 4), dtype=torch.bfloat16) * 1.25},
            "d": torch.tensor(3), "e": [torch.zeros(2, dtype=torch.int32)]}
    CK.save(tmp_path / "ck", tree, step=7, meta={"note": "x"})
    out, step, meta = CK.load(tmp_path / "ck", tree)
    assert step == 7 and meta["note"] == "x"
    assert out["b"]["c"].dtype == torch.bfloat16
    for a, b in zip((tree["a"], tree["b"]["c"], tree["d"], tree["e"][0]),
                    (out["a"], out["b"]["c"], out["d"], out["e"][0])):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_async_copies_before_it_returns(tmp_path):
    w = torch.full((100,), 2.5)
    CK.save(tmp_path / "ck", {"w": w}, step=1, block=False)
    w.fill_(-1.0)                 # after the call: must not reach the file
    CK.wait_all()
    out, step, _ = CK.load(tmp_path / "ck", {"w": w})
    assert step == 1 and torch.equal(out["w"], torch.full((100,), 2.5))


def test_checkpoint_flush_leaves_no_tmp(tmp_path):
    trees = {f"ck{i}": {"w": torch.full((64,), float(i))} for i in range(4)}
    with CK.async_writes():
        for name, tree in trees.items():
            CK.save(tmp_path / name, tree, step=1, block=False)
    assert list(tmp_path.glob("*.tmp")) == []
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(trees)
    for name, tree in trees.items():
        out, _, _ = CK.load(tmp_path / name, tree)
        assert torch.equal(out["w"], tree["w"])
    CK.save(tmp_path / "one", {"w": torch.ones(8)}, block=False)
    CK.flush(tmp_path / "one")
    assert (tmp_path / "one").is_dir()
    assert not (tmp_path / "one.tmp").exists()


def test_checkpoint_corruption_detected(tmp_path):
    tree = {"w": torch.arange(50.0)}
    CK.save(tmp_path / "ck", tree, step=1)
    f = tmp_path / "ck" / "leaf_00000.npy"
    data = bytearray(f.read_bytes())
    data[-1] ^= 0xFF
    f.write_bytes(bytes(data))
    with pytest.raises(IOError):
        CK.load(tmp_path / "ck", tree)


def test_latest_step(tmp_path):
    assert CK.latest_step(tmp_path / "none") is None
    for s in (3, 12, 7):
        CK.save(tmp_path / f"step_{s:08d}", {"w": torch.ones(2)}, step=s)
    assert CK.latest_step(tmp_path).name == "step_00000012"


def _jax_particles():
    x = jax.random.uniform(jax.random.PRNGKey(0), (37, 2))
    return JP.from_positions(
        x, capacity=64,
        props={"m": jnp.arange(37.0),
               "v": jax.random.normal(jax.random.PRNGKey(1), (37, 2))})


def test_repro_particles_load_in_the_port(tmp_path):
    """repro's save_particles, read by the port's load_particles (elastic:
    a new capacity): the valid rows equal exactly."""
    jps = _jax_particles()
    JCK.save_particles(tmp_path / "pk", jps, step=11)
    ps, step, meta = CK.load_particles(tmp_path / "pk", capacity=128,
                                       device="cpu")
    assert step == 11 and meta["n"] == 37
    assert ps.capacity == 128 and int(ps.count()) == 37
    valid = np.asarray(jps.valid)
    np.testing.assert_array_equal(ps.x[ps.valid].numpy(),
                                  np.asarray(jps.x)[valid])
    for k in ("m", "v"):
        np.testing.assert_array_equal(ps.props[k][ps.valid].numpy(),
                                      np.asarray(jps.props[k])[valid])


def test_port_checkpoints_load_in_repro(tmp_path):
    """The port's save (a tree with a bf16 leaf) read by repro's load, and
    the port's save_particles by repro's load_particles: equal exactly."""
    rng = np.random.default_rng(2)
    tree = {"x": torch.from_numpy(rng.normal(size=(5, 3)).astype(np.float32)),
            "props": {"w": torch.from_numpy(rng.normal(size=6).astype(
                np.float32)).to(torch.bfloat16),
                "id": torch.arange(6, dtype=torch.int32)}}
    CK.save(tmp_path / "t", tree, step=4, meta={"k": 1})
    jtree = {"x": jnp.zeros((5, 3)),
             "props": {"w": jnp.zeros(6, jnp.bfloat16),
                       "id": jnp.zeros(6, jnp.int32)}}
    out, step, meta = JCK.load(tmp_path / "t", jtree)
    assert step == 4 and meta == {"k": 1}
    np.testing.assert_array_equal(np.asarray(out["x"]), tree["x"].numpy())
    assert str(out["props"]["w"].dtype) == "bfloat16"
    np.testing.assert_array_equal(
        np.asarray(out["props"]["w"]).view(np.uint16),
        tree["props"]["w"].view(torch.int16).numpy().view(np.uint16))
    np.testing.assert_array_equal(np.asarray(out["props"]["id"]),
                                  tree["props"]["id"].numpy())

    jps = _jax_particles()
    tps = TP.ParticleSet(x=torch.from_numpy(np.array(jps.x)),
                         props={k: torch.from_numpy(np.array(v))
                                for k, v in jps.props.items()},
                         valid=torch.from_numpy(np.array(jps.valid)))
    CK.save_particles(tmp_path / "pk", tps, step=9, meta={"rid": "a"})
    ps2, step, meta = JCK.load_particles(tmp_path / "pk", capacity=40)
    assert step == 9 and meta == {"rid": "a", "n": 37}
    valid = np.asarray(jps.valid)
    np.testing.assert_array_equal(np.asarray(ps2.x)[np.asarray(ps2.valid)],
                                  np.asarray(jps.x)[valid])
    np.testing.assert_array_equal(
        np.asarray(ps2.props["v"])[np.asarray(ps2.valid)],
        np.asarray(jps.props["v"])[valid])
