"""B1's generated functors (repro_torch/kernels/cell_pair/codegen.py) on
the CPU: each traced body is emitted as C++, compiled once per module with
the host g++ against tests/cell_pair_host_shim.h and the engine header's
host part, and evaluated pair by pair against its plain PyTorch body in
fp32 (bf16x is held on the card only: PyTorch's CPU rounds bf16 constants
otherwise). The functor also stands in for the CUDA launch of the operator
``repro_torch::cell_pair`` here, so that the packing, the sorted output
order and the fleet fold run with the generated code. Then the ops the
generator refuses, the library key's headers, and 2-D LJ: the port's
``md`` at ``dim=2`` against ``repro``'s Pallas kernel (interpret mode)."""
import ctypes
import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from _torch_bridge import np_, rel, to_torch

from repro.apps import md as jmd
from repro_torch.apps import dem as tdem
from repro_torch.apps import md as tmd
from repro_torch.apps import sph as tsph
from repro_torch.core import cell_list as TCL
from repro_torch.core import interactions as TI
from repro_torch.core import particles as TP
from repro_torch.kernels import _build
from repro_torch.kernels.cell_pair import cell_pair as TCP
from repro_torch.kernels.cell_pair import codegen as CG

TESTS = pathlib.Path(__file__).resolve().parent


def gauss_body(dx, r2, ok, wi, wj):
    """``repro``'s Gaussian body of tests/test_cell_pair.py, in PyTorch."""
    w = wi["q"] * wj["q"] * torch.exp(-8.0 * r2)
    return {"f": TI.Radial(w), "rho": w}


def kitchen_body(dx, r2, ok, wi, wj):
    """Every op the generator takes, on well-conditioned pairs (r2 in
    [0.01, 0.09], s in [1, 2], v in [-1, 1]); four outputs whose sorted
    order interleaves the radial and the scalar ones."""
    r = torch.sqrt(torch.clamp(r2, min=1e-12))
    dot = (wi["v"] * wj["v"]).sum(-1)
    a = torch.where(r < 0.5 * wi["s"], torch.exp(-r2 / 0.3),
                    torch.log(1.0 + r2))
    b = torch.clamp(dot, min=-0.5, max=0.5) + torch.abs(dx(0)) - (-r2)
    c = torch.rsqrt(r2 + 0.1) * torch.reciprocal(1.0 + r2) + r2 ** 2 \
        + r2 ** 3 + (r2 + 1.0) ** -2 + (r2 + 0.5) ** 1.7 + r2 ** 0.5 \
        + (r2 + 0.2) ** -0.5 + (r2 + 0.3) ** -1
    d = torch.maximum(r2, wi["s"] * 0.05) - torch.minimum(r2, wj["s"] * 0.05) \
        + torch.pow(r2 + 1.0, wi["s"]) + torch.clamp_max(dx(1), 0.1)
    cond = ((r2 > 0.04) & ~(dot < 0.0)) | (wj["s"] >= 1.5)
    e = torch.where(cond, 1.0, 0.5) * torch.where(
        torch.logical_xor(r2 != 0.05, wi["v"][..., 0] <= 0.0),
        torch.full_like(r2, 2.0), torch.ones_like(r2))
    g = r2 / 3.0 + (2.0 - r2) * wi["v"][..., 1] + torch.zeros_like(r2) \
        + (r2 - wj["v"][..., 2]) * torch.tensor(1.5) \
        + torch.sub(r2, wi["s"], alpha=0.25)
    return {"b_rad": TI.Radial(a * b), "a_sca": c + d,
            "c_rad": TI.Radial(e), "d_sca": g * e}


KITCHEN_OUT = {"b_rad": "radial", "a_sca": "scalar", "c_rad": "radial",
               "d_sca": "scalar"}
SPH_CFG = tsph.SPHConfig(device="cpu")
DEM_CFG = tdem.DEMConfig(device="cpu")
H_SPH = float(tsph.kernel_consts(SPH_CFG)[0])


def _pairs(rng, n, dim, r_lo, r_hi):
    """n displacements of length in [r_lo, r_hi)."""
    u = rng.normal(size=(n, dim))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    return (u * rng.uniform(r_lo, r_hi, size=(n, 1))).astype(np.float32)


# name: (body, out, dim, props {name: is a vector}, pair sampler)
CASES = {
    "gauss": (gauss_body, {"f": "radial", "rho": "scalar"}, 2,
              {"q": False},
              lambda rng, n: (_pairs(rng, n, 2, 0.0, 0.26),
                              {"q": rng.uniform(1.0, 2.0, (2, n))})),
    "lj": (tmd.lj_pair_body(0.1, 1.0), {"f": "radial"}, 3, {},
           lambda rng, n: (_pairs(rng, n, 3, 0.09, 0.3), {})),
    "sph": (tsph.sph_pair_body(SPH_CFG), {"a": "radial", "drho": "scalar"},
            3, {"v": True, "rho": False},
            lambda rng, n: (_pairs(rng, n, 3, 1e-3, 2.0 * H_SPH), {
                "v": rng.uniform(-1.0, 1.0, (2, n, 3)),
                "rho": SPH_CFG.rho0 * rng.uniform(0.99, 1.01, (2, n))})),
    "dem": (tdem.dem_normal_body(DEM_CFG), {"f": "radial"}, 3, {"v": True},
            lambda rng, n: (_pairs(rng, n, 3, 1.8 * DEM_CFG.R,
                                   2.1 * DEM_CFG.R),
                            {"v": rng.uniform(-1.0, 1.0, (2, n, 3))})),
    "kitchen": (kitchen_body, KITCHEN_OUT, 3, {"v": True, "s": False},
                lambda rng, n: (_pairs(rng, n, 3, 0.1, 0.3), {
                    "v": rng.uniform(-1.0, 1.0, (2, n, 3)),
                    "s": rng.uniform(1.0, 2.0, (2, n))})),
}


class _HostLib:
    """The generated functors of ``CASES`` compiled with g++: per kind an
    ``eval_<kind>(n, dx, r2, wi, wj, params, radial, scalar)`` over n
    pairs, in fp32."""

    def __init__(self, gens, build_dir: pathlib.Path):
        self.gens = {g.kind: g for g in gens}
        src = ['#include "cell_pair_host_shim.h"', f'#include "{CG.ENGINE}"',
               "namespace {", *[g.code for g in self.gens.values()], "}"]
        for g in self.gens.values():
            n_rad = sum(k == "radial" for _, k in g.out)
            n_sca = len(g.out) - n_rad
            w = max(g.width, 1)
            src.append(
                f'extern "C" void eval_{g.kind}(int n, const float* dx, '
                "const float* r2, const float* wi, const float* wj, "
                "const float* p, float* rad, float* sca) {\n"
                f"  const auto b = {g.functor}<F32>::from(p);\n"
                "  for (int i = 0; i < n; ++i)\n"
                f"    b(dx + i * {g.dim}, r2[i], wi + i * {w}, wj + i * {w},"
                f" nullptr, nullptr, rad + i * {max(n_rad, 1) * g.dim}, "
                f"sca + i * {max(n_sca, 1)});\n}}")
        cpp = build_dir / "functors.cpp"
        cpp.write_text("\n".join(src))
        so = build_dir / "functors.so"
        subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
                        "-Wall", "-Wno-unknown-pragmas", f"-I{TESTS}", "-o",
                        str(so), str(cpp)], check=True, capture_output=True,
                       text=True)
        self.lib = ctypes.CDLL(str(so))

    def eval(self, kind, params, dx, r2, wi, wj):
        """Per-pair outputs: radial (n, N_RADIAL, dim), scalar (n,
        N_SCALAR), fp32 numpy."""
        g = self.gens[kind]
        n, dim = dx.shape
        n_rad = sum(k == "radial" for _, k in g.out)
        n_sca = len(g.out) - n_rad
        rad = np.zeros((n, max(n_rad, 1), dim), np.float32)
        sca = np.zeros((n, max(n_sca, 1)), np.float32)
        arrs = [np.ascontiguousarray(a, np.float32) for a in
                (dx, r2, wi, wj, np.asarray(params, np.float32))]
        ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)
        getattr(self.lib, f"eval_{kind}")(
            ctypes.c_int(n), *[ptr(a) for a in arrs], ptr(rad), ptr(sca))
        return rad[:, :n_rad], sca[:, :n_sca]


def _pack(props, names, vector, n):
    """(n, width) packed props of one side: scalar (n,) / vector (n, d)."""
    parts = [props[k] if vec else props[k][:, None]
             for k, vec in zip(names, vector)]
    return np.concatenate(parts, axis=1) if parts \
        else np.zeros((n, 1), np.float32)


def _stand_in(host):
    """A CPU kernel for ``repro_torch::cell_pair`` that runs the generated
    functor (fp32) on every pair the engine would evaluate and sums in
    float64: the operator's packed output layout, from the real code."""

    def kernel(cell_x, nbr_x, cell_mask, nbr_mask, pi, pj, kind, prec,
               params, r_cut):
        assert prec == "f32" and kind in host.gens
        g = host.gens[kind]
        C, cc, dim = cell_x.shape
        dx = (cell_x[:, :, None, :] - nbr_x[:, None, :, :]).numpy()
        with np.errstate(over="ignore"):      # FILL slots, masked below
            r2 = dx[..., 0] * dx[..., 0]
            for d in range(1, dim):
                r2 = r2 + dx[..., d] * dx[..., d]
        ok = (cell_mask[:, :, None] & nbr_mask[:, None, :]).numpy() \
            & (r2 < np.float32(r_cut * r_cut)) & (r2 > np.float32(1e-12))
        c, i, j = np.nonzero(ok)
        w = max(g.width, 1)
        wi = pi.numpy()[c, i] if pi is not None else np.zeros((len(c), w))
        wj = pj.numpy()[c, j] if pj is not None else np.zeros((len(c), w))
        rad, sca = host.eval(kind, params, dx[c, i, j], r2[c, i, j], wi, wj)
        n_rad, n_sca = rad.shape[1], sca.shape[1]
        out_r = np.zeros((n_rad, C, cc, dim))
        out_s = np.zeros((n_sca, C, cc))
        for k in range(n_rad):
            np.add.at(out_r[k], (c, i), rad[:, k])
        for k in range(n_sca):
            np.add.at(out_s[k], (c, i), sca[:, k])
        f = lambda a, shape: torch.from_numpy(
            a.astype(np.float32).reshape(shape)) if a.size \
            else cell_x.new_empty((0,))
        return (f(out_r, (n_rad * C, cc, dim)), f(out_s, (n_sca * C, cc)))

    return kernel


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no host g++ to compile the generated functors")
    gens = {name: CG.generate(body, out, dim, props)
            for name, (body, out, dim, props, _) in CASES.items()}
    lib = _HostLib(list(gens.values()), tmp_path_factory.mktemp("gen"))
    lib.by_name = gens
    TCP._cell_pair_op.register_kernel("cpu")(_stand_in(lib))
    return lib


@pytest.mark.parametrize("name", sorted(CASES))
def test_generated_functor_matches_plain_body(host, name):
    """The functor emitted from each body (the Gaussian, the port's LJ,
    SPH and DEM bodies with their cuda_kind ignored, and a body of every
    op taken), compiled with g++, against the plain body on 4,096 seeded
    pairs: each output within 1e-6 of its max."""
    body, out, dim, props, sample = CASES[name]
    g = host.by_name[name]
    rng = np.random.default_rng(len(name))
    n = 4096
    dx, pv = sample(rng, n)
    r2 = dx[:, 0] * dx[:, 0]
    for d in range(1, dim):
        r2 = r2 + dx[:, d] * dx[:, d]
    pv = {k: v.astype(np.float32) for k, v in pv.items()}
    wi = {k: torch.from_numpy(v[0]) for k, v in pv.items()}
    wj = {k: torch.from_numpy(v[1]) for k, v in pv.items()}
    dxt = torch.from_numpy(dx)
    want = body(lambda d: dxt[:, d], torch.from_numpy(r2),
                torch.ones(n, dtype=torch.bool), wi, wj)
    rad, sca = host.eval(g.kind, g.params, dx, r2,
                         _pack({k: v[0] for k, v in pv.items()}, g.props,
                               g.vector, n),
                         _pack({k: v[1] for k, v in pv.items()}, g.props,
                               g.vector, n))
    radial = [k for k, kind in sorted(out.items()) if kind == "radial"]
    scalar = [k for k, kind in sorted(out.items()) if kind == "scalar"]
    for k, nm in enumerate(radial):
        ref = (want[nm].mag[:, None] * dxt).numpy()
        assert rel(rad[:, k], ref) <= 1e-6, nm
    for k, nm in enumerate(scalar):
        assert rel(sca[:, k], want[nm]) <= 1e-6, nm
    assert g.props == tuple(sorted(props))


def _tiles(dim=3, n=60, seed=4):
    """A small periodic box's tiles with props v (vector) and s (scalar)."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.uniform(0.0, 1.0, (n, dim)).astype(np.float32))
    ps = TP.from_positions(x, capacity=n + 4, props={
        "v": torch.from_numpy(rng.uniform(-1, 1, (n, dim)).astype(
            np.float32)),
        "s": torch.from_numpy(rng.uniform(1, 2, n).astype(np.float32))})
    cl = TCL.build_cell_list(ps, box_lo=(0.0,) * dim, box_hi=(1.0,) * dim,
                             grid_shape=(3,) * dim, periodic=(True,) * dim,
                             cell_cap=16)
    return ps, cl, TCP.gather_cell_tiles(ps, cl, ("s", "v"))


def test_outputs_unpack_by_name_and_fleet_folds(host):
    """The four-output body through the operator (the generated functor
    standing in for the launch): each output, radial and scalar in sorted
    order, equals cell_pair_torch's by name; under vmap, three members
    make one call over their folded cells and equal their own calls."""
    _, _, t = _tiles()
    kw = dict(body=kitchen_body, out=KITCHEN_OUT, r_cut=0.3,
              precision="fp32")
    args = (t.cell_x, t.nbr_x, t.cell_mask, t.nbr_mask)
    n0 = TCP.LAUNCHES
    got = TCP._cell_pair_cuda(*args, dict(t.props_i), dict(t.props_j), **kw)
    ref = TCP.cell_pair_torch(*args, t.props_i, t.props_j, **kw)
    assert sorted(got) == sorted(KITCHEN_OUT)
    for k in KITCHEN_OUT:
        assert got[k].shape == ref[k].shape
        assert rel(got[k], ref[k]) <= 1e-6, k
    kind, prec, params = TCP._kind_of(kitchen_body, KITCHEN_OUT, "fp32", 3,
                                      t.props_i)
    assert kind == host.by_name["kitchen"].kind and prec == "f32"
    assert TCP.KINDS[kind].names() == (["b_rad", "c_rad"],
                                       ["a_sca", "d_sca"])
    assert TCP.LAUNCHES == n0          # the stand-in is not a launch
    calls = []
    kernel = _stand_in(host)

    def counting(*a):
        calls.append(a[0].shape[0])
        return kernel(*a)

    TCP._cell_pair_op.register_kernel("cpu")(counting)
    try:
        xs = torch.stack([t.nbr_x + 0.003 * b for b in range(3)])
        member = lambda nx: TCP._cell_pair_cuda(
            t.cell_x, nx, t.cell_mask, t.nbr_mask, dict(t.props_i),
            dict(t.props_j), **kw)
        batched = torch.func.vmap(member)(xs)
        assert calls == [3 * t.cell_x.shape[0]]
        for b in range(3):
            own = member(xs[b])
            for k in KITCHEN_OUT:
                assert torch.equal(batched[k][b], own[k]), (b, k)
    finally:
        TCP._cell_pair_op.register_kernel("cpu")(kernel)


def test_constants_are_params_not_text():
    """Two bodies that differ in their numbers share one functor (and so
    one library); their params differ."""
    def body(c):
        return lambda dx, r2, ok, wi, wj: {"f": TI.Radial(torch.exp(c * r2))}
    a = CG.generate(body(-8.0), {"f": "radial"}, 3, {})
    b = CG.generate(body(-3.0), {"f": "radial"}, 3, {})
    assert a.kind == b.kind and a.code == b.code
    assert a.params != b.params
    assert "-8" not in a.source() and a.params[0] == -8.0


def test_unsupported_op_raises():
    """An op outside the generator's set raises NotImplementedError naming
    the aten op, on the CPU too, as does Python control flow on a traced
    value; a hand functor's body is not traced at all."""
    def cum(dx, r2, ok, wi, wj):
        return {"n": torch.cumsum(r2, 0)}

    with pytest.raises(NotImplementedError, match="aten.cumsum"):
        CG.generate(cum, {"n": "scalar"}, 3, {})
    with pytest.raises(NotImplementedError, match="aten.cumsum"):
        TCP._kind_of(cum, {"n": "scalar"}, "fp32", 3, {})

    def branchy(dx, r2, ok, wi, wj):
        return {"n": r2 if bool((r2 > 0.1).any()) else 2.0 * r2}

    with pytest.raises(NotImplementedError, match="control flow"):
        CG.generate(branchy, {"n": "scalar"}, 3, {})
    kind, prec, params = TCP._kind_of(tmd.lj_pair_body(0.1, 1.0),
                                      {"f": "radial"}, "bf16x", 2)
    assert (kind, prec, params) == ("lj", "bf16x", (0.1 * 0.1, 24.0))


def test_generated_precisions_and_entries():
    """A two-output body gets f32, bf16x and both bf16x:<name> entries,
    each a CELL_PAIR_ENTRY of its source; the mixed ones' MixedBody masks
    follow the sorted output order."""
    g = CG.generate(gauss_body, {"f": "radial", "rho": "scalar"}, 2,
                    {"q": False})
    assert g.precs == ("f32", "bf16x", "bf16x_f", "bf16x_rho")
    src = g.source()
    for prec in g.precs:
        assert f"CELL_PAIR_ENTRY(cell_pair_{g.kind}_{prec}_d2," in src
    assert f"<{g.functor}<F32>, {g.functor}<BF16>, 1u, 0u>" in src
    assert f"<{g.functor}<F32>, {g.functor}<BF16>, 0u, 1u>" in src
    assert "BF16::r(" in g.code and "Ops<BF16>::exp" in g.code


def test_library_key_follows_local_headers(tmp_path):
    """A library is keyed by its source and every local header it
    includes, so a changed header rebuilds; the cell-pair source includes
    the engine header."""
    (tmp_path / "h.cuh").write_text("// one\n")
    (tmp_path / "inner.cuh").write_text('#include "h.cuh"\n')
    src = tmp_path / "k.cu"
    src.write_text('#include "inner.cuh"\nint x;\n')
    before = _build.lib_path(src)
    (tmp_path / "h.cuh").write_text("// two\n")
    assert _build.lib_path(src) != before
    assert _build.local_headers(src) == [tmp_path / "inner.cuh",
                                         tmp_path / "h.cuh"]
    assert CG.ENGINE in _build.local_headers(TCP.SOURCE)


def test_lj_2d_matches_repro_pallas():
    """2-D LJ (n_per_side 8): the port's forces against repro's Pallas
    kernel in interpret mode within 1e-5, and 5 steps of x and v within
    1e-4, from a state that repro's jnp path thermalised for 40 steps."""
    import dataclasses
    cfg = jmd.MDConfig(n_per_side=8, dim=2, backend="pallas",
                       interpret=True)
    jps, _ = jmd.run(dataclasses.replace(cfg, backend="jnp"), 40,
                     thermal_v=0.4)
    tcfg = tmd.MDConfig(n_per_side=8, sigma=cfg.sigma, epsilon=cfg.epsilon,
                        dt=cfg.dt, box=cfg.box, cell_cap=cfg.cell_cap,
                        capacity_factor=cfg.capacity_factor, dim=2,
                        device="cpu")
    ref, _ = jmd.compute_forces(jps, cfg)
    got, ovf = tmd.compute_forces(to_torch(jps), tcfg)
    assert int(ovf) == 0
    assert rel(got.props["f"], ref.props["f"]) <= 1e-5
    tps = to_torch(jps)
    for _ in range(5):
        jps, _ = jmd.md_step(jps, cfg)
        tps, flag = tmd.md_step(tps, tcfg)
        assert int(flag) == 0
    valid = np_(jps.valid)
    assert rel(np_(tps.x)[valid], np_(jps.x)[valid]) <= 1e-4
    assert rel(np_(tps.props["v"])[valid], np_(jps.props["v"])[valid]) \
        <= 1e-4
