"""B1's generated functors (repro_torch/kernels/cell_pair/codegen.py) on
the CPU: each traced body is emitted as C++, compiled once per module with
the host g++ against tests/cell_pair_host_shim.h and the engine header's
host part, and evaluated pair by pair against its plain PyTorch body in
fp32 (bf16x is held on the card only: PyTorch's CPU rounds bf16 constants
otherwise). The bodies include a Kob–Andersen binary mixture (an int32
species prop, its parameters looked up in constant tables), damped
shifted-force electrostatics (erfc) and a five-output body of a width-4
prop. The functor also stands in for the CUDA launch of the operator
``repro_torch::cell_pair`` here, so that the packing (integer props as
their bits), the sorted output order and the fleet fold run with the
generated code. Then the ops and dtypes the generator refuses, the
library key's headers, and two runs against ``repro``'s Pallas kernel
(interpret mode): 2-D LJ through the port's ``md``, and the Kob–Andersen
mixture through ``make_sim_step``."""
import ctypes
import dataclasses
import pathlib
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from _torch_bridge import (DSF_OUT, NEW_OPS, NEW_OPS_EXACT, OPS_OUT,
                           QUAT_OUT, DSFBody, KABody, NewOpsBody, OpsBody,
                           QuatBody, new_ops_props, np_, rel, to_torch)

import jax.numpy as jnp

from repro.apps import md as jmd
from repro.core import interactions as JI
from repro.core import particles as JP
from repro.core import simulation as JSIM
from repro_torch.apps import dem as tdem
from repro_torch.apps import md as tmd
from repro_torch.apps import sph as tsph
from repro_torch.core import cell_list as TCL
from repro_torch.core import interactions as TI
from repro_torch.core import particles as TP
from repro_torch.core import simulation as TSIM
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
F32, I32 = torch.float32, torch.int32
SPH_CFG = tsph.SPHConfig(device="cpu")
DEM_CFG = tdem.DEMConfig(device="cpu")
H_SPH = float(tsph.kernel_consts(SPH_CFG)[0])


def _pairs(rng, n, dim, r_lo, r_hi):
    """n displacements of length in [r_lo, r_hi)."""
    u = rng.normal(size=(n, dim))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    return (u * rng.uniform(r_lo, r_hi, size=(n, 1))).astype(np.float32)


def _quats(rng, shape):
    q = rng.normal(size=shape + (4,))
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


# name: (body, out, dim, props {name: CG.Prop}, pair sampler)
CASES = {
    "gauss": (gauss_body, {"f": "radial", "rho": "scalar"}, 2,
              {"q": CG.Prop(0, F32)},
              lambda rng, n: (_pairs(rng, n, 2, 0.0, 0.26),
                              {"q": rng.uniform(1.0, 2.0, (2, n))})),
    "lj": (tmd.lj_pair_body(0.1, 1.0), {"f": "radial"}, 3, {},
           lambda rng, n: (_pairs(rng, n, 3, 0.09, 0.3), {})),
    "sph": (tsph.sph_pair_body(SPH_CFG), {"a": "radial", "drho": "scalar"},
            3, {"v": CG.Prop(3, F32), "rho": CG.Prop(0, F32)},
            lambda rng, n: (_pairs(rng, n, 3, 1e-3, 2.0 * H_SPH), {
                "v": rng.uniform(-1.0, 1.0, (2, n, 3)),
                "rho": SPH_CFG.rho0 * rng.uniform(0.99, 1.01, (2, n))})),
    "dem": (tdem.dem_normal_body(DEM_CFG), {"f": "radial"}, 3,
            {"v": CG.Prop(3, F32)},
            lambda rng, n: (_pairs(rng, n, 3, 1.8 * DEM_CFG.R,
                                   2.1 * DEM_CFG.R),
                            {"v": rng.uniform(-1.0, 1.0, (2, n, 3))})),
    "kitchen": (kitchen_body, KITCHEN_OUT, 3,
                {"v": CG.Prop(3, F32), "s": CG.Prop(0, F32)},
                lambda rng, n: (_pairs(rng, n, 3, 0.1, 0.3), {
                    "v": rng.uniform(-1.0, 1.0, (2, n, 3)),
                    "s": rng.uniform(1.0, 2.0, (2, n))})),
    # species ids up to 2^26: a value conversion would lose their low bit
    "ka": (KABody(1.0), {"f": "radial"}, 3, {"species": CG.Prop(0, I32)},
           lambda rng, n: (_pairs(rng, n, 3, 0.75, 2.5), {
               "species": rng.integers(0, 2 ** 26, (2, n)).astype(
                   np.int32)})),
    "dsf": (DSFBody(0.2, 3.0), DSF_OUT, 3, {"q": CG.Prop(0, F32)},
            lambda rng, n: (_pairs(rng, n, 3, 0.5, 3.0), {
                "q": rng.choice([-1.0, 1.0], (2, n))})),
    "w4": (QuatBody(2.0), QUAT_OUT, 3, {"q4": CG.Prop(4, F32)},
           lambda rng, n: (_pairs(rng, n, 3, 0.1, 1.0),
                           {"q4": _quats(rng, (2, n))})),
    "ops": (OpsBody(3.0), OPS_OUT, 3, {"kind": CG.Prop(0, I32)},
            lambda rng, n: (_pairs(rng, n, 3, 0.05, 1.0), {
                "kind": rng.integers(-50, 50, (2, n)).astype(np.int32)})),
}
NEW_PROPS = {"a": CG.Prop(0, F32), "b": CG.Prop(0, F32), "k": CG.Prop(0, I32)}
# each op of NEW_OPS alone, and all of them beside a radial force
for _name, _body in [(f"new_{op}", NewOpsBody((op,))) for op in NEW_OPS] \
        + [("new_all", NewOpsBody(k_f=2.0))]:
    CASES[_name] = (_body, _body.out(), 3, NEW_PROPS,
                    lambda rng, n: (_pairs(rng, n, 3, 0.1, 1.0),
                                    new_ops_props(rng, (2, n))))


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


def _pack(props, g, n):
    """(n, width) packed props of one side, as ``cell_pair.pack_props``
    packs them: scalar (n,) / vector (n, w); an integer prop's int32
    bits."""
    parts = [props[k] if w else props[k][:, None]
             for k, w in zip(g.props, g.widths)]
    parts = [a.astype(np.int32).view(np.float32) if a.dtype.kind in "iub"
             else a.astype(np.float32) for a in parts]
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
    SPH and DEM bodies with their cuda_kind ignored, a body of many ops,
    the Kob–Andersen mixture with int32 species above 2^24, damped
    shifted-force electrostatics and a five-output body of a width-4
    prop), compiled with g++, against the plain body on 4,096 seeded
    pairs: each output within 1e-6 of its max."""
    body, out, dim, props, sample = CASES[name]
    g = host.by_name[name]
    rng = np.random.default_rng(len(name))
    n = 4096
    dx, pv = sample(rng, n)
    r2 = dx[:, 0] * dx[:, 0]
    for d in range(1, dim):
        r2 = r2 + dx[:, d] * dx[:, d]
    pv = {k: v if v.dtype.kind in "iub" else v.astype(np.float32)
          for k, v in pv.items()}
    wi = {k: torch.from_numpy(v[0]) for k, v in pv.items()}
    wj = {k: torch.from_numpy(v[1]) for k, v in pv.items()}
    dxt = torch.from_numpy(dx)
    want = body(lambda d: dxt[:, d], torch.from_numpy(r2),
                torch.ones(n, dtype=torch.bool), wi, wj)
    rad, sca = host.eval(g.kind, g.params, dx, r2,
                         _pack({k: v[0] for k, v in pv.items()}, g, n),
                         _pack({k: v[1] for k, v in pv.items()}, g, n))
    radial = [k for k, kind in sorted(out.items()) if kind == "radial"]
    scalar = [k for k, kind in sorted(out.items()) if kind == "scalar"]
    for k, nm in enumerate(radial):
        ref = (want[nm].mag[:, None] * dxt).numpy()
        assert rel(rad[:, k], ref) <= 1e-6, nm
    for k, nm in enumerate(scalar):
        assert rel(sca[:, k], want[nm]) <= 1e-6, nm
        if isinstance(body, NewOpsBody) and nm in NEW_OPS_EXACT:
            assert np.array_equal(sca[:, k], np_(want[nm])), nm
    # a one-op body reads the props its op reads
    one_op = isinstance(body, NewOpsBody) and len(body.ops) == 1
    assert set(g.props) <= set(props) if one_op \
        else g.props == tuple(sorted(props))


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
    """What neither package's kernel takes raises NotImplementedError on
    the CPU too: an op outside the generator's set (cumsum along the pair
    axis) naming the aten op, Python control flow on a traced value and a
    closed-over array larger than a table; a hand functor's body is not
    traced at all."""
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

    table = torch.linspace(0.0, 1.0, 512)

    def captured(dx, r2, ok, wi, wj):
        return {"n": table.to(r2.dtype)[wi["k"] % 512] * r2}

    # repro's pallas_call refuses a captured f32[512] too ("captures
    # constants ... pass them as inputs")
    with pytest.raises(NotImplementedError, match="closes over"):
        CG.generate(captured, {"n": "scalar"}, 3, {"k": CG.Prop(0, I32)})
    kind, prec, params = TCP._kind_of(tmd.lj_pair_body(0.1, 1.0),
                                      {"f": "radial"}, "bf16x", 2)
    assert (kind, prec, params) == ("lj", "bf16x", (0.1 * 0.1, 24.0))


def test_generated_precisions_and_entries():
    """A two-output body gets f32 and bf16x entries, and a bf16x:<name>
    entry for each selection asked for, each a CELL_PAIR_ENTRY_FIT of its
    source (fitted to its block's register budget); the mixed ones' MixedBody masks follow the sorted output
    order."""
    g0 = CG.generate(gauss_body, {"f": "radial", "rho": "scalar"}, 2,
                     {"q": CG.Prop(0, F32)})
    assert g0.precs == ("f32", "bf16x")
    g = g0.with_mixed("bf16x_rho", {"rho"}).with_mixed("bf16x_f", {"f"})
    assert g.precs == ("f32", "bf16x", "bf16x_f", "bf16x_rho")
    assert g.with_mixed("bf16x_f", {"f"}) is g
    assert CG.source_file(g) != CG.source_file(g0)
    src = g.source()
    for prec in g.precs:
        assert f"CELL_PAIR_ENTRY_FIT(cell_pair_{g.kind}_{prec}_d2," in src
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


def test_int64_prop_raises():
    """An int64 prop raises NotImplementedError naming its dtype, when
    the functor is generated and when props are packed; an int32 prop of
    the same values does not."""
    t = torch.arange(12, dtype=torch.int64).reshape(2, 6)
    body = KABody(1.0)
    with pytest.raises(NotImplementedError, match="torch.int64"):
        TCP._kind_of(body, {"f": "radial"}, "fp32", 3, {"species": t})
    with pytest.raises(NotImplementedError, match="torch.int64"):
        TCP.pack_props({"species": t}, ("species",))
    kind, _, _ = TCP._kind_of(body, {"f": "radial"}, "fp32", 3,
                              {"species": t.to(torch.int32)})
    assert TCP.KINDS[kind].widths == (0,)


def test_pack_props_round_trips_int_bits():
    """pack_props carries int32 props bit for bit (the edges of the range,
    values above 2^24, negatives), widens int16, int8, uint8 and bool
    props to int32 first, and packs float props beside them as fp32, in
    the order named, with any width."""
    rng = np.random.default_rng(5)
    ids = np.concatenate([[-2 ** 31, 2 ** 31 - 1, 2 ** 24 + 1, -1, 0],
                          rng.integers(-2 ** 31, 2 ** 31, 7)]).astype(
        np.int32).reshape(2, 6)
    props = {"ids": torch.from_numpy(ids),
             "u8": torch.from_numpy(rng.integers(0, 256, (2, 6)).astype(
                 np.uint8)),
             "i16": torch.from_numpy(rng.integers(-2 ** 15, 2 ** 15, (2, 6))
                                     .astype(np.int16)),
             "flag": torch.from_numpy(rng.uniform(size=(2, 6)) < 0.5),
             "q4": torch.from_numpy(rng.normal(size=(2, 6, 4)).astype(
                 np.float32)),
             "i8": torch.from_numpy(rng.integers(-128, 128, (2, 6, 2))
                                    .astype(np.int8))}
    names = ("q4", "ids", "u8", "i8", "i16", "flag")
    packed = TCP.pack_props(props, names)
    assert packed.dtype == torch.float32 and packed.shape == (2, 6, 10)
    assert torch.equal(packed[..., :4], props["q4"])
    bits = packed[..., 4:].contiguous().view(torch.int32)
    assert torch.equal(bits[..., 0], props["ids"])
    assert torch.equal(bits[..., 1], props["u8"].to(torch.int32))
    assert torch.equal(bits[..., 2:4], props["i8"].to(torch.int32))
    assert torch.equal(bits[..., 4], props["i16"].to(torch.int32))
    assert torch.equal(bits[..., 5], props["flag"].to(torch.int32))
    one = TCP.pack_props({"ids": props["ids"]}, ("ids",))
    assert torch.equal(one.view(torch.int32)[..., 0], props["ids"])


def test_five_output_source_holds_asked_entries(host):
    """A five-output body under bf16x:<two names> gets exactly that
    entry beside f32 and bf16x (no subset is emitted up front), in a
    source of its own; its MixedBody masks follow the sorted outputs
    (radial f, twist; scalar align, dens, spin)."""
    _, _, dim, props, _ = CASES["w4"]
    q4 = torch.zeros((2, 5, 4))
    kind, prec, params = TCP._kind_of(QuatBody(2.0), QUAT_OUT,
                                      "bf16x:twist,dens", dim, {"q4": q4})
    g = TCP.KINDS[kind].gen
    assert kind == host.by_name["w4"].kind and params == g.params
    assert prec == "bf16x_dens_twist"
    assert g.precs == ("f32", "bf16x", "bf16x_dens_twist")
    assert TCP.KINDS[kind].precs == g.precs
    assert TCP.KINDS[kind].widths == (4,) and TCP.KINDS[kind].width(3) == 4
    src = g.source()
    assert src.count("CELL_PAIR_ENTRY_FIT(") == 3
    assert re.findall(r"_(bf16x_\w+)_d3,", src) == ["bf16x_dens_twist"]
    assert f"<{g.functor}<F32>, {g.functor}<BF16>, 2u, 2u>" in src
    assert CG.source_file(g) != CG.source_file(host.by_name["w4"])
    assert "Ops<F32>::tanh" in g.code and "Ops<BF16>::tanh" in g.code
    assert TCP.launch_key(kind, prec) in TCP.LAUNCHES_BY_KIND


def _ka_tiles(seed=8, n=80):
    """A small periodic box's tiles with an int32 species prop whose ids
    reach above 2^24."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32))
    ids = rng.integers(0, 2 ** 26, n).astype(np.int32)
    ps = TP.from_positions(x, capacity=n + 4,
                           props={"species": torch.from_numpy(ids)})
    cl = TCL.build_cell_list(ps, box_lo=(0.0,) * 3, box_hi=(1.0,) * 3,
                             grid_shape=(3,) * 3, periodic=(True,) * 3,
                             cell_cap=16)
    return TCP.gather_cell_tiles(ps, cl, ("species",))


def test_int_props_through_the_operator_and_fold(host):
    """The Kob–Andersen body's int32 species through the operator (the
    generated functor standing in for the launch) equal cell_pair_torch's
    forces; under vmap, three members with their own species make one
    call over their folded cells and equal their own calls bit for
    bit."""
    t = _ka_tiles()
    kw = dict(body=KABody(0.12), out={"f": "radial"}, r_cut=0.3,
              precision="fp32")
    args = (t.cell_x, t.nbr_x, t.cell_mask, t.nbr_mask)
    got = TCP._cell_pair_cuda(*args, dict(t.props_i), dict(t.props_j), **kw)
    ref = TCP.cell_pair_torch(*args, t.props_i, t.props_j, **kw)
    assert float(ref["f"].abs().max()) > 0.0
    assert rel(got["f"], ref["f"]) <= 1e-6
    calls = []
    kernel = _stand_in(host)

    def counting(*a):
        calls.append(a[0].shape[0])
        return kernel(*a)

    TCP._cell_pair_op.register_kernel("cpu")(counting)
    try:
        si = torch.stack([t.props_i["species"] + b for b in range(3)])
        sj = torch.stack([t.props_j["species"] + b for b in range(3)])
        member = lambda a, b: TCP._cell_pair_cuda(
            *args, {"species": a}, {"species": b}, **kw)["f"]
        batched = torch.func.vmap(member)(si, sj)
        assert calls == [3 * t.cell_x.shape[0]]
        for b in range(3):
            assert torch.equal(batched[b], member(si[b], sj[b])), b
        assert not torch.equal(batched[0], batched[1])
    finally:
        TCP._cell_pair_op.register_kernel("cpu")(kernel)


@dataclasses.dataclass(frozen=True)
class KACfg:
    """The Kob–Andersen mixture on an n^3 lattice of a unit periodic box
    at number density 1.2 sigma_AA^-3; the engine's cutoff 2.5 sigma_AA."""

    n_per_side: int = 8
    dt: float = 0.0005 / 0.085 * (1.2 / 512) ** (1 / 3)
    backend: str = "torch"
    interpret: bool = True

    @property
    def sigma(self) -> float:
        return (1.2 / self.n_per_side ** 3) ** (1 / 3)


def ka_tphysics(cfg: KACfg):
    """The port's MD spec (velocity Verlet) around the Kob–Andersen
    body."""
    spec = tmd.physics(tmd.MDConfig(n_per_side=cfg.n_per_side,
                                    sigma=cfg.sigma, dt=cfg.dt, device="cpu",
                                    backend=cfg.backend))
    return dataclasses.replace(
        spec, name="ka", r_cut=2.5 * cfg.sigma,
        make_body=lambda: KABody(cfg.sigma), pair_props=("species",),
        ghost_props=("species",))


def _ka_jbody(sigma: float):
    """The Kob–Andersen body in jnp. ``repro``'s Pallas kernel refuses a
    closed-over table, so it selects the same entries with jnp.where."""
    tables = KABody(sigma).tables()

    def pick(t, si, sj):
        return jnp.where(si == 0, jnp.where(sj == 0, t[0][0], t[0][1]),
                         jnp.where(sj == 0, t[1][0], t[1][1]))

    def body(dx, r2, ok, wi, wj):
        si, sj = wi["species"] % 2, wj["species"] % 2
        eps, s2, rc2 = (pick(t, si, sj) for t in tables)
        r2s = jnp.maximum(r2, 1e-12)
        inv3 = (s2 / r2s) ** 3
        mag = 24.0 * eps * (2.0 * inv3 * inv3 - inv3) / r2s
        return {"f": JI.Radial(jnp.where(r2 < rc2, mag, 0.0))}

    return body


def ka_jphysics(cfg: KACfg):
    """``repro``'s MD spec around the jnp Kob–Andersen body, on its Pallas
    kernel in interpret mode."""
    spec = jmd.physics(jmd.MDConfig(n_per_side=cfg.n_per_side,
                                    sigma=cfg.sigma, dt=cfg.dt,
                                    backend="pallas",
                                    interpret=cfg.interpret))
    return dataclasses.replace(
        spec, name="ka", r_cut=2.5 * cfg.sigma,
        make_body=lambda: _ka_jbody(cfg.sigma), pair_props=("species",),
        ghost_props=("species",))


def test_ka_sim_step_matches_repro_pallas():
    """Kob–Andersen 80:20 at 512 particles (a jittered lattice, B on a
    seeded 20% of sites, species ids reaching 2^26): 5 steps of the
    port's make_sim_step on the plain path against repro's make_sim_step
    on its Pallas kernel in interpret mode, x and v within 1e-4 and the
    species carried unchanged."""
    cfg = KACfg()
    rng = np.random.default_rng(29)
    n = cfg.n_per_side
    g = (np.arange(n) + 0.5) / n
    x = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    x = (x + rng.uniform(-0.05, 0.05, x.shape) / n).astype(np.float32)
    m = x.shape[0]
    species = (2 * rng.integers(0, 2 ** 25, m)
               + (rng.uniform(size=m) < 0.2)).astype(np.int32)
    props = {"v": rng.normal(0.0, 0.5, (m, 3)).astype(np.float32),
             "f": np.zeros((m, 3), np.float32), "species": species}
    jps = JP.from_positions(jnp.asarray(x), capacity=int(1.3 * m),
                            props={k: jnp.asarray(v)
                                   for k, v in props.items()})
    js = JSIM.serial_state(jps, ka_jphysics, cfg)
    ts = TSIM.serial_state(to_torch(jps), ka_tphysics, cfg)
    assert ts.ps.props["species"].dtype == torch.int32
    j_step = JSIM.make_sim_step(ka_jphysics, cfg)
    t_step = TSIM.make_sim_step(ka_tphysics, cfg)
    for _ in range(5):
        js, jf, _ = j_step(js, {})
        ts, tf, _ = t_step(ts, {})
        assert int(jf.any()) == int(tf.any()) == 0
    valid = np_(js.ps.valid)
    assert np.array_equal(np_(ts.ps.valid), valid)
    assert rel(np_(ts.ps.x)[valid], np_(js.ps.x)[valid]) <= 1e-4
    assert rel(np_(ts.ps.props["v"])[valid],
               np_(js.ps.props["v"])[valid]) <= 1e-4
    assert float(np.abs(np_(ts.ps.props["f"])[valid]).max()) > 1.0
    assert np.array_equal(np.sort(np_(ts.ps.props["species"])[valid]),
                          np.sort(species))


def _new_ops_jbody(k_f: float):
    """:class:`NewOpsBody` (every op, with its force) in jnp, for
    ``repro``'s Pallas kernel."""
    import jax.scipy.special as jss

    ops = {
        "remainder": lambda r2, dx, u, v, k: jnp.remainder(u, v),
        "remainder_s": lambda r2, dx, u, v, k: jnp.remainder(u, 0.7),
        "fmod": lambda r2, dx, u, v, k: jnp.fmod(u, v),
        "fmod_s": lambda r2, dx, u, v, k: jnp.fmod(u, -0.7),
        "floordiv": lambda r2, dx, u, v, k: u // v,
        "floordiv_s": lambda r2, dx, u, v, k: u // 0.7,
        "div_floor_s": lambda r2, dx, u, v, k: jnp.floor_divide(u, -0.7),
        "div_trunc": lambda r2, dx, u, v, k: jnp.trunc(u / v),
        "div_trunc_s": lambda r2, dx, u, v, k: jnp.trunc(u / 0.7),
        "round_2": lambda r2, dx, u, v, k: jnp.round(u * v, 2),
        "round_m1": lambda r2, dx, u, v, k: jnp.round(3.7 * u, -1),
        "ipow": lambda r2, dx, u, v, k: (k ** 3 - k ** 2 + k ** 0).astype(
            r2.dtype) * 1e-4,
        "hypot": lambda r2, dx, u, v, k: jnp.hypot(dx(0), dx(1)),
        "copysign": lambda r2, dx, u, v, k: jnp.copysign(r2, u),
        "copysign_s": lambda r2, dx, u, v, k: jnp.copysign(r2, -1.0),
        "log2": lambda r2, dx, u, v, k: jnp.log2(r2),
        "exp2": lambda r2, dx, u, v, k: jnp.exp2(-3.0 * r2),
        "log10": lambda r2, dx, u, v, k: jnp.log10(r2),
        "tan": lambda r2, dx, u, v, k: jnp.tan(r2),
        "asin": lambda r2, dx, u, v, k: jnp.arcsin(0.9 * r2 - 0.45),
        "acos": lambda r2, dx, u, v, k: jnp.arccos(0.9 * r2 - 0.45),
        "atan": lambda r2, dx, u, v, k: jnp.arctan(3.0 * r2),
        "sinh": lambda r2, dx, u, v, k: jnp.sinh(2.0 * r2),
        "cosh": lambda r2, dx, u, v, k: jnp.cosh(2.0 * r2),
        "asinh": lambda r2, dx, u, v, k: jnp.arcsinh(3.0 * r2 - 1.0),
        "acosh": lambda r2, dx, u, v, k: jnp.arccosh(1.0 + 3.0 * r2),
        "atanh": lambda r2, dx, u, v, k: jnp.arctanh(0.9 * r2 - 0.4),
        "lgamma": lambda r2, dx, u, v, k: jss.gammaln(5.0 * r2 + 0.1),
        "amax": lambda r2, dx, u, v, k: jnp.max(
            jnp.stack([r2, 0.05 * u, 0.5 * v]), axis=0),
        "amin": lambda r2, dx, u, v, k: jnp.min(
            jnp.stack([r2, 0.05 * u, 0.5 * v]), axis=0),
        "ssum": lambda r2, dx, u, v, k: jnp.sum(jnp.stack([r2, u, v]), 0),
        "sprod": lambda r2, dx, u, v, k: jnp.prod(jnp.stack([r2, u, v]), 0),
        "maxdim": lambda r2, dx, u, v, k: jnp.max(
            jnp.stack([r2, 0.5 * v]), axis=0),
        "iamax": lambda r2, dx, u, v, k: jnp.max(
            jnp.stack([k, 3 - k]), axis=0).astype(r2.dtype),
    }
    assert tuple(ops) == tuple(NEW_OPS)

    def body(dx, r2, ok, wi, wj):
        # the kernel's wi are columns and its wj rows: stack full tiles
        u, v, k = (jnp.broadcast_to(a, r2.shape) for a in
                   (wi["a"], wj["b"], wi["k"] - wj["k"]))
        vals = [ops[name](r2, dx, u, v, k) for name in NEW_OPS]
        mean = sum(vals) * (0.01 / len(vals))
        return {"f": JI.Radial(jnp.exp2(-k_f * r2) * (2.0 + mean))}

    return body


def _new_ops_phys(cfg: KACfg, k_f: float, repro: bool):
    """MD (velocity Verlet) around the new-op body's force: the port's
    spec, or ``repro``'s on its Pallas kernel in interpret mode."""
    props = ("a", "b", "k")
    if repro:
        spec = jmd.physics(jmd.MDConfig(
            n_per_side=cfg.n_per_side, sigma=cfg.sigma, dt=cfg.dt,
            backend="pallas", interpret=cfg.interpret))
        body = _new_ops_jbody(k_f)
    else:
        spec = tmd.physics(tmd.MDConfig(
            n_per_side=cfg.n_per_side, sigma=cfg.sigma, dt=cfg.dt,
            device="cpu", backend=cfg.backend))
        body = NewOpsBody(k_f=k_f)
    return dataclasses.replace(
        spec, name="new_ops", r_cut=2.5 * cfg.sigma, make_body=lambda: body,
        pair_out={"f": "radial"}, pair_props=props, ghost_props=props)


def test_new_ops_sim_step_matches_repro_pallas():
    """The force of every op B1's generated route gained last (remainder,
    fmod, floor and trunc division by tensors and numbers, round with
    decimals, integer pow, hypot, copysign, log2, exp2, log10, tan, the
    inverse and hyperbolic functions, lgamma and reductions over stacks)
    at 512 particles: 5 steps of the port's make_sim_step on the plain
    path against repro's make_sim_step on its Pallas kernel in interpret
    mode, x, v and f within 1e-5; the body's generated functor takes it
    (no NotImplementedError)."""
    cfg = KACfg()
    k_f = 10.0 / (2.5 * cfg.sigma) ** 2
    rng = np.random.default_rng(30)
    n = cfg.n_per_side
    g = (np.arange(n) + 0.5) / n
    x = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    x = (x + rng.uniform(-0.05, 0.05, x.shape) / n).astype(np.float32)
    m = x.shape[0]
    props = {"v": rng.normal(0.0, 0.5, (m, 3)).astype(np.float32),
             "f": np.zeros((m, 3), np.float32),
             **new_ops_props(rng, (m,))}
    jps = JP.from_positions(jnp.asarray(x), capacity=int(1.3 * m),
                            props={k: jnp.asarray(v)
                                   for k, v in props.items()})
    jphys = lambda c: _new_ops_phys(c, k_f, True)
    tphys = lambda c: _new_ops_phys(c, k_f, False)
    js = JSIM.serial_state(jps, jphys, cfg)
    ts = TSIM.serial_state(to_torch(jps), tphys, cfg)
    kind, _, _ = TCP._kind_of(NewOpsBody(k_f=k_f), {"f": "radial"}, "fp32",
                              3, {k: ts.ps.props[k][None] for k in "abk"})
    assert kind.startswith("gen_")
    j_step = JSIM.make_sim_step(jphys, cfg)
    t_step = TSIM.make_sim_step(tphys, cfg)
    for _ in range(5):
        js, jf, _ = j_step(js, {})
        ts, tf, _ = t_step(ts, {})
        assert int(jf.any()) == int(tf.any()) == 0
    valid = np_(js.ps.valid)
    assert np.array_equal(np_(ts.ps.valid), valid)
    for key in ("v", "f"):
        assert rel(np_(ts.ps.props[key])[valid],
                   np_(js.ps.props[key])[valid]) <= 1e-5, key
    assert rel(np_(ts.ps.x)[valid], np_(js.ps.x)[valid]) <= 1e-5
    assert float(np.abs(np_(ts.ps.props["f"])[valid]).max()) > 0.01
