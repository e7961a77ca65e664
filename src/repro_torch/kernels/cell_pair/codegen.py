"""B1 functors generated from a plain pair body (``repro``'s
``_pair_kernel`` traces any body into its Pallas kernel; this module does
the same for the hand-written CUDA engine, ``csrc/cell_pair_engine.cuh``).

A pair body (the protocol of ``repro_torch.core.interactions``) is traced
with ``torch.fx.experimental.proxy_tensor.make_fx`` on small fake CPU
tensors, once with fp32 operands and once with bf16 operands (the
``bf16x`` evaluation: floating props become bf16, integer props keep
their dtype, as ``interactions.cast_bf16`` does), at the call's ``dim``,
prop layouts and ``out`` spec. Each traced graph is emitted as one
specialization of ``template <class P> struct GenBody_<hash>``, a functor
to the engine's body interface: every floating result goes through the
engine's ``Ops<T>`` for the node's dtype, so a bf16 result is rounded as
PyTorch's bf16 elementwise ops round it on the card; integer results go
through ``Int`` (wrapping two's-complement arithmetic) and are narrowed
to their dtype; vector values unroll over their components. ``ok`` is
true for every pair the engine evaluates, so ``where(ok, a, b)`` is
``a``.

The ops taken (aten names): add, sub, rsub, mul, div, neg, abs; clamp,
clamp_min, clamp_max, maximum, minimum; where, eq/ne/lt/le/gt/ge, the
logical ops, and the bitwise and/or/xor/not of booleans and integers;
exp, log, sqrt, rsqrt, reciprocal, pow (a tensor exponent or a number;
an integer base to an integer power), tanh, sin, cos, tan, asin, acos,
atan, sinh, cosh, asinh, acosh, atanh, erf, erfc, log1p, expm1, log2,
exp2, log10, lgamma, floor, ceil, round (with ``decimals`` too), trunc,
sign, sigmoid, atan2, hypot and copysign; remainder, fmod, floor_divide
and ``div`` with a rounding mode, on floats and integers; full,
full_like, zeros_like, ones_like, scalar_tensor and other constants;
select and slice of a vector's components; ``stack`` of per-pair values
and ``amax``, ``amin``, ``sum`` and ``prod`` over its leading axis or
over a vector's components (``max.dim`` / ``min.dim`` through their
values), a chain in their order; ``index`` and ``select`` of a
closed-over float table (1-D or 2-D, at most :data:`MAX_TABLE` per axis)
by integer values; ``_to_copy``
between fp32, bf16, bool and the integer dtypes, and the view ops that
keep a value's components. The values are per-pair scalars and vectors
of any width (a ``(C, n, w)`` prop is read component by component); the
dtypes are float32, bfloat16, bool, int32, int16, int8 and uint8. Any
other op or dtype (int64 among them) raises :class:`NotImplementedError`
naming it, when the body is traced (on the CPU too), as does Python
control flow on a traced value.

The body's floating numbers (Python floats in the graph, scalars it
closes over, 0-d constant tensors, the entries of a table) are not in the
emitted text: each is a slot of the functor's float ``params``, so that a
body with other constants reuses the library (its integer numbers are
literals). What the card does with them is followed: a Python divisor is
reciprocal-then-multiply (``div_true_kernel_cuda``; a floor or trunc
division by one too, ``div_floor_kernel_cuda`` and
``div_trunc_kernel_cuda``, where a tensor divisor takes
``c10::div_floor_floating``), a Python operand of an arithmetic op stays
fp32 beside a bf16 tensor, the bound of a clamp, the other side of a
comparison, an operand of remainder, fmod and copysign and a filled
constant are rounded to the tensor's dtype, ``pow``'s exponents 0, 1, 2,
3, -2, +-0.5 and -1 take
ATen's special cases (``aten/src/ATen/native/cuda/PowKernel.cu``), every
other exponent ``powf`` with the exponent rounded to the tensor's dtype,
and an integer converted to bf16 goes through fp32 first (c10's
``BFloat16(float)``).

:func:`generate` returns the body's :class:`Generated` functor: its kind
name, its params, the props it reads (packed in sorted name order, with
their widths) and the C++ source, which :func:`source_path` writes under
``build/repro_torch/gen/`` (listed in ``.gitignore``) with one
``CELL_PAIR_ENTRY_FIT`` per precision: ``f32``, ``bf16x`` and one
``bf16x_<names>`` (``MixedBody``) for each selection a launch has asked
for (:meth:`Generated.with_mixed`; a new selection names a new source
file, built at its first launch). ``_FIT``: each entry's register bound
(the engine header's register budget) is :func:`entry_bound`'s, which a
launch takes where its block fits 256 threads. The library is built from it by
``_build`` at first launch, keyed by its text and flags.
"""
from __future__ import annotations

import collections
import hashlib
import itertools
import operator
import pathlib
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core.interactions import check_out_kind
from repro_torch.kernels import _build

ENGINE = pathlib.Path(__file__).resolve().parent / "csrc" \
    / "cell_pair_engine.cuh"
GEN_DIR = _build.BUILD_DIR / "gen"

#: Output floats a lane (N_RADIAL DIM + N_SCALAR) above which a generated
#: functor keeps the wide bound (:func:`entry_bound`).
WIDE_OUTPUTS = 16


def entry_bound(n_out: int, prec: str) -> int:
    """The register bound of a generated functor's entry in precision
    ``prec`` with ``n_out`` output floats a lane, as the engine's
    ``CELL_PAIR_ENTRY_FIT`` takes it: -1 the wide bound (1024 threads), 0
    256 threads, 1-4 (256 threads, that many blocks an SM). Each rule is
    the bound that timed best on an H100 80GB HBM3 (700 W) against the wide
    one, in turns (tools/b1_ab.py; PERF.md): fp32 bodies of up to 16
    outputs at 256 threads (0.934-0.998x: LJ with its kind hidden, the
    Gaussian, Kob–Andersen, DSF, the width-4 body), bf16x and mixed
    entries at (256, 4) (0.965-0.999x; at 256 threads the Gaussian's took
    1.011x), and a wider body at the wide bound: phase 22a's 37
    sums a lane lost more to occupancy under a larger register cap than it
    saved in spills (80 registers 0.989x and 1.038x in bf16x, 120 1.071x
    and 1.175x), and (256, 4) took it to 1.000x and 1.012x."""
    if n_out > WIDE_OUTPUTS:
        return -1
    return 0 if prec == "f32" else 4

#: The precisions of every generated functor; ``bf16x_<names>`` entries
#: are added as launches ask for them (:meth:`Generated.with_mixed`).
BASE_PRECS = ("f32", "bf16x")

#: The largest closed-over table the generator reads, per axis.
MAX_TABLE = 16

#: A table lookup that can reach at most this many entries is a chain of
#: selects over them (each read at one address for the whole warp); a
#: larger one indexes the params at run time, which the card serializes
#: over a warp's distinct addresses (B1-gen-KA's three 2 x 2 lookups:
#: 0.9617 ms so, 0.4181 ms as selects, on an H100; PERF.md §6).
SELECT_MAX = 16

_DT = {torch.float32: "f32", torch.bfloat16: "bf16", torch.bool: "bool",
       torch.int32: "i32", torch.int16: "i16", torch.int8: "i8",
       torch.uint8: "u8"}
_TORCH = {v: k for k, v in _DT.items()}
_INTS = ("i32", "i16", "i8", "u8")
_FLOATS = ("f32", "bf16")
_TYPE = {"f32": "F32", "bf16": "BF16"}
_CTYPE = {"f32": "float", "bf16": "float", "bool": "bool",
          **dict.fromkeys(_INTS, "int")}
# an integer value of a narrower dtype, held as an int, wrapped to it
_NARROW = {"i32": "{}", "i16": "static_cast<int>(static_cast<short>({}))",
           "i8": "static_cast<int>(static_cast<signed char>({}))",
           "u8": "(({}) & 0xff)"}

#: Prop dtypes that travel as the bits of their int32 value.
INT_PROP_DTYPES = (torch.int32, torch.int16, torch.int8, torch.uint8,
                   torch.bool)


class Prop(NamedTuple):
    """How a prop tile reaches a functor: ``width`` 0 for a ``(C, n)``
    scalar, w for a ``(C, n, w)`` vector; ``dtype`` float32 for every
    floating prop (packed as fp32) or its own integer or bool dtype
    (packed as the bits of its int32 value)."""

    width: int
    dtype: torch.dtype


def check_prop_dtype(name: str, dtype: torch.dtype) -> None:
    """Raise NotImplementedError naming a prop dtype the kernel cannot
    carry (int64, complex)."""
    if not (dtype.is_floating_point or dtype in INT_PROP_DTYPES):
        raise NotImplementedError(
            f"prop {name!r} is {dtype}: the CUDA cell-pair kernel carries "
            "floating props as fp32 and int32, int16, int8, uint8 and bool "
            "props as the bits of their int32 value")


def prop_of(name: str, t: torch.Tensor) -> Prop:
    """The :class:`Prop` of a ``(C, n)`` or ``(C, n, w)`` prop tile."""
    if t.dim() not in (2, 3):
        raise ValueError(f"prop {name!r} has shape {tuple(t.shape)}; a "
                         "prop tile is (C, n) or (C, n, w)")
    check_prop_dtype(name, t.dtype)
    width = 0 if t.dim() == 2 else int(t.shape[-1])
    return Prop(width, torch.float32 if t.is_floating_point() else t.dtype)


class Generated(NamedTuple):
    """A pair body's generated functor at one dim and prop layout."""

    kind: str                     # "gen_<hash>": the registry key
    dim: int
    out: Tuple[Tuple[str, str], ...]     # sorted (name, "radial"|"scalar")
    props: Tuple[str, ...]        # the props it reads, in packed order
    widths: Tuple[int, ...]       # per prop: 0 (a scalar) or its width
    params: Tuple[float, ...]     # the body's numbers, fp32 slots first
    code: str                     # the functor (both specializations)
    # (precision, its bf16 outputs) of each bf16x:<names> entry
    mixed: Tuple[Tuple[str, Tuple[str, ...]], ...] = ()

    @property
    def precs(self) -> Tuple[str, ...]:
        """Its C entries' precisions."""
        return BASE_PRECS + tuple(p for p, _ in self.mixed)

    @property
    def width(self) -> int:
        """Floats per particle in the packed props."""
        return sum(max(w, 1) for w in self.widths)

    @property
    def functor(self) -> str:
        """The C++ template's name, ``GenBody_<hash>``."""
        return f"GenBody_{self.kind[4:]}"

    def with_mixed(self, prec: str, sel) -> "Generated":
        """This functor with a ``bf16x:<names>`` entry named ``prec`` that
        takes outputs ``sel`` from the bf16 evaluation (itself if it has
        one)."""
        sel = tuple(sorted(sel))
        for p, s in self.mixed:
            if p == prec:
                if s != sel:
                    raise ValueError(
                        f"the bf16x selections {s} and {sel} both name the "
                        f"C entry {prec!r}; rename an output")
                return self
        return self._replace(mixed=tuple(sorted(self.mixed + ((prec, sel),))))

    def source(self) -> str:
        """The whole ``.cu``: the engine header, the functor, the C
        entries."""
        name = self.functor
        lines = [f"// Generated by repro_torch/kernels/cell_pair/codegen.py "
                 f"from a traced pair body; dim {self.dim}, outputs "
                 f"{', '.join(n for n, _ in self.out)}, props "
                 f"{', '.join(self.props) or '(none)'}.",
                 f'#include "{ENGINE}"', "", "namespace {", "",
                 self.code]
        radial = [n for n, k in self.out if k == "radial"]
        scalar = [n for n, k in self.out if k == "scalar"]
        bodies = {"f32": f"{name}<F32>", "bf16x": f"{name}<BF16>"}
        for prec, sel in self.mixed:
            rad = sum(1 << k for k, n in enumerate(radial) if n in sel)
            sca = sum(1 << k for k, n in enumerate(scalar) if n in sel)
            alias = f"Mixed_{prec}"
            lines.append(f"using {alias} = MixedBody<{name}<F32>, "
                         f"{name}<BF16>, {rad}u, {sca}u>;")
            bodies[prec] = alias
        n_out = sum(self.dim if k == "radial" else 1 for _, k in self.out)
        entries = [f"CELL_PAIR_ENTRY_FIT(cell_pair_{self.kind}_{prec}_d"
                   f"{self.dim}, {bodies[prec]}, {self.width}, "
                   f"{entry_bound(n_out, prec)})"
                   for prec in self.precs]
        lines += ["", "}  // namespace", "", 'extern "C" {', *entries,
                  "}", ""]
        return "\n".join(lines)


# --------------------------------------------------------------------------
# Tracing
# --------------------------------------------------------------------------

def _pair_axis(dim: int, props: Dict[str, Prop]) -> int:
    """The traced pair axis: a size that is no DIM and no prop width, so
    that a value's shape tells its components."""
    sizes = {1, dim} | {p.width for p in props.values()}
    n = 7
    while n in sizes:
        n += 1
    return n


def _trace(body, out, dim: int, props: Dict[str, Prop], dtype, n: int):
    """The body's aten graph at operand dtype ``dtype``: placeholders dx
    (n, dim), r2 (n,), ok (n,), then wi[k], wj[k] per prop in sorted
    order ((n,) or (n, w); floating props in ``dtype``, integer ones in
    their own); outputs the sorted ``out`` values (radial: the
    magnitude)."""
    from torch.fx.experimental.proxy_tensor import make_fx
    from torch.fx.experimental.symbolic_shapes import \
        GuardOnDataDependentSymNode
    names = sorted(props)

    def fn(dxt, r2, ok, *pv):
        wi = {k: pv[2 * i] for i, k in enumerate(names)}
        wj = {k: pv[2 * i + 1] for i, k in enumerate(names)}
        vals = body(lambda d: dxt[..., d], r2, ok, wi, wj)
        return [check_out_kind(k, kind, vals[k])
                for k, kind in sorted(out.items())]

    args = [torch.zeros((n, dim), dtype=dtype), torch.zeros(n, dtype=dtype),
            torch.ones(n, dtype=torch.bool)]
    for k in names:
        p = props[k]
        shape = (n, p.width) if p.width else (n,)
        pdt = dtype if p.dtype.is_floating_point else p.dtype
        args += [torch.zeros(shape, dtype=pdt), torch.zeros(shape, dtype=pdt)]
    try:
        return make_fx(torch.func.functionalize(fn),
                       tracing_mode="fake")(*args)
    except GuardOnDataDependentSymNode as e:
        raise NotImplementedError(
            "the pair body branches in Python on a traced value "
            "(data-dependent control flow); write it with torch.where for "
            "the CUDA cell-pair kernel") from e
    except AssertionError as e:
        if "FakeTensor" not in str(e):
            raise
        # as repro's pallas_call refuses a captured constant array
        raise NotImplementedError(
            "the pair body closes over a tensor made outside it; pass it as "
            "a prop (a table of numbers written in the body is taken)") from e


# --------------------------------------------------------------------------
# Emitting
# --------------------------------------------------------------------------

class _Val(NamedTuple):
    c: List[str]       # C expression per component (1 or the width)
    dtype: str         # "f32" | "bf16" | "bool" | "i32" | "i16" | ...
    ndim: int          # the traced tensor's ndim (0: a 0-d constant)


class _Table(NamedTuple):
    """A closed-over float table: its entries are params from slot
    ``off``, read at ``off + sum(i_k * strides[k])``; ``dtypes`` is the
    stored dtype and each conversion applied since."""

    off: int
    shape: Tuple[int, ...]
    strides: Tuple[int, ...]
    dtypes: Tuple[str, ...]


class _Stack(NamedTuple):
    """A ``torch.stack`` along a new leading axis: each member's
    components, in stack order, as values of ``dtype``. It is read only
    by a reduction over that axis."""

    members: List[List[str]]
    dtype: str


class _Reduced(NamedTuple):
    """The (values, indices) of ``max.dim`` / ``min.dim``: only the
    values are read."""

    values: _Val


def _meta(node):
    val = node.meta.get("val")
    if not isinstance(val, torch.Tensor):
        raise NotImplementedError(
            f"{node.target}: a pair body's values must be tensors")
    if val.dtype not in _DT:
        raise NotImplementedError(
            f"{node.target}: dtype {val.dtype} (the CUDA cell-pair kernel's "
            "generated bodies compute in float32, bfloat16, bool, int32, "
            "int16, int8 and uint8)")
    return val


def _ncomp(shape, n: int, what) -> int:
    """Components of a traced value: 1 for a per-pair scalar (shapes (),
    (n,), (1,)), w for a vector (n, w) / (1, w)."""
    shape = tuple(shape)
    if len(shape) == 0 or shape in ((n,), (1,)):
        return 1
    if len(shape) == 2 and shape[0] in (n, 1):
        return shape[1]
    raise NotImplementedError(
        f"{what}: a value of shape {shape} (the traced pair axis is {n}); "
        "a body's values are per-pair scalars or vectors")


def _needed(gm) -> set:
    """The graph's nodes that its outputs depend on."""
    need, todo = set(), list(list(gm.graph.nodes)[-1].all_input_nodes)
    while todo:
        nd = todo.pop()
        if nd not in need:
            need.add(nd)
            todo += nd.all_input_nodes
    return need


def _int_literal(value, dtype: str) -> str:
    """A Python number as a C int of integer dtype ``dtype`` (wrapped as
    PyTorch converts a number to that dtype)."""
    v = int(torch.tensor(int(value)).to(_TORCH[dtype]))
    return "(-2147483647 - 1)" if v == -2 ** 31 else str(v)


_UNARY = ("neg", "abs", "exp", "log", "sqrt", "rsqrt", "reciprocal", "tanh",
          "sin", "cos", "erf", "erfc", "log1p", "expm1", "floor", "ceil",
          "round", "trunc", "sign", "sigmoid", "tan", "asin", "acos", "atan",
          "sinh", "cosh", "asinh", "acosh", "atanh", "log2", "exp2", "log10",
          "lgamma")
_REDUCE = ("amax", "amin", "sum", "prod")
_VIEWS = ("_to_copy", "clone", "alias", "detach", "lift_fresh_copy", "view",
          "_unsafe_view", "reshape", "unsqueeze", "squeeze", "expand",
          "view_copy", "expand_copy", "unsqueeze_copy", "squeeze_copy",
          "alias_copy", "detach_copy")


class _Emitter:
    """One traced graph as the body of one ``GenBody<P>`` specialization."""

    def __init__(self, gm, dim: int, prec: str, props: Dict[str, Prop],
                 out, used: set, n: int):
        self.gm, self.dim, self.prec, self.n = gm, dim, prec, n
        self.P = _TYPE[prec]
        self.props = props
        self.used = used
        self.out = sorted(out.items())
        self.consts: List[float] = []
        self.lines: List[str] = []
        self.vals: Dict = {}
        self.n_tmp = 0

    # -- helpers -----------------------------------------------------------
    def const(self, value: float) -> str:
        self.consts.append(float(np.float32(value)))
        return f"c[{len(self.consts) - 1}]"

    def let(self, dtype: str, expr: str) -> str:
        name = f"v{self.n_tmp}"
        self.n_tmp += 1
        self.lines.append(f"    const {_CTYPE[dtype]} {name} = {expr};")
        return name

    @staticmethod
    def narrow(expr: str, dtype: str) -> str:
        return _NARROW[dtype].format(expr)

    @classmethod
    def cvt(cls, expr: str, src: str, dst: str) -> str:
        """A value of dtype ``src`` converted to ``dst``, as PyTorch's
        ``_to_copy`` converts it."""
        if src == dst or (src == "bf16" and dst == "f32"):
            return expr
        if dst == "bool":
            return f"({expr} != 0)" if src in _INTS else f"({expr} != 0.0f)"
        if src == "bool":
            return f"({expr} ? 1 : 0)" if dst in _INTS \
                else f"({expr} ? 1.0f : 0.0f)"
        if dst in _INTS:
            e = expr if src in _INTS else f"static_cast<int>({expr})"
            return cls.narrow(e, dst)
        if src in _INTS:
            expr = f"static_cast<float>({expr})"
        return expr if dst == "f32" else f"BF16::r({expr})"

    def rounded_const(self, value, dtype: str) -> str:
        """A number as a value of ``dtype`` (a filled tensor, a clamp
        bound, the other side of a comparison, an integer op's operand)."""
        if dtype == "bool":
            return "true" if value else "false"
        if dtype in _INTS:
            return _int_literal(value, dtype)
        c = self.const(value)
        return c if dtype == "f32" else f"BF16::r({c})"

    def val(self, a) -> _Val:
        if not isinstance(a, torch.fx.Node):
            raise NotImplementedError(f"unexpected operand {a!r}")
        v = self.vals[a]
        if isinstance(v, _Table):
            raise NotImplementedError(
                f"{a.target}: a closed-over table is read only by indexing "
                "it with integer values")
        if isinstance(v, (_Stack, _Reduced)):
            raise NotImplementedError(
                f"{a.target}: a stack is read only by amax, amin, sum or "
                "prod over its leading axis, and max.dim / min.dim only "
                "through their values")
        return v

    @staticmethod
    def is_num(a) -> bool:
        return isinstance(a, (bool, int, float)) and not isinstance(
            a, torch.fx.Node)

    def common(self, *ops) -> str:
        """PyTorch's result dtype of an op on these operands."""
        args = []
        for a in ops:
            if self.is_num(a):
                args.append(a)
            else:
                v = self.val(a)
                args.append(torch.zeros((1,) * v.ndim, dtype=_TORCH[v.dtype]))
        res = args[0]
        for b in args[1:]:
            dt = torch.result_type(res, b)
            res = torch.zeros((1,) * max(getattr(res, "ndim", 0),
                                          getattr(b, "ndim", 0)), dtype=dt)
        if not isinstance(res, torch.Tensor):
            raise NotImplementedError("an op on numbers only")
        if res.dtype not in _DT:
            raise NotImplementedError(f"result dtype {res.dtype}")
        return _DT[res.dtype]

    def operand(self, a, T: str, n: int, *, scalar_as: str = "opmath"):
        """Operand ``a`` as ``n`` component expressions of type ``T``. A
        number is an fp32 param (``opmath``, as a floating arithmetic op
        takes it on the card) or a value of ``T`` (``rounded``; integer
        and bool types always)."""
        if self.is_num(a):
            e = self.const(a) if scalar_as == "opmath" and T in _FLOATS \
                else self.rounded_const(a, T)
            return [e] * n
        v = self.val(a)
        comps = v.c * n if len(v.c) == 1 else v.c
        return [self.cvt(e, v.dtype, T) for e in comps]

    # -- the graph -----------------------------------------------------------
    def run(self) -> List[str]:
        """Emit every node the outputs need; returns the output
        statements."""
        nodes = list(self.gm.graph.nodes)
        need = _needed(self.gm)
        placeholders = [nd for nd in nodes if nd.op == "placeholder"]
        P = self.P
        for i, nd in enumerate(placeholders):
            if nd not in need:
                continue
            if i == 0:
                c = [self.let(self.prec, f"{P}::r(dx_in[{d}])")
                     for d in range(self.dim)]
                self.vals[nd] = _Val(c, self.prec, 2)
            elif i == 1:
                self.vals[nd] = _Val([self.let(self.prec, f"{P}::r(r2_in)")],
                                     self.prec, 1)
            elif i == 2:
                self.vals[nd] = _Val(["true"], "bool", 1)
            else:
                k = sorted(self.props)[(i - 3) // 2]
                self.vals[nd] = self.load_prop(
                    k, "wi_in" if (i - 3) % 2 == 0 else "wj_in")
        for nd in nodes:
            if nd.op in ("placeholder", "output") or nd not in need:
                continue
            if nd.op == "get_attr":
                self.vals[nd] = self.constant(nd)
                continue
            if nd.op != "call_function":
                raise NotImplementedError(f"graph node {nd.op} {nd.target}")
            self.vals[nd] = self.emit(nd)
        return self.outputs(nodes[-1])

    def constant(self, nd):
        """A tensor the body closes over: a 0-d number, or a float table
        whose entries become params."""
        t = getattr(self.gm, nd.target)
        shape = tuple(getattr(t, "shape", ()))
        if isinstance(t, torch.Tensor) and t.dim() == 0 and t.dtype in _DT:
            dt = _DT[t.dtype]
            return _Val([self.rounded_const(t.item(), dt)], dt, 0)
        if isinstance(t, torch.Tensor) and t.dim() in (1, 2) \
                and _DT.get(t.dtype) in _FLOATS \
                and max(shape) <= MAX_TABLE:
            off = len(self.consts)
            for v in t.detach().float().reshape(-1).tolist():
                self.const(v)
            strides = (shape[1], 1) if t.dim() == 2 else (1,)
            return _Table(off, shape, strides, (_DT[t.dtype],))
        raise NotImplementedError(
            f"a tensor the pair body closes over ({nd.target}, shape "
            f"{shape}, {getattr(t, 'dtype', type(t).__name__)}): only 0-d "
            "numbers and float32 or bfloat16 tables of 1 or 2 axes of at "
            f"most {MAX_TABLE} are taken")

    def load_prop(self, k: str, side: str) -> _Val:
        """Prop ``k`` of one side (``wi_in`` / ``wj_in``) from its packed
        row: the props the body reads, in sorted order. An integer prop
        travels as its int32 value's bits."""
        p = self.props[k]
        off = sum(max(self.props[name].width, 1)
                  for name in sorted(self.used) if name < k)
        if p.dtype.is_floating_point:
            dt, read = self.prec, f"{self.P}::r({{}})"
        elif p.dtype == torch.bool:
            dt, read = "bool", "(__float_as_int({}) != 0)"
        else:
            dt, read = _DT[p.dtype], "__float_as_int({})"
        c = [self.let(dt, read.format(f"{side}[{off + d}]"))
             for d in range(max(p.width, 1))]
        return _Val(c, dt, 2 if p.width else 1)

    def emit(self, nd) -> _Val:
        tgt = nd.target
        what = str(tgt)
        packet = getattr(getattr(tgt, "overloadpacket", None), "__name__",
                         None)
        args = list(nd.args)
        kw = dict(nd.kwargs)
        if isinstance(self.vals.get(args[0]) if args and isinstance(
                args[0], torch.fx.Node) else None, _Table):
            return self.table_op(nd, packet, args, kw)
        if tgt is operator.getitem:
            src = self.vals.get(args[0])
            if isinstance(src, _Reduced) and args[1] == 0:
                return src.values
            raise NotImplementedError(
                f"{args[0].target}: item {args[1]} (only the values of "
                "max.dim / min.dim are read; their indices are int64)")
        if packet in ("max", "min") and tgt._overloadname == "dim":
            val = nd.meta["val"][0]
            return _Reduced(self.reduce(nd, "a" + packet, args, kw,
                                        _DT[val.dtype], val.dim()))
        meta = _meta(nd)
        T = _DT[meta.dtype]
        if packet == "stack":
            return self.stack(nd, args, kw, meta, T)
        if packet in _REDUCE:
            return self.reduce(nd, packet, args, kw, T, meta.dim())
        n = _ncomp(meta.shape, self.n, what)
        ndim = meta.dim()

        def make(comps, dtype=T):
            return _Val([self.let(dtype, e) for e in comps], dtype, ndim)

        if T in _INTS:
            res = self.emit_int(nd, packet, args, kw, T, n, make)
            if res is not None:
                return res
        O = f"Ops<{_TYPE.get(T, 'F32')}>"
        if T in _FLOATS and (packet == "floor_divide" or (
                packet == "div" and kw.get("rounding_mode") is not None)):
            return self.rounding_div(nd, packet, args, kw, T, n, O, make)
        if packet in ("remainder", "fmod") and T in _FLOATS:
            # a number operand is rounded to T (gpu_kernel_with_scalars)
            xa, xb = (self.operand(a, T, n, scalar_as="rounded")
                      for a in args[:2])
            return make([f"{O}::{packet}({x}, {y})" for x, y in zip(xa, xb)])
        if packet in ("add", "sub", "mul", "div", "rsub") and T in _FLOATS:
            a, b = args[0], args[1]
            alpha = kw.get("alpha", 1)
            if packet == "rsub":
                a, b = b, a
                packet = "sub"
            if packet == "div" and self.is_num(b):
                inv = np.float32(1.0) / np.float32(b)
                xa = self.operand(a, T, n)
                return make([f"{O}::mul({x}, {self.const(inv)})"
                             for x in xa])
            xa = self.operand(a, T, n)
            xb = self.operand(b, T, n)
            if packet in ("add", "sub") and alpha not in (1, 1.0):
                al = alpha if packet == "add" else -alpha
                if al in (-1, -1.0) and packet == "add":
                    return make([f"{O}::sub({x}, {y})"
                                 for x, y in zip(xa, xb)])
                if al in (1, 1.0):
                    return make([f"{O}::add({x}, {y})"
                                 for x, y in zip(xa, xb)])
                c = self.const(al)
                return make([f"{O}::add_alpha({x}, {y}, {c})"
                             for x, y in zip(xa, xb)])
            return make([f"{O}::{packet}({x}, {y})" for x, y in zip(xa, xb)])
        if packet in ("maximum", "minimum") and T in _FLOATS:
            xa, xb = (self.operand(a, T, n) for a in args[:2])
            return make([f"{O}::{packet}({x}, {y})" for x, y in zip(xa, xb)])
        if packet in _UNARY and T in _FLOATS:
            xa = self.operand(args[0], T, n)
            d = int(kw.get("decimals", 0)) if packet == "round" else 0
            if d:
                # round_decimals_kernel_cuda: t = 10^|d| in double, as T
                with np.errstate(over="ignore"):
                    t = self.rounded_const(np.float64(10.0) ** abs(d), T)
                fn = "round_dec" if d > 0 else "round_dec_neg"
                return make([f"{O}::{fn}({x}, {t})" for x in xa])
            fn = {"reciprocal": "recip"}.get(packet, packet)
            return make([f"{O}::{fn}({x})" for x in xa])
        if packet in ("atan2", "hypot") and T in _FLOATS:
            xa, xb = (self.operand(a, T, n) for a in args[:2])
            return make([f"{O}::{packet}({x}, {y})" for x, y in zip(xa, xb)])
        if packet == "copysign" and T in _FLOATS:
            xa, xb = (self.operand(a, T, n, scalar_as="rounded")
                      for a in args[:2])
            return make([f"{O}::copysign({x}, {y})" for x, y in zip(xa, xb)])
        if packet in ("clamp", "clamp_min", "clamp_max") and T in _FLOATS:
            x = self.operand(args[0], T, n)
            lo, hi = self.clamp_bounds(packet, args, kw)
            if lo is not None:
                if self.is_num(lo):
                    c = self.rounded_const(lo, T)
                    x = [f"{O}::clamp_min({e}, {c})" for e in x]
                else:
                    x = [f"{O}::maximum({e}, {f})" for e, f in
                         zip(x, self.operand(lo, T, n))]
            if hi is not None:
                if self.is_num(hi):
                    c = self.rounded_const(hi, T)
                    x = [f"{O}::clamp_max({e}, {c})" for e in x]
                else:
                    x = [f"{O}::minimum({e}, {f})" for e, f in
                         zip(x, self.operand(hi, T, n))]
            return make(x)
        if packet == "pow" and T in _FLOATS:
            return self.pow(nd, args, T, n, O, make)
        if packet in ("eq", "ne", "lt", "le", "gt", "ge"):
            op = {"eq": "==", "ne": "!=", "lt": "<", "le": "<=", "gt": ">",
                  "ge": ">="}[packet]
            C = self.common(*args[:2])
            xa = self.operand(args[0], C, n, scalar_as="rounded")
            xb = self.operand(args[1], C, n, scalar_as="rounded")
            return make([f"{x} {op} {y}" for x, y in zip(xa, xb)], "bool")
        if packet in ("logical_and", "logical_or", "logical_xor") or (
                packet in ("bitwise_and", "bitwise_or", "bitwise_xor")
                and T == "bool"):
            op = {"and": "&&", "or": "||", "xor": "!="}[packet.split("_")[1]]
            xa, xb = (self.operand(a, "bool", n, scalar_as="rounded")
                      for a in args[:2])
            return make([f"({x} {op} {y})" for x, y in zip(xa, xb)], "bool")
        if packet == "logical_not" or (packet == "bitwise_not"
                                       and T == "bool"):
            return make([f"!{x}" for x in
                         self.operand(args[0], "bool", n)], "bool")
        if packet in ("bitwise_and", "bitwise_or", "bitwise_xor",
                      "bitwise_not"):
            raise NotImplementedError(f"{what} on {T} values (bitwise ops "
                                      "are taken on booleans and integers)")
        if packet == "where":
            cond = self.operand(args[0], "bool", n)
            xa = self.operand(args[1], T, n, scalar_as="rounded")
            xb = self.operand(args[2], T, n, scalar_as="rounded")
            return make([f"{c} ? {x} : {y}" for c, x, y in
                         zip(cond, xa, xb)])
        if packet in ("full", "full_like", "new_full", "scalar_tensor"):
            value = {"full": 1, "full_like": 1, "new_full": 2,
                     "scalar_tensor": 0}[packet]
            value = args[value] if len(args) > value else kw["fill_value"]
            return _Val([self.rounded_const(value, T)] * n, T, ndim)
        if packet in ("zeros_like", "ones_like", "zeros", "ones",
                      "new_zeros", "new_ones"):
            one = packet.startswith(("ones", "new_ones"))
            lit = {"bool": ("false", "true"), "f32": ("0.0f", "1.0f"),
                   "bf16": ("0.0f", "1.0f")}.get(T, ("0", "1"))[one]
            return _Val([lit] * n, T, ndim)
        if packet in _VIEWS:
            src = self.val(args[0])
            if len(src.c) not in (1, n):
                raise NotImplementedError(
                    f"{what}: from {len(src.c)} components to {n}")
            comps = src.c * n if len(src.c) == 1 else src.c
            if src.dtype == T:
                return _Val(comps, T, ndim)
            return make([self.cvt(e, src.dtype, T) for e in comps])
        if packet in ("select", "select_copy", "slice", "slice_copy"):
            src = self.val(args[0])
            src_meta = _meta(args[0])
            axis = args[1] if len(args) > 1 else kw.get("dim", 0)
            if src_meta.dim() != 2 or axis not in (1, -1):
                raise NotImplementedError(
                    f"{what}: a {packet} of axis {axis} of a value of shape "
                    f"{tuple(src_meta.shape)} (only a vector's component "
                    "axis is taken)")
            width = src_meta.shape[1]
            comps = src.c if len(src.c) == width else src.c * width
            if packet.startswith("select"):
                return _Val([comps[args[2] % width]], src.dtype, ndim)
            start, end, step = (list(args[2:]) + [None, None, 1])[:3]
            return _Val(comps[slice(start, end, step)], src.dtype, ndim)
        if packet == "index":
            raise NotImplementedError(
                f"{what} of a value the body computes (only a closed-over "
                "table is indexed)")
        raise NotImplementedError(
            f"{what} is not an op the CUDA cell-pair kernel's generated "
            f"bodies take on {T} values (codegen.py lists them)")

    def rounding_div(self, nd, packet, args, kw, T, n, O, make):
        """``floor_divide`` and ``div`` with a rounding mode on floating
        values, as div_floor_kernel_cuda and div_trunc_kernel_cuda compute
        them: a number divisor (a CPU scalar) through its fp32 reciprocal,
        a number dividend rounded to T."""
        mode = "floor" if packet == "floor_divide" else kw["rounding_mode"]
        if mode not in ("floor", "trunc"):
            raise NotImplementedError(f"{nd.target} with rounding_mode "
                                      f"{mode!r}")
        a, b = args[0], args[1]
        if self.is_num(b):
            xa = self.operand(a, T, n)
            with np.errstate(divide="ignore"):
                inv = self.const(np.float32(1.0) / np.float32(b))
            if mode == "trunc":
                return make([f"{O}::div_trunc_s({x}, {inv})" for x in xa])
            if np.float32(b) == 0.0:       # div_true_kernel_cuda's a * inf
                return make([f"{O}::mul({x}, {inv})" for x in xa])
            c = self.const(b)
            return make([f"{O}::floor_div_s({x}, {c}, {inv})" for x in xa])
        xa = self.operand(a, T, n, scalar_as="rounded")
        xb = self.operand(b, T, n)
        fn = "floor_div" if mode == "floor" else "div_trunc"
        return make([f"{O}::{fn}({x}, {y})" for x, y in zip(xa, xb)])

    def stack(self, nd, args, kw, meta, T) -> "_Stack | _Val":
        """``torch.stack`` of per-pair values: along a new leading axis a
        :class:`_Stack` (read by a reduction over it); of scalars along
        the last axis, a vector of them."""
        dim = args[1] if len(args) > 1 else kw.get("dim", 0)
        dim %= meta.dim()
        vals = [self.val(a) for a in args[0]]
        width = max(len(v.c) for v in vals)
        members = [[self.cvt(e, v.dtype, T) for e in
                    (v.c * width if len(v.c) == 1 else v.c)] for v in vals]
        if dim == 0:
            return _Stack(members, T)
        if width == 1 and meta.dim() == 2:
            return _Val([m[0] for m in members], T, 2)
        raise NotImplementedError(
            f"{nd.target} along axis {dim} into shape {tuple(meta.shape)} "
            "(a stack is taken along a new leading axis, or of per-pair "
            "scalars along the last)")

    def reduce(self, nd, packet, args, kw, T, ndim) -> _Val:
        """``amax``, ``amin``, ``sum`` or ``prod`` over the leading axis of
        a stack or over a vector's components: a chain in their order; a
        floating sum or product in fp32, rounded to T once, as PyTorch's
        reductions accumulate; an integer one wrapping (an integer sum is
        int64 unless given ``dtype``)."""
        what = str(nd.target)
        src = self.vals[args[0]]
        src_meta = _meta(args[0])
        dims = args[1] if len(args) > 1 else kw.get("dim")
        keep = args[2] if len(args) > 2 else kw.get("keepdim", False)
        if isinstance(dims, int):
            dims = [dims]
        dims = [d % src_meta.dim() for d in (dims or [])]
        if isinstance(src, _Stack) and dims == [0] and not keep:
            lists, sdt = [list(c) for c in zip(*src.members)], src.dtype
        elif isinstance(src, _Val) and src_meta.dim() == 2 and dims == [1] \
                and not keep:
            lists, sdt = [src.c], src.dtype
        else:
            raise NotImplementedError(
                f"{what} over {dims} (keepdim {keep}) of a value of shape "
                f"{tuple(src_meta.shape)} (a reduction is taken over a "
                "stack's leading axis or a vector's components)")
        if T == "bool":
            raise NotImplementedError(f"{what} of bool values")
        comps = []
        for lst in lists:
            xs = [self.cvt(e, sdt, T if T in _INTS else "f32") for e in lst]
            acc = xs[0]
            for e in xs[1:]:
                if packet in ("amax", "amin") and T in _INTS:
                    op = ">" if packet == "amax" else "<"
                    acc = self.let(T, f"({acc} {op} {e} ? {acc} : {e})")
                elif T in _INTS:
                    fn = "add" if packet == "sum" else "mul"
                    acc = self.let(T, self.narrow(f"Int::{fn}({acc}, {e})",
                                                  T))
                elif packet in ("amax", "amin"):
                    fn = "maximum" if packet == "amax" else "minimum"
                    acc = f"Ops<F32>::{fn}({acc}, {e})"
                else:
                    rn = "__fadd_rn" if packet == "sum" else "__fmul_rn"
                    acc = f"{rn}({acc}, {e})"
            comps.append(acc if T in _INTS else
                         f"Ops<{_TYPE[T]}>::cvt({acc})")
        return _Val([self.let(T, e) for e in comps], T, ndim)

    @staticmethod
    def clamp_bounds(packet, args, kw):
        if packet == "clamp":
            return (args[1] if len(args) > 1 else kw.get("min"),
                    args[2] if len(args) > 2 else kw.get("max"))
        if packet == "clamp_min":
            return args[1], None
        return None, args[1]

    def emit_int(self, nd, packet, args, kw, T, n, make):
        """An op with an integer result, or None where it is a
        dtype-neutral op (comparison operands, where, constants, views,
        select) that :meth:`emit` handles for every dtype."""
        what = str(nd.target)
        wrap = lambda e: self.narrow(e, T)
        if packet in ("add", "sub", "mul", "rsub"):
            a, b = args[0], args[1]
            if packet == "rsub":
                a, b, packet = b, a, "sub"
            xa = self.operand(a, T, n)
            xb = self.operand(b, T, n)
            alpha = kw.get("alpha", 1)
            if alpha != 1:
                c = _int_literal(alpha, T)
                xb = [f"Int::mul({c}, {y})" for y in xb]
            return make([wrap(f"Int::{packet}({x}, {y})")
                         for x, y in zip(xa, xb)])
        if packet == "pow":
            base, e = args[0], args[1]
            if self.is_num(base):
                raise NotImplementedError(f"{what}: a number raised to a "
                                          "tensor")
            if self.is_num(e) and int(e) < 0:
                raise NotImplementedError(f"{what}: an integer to the "
                                          f"negative power {e}")
            xa, xe = (self.operand(a, T, n) for a in (base, e))
            return make([wrap(f"Int::pow({x}, {y})") for x, y in zip(xa, xe)])
        if packet in ("div", "floor_divide", "remainder", "fmod"):
            mode = kw.get("rounding_mode") if packet == "div" else None
            if packet == "div" and mode not in ("floor", "trunc"):
                raise NotImplementedError(f"{what} with rounding_mode "
                                          f"{mode!r} on integers")
            fn = {"floor": "floor_div", "trunc": "div_trunc",
                  None: {"floor_divide": "floor_div", "remainder": "rem",
                         "fmod": "fmod"}.get(packet)}[mode]
            xa, xb = (self.operand(a, T, n) for a in args[:2])
            return make([wrap(f"Int::{fn}({x}, {y})")
                         for x, y in zip(xa, xb)])
        if packet in ("maximum", "minimum"):
            op = ">" if packet == "maximum" else "<"
            xa, xb = (self.operand(a, T, n) for a in args[:2])
            return make([f"({x} {op} {y} ? {x} : {y})"
                         for x, y in zip(xa, xb)])
        if packet in ("clamp", "clamp_min", "clamp_max"):
            x = self.operand(args[0], T, n)
            lo, hi = self.clamp_bounds(packet, args, kw)
            if lo is not None:
                x = [f"({e} < {f} ? {f} : {e})" for e, f in
                     zip(x, self.operand(lo, T, n))]
            if hi is not None:
                x = [f"({e} > {f} ? {f} : {e})" for e, f in
                     zip(x, self.operand(hi, T, n))]
            return make(x)
        if packet in ("neg", "abs", "sign"):
            return make([wrap(f"Int::{packet}({x})")
                         for x in self.operand(args[0], T, n)])
        if packet in ("floor", "ceil", "round", "trunc"):
            return make(self.operand(args[0], T, n))
        if packet in ("bitwise_and", "bitwise_or", "bitwise_xor"):
            op = {"and": "&", "or": "|", "xor": "^"}[packet.split("_")[1]]
            xa, xb = (self.operand(a, T, n) for a in args[:2])
            return make([wrap(f"({x} {op} {y})") for x, y in zip(xa, xb)])
        if packet == "bitwise_not":
            return make([wrap(f"(~{x})")
                         for x in self.operand(args[0], T, n)])
        if packet in ("where", "full", "full_like", "new_full",
                      "scalar_tensor", "zeros_like", "ones_like", "zeros",
                      "ones", "new_zeros", "new_ones", "select",
                      "select_copy", "slice", "slice_copy", "index",
                      *_VIEWS):
            return None
        raise NotImplementedError(
            f"{what} is not an op the CUDA cell-pair kernel's generated "
            f"bodies take on {T} values (codegen.py lists them)")

    def table_op(self, nd, packet, args, kw):
        """An op on a closed-over table: a conversion, a select of a
        constant row or column, or an index by integer values."""
        what = str(nd.target)
        tab = self.vals[args[0]]
        if packet in _VIEWS and packet not in (
                "view", "_unsafe_view", "reshape", "unsqueeze", "squeeze",
                "expand", "view_copy", "expand_copy", "unsqueeze_copy",
                "squeeze_copy"):
            dst = _DT[_meta(nd).dtype] if packet == "_to_copy" \
                else tab.dtypes[-1]
            if dst not in _FLOATS:
                raise NotImplementedError(f"{what}: a table as {dst}")
            return tab if dst == tab.dtypes[-1] \
                else tab._replace(dtypes=tab.dtypes + (dst,))
        if packet in ("select", "select_copy"):
            axis, idx = args[1] % len(tab.shape), args[2]
            idx %= tab.shape[axis]
            tab = _Table(tab.off + idx * tab.strides[axis],
                         tab.shape[:axis] + tab.shape[axis + 1:],
                         tab.strides[:axis] + tab.strides[axis + 1:],
                         tab.dtypes)
            return self.entry(tab, "0", [0]) if not tab.shape else tab
        if packet == "index":
            return self.index(nd, tab, args[1])
        raise NotImplementedError(
            f"{what} of a closed-over table (a table is read only by "
            "indexing it with integer values)")

    def entry(self, tab: _Table, flat: str, offsets, extra: int = 0) -> _Val:
        """The table entry at offset ``flat`` + ``extra``, as a value;
        ``offsets`` lists the values ``flat`` can take."""
        if len(offsets) <= SELECT_MAX:
            e = f"c[{tab.off + offsets[-1] + extra}]"
            for o in reversed(offsets[:-1]):
                e = f"({flat} == {o} ? c[{tab.off + o + extra}] : {e})"
        else:
            e = f"c[{tab.off + extra} + {flat}]"
        for src, dst in zip(tab.dtypes, tab.dtypes[1:]):
            e = self.cvt(e, src, dst)
        return _Val([self.let(tab.dtypes[-1], e)], tab.dtypes[-1], 1)

    def index(self, nd, tab: _Table, indices) -> _Val:
        """``table[i0, i1]`` (or ``table[i0]``, a row per pair) by integer
        values; a negative index counts from the end, as in PyTorch, and
        an index out of range is clamped to it (PyTorch raises there)."""
        what = str(nd.target)
        meta = _meta(nd)
        n = _ncomp(meta.shape, self.n, what)
        if any(i is None for i in indices) or len(indices) > len(tab.shape) \
                or len(tab.shape) - len(indices) > 1:
            raise NotImplementedError(
                f"{what}: a table of shape {tab.shape} indexed by "
                f"{len(indices)} values (each axis, or all but the last, by "
                "an integer value)")
        idx = []
        for i in indices:
            v = self.val(i)
            if v.dtype not in _INTS:
                raise NotImplementedError(
                    f"{what}: a table indexed by a {v.dtype} value")
            idx.append(v)
        rest = len(tab.shape) - len(indices)
        m = 1 if rest else n
        if any(len(v.c) not in (1, m) for v in idx):
            raise NotImplementedError(f"{what}: index widths "
                                      f"{[len(v.c) for v in idx]}")
        flats = []
        for d in range(m):
            terms = []
            for v, size, stride in zip(idx, tab.shape, tab.strides):
                e = f"Int::at({v.c[d % len(v.c)]}, {size})"
                terms.append(e if stride == 1 else f"{e} * {stride}")
            flats.append(self.let("i32", " + ".join(terms)))
        offsets = sorted({sum(i * st for i, st in zip(ix, tab.strides))
                          for ix in itertools.product(
                              *(range(n) for n in tab.shape[:len(idx)]))})
        if rest:
            comps = [self.entry(tab, flats[0], offsets,
                                k * tab.strides[-1]).c[0]
                     for k in range(tab.shape[-1])]
        else:
            comps = [self.entry(tab, f, offsets).c[0] for f in flats]
        return _Val(comps, tab.dtypes[-1], meta.dim())

    def pow(self, nd, args, T, n, O, make):
        what = str(nd.target)
        base, e = args[0], args[1]
        if self.is_num(base):
            raise NotImplementedError(f"{what}: a number raised to a tensor")
        x = self.operand(base, T, n)
        if not self.is_num(e):
            y = self.operand(e, T, n)
            return make([f"{O}::pow({a}, {b})" for a, b in zip(x, y)])
        e = float(e)
        if e == 0.0:
            return make(["1.0f"] * n)
        if e == 1.0:
            return make(x)
        if e == 0.5:
            return make([f"{O}::sqrt({a})" for a in x])
        if e == -0.5:
            return make([f"{O}::rsqrt({a})" for a in x])
        if e == -1.0:
            return make([f"{O}::recip({a})" for a in x])
        er = e if T == "f32" else float(torch.tensor(e).to(torch.bfloat16))
        if er == 2.0:
            return make([f"{O}::mul({a}, {a})" for a in x])
        if er == 3.0:
            return make([f"{O}::mul({O}::mul({a}, {a}), {a})" for a in x])
        if er == -2.0:
            return make([f"{O}::pow_m2({a})" for a in x])
        c = self.rounded_const(e, T)
        return make([f"{O}::pow({a}, {c})" for a in x])

    def outputs(self, out_node):
        res = out_node.args[0]
        stmts = []
        k_rad = k_sca = 0
        dx = None
        for (name, kind), nd in zip(self.out, res):
            if not isinstance(nd, torch.fx.Node):
                raise NotImplementedError(
                    f"pair-body output {name!r} is not a tensor")
            v = self.val(nd)
            if len(v.c) != 1:
                raise NotImplementedError(
                    f"pair-body output {name!r} has {len(v.c)} components "
                    "per pair; an output (a radial output's magnitude) is "
                    "one value per pair")
            m = v.c[0]
            if kind == "radial":
                if dx is None:
                    dx = [self.let(self.prec, f"{self.P}::r(dx_in[{d}])")
                          for d in range(self.dim)]
                for d in range(self.dim):
                    # mag * dx in PyTorch's result dtype of the product
                    if self.prec == "f32":
                        term = f"F32::term({self.cvt(m, v.dtype, 'f32')}, " \
                               f"{dx[d]})"
                    elif v.dtype == "f32":
                        term = f"__fmul_rn({m}, {dx[d]})"
                    else:
                        term = f"BF16::term({self.cvt(m, v.dtype, 'bf16')}, " \
                               f"{dx[d]})"
                    stmts.append(f"    radial[{k_rad * self.dim + d}] = "
                                 f"{term};")
                k_rad += 1
            else:
                stmts.append(f"    scalar[{k_sca}] = "
                             f"{self.cvt(m, v.dtype, 'f32')};")
                k_sca += 1
        return stmts


def _specialization(gm, dim, prec, props, out, used, n):
    """(the emitter, after its run: its consts; the operator's lines)."""
    em = _Emitter(gm, dim, prec, props, out, used, n)
    stmts = em.run()
    return em, em.lines + stmts


def _used_props(gm, props) -> set:
    """The props whose placeholders the outputs depend on."""
    names, need = sorted(props), _needed(gm)
    ph = [nd for nd in gm.graph.nodes if nd.op == "placeholder"]
    return {names[(i - 3) // 2] for i, nd in enumerate(ph)
            if i >= 3 and nd in need}


def _struct(name, prec, dim, n_rad, n_sca, offset, consts, body_lines):
    n = max(len(consts), 1)
    P = _TYPE[prec]
    return "\n".join([
        "template <>",
        f"struct {name}<{P}> {{",
        f"  static constexpr int DIM = {dim};",
        f"  static constexpr int N_RADIAL = {n_rad};",
        f"  static constexpr int N_SCALAR = {n_sca};",
        "  static constexpr int N_HOOK = 0;",
        f"  float c[{n}];   // the body's numbers: params[{offset}:"
        f"{offset + len(consts)}]",
        "",
        f"  static {name} from(const float* p) {{",
        f"    {name} b{{}};",
        f"    for (int k = 0; k < {len(consts)}; ++k) b.c[k] = "
        f"p[{offset} + k];",
        "    return b;",
        "  }",
        "",
        "  __device__ __forceinline__ void hook(const float* /*w*/,",
        "                                       float* /*h*/) const {}",
        "",
        "  __device__ __forceinline__ void operator()(",
        "      const float* dx_in, float r2_in, const float* wi_in,",
        "      const float* wj_in, const float* /*hi*/, const float* /*hj*/,",
        "      float* radial, float* scalar) const {",
        "    (void)dx_in; (void)r2_in; (void)wi_in; (void)wj_in;",
        "    (void)radial; (void)scalar;",
        *body_lines,
        "  }",
        "};",
    ])


def _key(body, out, dim, props):
    try:
        hash(body)
    except TypeError:
        return None
    return (body, tuple(sorted(out.items())), dim,
            tuple(sorted(props.items())))


#: Bodies traced lately (a body made anew with other numbers each step
#: would grow an unbounded cache).
_CACHE: "collections.OrderedDict[tuple, Generated]" = \
    collections.OrderedDict()
_CACHE_SIZE = 256


def generate(body, out: Dict[str, str], dim: int,
             props: Dict[str, Prop]) -> Generated:
    """The generated functor of ``body`` at ``dim`` with props ``props``
    ({name: :class:`Prop`}) and outputs ``out``. Traces the body in fp32
    and in bf16 and emits both specializations, with the entries of
    :data:`BASE_PRECS`; raises NotImplementedError naming an op or dtype
    it does not take. Cached on the body (when hashable), ``out``,
    ``dim`` and ``props``."""
    key = _key(body, out, dim, props)
    if key is not None and key in _CACHE:
        _CACHE.move_to_end(key)
        return _CACHE[key]
    for name, kind in out.items():
        if not name.isidentifier() or kind not in ("radial", "scalar"):
            raise ValueError(f"pair output {name!r}: {kind!r} (a generated "
                             "functor takes identifier names, 'radial' or "
                             "'scalar')")
    n = _pair_axis(dim, props)
    gm32 = _trace(body, out, dim, props, torch.float32, n)
    gm16 = _trace(body, out, dim, props, torch.bfloat16, n)
    used = _used_props(gm32, props) | _used_props(gm16, props)
    n_rad = sum(k == "radial" for k in out.values())
    n_sca = len(out) - n_rad
    em32, lines32 = _specialization(gm32, dim, "f32", props, out, used, n)
    em16, lines16 = _specialization(gm16, dim, "bf16", props, out, used, n)
    names = tuple(sorted(used))
    outs = tuple(sorted(out.items()))
    layout = [(k, props[k].width, str(props[k].dtype)) for k in names]
    placeholder = "GenBody"
    code = "\n".join([
        f"// outputs {outs}; props (name, width, dtype) {layout}",
        f"template <class P>\nstruct {placeholder};", "",
        _struct(placeholder, "f32", dim, n_rad, n_sca, 0, em32.consts,
                lines32), "",
        _struct(placeholder, "bf16", dim, n_rad, n_sca, len(em32.consts),
                em16.consts, lines16), ""])
    digest = hashlib.sha256(code.encode()).hexdigest()[:16]
    code = code.replace(placeholder, f"GenBody_{digest}")
    gen = Generated(kind=f"gen_{digest}", dim=dim, out=outs, props=names,
                    widths=tuple(props[k].width for k in names),
                    params=tuple(em32.consts + em16.consts), code=code)
    if key is not None:
        _CACHE[key] = gen
        if len(_CACHE) > _CACHE_SIZE:
            _CACHE.popitem(last=False)
    return gen


def source_file(gen: Generated) -> pathlib.Path:
    """Where ``gen``'s ``.cu`` goes: ``build/repro_torch/gen/``; a functor
    with ``bf16x:<names>`` entries has a file per set of entries."""
    tag = "" if not gen.mixed else "_" + hashlib.sha256(
        ",".join(gen.precs).encode()).hexdigest()[:8]
    return GEN_DIR / f"cell_pair_{gen.kind}_d{gen.dim}{tag}.cu"


def source_path(gen: Generated) -> pathlib.Path:
    """Write ``gen``'s ``.cu`` (once) and return its path."""
    path = source_file(gen)
    text = gen.source()
    if not path.exists() or path.read_text() != text:
        GEN_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(".tmp")
        tmp.write_text(text)
        tmp.replace(path)
    return path
