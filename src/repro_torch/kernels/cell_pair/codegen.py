"""B1 functors generated from a plain pair body (``repro``'s
``_pair_kernel`` traces any body into its Pallas kernel; this module does
the same for the hand-written CUDA engine, ``csrc/cell_pair_engine.cuh``).

A pair body (the protocol of ``repro_torch.core.interactions``) is traced
with ``torch.fx.experimental.proxy_tensor.make_fx`` on small fake CPU
tensors, once with fp32 operands and once with bf16 operands (the
``bf16x`` evaluation), at the call's ``dim``, prop widths and ``out``
spec. Each traced graph is emitted as one specialization of ``template
<class P> struct GenBody_<hash>``, a functor to the engine's body
interface: every arithmetic result goes through the engine's ``Ops<T>``
for the node's dtype, so a bf16 result is rounded as PyTorch's bf16
elementwise ops round it on the card, and vector props and radial outputs
unroll over DIM. ``ok`` is true for every pair the engine evaluates, so
``where(ok, a, b)`` is ``a``.

The ops taken (aten names): add, sub, rsub, mul, div, neg, abs; clamp,
clamp_min, clamp_max, maximum, minimum; where, eq/ne/lt/le/gt/ge, the
logical and bitwise and/or/xor/not of booleans; exp, log, sqrt, rsqrt,
reciprocal, pow (a tensor exponent or a number); full, full_like,
zeros_like, ones_like, scalar_tensor and other constants; select of one
vector component and sum over the components; ``_to_copy`` between fp32
and bf16, and the view ops that keep a value's components. Any other op
raises :class:`NotImplementedError` naming it, when the body is traced
(on the CPU too), as does Python control flow on a traced value.

The body's numbers (Python floats in the graph, scalars it closes over,
0-d constant tensors) are not in the emitted text: each occurrence is a
slot of the functor's float ``params``, so that a body with other
constants reuses the library. What the card does with them is followed:
a Python divisor is reciprocal-then-multiply (``div_true_kernel_cuda``),
a Python operand of an arithmetic op stays fp32 beside a bf16 tensor, the
bound of a clamp, the other side of a comparison and a filled constant
are rounded to the tensor's dtype, and ``pow``'s exponents 0, 1, 2, 3,
-2, +-0.5 and -1 take ATen's special cases
(``aten/src/ATen/native/cuda/PowKernel.cu``), every other exponent
``powf`` with the exponent rounded to the tensor's dtype.

:func:`generate` returns the body's :class:`Generated` functor: its kind
name, its params, the props it reads (packed in sorted name order) and
the C++ source, which :func:`source_path` writes under
``build/repro_torch/gen/`` (listed in ``.gitignore``) with one
``CELL_PAIR_ENTRY`` per precision: ``f32``, ``bf16x`` and, for a body of
up to three outputs, ``bf16x_<names>`` for every proper subset of them
(``MixedBody``). The library is built from it by ``_build`` at first
launch, keyed by its text and flags.
"""
from __future__ import annotations

import collections
import hashlib
import itertools
import pathlib
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core.interactions import check_out_kind
from repro_torch.kernels import _build

ENGINE = pathlib.Path(__file__).resolve().parent / "csrc" \
    / "cell_pair_engine.cuh"
GEN_DIR = _build.BUILD_DIR / "gen"

#: Bodies of up to this many outputs get a ``bf16x:<names>`` entry for
#: every proper subset of their outputs.
MAX_MIXED_OUTPUTS = 3

#: The pair axis of the traced tensors (any size that is not a DIM).
_N = 7

_DT = {torch.float32: "f32", torch.bfloat16: "bf16", torch.bool: "bool"}
_TYPE = {"f32": "F32", "bf16": "BF16"}


class Generated(NamedTuple):
    """A pair body's generated functor at one dim and prop layout."""

    kind: str                     # "gen_<hash>": the registry key
    dim: int
    out: Tuple[Tuple[str, str], ...]     # sorted (name, "radial"|"scalar")
    props: Tuple[str, ...]        # the props it reads, in packed order
    vector: Tuple[bool, ...]      # per prop: a (dim,) vector or a scalar
    params: Tuple[float, ...]     # the body's numbers, fp32 slots first
    precs: Tuple[str, ...]        # its C entries' precisions
    code: str                     # the functor (both specializations)

    @property
    def width(self) -> int:
        """Floats per particle in the packed props."""
        return sum(self.dim if v else 1 for v in self.vector)

    @property
    def functor(self) -> str:
        """The C++ template's name, ``GenBody_<hash>``."""
        return f"GenBody_{self.kind[4:]}"

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
        entries = []
        for prec in self.precs:
            if prec == "f32":
                body = f"{name}<F32>"
            elif prec == "bf16x":
                body = f"{name}<BF16>"
            else:
                sel = set(prec.split("_")[1:])
                rad = sum(1 << k for k, n in enumerate(radial) if n in sel)
                sca = sum(1 << k for k, n in enumerate(scalar) if n in sel)
                alias = f"Mixed_{prec}"
                lines.append(f"using {alias} = MixedBody<{name}<F32>, "
                             f"{name}<BF16>, {rad}u, {sca}u>;")
                body = alias
            entries.append(f"CELL_PAIR_ENTRY(cell_pair_{self.kind}_{prec}_"
                           f"d{self.dim}, {body}, {self.width})")
        lines += ["", "}  // namespace", "", 'extern "C" {', *entries,
                  "}", ""]
        return "\n".join(lines)


# --------------------------------------------------------------------------
# Tracing
# --------------------------------------------------------------------------

def _trace(body, out, dim: int, props: Dict[str, bool], dtype):
    """The body's aten graph at operand dtype ``dtype``: placeholders dx
    (N, dim), r2 (N,), ok (N,), then wi[k], wj[k] per prop in sorted
    order; outputs the sorted ``out`` values (radial: the magnitude)."""
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

    args = [torch.zeros((_N, dim), dtype=dtype), torch.zeros(_N, dtype=dtype),
            torch.ones(_N, dtype=torch.bool)]
    for k in names:
        shape = (_N, dim) if props[k] else (_N,)
        args += [torch.zeros(shape, dtype=dtype),
                 torch.zeros(shape, dtype=dtype)]
    try:
        return make_fx(torch.func.functionalize(fn),
                       tracing_mode="fake")(*args)
    except GuardOnDataDependentSymNode as e:
        raise NotImplementedError(
            "the pair body branches in Python on a traced value "
            "(data-dependent control flow); write it with torch.where for "
            "the CUDA cell-pair kernel") from e


# --------------------------------------------------------------------------
# Emitting
# --------------------------------------------------------------------------

class _Val(NamedTuple):
    c: List[str]       # C expression per component (1 or DIM)
    dtype: str         # "f32" | "bf16" | "bool"
    ndim: int          # the traced tensor's ndim (0: a 0-d constant)


def _meta(node):
    val = node.meta.get("val")
    if not isinstance(val, torch.Tensor):
        raise NotImplementedError(
            f"{node.target}: a pair body's values must be tensors")
    if val.dtype not in _DT:
        raise NotImplementedError(
            f"{node.target}: dtype {val.dtype} (the CUDA cell-pair kernel's "
            "generated bodies compute in float32, bfloat16 and bool)")
    return val


def _ncomp(shape, dim: int, what) -> int:
    """Components of a traced value: 1 for a per-pair scalar (shapes (),
    (N,), (1,), (N, 1), (1, 1)), DIM for a vector (N, DIM) / (1, DIM)."""
    shape = tuple(shape)
    if len(shape) == 0 or shape in ((_N,), (1,)):
        return 1
    if len(shape) == 2 and shape[0] in (_N, 1) and shape[1] in (1, dim):
        return shape[1]
    raise NotImplementedError(
        f"{what}: a value of shape {shape} (the traced pair axis is {_N}, "
        f"dim {dim}); a body's values are per-pair scalars or (dim,) "
        "vectors")


def _needed(gm) -> set:
    """The graph's nodes that its outputs depend on."""
    need, todo = set(), list(list(gm.graph.nodes)[-1].all_input_nodes)
    while todo:
        nd = todo.pop()
        if nd not in need:
            need.add(nd)
            todo += nd.all_input_nodes
    return need


class _Emitter:
    """One traced graph as the body of one ``GenBody<P>`` specialization."""

    def __init__(self, gm, dim: int, prec: str, props: Dict[str, bool],
                 out, used: set):
        self.gm, self.dim, self.prec = gm, dim, prec
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
        ctype = "bool" if dtype == "bool" else "float"
        self.lines.append(f"    const {ctype} {name} = {expr};")
        return name

    @staticmethod
    def cvt(expr: str, src: str, dst: str) -> str:
        """A value of dtype ``src`` converted to ``dst``."""
        if src == dst or (src == "bf16" and dst == "f32"):
            return expr
        if dst == "bool":
            return f"({expr} != 0.0f)"
        if src == "bool":
            return f"({expr} ? 1.0f : 0.0f)"
        return f"BF16::r({expr})"            # f32 -> bf16

    def rounded_const(self, value, dtype: str) -> str:
        """A number as a value of ``dtype`` (a filled tensor, a clamp
        bound, the other side of a comparison)."""
        if dtype == "bool":
            return "true" if value else "false"
        c = self.const(value)
        return c if dtype == "f32" else f"BF16::r({c})"

    def val(self, a) -> _Val:
        if isinstance(a, torch.fx.Node):
            return self.vals[a]
        raise NotImplementedError(f"unexpected operand {a!r}")

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
                dt = {"f32": torch.float32, "bf16": torch.bfloat16,
                      "bool": torch.bool}[v.dtype]
                args.append(torch.zeros((1,) * v.ndim, dtype=dt))
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
        number is an fp32 param (``opmath``, as an arithmetic op takes it
        on the card) or rounded to ``T`` (``rounded``)."""
        if self.is_num(a):
            e = self.const(a) if scalar_as == "opmath" \
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
                t = getattr(self.gm, nd.target)
                if not isinstance(t, torch.Tensor) or t.dim() != 0 \
                        or t.dtype not in _DT:
                    raise NotImplementedError(
                        f"a tensor the pair body closes over ({nd.target}, "
                        f"shape {tuple(getattr(t, 'shape', ()))}): only 0-d "
                        "float32, bfloat16 or bool constants are taken")
                dt = _DT[t.dtype]
                self.vals[nd] = _Val([self.rounded_const(t.item(), dt)], dt,
                                     0)
                continue
            if nd.op != "call_function":
                raise NotImplementedError(f"graph node {nd.op} {nd.target}")
            self.vals[nd] = self.emit(nd)
        return self.outputs(nodes[-1])

    def load_prop(self, k: str, side: str) -> _Val:
        """Prop ``k`` of one side (``wi_in`` / ``wj_in``) from its packed
        row: the props the body reads, in sorted order."""
        off = sum(self.dim if self.props[name] else 1
                  for name in sorted(self.used) if name < k)
        n = self.dim if self.props[k] else 1
        c = [self.let(self.prec, f"{self.P}::r({side}[{off + d}])")
             for d in range(n)]
        return _Val(c, self.prec, 2 if self.props[k] else 1)

    def emit(self, nd) -> _Val:
        tgt = nd.target
        what = str(tgt)
        packet = getattr(getattr(tgt, "overloadpacket", None), "__name__",
                         None)
        meta = _meta(nd)
        T = _DT[meta.dtype]
        n = _ncomp(meta.shape, self.dim, what)
        args = list(nd.args)
        kw = dict(nd.kwargs)
        ndim = meta.dim()

        def make(comps, dtype=T):
            return _Val([self.let(dtype, e) for e in comps], dtype, ndim)

        O = f"Ops<{_TYPE.get(T, 'F32')}>"
        if packet in ("add", "sub", "mul", "div", "rsub"):
            a, b = args[0], args[1]
            alpha = kw.get("alpha", 1)
            if packet == "rsub":
                a, b = b, a
                packet = "sub"
            if packet == "div" and kw.get("rounding_mode") is not None:
                raise NotImplementedError(f"{what} with rounding_mode "
                                          f"{kw['rounding_mode']!r}")
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
        if packet in ("maximum", "minimum"):
            xa, xb = (self.operand(a, T, n) for a in args[:2])
            return make([f"{O}::{packet}({x}, {y})" for x, y in zip(xa, xb)])
        if packet in ("neg", "abs", "exp", "log", "sqrt", "rsqrt",
                      "reciprocal"):
            fn = {"reciprocal": "recip"}.get(packet, packet)
            return make([f"{O}::{fn}({x})"
                         for x in self.operand(args[0], T, n)])
        if packet in ("clamp", "clamp_min", "clamp_max"):
            x = self.operand(args[0], T, n)
            if packet == "clamp":
                lo = args[1] if len(args) > 1 else kw.get("min")
                hi = args[2] if len(args) > 2 else kw.get("max")
            elif packet == "clamp_min":
                lo, hi = args[1], None
            else:
                lo, hi = None, args[1]
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
        if packet == "pow":
            return self.pow(nd, args, T, n, O, make)
        if packet in ("eq", "ne", "lt", "le", "gt", "ge"):
            op = {"eq": "==", "ne": "!=", "lt": "<", "le": "<=", "gt": ">",
                  "ge": ">="}[packet]
            C = self.common(*args[:2])
            xa = self.operand(args[0], C, n, scalar_as="rounded")
            xb = self.operand(args[1], C, n, scalar_as="rounded")
            return make([f"{x} {op} {y}" for x, y in zip(xa, xb)], "bool")
        if packet in ("logical_and", "logical_or", "logical_xor",
                      "bitwise_and", "bitwise_or", "bitwise_xor"):
            if T != "bool":
                raise NotImplementedError(f"{what} on {T} values (bitwise "
                                          "ops are taken on booleans only)")
            op = {"and": "&&", "or": "||", "xor": "!="}[packet.split("_")[1]]
            xa, xb = (self.operand(a, "bool", n, scalar_as="rounded")
                      for a in args[:2])
            return make([f"({x} {op} {y})" for x, y in zip(xa, xb)], "bool")
        if packet in ("logical_not", "bitwise_not"):
            if packet == "bitwise_not" and self.val(args[0]).dtype != "bool":
                raise NotImplementedError(f"{what} on a non-boolean value")
            return make([f"!{x}" for x in
                         self.operand(args[0], "bool", n)], "bool")
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
            lit = ("true" if one else "false") if T == "bool" \
                else ("1.0f" if one else "0.0f")
            return _Val([lit] * n, T, ndim)
        if packet in ("_to_copy", "clone", "alias", "detach",
                      "lift_fresh_copy", "view", "_unsafe_view", "reshape",
                      "unsqueeze", "squeeze", "expand", "view_copy",
                      "expand_copy", "unsqueeze_copy", "squeeze_copy",
                      "alias_copy", "detach_copy"):
            src = self.val(args[0])
            if len(src.c) not in (1, n):
                raise NotImplementedError(
                    f"{what}: from {len(src.c)} components to {n}")
            comps = src.c * n if len(src.c) == 1 else src.c
            if src.dtype == T:
                return _Val(comps, T, ndim)
            return make([self.cvt(e, src.dtype, T) for e in comps])
        if packet in ("select", "select_copy"):
            src = self.val(args[0])
            src_meta = _meta(args[0])
            axis, idx = args[1], args[2]
            if src_meta.dim() != 2 or axis not in (1, -1):
                raise NotImplementedError(
                    f"{what}: a select of axis {axis} of a value of shape "
                    f"{tuple(src_meta.shape)} (only a vector's component "
                    "axis is taken)")
            comps = src.c if len(src.c) > 1 else src.c * self.dim
            return _Val([comps[idx % len(comps)]], src.dtype, ndim)
        if packet == "sum":
            src_meta = _meta(args[0])
            dims = args[1] if len(args) > 1 else kw.get("dim")
            if tgt._overloadname != "dim_IntList" or src_meta.dim() != 2 \
                    or list(dims or ()) not in ([1], [-1]):
                raise NotImplementedError(
                    f"{what} over {dims} of a value of shape "
                    f"{tuple(src_meta.shape)} (only a sum over a vector's "
                    "components is taken)")
            src = self.val(args[0])
            comps = [self.cvt(e, src.dtype, "f32") for e in src.c]
            acc = comps[0]
            for e in comps[1:]:
                acc = f"__fadd_rn({acc}, {e})"
            return make([f"{O}::cvt({acc})"])
        raise NotImplementedError(
            f"{what} is not an op the CUDA cell-pair kernel's generated "
            "bodies take (codegen.py lists them)")

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
            v = self.vals[nd]
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
                mt = "f32" if v.dtype == "bool" else v.dtype
                m = self.cvt(m, v.dtype, mt)
                for d in range(self.dim):
                    if mt == "bf16" and self.prec == "bf16":
                        term = f"BF16::term({m}, {dx[d]})"
                    elif self.prec == "f32":
                        term = f"F32::term({m}, {dx[d]})"
                    else:
                        term = f"__fmul_rn({m}, {dx[d]})"
                    stmts.append(f"    radial[{k_rad * self.dim + d}] = "
                                 f"{term};")
                k_rad += 1
            else:
                stmts.append(f"    scalar[{k_sca}] = "
                             f"{self.cvt(m, v.dtype, 'f32')};")
                k_sca += 1
        return stmts


def _specialization(gm, dim, prec, props, out, used):
    """(the emitter, after its run: its consts; the operator's lines)."""
    em = _Emitter(gm, dim, prec, props, out, used)
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
             props: Dict[str, bool]) -> Generated:
    """The generated functor of ``body`` at ``dim`` with props ``props``
    ({name: is a (dim,) vector}) and outputs ``out``. Traces the body in
    fp32 and in bf16 and emits both specializations; raises
    NotImplementedError naming an op it does not take. Cached on the body
    (when hashable), ``out``, ``dim`` and ``props``."""
    key = _key(body, out, dim, props)
    if key is not None and key in _CACHE:
        _CACHE.move_to_end(key)
        return _CACHE[key]
    for name, kind in out.items():
        if not name.isidentifier() or kind not in ("radial", "scalar"):
            raise ValueError(f"pair output {name!r}: {kind!r} (a generated "
                             "functor takes identifier names, 'radial' or "
                             "'scalar')")
    gm32 = _trace(body, out, dim, props, torch.float32)
    gm16 = _trace(body, out, dim, props, torch.bfloat16)
    used = _used_props(gm32, props) | _used_props(gm16, props)
    n_rad = sum(k == "radial" for k in out.values())
    n_sca = len(out) - n_rad
    em32, lines32 = _specialization(gm32, dim, "f32", props, out, used)
    em16, lines16 = _specialization(gm16, dim, "bf16", props, out, used)
    names = tuple(sorted(used))
    outs = tuple(sorted(out.items()))
    placeholder = "GenBody"
    code = "\n".join([
        f"// outputs {outs}; props {[(k, props[k]) for k in names]}",
        f"template <class P>\nstruct {placeholder};", "",
        _struct(placeholder, "f32", dim, n_rad, n_sca, 0, em32.consts,
                lines32), "",
        _struct(placeholder, "bf16", dim, n_rad, n_sca, len(em32.consts),
                em16.consts, lines16), ""])
    digest = hashlib.sha256(code.encode()).hexdigest()[:16]
    code = code.replace(placeholder, f"GenBody_{digest}")
    precs = ["f32", "bf16x"]
    if 1 < len(outs) <= MAX_MIXED_OUTPUTS:
        for r in range(1, len(outs)):
            for sel in itertools.combinations([n for n, _ in outs], r):
                precs.append("_".join(["bf16x", *sel]))
    gen = Generated(kind=f"gen_{digest}", dim=dim, out=outs, props=names,
                    vector=tuple(props[k] for k in names),
                    params=tuple(em32.consts + em16.consts),
                    precs=tuple(precs), code=code)
    if key is not None:
        _CACHE[key] = gen
        if len(_CACHE) > _CACHE_SIZE:
            _CACHE.popitem(last=False)
    return gen


def source_file(gen: Generated) -> pathlib.Path:
    """Where ``gen``'s ``.cu`` goes: ``build/repro_torch/gen/``."""
    return GEN_DIR / f"cell_pair_{gen.kind}_d{gen.dim}.cu"


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
