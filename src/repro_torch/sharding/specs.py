"""Logical-axis sharding rules (``repro``'s ``sharding/specs.py``) on the
port's meshes.

Every parameter, cache and activation of the LM carries a tuple of
*logical* axis names; a rule table maps each to a mesh axis (or a tuple
of them, or None: replicated). ``repro`` turns the resulting
``PartitionSpec``s into ``NamedSharding``s and lets GSPMD place the
collectives. The port runs the model SPMD by process on a
``runtime.make_mesh`` mesh (or the dry-run's ``runtime.make_dry_mesh``):
a spec here is a plain tuple, one entry per dimension (a mesh axis name,
a tuple of names, or None), and it says which block of a leaf this rank
holds. The model code places the collectives itself where GSPMD would
(``models/layers.py``, ``models/transformer.py``).

Default layout (``repro``'s):
  batch   → ("pod", "data")   data parallelism across pods and the
                              intra-pod data axis
  heads/mlp/experts/vocab/ssm_heads → "model"   tensor/expert parallelism
  embed   → None              activations replicated along d_model
  kv_seq  → "data"            long-context KV sharding (decode)
  fsdp    → "data"            ZeRO: weights sharded over the data axis,
                              gathered where used
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple, Union

import torch

from repro_torch.core import runtime as RT

Rules = Dict[str, Any]          # logical axis -> mesh axis | tuple | None
#: One entry per dimension: a mesh axis name, a tuple of them, or None.
Spec = Tuple[Union[None, str, Tuple[str, ...]], ...]

DEFAULT_RULES: Rules = {
    "batch": ("pod", "data"),
    "seq": None,
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "vocab": "model",
    "experts": "model",
    "expert_mlp": None,
    "kv_seq": "data",      # sharded KV cache for decode shapes
    "conv": None,
    "ssm_state": None,
    "ssm_heads": "model",
    "fsdp": "data",
    "stack": None,          # the stacked-groups dim: never sharded
}


def mesh_axes(mesh) -> Tuple[str, ...]:
    """The mesh's axis names (a ``DeviceMesh`` or a ``runtime.DryMesh``)."""
    return tuple(mesh.mesh_dim_names)


def mesh_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of the mesh."""
    return {n: int(mesh.size(i)) for i, n in enumerate(mesh_axes(mesh))}


def _filter(axis, mesh):
    """Drop mesh axes the mesh does not have (``pod`` on the single-pod
    mesh)."""
    names = set(mesh_axes(mesh))
    if axis is None:
        return None
    if isinstance(axis, (tuple, list)):
        kept = tuple(a for a in axis if a in names)
        return kept if kept else None
    return axis if axis in names else None


def flat_axes(e) -> Tuple[str, ...]:
    """The mesh axes of one spec entry, as a tuple (empty for None)."""
    if e is None:
        return ()
    return (e,) if isinstance(e, str) else tuple(e)


def spec_for(logical: Tuple[Optional[str], ...], rules: Rules, mesh) -> Spec:
    """The spec of a leaf with these logical axes; a mesh axis appears at
    most once (a later dimension that would reuse one stays None). A
    tuple of one axis is that axis, as ``PartitionSpec`` writes it."""
    parts = []
    used = set()
    for ax in logical:
        m = _filter(rules.get(ax) if ax else None, mesh)
        if m is not None:
            flat = flat_axes(m)
            if any(f in used for f in flat):
                m = None
            else:
                used.update(flat)
                m = flat[0] if len(flat) == 1 else flat
        parts.append(m)
    return tuple(parts)


def legalize_spec(spec: Spec, shape, mesh) -> Spec:
    """Drop mesh axes from dims they do not divide evenly (``repro``: jit
    argument shardings need divisibility; here a rank's block must be a
    whole slice). E.g. mamba2's vocab 50280 does not take the 16-way
    model axis."""
    sizes = mesh_sizes(mesh)
    parts = []
    for d, e in enumerate(spec):
        if e is None or d >= len(shape):
            parts.append(e)
            continue
        prod = math.prod(sizes.get(a, 1) for a in flat_axes(e))
        parts.append(e if shape[d] % prod == 0 else None)
    return tuple(parts)


def fsdp_extend(spec: Spec, shape, logical, mesh, axis: str = "data"
                ) -> Spec:
    """ZeRO/FSDP refinement (``repro``'s ``launch/dryrun._fsdp_extend``):
    shard the largest unsharded dim (never the ``stack`` dim) over
    ``axis`` where it divides, unless the spec already uses ``axis``."""
    if axis not in mesh_axes(mesh):
        return spec
    size = mesh_sizes(mesh)[axis]
    used = {a for e in spec for a in flat_axes(e)}
    if axis in used:
        return spec
    best, best_dim = 0, -1
    for d, (e, n) in enumerate(zip(spec, shape)):
        if e is not None:
            continue
        if logical is not None and d < len(logical) and logical[d] == "stack":
            continue
        if n % size == 0 and n // size > 0 and n > best:
            best, best_dim = n, d
    if best_dim < 0:
        return spec
    parts = list(spec) + [None] * (len(shape) - len(spec))
    parts[best_dim] = axis
    return tuple(parts)


def is_logical(x) -> bool:
    """A logical-axes tuple (a leaf of a logical tree)."""
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def is_spec(x) -> bool:
    """A spec (a leaf of a spec tree): entries None, names or tuples of
    names."""
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, str)
        or (isinstance(e, tuple) and all(isinstance(a, str) for a in e))
        for e in x)


def tree_map2(fn, first, tree, is_leaf=None):
    """``fn(leaf of first, leaf of tree)`` over two trees of nested dicts
    with the same keys; ``first``'s leaves are logical tuples, or specs
    (``is_leaf=is_spec``)."""
    leaf = is_leaf or is_logical
    if leaf(first):
        return fn(first, tree)
    return {k: tree_map2(fn, first[k], tree[k], is_leaf) for k in first}


def tree_shardings(logical_tree, rules: Rules, mesh):
    """Map a tree of logical-axis tuples to a tree of specs."""
    if is_logical(logical_tree):
        return spec_for(logical_tree, rules, mesh)
    return {k: tree_shardings(v, rules, mesh)
            for k, v in logical_tree.items()}


# --------------------------------------------------------------------------
# A rank's block of a leaf
# --------------------------------------------------------------------------

def n_shards(e, mesh) -> int:
    """How many blocks one spec entry cuts its dimension into."""
    sizes = mesh_sizes(mesh)
    return math.prod(sizes[a] for a in flat_axes(e))


def block_index(e) -> int:
    """This rank's block along a dimension with spec entry ``e`` (row-major
    over a tuple of axes, as ``NamedSharding`` orders devices); inside
    ``runtime.on_mesh``."""
    axes = flat_axes(e)
    return RT.axis_index(axes) if axes else 0


def local_shape(shape, spec: Spec, mesh) -> Tuple[int, ...]:
    """The shape of one rank's block of a leaf of ``shape``."""
    out = list(shape)
    for d, e in enumerate(spec):
        if e is not None:
            out[d] //= n_shards(e, mesh)
    return tuple(out)


def local_slices(shape, spec: Spec, mesh) -> Tuple[slice, ...]:
    """This rank's slices of a leaf of ``shape`` (inside
    ``runtime.on_mesh(mesh)``)."""
    out = []
    for d, n in enumerate(shape):
        e = spec[d] if d < len(spec) else None
        if e is None:
            out.append(slice(None))
            continue
        blk = n // n_shards(e, mesh)
        i = block_index(e)
        out.append(slice(i * blk, (i + 1) * blk))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A leaf's spec on a mesh: ``repro``'s ``NamedSharding`` as the port
    needs it (which block a rank holds)."""

    mesh: Any
    spec: Spec

    def local_shape(self, shape) -> Tuple[int, ...]:
        return local_shape(shape, self.spec, self.mesh)

    def slices(self, shape) -> Tuple[slice, ...]:
        with RT.on_mesh(self.mesh):
            return local_slices(shape, self.spec, self.mesh)


def shard_tree(full_tree, logical_tree, ctx, specs=None):
    """Each rank's block of every leaf of ``full_tree`` (full tensors,
    the same on every rank), laid out by ``specs`` (a tree of specs of
    the same shape) or by the rules of ``ctx`` (legalized against each
    leaf's shape). The blocks are copies."""
    mesh = ctx.mesh

    def one(lg, leaf, sp):
        if sp is None:
            sp = legalize_spec(spec_for(lg, ctx.rules_dict, mesh),
                               leaf.shape, mesh)
        return leaf[local_slices(leaf.shape, sp, mesh)].clone()

    def walk(lg, tree, sp):
        if is_logical(lg):
            return one(lg, tree, sp)
        return {k: walk(lg[k], tree[k], None if sp is None else sp[k])
                for k in lg}

    with RT.on_mesh(mesh):
        return walk(logical_tree, full_tree, specs)


def gather_block(x: torch.Tensor, spec: Spec) -> torch.Tensor:
    """The whole leaf from every rank's block ``x`` of it (an
    ``all_gather`` along each sharded dimension; inside
    ``runtime.on_mesh``)."""
    for d, e in enumerate(spec):
        if e is not None:
            x = RT.all_gather(x, flat_axes(e), axis=d, tiled=True)
    return x


# --------------------------------------------------------------------------
# The context the model code reads
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardingContext:
    """Mesh + rules (``repro``'s), and whether weights are FSDP-sharded
    over ``data``. ``repro``'s ``cons`` pins a sharding for GSPMD; here
    the model code already runs on local blocks, so :meth:`cons` only
    checks a block's shape against the rules."""

    mesh: Any
    rules: Tuple[Tuple[str, Any], ...]  # hashable form
    fsdp: bool = False

    @staticmethod
    def create(mesh, rules: Rules | None = None, *,
               fsdp: bool = False) -> "ShardingContext":
        r = dict(DEFAULT_RULES)
        if rules:
            r.update(rules)
        return ShardingContext(mesh=mesh, rules=tuple(sorted(
            r.items(), key=lambda kv: kv[0])), fsdp=bool(fsdp))

    @property
    def rules_dict(self) -> Rules:
        return dict(self.rules)

    @property
    def sizes(self) -> Dict[str, int]:
        return mesh_sizes(self.mesh)

    def spec(self, logical, shape=None) -> Spec:
        """The spec of ``logical``, legalized against ``shape`` if given."""
        sp = spec_for(tuple(logical), self.rules_dict, self.mesh)
        return sp if shape is None else legalize_spec(sp, shape, self.mesh)

    def sharding(self, logical, shape=None) -> Sharding:
        """The :class:`Sharding` of a leaf with these logical axes (its
        block's shape and this rank's slices)."""
        return Sharding(self.mesh, self.spec(logical, shape))

    def cons(self, x, logical, shape=None):
        """``x`` itself, after checking that it is this rank's block of a
        leaf of ``shape`` (when given) laid out by the rules."""
        if shape is not None:
            want = self.sharding(logical, shape).local_shape(shape)
            if tuple(x.shape) != want:
                raise ValueError(f"block {tuple(x.shape)} of {logical} is "
                                 f"not {want} (the rules' block of "
                                 f"{tuple(shape)})")
        return x

    def axis(self, logical_name: str, size: Optional[int] = None):
        """The mesh axes (a name, a tuple, or None) that shard a dimension
        of this logical axis, and of ``size`` when given (dropped where
        they do not divide it)."""
        return self.spec((logical_name,),
                         None if size is None else (size,))[0]

    def n_shards(self, e) -> int:
        return n_shards(e, self.mesh) if e is not None else 1

    def batch_axes(self) -> Tuple[str, ...]:
        """The mesh axes the batch is split over."""
        return flat_axes(self.axis("batch"))

    def active(self):
        """``runtime.on_mesh(self.mesh)``: resolve axis names on the mesh."""
        return RT.on_mesh(self.mesh)
