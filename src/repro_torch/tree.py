"""A small pytree flattener for the port's containers (dicts, lists,
tuples and dataclasses of tensors or arrays).

``repro`` flattens with ``jax.tree_util``; the checkpoint format and the
fleet engine need the same walk here. Key paths are rendered as
``jax.tree_util.keystr`` renders them, so the trees the two packages share
name their leaves alike: a dict flattens in sorted key order as
``['x']``, ``['props']['v']``; a list or tuple as ``[0]``; a dataclass
field as ``.name``. ``None`` is an empty subtree. Anything else is a
leaf.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, NamedTuple, Tuple


class TreeDef(NamedTuple):
    """The structure of a flattened tree: ``kind`` is ``"leaf"``,
    ``"none"``, ``"dict"``, ``"list"``, ``"tuple"`` or ``"dataclass"``;
    ``meta`` the keys (dict), the type (dataclass) or None; ``children``
    the subtrees' TreeDefs."""

    kind: str
    meta: Any
    children: Tuple["TreeDef", ...]

    def __str__(self) -> str:
        if self.kind == "leaf":
            return "*"
        if self.kind == "none":
            return "None"
        inner = ", ".join(str(c) for c in self.children)
        if self.kind == "dict":
            return "{" + ", ".join(f"{k!r}: {c}" for k, c in
                                   zip(self.meta, self.children)) + "}"
        if self.kind == "list":
            return f"[{inner}]"
        if self.kind == "tuple":
            return f"({inner})"
        return f"{self.meta.__name__}({inner})"


def _field_names(x):
    return [f.name for f in dataclasses.fields(x)]


def _children(x):
    """(kind, meta, [(key string, child)]) of one node."""
    if x is None:
        return "none", None, []
    if isinstance(x, dict):
        keys = tuple(sorted(x))
        return "dict", keys, [(f"[{k!r}]", x[k]) for k in keys]
    if isinstance(x, (list, tuple)):
        kind = "list" if isinstance(x, list) else "tuple"
        return kind, None, [(f"[{i}]", c) for i, c in enumerate(x)]
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return "dataclass", type(x), [(f".{k}", getattr(x, k))
                                       for k in _field_names(x)]
    return "leaf", None, None


def flatten_with_path(tree) -> Tuple[List[Tuple[str, Any]], TreeDef]:
    """``([(keystr, leaf), ...], treedef)`` in ``jax.tree_util`` order."""
    out: List[Tuple[str, Any]] = []

    def walk(x, path):
        kind, meta, kids = _children(x)
        if kind == "leaf":
            out.append((path, x))
            return TreeDef("leaf", None, ())
        return TreeDef(kind, meta, tuple(walk(c, path + k)
                                         for k, c in kids))

    treedef = walk(tree, "")
    return out, treedef


def flatten(tree) -> Tuple[List[Any], TreeDef]:
    """``(leaves, treedef)``."""
    pairs, treedef = flatten_with_path(tree)
    return [leaf for _, leaf in pairs], treedef


def unflatten(treedef: TreeDef, leaves) -> Any:
    """The tree of structure ``treedef`` holding ``leaves`` in order."""
    it = iter(leaves)

    def build(d: TreeDef):
        if d.kind == "leaf":
            return next(it)
        if d.kind == "none":
            return None
        kids = [build(c) for c in d.children]
        if d.kind == "dict":
            return dict(zip(d.meta, kids))
        if d.kind == "list":
            return kids
        if d.kind == "tuple":
            return tuple(kids)
        return d.meta(**dict(zip(_field_names(d.meta), kids)))

    out = build(treedef)
    rest = sum(1 for _ in it)
    if rest:
        raise ValueError(f"{rest} leaves left over for {treedef}")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` (and of ``rest``, which must
    have the same structure)."""
    leaves, treedef = flatten(tree)
    others = []
    for r in rest:
        lv, d = flatten(r)
        if d != treedef:
            raise ValueError(f"tree structures differ: {treedef} vs {d}")
        others.append(lv)
    return unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])
