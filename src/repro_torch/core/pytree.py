"""Pytrees as the reference's `jax.tree_util` walks them, without JAX.

`compress_pytree` names every leaf by its path and batches the float
leaves in flattening order, so the order decides which fields share a
decision batch (and so, at the ulp level, their float32 windows). This
module flattens exactly as `jax.tree_util.tree_flatten_with_path` does for
the containers it knows:

* ``dict``: keys sorted, each a `DictKey` (an ``OrderedDict`` keeps its
  insertion order);
* ``list`` and ``tuple``: positions, each a `SequenceKey`;
* namedtuples: fields in declaration order, each a `GetAttrKey`, whose
  name reads ``.field``;
* ``None``: an empty node, no leaf.

Everything else is a leaf: arrays, tensors, Python scalars. For example
``{'z': 1.0, 'a': [x, (y, None)], 'm': NT(b=u, a=v)}`` has the leaves
``a/0, a/1/0, m/.b, m/.a, z`` (names joined as the reference's
`_leaf_name` joins them). `torch.utils._pytree` keeps dict insertion order
instead, which is why the port carries its own walk.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Any


@dataclass(frozen=True)
class DictKey:
    key: Any


@dataclass(frozen=True)
class SequenceKey:
    idx: int


@dataclass(frozen=True)
class GetAttrKey:
    name: str

    def __str__(self) -> str:
        return f".{self.name}"


@dataclass(frozen=True)
class TreeDef:
    """The structure of a flattened tree: a node's type, its keys (dict
    keys or namedtuple fields) and its children's structures; a leaf is
    ``TreeDef(None)``."""

    kind: Any
    keys: tuple = ()
    children: tuple = ()


_LEAF = TreeDef(None)


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


def _children(node):
    """(key objects, children) of a container node, or None for a leaf."""
    if node is None:
        return (), ()
    t = type(node)
    if t is dict:
        keys = sorted(node)
        return [DictKey(k) for k in keys], [node[k] for k in keys]
    if t is OrderedDict:
        return [DictKey(k) for k in node], list(node.values())
    if _is_namedtuple(node):
        return [GetAttrKey(f) for f in node._fields], list(node)
    if t in (list, tuple):
        return [SequenceKey(i) for i in range(len(node))], list(node)
    return None


def flatten_with_path(tree) -> tuple[list[tuple[tuple, Any]], TreeDef]:
    """[(path, leaf)] in the reference's order, and the tree's structure."""
    leaves: list[tuple[tuple, Any]] = []

    def walk(node, path) -> TreeDef:
        found = _children(node)
        if found is None:
            leaves.append((path, node))
            return _LEAF
        keys, kids = found
        defs = tuple(walk(kid, path + (key,)) for key, kid in zip(keys, kids))
        names = tuple(getattr(k, "key", getattr(k, "name", None)) for k in keys)
        return TreeDef(type(node), names, defs)

    treedef = walk(tree, ())
    return leaves, treedef


def unflatten(treedef: TreeDef, leaves) -> Any:
    """Rebuild a tree of `treedef`'s structure from its leaves in order."""
    it = iter(leaves)

    def build(td: TreeDef):
        if td.kind is None:
            return next(it)
        kids = [build(c) for c in td.children]
        if td.kind is type(None):
            return None
        if td.kind in (dict, OrderedDict):
            return td.kind(zip(td.keys, kids))
        if issubclass(td.kind, tuple) and hasattr(td.kind, "_fields"):
            return td.kind(*kids)
        return td.kind(kids)

    out = build(treedef)
    if next(it, _LEAF) is not _LEAF:
        raise ValueError("unflatten: more leaves than the structure holds")
    return out


def flatten_up_to(treedef: TreeDef, tree) -> list:
    """The subtrees of `tree` at the leaf positions of `treedef` (whose
    structure `tree` extends), in order: `jax.tree_util`'s
    ``treedef.flatten_up_to``. A None there is a value, not an empty node."""
    out: list = []

    def walk(td: TreeDef, node) -> None:
        if td.kind is None:
            out.append(node)
            return
        found = _children(node)
        if found is None or len(found[1]) != len(td.children):
            raise ValueError(f"flatten_up_to: {type(node).__name__} does not match {td.kind}")
        for child, kid in zip(td.children, found[1]):
            walk(child, kid)

    walk(treedef, tree)
    return out


def leaves(tree) -> list:
    """The leaves of `tree` in the reference's order."""
    return [leaf for _, leaf in flatten_with_path(tree)[0]]


def tree_map(fn, tree) -> Any:
    """`tree` with `fn` applied to every leaf, its structure kept."""
    found, treedef = flatten_with_path(tree)
    return unflatten(treedef, [fn(leaf) for _, leaf in found])


def leaf_name(path) -> str:
    """The reference's leaf name: path entries joined by '/', each its dict
    key, its position, or ``.field``."""
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
