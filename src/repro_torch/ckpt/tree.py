"""Nested state trees in the reference's leaf order.

A checkpoint is written leaf by leaf, and its manifest refers to leaves
by index, so the port must number them as ``jax.tree.flatten`` does for
checkpoints to read across the two packages: dict children in sorted key
order, list and tuple (namedtuple) children in order, ``None`` an empty
node, anything else a leaf.  ``torch.utils._pytree`` keeps a dict's
insertion order instead, hence this module.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Tuple


@dataclasses.dataclass(frozen=True)
class TreeDef:
    """The structure of a tree with its leaves taken out."""

    kind: str                 # "leaf" | "none" | "dict" | "list" | "tuple"
    node_type: Any = None     # the tuple subclass of a namedtuple node
    keys: tuple = ()
    children: tuple = ()

    def __str__(self) -> str:
        if self.kind == "leaf":
            return "*"
        if self.kind == "none":
            return "None"
        if self.kind == "dict":
            return "{" + ", ".join(f"{k!r}: {c}" for k, c in
                                   zip(self.keys, self.children)) + "}"
        inner = ", ".join(str(c) for c in self.children)
        if self.kind == "list":
            return f"[{inner}]"
        if self.node_type is not None:
            return f"{self.node_type.__name__}({inner})"
        return f"({inner}{',' if len(self.children) == 1 else ''})"


_END = object()


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


def tree_flatten(tree: Any, is_leaf: Callable[[Any], bool] = None
                 ) -> Tuple[List[Any], TreeDef]:
    """(leaves in the reference's order, structure).  ``is_leaf`` names
    nodes to keep whole as leaves (``jax.tree.flatten``'s argument)."""
    leaves: list = []

    def walk(node) -> TreeDef:
        if is_leaf is not None and is_leaf(node):
            leaves.append(node)
            return TreeDef("leaf")
        if node is None:
            return TreeDef("none")
        if isinstance(node, dict):
            keys = tuple(sorted(node))
            return TreeDef("dict", keys=keys,
                           children=tuple(walk(node[k]) for k in keys))
        if isinstance(node, (list, tuple)):
            kind = "list" if isinstance(node, list) else "tuple"
            ntype = type(node) if _is_namedtuple(node) else None
            return TreeDef(kind, node_type=ntype,
                           children=tuple(walk(c) for c in node))
        leaves.append(node)
        return TreeDef("leaf")

    try:
        treedef = walk(tree)
    finally:
        # ``walk`` refers to itself through its closure: emptying its cell
        # breaks that cycle, so the leaves are not kept alive until the
        # cyclic garbage collector runs (a served model's weights, say)
        del walk
    return leaves, treedef


def tree_unflatten(treedef: TreeDef, leaves) -> Any:
    """Rebuild a tree of ``treedef``'s structure from ``leaves``."""
    it = iter(leaves)

    def build(td: TreeDef):
        if td.kind == "leaf":
            return next(it)
        if td.kind == "none":
            return None
        kids = [build(c) for c in td.children]
        if td.kind == "dict":
            return dict(zip(td.keys, kids))
        if td.kind == "list":
            return kids
        if td.node_type is not None:
            return td.node_type(*kids)
        return tuple(kids)

    try:
        out = build(treedef)
    except StopIteration:
        raise ValueError("fewer leaves than the tree structure holds") \
            from None
    finally:
        del build                # the self-reference, as in tree_flatten
    if next(it, _END) is not _END:
        raise ValueError("more leaves than the tree structure holds")
    return out


def tree_leaves(tree: Any, is_leaf: Callable[[Any], bool] = None) -> list:
    return tree_flatten(tree, is_leaf)[0]


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """``tree`` with ``fn`` applied to every leaf."""
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [fn(x) for x in leaves])
