"""Pytree helpers over nested dicts / lists / tuples of tensors.

Leaf order matches ``jax.tree.flatten``: dict entries are visited in
**sorted key order**, lists and tuples in position order.  The flat-buffer
layout (``repro_torch.optim.flat.make_spec``) is built from this order, so
keeping it identical to the JAX package is what makes the port's buffers
agree with the reference element for element.  (``torch.utils._pytree``
keeps dict insertion order and would not.)
"""
from __future__ import annotations

from typing import Any, Callable, List, NamedTuple

import torch


class TreeDef(NamedTuple):
    """Structure of a flattened tree: ``kind`` is "leaf", "dict", "list" or
    "tuple"; ``keys`` the sorted dict keys; ``children`` the sub-structures."""
    kind: str
    keys: tuple = ()
    children: tuple = ()

    def unflatten(self, leaves):
        it = iter(leaves)
        out = self._build(it)
        if next(it, None) is not None:
            raise ValueError("too many leaves for this tree structure")
        return out

    def _build(self, it):
        if self.kind == "leaf":
            return next(it)
        kids = [c._build(it) for c in self.children]
        if self.kind == "dict":
            return dict(zip(self.keys, kids))
        return list(kids) if self.kind == "list" else tuple(kids)

    def flatten_up_to(self, tree) -> List[Any]:
        """Leaves of ``tree`` at this structure's leaf positions (a leaf
        position may hold any object, e.g. a batched tensor)."""
        out: List[Any] = []
        self._collect(tree, out)
        return out

    def _collect(self, tree, out):
        if self.kind == "leaf":
            out.append(tree)
            return
        if self.kind == "dict":
            if sorted(tree) != list(self.keys):
                raise ValueError(f"dict keys {sorted(tree)} != {list(self.keys)}")
            for k, c in zip(self.keys, self.children):
                c._collect(tree[k], out)
            return
        if len(tree) != len(self.children):
            raise ValueError("sequence length differs from the structure")
        for t, c in zip(tree, self.children):
            c._collect(t, out)


def tree_structure(tree) -> TreeDef:
    if isinstance(tree, dict):
        keys = tuple(sorted(tree))
        return TreeDef("dict", keys, tuple(tree_structure(tree[k]) for k in keys))
    if isinstance(tree, (list, tuple)):
        kind = "list" if isinstance(tree, list) else "tuple"
        return TreeDef(kind, (), tuple(tree_structure(t) for t in tree))
    return TreeDef("leaf")


def tree_flatten(tree):
    """(leaves, TreeDef) in ``jax.tree.flatten`` order."""
    treedef = tree_structure(tree)
    return treedef.flatten_up_to(tree), treedef


def tree_leaves(tree) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree, *rest):
    leaves, treedef = tree_flatten(tree)
    others = [treedef.flatten_up_to(r) for r in rest]
    return treedef.unflatten([fn(*xs) for xs in zip(leaves, *others)])


def tree_sub(a, b):
    return tree_map(torch.sub, a, b)


def tree_scale(s, a):
    return tree_map(lambda x: s * x, a)


def tree_axpy(s, a, b):
    """b + s * a"""
    return tree_map(lambda x, y: y + s * x, a, b)


def tree_zeros_like(a):
    return tree_map(torch.zeros_like, a)


def tree_stack(trees):
    """List of same-structure trees → one tree with a new leading axis."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def client_slice(tree, m: int):
    return tree_map(lambda x: x[m], tree)
