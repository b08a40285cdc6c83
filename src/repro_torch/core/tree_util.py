"""Pytree helpers over nested dicts / lists / tuples of tensors.

Leaf order matches ``jax.tree.flatten``: dict entries are visited in
**sorted key order**, lists, tuples and NamedTuples in position order (a
NamedTuple unflattens to its own class).  The flat-buffer
layout (``repro_torch.optim.flat.make_spec``) is built from this order, so
keeping it identical to the JAX package is what makes the port's buffers
agree with the reference element for element.  (``torch.utils._pytree``
keeps dict insertion order and would not.)
"""
from __future__ import annotations

from typing import Any, Callable, List, NamedTuple

import torch


class TreeDef(NamedTuple):
    """Structure of a flattened tree: ``kind`` is "leaf", "dict", "list",
    "tuple" or "namedtuple"; ``keys`` the sorted dict keys or the
    NamedTuple's fields; ``children`` the sub-structures; ``cls`` the
    NamedTuple's class."""
    kind: str
    keys: tuple = ()
    children: tuple = ()
    cls: Any = None

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
        if self.kind == "namedtuple":
            return self.cls(*kids)
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

    def paths(self, prefix: str = "") -> List[str]:
        """Each leaf's path as ``jax.tree_util.keystr`` writes it:
        ``['key']`` for a dict entry, ``[i]`` for a list or tuple position,
        ``.field`` for a NamedTuple field."""
        if self.kind == "leaf":
            return [prefix]
        if self.kind == "dict":
            steps = [f"[{k!r}]" for k in self.keys]
        elif self.kind == "namedtuple":
            steps = [f".{f}" for f in self.keys]
        else:
            steps = [f"[{i}]" for i in range(len(self.children))]
        return [p for s, c in zip(steps, self.children)
                for p in c.paths(prefix + s)]

    def __str__(self) -> str:
        """The structure as ``str(jax.tree_util.tree_structure(...))``
        prints it."""
        return f"PyTreeDef({self._str()})"

    def _str(self) -> str:
        kids = [c._str() for c in self.children]
        if self.kind == "leaf":
            return "*"
        if self.kind == "dict":
            return "{" + ", ".join(f"{k!r}: {c}" for k, c in
                                   zip(self.keys, kids)) + "}"
        if self.kind == "list":
            return "[" + ", ".join(kids) + "]"
        if self.kind == "namedtuple":
            return (f"CustomNode(namedtuple[{self.cls.__name__}], "
                    f"[{', '.join(kids)}])")
        return "(" + ", ".join(kids) + (",)" if len(kids) == 1 else ")")


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(type(tree), "_fields")


def tree_structure(tree) -> TreeDef:
    if isinstance(tree, dict):
        keys = tuple(sorted(tree))
        return TreeDef("dict", keys, tuple(tree_structure(tree[k]) for k in keys))
    if _is_namedtuple(tree):
        return TreeDef("namedtuple", tuple(tree._fields),
                       tuple(tree_structure(t) for t in tree), type(tree))
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


def tree_add(a, b):
    return tree_map(torch.add, a, b)


def tree_sub(a, b):
    return tree_map(torch.sub, a, b)


def tree_scale(s, a):
    return tree_map(lambda x: s * x, a)


def tree_axpy(s, a, b):
    """b + s * a"""
    return tree_map(lambda x, y: y + s * x, a, b)


def tree_vdot(a, b):
    """Σ over leaves of the f32 dot products, accumulated from an f32 zero
    in leaf order."""
    parts = tree_leaves(tree_map(
        lambda x, y: torch.vdot(x.reshape(-1).to(torch.float32),
                                y.reshape(-1).to(torch.float32)), a, b))
    return sum(parts, torch.zeros((), dtype=torch.float32,
                                  device=parts[0].device if parts else None))


def tree_sqnorm(a):
    return tree_vdot(a, a)


def tree_zeros_like(a):
    return tree_map(torch.zeros_like, a)


def tree_randn_like(key, a, scale=1.0):
    """Standard normal leaves shaped as ``a``'s, one key of ``split(key)``
    per leaf in leaf order (``repro_torch.random``)."""
    from repro_torch import random as jr
    leaves, treedef = tree_flatten(a)
    keys = jr.split(key, len(leaves))
    return treedef.unflatten([scale * jr.normal(k, tuple(x.shape), x.dtype)
                              .to(x.device) for k, x in zip(keys, leaves)])


def tree_size(a) -> int:
    return sum(x.numel() for x in tree_leaves(a))


def client_mean(tree):
    """Average over the leading client axis and broadcast back: the
    communication round.  With the reference's arithmetic: summed in f32
    (``jnp.mean`` upcasts bf16), multiplied by the f32 reciprocal of M (XLA
    turns the division by the constant M into that product), cast to the
    leaf's dtype."""
    def one(x):
        inv = torch.tensor(1.0 / x.shape[0], dtype=torch.float32,
                           device=x.device)
        m = x.to(torch.float32).sum(dim=0, keepdim=True) * inv
        return m.to(x.dtype).expand_as(x)

    return tree_map(one, tree)


def _over_rows(fn, x):
    """``fn`` of the [M, L] rows of leaf ``x`` [M, ...], shaped back."""
    return fn(x.reshape(x.shape[0], -1)).reshape(x.shape)


def client_mean_grouped(tree, num_groups: int):
    """Average within ``num_groups`` contiguous client groups (the pods of
    the hierarchical multi-pod schedule) and broadcast back in each."""
    from repro_torch.optim.flat import _bcast_mean_grouped
    return tree_map(lambda x: _over_rows(
        lambda r: _bcast_mean_grouped(r, num_groups), x), tree)


def client_mean_weighted(tree, w):
    """Participation-weighted client mean: over the participants only (w =
    0: a non-participant), whose rows it replaces; a non-participant's
    rows pass through bit for bit.  The flat substrate's arithmetic
    (``optim.flat._bcast_mean`` and its ``_weight_col``) leaf by leaf."""
    from repro_torch.optim.flat import _bcast_mean
    return tree_map(lambda x: _over_rows(lambda r: _bcast_mean(r, w), x),
                    tree)


def client_mean_grouped_weighted(tree, num_groups: int, w):
    """Participation-weighted pod-local mean (:func:`client_mean_grouped`
    over each group's participants); a group without participants keeps
    its rows."""
    from repro_torch.optim.flat import _bcast_mean_grouped
    return tree_map(lambda x: _over_rows(
        lambda r: _bcast_mean_grouped(r, num_groups, w), x), tree)


def tree_stack(trees):
    """List of same-structure trees → one tree with a new leading axis."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def client_slice(tree, m: int):
    return tree_map(lambda x: x[m], tree)
