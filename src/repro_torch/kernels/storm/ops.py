"""The fused STORM update over pytrees: the port of
``repro/kernels/storm/ops.py:storm_update``, step for step.

Leaves are flattened in ``jax.tree.flatten`` order (``core/tree_util``:
sorted dict keys), grouped by ``(p.dtype, m.dtype)`` in the order each pair
is first seen, and each group is concatenated once and updated by one call
of :func:`kernel.storm_update_flat`; the leaves come back as views of its
outputs.  The gradients are cast to the group's momentum dtype first (with
bf16 momentum they are rounded to bf16), as the reference casts them.  The
reference pads each group to its 65,536-element tile; the kernel takes any
length, so nothing is padded.

Like the reference, this re-flattens on every call: fine for one-off
updates and tests, while the training loops keep their state flat
(``optim/flat.py``).
"""
from __future__ import annotations

import torch

from repro_torch.core.tree_util import tree_flatten
from repro_torch.kernels.storm.kernel import storm_update_flat


def _cat(leaves, dtype=None):
    flat = [t.reshape(-1) if dtype is None else t.reshape(-1).to(dtype)
            for t in leaves]
    return flat[0] if len(flat) == 1 else torch.cat(flat)


def _split(buf, like):
    out, off = [], 0
    for t in like:
        out.append(buf[off:off + t.numel()].view(t.shape))
        off += t.numel()
    return out


def storm_update(params, mom, g_new, g_old, lr, decay):
    """``p' = p − lr·m`` and ``m' = g_new + decay·(m − g_old)`` over pytrees
    (``mom``, ``g_new`` and ``g_old`` follow the structure of ``params``).
    Returns ``(params', mom')`` with the structure of ``params``, ``p'`` in
    each leaf's dtype and ``m'`` in its momentum's."""
    p_leaves, treedef = tree_flatten(params)
    m_leaves, gn_leaves, go_leaves = (treedef.flatten_up_to(t)
                                      for t in (mom, g_new, g_old))
    for i, p in enumerate(p_leaves):
        shapes = {tuple(t[i].shape) for t in (m_leaves, gn_leaves, go_leaves)}
        if shapes != {tuple(p.shape)}:
            raise ValueError(f"storm_update: leaf {i} has shape "
                             f"{tuple(p.shape)} in params but {sorted(shapes)} "
                             f"in mom / g_new / g_old")

    groups = {}
    for i, (p, m) in enumerate(zip(p_leaves, m_leaves)):
        groups.setdefault((p.dtype, m.dtype), []).append(i)

    p_out = [None] * len(p_leaves)
    m_out = [None] * len(m_leaves)
    for (_, m_dtype), idxs in groups.items():
        ps = [p_leaves[i] for i in idxs]
        pn, mn = storm_update_flat(
            _cat(ps), _cat([m_leaves[i] for i in idxs]),
            _cat([gn_leaves[i] for i in idxs], m_dtype),
            _cat([go_leaves[i] for i in idxs], m_dtype), lr, decay)
        for i, a, b in zip(idxs, _split(pn, ps), _split(mn, ps)):
            p_out[i], m_out[i] = a, b
    return treedef.unflatten(p_out), treedef.unflatten(m_out)
