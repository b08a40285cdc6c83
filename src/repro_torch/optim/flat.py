"""Flat-buffer optimizer substrate (counterpart of ``repro/optim/flat.py``).

The (x, y, u) trees and their momenta are flattened once at init into
contiguous per-dtype buffers; every step then runs one fused kernel launch
per buffer (STORM, plain SGD or heavy-ball SGD) and one section-masked client
mean.  The layout is the JAX package's, element for element:

* leaves are grouped by dtype (groups ordered by first appearance in
  section order), one 1-D buffer per dtype;
* within a buffer, leaves are ordered by **section** and each section is
  zero-padded to a multiple of the tile ``block``, so every tile belongs to
  exactly one section (``_Group.section_ids`` maps tile → section, and the
  per-section (lr, decay) scalars become per-tile tables for the kernel);
* buffers may carry a leading client axis (``batch_dims=1`` → [M, N]).

Only the unsharded layout (``shards=1``) and the unweighted, fault-free,
uncompressed reductions are ported so far; the fused launches take no
participation mask yet.

In-place updates: :func:`client_mean_masked` writes each reduced run back
into the buffers it is given (the engine always passes buffers it has just
allocated), which keeps one copy of the buffers alive instead of two.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Sequence

import torch

from repro_torch.core.tree_util import tree_flatten, tree_map
from repro_torch.kernels.storm.kernel import (BLOCK, momsgd3_step, sgd3_step,
                                              storm3_step, storm3_update)


class _Leaf(NamedTuple):
    index: int          # position in the spec treedef's leaf order
    shape: tuple        # leaf shape without batch dims
    size: int
    offset: int         # element offset inside the buffer


class _Group(NamedTuple):
    dtype: Any                  # torch dtype of the buffer
    leaves: tuple               # of _Leaf, ascending offset
    padded: int                 # buffer length, a multiple of block
    block: int
    section_ids: torch.Tensor   # [padded // block] int64, tile → section
    extents: tuple = ()         # ((section, start_elem, stop_elem), ...)


class FlatSpec(NamedTuple):
    treedef: Any
    num_leaves: int
    sections: tuple
    groups: tuple


def _round_up(n: int, block: int) -> int:
    return n + (-n) % block


def make_spec(tree, *, sections: Sequence[str] | None = None,
              block: int = BLOCK) -> FlatSpec:
    """Flat layout of ``tree`` (leaves need ``.shape`` and ``.dtype``; meta
    tensors will do).  ``sections``: top-level keys of ``tree`` whose
    subtrees occupy contiguous tile-aligned runs of each dtype buffer, in
    this order.  The layout is the reference's unsharded one
    (``shards=1``)."""
    leaves, treedef = tree_flatten(tree)
    if sections is None:
        sec_names: tuple = ()
        sec_of_leaf = [0] * len(leaves)
        n_sections = 1
    else:
        sec_names = tuple(sections)
        labels = {k: tree_map(lambda _, s=i: s, tree[k])
                  for i, k in enumerate(sec_names)}
        sec_of_leaf = tree_flatten(labels)[0]
        if len(sec_of_leaf) != len(leaves):
            raise ValueError("sections must cover the tree")
        n_sections = len(sec_names)

    order = sorted(range(len(leaves)), key=lambda i: (sec_of_leaf[i], i))
    dtypes: list = []
    for i in order:
        if leaves[i].dtype not in dtypes:
            dtypes.append(leaves[i].dtype)

    groups = []
    for dt in dtypes:
        lfs, offset = [], 0
        pattern: list = []
        extents: list = []
        for s in range(n_sections):
            start = offset
            for i in order:
                if sec_of_leaf[i] != s or leaves[i].dtype != dt:
                    continue
                shape = tuple(leaves[i].shape)
                size = 1
                for d in shape:
                    size *= int(d)
                lfs.append(_Leaf(i, shape, size, offset))
                offset += size
            if offset > start:
                offset = _round_up(offset, block)
                k = (offset - start) // block
                a = extents[-1][2] if extents else 0
                extents.append((s, a, a + k * block))
                pattern += [s] * k
        if lfs:
            groups.append(_Group(dt, tuple(lfs), offset, block,
                                 torch.tensor(pattern, dtype=torch.int64),
                                 tuple(extents)))
    return FlatSpec(treedef, len(leaves), sec_names, tuple(groups))


def flatten_tree(spec: FlatSpec, tree, *, batch_dims: int = 0, dtype=None):
    """Pack ``tree`` into the spec's flat buffers (one per dtype group).
    Leaves may carry ``batch_dims`` shared leading axes; ``dtype`` overrides
    every buffer's dtype (momenta and gradients live in f32 buffers)."""
    leaves = spec.treedef.flatten_up_to(tree)
    bufs = []
    for grp in spec.groups:
        out_dt = dtype if dtype is not None else grp.dtype
        first = leaves[grp.leaves[0].index]
        batch_shape = tuple(first.shape[:batch_dims])
        dev = first.device
        parts, cursor = [], 0
        for lf in grp.leaves:
            if lf.offset > cursor:
                parts.append(torch.zeros(batch_shape + (lf.offset - cursor,),
                                         dtype=out_dt, device=dev))
            parts.append(leaves[lf.index].to(out_dt).reshape(batch_shape + (-1,)))
            cursor = lf.offset + lf.size
        if cursor < grp.padded:
            parts.append(torch.zeros(batch_shape + (grp.padded - cursor,),
                                     dtype=out_dt, device=dev))
        bufs.append(parts[0].contiguous() if len(parts) == 1
                    else torch.cat(parts, dim=-1))
    return tuple(bufs)


def unflatten_tree(spec: FlatSpec, bufs):
    """Pytree view of flat buffers: slices and reshapes only, so the leaves
    are views into the buffers."""
    leaves: list = [None] * spec.num_leaves
    for grp, buf in zip(spec.groups, bufs):
        batch_shape = tuple(buf.shape[:-1])
        for lf in grp.leaves:
            seg = buf[..., lf.offset:lf.offset + lf.size]
            leaves[lf.index] = seg.reshape(batch_shape + lf.shape)
    return spec.treedef.unflatten(leaves)


def zeros_buffers(spec: FlatSpec, *, batch_shape: tuple = (), device=None):
    return tuple(torch.zeros(batch_shape + (g.padded,), dtype=g.dtype,
                             device=device) for g in spec.groups)


# ---------------------------------------------------------------------------
# Per-tile hyper-parameter tables and fused launches
# ---------------------------------------------------------------------------

def _tile_table(grp: _Group, buf, table):
    """Per-section scalars → the flat per-tile table of ``buf`` ([reps·T]
    f32, client-major like the flattened buffer), on the buffer's device.
    The scalars are f32 tensors; the table is gathered on the CPU and copied
    to the device once."""
    reps = 1
    for d in buf.shape[:-1]:
        reps *= int(d)
    row = torch.stack([torch.as_tensor(v, dtype=torch.float32)
                       for v in table])[grp.section_ids]
    return row.repeat(reps).to(buf.device)


def _launch(kern, grp: _Group, bufs, tables, n_out: int):
    """One kernel launch on one dtype buffer, flattened client-major; the
    kernel returns ``n_out`` flat outputs (a bare tensor when 1)."""
    shape = bufs[0].shape
    outs = kern(*[b.reshape(-1) for b in bufs], *tables, block=grp.block)
    outs = outs if n_out > 1 else (outs,)
    return tuple(o.reshape(shape) for o in outs)


def storm_partial_step(spec: FlatSpec, var_bufs, mom_bufs, g_old_bufs,
                       lrs, decays):
    """One fused ``storm3_step`` launch per dtype buffer:

        v_new  = v − lr_sec·m            (variable step, entering momentum)
        m_part = decay_sec·(m − g_old)   (partial STORM momentum)

    ``lrs``/``decays``: one f32 scalar per section."""
    out_v, out_m = [], []
    for grp, v, m, go in zip(spec.groups, var_bufs, mom_bufs, g_old_bufs):
        vn, mn = _launch(storm3_step, grp, (v, m, go),
                         (_tile_table(grp, v, lrs), _tile_table(grp, v, decays)),
                         2)
        out_v.append(vn)
        out_m.append(mn)
    return tuple(out_v), tuple(out_m)


def storm_full_update(spec: FlatSpec, var_bufs, mom_bufs, g_new_bufs,
                      g_old_bufs, lrs, decays):
    """One fused ``storm3_update`` launch per dtype buffer:
    (v − lr·m, g_new + decay·(m − g_old))."""
    out_v, out_m = [], []
    for grp, v, m, gn, go in zip(spec.groups, var_bufs, mom_bufs,
                                 g_new_bufs, g_old_bufs):
        vn, mn = _launch(storm3_update, grp, (v, m, gn, go),
                         (_tile_table(grp, v, lrs), _tile_table(grp, v, decays)),
                         2)
        out_v.append(vn)
        out_m.append(mn)
    return tuple(out_v), tuple(out_m)


def momentum_sgd_step(spec: FlatSpec, var_bufs, mom_bufs, g_bufs, lrs, betas):
    """One fused ``momsgd3_step`` launch per dtype buffer:

        m_new = β_sec·m + g        (momentum update, FedAvg's order)
        v_new = v − lr_sec·m_new   (variable step, updated momentum)

    ``lrs``/``betas``: one f32 scalar per section."""
    out_v, out_m = [], []
    for grp, v, m, gb in zip(spec.groups, var_bufs, mom_bufs, g_bufs):
        vn, mn = _launch(momsgd3_step, grp, (v, m, gb),
                         (_tile_table(grp, v, lrs), _tile_table(grp, v, betas)),
                         2)
        out_v.append(vn)
        out_m.append(mn)
    return tuple(out_v), tuple(out_m)


def sgd_step(spec: FlatSpec, var_bufs, g_bufs, lrs):
    """One fused ``sgd3_step`` launch per dtype buffer: v_new = v − lr_sec·g,
    for the specs that carry no momentum (no momentum stream is read or
    written)."""
    return tuple(_launch(sgd3_step, grp, (v, gb), (_tile_table(grp, v, lrs),),
                         1)[0]
                 for grp, v, gb in zip(spec.groups, var_bufs, g_bufs))


def buffers_add(a, b):
    """Elementwise a + b over buffer tuples (the STORM correction add)."""
    return tuple(x + y for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# Section-masked communication
# ---------------------------------------------------------------------------

def _bcast_mean(x):
    """Client mean over the leading axis, broadcast back, with the
    reference's arithmetic: summed in f32 (``jnp.mean`` upcasts bf16), then
    multiplied by the f32 reciprocal of M (XLA turns the division by the
    constant M into that product), then cast to the buffer dtype."""
    inv = torch.tensor(1.0 / x.shape[0], dtype=torch.float32, device=x.device)
    m = x.to(torch.float32).sum(dim=0, keepdim=True) * inv
    return m.to(x.dtype).expand_as(x)


def _section_runs(grp: _Group, modes):
    """[mode, start, stop] element runs covering the buffer, adjacent runs
    of the same mode merged (one reduction per communicated run)."""
    runs: list = []
    for s, a, b in grp.extents:
        mode = modes[int(s)]
        if runs and runs[-1][0] == mode and runs[-1][2] == a:
            runs[-1][2] = b
        else:
            runs.append([mode, a, b])
    return runs


def client_mean_masked(spec: FlatSpec, bufs, modes):
    """Section-masked client communication over flat [M, N] buffers, in
    place: every ``"mean"`` run is replaced by its client mean, ``"none"``
    (private) runs are not touched.  Returns ``bufs``.  Participation
    weights, faults, robust aggregators, compression and sharding are not
    ported yet."""
    n_sections = max(len(spec.sections), 1)
    if len(modes) != n_sections:
        raise ValueError(f"modes {modes} do not match sections {spec.sections}")
    if any(m not in ("none", "mean") for m in modes):
        raise NotImplementedError(
            f"modes {modes}: only 'none' and 'mean' are ported; the grouped "
            f"(hierarchical) mean waits for ROADMAP queue 1, item "
            f"'Participation, staleness and cadence'")
    for grp, buf in zip(spec.groups, bufs):
        if buf.dim() < 2:
            raise ValueError("client_mean_masked needs a leading client axis")
        for mode, start, stop in _section_runs(grp, modes):
            if mode == "mean":
                seg = buf[..., start:stop]
                seg.copy_(_bcast_mean(seg))
    return bufs
