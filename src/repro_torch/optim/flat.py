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

Only the unsharded layout (``shards=1``) and the unweighted, fault-free
reductions are ported so far, exact or compressed (:class:`CompressCfg`:
bf16 or per-tile int8 quantization, per-tile top-k with per-client error
feedback); the fused launches take no participation mask yet.

In-place updates: :func:`client_mean_masked` writes each reduced run back
into the buffers it is given (the engine always passes buffers it has just
allocated), which keeps one copy of the buffers alive instead of two.  The
error-feedback buffers it is given belong to the caller's state, so it
writes their updates into copies.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Sequence

import torch

from repro_torch.core.tree_util import tree_flatten, tree_map
from repro_torch.kernels.storm.kernel import (BLOCK, momsgd3_step, sgd3_step,
                                              storm3_step, storm3_update)
from repro_torch.kernels.storm.quantpack import (quantpack_flat,
                                                 quantunpack_flat)


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
    m = x.to(torch.float32).sum(dim=0, keepdim=True) * _inv(x.shape[0],
                                                            x.device)
    return m.to(x.dtype).expand_as(x)


def _inv(m: int, device) -> torch.Tensor:
    return torch.tensor(1.0 / m, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# Compressed communication
# ---------------------------------------------------------------------------

class CompressCfg(NamedTuple):
    """Compressed-reduction policy of :func:`client_mean_masked` (the
    substrate half of ``repro_torch.federation.compression.CompressionSpec``,
    lowered by ``sequences.make_engine``).

    ``quant``: ``None`` | ``"bf16"`` | ``"int8"`` — what each client's send
    is rounded through: a bf16 cast, or symmetric per-tile int8 with one f32
    scale per ``block`` elements (the ``quantpack``/``quantunpack`` kernels).
    ``topk_frac``: every client keeps the ``ceil(topk_frac · block)``
    largest-magnitude entries of each tile of (row + error feedback).
    ``error_feedback``: carry the dropped mass per client in f32 buffers
    shaped like the communicated ones (``FlatState.ef``) and add it back
    into the next send; active only with ``topk_frac > 0``.
    ``sections``: section names to compress; () compresses every
    communicated run."""
    quant: str | None = None
    topk_frac: float = 0.0
    error_feedback: bool = True
    sections: tuple = ()

    @property
    def has_ef(self) -> bool:
        return self.topk_frac > 0 and self.error_feedback


def _topk_tiles(x, block: int, frac: float):
    """Per-tile top-k of f32 ``x`` [..., L]: keep the entries of each
    ``block``-sized tile whose magnitude reaches the tile's k-th largest
    (k = ceil(frac · block)), zero the rest.  The threshold is an element
    value, so ties keep more than k entries, as the reference's
    ``lax.top_k`` threshold does; a zero tile keeps its zeros."""
    t = x.reshape(x.shape[:-1] + (-1, block))
    k = max(1, math.ceil(frac * block))
    mag = t.abs()
    thr = torch.topk(mag, k, dim=-1, sorted=False).values.amin(-1, keepdim=True)
    keep = mag >= thr
    del mag, thr
    return torch.where(keep, t, 0.0).reshape(x.shape)


def _compressed_mean(seg, eseg, ccfg: CompressCfg, block: int):
    """Compressed client mean of one run [M, L]: every client sends its
    compressed (row + EF), the mean of the sends is broadcast back, and the
    residual ``(row + EF) − send`` becomes the client's new EF (None without
    ``eseg``).  Returns ``(mean row f32 [1, L], new EF f32 [M, L] | None)``.

    The arithmetic is the reference's as the TPU runs it: the int8 send is
    what its ``quantunpack_flat`` kernel writes (one rounded f32 product per
    element), and the mean sums the f32 sends from 0 in client order, then
    multiplies by ``f32(1/M)``.  Under ``jit`` on the CPU, where no kernel
    stands between them, XLA fuses the product into the sum and the
    residual as multiply-adds instead."""
    m = seg.shape[0]
    acc = seg.to(torch.float32)
    if eseg is not None:
        acc = acc + eseg
    sent = _topk_tiles(acc, block, ccfg.topk_frac) if ccfg.topk_frac > 0 \
        else acc
    if ccfg.quant == "int8":
        q, s = quantpack_flat(sent.reshape(-1), block=block)
        sent = quantunpack_flat(q, s, block=block).reshape(acc.shape)
        del q, s
    elif ccfg.quant == "bf16":
        sent = sent.to(torch.bfloat16).to(torch.float32)
    total = torch.zeros(seg.shape[1:], dtype=torch.float32, device=seg.device)
    for i in range(m):
        total += sent[i]
    new_e = None if eseg is None else acc.sub_(sent)
    return (total * _inv(m, seg.device))[None], new_e


def _section_runs(grp: _Group, modes, comp_of_sec=None):
    """[mode, start, stop, compressed] element runs covering the buffer;
    adjacent runs merge when the mode and the compression flag coincide
    (``"none"`` runs merge whatever the flag: private tiles are never
    reduced), so there is one reduction per communicated run."""
    runs: list = []
    for s, a, b in grp.extents:
        mode = modes[int(s)]
        comp = bool(comp_of_sec[int(s)]) if comp_of_sec else False
        if runs and runs[-1][0] == mode and runs[-1][2] == a and (
                mode == "none" or runs[-1][3] == comp):
            runs[-1][2] = b
        else:
            runs.append([mode, a, b, comp])
    return runs


def client_mean_masked(spec: FlatSpec, bufs, modes, *, compress=None,
                       ef=None):
    """Section-masked client communication over flat [M, N] buffers, in
    place: every ``"mean"`` run is replaced by its client mean, ``"none"``
    (private) runs are not touched.  Returns ``bufs``.

    ``compress``: a :class:`CompressCfg`; the runs of the sections it names
    (every communicated one when ``sections`` is empty) take the compressed
    mean of :func:`_compressed_mean`, whole-run, and the call returns
    ``(bufs, ef)``: the updated per-client error-feedback buffers, one f32
    [M, N] buffer per dtype group (pass the current ones as ``ef=``), or
    ``()`` when ``compress.has_ef`` is false.  Participation weights,
    faults, robust aggregators, the grouped mean and sharding are not
    ported yet."""
    n_sections = max(len(spec.sections), 1)
    if len(modes) != n_sections:
        raise ValueError(f"modes {modes} do not match sections {spec.sections}")
    if any(m not in ("none", "mean") for m in modes):
        raise NotImplementedError(
            f"modes {modes}: only 'none' and 'mean' are ported; the grouped "
            f"(hierarchical) mean waits for ROADMAP queue 1, item "
            f"'Participation, staleness and cadence'")
    comp_of_sec = None
    if compress is not None:
        names = spec.sections if spec.sections else ("",)
        comp_of_sec = tuple(not compress.sections or nm in compress.sections
                            for nm in names)
    has_ef = compress is not None and compress.has_ef
    if has_ef and len(ef or ()) != len(spec.groups):
        raise ValueError("compression with error feedback needs one f32 EF "
                         "buffer per dtype group (pass ef=)")
    ef_out = []
    for gi, (grp, buf) in enumerate(zip(spec.groups, bufs)):
        if buf.dim() < 2:
            raise ValueError("client_mean_masked needs a leading client axis")
        ebuf = ef[gi].clone() if has_ef else None
        for mode, start, stop, comp in _section_runs(grp, modes, comp_of_sec):
            if mode == "none":
                continue
            seg = buf[..., start:stop]
            if not comp:
                seg.copy_(_bcast_mean(seg))
                continue
            eseg = None if ebuf is None else ebuf[..., start:stop]
            mean, new_e = _compressed_mean(seg, eseg, compress, grp.block)
            seg.copy_(mean.expand_as(seg))
            if new_e is not None:
                eseg.copy_(new_e)
        ef_out.append(ebuf)
    if compress is None:
        return bufs
    return bufs, (tuple(ef_out) if has_ef else ())
