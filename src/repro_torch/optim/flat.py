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

The means run over all clients or over contiguous client groups (the
hierarchical schedule's pod-local ``"group"`` runs), unweighted or weighted
by participation (``weights=``, one tensor or one per section); compressed
means of both kinds, also weighted (:class:`CompressCfg`: bf16 or per-tile
int8 quantization, per-tile top-k with per-client error feedback, which a
grouped run does not take); and the guarded reductions of the fault layer
(``corrupt=``, ``robust=``: :class:`RobustCfg`, :func:`_robust_mean_into`).
The fused launches take a participation ``mask=``, which gates their tile
tables (:func:`_gate`).

Mesh sharding (``shards`` / :class:`ShardCtx`): ``make_spec(...,
shards=k)`` pads every section to a multiple of ``block · k`` and lays the
buffer out **shard-major**, as the reference does: chunk j of the k
contiguous chunks holds the j-th ``1/k`` slice of every section, in
section order, so every chunk carries the same tile-aligned section pattern
(``_Group.extents`` describes one chunk; ``section_ids`` is that pattern
tiled k times).  On a ``[data, model]`` mesh of ``torch.distributed`` ranks
(``repro_torch.launch.mesh``), rank ``(i, j)`` holds the block of client
rows ``i`` and column chunk ``j`` of every [M, N] buffer
(``sharding.rules``).  With ``shard=`` each fused launch runs the same
kernel on the rank's local [M/d, N/k] block with the chunk's tile tables,
and no collective; :func:`client_mean_masked` sums each communicated run's
local rows and all-reduces the partial sums over the data axis (or its
reduce-scatter + all-gather under ``ShardCtx.use_scatter``, a pod's ranks
for a grouped run), the compressed runs in the wire dtype
(:func:`_wire_allreduce`).  Private and non-participant tiles never enter a
collective.  ``shards=1`` is the unsharded layout bit for bit.

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
import torch.distributed as dist

from repro_torch.core.tree_util import client_mean, tree_flatten, tree_map
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
    padded: int                 # buffer length, a multiple of block·shards
    block: int
    section_ids: torch.Tensor   # [padded // block] int64, tile → section
    extents: tuple = ()         # ((section, start_elem, stop_elem), ...) of
    #   ONE shard chunk, covering [0, padded // shards)


class FlatSpec(NamedTuple):
    treedef: Any
    num_leaves: int
    sections: tuple
    groups: tuple
    shards: int = 1             # model-axis chunks of the layout


class ShardCtx(NamedTuple):
    """How the flat substrate is partitioned over a mesh of ranks
    (``repro_torch.launch.mesh.Mesh``): the client axis M over
    ``data_axis``, the packed parameter axis N over ``model_axis`` (whose
    size must equal ``FlatSpec.shards``).  ``use_scatter`` lowers each
    participant mean to a reduce-scatter + all-gather over the data axis
    instead of one all-reduce."""
    mesh: Any
    data_axis: str = "data"
    model_axis: str = "model"
    use_scatter: bool = False

    @property
    def data_size(self) -> int:
        return self.mesh.shape[self.data_axis]

    @property
    def model_size(self) -> int:
        return self.mesh.shape[self.model_axis]

    @property
    def data_index(self) -> int:
        return self.mesh.coords[self.data_axis]

    @property
    def model_index(self) -> int:
        return self.mesh.coords[self.model_axis]

    @property
    def data_group(self):
        return self.mesh.group(self.data_axis)

    @property
    def model_group(self):
        return self.mesh.group(self.model_axis)

    def rows(self, m: int) -> slice:
        """This rank's rows of an [M, ...] operand."""
        per = m // self.data_size
        return slice(self.data_index * per, (self.data_index + 1) * per)

    def local_rows(self, v):
        """This rank's rows of a per-client [M] operand (None passes)."""
        return None if v is None else v[self.rows(v.shape[0])]


def make_shard_ctx(mesh, *, data_axis: str = "data",
                   model_axis: str = "model",
                   use_scatter: bool = False) -> ShardCtx:
    axes = dict(mesh.shape)
    for a in (data_axis, model_axis):
        if a not in axes:
            raise ValueError(f"mesh axes {tuple(axes)} carry no {a!r} axis")
    return ShardCtx(mesh, data_axis, model_axis, use_scatter)


def _round_up(n: int, block: int) -> int:
    return n + (-n) % block


def make_spec(tree, *, sections: Sequence[str] | None = None,
              block: int = BLOCK, shards: int = 1) -> FlatSpec:
    """Flat layout of ``tree`` (leaves need ``.shape`` and ``.dtype``; meta
    tensors will do).  ``sections``: top-level keys of ``tree`` whose
    subtrees occupy contiguous tile-aligned runs of each dtype buffer, in
    this order.  ``shards``: model-axis chunks; every section is padded to
    a multiple of ``block · shards`` and the buffer is shard-major (see the
    module docstring).  The layout is the reference's, element for
    element."""
    if shards < 1:
        raise ValueError(f"shards={shards} must be >= 1")
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

    quantum = block * shards
    groups = []
    for dt in dtypes:
        lfs, offset = [], 0
        pattern: list = []      # one chunk's tile → section
        extents: list = []      # one chunk's (section, start, stop)
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
                offset = _round_up(offset, quantum)
                k = (offset - start) // quantum    # tiles per chunk
                a = extents[-1][2] if extents else 0
                extents.append((s, a, a + k * block))
                pattern += [s] * k
        if lfs:
            groups.append(_Group(dt, tuple(lfs), offset, block,
                                 torch.tensor(pattern, dtype=torch.int64)
                                 .repeat(shards), tuple(extents)))
    return FlatSpec(treedef, len(leaves), sec_names, tuple(groups), shards)


def _pieces(spec: FlatSpec, grp: _Group, lf: _Leaf) -> list:
    """Where leaf ``lf`` lies in the shard-major buffer: ``(start in the
    leaf, start in the buffer, length)`` pieces.  A leaf's offset is in the
    section-contiguous order; a section of per-chunk width w occupies w
    columns of every chunk, so a leaf splits at the chunk boundaries."""
    if spec.shards == 1:
        return [(0, lf.offset, lf.size)]
    chunk = grp.padded // spec.shards
    cont = 0
    for _, a, b in grp.extents:
        w = b - a
        if lf.offset < cont + w * spec.shards:
            break
        cont += w * spec.shards
    out, p, end = [], lf.offset, lf.offset + lf.size
    while p < end:
        c, r = divmod(p - cont, w)
        n = min(w - r, end - p)
        out.append((p - lf.offset, c * chunk + a + r, n))
        p += n
    return out


def flatten_tree(spec: FlatSpec, tree, *, batch_dims: int = 0, dtype=None,
                 chunk: int | None = None):
    """Pack ``tree`` into the spec's flat buffers (one per dtype group).
    Leaves may carry ``batch_dims`` shared leading axes; ``dtype`` overrides
    every buffer's dtype (momenta and gradients live in f32 buffers).
    ``chunk=j`` packs only model chunk j of every buffer (``padded //
    shards`` columns): a rank's block, without the whole buffer."""
    leaves = spec.treedef.flatten_up_to(tree)
    bufs = []
    for grp in spec.groups:
        out_dt = dtype if dtype is not None else grp.dtype
        first = leaves[grp.leaves[0].index]
        batch_shape = tuple(first.shape[:batch_dims])
        if spec.shards == 1 and chunk is None:
            # each leaf is copied (and converted) straight into its slice,
            # so the buffer is the only copy made
            buf = torch.empty(batch_shape + (grp.padded,), dtype=out_dt,
                              device=first.device)
            cursor = 0
            for lf in grp.leaves:
                buf[..., cursor:lf.offset].zero_()
                buf[..., lf.offset:lf.offset + lf.size].copy_(
                    leaves[lf.index].reshape(batch_shape + (-1,)))
                cursor = lf.offset + lf.size
            buf[..., cursor:].zero_()
            bufs.append(buf)
            continue
        width = grp.padded // spec.shards
        lo, hi = ((0, grp.padded) if chunk is None
                  else (chunk * width, (chunk + 1) * width))
        buf = torch.zeros(batch_shape + (hi - lo,), dtype=out_dt,
                          device=first.device)
        for lf in grp.leaves:
            src = leaves[lf.index].reshape(batch_shape + (-1,))
            for s0, d0, n in _pieces(spec, grp, lf):
                if lo <= d0 < hi:
                    buf[..., d0 - lo:d0 - lo + n].copy_(src[..., s0:s0 + n])
        bufs.append(buf)
    return tuple(bufs)


def unflatten_tree(spec: FlatSpec, bufs):
    """Pytree view of flat buffers (whole buffers, not a rank's block):
    slices and reshapes only under ``shards=1``, so the leaves are views
    into the buffers; a shard-major leaf that spans chunks is copied
    together."""
    leaves: list = [None] * spec.num_leaves
    for grp, buf in zip(spec.groups, bufs):
        if buf.shape[-1] != grp.padded:
            raise ValueError(f"a buffer of {buf.shape[-1]} columns for a "
                             f"layout of {grp.padded}: gather a rank's "
                             f"block first (sharding.rules.gather_state)")
        batch_shape = tuple(buf.shape[:-1])
        for lf in grp.leaves:
            parts = [buf[..., d0:d0 + n]
                     for _, d0, n in _pieces(spec, grp, lf)]
            seg = (parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)
                   if parts else buf[..., :0])
            leaves[lf.index] = seg.reshape(batch_shape + lf.shape)
    return spec.treedef.unflatten(leaves)


def zeros_buffers(spec: FlatSpec, *, batch_shape: tuple = (), device=None):
    return tuple(torch.zeros(batch_shape + (g.padded,), dtype=g.dtype,
                             device=device) for g in spec.groups)


def _check_shard(spec: FlatSpec, shard: ShardCtx, buf):
    """A rank's block of one dtype buffer against the spec and the mesh:
    the reference's checks, in its words."""
    if buf.dim() != 2:
        raise ValueError("the sharded substrate needs [M, N] buffers "
                         "(batch_dims=1)")
    if spec.shards != shard.model_size:
        raise ValueError(
            f"spec was built for shards={spec.shards} but the mesh "
            f"{shard.model_axis} axis has size {shard.model_size}; rebuild "
            f"the spec with make_spec(..., shards={shard.model_size})")


def _check_rows(shard: ShardCtx, m: int):
    if m % shard.data_size:
        raise ValueError(
            f"client axis M={m} is not divisible by the mesh "
            f"{shard.data_axis} axis size {shard.data_size}")


def local_blocks(spec: FlatSpec, bufs, shard: ShardCtx) -> tuple:
    """This rank's blocks (its client rows, its model chunk) of whole
    [M, N] buffers, as contiguous tensors of their own."""
    out = []
    for grp, buf in zip(spec.groups, bufs):
        _check_shard(spec, shard, buf)
        _check_rows(shard, buf.shape[0])
        width = grp.padded // spec.shards
        j = shard.model_index
        out.append(buf[shard.rows(buf.shape[0]),
                       j * width:(j + 1) * width].contiguous())
    return tuple(out)


def _check_blocks(spec: FlatSpec, shard: ShardCtx, bufs):
    """Rank-local blocks: [M/d, padded // shards] each."""
    for grp, buf in zip(spec.groups, bufs):
        _check_shard(spec, shard, buf)
        width = grp.padded // spec.shards
        if buf.shape[1] != width:
            raise ValueError(
                f"a rank's block has {buf.shape[1]} columns, but one model "
                f"chunk of the {grp.dtype} buffer holds {width}: pass the "
                f"rank's block (flat.local_blocks), not the whole buffer")


# ---------------------------------------------------------------------------
# Per-tile hyper-parameter tables and fused launches
# ---------------------------------------------------------------------------

def _tile_table(grp: _Group, buf, table):
    """Per-section scalars → the per-tile table of ``buf``, [reps, T] f32 on
    the CPU (``reps`` the product of the leading dims: client-major like the
    flattened buffer).  The tiles are the buffer's own: a rank's block of
    one model chunk takes the chunk's pattern, the first ``T`` entries of
    ``section_ids``, which every chunk repeats."""
    reps = 1
    for d in buf.shape[:-1]:
        reps *= int(d)
    ids = grp.section_ids[:buf.shape[-1] // grp.block]
    row = torch.stack([torch.as_tensor(v, dtype=torch.float32)
                       for v in table])[ids]
    return row.expand(reps, -1)


def _gate(lr_tiles, decay_tiles, mask, frozen_decay: float):
    """Gate per-tile (lr, decay|β) tables [M, T] with the participation mask
    [M]: non-participants get lr = 0 and decay pinned to ``frozen_decay``
    (1.0 freezes STORM and heavy-ball momenta bit for bit once their oracle
    contributions are zeroed by :func:`mask_buffers`)."""
    if mask is None:
        return lr_tiles, decay_tiles
    if tuple(mask.shape) != (lr_tiles.shape[0],):
        raise ValueError(f"mask of shape {tuple(mask.shape)} for "
                         f"{lr_tiles.shape[0]} clients")
    col = mask.to(device=lr_tiles.device, dtype=torch.float32)[:, None]
    lr_tiles = lr_tiles * col
    if decay_tiles is not None:
        decay_tiles = torch.where(col > 0, decay_tiles, float(frozen_decay))
    return lr_tiles, decay_tiles


def _on_device(buf, *tables):
    """Tables as the flat [reps·T] tensors a launch takes, copied to the
    buffer's device once."""
    return tuple(t.reshape(-1).to(buf.device) for t in tables)


def mask_buffers(bufs, mask):
    """Zero non-participant rows of [M, N] buffers in place and return them
    (the "oracle skipped" half of the freeze: every client computes, but a
    non-participant's gradients must not reach its momentum).  A fill, not
    a multiply: participants pass through bit for bit, and a non-finite
    gradient of a skipped client still comes out zero (0 · inf would be
    NaN)."""
    if mask is None:
        return bufs
    for b in bufs:
        drop = (mask.to(b.device) <= 0).reshape((-1,) + (1,) * (b.dim() - 1))
        b.masked_fill_(drop, 0)
    return bufs


def _launch(kern, grp: _Group, bufs, tables, n_out: int):
    """One kernel launch on one dtype buffer (or a rank's block of it),
    flattened client-major; the kernel returns ``n_out`` flat outputs (a
    bare tensor when 1).  Under a mesh each rank launches on its own block:
    the launch has no collective."""
    shape = bufs[0].shape
    outs = kern(*[b.reshape(-1) for b in bufs], *tables, block=grp.block)
    outs = outs if n_out > 1 else (outs,)
    return tuple(o.reshape(shape) for o in outs)


def _shard_mask(spec: FlatSpec, shard, bufs, mask):
    """With ``shard``: check the rank's blocks and take its rows of the
    [M] launch mask; without, the mask as it is."""
    if shard is None:
        return mask
    _check_blocks(spec, shard, bufs)
    return shard.local_rows(mask)


def storm_partial_step(spec: FlatSpec, var_bufs, mom_bufs, g_old_bufs,
                       lrs, decays, *, mask=None, shard=None):
    """One fused ``storm3_step`` launch per dtype buffer:

        v_new  = v − lr_sec·m            (variable step, entering momentum)
        m_part = decay_sec·(m − g_old)   (partial STORM momentum)

    ``lrs``/``decays``: one f32 scalar per section.  ``mask``: optional
    participation mask [M]: non-participants' tiles run with lr = 0 and
    decay = 1, so (with ``g_old`` zeroed by :func:`mask_buffers`) their rows
    come out of the same launch bit for bit as they went in.  ``shard``: a
    :class:`ShardCtx`; the buffers are then the rank's blocks and ``mask``
    stays the whole [M] mask."""
    mask = _shard_mask(spec, shard, var_bufs, mask)
    out_v, out_m = [], []
    for grp, v, m, go in zip(spec.groups, var_bufs, mom_bufs, g_old_bufs):
        tables = _gate(_tile_table(grp, v, lrs), _tile_table(grp, v, decays),
                       mask, 1.0)
        vn, mn = _launch(storm3_step, grp, (v, m, go), _on_device(v, *tables),
                         2)
        out_v.append(vn)
        out_m.append(mn)
    return tuple(out_v), tuple(out_m)


def storm_full_update(spec: FlatSpec, var_bufs, mom_bufs, g_new_bufs,
                      g_old_bufs, lrs, decays, *, shard=None):
    """One fused ``storm3_update`` launch per dtype buffer:
    (v − lr·m, g_new + decay·(m − g_old)).  ``shard``: as in
    :func:`storm_partial_step`."""
    _shard_mask(spec, shard, var_bufs, None)
    out_v, out_m = [], []
    for grp, v, m, gn, go in zip(spec.groups, var_bufs, mom_bufs,
                                 g_new_bufs, g_old_bufs):
        vn, mn = _launch(storm3_update, grp, (v, m, gn, go),
                         _on_device(v, _tile_table(grp, v, lrs),
                                    _tile_table(grp, v, decays)), 2)
        out_v.append(vn)
        out_m.append(mn)
    return tuple(out_v), tuple(out_m)


def momentum_sgd_step(spec: FlatSpec, var_bufs, mom_bufs, g_bufs, lrs, betas,
                      *, mask=None, shard=None):
    """One fused ``momsgd3_step`` launch per dtype buffer:

        m_new = β_sec·m + g        (momentum update, FedAvg's order)
        v_new = v − lr_sec·m_new   (variable step, updated momentum)

    ``lrs``/``betas``: one f32 scalar per section.  ``mask``: as in
    :func:`storm_partial_step` (lr = 0, β = 1 for non-participants, whose
    ``g`` :func:`mask_buffers` zeroes).  ``shard``: as there."""
    mask = _shard_mask(spec, shard, var_bufs, mask)
    out_v, out_m = [], []
    for grp, v, m, gb in zip(spec.groups, var_bufs, mom_bufs, g_bufs):
        tables = _gate(_tile_table(grp, v, lrs), _tile_table(grp, v, betas),
                       mask, 1.0)
        vn, mn = _launch(momsgd3_step, grp, (v, m, gb),
                         _on_device(v, *tables), 2)
        out_v.append(vn)
        out_m.append(mn)
    return tuple(out_v), tuple(out_m)


def sgd_step(spec: FlatSpec, var_bufs, g_bufs, lrs, *, mask=None,
             shard=None):
    """One fused ``sgd3_step`` launch per dtype buffer: v_new = v − lr_sec·g,
    for the specs that carry no momentum (no momentum stream is read or
    written).  ``mask``: non-participants' tiles run with lr = 0.
    ``shard``: as in :func:`storm_partial_step`."""
    mask = _shard_mask(spec, shard, var_bufs, mask)
    out = []
    for grp, v, gb in zip(spec.groups, var_bufs, g_bufs):
        lr_t, _ = _gate(_tile_table(grp, v, lrs), None, mask, 1.0)
        out.append(_launch(sgd3_step, grp, (v, gb), _on_device(v, lr_t),
                           1)[0])
    return tuple(out)


def buffers_add(a, b):
    """Elementwise a + b over buffer tuples (the STORM correction add), in
    place into ``a``, which must be buffers of the step's own (a kernel's
    fresh outputs): the sum then takes no third buffer."""
    return tuple(x.add_(y) for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# Section-masked communication
# ---------------------------------------------------------------------------

_CHUNK = 1 << 22     # columns per pass of the weighted mean's f64 temporaries


def _weight_col(x, w):
    """Per-client weights [M] → the column ``col = w · (M / Σw)`` in the
    dtype of ``x`` (as an f32 tensor on ``w``'s device), rescaled so that
    the plain mean of ``x · col`` is the weighted mean Σ w_m x_m / Σ w; an
    empty group (Σw = 0) scales to 0.  Σw is summed in client order, as the
    compiled reference sums."""
    wsum = torch.zeros((), dtype=torch.float32, device=w.device)
    for v in w.to(torch.float32):
        wsum = wsum + v
    scale = torch.where(wsum > 0, w.shape[-1] / wsum, 0.0)
    return (w * scale).to(x.dtype).to(torch.float32)


def _bcast_mean(x, w=None):
    """Client mean of one buffer run over the leading axis, broadcast back.

    Without ``w``: ``tree_util.client_mean``'s arithmetic.  With
    participation weights ``w`` [M] (zero = non-participant): the mean is
    over participants only, and non-participant rows pass through bit for
    bit (:func:`_weighted_mean_into`).  All-ones weights give ``col = 1``
    and the unweighted mean bit for bit."""
    if w is None:
        return client_mean(x)
    out = x.clone()
    _weighted_mean_into(out, x, w)
    return out


def _weighted_mean_into(dst, src, w):
    """Write the participants' weighted mean of the rows of ``src`` [n, L]
    into the participants' rows of ``dst`` (same shape; ``dst`` may be
    ``src``), cast to ``dst``'s dtype; a row of weight 0 is not written.
    The arithmetic is the compiled reference's ``mean(src · col)``
    (:func:`_weight_col`, ``col`` in ``src``'s dtype): XLA fuses the
    product into the reduction, so each client adds ``src_m · col_m`` to
    the f32 sum with one rounding, a fused multiply-add, in client order
    (taken here in f64, where the product of two f32 values is exact, and
    rounded to f32 once: that rounds twice only where the f64 sum falls
    exactly half-way between two f32 values); then the sum is multiplied
    by ``f32(1/n)``.  In column chunks, so that the f64 temporaries stay
    small."""
    n = src.shape[0]
    col = _weight_col(src, w)
    keep = (col > 0).to(dst.device).reshape(n, 1)
    c = col.to(device=src.device, dtype=torch.float64)
    inv = _inv(n, src.device)
    flat_src, flat_dst = src.reshape(n, -1), dst.reshape(n, -1)
    for a in range(0, flat_src.shape[1], _CHUNK):
        mean = (_weighted_sum(flat_src[:, a:a + _CHUNK], c) * inv).to(
            dst.dtype)
        d = flat_dst[:, a:a + _CHUNK]
        d.copy_(torch.where(keep, mean[None], d))


def _groups(m: int, num_groups: int) -> list:
    """The row slices of ``num_groups`` contiguous client groups (pods) of
    equal size; raises where ``m`` clients do not split so (the reference
    fails in its reshape there)."""
    if num_groups < 1 or m % num_groups:
        raise ValueError(f"{m} clients do not split into {num_groups} "
                         f"equal contiguous groups (hierarchy_groups)")
    n = m // num_groups
    return [slice(g * n, (g + 1) * n) for g in range(num_groups)]


def _bcast_mean_grouped(x, num_groups: int, w=None):
    """Pod-local grouped mean over contiguous client groups (the
    hierarchical multi-pod schedule): each group's rows get
    :func:`_bcast_mean` of that group, with ``w`` restricted to it, so an
    empty group (Σw = 0 in it) passes its rows through."""
    out = torch.empty_like(x)
    for r in _groups(x.shape[0], num_groups):
        out[r] = _bcast_mean(x[r], None if w is None else w[r])
    return out


def _inv(m: int, device) -> torch.Tensor:
    return torch.tensor(1.0 / m, dtype=torch.float32, device=device)


def _weighted_sum(seg, c):
    """Σ_m seg_m · c_m over the leading axis, in f32, as the compiled
    reference sums ``x · col``: one rounding per client, in client order
    (see :func:`_bcast_mean`); ``c`` [M] f64 on ``seg``'s device."""
    acc = torch.zeros(seg.shape[1], dtype=torch.float32, device=seg.device)
    for i in range(seg.shape[0]):
        acc = (acc.double() + seg[i].double() * c[i]).float()
    return acc


# ---------------------------------------------------------------------------
# Guarded communication: fault injection and robust aggregation
# ---------------------------------------------------------------------------

class RobustCfg(NamedTuple):
    """Robust-reduction policy of :func:`client_mean_masked` (the substrate
    half of ``repro_torch.federation.faults.RobustnessSpec``, lowered by
    ``sequences.make_engine``).

    ``screen`` enables the per-client health mask: a participant is healthy
    iff its row as sent is all-finite and its norm lies within ``z_thresh``
    standard deviations of the finite participants' mean norm
    (``z_thresh <= 0`` keeps the finite check only).  ``aggregator``:
    ``"mean"`` (the participants-only weighted mean over healthy rows, with
    the unguarded path's arithmetic, so an all-healthy round reproduces it
    bit for bit), ``"clip"`` (each healthy row scaled to at most
    ``clip_factor`` × the healthy participants' weighted mean norm, then
    the mean) or ``"trim"`` (the coordinate-wise ``trim_frac``-trimmed mean
    over healthy rows)."""
    aggregator: str = "mean"
    screen: bool = True
    z_thresh: float = 3.0
    clip_factor: float = 2.0
    trim_frac: float = 0.2


def _rows(v, x):
    """[M] → an [M, 1] column on ``x``'s device."""
    return v.to(x.device).reshape(-1, 1)


def _corrupt_rows(x, corrupt):
    """The round's fault transform of what the clients send into one
    reduction: ``corrupt = (nan, byz, scale)`` with [M] {0, 1} masks; byz
    rows are scaled in the rows' dtype, nan rows replaced wholesale.
    ``where`` selects, so unfaulted rows pass through bit for bit."""
    if corrupt is None:
        return x
    nan, byz, scale = corrupt
    x = torch.where(_rows(byz, x) > 0,
                    x * torch.tensor(scale, dtype=x.dtype, device=x.device), x)
    return torch.where(_rows(nan, x) > 0,
                       torch.tensor(math.nan, dtype=x.dtype, device=x.device),
                       x)


def _sent(x0, w, corrupt):
    """The rows as sent: corrupted, except a zero-weight client's, which
    sends nothing (its faults never reach the round)."""
    x = _corrupt_rows(x0, corrupt)
    if w is None or corrupt is None:
        return x
    return torch.where(_rows(w, x) > 0, x, x0)


def _row_stats(x0, w, corrupt):
    """Per client, over the whole run as sent: (all entries finite, Σ x²),
    in a pass over column chunks so that no [M, N] temporary outlives one
    chunk.  The squares are taken in f32 and summed in f64 (the reference's
    f32 sum runs in XLA's order, which is not reproduced); both on the
    host."""
    m = x0.shape[0]
    finite = torch.ones(m, dtype=torch.bool, device=x0.device)
    sq = torch.zeros(m, dtype=torch.float64, device=x0.device)
    for a in range(0, x0.shape[1], _CHUNK):
        x = _sent(x0[:, a:a + _CHUNK], w, corrupt).to(torch.float32)
        finite &= torch.isfinite(x).all(dim=1)
        sq += x.square().sum(dim=1, dtype=torch.float64)
    return finite.cpu(), sq.cpu()


def _health_stats(finite, sq, p, robust: RobustCfg):
    """The health screen's verdict [M] f32 (1 = healthy participant) and
    its statistics ``(n, mu, tol)`` (None with ``z_thresh <= 0``): a
    participant with a finite row is healthy when its norm ``n`` lies
    within ``tol = z·sd + 1e-4·mu + 1e-12`` of the finite participants'
    mean norm ``mu`` (``sd`` their standard deviation); excluded rows count
    with norm 0.  The reference's ``_health_mask``, in f32 on the host."""
    h = p & finite
    if robust.z_thresh <= 0:
        return h.to(torch.float32), None
    n = torch.where(h, sq, 0.0).to(torch.float32).sqrt()
    hf = h.to(torch.float32)
    cnt = torch.clamp_min(hf.sum(), 1.0)
    mu = (n * hf).sum() / cnt
    sd = ((n - mu).square() * hf).sum().div(cnt).sqrt()
    # relative tolerance: an all-equal-norm round has sd = 0 and must not
    # screen everyone out over rounding in |n − mu|
    tol = robust.z_thresh * sd + 1e-4 * mu + 1e-12
    return (h & ((n - mu).abs() <= tol)).to(torch.float32), (n, mu, tol)


def _clip_scale(sq, hf, w_eff, clip_factor: float):
    """Per-client clip factors [M] f32: ``min(1, tau / n)`` with ``n`` the
    norm of each healthy row (0 otherwise) and ``tau = clip_factor ×`` the
    healthy participants' weighted mean norm."""
    n = torch.where(hf > 0, sq.to(torch.float32).sqrt(),
                    torch.zeros((), dtype=torch.float32))
    wsum = torch.clamp_min(w_eff.sum(), 1e-12)
    tau = clip_factor * ((n * w_eff).sum() / wsum)
    return torch.minimum(torch.ones(()),
                         tau / torch.maximum(n, torch.tensor(1e-12)))


def _trim_bounds(nh: torch.Tensor, trim_frac: float, m: int):
    """(first kept, one past the last kept sorted position, divisor) of
    the trimmed mean over ``nh`` healthy rows sorted to the front: positions
    [k, nh − k) survive, k clamped so that one row always does."""
    k = torch.minimum(torch.floor(trim_frac * nh),
                      torch.clamp_min(torch.floor((nh - 1.0) / 2.0), 0.0))
    return (int(k), min(int(nh - k), m),
            torch.clamp_min(nh - 2.0 * k, 1.0))


def _robust_mean_into(seg, w, corrupt, robust: RobustCfg | None,
                      verdicts: list | None = None) -> None:
    """Fault- and robustness-aware participant mean of one communicated run
    [M, L], written into ``seg`` in place.

    The fault transform applies to what the clients send (:func:`_sent`).
    With ``robust=None`` this is the unguarded faulty mean: corrupted rows
    enter the sum and poison every participant.  With a
    :class:`RobustCfg`, a first pass over column chunks takes each row's
    finiteness and squared norm (:func:`_row_stats`), the screen decides
    the healthy senders on the host (:func:`_health_stats`), and a second
    pass writes the chosen aggregate chunk by chunk: unhealthy senders are
    left out of it and then recovered (they receive the aggregate), while
    non-participants keep their rows; if no healthy weight remains, every
    row stays as it was.  ``verdicts``: a list that gets the screen's
    health mask [M] (1 = healthy participant) of this run."""
    m = seg.shape[0]
    if robust is None:
        for a in range(0, seg.shape[1], _CHUNK):
            s = seg[:, a:a + _CHUNK]
            s.copy_(_bcast_mean(_sent(s, w, corrupt), w))
        return
    wv = torch.ones(m) if w is None else w.to(torch.float32).cpu()
    p = wv > 0
    stats = (_row_stats(seg, w, corrupt)
             if robust.screen or robust.aggregator == "clip" else None)
    hf = (_health_stats(*stats, p, robust)[0] if robust.screen
          else p.to(torch.float32))
    if verdicts is not None and robust.screen:
        verdicts.append(hf)
    w_eff = wv * hf
    if not bool(w_eff.sum() > 0):
        return
    keep = _rows(p, seg)
    healthy = _rows(hf, seg) > 0
    if robust.aggregator == "trim":
        lo, hi, div = _trim_bounds(hf.sum(), robust.trim_frac, m)
        div = div.to(seg.device)
    else:
        # the unguarded path's _weight_col arithmetic: an all-healthy round
        # (w_eff = wv bit for bit) reproduces it
        c = _weight_col(seg, w_eff).to(device=seg.device,
                                       dtype=torch.float64)
        inv = _inv(m, seg.device)
        if robust.aggregator == "clip":
            scale = _rows(_clip_scale(stats[1], hf, w_eff,
                                      robust.clip_factor), seg).to(seg.dtype)
    zero = torch.zeros((), dtype=seg.dtype, device=seg.device)
    for a in range(0, seg.shape[1], _CHUNK):
        s = seg[:, a:a + _CHUNK]
        xh = torch.where(healthy, _sent(s, w, corrupt), zero)
        if robust.aggregator == "trim":
            xs = torch.where(healthy, xh.to(torch.float32), math.inf)
            xs = torch.sort(xs, dim=0).values
            mean = xs[lo:hi].sum(dim=0) / div
        else:
            if robust.aggregator == "clip":
                xh = xh * scale
            mean = _weighted_sum(xh, c) * inv
        s.copy_(torch.where(keep, mean.to(seg.dtype)[None], s))


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


def _compress_sent(acc, ccfg: CompressCfg, block: int):
    """What each client sends into a compressed reduction, from its f32
    (row + EF) ``acc`` [M, L]: the per-tile top-k, then the round trip
    through the reduction's dtype.  The int8 send is what the reference's
    ``quantunpack_flat`` kernel writes on a TPU (one rounded f32 product per
    element): one ``quantpack``/``quantunpack`` launch over the run."""
    sent = (_topk_tiles(acc, block, ccfg.topk_frac) if ccfg.topk_frac > 0
            else acc)
    if ccfg.quant == "int8":
        q, s = quantpack_flat(sent.reshape(-1), block=block)
        sent = quantunpack_flat(q, s, block=block).reshape(acc.shape)
    elif ccfg.quant == "bf16":
        sent = sent.to(torch.bfloat16).to(torch.float32)
    return sent


def _mean_of_sends_into(dst, sent, w):
    """Write the client mean of the f32 sends ``sent`` [n, L] into ``dst``
    (the run's rows, in its dtype).  Unweighted: summed from 0 in client
    order, then multiplied by ``f32(1/n)`` (the reference's ``jnp.mean``
    over the materialized sends).  Weighted: the participants' mean into
    the participants' rows, non-participants' rows untouched
    (:func:`_weighted_mean_into`, ``col`` in f32)."""
    if w is not None:
        _weighted_mean_into(dst, sent, w)
        return
    total = torch.zeros(sent.shape[1:], dtype=torch.float32,
                        device=sent.device)
    for i in range(sent.shape[0]):
        total += sent[i]
    dst.copy_((total * _inv(sent.shape[0], sent.device)).to(dst.dtype)
              .expand_as(dst))


def _compressed_mean_into(seg, eseg, w, ccfg: CompressCfg, block: int):
    """Compressed client mean of one run [M, L], in place: every
    participant sends its compressed (row + EF) (:func:`_compress_sent`),
    the participants' (weighted) mean of the sends replaces their rows, and
    the residual ``(row + EF) − send`` becomes their EF (``eseg``, written
    in place; None without error feedback).  With ``w``, a non-participant
    (w = 0) keeps its row and its EF row bit for bit: it sent nothing."""
    acc = seg.to(torch.float32)
    if eseg is not None:
        acc = acc + eseg
    sent = _compress_sent(acc, ccfg, block)
    # with EF, acc is a tensor of its own: seg may be written first
    _mean_of_sends_into(seg, sent, w)
    if eseg is None:
        return
    new_e = acc.sub_(sent)
    del sent
    if w is not None:
        new_e = torch.where(_rows(w > 0, new_e), new_e, eseg)
    eseg.copy_(new_e)


def _compressed_mean_grouped_into(seg, w, ccfg: CompressCfg, block: int,
                                  num_groups: int):
    """Grouped (pod-local) mean of one run over quantized sends, in place:
    each client's send is rounded once (:func:`_compress_sent`, one launch
    pair over the run) and each group's rows get the (weighted) mean of its
    sends; an empty group keeps its rows.  Quantization only
    (:func:`client_mean_masked` refuses top-k, whose error feedback does
    not compose with a grouped mean)."""
    groups = _groups(seg.shape[0], num_groups)
    sent = _compress_sent(seg.to(torch.float32), ccfg, block)
    for r in groups:
        _mean_of_sends_into(seg[r], sent[r], None if w is None else w[r])


def _normalize_weights(spec: FlatSpec, weights) -> tuple:
    """One weight entry per section: a tuple or list passes as it is (its
    length checked), a single [M] tensor or None is shared by all."""
    n_sections = max(len(spec.sections), 1)
    if isinstance(weights, (tuple, list)):
        if len(weights) != n_sections:
            raise ValueError(f"{len(weights)} weights for {n_sections} "
                             f"sections")
        return tuple(weights)
    return (weights,) * n_sections


def _section_runs(grp: _Group, modes, comp_of_sec=None, w_of_sec=None,
                  shards: int = 1):
    """[mode, start, stop, compressed, weights] element runs covering the
    buffer (``shards`` chunks of the chunk extents; 1 for a rank's block);
    adjacent runs merge when the mode, the compression flag and the weight
    tensor (the same object) coincide (``"none"`` runs merge whatever the
    rest: private tiles are never reduced), across chunk boundaries too, so
    there is one reduction per communicated run."""
    width = grp.padded // shards
    runs: list = []
    for j in range(shards):
        for s, a, b in grp.extents:
            mode = modes[int(s)]
            comp = bool(comp_of_sec[int(s)]) if comp_of_sec else False
            w = w_of_sec[int(s)] if w_of_sec else None
            a, b = j * width + a, j * width + b
            if runs and runs[-1][0] == mode and runs[-1][2] == a and (
                    mode == "none"
                    or (runs[-1][3] == comp and runs[-1][4] is w)):
                runs[-1][2] = b
            else:
                runs.append([mode, a, b, comp, w])
    return runs


def client_mean_masked(spec: FlatSpec, bufs, modes, *, num_groups: int = 2,
                       weights=None, corrupt=None,
                       robust: RobustCfg | None = None,
                       verdicts: list | None = None, compress=None, ef=None,
                       shard: ShardCtx | None = None,
                       pending: list | None = None):
    """Section-masked client communication over flat [M, N] buffers, in
    place: every ``"mean"`` run is replaced by its client mean, every
    ``"group"`` run by the pod-local mean of ``num_groups`` contiguous
    client groups (the hierarchical schedule's local rounds), and
    ``"none"`` (private) runs are not touched.  Returns ``bufs``.

    ``weights``: participation weights, one [M] tensor (or None) shared by
    every section or a tuple of one per section.  Zero-weight clients are
    non-participants: each mean is over participants only (in a grouped
    run, over the group's participants; an empty group keeps its rows) and
    their rows pass through bit for bit (:func:`_bcast_mean`).

    ``compress``: a :class:`CompressCfg`; the runs of the sections it names
    (every communicated one when ``sections`` is empty) take the compressed
    mean, whole-run (:func:`_compressed_mean_into`; a ``"group"`` run
    :func:`_compressed_mean_grouped_into`, quantization only), and the call
    returns ``(bufs, ef)``: the updated per-client error-feedback buffers,
    one f32 [M, N] buffer per dtype group (pass the current ones as
    ``ef=``; copies are written), or ``()`` when ``compress.has_ef`` is
    false.  A non-participant's EF rows stay as they were.

    ``corrupt``: the round's ``(nan, byz, scale)`` fault masks ([M] {0, 1}
    tensors and a scalar), applied to what the clients send into each
    ``"mean"`` run (:func:`_corrupt_rows`).  ``robust``: a
    :class:`RobustCfg`: health-screen the senders and reduce with its
    aggregator (:func:`_robust_mean_into`), the screen's statistics over
    each whole run; ``verdicts`` (a list) then gets each run's health mask.
    Neither composes with compression or a grouped mean.

    ``shard``: a :class:`ShardCtx`; ``bufs`` (and ``ef``) are then the
    rank's blocks, while ``weights`` and ``corrupt`` stay the [M] operands
    of every client (:func:`_client_mean_masked_sharded`).  ``pending``: a
    list, with ``shard``; each run's all-reduce is then issued without
    waiting and a function that waits and writes the run back is appended
    to it (the overlap schedule calls them after the new-iterate oracle);
    the error-feedback updates need no collective and are written at
    once."""
    n_sections = max(len(spec.sections), 1)
    if len(modes) != n_sections:
        raise ValueError(f"modes {modes} do not match sections {spec.sections}")
    if any(m not in ("none", "mean", "group") for m in modes):
        raise ValueError(f"unknown communication modes {modes} "
                         f"(none | mean | group)")
    guarded = corrupt is not None or robust is not None
    if guarded and "group" in modes:
        raise ValueError(f"corrupt=/robust= do not compose with grouped "
                         f"(hierarchical) means: modes {modes}")
    if guarded and compress is not None:
        raise ValueError("compress= does not compose with corrupt=/robust= "
                         "(the guarded reductions consume raw client rows)")
    comp_of_sec = None
    if compress is not None:
        if compress.topk_frac > 0 and "group" in modes:
            raise ValueError(f"top-k compression does not compose with "
                             f"grouped (hierarchical) means: modes {modes}")
        names = spec.sections if spec.sections else ("",)
        comp_of_sec = tuple(not compress.sections or nm in compress.sections
                            for nm in names)
    w_of_sec = _normalize_weights(spec, weights)
    has_ef = compress is not None and compress.has_ef
    if has_ef and len(ef or ()) != len(spec.groups):
        raise ValueError("compression with error feedback needs one f32 EF "
                         "buffer per dtype group (pass ef=)")
    if shard is not None:
        return _client_mean_masked_sharded(
            spec, bufs, modes, num_groups, w_of_sec, shard, corrupt, robust,
            verdicts, compress, comp_of_sec, ef if has_ef else None,
            pending)
    ef_out = []
    for gi, (grp, buf) in enumerate(zip(spec.groups, bufs)):
        if buf.dim() < 2:
            raise ValueError("client_mean_masked needs a leading client axis")
        ebuf = ef[gi].clone() if has_ef else None
        for mode, start, stop, comp, w in _section_runs(grp, modes,
                                                         comp_of_sec,
                                                         w_of_sec,
                                                         spec.shards):
            if mode == "none":
                continue
            seg = buf[..., start:stop]
            if guarded:
                _robust_mean_into(seg, w, corrupt, robust, verdicts)
            elif not comp and mode == "mean":
                seg.copy_(_bcast_mean(seg, w))
            elif not comp:
                seg.copy_(_bcast_mean_grouped(seg, num_groups, w))
            elif mode == "mean":
                _compressed_mean_into(
                    seg, None if ebuf is None else ebuf[..., start:stop], w,
                    compress, grp.block)
            else:
                _compressed_mean_grouped_into(seg, w, compress, grp.block,
                                              num_groups)
        ef_out.append(ebuf)
    if compress is None:
        return bufs
    return bufs, (tuple(ef_out) if has_ef else ())


# ---------------------------------------------------------------------------
# Sharded communication: collectives over the mesh's ranks
# ---------------------------------------------------------------------------
#
# Each function below runs on every rank of the mesh with that rank's block
# of the buffers.  A communicated run's local rows are summed into a partial
# sum [L] and the partial sums are all-reduced over the data axis (the
# ranks of one model column), or over one pod's ranks for a grouped run.
# The per-client weights and fault masks are host decisions that every rank
# holds for all M clients, so the weight sums need no collective.

def _group_index_sets(shard: ShardCtx, num_groups: int):
    """Contiguous rank groups along the data axis for the pod-local mean
    (data indices of each pod)."""
    d = shard.data_size
    if num_groups < 1 or d % num_groups:
        raise ValueError(
            f"hierarchy_groups={num_groups} must divide the mesh "
            f"{shard.data_axis} axis size {d} on the sharded path")
    per = d // num_groups
    return [[g * per + i for i in range(per)] for g in range(num_groups)]


def _psum(x, group):
    """Sum of ``x`` over the ranks of ``group``, in place, waited for."""
    dist.all_reduce(x, group=group)
    return x


def _allreduce(x, shard: ShardCtx, group=None, *, async_op: bool = False):
    """All-reduce (sum) of a partial sum [L] over the data axis (``group``
    None) or over ``group`` (a pod's ranks); with ``shard.use_scatter``
    and no group, a reduce-scatter followed by an all-gather.  Returns a
    function that waits and gives the reduced tensor; ``async_op`` issues
    the first collective without waiting."""
    if (shard.use_scatter and group is None
            and x.shape[-1] % shard.data_size == 0):
        piece = torch.empty(x.shape[-1] // shard.data_size, dtype=x.dtype,
                            device=x.device)
        work = dist.reduce_scatter_tensor(piece, x, group=shard.data_group,
                                          async_op=async_op)

        def gathered():
            if work is not None:
                work.wait()
            out = torch.empty_like(x)
            dist.all_gather_into_tensor(out, piece, group=shard.data_group)
            return out

        return gathered
    work = dist.all_reduce(x, group=shard.data_group if group is None
                           else group, async_op=async_op)

    def reduced():
        if work is not None:
            work.wait()
        return x

    return reduced


def _wire_allreduce(partial, quant, block: int, shard: ShardCtx, group,
                    nsum: int, *, async_op: bool = False):
    """All-reduce of f32 partial sums [L] in the WIRE dtype (returns a
    function that waits and gives the f32 sum):

    * bf16: cast, reduce, cast back (2 B an element);
    * int8: symmetric per-tile quantization on a scale SHARED by the
      ``nsum`` ranks being summed, ``s = Σ amax / (127 − nsum/2)``: each
      rank's |q| ≤ amax/s + 1/2, so the int8 sum stays within 127 and
      cannot wrap (integer adds wrap, they do not saturate).  The scales
      are one small f32 all-reduce of [L/block] first;
    * None (top-k only): dense f32, as sparsity does not shrink the sum."""
    if quant is None:
        return _allreduce(partial, shard, group, async_op=async_op)
    if quant == "bf16":
        f = _allreduce(partial.to(torch.bfloat16), shard, group,
                       async_op=async_op)
        return lambda: f().to(torch.float32)
    if quant != "int8":
        raise ValueError(f"unknown compression quant {quant!r}")
    t = partial.reshape(-1, block)
    gmax = _psum(t.abs().amax(dim=-1), shard.data_group if group is None
                 else group)
    s = gmax / (127.0 - 0.5 * nsum)
    safe = torch.where(s > 0, s, torch.ones_like(s))
    q = torch.clamp(torch.round(t / safe[:, None]), -127.0, 127.0).to(
        torch.int8)
    f = _allreduce(q.reshape(partial.shape), shard, group, async_op=async_op)
    return lambda: (f().reshape(t.shape).to(torch.float32)
                    * s[:, None]).reshape(partial.shape)


def _rank_sum(w, shard: ShardCtx, ranks) -> torch.Tensor:
    """Σ w over the clients of data ranks ``ranks``: each rank's rows
    summed, then the rank sums in rank order (f32), as an all-reduce of
    the ranks' local sums adds them."""
    per = w.shape[0] // shard.data_size
    tot = torch.zeros((), dtype=torch.float32)
    for r in ranks:
        tot = tot + w[r * per:(r + 1) * per].to(torch.float32).sum()
    return tot


def _robust_mean_sharded(seg, w, corrupt, robust: RobustCfg | None,
                         shard: ShardCtx, m: int,
                         verdicts: list | None) -> None:
    """The guarded participant mean of one run on a rank's block, written
    into ``seg`` in place (the sharded mirror of
    :func:`_robust_mean_into`, the reference's ``_robust_mean_sharded``
    step for step): per-client row statistics (finiteness, norms) are
    completed over the MODEL axis, each rank holding a column slice of its
    rows; the screen's and the aggregate's statistics over the DATA axis;
    clipping is row-local; the trimmed mean all-gathers the rows over the
    data axis (an order statistic needs every client).  ``w`` and
    ``corrupt`` are the [M] operands of every client."""
    da, ma = shard.data_group, shard.model_group
    dev = seg.device
    seg0 = seg.clone()
    w_l = shard.local_rows(w)
    corr = (None if corrupt is None else
            (shard.local_rows(corrupt[0]), shard.local_rows(corrupt[1]),
             corrupt[2]))
    sent = _sent(seg0, w_l, corr)
    n_l = seg.shape[0]
    wv = (torch.ones(n_l) if w_l is None
          else w_l.to(torch.float32).cpu()).to(dev)
    p = wv > 0
    if robust is None:
        # the unguarded faulty mean: corrupted rows enter the sum
        wsum = _psum(wv.sum(), da)
        scale = torch.where(wsum > 0, m / wsum, 0.0)
        col = (wv * scale).to(seg.dtype)[:, None]
        tot = _allreduce((sent * col).sum(dim=0), shard)()
        mean = (tot / m)[None].to(seg.dtype).expand_as(seg)
        seg.copy_(mean if w_l is None else torch.where(col > 0, mean, seg0))
        return
    if robust.screen:
        nonfinite = _psum((~torch.isfinite(sent)).sum(dim=1).to(
            torch.float32), ma)
        h = p & (nonfinite == 0)
    else:
        h = p
    sq = _psum(torch.where(h[:, None], sent, 0).to(torch.float32).square()
               .sum(dim=1), ma)
    n = sq.sqrt()
    hf = h.to(torch.float32)
    if robust.screen and robust.z_thresh > 0:
        cnt = torch.clamp_min(_psum(hf.sum(), da), 1.0)
        mu = _psum((n * hf).sum(), da) / cnt
        sd = (_psum(((n - mu).square() * hf).sum(), da) / cnt).sqrt()
        tol = robust.z_thresh * sd + 1e-4 * mu + 1e-12
        h = h & ((n - mu).abs() <= tol)
        hf = h.to(torch.float32)
    if verdicts is not None and robust.screen:
        every = torch.empty(m, dtype=torch.float32, device=dev)
        dist.all_gather_into_tensor(every, hf, group=da)
        verdicts.append(every.cpu())
    w_eff = wv * hf
    wsum_eff = _psum(w_eff.sum(), da)
    if robust.aggregator == "trim":
        rows = torch.empty((m,) + tuple(seg.shape[1:]), dtype=torch.float32,
                           device=dev)
        dist.all_gather_into_tensor(
            rows, torch.where(h[:, None], sent.to(torch.float32), math.inf),
            group=da)
        xs = torch.sort(rows, dim=0).values
        nh = _psum(hf.sum(), da)
        k = torch.minimum(torch.floor(robust.trim_frac * nh),
                          torch.clamp_min(torch.floor((nh - 1.0) / 2.0),
                                          0.0))
        idx = torch.arange(m, dtype=torch.float32, device=dev)[:, None]
        keep = (idx >= k) & (idx < nh - k)
        mean = (torch.where(keep, xs, 0.0).sum(dim=0, keepdim=True)
                / torch.clamp_min(nh - 2.0 * k, 1.0))
    else:
        xh = torch.where(h[:, None], sent, torch.zeros((), dtype=seg.dtype,
                                                       device=dev))
        if robust.aggregator == "clip":
            tau = robust.clip_factor * (
                _psum((n * w_eff).sum(), da)
                / torch.clamp_min(wsum_eff, 1e-12))
            sc = torch.minimum(torch.ones((), device=dev),
                               tau / torch.clamp_min(n, 1e-12))
            xh = xh * sc[:, None].to(xh.dtype)
        scale = torch.where(wsum_eff > 0, m / wsum_eff, 0.0)
        col = (w_eff * scale).to(seg.dtype)[:, None]
        tot = _allreduce((xh * col).sum(dim=0), shard)()
        mean = (tot / m)[None]
    mean = mean.to(seg.dtype).expand_as(seg)
    seg.copy_(torch.where(p[:, None] & (wsum_eff > 0), mean, seg0))


def _client_mean_masked_sharded(spec: FlatSpec, bufs, modes, num_groups,
                                w_of_sec, shard: ShardCtx, corrupt, robust,
                                verdicts, compress, comp_of_sec, ef,
                                pending):
    """:func:`client_mean_masked` on a rank's blocks.  One run list per
    model chunk, the same on every rank (the chunk extents), so all ranks
    issue the same collectives in the same order.  Each communicated run
    sums its local rows (weighted by ``w·(denom/Σw)``, Σw over the run's
    clients) and all-reduces the partial sum over the data axis, or over
    its pod's ranks for a ``"group"`` run; a compressed run sums the
    clients' compressed sends and all-reduces in the wire dtype
    (:func:`_wire_allreduce`).  Private and non-participant rows never
    enter a collective, and a non-participant's rows (and EF rows) keep
    their bits."""
    guarded = corrupt is not None or robust is not None
    _check_blocks(spec, shard, bufs)
    d = shard.data_size
    ef_out = []
    for gi, (grp, buf) in enumerate(zip(spec.groups, bufs)):
        m = buf.shape[0] * d
        ebuf = None if ef is None else ef[gi].clone()
        for mode, a, stop, comp, w in _section_runs(grp, modes, comp_of_sec,
                                                    w_of_sec):
            if mode == "none":
                continue        # private tiles never enter the collective
            seg = buf[:, a:stop]
            if w is not None and w.shape[0] != m:
                raise ValueError(f"weights for {w.shape[0]} clients on a "
                                 f"mesh of {m}")
            if guarded:
                _robust_mean_sharded(seg, w, corrupt, robust, shard, m,
                                     verdicts)
                continue
            if mode == "group":
                pods = _group_index_sets(shard, num_groups)
                ranks = pods[shard.data_index // (d // num_groups)]
                pg = shard.mesh.pod_group(num_groups)
                denom, nsum = m // num_groups, d // num_groups
            else:
                ranks, pg, denom, nsum = range(d), None, m, d
            col = None
            if w is not None:
                wsum = _rank_sum(w, shard, ranks)
                scale = torch.where(wsum > 0, denom / wsum, 0.0)
                col = (shard.local_rows(w) * scale).to(torch.float32)
            async_op = pending is not None
            if comp:
                eseg = (ebuf[:, a:stop]
                        if ebuf is not None and mode == "mean" else None)
                acc = seg.to(torch.float32)
                if eseg is not None:
                    acc = acc + eseg
                sent = _compress_sent(acc, compress, grp.block)
                if col is None:
                    partial = sent.sum(dim=0)
                else:
                    col = col.to(seg.device)[:, None]
                    partial = (sent * col).sum(dim=0)
                if eseg is not None:
                    new_e = acc - sent
                    if w is not None:
                        new_e = torch.where(
                            _rows(shard.local_rows(w) > 0, new_e), new_e,
                            eseg)
                    eseg.copy_(new_e)
                    del new_e
                del acc, sent
                fin = _wire_allreduce(partial, compress.quant, grp.block,
                                      shard, pg, nsum, async_op=async_op)
                upd_dtype = torch.float32
            else:
                if col is None:
                    partial = seg.sum(dim=0)
                else:
                    col = col.to(device=seg.device, dtype=seg.dtype)[:, None]
                    partial = (seg * col).sum(dim=0)
                fin = _allreduce(partial, shard, pg, async_op=async_op)
                upd_dtype = seg.dtype

            def write(seg=seg, fin=fin, col=col, denom=denom,
                      upd_dtype=upd_dtype):
                mean = (fin() / denom)[None].to(upd_dtype)
                if col is None:
                    seg.copy_(mean.expand_as(seg))
                else:
                    seg.copy_(torch.where(col > 0, mean, seg.to(upd_dtype)))

            if pending is None:
                write()
            else:
                pending.append(write)
        ef_out.append(ebuf)
    if compress is None:
        return bufs
    return bufs, (tuple(ef_out) if ef is not None else ())


# ---------------------------------------------------------------------------
# Telemetry metrics (read-only side outputs: they never touch a trajectory)
# ---------------------------------------------------------------------------
#
# Each metric runs over column chunks of ``_CHUNK``, so that no f32 [M, N]
# temporary outlives one chunk, and sums its squares in f64 (the
# reference's f32 sums run in XLA's order, which is not reproduced).
# Results are 0-d (or [M]) f32 tensors on the buffers' device, read by the
# host only where the train CLI logs them.
#
# With ``shard=`` each pass runs on a rank's blocks (its clients' rows, one
# model chunk, whose columns are the chunk extents themselves) and
# completes its partial sums with collectives, so that every rank holds the
# whole metric: a quantity of a row over the model axis, a sum over
# clients over the data axis.  The reference computes these passes on
# global arrays outside ``shard_map`` and lets GSPMD insert the same
# reductions; the values agree up to the order of summation.

def _section_cols(spec: FlatSpec, grp: _Group, shard=None) -> dict:
    """Column ranges of every section in one (whole, possibly shard-major)
    buffer: ``{section_index: [(start, stop), ...]}``.  The extents cover
    one chunk, so a sharded layout repeats them at every chunk offset; a
    rank's block (``shard``) is one chunk, whose ranges are the extents."""
    chunk = grp.padded // spec.shards
    out: dict = {}
    for s, a, b in grp.extents:
        for j in range(1 if shard is not None else spec.shards):
            out.setdefault(int(s), []).append((j * chunk + a,
                                               j * chunk + b))
    return out


def _chunks(a: int, b: int, step: int = _CHUNK):
    for c in range(a, b, step):
        yield c, min(c + step, b)


def _mesh_sums(parts: dict, shard) -> dict:
    """Complete per-section partial sums (0-d tensors, keyed by section)
    over the mesh: one all-reduce of the stacked sums over the model axis,
    then one over the data axis, the keys in sorted order on every rank.
    Off a mesh the sums pass."""
    if shard is None or not parts:
        return parts
    keys = sorted(parts)
    vec = torch.stack([parts[k] for k in keys])
    _psum(_psum(vec, shard.model_group), shard.data_group)
    return dict(zip(keys, vec.unbind()))


def section_norms(spec: FlatSpec, bufs, *, mask=None, prefix="norm",
                  minus=None, shard: ShardCtx | None = None) -> dict:
    """Per-section l2 norms of flat [M, N] buffers (telemetry side output):
    ``{"<prefix>/<section>": 0-d f32}``.  ``mask`` [M] restricts the sum to
    participant rows (selected, so a left-out row never multiplies a
    NaN).  ``minus``: buffers of the same layout; the norm is then that of
    ``bufs − minus``, the difference taken in the buffers' dtype as the
    reference takes it, a chunk at a time.  Section padding is zero by
    construction and contributes nothing.  ``shard``: the buffers are a
    rank's blocks and ``mask`` stays the [M] mask of every client; the
    squares are all-reduced over the model, then the data axis."""
    names = spec.sections or ("all",)
    if shard is not None:
        _check_blocks(spec, shard, bufs)
        mask = shard.local_rows(mask)
    sq: dict = {}
    for gi, (grp, buf) in enumerate(zip(spec.groups, bufs)):
        keep = None if mask is None else _rows(mask > 0, buf)
        for s, runs in _section_cols(spec, grp, shard).items():
            for a, b in runs:
                for c0, c1 in _chunks(a, b):
                    x = buf[:, c0:c1]
                    if minus is not None:
                        x = x - minus[gi][:, c0:c1]
                    x = x.to(torch.float32)
                    if keep is not None:
                        x = torch.where(keep, x, 0.0)
                    part = x.square().sum(dtype=torch.float64)
                    sq[s] = part if s not in sq else sq[s] + part
    sq = _mesh_sums(sq, shard)
    return {f"{prefix}/{names[s]}": v.sqrt().to(torch.float32)
            for s, v in sorted(sq.items())}


def section_drift(spec: FlatSpec, bufs, *, mask=None, prefix="drift",
                  shard: ShardCtx | None = None) -> dict:
    """Per-section client-drift dispersion (telemetry side output): the rms
    distance of participant rows to the participants' mean row, the
    non-IID heterogeneity term, measured on the LOCAL iterates before
    averaging.  The mean is taken in f32 as the reference takes it; same
    masking as :func:`section_norms`.  ``shard``: the mean row's column
    sums are all-reduced over the data axis first (f32), then the squared
    distances over the model and the data axis."""
    names = spec.sections or ("all",)
    if shard is not None:
        _check_blocks(spec, shard, bufs)
    m = bufs[0].shape[0] * (1 if shard is None else shard.data_size)
    rows = (None if mask is None
            else torch.nonzero(mask.cpu() > 0).flatten())
    cnt = m if rows is None else max(int(rows.numel()), 1)
    if shard is not None and rows is not None:
        # this rank's participants, as indices into its own rows
        lo = shard.rows(m).start
        rows = rows[(rows >= lo) & (rows < lo + bufs[0].shape[0])] - lo
    sq: dict = {}
    for grp, buf in zip(spec.groups, bufs):
        idx = None if rows is None else rows.to(buf.device)
        for s, runs in _section_cols(spec, grp, shard).items():
            for a, b in runs:
                for c0, c1 in _chunks(a, b):
                    seg = buf[:, c0:c1]
                    x = (seg if idx is None else seg[idx]).to(torch.float32)
                    tot = x.sum(dim=0, keepdim=True)
                    if shard is not None:
                        _psum(tot, shard.data_group)
                    mean = tot / cnt
                    part = (x - mean).square().sum(dtype=torch.float64)
                    sq[s] = part if s not in sq else sq[s] + part
    sq = _mesh_sums(sq, shard)
    return {f"{prefix}/{names[s]}": (v / cnt).sqrt().to(torch.float32)
            for s, v in sorted(sq.items())}


def quant_roundtrip_err(bufs, block: int, quant,
                        shard: ShardCtx | None = None) -> torch.Tensor:
    """l2 norm of the quantization round-trip error over ``bufs``: the
    value error the next compressed send of these buffers would incur
    (telemetry side output).  int8 goes through the ``quantpack`` /
    ``quantunpack`` wrappers (the kernels on a CUDA tensor, their plain
    versions on the CPU), a tile-aligned chunk of columns at a time.
    ``shard``: the buffers are a rank's blocks; a tile never straddles a
    block, so only the sum of squares is all-reduced (model, then data)."""
    if quant not in ("bf16", "int8"):
        raise ValueError(f"unknown compression quant {quant!r}")
    step = max(_CHUNK // block, 1) * block
    sq = torch.zeros((), dtype=torch.float64, device=bufs[0].device)
    for b in bufs:
        for c0, c1 in _chunks(0, b.shape[-1], step):
            x = b[..., c0:c1].to(torch.float32)
            if quant == "int8":
                q, s = quantpack_flat(x.reshape(-1), block=block)
                d = quantunpack_flat(q, s, block=block).reshape(x.shape) - x
                del q, s
            else:
                d = x.to(torch.bfloat16).to(torch.float32) - x
            sq += d.square().sum(dtype=torch.float64)
    return _mesh_sums({0: sq}, shard)[0].sqrt().to(torch.float32)


def health_screen(spec: FlatSpec, bufs, mask, corrupt,
                  robust: RobustCfg,
                  shard: ShardCtx | None = None) -> torch.Tensor:
    """Recomputed health-screen verdicts for telemetry: [M] f32 on the
    host, 1 where a participant (``mask > 0``, every client without a
    mask) would FAIL the screen on what it sends this round.  The rows are
    whole client rows over every buffer, cast to f32 before the fault
    transform, as the reference concatenates them; the verdict is the
    guarded reduction's rule (:func:`_health_stats`) with its z-score over
    those whole-row norms, an audit approximation (the guarded reduction
    itself screens each run).  ``shard``: the buffers are a rank's blocks
    and ``mask``/``corrupt`` the [M] operands of every client; each row's
    squared norm and count of non-finite entries are completed over the
    model axis, then every client's are all-gathered over the data axis
    (the z-score needs them all)."""
    n_l, dev = bufs[0].shape[0], bufs[0].device
    m = n_l * (1 if shard is None else shard.data_size)
    p = (torch.ones(m, dtype=torch.bool) if mask is None
         else mask.cpu() > 0)
    if shard is not None:
        _check_blocks(spec, shard, bufs)
        if corrupt is not None:
            corrupt = (shard.local_rows(corrupt[0]),
                       shard.local_rows(corrupt[1]), corrupt[2])
    bad = torch.zeros(n_l, dtype=torch.float64, device=dev)
    sq = torch.zeros(n_l, dtype=torch.float64, device=dev)
    for buf in bufs:
        for c0, c1 in _chunks(0, buf.shape[-1]):
            x = _corrupt_rows(buf[:, c0:c1].to(torch.float32), corrupt)
            bad += (~torch.isfinite(x)).sum(dim=1)
            sq += x.square().sum(dim=1, dtype=torch.float64)
    if shard is not None:
        stats = _psum(torch.cat([bad, sq]), shard.model_group)
        every = torch.empty(shard.data_size * stats.numel(),
                            dtype=stats.dtype, device=dev)
        dist.all_gather_into_tensor(every, stats, group=shard.data_group)
        bad, sq = every.view(shard.data_size, 2, n_l).permute(
            1, 0, 2).reshape(2, m).unbind()
    h, _ = _health_stats((bad == 0).cpu(), sq.cpu(), p, robust)
    return p.to(torch.float32) * (1.0 - h)
