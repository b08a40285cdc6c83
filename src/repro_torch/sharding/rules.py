"""Placement of the flat substrate's state over a ``[data, model]`` mesh of
ranks (counterpart of ``flat_state_specs`` in ``repro/sharding/rules.py``),
and the helpers that move whole states to and from rank 0.

The engine's :class:`~repro_torch.optim.sequences.FlatState` holds
per-dtype [M, N] buffers laid out by ``flat.make_spec(..., shards=k)``:
rank ``(i, j)`` holds rows ``i·M/d … (i+1)·M/d`` (its clients) and columns
``j·N/k … (j+1)·N/k`` (model chunk ``j``, which carries the same
tile-aligned section pattern as every other chunk) of each, the
reference's ``P("data", "model")``.  The step counter, the staleness
counters, the deadline and the retry counter are host state that every rank
decides the same way (they are pure in the seed, the round and the state's
own counters), so each rank holds all of them: the reference shards its
[M] counters over the data axis instead.

Checkpoints, ``views`` and the evaluation read whole states:
:func:`gather_state` assembles one on rank 0 (shard-major [M, N] buffers on
the CPU, the reference's on-disk layout) and :func:`scatter_state` sends
one back from rank 0 into every rank's blocks.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.optim import flat
from repro_torch.optim.sequences import FlatState

_BUFFER_FIELDS = ("vars", "mom", "ef")


def flat_state_specs(state: FlatState, *, data_axis: str = "data",
                     model_axis: str = "model") -> FlatState:
    """The placement of every leaf of ``state``: ``(data_axis,
    model_axis)`` for an [M, N] buffer (split over both axes), ``()`` for
    host state that every rank holds whole."""
    def one(leaf):
        if torch.is_tensor(leaf) and leaf.dim() == 2:
            return (data_axis, model_axis)
        return ()

    return _map_buffers(state, one, host=lambda v: ())


def _map_buffers(state: FlatState, fn, host=lambda v: v) -> FlatState:
    """``state`` with ``fn`` applied to each buffer of ``vars``, ``mom``
    and ``ef`` (whose entries are buffer tuples) and ``host`` to the rest."""
    def bufs(v):
        return tuple(bufs(b) if isinstance(b, tuple) else fn(b) for b in v)

    return FlatState(vars=bufs(state.vars), mom=bufs(state.mom),
                     step=host(state.step), ef=bufs(state.ef),
                     stale=host(state.stale), deadline=host(state.deadline),
                     retry=host(state.retry))


def _layouts(spec: flat.FlatSpec, state: FlatState) -> list:
    """The dtype group of each buffer of ``state``, in the order
    :func:`_map_buffers` visits them."""
    out: list = []

    def walk(v):
        for gi, b in enumerate(v):
            if isinstance(b, tuple):
                walk(b)
            else:
                out.append(spec.groups[gi])

    for name in _BUFFER_FIELDS:
        walk(getattr(state, name))
    return out


def gather_state(spec: flat.FlatSpec, state: FlatState,
                 shard: flat.ShardCtx):
    """The whole state on rank 0 (its [M, N] buffers assembled from every
    rank's block, on the CPU); None on the other ranks.  A collective:
    every rank calls it."""
    d, k = shard.data_size, shard.model_size
    rank0 = dist.get_rank() == 0
    grps = iter(_layouts(spec, state))

    def one(block):
        grp = next(grps)
        parts = ([torch.empty_like(block) for _ in range(d * k)]
                 if rank0 else None)
        dist.gather(block.contiguous(), parts, dst=0)
        if not rank0:
            return None
        rows, width = block.shape[0], grp.padded // spec.shards
        whole = torch.empty((rows * d, grp.padded), dtype=block.dtype)
        for r, part in enumerate(parts):
            i, j = divmod(r, k)
            whole[i * rows:(i + 1) * rows, j * width:(j + 1) * width] = \
                part.cpu()
        return whole

    out = _map_buffers(state, one)
    return out if rank0 else None


def whole_like(spec: flat.FlatSpec, state: FlatState,
               shard: flat.ShardCtx) -> FlatState:
    """A zero whole state (CPU) shaped as the one ``state``'s blocks make
    up: the target a checkpoint is loaded into on rank 0."""
    grps = iter(_layouts(spec, state))

    def one(block):
        grp = next(grps)
        return torch.zeros((block.shape[0] * shard.data_size, grp.padded),
                           dtype=block.dtype)

    return _map_buffers(state, one)


def scatter_state(spec: flat.FlatSpec, whole, state: FlatState,
                  shard: flat.ShardCtx) -> FlatState:
    """Copy rank 0's whole state ``whole`` (None on the other ranks) into
    every rank's blocks ``state`` in place, and its host fields into every
    rank's; returns the state.  A collective: every rank calls it."""
    rank0 = dist.get_rank() == 0
    host = [None]
    if rank0:
        host = [(whole.step, whole.stale, whole.deadline, whole.retry)]
    dist.broadcast_object_list(host, src=0)
    step, stale, deadline, retry = host[0]
    blocks = iter(_blocks(whole, spec, shard) if rank0 else ())

    def one(block):
        parts = None
        if rank0:
            parts = [p.to(block.device) for p in next(blocks)]
        dist.scatter(block, parts, src=0)
        return block

    out = _map_buffers(state, one)
    return out._replace(step=int(step), stale=stale, deadline=deadline,
                        retry=retry)


def _blocks(whole: FlatState, spec: flat.FlatSpec, shard: flat.ShardCtx):
    """Per buffer of ``whole``, the list of every rank's block, in rank
    order."""
    d, k = shard.data_size, shard.model_size
    grps = iter(_layouts(spec, whole))
    out: list = []

    def one(buf):
        grp = next(grps)
        rows, width = buf.shape[0] // d, grp.padded // spec.shards
        out.append([buf[i * rows:(i + 1) * rows,
                        j * width:(j + 1) * width].contiguous()
                    for i in range(d) for j in range(k)])
        return buf

    _map_buffers(whole, one)
    return out


def gather_client(spec: flat.FlatSpec, bufs, shard: flat.ShardCtx,
                  client: int = 0):
    """Client ``client``'s whole rows ``[1, N]`` of ``bufs`` (rank blocks),
    on the rank that holds its first chunk (data index of the client,
    model index 0), None elsewhere.  A collective of that data row's
    ranks only: the other ranks return None at once."""
    rows = bufs[0].shape[0]
    i, r = divmod(client, rows)
    if shard.data_index != i:
        return None
    k = shard.model_size
    first = i * k
    out = []
    for grp, block in zip(spec.groups, bufs):
        row = block[r:r + 1].contiguous()
        parts = ([torch.empty_like(row) for _ in range(k)]
                 if dist.get_rank() == first else None)
        dist.gather(row, parts, dst=first, group=shard.model_group)
        if parts is not None:
            out.append(torch.cat(parts, dim=1))
    return tuple(out) if dist.get_rank() == first else None
