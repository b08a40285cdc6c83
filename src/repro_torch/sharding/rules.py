"""Placement rules (counterpart of ``repro/sharding/rules.py``): where each
leaf of a parameter, train-state, cache or batch tree goes on the
production mesh; the placement of the flat substrate's state over a
``[data, model]`` mesh of ranks; and the helpers that move whole states to
and from rank 0.

**The tree rules** (:func:`param_specs`, :func:`state_specs`,
:func:`cache_specs`, :func:`batch_specs`) are the reference's, keyed on the
same tree-path names (``stages``, ``ffn``, ``wq``, ...): Megatron-style
tensor parallelism over ``"model"`` (column-parallel input projections,
row-parallel output projections, expert-parallel MoE, the vocabulary of the
embedding and head, or ``d_model`` where the vocabulary does not divide);
the client axis over ``"data"`` (``client_sharded``), over the whole mesh
(``client_pure``), over ``"model"`` with each client data-parallel
(``dp_within_client``), or replicated with FSDP over ``"data"``
(``client_replicated``).  Divisibility is always checked; a dimension that
does not divide falls back to the next candidate or to replication.  Each
leaf gets a tuple with one entry per dimension, an axis name, a tuple of
axis names or None, where the reference returns a ``PartitionSpec``: the
port has no tensor-parallel tree path, so the dry run reads them to divide
each leaf's bytes by the mesh axes it would be split over.

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

from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.config import MeshConfig
from repro_torch.optim import flat
from repro_torch.optim.sequences import FlatState

_BUFFER_FIELDS = ("vars", "mom", "ef")


# name → rule. COL: "model" on last dim; ROW: "model" on first core dim.
_COL = {"wq", "wk", "wv", "wi", "wg", "in_proj", "in_x", "in_gate", "wa", "wx",
        "w", "table", "patch_proj", "frontend_proj"}
_ROW = {"wo", "out", "out_proj"}
_REPL = {"scale", "ba", "bx", "Lambda", "conv_w", "conv_b", "A_log", "D",
         "dt_bias", "b", "router"}


def _with_names(tree, prefix: tuple = ()):
    """``(names, leaf)`` for every leaf in ``jax.tree.flatten`` order;
    ``names`` holds the dict keys and ``[i]`` for list and tuple positions
    on the way (a NamedTuple's fields are not names, as in the reference's
    key paths)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _with_names(tree[k], prefix + (str(k),))
    elif isinstance(tree, tuple) and hasattr(type(tree), "_fields"):
        for v in tree:
            yield from _with_names(v, prefix)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _with_names(v, prefix + (f"[{i}]",))
    else:
        yield prefix, tree


def _map_with_names(fn, tree):
    """``tree`` with each leaf replaced by ``fn(names, leaf)``."""
    from repro_torch.core.tree_util import tree_structure
    return tree_structure(tree).unflatten(
        [fn(list(names), leaf) for names, leaf in _with_names(tree)])


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape) if torch.is_tensor(leaf) else ()


def _divisible(dim: int, size: int) -> bool:
    return dim % size == 0 and dim >= size


def _param_core_spec(name: str, shape: Tuple[int, ...], model_size: int,
                     is_moe: bool) -> List[Optional[str]]:
    spec: List[Optional[str]] = [None] * len(shape)
    if len(shape) == 0 or name in _REPL:
        return spec
    if is_moe and len(shape) == 3:
        # [E, d, f] expert-parallel
        if _divisible(shape[0], model_size):
            spec[0] = "model"
        return spec
    if name in _COL and len(shape) >= 2:
        if _divisible(shape[-1], model_size):
            spec[-1] = "model"
        elif _divisible(shape[-2], model_size):
            spec[-2] = "model"
        return spec
    if name in _ROW and len(shape) >= 2:
        if _divisible(shape[0], model_size):
            spec[0] = "model"
        elif _divisible(shape[-1], model_size):
            spec[-1] = "model"
        return spec
    return spec


def _add_fsdp(spec: List[Optional[str]], shape: Tuple[int, ...],
              data_size: int) -> None:
    """Shard the largest remaining dim over "data" (FSDP), in place."""
    best, best_dim = -1, -1
    for i, (s, sp) in enumerate(zip(shape, spec)):
        if sp is None and _divisible(s, data_size) and s > best:
            best, best_dim = s, i
    if best_dim >= 0:
        spec[best_dim] = "data"


def _client_axis_spec(placement: str, mesh: MeshConfig):
    if placement == "client_sharded":
        return ("pod", "data") if mesh.multi_pod else "data"
    if placement == "client_pure":
        # multi-pod: the global batch cannot feed pod×data×model pure
        # clients; the client axis stays ("data", "model"), pod replicates
        return ("data", "model")
    if placement == "dp_within_client":
        # clients on "model"; each client data-parallel over "data" with
        # weights replicated (grad all-reduce) except vocab-sized tensors
        return ("pod", "model") if mesh.multi_pod else "model"
    # client_replicated
    return "pod" if mesh.multi_pod else None


_VOCAB_DIM_MIN = 32768   # dp_within_client: shard only vocab-sized leaves


def _dp_core_spec(core_shape, data_size: int) -> List[Optional[str]]:
    spec: List[Optional[str]] = [None] * len(core_shape)
    if any(s >= _VOCAB_DIM_MIN for s in core_shape):
        _add_fsdp(spec, core_shape, data_size)       # "data" on largest dim
    return spec


def _core_spec(names, shape, lead: int, placement: str, axes: dict,
               fsdp: bool) -> List[Any]:
    """The placement of a leaf's dimensions past its ``lead`` leading
    (client, scanned reps) ones."""
    name = names[-1] if names else ""
    is_moe = name in ("wi", "wg", "wo") and "ffn" in names
    core_shape = shape[lead:]
    if placement == "client_pure":
        # clients consume the whole mesh; per-client tensors unsharded
        return [None] * len(core_shape)
    if placement == "dp_within_client":
        return _dp_core_spec(core_shape, axes["data"])
    # MoE leaves under stages have an extra reps axis before [E, d, f]
    core = _param_core_spec(name, core_shape, axes["model"],
                            is_moe and len(core_shape) == 3)
    if fsdp:
        _add_fsdp(core, core_shape, axes["data"])
    return core


def param_specs(params: Any, mesh: MeshConfig, *,
                placement: str = "client_sharded", client_axis: bool = False,
                fsdp: Optional[bool] = None):
    """The placement of each leaf of a model parameter tree (or a
    federated-state tree with ``client_axis``: a leading client dim).
    ``fsdp`` forces FSDP on or off (default: on iff client_replicated)."""
    axes = dict(zip(mesh.axes, mesh.shape))
    if fsdp is None:
        fsdp = placement == "client_replicated"

    def one(names, leaf):
        in_stages = "stages" in names
        lead = (1 if client_axis else 0) + (1 if in_stages else 0)
        core = _core_spec(names, _shape(leaf), lead, placement, axes, fsdp)
        lead_spec: List[Any] = []
        if client_axis:
            lead_spec.append(_client_axis_spec(placement, mesh))
        if in_stages:
            lead_spec.append(None)   # scanned reps axis
        return tuple(lead_spec + core)

    return _map_with_names(one, params)


def state_specs(state: Any, mesh: MeshConfig, *, placement: str):
    """The placement of each leaf of a federated train state: the client
    axis on every leaf but the scalar ones (the step counter, which the
    port keeps on the host as a Python int)."""
    axes = dict(zip(mesh.axes, mesh.shape))

    def one(names, leaf):
        shape = _shape(leaf)
        if len(shape) == 0:
            return ()
        in_stages = "stages" in names
        lead = 1 + (1 if in_stages else 0)
        core = _core_spec(names, shape, lead, placement, axes,
                          placement == "client_replicated")
        lead_spec: List[Any] = [_client_axis_spec(placement, mesh)]
        if in_stages:
            lead_spec.append(None)
        return tuple(lead_spec + core)

    return _map_with_names(one, state)


def _generic_spec(shape: Sequence[int], mesh: MeshConfig) -> tuple:
    """Greedy axis assignment for caches/batches: pod/data left→right (batch
    and sequence dims), model right→left (feature dims)."""
    spec: List[Optional[Any]] = [None] * len(shape)
    axes = list(zip(mesh.axes, mesh.shape))
    fwd = [a for a in axes if a[0] in ("pod", "data")]
    bwd = [a for a in axes if a[0] == "model"]
    used = set()
    for name, size in fwd:
        for i, s in enumerate(shape):
            if i not in used and spec[i] is None and _divisible(s, size):
                spec[i] = name
                used.add(i)
                break
    for name, size in bwd:
        for i in range(len(shape) - 1, -1, -1):
            if i not in used and spec[i] is None and _divisible(shape[i], size):
                spec[i] = name
                used.add(i)
                break
    return tuple(spec)


def cache_specs(caches: Any, mesh: MeshConfig):
    """The placement of each decode cache leaf (kv rings, recurrent and
    conv states).  Leaves have a leading scanned reps axis (kept unsharded)
    then [B, ...].  KV rings [reps, B, S, hkv, hd] shard B over data and S
    over model, which keeps attention local to each shard."""
    axes = dict(zip(mesh.axes, mesh.shape))

    def one(names, leaf):
        full = _shape(leaf)
        if len(full) <= 1:
            return ()
        shape = full[1:]
        if len(full) == 5:                      # kv ring [B, S, hkv, hd]
            b_spec = "data" if _divisible(shape[0], axes["data"]) else None
            s_spec = "model" if _divisible(shape[1], axes["model"]) else None
            return (None, b_spec, s_spec, None, None)
        return (None,) + _generic_spec(shape, mesh)

    return _map_with_names(one, caches)


def batch_specs(batch: Any, mesh: MeshConfig, *, client_axis: bool = False,
                placement: str = "client_sharded"):
    """The placement of each input batch leaf: federated train batches
    lead with [M, per_client, ...], serve batches with [B, ...]."""
    data = dict(zip(mesh.axes, mesh.shape))["data"]

    def one(names, leaf):
        shape = _shape(leaf)
        if len(shape) == 0:
            return ()
        if not client_axis:
            return _generic_spec(shape, mesh)
        rest: List[Any] = [None] * (len(shape) - 1)
        if placement in ("client_sharded", "client_pure"):
            return (_client_axis_spec(placement, mesh), *rest)
        # dp_within_client: clients on "model", batch on "data";
        # client_replicated: [M, per_client, ...] → per_client over data
        lead = (_client_axis_spec(placement, mesh)
                if placement == "dp_within_client"
                else "pod" if mesh.multi_pod else None)
        if len(shape) >= 2 and _divisible(shape[1], data):
            rest[0] = "data"
        return (lead, *rest)

    return _map_with_names(one, batch)


def placed_bytes(tree, specs, mesh: MeshConfig) -> int:
    """The bytes one device of ``mesh`` holds of ``tree`` placed by
    ``specs``: each tensor leaf's bytes over the product of the sizes of
    the axes its placement names."""
    from repro_torch.core.tree_util import tree_leaves, tree_structure
    sizes = dict(zip(mesh.axes, mesh.shape))
    total = 0
    for leaf, spec in zip(tree_leaves(tree),
                          tree_structure(tree).flatten_up_to(specs)):
        if not torch.is_tensor(leaf):
            continue
        split = 1
        for entry in spec:
            for ax in (entry if isinstance(entry, tuple) else (entry,)):
                split *= sizes.get(ax, 1) if ax is not None else 1
        total += leaf.numel() * leaf.element_size() // split
    return total


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
