"""Per-round analytic communication-bytes plan of a built run (counterpart
of ``repro/telemetry/comm.py``).

One :class:`CommPlan` is derived from the engine's flat layout
(``run.step.spec``), its sequence spec (``run.step.aspec``) and the
experiment's compression policy, with the per-element byte model of
``repro_torch.federation.compression``, so that the ``comm`` events the
train CLI emits every communication round reconcile against it:
``python -m repro_torch.telemetry.validate`` rebuilds the per-element
model from the event stream's embedded experiment and checks every
``comm`` event's ``bytes_wire`` against it.

``elems`` counts the logical elements of each reduction (the padded
section runs of every dtype buffer: one shard chunk's extents ×
``FlatSpec.shards``); ``bytes_wire`` is what one all-reduce of that
payload moves (dense partial sums: only the dtype narrows it),
``bytes_uplink_per_client`` what one participating client ships (top-k
sends only the kept values and their indices).  A section counts at the
rounds its cadence (``Sequence.comm_every``) divides; the model does not
tell a pod-local round from a global one, as the reference's does not.
The port's layout is the reference's, sharded or not, so the integers are
the reference's for every spec the port builds.
"""
from __future__ import annotations

from typing import NamedTuple

F32_BYTES = 4.0


class CommPlan(NamedTuple):
    """Static per-round byte model: ``sections`` is a tuple of
    ``(name, elems, cadence, compressed)`` for every communicated
    sequence; ``reductions`` is 2 for momentum-carrying specs (variables
    and momenta reduce at each communication), 1 otherwise."""
    sections: tuple
    reductions: int
    block: int
    wire_bpe: float
    uplink_bpe: float


def comm_plan(flat_spec, aspec, compression=None) -> CommPlan | None:
    """The run's :class:`CommPlan` (None when nothing is communicated:
    all-private specs)."""
    from repro_torch.federation.compression import (uplink_bytes_per_elem,
                                                    wire_bytes_per_elem)
    from repro_torch.optim.sequences import PRIVATE

    comm = [q for q in aspec.sequences if q.comm != PRIVATE]
    if not comm:
        return None
    csecs: set = set()
    if compression is not None:
        csecs = set(compression.sections
                    or tuple(q.section for q in comm))
    # extents carry section indices into flat_spec.sections and describe
    # one shard chunk: the section's elements are (b - a) × shards
    elems: dict = {}
    for grp in flat_spec.groups:
        for s, a, b in grp.extents:
            name = flat_spec.sections[s]
            elems[name] = elems.get(name, 0) + (b - a) * flat_spec.shards
    block = flat_spec.groups[0].block if flat_spec.groups else 256
    secs = tuple((q.section, elems.get(q.section, 0), q.comm_every,
                  q.section in csecs) for q in comm)
    wire = (wire_bytes_per_elem(compression, block)
            if compression is not None else F32_BYTES)
    uplink = (uplink_bytes_per_elem(compression, block)
              if compression is not None else F32_BYTES)
    return CommPlan(secs, 2 if aspec.has_momentum else 1, block, wire,
                    uplink)


def compressed_chunk_elems(flat_spec, aspec, compression) -> int:
    """Elements of every compressed section in one shard chunk (the whole
    buffers unsharded): the section-extent arithmetic of the byte model,
    for its other readers."""
    from repro_torch.optim.sequences import PRIVATE
    comm = tuple(q.section for q in aspec.sequences if q.comm != PRIVATE)
    csecs = compression.sections or comm
    cids = {i for i, n in enumerate(flat_spec.sections) if n in csecs}
    return sum(b - a for grp in flat_spec.groups
               for s, a, b in grp.extents if s in cids)


def round_bytes(plan: CommPlan, round_idx: int) -> dict | None:
    """The ``comm`` event payload of communication round ``round_idx``
    (``(step + 1) // local_steps`` at a communication step); None when
    every section's cadence skips this round."""
    e_comp = sum(e for _, e, c, comp in plan.sections
                 if round_idx % c == 0 and comp)
    e_exact = sum(e for _, e, c, comp in plan.sections
                  if round_idx % c == 0 and not comp)
    if e_comp + e_exact == 0:
        return None
    r = plan.reductions
    return {
        "round": int(round_idx),
        "elems": e_comp + e_exact,
        "elems_compressed": e_comp,
        "elems_exact": e_exact,
        "reductions": r,
        "block": plan.block,
        "bytes_wire": int(round(r * (e_comp * plan.wire_bpe
                                     + e_exact * F32_BYTES))),
        "bytes_uplink_per_client": int(round(
            r * (e_comp * plan.uplink_bpe + e_exact * F32_BYTES))),
    }
