"""Collective statistics shared by the dry run and the static verifier
(counterpart of ``repro/launch/hlo_stats.py``).

The reference parses a compiled module's text for its collective ops.  The
port has no compiled module: its collectives are the ``torch.distributed``
calls a step issues, which ``analysis.collectives.record_collectives``
observes as ``(hlo op, result bytes by dtype)`` pairs (the dtype keys are
HLO tokens: ``f32``, ``bf16``, ``s8``, ...).  :func:`collective_bytes`
sums such a list into the reference's record, so the dry run and the
verifier's wire audit read one byte model.
"""
from __future__ import annotations

from typing import Dict, Iterable, Mapping, Tuple

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")


def collective_bytes(ops: Iterable[Tuple[str, Mapping[str, int]]]
                     ) -> Dict[str, object]:
    """Sum the result bytes of every collective in ``ops``, each an
    ``(op, {dtype token: bytes})`` pair in issue order.

    The record is the reference's: per-op ``bytes`` and ``counts`` (the
    five ops of the reference, and any other op met, such as
    ``collective-broadcast``, under its own name), ``bytes_by_dtype`` (the
    split a compressed spec is audited on), ``total_bytes``, and ``ops``,
    one ``{"op", "bytes", "dtypes"}`` entry per collective."""
    out = dict.fromkeys(_COLLECTIVES, 0)
    counts = dict.fromkeys(_COLLECTIVES, 0)
    by_dtype: Dict[str, int] = {}
    per_op = []
    for op, nbytes in ops:
        total = sum(nbytes.values())
        out[op] = out.get(op, 0) + total
        counts[op] = counts.get(op, 0) + 1
        for dt, b in nbytes.items():
            by_dtype[dt] = by_dtype.get(dt, 0) + b
        per_op.append({"op": op, "bytes": total, "dtypes": sorted(nbytes)})
    return {"bytes": out, "counts": counts, "bytes_by_dtype": by_dtype,
            "total_bytes": sum(out.values()), "ops": per_op}
