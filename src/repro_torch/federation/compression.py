"""Declarative compressed-communication policies + the analytic bytes model
(the port's own copy of ``repro/federation/compression.py``).

The paper's entire pitch is communication complexity; this module makes the
per-round bytes a spec knob.  A :class:`CompressionSpec` rides
``Experiment.compression`` (JSON round-trip, ``edit()``-sweepable) and is
lowered by ``sequences.make_engine`` into the substrate-local
``optim.flat.CompressCfg`` that ``client_mean_masked`` consumes — the same
layering as ``RobustnessSpec`` → ``RobustCfg``, keeping the substrate
import-free of this package.

Two composing mechanisms, both per ``block``-sized tile:

* **quantization** (``quant``): what every client sends — and, on the
  sharded path, the dtype the ``psum`` / ``psum_scatter`` collective
  actually moves — is cast to bf16, or int8 with one f32 scale per tile.
* **top-k sparsification** (``topk_frac``): each client keeps only the
  top ``ceil(topk_frac · block)`` entries of every tile by magnitude and
  accumulates what it dropped in a per-client **error-feedback** buffer
  (added back into the next round's send), carried on
  ``FlatState.ef`` — f32 buffers shaped exactly like the communicated
  buffers, so sharding rules, participation masking and checkpointing
  inherit it for free and compressed runs stay resume-bit-exact.
  Per-tile (block-balanced) selection is a deliberate variant of global
  top-k: it is identical under every mesh partitioning (tiles are the
  shard quantum) and matches the quantizer's scale granularity.

The analytic bytes model below is the JAX package's, whose benchmarks and
dryrun HLO stats use it; the port runs no sharded collective yet, so only
the uplink number describes a port run.  Two numbers matter:

* **uplink** bytes/element — what one client logically ships to the server
  per communicated element (values + top-k indices + scales).  This is the
  federated-bytes headline: top-k shrinks it by ~1/topk_frac.
* **wire** bytes/element — what one SPMD all-reduce moves per element.
  Partial sums are dense, so sparsity does NOT shrink a psum; only the
  narrow dtype does (int8 ≈ 3.94x at block=256 — strictly < 4x because of
  the per-tile f32 scale exchange).  Backend caveat, audited by the dryrun
  HLO check: the host CPU backend has no native bf16 reduce and re-widens
  bf16 all-reduces to f32 (TPU keeps them bf16); int8 collectives are
  integer and no backend promotes them.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

QUANTS = (None, "bf16", "int8")

_VALUE_BYTES = {None: 4.0, "bf16": 2.0, "int8": 1.0}
_SCALE_BYTES = 4.0      # one f32 scale per tile (int8 only)
_INDEX_BYTES = 2.0      # int16 intra-tile index per surviving top-k entry


class CompressionSpec(NamedTuple):
    """Compressed comm policy of an experiment (``Experiment.compression``).

    ``quant``: ``None`` | ``"bf16"`` | ``"int8"`` — reduction dtype.
    ``topk_frac``: fraction of each tile's entries every client keeps
    (0 disables sparsification; must be < 1).
    ``error_feedback``: accumulate the dropped mass per client and re-send
    it next round (the convergence-critical half of top-k — disabling it
    is allowed but is the documented divergence row of the benchmarks).
    ``sections``: section names to compress (``None`` = every communicated
    section; private sections are never compressed — validated).
    """
    quant: Optional[str] = None
    topk_frac: float = 0.0
    error_feedback: bool = True
    sections: Optional[Tuple[str, ...]] = None


def uplink_bytes_per_elem(spec: CompressionSpec, block: int) -> float:
    """Analytic per-client uplink bytes per communicated element.

    Exact f32 is 4.0.  Top-k ships ``topk_frac`` of the entries, each as a
    (value, int16 intra-tile index) pair; int8 adds one f32 scale per tile
    (4/block per element).  bf16 halves the value bytes."""
    v = _VALUE_BYTES[spec.quant]
    s = _SCALE_BYTES / block if spec.quant == "int8" else 0.0
    f = float(spec.topk_frac or 0.0)
    if f > 0:
        return f * (v + _INDEX_BYTES) + s
    return v + s


def wire_bytes_per_elem(spec: CompressionSpec, block: int) -> float:
    """Bytes per element ONE SPMD all-reduce moves for a compressed run.

    Dense in the reduction dtype — per-shard partial sums of sparsified
    sends are dense, so only ``quant`` shrinks the collective (this is the
    number the dryrun HLO collective stats must agree with)."""
    v = _VALUE_BYTES[spec.quant]
    s = _SCALE_BYTES / block if spec.quant == "int8" else 0.0
    return v + s
