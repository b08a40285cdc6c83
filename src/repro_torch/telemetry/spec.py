"""Declarative telemetry policy, the spec half of ``repro_torch.telemetry``
(counterpart of ``repro/telemetry/spec.py``).

:class:`TelemetrySpec` rides ``Experiment.telemetry`` (an optional layer,
like ``CompressionSpec``): JSON-round-trippable, ``edit()``-sweepable,
validated by ``Experiment.validate``.  It selects which in-band metric
groups the fused engine computes beside every step, and where the
structured event stream lands.  With the layer absent every trajectory is
bit for bit a telemetry-free build's, and the step's metrics dict carries
no metric group.

Metric groups (``metrics=None`` resolves to every group the experiment's
other layers make applicable):

* ``"norms"``: per-sequence l2 update norms (x, y, u runs; the u-sequence
  norm is the hypergradient-estimation proxy of AggITD, arxiv 2302.04969)
  plus momentum norms for momentum-carrying specs;
* ``"drift"``: per-sequence client-drift dispersion, the participants'
  rms distance to their mean local iterate *before* averaging (the non-IID
  heterogeneity term of the linear-speedup analysis, arxiv 2302.05412);
* ``"compression"``: error-feedback residual norm and the quantization
  round-trip error of the communicated buffers (needs
  ``Experiment.compression``);
* ``"health"``: staleness histogram, recomputed health-screen verdicts and
  the round's injected fault masks (needs participation sampling, faults,
  or robustness);
* ``"stragglers"``: the elastic round's effective and next deadline,
  arrival and quorum counts, extension count and the arrival-time
  histogram (needs ``Experiment.stragglers``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

METRIC_GROUPS = ("norms", "drift", "compression", "health", "stragglers")


class TelemetrySpec(NamedTuple):
    """Telemetry policy of one run (see the module docstring).

    ``sink``: path of the JSONL event stream (relative paths resolve
    against the working directory); ``None`` lets the train CLI pick
    (``events.jsonl`` next to the checkpoints, or in the cwd).
    ``metrics``: in-band metric groups, a subset of :data:`METRIC_GROUPS`;
    ``None`` = every applicable group, ``()`` = events only (no in-band
    metrics).  ``trace``: emit wall-clock phase spans as ``span`` events.
    """
    sink: Optional[str] = None
    metrics: Optional[Tuple[str, ...]] = None
    trace: bool = True


def resolve_metric_groups(metrics, *, compressed: bool = False,
                          guarded: bool = False,
                          sampled: bool = False,
                          straggled: bool = False) -> tuple:
    """The metric groups a run computes: an explicit ``metrics`` tuple
    passes through as it is (validated), ``None`` resolves to every group
    the run's layers make applicable."""
    if metrics is None:
        groups = ("norms", "drift")
        if compressed:
            groups += ("compression",)
        if guarded or sampled:
            groups += ("health",)
        if straggled:
            groups += ("stragglers",)
        return groups
    unknown = set(metrics) - set(METRIC_GROUPS)
    if unknown:
        raise ValueError(f"unknown telemetry metric groups "
                         f"{sorted(unknown)} (known: {METRIC_GROUPS})")
    return tuple(metrics)
