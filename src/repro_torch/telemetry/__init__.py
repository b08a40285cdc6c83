"""Round-level telemetry of the PyTorch port (counterpart of
``repro/telemetry``): in-band metrics, phase spans, and the structured
event stream of every run.

* :class:`TelemetrySpec`: the declarative policy on
  ``Experiment.telemetry`` (metric groups, sink path, spans);
* :class:`EventLog`: the schema-versioned, append-only JSONL event writer
  the train CLI emits to (the reference's schema, unchanged);
* :func:`phase` / :func:`annotate`: host wall-clock spans (a
  ``torch.profiler.record_function`` range, and an NVTX range on a CUDA
  run) and the engine's device-phase markers;
* :func:`comm_plan` / :func:`round_bytes`: the per-round analytic
  communication-bytes model ``comm`` events carry;
* ``python -m repro_torch.telemetry.validate``: schema validation and
  comm-bytes reconciliation; ``python -m repro_torch.launch.metrics``: the
  summarizer.

The in-band metrics themselves are computed by the fused engine
(``repro_torch.optim.sequences.make_engine(..., telemetry=)``) beside each
step, from its flat buffers, into the step's metrics dict; with the layer
absent the engine computes none, and every trajectory is bit for bit a
telemetry-free build's either way.
"""
from repro_torch.telemetry.comm import CommPlan, comm_plan, round_bytes
from repro_torch.telemetry.events import (EVENT_SCHEMA_VERSION,
                                          REQUIRED_KEYS, EventLog,
                                          TelemetryError, read_events)
from repro_torch.telemetry.spec import (METRIC_GROUPS, TelemetrySpec,
                                        resolve_metric_groups)
from repro_torch.telemetry.trace import annotate, phase
from repro_torch.telemetry.validate import validate_events

__all__ = [
    "CommPlan", "EVENT_SCHEMA_VERSION", "EventLog", "METRIC_GROUPS",
    "REQUIRED_KEYS", "TelemetryError", "TelemetrySpec", "annotate",
    "comm_plan", "phase", "read_events", "resolve_metric_groups",
    "round_bytes", "validate_events",
]
