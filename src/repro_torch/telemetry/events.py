"""The structured event stream: a schema-versioned, append-only JSONL log
(counterpart of ``repro/telemetry/events.py``; the schema is the same, so
each package's validator accepts the other's streams).

Every run writes one :class:`EventLog`: the first line of every process
segment is a ``run_start`` event carrying the schema version and the
embedded experiment spec, and each later line is one event with a
monotonic per-segment ``seq``, a wall-clock ``ts``, and the keys
:data:`REQUIRED_KEYS` demands for its type.  Every event is a single
``write`` of a full line flushed to the OS; the log opens in *append* mode
(a resumed or rolled-back run extends the same stream, retried rounds
appear as distinct events keyed by ``(step, retry)``), and a partial tail
line left by a crash is truncated away on the next open, so the stream
always parses.  ``python -m repro_torch.telemetry.validate`` checks all of
this afterwards; ``python -m repro_torch.launch.metrics`` renders it.
"""
from __future__ import annotations

import json
import os
import time

EVENT_SCHEMA_VERSION = 1

# event type → keys every event of that type must carry (on top of the
# envelope keys "event", "seq", "ts" stamped by EventLog.emit).  Adding a
# type or key is backward-compatible; removing or renaming one bumps
# EVENT_SCHEMA_VERSION.
REQUIRED_KEYS = {
    "run_start": ("schema", "experiment"),
    "metrics": ("step",),
    "comm": ("step", "round", "elems", "reductions", "bytes_wire"),
    "span": ("name", "dur_s"),
    "rollback": ("step", "retry", "bad_loss"),
    "retry_budget_exhausted": ("step", "retry"),
    "clients_screened": ("step", "round", "clients"),
    "deadline": ("step", "round", "deadline", "arrivals", "quorum",
                 "extensions"),
    "quorum_miss": ("step", "round", "extensions", "deadline"),
    "checkpoint": ("step", "path"),
    "hlo_collectives": ("bytes_by_dtype",),
    "bench": ("name", "us_per_step"),
    "note": ("text",),
    "run_end": ("step", "status"),
}


class TelemetryError(ValueError):
    """A malformed event or an invalid event stream."""


def _repair_tail(path: str) -> None:
    """Truncate a partial (unterminated) tail line left by a crash, so
    that what survives is always a sequence of complete lines."""
    try:
        size = os.path.getsize(path)
    except OSError:
        return
    if size == 0:
        return
    with open(path, "rb+") as f:
        f.seek(-1, os.SEEK_END)
        if f.read(1) == b"\n":
            return
        # walk back to the last newline (or the file start) and cut there
        f.seek(0)
        keep = f.read().rfind(b"\n") + 1
        f.truncate(keep)


class EventLog:
    """Append-only JSONL event writer (see the module docstring).

    ``meta``: extra fields of the segment's ``run_start`` event; pass the
    experiment's JSON dict as ``experiment=`` so that the stream describes
    itself (the validate CLI reconciles ``comm`` events against the
    analytic bytes model rebuilt from it).
    """

    def __init__(self, path: str, **meta):
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        _repair_tail(path)
        self.path = path
        self._f = open(path, "a", encoding="utf-8")
        self._seq = 0
        meta.setdefault("experiment", None)
        self.emit("run_start", schema=EVENT_SCHEMA_VERSION, **meta)

    def emit(self, event: str, **fields) -> dict:
        """Write one event line; returns the full record."""
        missing = [k for k in REQUIRED_KEYS.get(event, ())
                   if k not in fields]
        if missing:
            raise TelemetryError(f"event {event!r} missing required keys "
                                 f"{missing}")
        rec = {"event": event, "seq": self._seq,
               "ts": round(time.time(), 3), **fields}  # analysis: ignore[L301] event timestamp
        self._seq += 1
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        return rec

    def close(self) -> None:
        if not self._f.closed:
            self._f.flush()
            os.fsync(self._f.fileno())
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_events(path: str) -> list:
    """Parse an event stream into a list of dicts (raises
    :class:`TelemetryError` on an unparseable or unterminated line)."""
    out = []
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f):
            if not line.endswith("\n"):
                raise TelemetryError(
                    f"{path}:{i + 1}: unterminated tail line (crashed "
                    f"writer? EventLog repairs this on the next open)")
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError as e:
                raise TelemetryError(f"{path}:{i + 1}: {e}") from None
    return out
