"""Validate a telemetry event stream: ``python -m
repro_torch.telemetry.validate`` (counterpart of
``repro/telemetry/validate.py``, with every check and message of it).

Checks that a JSONL event stream parses, is schema-valid (known event
types, required keys, supported schema version, monotonic per-segment
``seq``), and, with reconciliation on (the default), that every ``comm``
event's reported wire bytes match the analytic bytes model of
``repro_torch.federation.compression`` rebuilt from the stream's embedded
experiment spec.  Straggler ``deadline``/``quorum_miss`` events are always
checked: deadlines finite positive, per-segment rounds strictly
increasing, arrivals >= quorum on every accepted round, and every
quorum_miss carrying at least one extension.  ``--expect`` asserts that
given event types occurred (e.g. ``rollback`` on a faulty run);
``--trend-decreasing KEY`` asserts a metrics series (e.g. ``upd_norm/u``,
the hypergradient-estimation proxy) is finite and trends down over the
run.  Either package's streams validate here.

    python -m repro_torch.telemetry.validate events.jsonl
    python -m repro_torch.telemetry.validate events.jsonl \
        --expect run_start,metrics,comm --trend-decreasing upd_norm/u
"""
from __future__ import annotations

import argparse
import math
import sys

from repro_torch.telemetry.events import (EVENT_SCHEMA_VERSION,
                                          REQUIRED_KEYS, TelemetryError,
                                          read_events)


def _reconcile_comm(ev: dict, exp_json) -> None:
    """Check one ``comm`` event's bytes against the analytic model rebuilt
    from the embedded experiment (the per-element model of
    ``federation/compression.py``)."""
    from repro_torch.federation.compression import (CompressionSpec,
                                                    wire_bytes_per_elem)
    cp = None
    if exp_json and exp_json.get("compression"):
        d = dict(exp_json["compression"])
        if d.get("sections") is not None:
            d["sections"] = tuple(d["sections"])
        cp = CompressionSpec(**d)
    ec = ev.get("elems_compressed", ev["elems"] if cp is not None else 0)
    ee = ev.get("elems_exact", ev["elems"] - ec)
    wire = (wire_bytes_per_elem(cp, ev.get("block", 256))
            if cp is not None else 4.0)
    expected = ev["reductions"] * (ec * wire + ee * 4.0)
    tol = max(16.0, 0.005 * expected)
    if abs(ev["bytes_wire"] - expected) > tol:
        raise TelemetryError(
            f"comm event (seq {ev['seq']}, round {ev['round']}): reported "
            f"bytes_wire={ev['bytes_wire']} disagrees with the analytic "
            f"model ({expected:.0f} B = {ev['reductions']} reductions x "
            f"({ec} compressed elems x {wire:.4f} B + {ee} exact elems x "
            f"4 B))")


def _check_deadlines(path: str, events: list) -> int:
    """Straggler invariants over ``deadline`` / ``quorum_miss`` events:
    every accepted round reports ``arrivals >= quorum`` (the quorum
    fallback guarantees this even on exhausted extensions), deadlines are
    finite and positive, rounds are strictly increasing within a segment
    (reset at each ``run_start``), and every ``quorum_miss`` carries
    ``extensions >= 1``.  Returns the number of deadline events checked."""
    checked = 0
    last_round = None
    for i, ev in enumerate(events):
        kind = ev.get("event")
        if kind == "run_start":
            last_round = None
        elif kind == "deadline":
            dl = ev["deadline"]
            if not (isinstance(dl, (int, float)) and math.isfinite(dl)
                    and dl > 0):
                raise TelemetryError(
                    f"{path}: line {i + 1}: deadline event round "
                    f"{ev['round']}: deadline {dl!r} is not finite "
                    f"positive")
            if ev["arrivals"] < ev["quorum"]:
                raise TelemetryError(
                    f"{path}: line {i + 1}: deadline event round "
                    f"{ev['round']}: arrivals {ev['arrivals']} < quorum "
                    f"{ev['quorum']} — an accepted round must meet quorum")
            if last_round is not None and ev["round"] <= last_round:
                raise TelemetryError(
                    f"{path}: line {i + 1}: deadline event round "
                    f"{ev['round']} not increasing within its segment "
                    f"(prev {last_round})")
            last_round = ev["round"]
            checked += 1
        elif kind == "quorum_miss":
            if ev["extensions"] < 1:
                raise TelemetryError(
                    f"{path}: line {i + 1}: quorum_miss event round "
                    f"{ev['round']}: extensions {ev['extensions']} < 1 — "
                    f"a miss implies at least one deadline extension")
    return checked


def _trend_decreasing(events: list, key: str) -> None:
    """Assert the metrics series ``key`` is finite and trends down.  The
    STORM sequences update with the ENTERING momentum, so step 1's update
    norm is exactly 0 — leading zeros are dropped before the comparison."""
    vals = [e[key] for e in events
            if e.get("event") == "metrics" and key in e]
    if not vals:
        raise TelemetryError(f"no metrics events carry {key!r}")
    bad = [v for v in vals if not math.isfinite(v)]
    if bad:
        raise TelemetryError(f"{key!r} has non-finite values: {bad[:4]}")
    while vals and vals[0] == 0.0:
        vals = vals[1:]
    if len(vals) < 2:
        raise TelemetryError(f"{key!r} has {len(vals)} nonzero values — "
                             f"too few to establish a trend")
    if not vals[-1] < vals[0]:
        raise TelemetryError(f"{key!r} does not trend down: first nonzero "
                             f"{vals[0]:.6g} -> last {vals[-1]:.6g}")


def validate_events(path: str, *, reconcile: bool = True,
                    expect: tuple = (), trend_decreasing: tuple = ()) -> dict:
    """Validate one stream; returns a summary dict, raises
    :class:`TelemetryError` on the first violation."""
    events = read_events(path)
    if not events:
        raise TelemetryError(f"{path}: empty event stream")
    by_type: dict = {}
    segments = 0
    exp_json = None
    last_seq = None
    reconciled = 0
    for i, ev in enumerate(events):
        kind = ev.get("event")
        if kind not in REQUIRED_KEYS:
            raise TelemetryError(f"{path}: line {i + 1}: unknown event "
                                 f"type {kind!r}")
        missing = [k for k in REQUIRED_KEYS[kind] if k not in ev]
        if missing or "seq" not in ev or "ts" not in ev:
            raise TelemetryError(f"{path}: line {i + 1}: event {kind!r} "
                                 f"missing keys {missing or ['seq/ts']}")
        if kind == "run_start":
            if ev["schema"] > EVENT_SCHEMA_VERSION:
                raise TelemetryError(
                    f"{path}: line {i + 1}: schema {ev['schema']} is newer "
                    f"than supported ({EVENT_SCHEMA_VERSION})")
            segments += 1
            exp_json = ev.get("experiment") or exp_json
            last_seq = ev["seq"]
        else:
            if segments == 0:
                raise TelemetryError(f"{path}: line {i + 1}: event before "
                                     f"any run_start")
            if ev["seq"] <= last_seq:
                raise TelemetryError(
                    f"{path}: line {i + 1}: seq {ev['seq']} not monotonic "
                    f"within its segment (prev {last_seq})")
            last_seq = ev["seq"]
        by_type[kind] = by_type.get(kind, 0) + 1
        if kind == "comm" and reconcile:
            if exp_json is None:
                raise TelemetryError(
                    f"{path}: line {i + 1}: cannot reconcile comm bytes — "
                    f"no embedded experiment in any run_start")
            _reconcile_comm(ev, exp_json)
            reconciled += 1
    deadlines_checked = _check_deadlines(path, events)
    for kind in expect:
        if kind not in by_type:
            raise TelemetryError(f"{path}: expected at least one "
                                 f"{kind!r} event — none found "
                                 f"(saw {sorted(by_type)})")
    for key in trend_decreasing:
        _trend_decreasing(events, key)
    return {"events": len(events), "segments": segments,
            "by_type": by_type, "comm_reconciled": reconciled,
            "deadlines_checked": deadlines_checked}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="+", help="event stream JSONL files")
    ap.add_argument("--no-reconcile", action="store_true",
                    help="skip the comm-bytes reconciliation against the "
                         "analytic model")
    ap.add_argument("--expect", default="",
                    help="comma-separated event types that must occur")
    ap.add_argument("--trend-decreasing", action="append", default=[],
                    metavar="KEY",
                    help="metrics key that must be finite and trend down "
                         "(repeatable), e.g. upd_norm/u")
    ns = ap.parse_args(argv)
    expect = tuple(t for t in ns.expect.split(",") if t)
    failed = False
    for path in ns.paths:
        try:
            s = validate_events(path, reconcile=not ns.no_reconcile,
                                expect=expect,
                                trend_decreasing=tuple(ns.trend_decreasing))
        except (TelemetryError, OSError, KeyError) as e:
            print(f"FAIL {path}: {e}")
            failed = True
            continue
        counts = " ".join(f"{k}={v}" for k, v in sorted(s["by_type"].items()))
        print(f"OK {path}: {s['events']} events, {s['segments']} segment(s), "
              f"{s['comm_reconciled']} comm event(s) reconciled, "
              f"{s['deadlines_checked']} deadline event(s) checked "
              f"[{counts}]")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
