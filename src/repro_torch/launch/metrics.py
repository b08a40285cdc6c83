"""Summarize a telemetry event stream: ``python -m
repro_torch.launch.metrics`` (counterpart of ``repro/launch/metrics.py``).

The reader half of ``repro_torch.telemetry``: renders the JSONL event
stream a run wrote (``launch.train --telemetry-sink``; the reference's
streams read the same) as

* a run summary (segments, rounds, final loss, wall-clock by phase,
  rollback and screening counts);
* a per-communication-round table (step, wire bytes, val loss, the
  u-sequence norms and client drift at that round): ``--table``;
* the communication-efficiency curve the paper's plots are built on:
  cumulative wire MB vs round vs val loss: ``--comm``;
* the last N metric records as they are: ``--tail N`` (point it at a live
  sink to follow a run).

    python -m repro_torch.launch.metrics events.jsonl
    python -m repro_torch.launch.metrics events.jsonl --table --comm
    python -m repro_torch.launch.metrics events.jsonl --tail 5
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.telemetry.events import read_events


def summarize(events: list) -> dict:
    by_type: dict = {}
    spans: dict = {}
    for ev in events:
        by_type.setdefault(ev.get("event"), []).append(ev)
        if ev.get("event") == "span":
            spans[ev["name"]] = spans.get(ev["name"], 0.0) + ev["dur_s"]
    losses = [(ev["step"], ev["val_loss"])
              for ev in by_type.get("metrics", ()) if "val_loss" in ev]
    comm = by_type.get("comm", ())
    out = {
        "segments": len(by_type.get("run_start", ())),
        "events": len(events),
        "counts": {k: len(v) for k, v in sorted(by_type.items())},
        "rounds_communicated": len({ev["round"] for ev in comm}),
        "wire_bytes_total": sum(ev["bytes_wire"] for ev in comm),
        "rollbacks": len(by_type.get("rollback", ())),
        "clients_screened": sorted({c
                                    for ev in by_type.get(
                                        "clients_screened", ())
                                    for c in ev["clients"]}),
        "span_seconds": {k: round(v, 3) for k, v in sorted(spans.items())},
        "final_val_loss": losses[-1][1] if losses else None,
        "status": (by_type["run_end"][-1]["status"]
                   if by_type.get("run_end") else "(no run_end — live or "
                                                  "crashed run)"),
    }
    return out


def round_table(events: list) -> list:
    """One row per communication round: the comm event joined with the
    in-band metrics of its step."""
    # a step can carry two metrics events (in-band + eval) — merge them;
    # rollback retries overwrite, so a row reflects the surviving attempt
    merged: dict = {}
    for ev in events:
        if ev.get("event") == "metrics":
            merged.setdefault(ev["step"], {}).update(ev)
    rows = []
    for ev in events:
        if ev.get("event") != "comm":
            continue
        m = merged.get(ev["step"], {})
        rows.append({"round": ev["round"], "step": ev["step"],
                     "retry": ev.get("retry", 0),
                     "bytes_wire": ev["bytes_wire"],
                     "val_loss": m.get("val_loss"),
                     "upd_norm/u": m.get("upd_norm/u"),
                     "mom_norm/u": m.get("mom_norm/u"),
                     "drift/x": m.get("drift/x")})
    return rows


def comm_curve(events: list) -> list:
    """Cumulative wire MB vs round vs the nearest val loss — the
    communication-efficiency curve."""
    losses = sorted((ev["step"], ev["val_loss"])
                    for ev in events
                    if ev.get("event") == "metrics" and "val_loss" in ev)
    rows, cum = [], 0
    for ev in events:
        if ev.get("event") != "comm":
            continue
        cum += ev["bytes_wire"]
        loss = None
        for s, l in losses:           # last loss at or before this step
            if s <= ev["step"]:
                loss = l
        rows.append({"round": ev["round"], "step": ev["step"],
                     "cum_wire_mb": round(cum / 2 ** 20, 3),
                     "val_loss": loss})
    return rows


def _fmt(v):
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.5g}"
    return str(v)


def _print_table(rows: list) -> None:
    if not rows:
        print("(no comm events)")
        return
    cols = list(rows[0])
    widths = [max(len(c), *(len(_fmt(r[c])) for r in rows)) for c in cols]
    print("  ".join(c.ljust(w) for c, w in zip(cols, widths)))
    for r in rows:
        print("  ".join(_fmt(r[c]).ljust(w) for c, w in zip(cols, widths)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path", help="event stream JSONL (see repro_torch.telemetry)")
    ap.add_argument("--table", action="store_true",
                    help="per-communication-round table")
    ap.add_argument("--comm", action="store_true",
                    help="cumulative wire-MB vs round vs val-loss curve")
    ap.add_argument("--tail", type=int, default=0, metavar="N",
                    help="print the last N metrics records verbatim")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable output (one JSON object)")
    ns = ap.parse_args(argv)
    events = read_events(ns.path)
    if ns.tail:
        for ev in [e for e in events if e.get("event") == "metrics"][-ns.tail:]:
            print(json.dumps(ev))
        return 0
    out = {"summary": summarize(events)}
    if ns.table:
        out["rounds"] = round_table(events)
    if ns.comm:
        out["comm_curve"] = comm_curve(events)
    if ns.json:
        print(json.dumps(out, indent=1))
        return 0
    s = out["summary"]
    print(f"{ns.path}: {s['events']} events, {s['segments']} segment(s), "
          f"status={s['status']}")
    print(f"  rounds communicated: {s['rounds_communicated']}, total wire: "
          f"{s['wire_bytes_total'] / 2 ** 20:.2f} MB, rollbacks: "
          f"{s['rollbacks']}, screened clients: "
          f"{s['clients_screened'] or '-'}")
    if s["final_val_loss"] is not None:
        print(f"  final val_loss: {s['final_val_loss']:.6g}")
    if s["span_seconds"]:
        top = sorted(s["span_seconds"].items(), key=lambda kv: -kv[1])
        print("  wall by phase: "
              + ", ".join(f"{k}={v:.3f}s" for k, v in top[:6]))
    if ns.table:
        print()
        _print_table(out["rounds"])
    if ns.comm:
        print()
        _print_table(out["comm_curve"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
