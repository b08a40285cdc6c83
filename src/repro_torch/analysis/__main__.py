"""CLI of the static verifier — see the package docstring.

    python -m repro_torch.analysis --all experiments/ --lint src/repro_torch
    python -m repro_torch.analysis --experiment experiments/fedbioacc.json \
        --device cpu

The reference's flags and lines, plus ``--device`` (``cuda`` by default,
``cpu`` for the CPU).  A spec with a mesh (and a compressed spec's wire
probe) runs its collective audit on spawned gloo ranks
(``repro_torch.analysis.verify``); lint alone needs no device.  Exit code 0
when every spec verifies and the lint is clean, 1 otherwise.
"""
from __future__ import annotations

import argparse
import glob
import os
import sys
from typing import List


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="verify Experiment specs (one recorded step each, no "
                    "training) and lint the source")
    ap.add_argument("--experiment", action="append", default=[],
                    metavar="EXP_JSON", help="verify one spec (repeatable)")
    ap.add_argument("--all", dest="all_dir", metavar="DIR",
                    help="verify every *.json under DIR")
    ap.add_argument("--lint", action="append", default=[], metavar="PATH",
                    help="lint .py files/trees (repeatable)")
    ap.add_argument("--no-hlo", action="store_true",
                    help="skip the communication subprogram's wire audit "
                         "(step and structure checks only)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    specs = list(args.experiment)
    if args.all_dir:
        specs += sorted(glob.glob(os.path.join(args.all_dir, "*.json")))
    if not specs and not args.lint:
        ap.error("nothing to do — pass --experiment/--all and/or --lint")

    from repro_torch.analysis.rules import Finding
    failures: List[Finding] = []
    errors = 0

    if args.lint:
        from repro_torch.analysis.lint import lint_paths
        lf = lint_paths(args.lint)
        failures += lf
        print(f"lint {' '.join(args.lint)}: "
              f"{'OK' if not lf else f'{len(lf)} finding(s)'}", flush=True)

    if specs:
        from repro_torch.analysis.verify import verify_experiment
        from repro_torch.api import Experiment
        bare_cache: dict = {}
        for p in specs:
            try:
                f, notes = verify_experiment(
                    Experiment.load(p), where=p, hlo=not args.no_hlo,
                    bare_cache=bare_cache, device=args.device)
            except Exception as e:      # build/validate/run failure
                errors += 1
                print(f"ERROR {p}: {type(e).__name__}: {e}", flush=True)
                continue
            failures += f
            status = "OK" if not f else f"FAIL ({len(f)} finding(s))"
            print(f"{status} {p}: " + "; ".join(notes), flush=True)

    for f in failures:
        print(f)
    n = len(failures)
    print(f"repro_torch.analysis: {len(specs)} spec(s), "
          f"{n} finding(s), {errors} error(s)")
    return 1 if (n or errors) else 0


if __name__ == "__main__":
    sys.exit(main())
