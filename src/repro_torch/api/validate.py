"""Validate committed Experiment spec files (counterpart of
``repro/api/validate.py``).

    PYTHONPATH=src python -m repro_torch.api.validate experiments/*.json

Each file must parse as a versioned ``repro_torch.api.Experiment`` AND pass
:meth:`Experiment.validate` (the reference's checks); whether the port runs
the spec yet is :func:`repro_torch.api.build`'s question, not this one.
Exit code 1 if any file fails; prints one line per file, as the
reference's checker does.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.api.spec import Experiment, SpecError


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="+", metavar="EXP.json")
    args = ap.parse_args(argv)
    failed = 0
    for path in args.paths:
        try:
            exp = Experiment.load(path).validate()
        except (SpecError, OSError) as e:
            print(f"FAIL {path}: {e}")
            failed += 1
            continue
        mesh = exp.execution.mesh
        guards = ""
        if exp.faults is not None:
            fl = exp.faults
            guards += (f", faults[drop={fl.dropout_rate} nan={fl.nan_rate} "
                       f"byz={fl.byzantine_rate}]")
        if exp.robustness is not None:
            rb = exp.robustness
            guards += (f", robust[{rb.aggregator}"
                       f"{' screened' if rb.screen else ''} "
                       f"retries={rb.retry_budget}]")
        if exp.compression is not None:
            cp = exp.compression
            parts = ([cp.quant] if cp.quant else []) \
                + ([f"topk={cp.topk_frac}"
                    f"{'' if cp.error_feedback else ' no-ef'}"]
                   if cp.topk_frac else [])
            guards += f", compress[{' '.join(parts)}]"
        print(f"OK   {path}: {exp.algorithm.name} on {exp.problem.arch}"
              f"{' (reduced)' if exp.problem.reduced else ''}, "
              f"M={exp.problem.num_clients}, steps={exp.schedule.steps}"
              + (f", mesh={mesh}" if mesh is not None else "") + guards)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
