"""Training CLI of the PyTorch port (counterpart of ``repro/launch/train.py``,
minimal):

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --experiment experiments/fedbioacc.json [--steps N] [--log-every K] \\
        [--device cuda|cpu]

Builds the experiment on the device (``cuda`` by default; without a card the
run stops unless ``--device cpu`` is given), trains, and prints one JSON line
``{"step", "val_loss", "wall_s"}`` per log interval; with stragglers the
line also carries that step's round: ``arrivals`` (the clients that beat
the deadline) and ``deadline`` (the effective one, in simulated seconds),
after a ``stragglers:`` banner.  A non-finite validation loss ends the run
with an error.
"""
from __future__ import annotations

import argparse
import json
import math
import time

import torch

from repro_torch.api import Experiment, build


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--experiment", required=True,
                    help="path of an Experiment JSON spec")
    ap.add_argument("--steps", type=int, default=None,
                    help="override schedule.steps")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None):
    ns = _parser().parse_args(argv)
    exp = Experiment.load(ns.experiment)
    if ns.steps is not None:
        exp = exp.edit(**{"schedule.steps": ns.steps})
    run = build(exp, device=ns.device)
    exp = run.spec
    state = run.init(torch.Generator(device=run.device)
                     .manual_seed(exp.schedule.seed))
    data_gen = torch.Generator().manual_seed(exp.schedule.seed)
    print(f"arch={run.model_cfg.name} algo={exp.algorithm.name} "
          f"device={run.device}", flush=True)
    sg = exp.stragglers
    if sg is not None:
        print(f"stragglers: policy={sg.late_policy} deadline={sg.deadline} "
              f"quorum={sg.quorum} over_provision={sg.over_provision} "
              f"tail={sg.tail}", flush=True)
    history = []
    t0 = time.perf_counter()
    for t in range(1, exp.schedule.steps + 1):
        state, metrics = run.step(state, run.batch_fn(data_gen))
        if t % ns.log_every == 0 or t == 1 or t == exp.schedule.steps:
            loss = run.eval_fn(state)
            history.append({"step": t, "val_loss": loss,
                            "wall_s": round(time.perf_counter() - t0, 3)})
            if sg is not None:
                history[-1].update(
                    arrivals=metrics["arrivals"].nonzero().flatten().tolist(),
                    deadline=metrics["deadline"])
            print(json.dumps(history[-1]), flush=True)
            if not math.isfinite(loss):
                raise SystemExit(f"non-finite validation loss ({loss}) at "
                                 f"step {t}")
    return history


if __name__ == "__main__":
    main()
