"""Define an Experiment, build it, train, checkpoint, resume — on the port
(counterpart of ``examples/declarative_experiment.py``).

The whole scenario is one serializable spec (``repro_torch.api.Experiment``);
the run is rebuilt from the checkpoint's embedded copy with no re-specified
knob, and the state is loaded into the rebuilt run's own tensors.

    PYTHONPATH=src python -m repro_torch.examples.declarative_experiment \\
        [--device cuda|cpu]

The device defaults to ``cuda``; without a card the run stops unless
``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import tempfile

import torch

from repro_torch.api import build
from repro_torch.api.spec import (AlgorithmSpec, ExecutionSpec, Experiment,
                                  ProblemSpec, ScheduleSpec)
from repro_torch.checkpoint import (load_checkpoint, load_experiment,
                                    save_checkpoint)


def main(argv=None) -> float:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    device = ap.parse_args(argv).device

    exp = Experiment(
        algorithm=AlgorithmSpec("fedbioacc"),            # Algorithm 2 (STORM)
        problem=ProblemSpec(arch="mamba2-130m", reduced=True, num_clients=4,
                            per_client=1, seq_len=32),
        execution=ExecutionSpec(fuse_storm=True, fuse_oracles=True),
        schedule=ScheduleSpec(steps=8, local_steps=2, neumann_q=2))

    run = build(Experiment.from_json(exp.to_json()), device=device)
    state = run.init(torch.Generator(device=run.device).manual_seed(0))
    data = torch.Generator().manual_seed(1)
    for _ in range(4):                                   # interrupted halfway
        state, _ = run.step(state, run.batch_fn(data))
    with tempfile.TemporaryDirectory() as ckpt:
        save_checkpoint(ckpt, state, {"step": 4}, experiment=run.spec)

        # resume: the checkpoint alone rebuilds the exact run
        run2 = build(load_experiment(ckpt), device=device)
        state = load_checkpoint(ckpt, run2.init(
            torch.Generator(device=run2.device).manual_seed(0)))
    for _ in range(4, run2.steps):
        state, _ = run2.step(state, run2.batch_fn(data))
    loss = run2.eval_fn(state)
    print(f"resumed and finished: val loss {loss:.4f} after {run2.steps} "
          f"steps ({run2.spec.algorithm.name} on {run2.spec.problem.arch}, "
          f"spec v{run2.spec.version}, {run2.device})")
    return loss


if __name__ == "__main__":
    main()
