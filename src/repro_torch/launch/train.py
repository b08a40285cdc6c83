"""Federated bilevel training CLI of the PyTorch port (counterpart of
``repro/launch/train.py``), a thin adapter over ``repro_torch.api``.

Every run is a declarative :class:`repro_torch.api.Experiment`: flags are
edits of a base spec (the built-in defaults, ``--experiment exp.json``, or
the spec embedded in a checkpoint).  The spec is embedded in every
checkpoint, so a resume needs no re-specified flags.

    # flags build a spec (the port runs the fused engine: --fuse-storm)
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \\
        --reduced --algo fedbioacc --fuse-storm --steps 100 --clients 4 \\
        --per-client 2 --seq 128

    # a committed spec runs as it is; flags override single fields
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --experiment experiments/fedbioacc.json [--steps 500]

    # checkpoints every --ckpt-every steps; --resume continues the exact run
    # from the embedded spec, and a spec flag that contradicts it is refused
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --experiment experiments/fedbioacc_straggler.json --ckpt-dir D \\
        --ckpt-every 2
    PYTHONPATH=src python -m repro_torch.launch.train --resume D

The run goes on the card (``--device cuda``, the default; without a card it
stops unless ``--device cpu`` is given).  The device is a run knob, never
part of the spec: a checkpoint written on the card resumes on the CPU and
the other way round.  One JSON line ``{"step", "val_loss", "wall_s"}`` is
printed per log interval; with stragglers the line also carries that step's
round: ``arrivals`` (the clients that beat the deadline) and ``deadline``
(the effective one, in simulated seconds).

A checkpoint holds the raw train state (``FlatState``), the embedded spec
and the metadata ``step``, ``arch``, ``retries`` (0: the port has no
rollback yet) and ``data_gen``: the exact state of the CPU
``torch.Generator`` that draws the batches, restored on resume (the
reference records its JAX batch key instead, so a reference checkpoint
cannot be resumed by this CLI).  A non-finite validation loss writes a
diagnostic checkpoint to ``<ckpt-dir>/diagnostic`` and exits non-zero,
naming the round.  ``--crash-at-step`` hard-exits (code 17) after that
step of a fresh run, for testing resumes.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time

import torch

from repro_torch.api import Experiment, SpecError, build
from repro_torch.api.spec import ARCH_NAMES
from repro_torch.checkpoint import (checkpoint_metadata, load_checkpoint,
                                    load_experiment, save_checkpoint)

# CLI dest → dotted Experiment path, for every flag that sets one spec field
# (the reference's table).  Flags with coupled semantics (--seed,
# --client-weights, --mesh, --comm-every) are handled in apply_overrides.
_FLAG_PATHS = {
    "algo": "algorithm.name",
    "arch": "problem.arch",
    "reduced": "problem.reduced",
    "clients": "problem.num_clients",
    "per_client": "problem.per_client",
    "seq": "problem.seq_len",
    "steps": "schedule.steps",
    "local_steps": "schedule.local_steps",
    "lr_x": "schedule.lr_x",
    "lr_y": "schedule.lr_y",
    "lr_u": "schedule.lr_u",
    "hierarchy_period": "schedule.hierarchy_period",
    "neumann_q": "schedule.neumann_q",
    "fuse_storm": "execution.fuse_storm",
    "fuse_oracles": "execution.fuse_oracles",
    "overlap": "execution.overlap",
    "scatter_comm": "execution.scatter_comm",
    "participation": "participation.sampler",
    "clients_per_round": "participation.clients_per_round",
    "availability_seed": "participation.seed",
    "availability_rate": "participation.availability_rate",
    "availability_trace": "participation.trace_path",
    "stale_discount": "participation.stale_discount",
    "telemetry_sink": "telemetry.sink",
}
# run knobs: never part of the spec or the trajectory
_RUN_KNOBS = {"experiment", "resume", "ckpt_dir", "ckpt_every",
              "log_every", "crash_at_step", "device"}


def _parser() -> argparse.ArgumentParser:
    S = argparse.SUPPRESS   # spec flags: only what was set reaches the spec
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--experiment", default=None, metavar="EXP.json",
                    help="base Experiment spec (JSON); other flags override "
                         "single fields")
    ap.add_argument("--resume", default=None, metavar="CKPT_DIR",
                    help="rebuild the run from the checkpoint's embedded "
                         "experiment.json and continue it; spec flags must "
                         "match the embedded spec")
    ap.add_argument("--arch", choices=sorted(ARCH_NAMES), default=S)
    ap.add_argument("--reduced", action="store_true", default=S,
                    help="train the reduced same-family variant")
    ap.add_argument("--algo", default=S, help="registered algorithm name")
    ap.add_argument("--steps", type=int, default=S)
    ap.add_argument("--clients", type=int, default=S)
    ap.add_argument("--local-steps", type=int, default=S)
    ap.add_argument("--per-client", type=int, default=S)
    ap.add_argument("--seq", type=int, default=S)
    ap.add_argument("--lr-x", type=float, default=S)
    ap.add_argument("--lr-y", type=float, default=S)
    ap.add_argument("--lr-u", type=float, default=S)
    ap.add_argument("--seed", type=int, default=S,
                    help="sets both problem.data_seed and schedule.seed")
    ap.add_argument("--hierarchy-period", type=int, default=S,
                    help="k>0: pod-local averaging, cross-pod only every "
                         "k-th round")
    ap.add_argument("--neumann-q", type=int, default=S,
                    help="Neumann series terms for the local-lower "
                         "hyper-gradient (fedbio_local/fedbioacc_local)")
    ap.add_argument("--comm-every", default=S, metavar="SEC=K[,SEC=K]",
                    help="per-section communication cadence, e.g. 'u=2'")
    ap.add_argument("--participation",
                    choices=["full", "uniform", "weighted", "trace"],
                    default=S, help="client sampler")
    ap.add_argument("--clients-per-round", type=int, default=S,
                    help="m for the uniform/weighted samplers (0 = all "
                         "clients; implies --participation uniform when set)")
    ap.add_argument("--availability-seed", type=int, default=S,
                    help="seed of the per-round availability process (masks "
                         "depend only on seed + round)")
    ap.add_argument("--availability-rate", type=float, default=S,
                    help="trace sampler: per-round client up-probability")
    ap.add_argument("--availability-trace", default=S, metavar="PATH.json",
                    help="recorded availability log replayed through the "
                         "trace sampler; implies --participation trace")
    ap.add_argument("--client-weights", default=S,
                    help="comma-separated per-client data sizes (required by "
                         "--participation weighted; also weights the means)")
    ap.add_argument("--stale-discount", type=float, default=S,
                    help="alpha^staleness discount for returning clients' "
                         "contributions (1.0 = off)")
    ap.add_argument("--fuse-storm", action="store_true", default=S,
                    help="flat-buffer substrate with fused updates (the "
                         "engine the port runs)")
    ap.add_argument("--fuse-oracles", action="store_true", default=S,
                    help="share one linearization across the oracle "
                         "directions")
    ap.add_argument("--mesh", default=S, metavar="DATA,MODEL",
                    help="shard the flat substrate over a (data, model) "
                         "device mesh, or 'production'")
    ap.add_argument("--overlap", action="store_true", default=S,
                    help="overlap the variable all-reduce with the "
                         "new-iterate oracle (needs --mesh)")
    ap.add_argument("--scatter-comm", action="store_true", default=S,
                    help="with --mesh: reduce-scatter + all-gather instead "
                         "of one all-reduce")
    ap.add_argument("--telemetry-sink", default=S, metavar="EVENTS.jsonl",
                    help="write the structured event stream here (enables "
                         "experiment.telemetry)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--crash-at-step", type=int, default=0,
                    help="testing: hard-exit (code 17) after this step of a "
                         "fresh run (inert on --resume)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; not part of the spec")
    return ap


def apply_overrides(base: Experiment, ov: dict) -> Experiment:
    """Apply the flags that were passed as spec edits (the only way flags
    reach the run), with the reference's coupled-flag semantics."""
    edits = {}
    for dest, path in _FLAG_PATHS.items():
        if dest in ov:
            edits[path] = ov[dest]
    if "seed" in ov:
        edits["problem.data_seed"] = ov["seed"]
        edits["schedule.seed"] = ov["seed"]
    if "client_weights" in ov:
        edits["participation.client_weights"] = tuple(
            float(v) for v in ov["client_weights"].split(","))
    if "mesh" in ov:
        m = ov["mesh"]
        if m == "production":
            edits["execution.mesh"] = "production"
        else:
            try:
                edits["execution.mesh"] = tuple(int(v) for v in m.split(","))
            except ValueError:
                raise SystemExit(f"--mesh expects DATA,MODEL (e.g. 4,2) or "
                                 f"'production'; got {m!r}")
    if "comm_every" in ov:
        try:
            edits["schedule.comm_every"] = {
                k: int(v) for k, v in
                (pair.split("=") for pair in ov["comm_every"].split(","))}
        except ValueError:
            raise SystemExit(f"--comm-every expects SEC=K[,SEC=K] (e.g. "
                             f"u=2); got {ov['comm_every']!r}")
    exp = base.edit(**edits).normalize()
    if exp.participation.sampler == "full" \
            and exp.participation.stale_discount != 1.0:
        print("stale_discount ignored: full participation has no "
              "stale clients (pick a sampler)")
    return exp


def _resolve_experiment(args, overrides: dict) -> tuple[Experiment, int]:
    """(experiment, start_step) from --resume / --experiment / defaults,
    with the flag overrides applied."""
    if args.resume:
        base = load_experiment(args.resume)
        if base is None:
            raise SystemExit(
                f"--resume {args.resume}: no experiment.json in the "
                f"checkpoint — re-specify the run with --experiment/flags "
                f"instead")
        exp = apply_overrides(base, overrides)
        if exp != base.normalize():
            raise SystemExit(
                f"--resume {args.resume}: flags contradict the embedded "
                f"experiment spec (passed: "
                f"{sorted('--' + k.replace('_', '-') for k in overrides)}). "
                f"Resume continues the EXACT run; drop the conflicting "
                f"flags or start a fresh run with --experiment")
        return exp, int(checkpoint_metadata(args.resume)["step"])
    if args.experiment:
        return apply_overrides(Experiment.load(args.experiment),
                               overrides), 0
    if "arch" not in overrides:
        raise SystemExit("--arch is required (or pass --experiment/--resume)")
    # the CLI's baseline: nothing reduced unless asked
    base = Experiment().edit(**{"problem.reduced": False})
    return apply_overrides(base, overrides), 0


def _strip_flag(argv: list, flag: str) -> list:
    """``argv`` without ``flag`` and its value (``--f v`` or ``--f=v``)."""
    out, i = [], 0
    while i < len(argv):
        if argv[i] == flag:
            i += 2
        elif argv[i].startswith(flag + "="):
            i += 1
        else:
            out.append(argv[i])
            i += 1
    return out


def _gen_state(gen: torch.Generator) -> str:
    return bytes(gen.get_state().tolist()).hex()


def _set_gen_state(gen: torch.Generator, hexstate: str) -> None:
    gen.set_state(torch.tensor(list(bytes.fromhex(hexstate)),
                               dtype=torch.uint8))


def _diagnostic_checkpoint(ns, state, step: int, exp) -> None:
    """Write the offending state beside the regular checkpoints, so that a
    failed run can be inspected (never over the last good checkpoint)."""
    if not ns.ckpt_dir:
        return
    d = os.path.join(ns.ckpt_dir, "diagnostic")
    save_checkpoint(d, state, {"step": int(step), "diagnostic": True},
                    experiment=exp)
    print(f"diagnostic checkpoint -> {d}", flush=True)


def main(argv=None):
    ns = _parser().parse_args(argv)
    # SUPPRESS-defaulted flags exist on the namespace only when passed
    overrides = {k: v for k, v in vars(ns).items() if k not in _RUN_KNOBS}
    exp, start = _resolve_experiment(ns, overrides)
    md = checkpoint_metadata(ns.resume) if start else {}
    if start and md.get("data_gen") is None:
        raise SystemExit(
            f"--resume {ns.resume}: the checkpoint records no 'data_gen' "
            f"(the state of the generator that draws the batches; a "
            f"checkpoint of the JAX package records its batch key instead), "
            f"so the run cannot continue exactly — load its state through "
            f"repro_torch.checkpoint.load_checkpoint instead")

    try:
        run = build(exp, device=ns.device)
    except (SpecError, NotImplementedError) as e:
        raise SystemExit(str(e))
    exp = run.spec

    print(f"arch={run.model_cfg.name} family={run.model_cfg.family} "
          f"algo={exp.algorithm.name} device={run.device}", flush=True)
    pspec = run.participation
    if pspec is not None:
        M = exp.problem.num_clients
        if pspec.trace_path is not None:
            detail = f"log={pspec.trace_path}"
        elif pspec.sampler == "trace":
            detail = f"rate={pspec.availability_rate}"
        else:
            detail = f"m={pspec.clients_per_round or M}/{M}"
        print(f"participation: {pspec.sampler} {detail} seed={pspec.seed}",
              flush=True)
    sg = exp.stragglers
    if sg is not None:
        print(f"stragglers: policy={sg.late_policy} deadline={sg.deadline} "
              f"quorum={sg.quorum} over_provision={sg.over_provision} "
              f"tail={sg.tail}", flush=True)

    state = run.init(torch.Generator(device=run.device)
                     .manual_seed(exp.schedule.seed))
    data_gen = torch.Generator().manual_seed(exp.schedule.seed)
    if start:
        # copied in place into init's tensors: no second copy of the state
        state = load_checkpoint(ns.resume, state)
        _set_gen_state(data_gen, md["data_gen"])
        print(f"resumed from {ns.resume} @ step {start}", flush=True)

    history = []
    t0 = time.perf_counter()
    for t in range(start + 1, exp.schedule.steps + 1):
        state, metrics = run.step(state, run.batch_fn(data_gen))
        if t % ns.log_every == 0 or t == start + 1 or t == exp.schedule.steps:
            loss = run.eval_fn(state)
            if not math.isfinite(loss):
                _diagnostic_checkpoint(ns, state, t, exp)
                raise SystemExit(
                    f"non-finite eval loss ({loss}) at round {t}: training "
                    f"diverged — inspect the diagnostic checkpoint or lower "
                    f"the learning rates")
            history.append({"step": t, "val_loss": loss,
                            "wall_s": round(time.perf_counter() - t0, 3)})
            if sg is not None:
                history[-1].update(
                    arrivals=metrics["arrivals"].nonzero().flatten().tolist(),
                    deadline=metrics["deadline"])
            print(json.dumps(history[-1]), flush=True)
        if ns.ckpt_dir and t % ns.ckpt_every == 0:
            # the raw state and the embedded spec: --resume rebuilds the
            # structure from the spec alone; the generator's state makes
            # the batches that follow the uninterrupted run's
            save_checkpoint(ns.ckpt_dir, state,
                            {"step": t, "arch": run.model_cfg.name,
                             "retries": 0, "data_gen": _gen_state(data_gen)},
                            experiment=exp)
            print(f"checkpoint @ step {t} -> {ns.ckpt_dir}", flush=True)
        if ns.crash_at_step and start == 0 and t == ns.crash_at_step:
            print(f"crash-at-step: hard exit after step {t}", flush=True)
            os._exit(17)
    return history


if __name__ == "__main__":
    main()
