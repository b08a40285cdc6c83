"""Federated bilevel training CLI of the PyTorch port (counterpart of
``repro/launch/train.py``), a thin adapter over ``repro_torch.api``.

Every run is a declarative :class:`repro_torch.api.Experiment`: flags are
edits of a base spec (the built-in defaults, ``--experiment exp.json``, or
the spec embedded in a checkpoint).  The spec is embedded in every
checkpoint, so a resume needs no re-specified flags.

    # flags build a spec (the unfused tree path unless --fuse-storm)
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \\
        --reduced --algo fedbioacc --steps 100 --clients 4 \\
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

    # supervised: a crash restarts the run from the latest checkpoint
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --experiment experiments/fedbioacc_faulty.json --ckpt-dir D \\
        --ckpt-every 2 --max-restarts 2

    # the event stream, then its checks and its summary
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --experiment experiments/fedbioacc_telemetry.json \\
        --telemetry-sink ev.jsonl
    PYTHONPATH=src python -m repro_torch.telemetry.validate ev.jsonl
    PYTHONPATH=src python -m repro_torch.launch.metrics ev.jsonl --table

The run goes on the card (``--device cuda``, the default; without a card it
stops unless ``--device cpu`` is given).  The device is a run knob, never
part of the spec: a checkpoint written on the card resumes on the CPU and
the other way round.  One JSON line ``{"step", "val_loss", "wall_s"}`` is
printed per log interval (and one at the last step); with stragglers the
line also carries that step's round: ``arrivals`` (the clients that beat
the deadline) and ``deadline`` (the effective one, in simulated seconds);
with faults, the clients the step's round injected (``nan``,
``byzantine``) and, with the health screen, those its reductions screened
out (``screened``).  Those extra fields are the port's own; the event
stream carries the reference's records.

With ``experiment.telemetry`` (or ``--telemetry-sink EVENTS.jsonl``, which
sets it) the run writes the reference's JSONL event stream
(``repro_torch.telemetry``): the banners as ``note`` events, the in-band
``metrics`` of every communication and log step, ``clients_screened``,
``deadline`` and ``quorum_miss`` events read off them, one ``comm`` event
a communication round from the analytic bytes plan, the ``eval`` span,
``rollback``, ``retry_budget_exhausted``, ``checkpoint`` and a ``run_end``
whose status is ``ok``, ``diverged`` or ``retry_budget_exhausted``.  The
stream lands at ``telemetry.sink``, else at ``events.jsonl`` in the
checkpoint (or resumed) directory, else in the working directory; a
resumed run appends a new segment.  Read it with ``python -m
repro_torch.telemetry.validate`` and ``python -m
repro_torch.launch.metrics``.

Fault tolerance (``repro_torch.federation.faults``): with
``experiment.robustness`` set, the loop snapshots last-known-good states
(host copies, ``robustness.ring`` of them) at the reference's log steps
and rolls back on a non-finite or spiking eval loss, printing
``{"rollback_to", "retry", "bad_loss"}`` and redrawing the retried rounds'
batches and fault masks, until ``retry_budget`` is spent: then it writes
a diagnostic checkpoint to ``<ckpt-dir>/diagnostic`` and exits non-zero,
naming the round.  Without it a non-finite eval loss does the same at
once.  ``--max-restarts N`` supervises the run in a subprocess and
resumes it from the latest checkpoint after a crash, up to N times
(``--crash-at-step`` hard-exits, code 17, after that step of a fresh run,
to test it).

A spec with ``execution.mesh [d, k]`` (or ``--mesh d,k``) runs over a
``[data, model]`` mesh of ``d·k`` ranks: run outside a process group, the
CLI starts them itself (``torch.multiprocessing`` spawn, a gloo world over
a ``FileStore`` in a temporary directory; on the card every rank uses
``cuda:0``, whose kernels the CLI builds once before it spawns), each rank
running this same CLI; rank 0 alone prints the lines, writes the event
stream and the checkpoints (the whole state, gathered), and a rank's
failure stops them all with its exit code.  Stragglers, faults with the
guarded means, rollback and in-band telemetry run there as off a mesh:
every rank decides each round alike on the host, each rank's
``RollbackGuard`` snapshots and restores its own blocks on the loss every
rank is given (the ranks check with one all-gather per evaluation that
they decided alike), and ``--max-restarts`` supervises the spawned world
as one run.

    PYTHONPATH=src python -m repro_torch.launch.train \
        --experiment experiments/fedbioacc_sharded_overlap.json --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train \
        --experiment experiments/fedbioacc_faulty.json --mesh 4,2 --device cpu

A checkpoint holds the raw train state (a ``FlatState``, or the unfused
path's pytree train state), the embedded spec
and the metadata ``step``, ``arch``, ``retries`` (the rollbacks taken) and
``data_gen``: the exact state of the CPU ``torch.Generator`` that draws
the batches, restored on resume (the reference records its JAX batch key
instead, so a reference checkpoint cannot be resumed by this CLI).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import zlib

import torch
import torch.distributed as dist

from repro_torch.api import (Experiment, RollbackError, RollbackGuard,
                             SpecError, build)
from repro_torch.api.build import checked, resolve_device
from repro_torch.api.spec import ARCH_NAMES
from repro_torch.checkpoint import (checkpoint_metadata, load_checkpoint,
                                    load_experiment, save_checkpoint)
from repro_torch.telemetry import EventLog, comm_plan, phase, round_bytes

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
              "log_every", "max_restarts", "restart_backoff", "crash_at_step",
              "device"}


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
                    help="flat-buffer substrate with fused updates")
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
    ap.add_argument("--max-restarts", type=int, default=0,
                    help="supervise the run in a subprocess and resume it "
                         "from the latest --ckpt-dir checkpoint after a "
                         "crash, up to N times (requires --ckpt-dir)")
    ap.add_argument("--restart-backoff", type=float, default=1.0,
                    help="base seconds between restart attempts (doubles "
                         "each retry)")
    ap.add_argument("--crash-at-step", type=int, default=0,
                    help="testing: hard-exit (code 17) after this step of a "
                         "fresh run (inert on --resume, so a supervised "
                         "restart runs to completion)")
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


_RESTART_WAIT_CAP = 60.0   # seconds: a supervised restart never sleeps longer


def _restart_wait(backoff: float, attempt: int, token: str = "") -> float:
    """Bounded exponential backoff with deterministic jitter: the wait
    ``backoff · 2**attempt`` is capped at :data:`_RESTART_WAIT_CAP`, then
    spread by a ±25 % factor from ``crc32(token:attempt)`` (reproducible,
    and different across checkpoint directories, so that supervisors do
    not restart in lockstep), the result capped again."""
    base = min(backoff * (2 ** attempt), _RESTART_WAIT_CAP)
    frac = zlib.crc32(f"{token}:{attempt}".encode()) % 1000 / 999.0
    return min(base * (0.75 + 0.5 * frac), _RESTART_WAIT_CAP)


def _supervise(ns, raw_argv: list) -> list:
    """--max-restarts: run the train loop in a child process (the same
    flags, ``--device`` included, the supervisor's own stripped), resuming
    from the latest --ckpt-dir checkpoint after each crash (non-zero exit)
    until it succeeds or the restart budget runs out."""
    if not ns.ckpt_dir:
        raise SystemExit("--max-restarts requires --ckpt-dir (restarts "
                         "resume from the latest checkpoint)")
    base = raw_argv
    for flag in ("--max-restarts", "--restart-backoff"):
        base = _strip_flag(base, flag)
    for attempt in range(ns.max_restarts + 1):
        child = list(base)
        if attempt:
            # the crash knob fires only on fresh runs, but a retry that
            # crashed before its first checkpoint is fresh
            child = _strip_flag(child, "--crash-at-step")
            if os.path.exists(os.path.join(ns.ckpt_dir, "manifest.json")):
                child = _strip_flag(child, "--resume")
                child += ["--resume", ns.ckpt_dir]
        rc = subprocess.call([sys.executable, "-m",
                              "repro_torch.launch.train", *child])
        if rc == 0:
            return []
        if attempt < ns.max_restarts:
            wait = _restart_wait(ns.restart_backoff, attempt,
                                 ns.ckpt_dir or "")
            print(f"run crashed (exit {rc}); restart "
                  f"{attempt + 1}/{ns.max_restarts} in {wait:.1f}s",
                  flush=True)
            time.sleep(wait)
    raise SystemExit(f"run still crashing after {ns.max_restarts} "
                     f"restarts (last exit {rc}) — inspect "
                     f"{ns.ckpt_dir}/diagnostic or the traceback above")


def _gen_state(gen: torch.Generator) -> str:
    return bytes(gen.get_state().tolist()).hex()


def _set_gen_state(gen: torch.Generator, hexstate: str) -> None:
    gen.set_state(torch.tensor(list(bytes.fromhex(hexstate)),
                               dtype=torch.uint8))


def _diagnostic_checkpoint(ns, save, step: int) -> None:
    """Write the offending state beside the regular checkpoints, so that a
    failed run can be inspected (never over the last good checkpoint);
    ``save(path, metadata)`` writes the run's state."""
    if not ns.ckpt_dir:
        return
    d = os.path.join(ns.ckpt_dir, "diagnostic")
    save(d, {"step": int(step), "diagnostic": True})
    print(f"diagnostic checkpoint -> {d}", flush=True)


_DECISIONS = ("healthy", "rollback", "retry budget exhausted")


def _agree(shard, t: int, decision: str) -> None:
    """On a mesh, check that every rank took the same rollback decision at
    the evaluation of step ``t`` (one all-gather of the decision): each
    rank's guard sees the same broadcast loss, so they must agree, and a
    rank that rolled back alone would run on from another state."""
    if shard is None:
        return
    code = torch.tensor([_DECISIONS.index(decision)], dtype=torch.int64)
    every = torch.empty(dist.get_world_size(), dtype=torch.int64)
    dist.all_gather_into_tensor(every, code)
    if not bool((every == code).all()):
        raise RuntimeError(
            f"step {t}: the ranks' rollback decisions differ: "
            f"{[_DECISIONS[int(c)] for c in every]}")


def _line_fields(metrics) -> dict:
    """The JSON line's fields of a step's round, from the engine's decision
    record (``metrics["decision"]``): with stragglers the clients that beat
    the deadline (``arrivals``) and the effective ``deadline``; with
    faults the clients the round injected (``nan``, ``byzantine``) and,
    with the health screen, those its reductions screened out
    (``screened``).  The port's own; the event stream carries the
    reference's records."""
    dec = metrics.get("decision", {})
    out = {}
    if "arrivals" in dec:
        out.update(arrivals=dec["arrivals"].nonzero().flatten().tolist(),
                   deadline=dec["deadline"])
    if "faults" in dec:
        _, nan, byz = dec["faults"]
        out.update(nan=nan.nonzero().flatten().tolist(),
                   byzantine=byz.nonzero().flatten().tolist())
    if "screened" in dec:
        out["screened"] = dec["screened"]
    return out


def _host_metrics(metrics) -> dict:
    """The step's in-band metrics as JSON scalars and lists, rounded as the
    reference rounds them and in its order (its jitted step returns the
    dict with sorted keys); the ``screened`` verdict vector is read
    separately, and ``decision`` is the engine's record, not a metric."""
    out = {}
    for k, v in sorted(metrics.items()):
        if k in ("step", "screened", "decision"):
            continue
        a = torch.as_tensor(v).detach().cpu()
        out[k] = (round(float(a), 8) if a.dim() == 0
                  else [round(x, 8) for x in a.reshape(-1).tolist()])
    return out


def _event_log(exp, ns, start: int):
    """The run's :class:`EventLog` (None without ``experiment.telemetry``):
    at ``telemetry.sink``, or ``events.jsonl`` in the checkpoint (or
    resumed) directory, or in the working directory; a resumed run appends
    its segment to the same stream."""
    if exp.telemetry is None:
        return None
    ckdir = ns.ckpt_dir or ns.resume
    sink = exp.telemetry.sink or (os.path.join(ckdir, "events.jsonl")
                                  if ckdir else "events.jsonl")
    return EventLog(sink, experiment=json.loads(exp.to_json()),
                    start_step=start)


def _round_events(emit, metrics, exp, t: int, retry: int) -> None:
    """The events read off a communication step's in-band metrics:
    ``clients_screened`` (with the health group and the screen),
    ``deadline`` and, after an extension, ``quorum_miss`` (with the
    stragglers group; a warm-up round, deadline 0, emits none)."""
    r = t // exp.schedule.local_steps
    screened = metrics.get("screened")
    if (screened is not None and exp.robustness is not None
            and exp.robustness.screen):
        idx = torch.nonzero(torch.as_tensor(screened) > 0).flatten()
        if idx.numel():
            emit("clients_screened", step=t, round=r, retry=retry,
                 clients=idx.tolist())
    if exp.stragglers is None or "deadline" not in metrics:
        return
    dl = round(float(metrics["deadline"]), 6)
    ext = int(metrics["extensions"])
    if dl <= 0:
        return
    emit("deadline", step=t, round=r, retry=retry, deadline=dl,
         deadline_next=round(float(metrics["deadline_next"]), 6),
         arrivals=int(metrics["arrivals"]), quorum=int(metrics["quorum"]),
         extensions=ext,
         arrival_hist=[int(round(x)) for x in
                       metrics["arrival_hist"].tolist()])
    if ext > 0:
        emit("quorum_miss", step=t, round=r, retry=retry, extensions=ext,
             deadline=dl)


def _rank_main(rank: int, world: int, store: str, argv: list,
               history_path: str) -> None:
    """One rank of a mesh run: join the gloo world, run this CLI (rank 0
    alone prints), and leave the world."""
    from repro_torch.launch.mesh import init_ranks
    init_ranks(rank, world, store)
    torch.set_num_threads(max(1, torch.get_num_threads() // world))
    if rank:
        sys.stdout = open(os.devnull, "w")
    history = main(argv)
    if rank == 0:
        with open(history_path, "w") as fh:
            json.dump(history, fh)
    dist.barrier()
    dist.destroy_process_group()


def _spawn_ranks(exp, ns, argv: list) -> list:
    """Run a mesh spec outside a process group: start its ``d·k`` ranks
    (spawned processes over a ``FileStore``), wait for them, and return
    rank 0's history; the first rank to fail stops the others, and its exit
    code is the run's.  On the card the kernels are built once here, so
    that the ranks only load them."""
    mesh = exp.execution.mesh
    if mesh == "production":
        from repro_torch.launch.mesh import make_production_mesh
        try:
            make_production_mesh()
        except RuntimeError as e:
            raise SystemExit(str(e))
    if resolve_device(ns.device).type == "cuda":
        from repro_torch.kernels.build import build_all
        build_all(("storm3", "quantpack"))
    from repro_torch.launch.mesh import spawn_ranks
    world = mesh[0] * mesh[1]
    tmp = tempfile.mkdtemp(prefix="repro_torch_mesh_")
    hist = os.path.join(tmp, "history.json")
    rc = spawn_ranks(_rank_main, world, os.path.join(tmp, "store"),
                     (argv, hist))
    history = []
    if not rc:
        with open(hist) as fh:
            history = json.load(fh)
    shutil.rmtree(tmp, ignore_errors=True)
    if rc:
        raise SystemExit(rc)
    return history


def main(argv=None):
    ns = _parser().parse_args(argv)
    if ns.max_restarts > 0:
        return _supervise(ns, list(argv) if argv is not None
                          else sys.argv[1:])
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

    if exp.execution.mesh is not None and not dist.is_initialized():
        try:
            exp = checked(exp)
        except (SpecError, NotImplementedError) as e:
            raise SystemExit(str(e))
        return _spawn_ranks(exp, ns, list(argv) if argv is not None
                            else sys.argv[1:])
    try:
        run = build(exp, device=ns.device)
    except (SpecError, NotImplementedError) as e:
        raise SystemExit(str(e))
    exp = run.spec
    shard = run.shard
    rank0 = shard is None or dist.get_rank() == 0

    # every line the CLI reports goes through the event stream (with
    # experiment.telemetry) and stdout renders the same records; on a mesh
    # rank 0 alone writes them
    log = _event_log(exp, ns, start) if rank0 else None
    tracing = log is not None and exp.telemetry.trace

    def emit(event, render=None, **fields):
        if log is not None:
            log.emit(event, **fields)
        if render is not None:
            print(render, flush=True)

    def end(status: str, t: int) -> None:
        if log is not None:
            log.emit("run_end", step=t, status=status)
            log.close()

    banner = (f"arch={run.model_cfg.name} family={run.model_cfg.family} "
              f"algo={exp.algorithm.name} device={run.device}")
    emit("note", render=banner, text=banner)
    pspec = run.participation
    if pspec is not None:
        M = exp.problem.num_clients
        if pspec.trace_path is not None:
            detail = f"log={pspec.trace_path}"
        elif pspec.sampler == "trace":
            detail = f"rate={pspec.availability_rate}"
        else:
            detail = f"m={pspec.clients_per_round or M}/{M}"
        banner = f"participation: {pspec.sampler} {detail} seed={pspec.seed}"
        emit("note", render=banner, text=banner)
    sg = exp.stragglers
    if sg is not None:
        banner = (f"stragglers: policy={sg.late_policy} "
                  f"deadline={sg.deadline} quorum={sg.quorum} "
                  f"over_provision={sg.over_provision} tail={sg.tail}")
        emit("note", render=banner, text=banner)

    guard = (RollbackGuard(exp.robustness) if exp.robustness is not None
             else None)
    state = run.init(torch.Generator(device=run.device)
                     .manual_seed(exp.schedule.seed))
    data_gen = torch.Generator().manual_seed(exp.schedule.seed)
    if start and shard is not None:
        # rank 0 reads the whole state and sends every rank its blocks
        from repro_torch.sharding.rules import scatter_state, whole_like
        whole = (load_checkpoint(ns.resume,
                                 whole_like(run.step.spec, state, shard))
                 if rank0 else None)
        state = scatter_state(run.step.spec, whole, state, shard)
        del whole
    elif start:
        # copied in place into init's tensors: no second copy of the state
        state = load_checkpoint(ns.resume, state)
    if start:
        _set_gen_state(data_gen, md["data_gen"])
        if guard is not None:
            guard.retries = int(md.get("retries", 0))
        banner = f"resumed from {ns.resume} @ step {start}"
        emit("note", render=banner, text=banner)

    # the analytic per-round bytes plan (the fused engine's layout): one
    # reconcilable `comm` event a communication round
    flat_spec = getattr(run.step, "spec", None)
    plan = (comm_plan(flat_spec, run.step.aspec, exp.compression)
            if log is not None and flat_spec is not None else None)
    in_band = bool(run.step.telemetry_groups)
    local_steps = exp.schedule.local_steps
    retry = lambda: guard.retries if guard is not None else 0  # noqa: E731
    history = []
    t0 = time.perf_counter()  # analysis: ignore[L301] driver timing
    t = start
    def save(path: str, meta: dict) -> None:
        """Checkpoint ``state`` (on a mesh, gathered on rank 0, which writes
        it; the other ranks wait for the write)."""
        whole = state
        if shard is not None:
            from repro_torch.sharding.rules import gather_state
            whole = gather_state(run.step.spec, state, shard)
        if rank0:
            save_checkpoint(path, whole, meta, experiment=exp)
        del whole
        if shard is not None:
            dist.barrier()

    while t < exp.schedule.steps:
        state, metrics = run.step(state,
                                  run.place_batch(run.batch_fn(data_gen)))
        t += 1
        is_comm = t % local_steps == 0
        # the reference's evaluation steps; the port also prints the last
        # step's loss, which feeds nothing and emits no event
        is_log = t % ns.log_every == 0 or t == start + 1
        if log is not None and in_band and (is_comm or is_log):
            # host-converted at communication and log steps only
            emit("metrics", step=t, retry=retry(), **_host_metrics(metrics))
            if is_comm:
                _round_events(emit, metrics, exp, t, retry())
        if plan is not None and is_comm:
            rb_ev = round_bytes(plan, t // local_steps)
            if rb_ev is not None:
                emit("comm", step=t, retry=retry(), **rb_ev)
        if is_log or t == exp.schedule.steps:
            if tracing and is_log:
                with phase("eval", log, step=t):
                    loss = run.eval_fn(state)
            else:
                loss = run.eval_fn(state)
            if guard is not None and is_log:
                try:
                    rb = guard.observe(t, state, data_gen, loss)
                except RollbackError as e:
                    _agree(shard, t, "retry budget exhausted")
                    emit("retry_budget_exhausted", step=t, retry=retry(),
                         bad_loss=float(loss))
                    end("retry_budget_exhausted", t)
                    _diagnostic_checkpoint(ns, save, t)
                    raise SystemExit(f"round {t}: {e}")
                _agree(shard, t, "healthy" if rb is None else "rollback")
                if rb is not None:
                    t, state, _ = rb
                    # else the tuple keeps this state on the device after
                    # the next step has replaced it
                    del rb
                    emit("rollback",
                         render=json.dumps({"rollback_to": t,
                                            "retry": guard.retries,
                                            "bad_loss": loss}),
                         step=t, retry=guard.retries, bad_loss=float(loss))
                    continue
            elif guard is None and not math.isfinite(loss):
                end("diverged", t)
                _diagnostic_checkpoint(ns, save, t)
                raise SystemExit(
                    f"non-finite eval loss ({loss}) at round {t}: training "
                    f"diverged — inspect the diagnostic checkpoint, enable "
                    f"robustness guards (experiment.robustness), or lower "
                    f"the learning rates")
            rec = {"step": t, "val_loss": loss,
                   "wall_s": round(time.perf_counter() - t0, 3)}  # analysis: ignore[L301] driver timing
            history.append({**rec, **_line_fields(metrics)})
            if is_log:
                emit("metrics", render=json.dumps(history[-1]), **rec)
            else:
                print(json.dumps(history[-1]), flush=True)
        if ns.ckpt_dir and t % ns.ckpt_every == 0:
            # the raw state and the embedded spec: --resume rebuilds the
            # structure from the spec alone; the generator's state makes
            # the batches that follow the uninterrupted run's, and the
            # retry count those after a rollback
            save(ns.ckpt_dir, {"step": t, "arch": run.model_cfg.name,
                               "retries": retry(),
                               "data_gen": _gen_state(data_gen)})
            emit("checkpoint",
                 render=f"checkpoint @ step {t} -> {ns.ckpt_dir}",
                 step=t, path=ns.ckpt_dir)
        if ns.crash_at_step and start == 0 and t == ns.crash_at_step:
            print(f"crash-at-step: hard exit after step {t}", flush=True)
            os._exit(17)
    end("ok", t)
    return history


if __name__ == "__main__":
    main()
