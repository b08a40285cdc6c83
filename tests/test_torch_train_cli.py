"""The port's spec serialization, spec checker and train CLI against the
reference's (``repro.api.spec.Experiment.to_json``, ``repro.api.validate``,
``repro.launch.train``), and resumes that continue a run bit for bit.

- ``to_json`` writes the reference's bytes for every committed spec, as
  loaded and as normalized; ``python -m repro_torch.api.validate`` prints
  the reference's lines and exit code.
- ``apply_overrides`` builds the reference's spec from the same flags
  (restating ``tests/test_api_spec.py``'s ``test_cli_flags_build_the_same_spec``),
  and ``--resume`` refuses flags that contradict the embedded spec.
- ``--crash-at-step 2`` (a hard exit after the step-2 checkpoint) then
  ``--resume`` ends where the uninterrupted run ends, bit for bit, for the
  reduced ``fedbioacc_straggler.json``: every logged loss, arrival set and
  deadline, and every array of the final checkpoint.
- Through the API, a state saved at step 2 and loaded into a fresh run
  continues bit for bit for the reduced ``fedbioacc_int8_topk.json`` (the
  error feedback), ``fedbioacc_local.json`` (the staleness counters, the
  PRIVATE rows), ``fedbio.json`` and ``fedavg.json``.
- Faults (``experiments/fedbioacc_faulty.json`` cut to 4 clients): a spec
  whose every retry sends NaN rolls back at the reference CLI's steps with
  its retry counts and exits naming its round; a run that rolls back once,
  checkpoints and crashes is resumed by ``--max-restarts`` bit for bit as
  the uninterrupted run, ``retries`` in the metadata; the reference's
  supervisor test on the port; ``_restart_wait`` equal to the reference's.
- The ``participation:`` banner is the reference's (``m=4/8`` for the
  straggler spec: ``Run.participation`` is the spec before
  over-provisioning, as the reference's is; checked against the
  reference's in ``tests/test_torch_straggler_trainer.py``), and a
  non-finite validation loss leaves a diagnostic checkpoint and names the
  round.
"""
import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.api import Experiment as JExperiment  # noqa: E402
from repro.api import validate as jvalidate  # noqa: E402
from repro.checkpoint import save_checkpoint as jsave  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro_torch.api import Experiment, build  # noqa: E402
from repro_torch.api import validate  # noqa: E402
from repro_torch.api.build import Run  # noqa: E402
from repro_torch.checkpoint import (checkpoint_metadata,  # noqa: E402
                                    load_checkpoint, load_experiment,
                                    save_checkpoint)
from repro_torch.core.tree_util import tree_leaves  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from torch_parity import bits  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECS = sorted(glob.glob(os.path.join(ROOT, "experiments", "*.json")))
STRAGGLER = os.path.join(ROOT, "experiments", "fedbioacc_straggler.json")


def _spec(name):
    return os.path.join(ROOT, "experiments", name)


def _env():
    return {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
            "OMP_NUM_THREADS": "1"}


# ---------------------------------------------------------------------------
# the spec's JSON and the spec checker
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", SPECS, ids=os.path.basename)
def test_to_json_is_the_references(path, tmp_path):
    ref, port = JExperiment.load(path), Experiment.load(path)
    for r, p in ((ref, port), (ref.normalize(), port.normalize())):
        assert p.to_json() == r.to_json()
        assert p.to_json(indent=None) == r.to_json(indent=None)
    port.save(str(tmp_path / "p.json"))
    ref.save(str(tmp_path / "r.json"))
    assert (tmp_path / "p.json").read_bytes() == \
        (tmp_path / "r.json").read_bytes()
    assert Experiment.load(str(tmp_path / "p.json")) == port


def test_validate_prints_the_references_lines(tmp_path, capsys):
    bad = tmp_path / "bad.json"
    bad.write_text(Experiment().to_json().replace('"steps": 100',
                                                  '"steps": 0'))
    for paths in (SPECS, SPECS + [str(bad), str(tmp_path / "missing.json")]):
        rc = validate.main(paths)
        mine = capsys.readouterr().out
        want_rc = jvalidate.main(paths)
        theirs = capsys.readouterr().out
        assert (rc, mine) == (want_rc, theirs)
        assert mine.count("\n") == len(paths)
    assert rc == 1 and "FAIL" in mine


# ---------------------------------------------------------------------------
# flags
# ---------------------------------------------------------------------------

FLAG_SETS = [
    ["--arch", "mamba2-130m", "--reduced", "--algo", "fedbioacc_local",
     "--clients", "8", "--clients-per-round", "4", "--seed", "3",
     "--fuse-storm", "--comm-every", "x=2"],
    ["--arch", "gemma2-2b", "--steps", "7", "--local-steps", "3", "--lr-x",
     "0.1", "--lr-y", "0.2", "--lr-u", "0.3", "--per-client", "4", "--seq",
     "64", "--neumann-q", "5", "--fuse-oracles"],
    ["--arch", "mamba2-130m", "--participation", "weighted",
     "--client-weights", "1,2,3,4", "--availability-seed", "9",
     "--stale-discount", "0.5", "--fuse-storm", "--mesh", "2,2",
     "--overlap", "--scatter-comm"],
    ["--arch", "mamba2-130m", "--availability-trace", "log.json",
     "--availability-rate", "0.4", "--hierarchy-period", "2",
     "--telemetry-sink", "events.jsonl", "--mesh", "production"],
    ["--experiment", _spec("fedbioacc_straggler.json"), "--steps", "3",
     "--seed", "5"],
    ["--experiment", _spec("fedavg.json"), "--stale-discount", "0.9"],
]


def _overrides(parser, argv):
    ns = parser.parse_args(argv)
    knobs = {"experiment", "resume", "ckpt_dir", "ckpt_every", "log_every",
              "max_restarts", "restart_backoff", "crash_at_step", "device"}
    return ns, {k: v for k, v in vars(ns).items() if k not in knobs}


@pytest.mark.parametrize("argv", FLAG_SETS, ids=range(len(FLAG_SETS)))
def test_cli_flags_build_the_references_spec(argv, capsys):
    ns, ov = _overrides(train._parser(), argv)
    jns, jov = _overrides(jtrain._parser(), argv)
    assert ov == jov
    mine, start = train._resolve_experiment(ns, ov)
    printed = capsys.readouterr().out
    theirs, jstart = jtrain._resolve_experiment(jns, jov)
    assert capsys.readouterr().out == printed
    assert start == jstart == 0
    assert mine.to_json() == theirs.to_json()


def test_cli_flags_example_of_the_reference():
    """``tests/test_api_spec.py``'s example: the CLI is a pure adapter."""
    ov = {"arch": "mamba2-130m", "reduced": True, "algo": "fedbioacc_local",
          "clients": 8, "clients_per_round": 4, "seed": 3,
          "fuse_storm": True, "comm_every": "x=2"}
    exp = train.apply_overrides(
        Experiment().edit(**{"problem.reduced": False}), ov)
    assert exp.algorithm.name == "fedbioacc_local"
    assert exp.problem.num_clients == 8 and exp.problem.reduced
    assert exp.participation.sampler == "uniform"       # promoted
    assert exp.participation.clients_per_round == 4
    assert exp.problem.data_seed == 3 and exp.schedule.seed == 3
    assert exp.schedule.comm_every_dict == {"x": 2}
    exp.validate()


def test_unported_flags_reach_the_spec_and_are_refused(tmp_path):
    # --mesh runs, stragglers on a mesh too (tests/test_torch_sharded_engine
    # .py); a spec that trains through the flash kernel, which the port
    # refuses, is refused by that name with --mesh applied, before any
    # rank starts
    flash = str(tmp_path / "flash.json")
    Experiment.load(STRAGGLER).edit(**{"execution.use_flash": True}).save(
        flash)
    assert train.apply_overrides(Experiment.load(flash), {"mesh": "2,2"}) \
        .execution.mesh == (2, 2)
    with pytest.raises(SystemExit, match="execution.use_flash"):
        train.main(["--experiment", flash, "--mesh", "2,2",
                    "--device", "cpu"])
    # --telemetry-sink is ported: it reaches the spec; a run that an
    # unported feature stops at build writes no stream
    sink = str(tmp_path / "ev.jsonl")
    exp = train.apply_overrides(Experiment.load(STRAGGLER),
                                {"telemetry_sink": sink})
    assert exp.telemetry == exp.telemetry._replace(sink=sink)
    # (--comm-every, the flag this case used until per-sequence cadences
    # were ported, now runs: tests/test_torch_hierarchical.py)
    with pytest.raises(SystemExit, match="execution.use_flash"):
        train.main(["--experiment", flash, "--telemetry-sink", sink,
                    "--mesh", "2,1", "--device", "cpu"])
    assert not os.path.exists(sink)


def test_resume_flag_mismatch_fails_loudly(tmp_path):
    exp = Experiment.load(_spec("fedbio.json"))
    ckpt = str(tmp_path / "ck")
    save_checkpoint(ckpt, {"x": torch.zeros(())}, {"step": 2}, experiment=exp)
    lr = exp.schedule.lr_x
    ns = train._parser().parse_args(["--resume", ckpt, "--lr-x",
                                     str(2 * lr)])
    with pytest.raises(SystemExit, match="contradict"):
        train._resolve_experiment(ns, {"lr_x": 2 * lr})
    # a flag that matches the embedded spec is not a mismatch
    ns = train._parser().parse_args(["--resume", ckpt, "--lr-x", str(lr)])
    got, start = train._resolve_experiment(ns, {"lr_x": lr})
    assert got == exp and start == 2


def test_strip_flag():
    argv = ["--resume", "d", "--crash-at-step=3", "--steps", "4",
            "--crash-at-step", "2"]
    assert train._strip_flag(argv, "--crash-at-step") == \
        ["--resume", "d", "--steps", "4"]
    assert train._strip_flag(argv, "--resume") == argv[2:]


def test_reference_checkpoint_is_not_resumed_by_the_cli(tmp_path):
    """A reference checkpoint records its batch key, not the port's data
    generator: the CLI refuses to continue it, saying why."""
    d = str(tmp_path / "ref")
    jsave(d, {"x": jax.numpy.zeros(())}, {"step": 2, "key": [0, 1]},
          experiment=JExperiment.load(STRAGGLER))
    with pytest.raises(SystemExit, match="data_gen"):
        train.main(["--resume", d, "--device", "cpu"])


# ---------------------------------------------------------------------------
# banners and the diagnostic checkpoint
# ---------------------------------------------------------------------------

def test_nonfinite_loss_fails_loudly(tmp_path, monkeypatch):
    def nan_run(exp, device=None):
        run = build(exp, device=device)
        return Run(**{**run._asdict(), "eval_fn": lambda s: float("nan")})

    monkeypatch.setattr(train, "build", nan_run)
    with pytest.raises(SystemExit, match="round 1"):
        train.main(["--experiment", _spec("fedavg.json"), "--steps", "2",
                    "--log-every", "1", "--device", "cpu", "--ckpt-dir",
                    str(tmp_path / "ck")])
    diag = str(tmp_path / "ck" / "diagnostic")
    assert checkpoint_metadata(diag) == {"step": 1, "diagnostic": True}
    assert load_experiment(diag) == \
        Experiment.load(_spec("fedavg.json")).edit(**{"schedule.steps": 2})
    assert not os.path.exists(str(tmp_path / "ck" / "manifest.json"))


# ---------------------------------------------------------------------------
# resumes, bit for bit
# ---------------------------------------------------------------------------

def _final_arrays(d):
    with np.load(os.path.join(d, f"arrays-{checkpoint_metadata(d)['step']:08d}"
                                 f".npz")) as data:
        return {k: data[k].copy() for k in data.files}


def test_crash_then_resume_equals_the_uninterrupted_run(tmp_path):
    crashed, full = str(tmp_path / "crashed"), str(tmp_path / "full")
    common = ["--device", "cpu", "--ckpt-every", "2", "--log-every", "1"]
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--experiment",
         STRAGGLER, "--steps", "4", "--ckpt-dir", crashed,
         "--crash-at-step", "2", *common],
        capture_output=True, text=True, timeout=300, cwd=ROOT, env=_env())
    assert out.returncode == 17, out.stderr
    assert "crash-at-step: hard exit after step 2" in out.stdout
    # the reference's banners (src/repro/launch/train.py:391-408)
    assert "participation: uniform m=4/8 seed=0\n" in out.stdout
    assert "stragglers: policy=drop deadline=1.5 quorum=0.5 " \
           "over_provision=2 tail=1.0\n" in out.stdout
    md = checkpoint_metadata(crashed)
    assert md["step"] == 2 and md["retries"] == 0
    assert md["arch"] == "mamba2-130m" and md["data_gen"]
    # --crash-at-step is inert on a resume
    resumed = train.main(["--resume", crashed, "--ckpt-dir", crashed,
                          "--crash-at-step", "3", *common])
    whole = train.main(["--experiment", STRAGGLER, "--steps", "4",
                        "--ckpt-dir", full, *common])
    assert [h["step"] for h in resumed] == [3, 4]
    strip = [{k: v for k, v in h.items() if k != "wall_s"} for h in whole]
    assert [{k: v for k, v in h.items() if k != "wall_s"}
            for h in resumed] == strip[2:]
    assert all(len(h["arrivals"]) >= 3 for h in strip)
    assert strip[2]["deadline"] != strip[0]["deadline"]   # the EMA moved it
    mine, want = _final_arrays(crashed), _final_arrays(full)
    assert checkpoint_metadata(crashed) == checkpoint_metadata(full)
    assert sorted(mine) == sorted(want) == [f"a{i}" for i in range(5)]
    for k in want:
        assert mine[k].dtype == want[k].dtype
        np.testing.assert_array_equal(bits(mine[k]), bits(want[k]))


@pytest.mark.parametrize("name", ["fedbioacc_int8_topk.json",
                                  "fedbioacc_local.json", "fedbio.json",
                                  "fedavg.json"])
def test_saved_at_step_2_continues_bit_for_bit(name, tmp_path):
    exp = Experiment.load(_spec(name)).edit(**{"schedule.steps": 4})
    run = build(exp, device="cpu")
    data = torch.Generator().manual_seed(exp.schedule.seed)
    batches = [run.batch_fn(data) for _ in range(4)]
    state = run.init(torch.Generator().manual_seed(exp.schedule.seed))
    for b in batches[:2]:
        state, _ = run.step(state, b)
    d = str(tmp_path / "ck")
    save_checkpoint(d, state, {"step": 2}, experiment=run.spec)
    saved = [bits(t).copy() for t in tree_leaves(state)]
    for b in batches[2:]:
        state, _ = run.step(state, b)

    run2 = build(load_experiment(d), device="cpu")
    state2 = load_checkpoint(d, run2.init(torch.Generator().manual_seed(9)))
    for s, t in zip(saved, tree_leaves(state2)):
        np.testing.assert_array_equal(s, bits(t))
    for b in batches[2:]:
        state2, _ = run2.step(state2, b)
    assert state2.step == state.step == 4
    leaves, leaves2 = tree_leaves(state), tree_leaves(state2)
    assert len(leaves) == len(leaves2)
    for a, b in zip(leaves, leaves2):
        np.testing.assert_array_equal(bits(a), bits(b))
    if exp.compression is not None:
        assert state.ef and any(bool(torch.any(e != 0))
                                for side in state.ef for e in side)
    if exp.participation.sampler != "full":
        assert bool(torch.any(state.stale != 0))


@pytest.mark.parametrize("example,argv", [
    ("declarative_experiment", ["--device", "cpu"]),
    ("train_lm_federated", ["--device", "cpu", "--steps", "2"]),
])
def test_examples_run_on_cpu(example, argv, tmp_path):
    import importlib
    mod = importlib.import_module(f"repro_torch.examples.{example}")
    if example == "train_lm_federated":
        argv = argv + ["--ckpt-dir", str(tmp_path / "ck")]
        history = mod.main(argv)     # asserts the loss fell
        assert [h["step"] for h in history] == [1, 2]
    else:
        assert np.isfinite(mod.main(argv))


# ---------------------------------------------------------------------------
# faults: rollbacks, restarts
# ---------------------------------------------------------------------------

FAULTY = _spec("fedbioacc_faulty.json")


def _faulty(tmp_path, name, **edits):
    """The committed faulty spec cut to 4 clients, with ``edits``, saved
    for both CLIs."""
    exp = Experiment.load(FAULTY).edit(**{"problem.num_clients": 4,
                                          **edits})
    path = str(tmp_path / f"{name}.json")
    exp.save(path)
    return path


def _rollbacks(text):
    return [json.loads(ln) for ln in text.splitlines()
            if ln.startswith('{"rollback_to"')]


def test_forced_rollbacks_match_the_reference_cli(tmp_path, capsys):
    """Every retry of round 1 sends NaN and nothing screens it: two
    rollbacks to the last good step, then the budget runs out at the
    reference's round, with a diagnostic checkpoint."""
    path = _faulty(tmp_path, "forced", **{
        "faults.nan_rate": 1.0, "faults.byzantine_rate": 0.0,
        "faults.start_round": 1, "robustness.screen": False,
        "robustness.retry_budget": 2})
    common = ["--experiment", path, "--log-every", "2"]
    with pytest.raises(SystemExit) as mine:
        train.main(common + ["--device", "cpu", "--ckpt-dir",
                             str(tmp_path / "ck")])
    out = capsys.readouterr().out
    with pytest.raises(SystemExit) as theirs:
        jtrain.main(common)
    ref = capsys.readouterr().out
    got, want = _rollbacks(out), _rollbacks(ref)
    assert [(r["rollback_to"], r["retry"]) for r in got] == \
        [(r["rollback_to"], r["retry"]) for r in want] == [(2, 1), (2, 2)]
    assert all(np.isnan(r["bad_loss"]) for r in got + want)
    assert str(mine.value).split(":")[0] == str(theirs.value).split(":")[0] \
        == "round 4"
    assert "exhausting the retry budget (2; rollbacks at steps [4, 4])" in \
        str(mine.value)
    diag = str(tmp_path / "ck" / "diagnostic")
    assert checkpoint_metadata(diag) == {"step": 4, "diagnostic": True}


def test_rollback_then_supervised_restart_is_bit_for_bit(tmp_path):
    """Round 1 sends NaN at retry 0 (clients 1, 2; seed 18) and none at
    retry 1: the run rolls back to step 3, checkpoints step 4 with
    ``retries`` 1 and crashes; ``--max-restarts 1`` resumes it, and it ends
    as the uninterrupted run, bit for bit."""
    path = _faulty(tmp_path, "once", **{
        "schedule.steps": 6, "faults.nan_rate": 0.2,
        "faults.byzantine_rate": 0.0, "faults.seed": 18,
        "robustness.aggregator": "mean", "robustness.screen": False})
    common = ["--experiment", path, "--device", "cpu", "--log-every", "1",
              "--ckpt-every", "2"]
    sup, whole = str(tmp_path / "sup"), str(tmp_path / "whole")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *common,
         "--ckpt-dir", sup, "--max-restarts", "1", "--restart-backoff", "0",
         "--crash-at-step", "4"],
        capture_output=True, text=True, timeout=300, cwd=ROOT, env=_env())
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert "crash-at-step: hard exit after step 4" in out.stdout
    assert "run crashed (exit 17); restart 1/1 in 0.0s" in out.stdout
    assert f"resumed from {sup} @ step 4" in out.stdout
    history = train.main(common + ["--ckpt-dir", whole])
    rolled = _rollbacks(out.stdout)
    assert [(r["rollback_to"], r["retry"]) for r in rolled] == [(3, 1)]
    assert np.isnan(rolled[0]["bad_loss"])
    lines = [json.loads(ln) for ln in out.stdout.splitlines()
             if ln.startswith('{"step"')]
    strip = [{k: v for k, v in h.items() if k != "wall_s"} for h in history]
    assert [{k: v for k, v in h.items() if k != "wall_s"}
            for h in lines] == strip
    assert [h["step"] for h in strip] == [1, 2, 3, 4, 5, 6]
    assert strip[3]["nan"] == [] and "screened" not in strip[3]
    md = checkpoint_metadata(sup)
    assert md == checkpoint_metadata(whole)
    assert md["step"] == 6 and md["retries"] == 1
    mine, want = _final_arrays(sup), _final_arrays(whole)
    assert sorted(mine) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(bits(mine[k]), bits(want[k]))
    assert int(mine[f"a{len(mine) - 1}"]) == 1     # FlatState.retry


def test_crash_auto_resume_supervisor(tmp_path):
    """The reference's supervisor test on the port: a hard crash after the
    step-2 checkpoint is survived by relaunching with --resume."""
    exp = Experiment.load(_spec("fedavg.json")).edit(
        **{"schedule.steps": 4})
    path = str(tmp_path / "exp.json")
    exp.save(path)
    ckpt = str(tmp_path / "ckpt")
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--experiment",
         path, "--device", "cpu", "--ckpt-dir", ckpt, "--ckpt-every", "2",
         "--log-every", "2", "--max-restarts", "2", "--restart-backoff",
         "0", "--crash-at-step", "3"],
        capture_output=True, text=True, timeout=300, cwd=ROOT, env=_env())
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    assert "crash-at-step" in res.stdout
    assert "resumed from" in res.stdout
    assert checkpoint_metadata(ckpt)["step"] == 4
    assert checkpoint_metadata(ckpt).get("data_gen") is not None


def test_max_restarts_needs_a_checkpoint_dir():
    with pytest.raises(SystemExit, match="--max-restarts requires "
                                         "--ckpt-dir"):
        train.main(["--experiment", FAULTY, "--max-restarts", "1"])


def test_restart_wait_is_the_references():
    assert train._RESTART_WAIT_CAP == jtrain._RESTART_WAIT_CAP
    for backoff in (0.0, 0.1, 0.5, 1.0):
        for token in ("", "ckpt-a", "/tmp/run/ck", "b"):
            for attempt in range(50):
                assert train._restart_wait(backoff, attempt, token) == \
                    jtrain._restart_wait(backoff, attempt, token)
