"""The port's sequence engine on the sharded flat substrate, over a
``[4, 2]`` mesh of gloo ranks on the CPU, against its unsharded engine
(the reference's ``tests/test_sharded_substrate.py`` engine cases).

* One group of 8 spawned ranks (``tests/torch_mesh.py``) runs the five
  algorithms sharded, FedBiOAcc under m = M/2 participation, the overlap
  schedule, and both: three steps each of the reduced Mamba-2 (4 clients,
  tiles of 256), gathered on rank 0.  Each case is a test of its own: every
  field within atol 2e-5 and rtol 2e-4 of the unsharded engine's (the
  reference's tolerance; the oracles' and the means' sums run in other
  orders), and rank 0 called the update kernel's wrapper as often as the
  unsharded run (one launch per dtype buffer a step, on its own block).
  FedBiOAcc with int8 sends on the mesh (the int8 wire: one more rounding
  of each partial sum, up to a quantum of the tile's shared scale) is held
  at the reference's tolerance for its sharded compressed engine, atol 0.2
  and rtol 0.05 (``tests/test_compressed_comm.py``); with top-k as well,
  a flipped selection changes later steps by whole entries, so the top-k
  means are held against the reference's in the substrate file.
* The same ranks run ``experiments/fedbioacc_sharded_overlap.json``
  through ``api.build`` for its 4 steps: finite ``eval_fn`` losses.
* The train CLI on the committed spec with ``--device cpu`` (a
  subprocess in a session of its own, killed whole past its time) starts
  its own 8 ranks: 4 step lines with finite ``val_loss``, the build's
  losses, and its checkpoint bit for bit the build's final state; a
  ``--crash-at-step 2`` run exits 17 and ``--resume`` continues it to the
  same bits.
* Stragglers, faults with the guarded means, and in-band telemetry on the
  mesh (``tm.guard_cases``: the straggler, faulty and telemetry specs
  edited to ``execution.mesh [4, 2]``, and their other late policies,
  guards and metric groups), run by the same ranks through ``api.build``,
  each held against the port's unsharded run of the same spec: the round
  decisions (arrivals, deadlines, fault masks) equal, the screen's
  verdicts equal once each client's margin from the z-score threshold is
  asserted, the fields within atol 2e-5 and rtol 2e-4 (the int8 wire at
  the int8 engine case's tolerance; the faulty specs' variables within
  1e-4 of their norm, and their last momenta, which the ×25 sends leave
  ill-conditioned, to 4× the measured response, ROADMAP queue 3 item
  15, but in the trim case, whose screen catches the ×25 sends too, at
  1e-4 as well), the in-band metrics within rtol 1e-5 (4.33e-7 measured: the sums
  run in another order; the drift also within the rounding of its mean
  row, which is all it is where the rows nearly coincide), and one
  ``storm3_step`` call a step on each rank's block
  (``tests/test_torch_sharded_reference.py`` holds the mesh runs of the
  three specs to the JAX package's engine with ``shard=``).  The
  same ranks run the train CLI on a spec that rolls back
  once: every rank rolls back at the step the unmeshed CLI does; on the
  telemetry spec, whose event stream validates and carries the unsharded
  run's in-band metrics; and on the committed faulty spec, whose step
  lines (faults, screened, ``val_loss``) match the unmeshed run's.
* One more CLI run with ``--mesh 4,2``, spawning its world: the straggler
  spec under ``--max-restarts 1 --crash-at-step 2``, which the
  supervisor resumes bit for bit into the uninterrupted run, its deadline
  carried in the checkpoint."""
import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_mesh as tm

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SPEC = os.path.join(ROOT, tm.SPEC)
CASES = tm.engine_cases()
GUARDS = tm.guard_cases()
TOL = {"atol": 2e-5, "rtol": 2e-4}
INT8_TOL = {"atol": 0.2, "rtol": 0.05}
METRIC_RTOL = 1e-5
FIELD_NORM_TOL = 1e-4          # the faulty specs' fields, of their norm
ILL_CONDITIONED = 1e-3         # a buffer's response above this is not held
MARGIN = 1e-4                  # the screen's margin, of its threshold

@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """What rank 0 of the engine group wrote: each case's whole final
    fields and its wrapper calls, the committed spec's losses and final
    buffers, each guard case's record (``tm.guard_run``) and the in-rank
    CLIs' output; beside it the port's unsharded run of each guard case
    (``"unsharded"``: :func:`_unsharded`, run while the ranks do) and the
    rollback spec's path (``"rollback"``)."""
    tmp = str(tmp_path_factory.mktemp("sharded_engine"))
    out = os.path.join(tmp, "engine.npz")
    rollback = os.path.join(tmp, "rollback.json")
    tm.rollback_spec(ROOT).save(rollback)
    unsharded = {}

    def run_unsharded():
        # the port's unsharded runs of the guard cases, while the ranks run
        with pytest.MonkeyPatch.context() as mp:
            for name in sorted(GUARDS):
                unsharded[name] = _unsharded(name, mp)
                mp.undo()

    tm.run_ranks(tm.engine_ranks, tmp, out, ROOT, rollback, timeout=600,
                 during=run_unsharded)
    got = dict(np.load(out))
    got["unsharded"] = unsharded
    got["rollback"] = rollback
    got["rollback_ck"] = os.path.join(tmp, "rollback_mesh")
    return got


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_engine_matches_unsharded(sharded, name):
    from repro_torch.kernels.storm import kernel as tk
    algo, m, overlap, comp = CASES[name]
    tk.reset_counts()
    step, state = tm.engine_run(algo, m, overlap, comp)
    calls = dict(tk.CALLS)
    want = tm.field_arrays(step, state, tm.FIELDS[algo])
    # compressed: the int8 wire is the one extra rounding (the reference's
    # own tolerance for its sharded compressed engine)
    tol = ({"atol": 2e-5, "rtol": 2e-4} if comp is None
           else {"atol": 0.2, "rtol": 0.05})
    for k, v in want.items():
        got = sharded[f"{name}/{k}"]
        assert got.shape == v.shape and np.all(np.isfinite(got)), k
        np.testing.assert_allclose(got, v, err_msg=f"{name}: {k}", **tol)
    np.testing.assert_array_equal(sharded[f"{name}/calls"],
                                  [calls[k] for k in sorted(calls)])
    kern = {"fedbio": "sgd3_step", "fedbio_local": "sgd3_step",
            "fedavg": "momsgd3_step"}.get(algo, "storm3_step")
    assert calls[kern] == tm.ENGINE_STEPS * len(step.spec.groups)
    if overlap:
        # the new-iterate oracle read the iterate from before the round's
        # reduction: the trajectory differs from the sequential schedule
        base = name.replace("-overlap", "")
        assert not np.array_equal(sharded[f"{name}/nu/0"],
                                  sharded[f"{base}/nu/0"])


def test_committed_spec_builds_and_trains_on_the_mesh(sharded):
    losses = sharded["spec/losses"]
    assert losses.shape == (4,) and np.all(np.isfinite(losses))


def _arrays(ckpt: str) -> dict:
    with np.load(os.path.join(ckpt, "arrays-00000004.npz")) as data:
        return {k: data[k] for k in data.files}


def _same_as_build(sharded, ckpt: str) -> None:
    arrays = _arrays(ckpt)
    bufs = sorted(k for k in sharded if k.startswith("spec/buf"))
    assert len(arrays) == len(bufs) + 1           # the buffers and the step
    for i, k in enumerate(bufs):
        assert arrays[f"a{i}"].tobytes() == sharded[k].tobytes(), k


def _cli(args: list, timeout: float = 300.0) -> tuple:
    """``python -m repro_torch.launch.train *args`` in a session of its own
    (the CLI spawns its ranks there), killed whole past ``timeout``
    seconds; returns (exit code, the step lines, stderr, stdout)."""
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    proc = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.train",
                             *args], cwd=ROOT, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    return proc.returncode, _lines(out), err, out


def _lines(out: str, head: str = '{"step"') -> list:
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith(head)]


class _ExitsBetweenReads:
    """A rank as ``launch.mesh.spawn_ranks`` sees it, which is running at
    the first read of its ``exitcode`` and has exited (0, reaped) at every
    later one, with its sentinel ready: the rank that exits between two of
    the parent's reads."""

    def __init__(self, *a, **kw):
        self.reads = 0
        self.sentinel, w = os.pipe()
        os.close(w)                        # its writer is gone: ready

    def start(self):
        pass

    @property
    def exitcode(self):
        self.reads += 1
        return None if self.reads == 1 else 0

    def join(self, timeout=None):
        pass


def test_spawn_ranks_waits_on_ranks_that_exit_between_its_reads(
        monkeypatch):
    """The last rank exiting between the parent's loop test and the list
    it waits on must not leave the parent waiting on nothing: the train
    CLI's parent then waited for ever on ranks that had all exited (with
    a timeout, as the verifier's, it raised ``TimeoutError`` instead)."""
    from types import SimpleNamespace

    from repro_torch.launch import mesh
    made = []

    def process(*a, **kw):
        made.append(_ExitsBetweenReads())
        return made[-1]
    monkeypatch.setattr(mesh.mp, "get_context",
                        lambda method: SimpleNamespace(Process=process))
    assert mesh.spawn_ranks(None, 1, "unused", timeout=5.0) == 0
    for p in made:
        os.close(p.sentinel)


def test_train_cli_runs_the_committed_spec_over_gloo_ranks(sharded,
                                                          tmp_path):
    ck = str(tmp_path / "ck")
    rc, history, err, _ = _cli(["--experiment", SPEC, "--device", "cpu",
                                "--log-every", "1", "--ckpt-dir", ck,
                                "--ckpt-every", "4"])
    assert rc == 0, err[-3000:]
    assert [h["step"] for h in history] == [1, 2, 3, 4]
    assert all(np.isfinite(h["val_loss"]) for h in history)
    np.testing.assert_array_equal([h["val_loss"] for h in history],
                                  sharded["spec/losses"])
    _same_as_build(sharded, ck)


def test_train_cli_crash_and_resume_bit_for_bit(sharded, tmp_path):
    ck = str(tmp_path / "ck")
    rc, history, err, _ = _cli(["--experiment", SPEC, "--device", "cpu",
                                "--ckpt-dir", ck, "--ckpt-every", "2",
                                "--crash-at-step", "2"])
    assert rc == 17, err[-3000:]
    rc, history, err, _ = _cli(["--resume", ck, "--device", "cpu",
                                "--ckpt-dir", ck, "--ckpt-every", "2",
                                "--log-every", "1"])
    assert rc == 0, err[-3000:]
    assert [h["step"] for h in history] == [3, 4]
    _same_as_build(sharded, ck)


# ---------------------------------------------------------------------------
# stragglers, faults and in-band telemetry on the mesh
# ---------------------------------------------------------------------------

SEC_MOM = {"x": "nu", "y": "omega", "u": "q"}
VAR_FIELDS = ("x", "y", "u")


def _guard(rec: dict, name: str) -> dict:
    """One case's record out of a dict keyed ``<case>/<key>``."""
    head = name + "/"
    return {k[len(head):]: v for k, v in rec.items() if k.startswith(head)}


def _at(rec: dict, head: str) -> dict:
    return {k[len(head):]: v for k, v in rec.items() if k.startswith(head)}


def _margin(seg, w, corrupt, robust) -> float:
    """The screen's smallest distance, over the finite participants, of a
    client's |norm − mean| from its threshold, relative to the threshold
    (inf without the z-score)."""
    from repro_torch.optim import flat
    wv = (torch.ones(seg.shape[0]) if w is None
          else w.to(torch.float32).cpu())
    finite, sq = flat._row_stats(seg, w, corrupt)
    _, stats = flat._health_stats(finite, sq, wv > 0, robust)
    if stats is None:
        return float("inf")
    n, mu, tol = stats
    live = (wv > 0) & finite
    return float((((n - mu).abs() - tol).abs()[live] / tol).min())


def _drift_slack(spec, bufs, mask) -> dict:
    """Per section, how far two f32 means of the participants' rows, summed
    in any two orders, can move the drift: each column sum of ``cnt``
    values errs by at most ``(cnt − 1)·2^-24·Σ|x|``, and by the triangle
    inequality the drift moves by at most the mean row's change, so by
    ``2·(cnt − 1)·2^-24·‖X‖ / √cnt`` (``X`` the section's participant rows;
    Cauchy–Schwarz).  Where the rows are nearly equal, the drift is this
    rounding alone."""
    from repro_torch.optim import flat
    rows = (torch.arange(bufs[0].shape[0]) if mask is None
            else torch.nonzero(mask.cpu() > 0).flatten())
    cnt = max(int(rows.numel()), 1)
    sq: dict = {}
    for grp, buf in zip(spec.groups, bufs):
        for s, runs in flat._section_cols(spec, grp).items():
            for a, b in runs:
                sq[s] = sq.get(s, 0.0) + float(
                    buf[rows, a:b].double().square().sum())
    names = spec.sections
    return {names[s]: 2 * (cnt - 1) * 2.0 ** -24 * v ** 0.5 / cnt ** 0.5
            for s, v in sq.items()}


def _unsharded(name: str, monkeypatch) -> tuple:
    """The port's unsharded run of the case (``tm.guard_run``, with the
    faulty specs' response measured), the screen's margins of each of its
    guarded reductions, and each step's drift slack by section
    (:func:`_drift_slack`)."""
    from repro_torch.optim import flat
    margins, slack = [], []
    orig, drift = flat._robust_mean_into, flat.section_drift

    def record(seg, w, corrupt, robust, verdicts=None):
        if robust is not None and robust.screen:
            margins.append(_margin(seg, w, corrupt, robust))
        return orig(seg, w, corrupt, robust, verdicts)

    def drift_of(spec, bufs, *, mask=None, **kw):
        slack.append(_drift_slack(spec, bufs, mask))
        return drift(spec, bufs, mask=mask, **kw)
    monkeypatch.setattr(flat, "_robust_mean_into", record)
    monkeypatch.setattr(flat, "section_drift", drift_of)
    faulty = GUARDS[name][0] == "faulty"
    return tm.guard_run(tm.guard_experiment(ROOT, name),
                        spread=faulty), margins, slack


def _norm_err(got: dict, want: dict, fields) -> float:
    """‖got − want‖ / ‖want‖ over the leaves of ``fields``."""
    keys = [k for k in sorted(want) if k.split("/")[0] in fields]
    g = np.concatenate([got[k].reshape(-1) for k in keys]).astype(np.float64)
    w = np.concatenate([want[k].reshape(-1) for k in keys]).astype(np.float64)
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))


def _check_fields(got: dict, want: dict, name: str, mom_resp=None,
                  fields=tuple(tm.FIELDS["fedbioacc"])) -> None:
    """The last two steps' fields of ``got`` against ``want``: elementwise
    (``TOL``, the int8 wire ``INT8_TOL``), or, for the faulty specs, each
    field within ``FIELD_NORM_TOL`` of its norm but the last momenta, held
    to 4× ``mom_resp``, the momentum buffer's measured response, where that
    is ill-conditioned.  ``fields``: the ones to check."""
    spec, _, steps = GUARDS[name]
    for t in (steps - 1, steps):
        g, w = _at(got, f"s{t}/"), _at(want, f"s{t}/")
        assert sorted(g) == sorted(w) and w, (name, t)
        if spec != "faulty":
            tol = INT8_TOL if "int8" in name else TOL
            for k in sorted(w):
                if k.split("/")[0] not in fields:
                    continue
                assert g[k].shape == w[k].shape and np.all(np.isfinite(g[k]))
                np.testing.assert_allclose(g[k], w[k], err_msg=f"{name} "
                                           f"step {t}: {k}", **tol)
            continue
        for f in fields:
            err = _norm_err(g, w, (f,))
            bound = FIELD_NORM_TOL
            if t == steps and f not in VAR_FIELDS:
                if mom_resp > ILL_CONDITIONED:
                    bound = 4 * mom_resp
            assert err <= bound, (name, t, f, err, bound)


def _check_metrics(got: dict, want: dict, name: str, slack=()) -> None:
    """Every in-band metric of every step within ``METRIC_RTOL``, the
    drift also within its rounding slack (``slack``: one dict a step, by
    section); with int8 sends the norms after a reduction differ by at
    most the fields' own difference (the triangle inequality), which the
    wire's rounding sets."""
    spec, _, steps = GUARDS[name]
    keys = sorted(k for k in want if k[0] == "m" and "/" in k)
    assert keys == sorted(k for k in got if k[0] == "m" and "/" in k)
    for k in keys:
        t, metric = k.split("/", 1)
        g, w = np.asarray(got[k], np.float64), np.asarray(want[k],
                                                         np.float64)
        kind, _, sec = metric.partition("/")
        if "int8" in name and kind in ("upd_norm", "mom_norm"):
            field = sec if kind == "upd_norm" else SEC_MOM[sec]
            step = int(t[1:])
            if step >= steps - 1:
                gf, wf = _at(got, f"s{step}/"), _at(want, f"s{step}/")
                diff = _norm_err(gf, wf, (field,)) * np.linalg.norm(
                    np.concatenate([wf[f].reshape(-1) for f in sorted(wf)
                                    if f.split("/")[0] == field]))
                assert abs(g - w) <= diff * (1 + 1e-5) + METRIC_RTOL * abs(w), \
                    (name, k, float(g), float(w), diff)
                continue
        atol = slack[int(t[1:]) - 1][sec] if kind == "drift" and slack else 0
        np.testing.assert_allclose(g, w, rtol=METRIC_RTOL, atol=atol,
                                   err_msg=f"{name}: {k}")


@pytest.mark.parametrize("name", sorted(GUARDS))
def test_guarded_engine_matches_unsharded(sharded, name):
    from repro_torch.kernels.storm import kernel as tk
    spec, _, steps = GUARDS[name]
    got = _guard(sharded, name)
    want, margins, slack = sharded["unsharded"][name]
    # the round decisions: host values every rank computes alike; the
    # screen's verdicts come from norms completed in another order, so
    # every client's margin from the threshold is asserted first
    assert min(margins, default=float("inf")) >= MARGIN, margins
    dkeys = sorted(k for k in want if k[0] == "d")
    assert dkeys == sorted(k for k in got if k[0] == "d")
    for k in dkeys:
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{name}: {k}")
    if spec == "faulty":
        assert bool(margins) == (name != "faulty-mean")
        last = f"d{steps}/"
        assert want[last + "nan"].sum() + want[last + "byz"].sum() > 0
        if name != "faulty-mean":
            # a NaN sender is screened out by every guarded reduction
            for c in np.flatnonzero(want[last + "nan"]):
                assert c in want[last + "screened"]
        if name == "faulty-trim":
            # its z-score screens the ×25 senders out too, which leaves the
            # last momenta well-conditioned: they are held at
            # FIELD_NORM_TOL like every other field
            for c in np.flatnonzero(want[last + "byz"]):
                assert c in want[last + "screened"]
            assert want["spread"][-2] <= ILL_CONDITIONED, want["spread"]
    if spec == "straggler":
        late = [t for t in range(1, steps + 1)
                if want[f"d{t}/arrivals"].sum() < 6]
        assert late, "no client missed the deadline"
    # the response of the port's own momentum buffer ([vars, mom, loss])
    _check_fields(got, want, name, want["spread"][-2] if "spread" in want
                  else None)
    _check_metrics(got, want, name, slack)
    for k in ("stale", "deadline", "retry"):
        if k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the eval loss; the last one of a faulty spec to 4× its response, and
    # after the int8 wire at the int8 engine case's rtol
    loss_tol = np.full(steps, METRIC_RTOL)
    if spec == "faulty":
        loss_tol[-1] = max(METRIC_RTOL, 4 * float(want["spread"][-1]))
    if "int8" in name:
        loss_tol[-1] = INT8_TOL["rtol"]
    assert np.all(np.abs(got["loss"] - want["loss"])
                  <= loss_tol * np.abs(want["loss"])), \
        (name, got["loss"], want["loss"], want.get("spread"))
    # one gated storm3_step call a step on each rank's block, as off it
    np.testing.assert_array_equal(got["calls"], want["calls"])
    n_groups = len([k for k in want if k.startswith("buf")]) // 2
    assert got["calls"][sorted(tk.CALLS).index("storm3_step")] == \
        steps * n_groups


def test_late_policies_differ_on_the_mesh(sharded):
    """``carry`` keeps the late clients computing, and ``cancel`` does not
    age them: each changes the mesh run against ``drop``."""
    carry = _guard(sharded, "straggler-carry")
    cancel = _guard(sharded, "straggler-cancel")
    frozen = _at(cancel, "s2/")
    assert any(not np.array_equal(carry["s2/" + k], frozen[k])
               for k in frozen)
    assert np.all(cancel["stale"] <= carry["stale"])
    assert not np.array_equal(cancel["stale"], carry["stale"])


def test_rollback_on_every_rank_as_unmeshed(sharded, tmp_path):
    """Round 1 of the rollback spec sends NaN at retry 0: on the mesh every
    rank rolls back to step 3 with the unmeshed CLI, re-seeds its batches
    alike and runs on to the same step lines."""
    from repro_torch.checkpoint import checkpoint_metadata
    text = str(sharded["rollback/out"])
    want = tm.rollback_cli(str(sharded["rollback"]), str(tmp_path / "ck"))
    rolled = [_lines(x, '{"rollback_to"') for x in (text, want)]
    assert [[(r["rollback_to"], r["retry"]) for r in x] for x in rolled] \
        == [[(3, 1)]] * 2
    assert all(np.isnan(x[0]["bad_loss"]) for x in rolled)
    got, exp = _lines(text), _lines(want)
    assert [h["step"] for h in got] == [h["step"] for h in exp] == \
        [1, 2, 3, 4, 5, 6]
    for g, w in zip(got, exp):
        assert {k: g[k] for k in ("nan", "byzantine")} == \
            {k: w[k] for k in ("nan", "byzantine")}
        np.testing.assert_allclose(g["val_loss"], w["val_loss"],
                                   rtol=METRIC_RTOL)
    assert checkpoint_metadata(str(sharded["rollback_ck"]))["retries"] == 1


def test_train_cli_streams_the_telemetry_spec_on_the_mesh(sharded):
    """The train CLI on the committed telemetry spec with ``--mesh 4,2`` in
    the ranks (2 steps): its event stream validates, and each step's
    in-band metrics event (rank 0's, the metrics every rank holds) is the
    unsharded run's within ``METRIC_RTOL``, as the CLI rounds them."""
    from repro_torch.telemetry import read_events, validate_events
    sink = os.path.join(os.path.dirname(str(sharded["rollback"])),
                        "telemetry_mesh.jsonl")
    validate_events(sink, expect=("run_start", "metrics", "comm"))
    want = sharded["unsharded"]["telemetry"][0]
    inband = [ev for ev in read_events(sink) if ev["event"] == "metrics"
              and "upd_norm/x" in ev]
    assert [ev["step"] for ev in inband] == [1, 2]
    for ev in inband:
        for k in ("upd_norm", "mom_norm", "drift"):
            for sec in ("x", "y", "u"):
                np.testing.assert_allclose(
                    ev[f"{k}/{sec}"], want[f"m{ev['step']}/{k}/{sec}"],
                    rtol=METRIC_RTOL, atol=1e-8, err_msg=f"{k}/{sec}")


def test_train_cli_runs_the_faulty_spec_on_the_mesh(sharded):
    """The train CLI on the committed faulty spec with ``--mesh 4,2`` in
    the ranks: its step lines' faults, screened clients and ``val_loss``
    are those of the unmeshed run of the same spec (the build the
    unmeshed CLI runs, seeded alike: the ``faulty`` guard case off the
    mesh)."""
    lines = _lines(str(sharded["faulty/out"]))
    want = sharded["unsharded"]["faulty"][0]
    assert [h["step"] for h in lines] == [1, 2, 3, 4]
    for h in lines:
        t = h["step"]
        assert h["nan"] == np.flatnonzero(want[f"d{t}/nan"]).tolist()
        assert h["byzantine"] == np.flatnonzero(want[f"d{t}/byz"]).tolist()
        assert h["screened"] == want[f"d{t}/screened"].tolist()
    np.testing.assert_allclose([h["val_loss"] for h in lines], want["loss"],
                               rtol=METRIC_RTOL)
    assert lines[-1]["nan"] == lines[-1]["screened"] == [2, 5]


def test_train_cli_resumes_the_straggler_spec_on_the_mesh(sharded,
                                                         tmp_path):
    """The straggler spec (4 steps) through ``--mesh 4,2`` under the
    supervisor: crashed after step 2, resumed from its checkpoint, it ends
    bit for bit as the uninterrupted mesh run, the deadline round 0 set
    carried into round 1."""
    ck = str(tmp_path / "ck")
    spec = os.path.join(ROOT, tm.GUARD_SPECS["straggler"])
    rc, lines, err, out = _cli([
        "--experiment", spec, "--mesh", "4,2", "--steps", "4", "--device",
        "cpu", "--ckpt-dir", ck, "--ckpt-every", "2", "--log-every", "1",
        "--crash-at-step", "2", "--max-restarts", "1",
        "--restart-backoff", "0"])
    assert rc == 0, err[-3000:]
    assert "crash-at-step: hard exit after step 2" in out
    assert f"resumed from {ck} @ step 2" in out
    rec = _guard(sharded, "straggler")
    assert [h["step"] for h in lines] == [1, 2, 3, 4]
    np.testing.assert_array_equal([h["val_loss"] for h in lines],
                                  rec["loss"])
    assert [h["deadline"] for h in lines] == \
        [float(rec[f"d{t}/deadline"]) for t in range(1, 5)]
    assert lines[2]["deadline"] != lines[1]["deadline"]
    arrays = _arrays(ck)
    bufs = sorted(k for k in rec if k.startswith("buf"))
    for i, k in enumerate(bufs):
        assert arrays[f"a{i}"].tobytes() == rec[k].tobytes(), k
    rest = [arrays[f"a{i}"] for i in range(len(bufs), len(arrays))]
    assert [a.tobytes() for a in rest] == [
        np.asarray(4, rest[0].dtype).tobytes(), rec["stale"].tobytes(),
        rec["deadline"].tobytes()]
