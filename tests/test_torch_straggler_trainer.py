"""FedBiOAcc with stragglers at model scale, against the JAX package:
``experiments/fedbioacc_straggler.json`` (reduced Mamba-2, 8 clients, a
``uniform`` sampler of 4 over-provisioned by 2 to 6 a round, deadline 1.5,
quorum 0.5, ``drop``, the adaptive deadline at 0.2), four steps, two
communication rounds.

The port starts from the reference's initial ``FlatState`` and is handed
the reference's batches.  Each round's sampled mask, arrival set and
extension count must equal the reference's, its effective and next
deadline lie within ``DL_ULPS`` ulps (they are drawn times or an EMA
toward one, and the draws are within a few ulps), the staleness counters
must be equal after every step, and every variable and momentum buffer
must agree within ``SPEC_TOL`` of its norm after the four steps (the
oracles' reductions run in other orders, as in
``test_torch_local_trainer``).  Within the port, each step must leave the
non-arrivals' rows bit for bit as they were and call ``storm3_step`` once
per dtype buffer."""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.api import Experiment as JExperiment  # noqa: E402
from repro.api import build as jbuild  # noqa: E402
from repro_torch.api import Experiment, build  # noqa: E402
from repro_torch.kernels.storm import kernel as tk  # noqa: E402
from repro_torch.optim import sequences as seqs  # noqa: E402
from torch_parity import bits, f32, to_torch  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SPEC = ROOT / "experiments" / "fedbioacc_straggler.json"
STEPS = 4
SPEC_TOL = 1e-4
DL_ULPS = 16


def _ulps(got, want) -> float:
    got, want = np.float32(got), np.float32(want)
    return float(abs(got - want) / np.spacing(abs(want)))


def test_four_steps_match_reference_with_over_provisioned_sampler():
    jrun = jbuild(JExperiment.load(str(SPEC)))
    key = jax.random.PRNGKey(jrun.spec.schedule.seed)
    jstate = jrun.init(key)
    run = build(Experiment.load(str(SPEC)), device="cpu")
    part, strag = run.init.participation, run.step.stragglers
    jpart, jstrag = jrun.step.participation, jrun.step.stragglers
    assert part is not None and strag is not None
    assert part.spec.clients_per_round == jpart.spec.clients_per_round == 6
    # Run.participation is the reference's: the spec before
    # over-provisioning (4 of 8); the step samples with 6 of 8
    assert run.participation._asdict() == jrun.participation._asdict()
    assert run.participation.clients_per_round == 4
    assert run.fed.num_clients == 8
    spec = run.init.spec
    assert [g.padded for g in spec.groups] == \
           [g.padded for g in jrun.step.spec.groups]
    state = seqs.FlatState(tuple(to_torch(list(jstate.vars))),
                           tuple(to_torch(list(jstate.mom))), 0,
                           stale=torch.zeros(8, dtype=torch.int32),
                           deadline=torch.tensor(float(jstate.deadline)))
    assert float(state.deadline) == float(jstate.deadline) == 1.5
    jstep = jax.jit(jrun.step)
    tk.reset_counts()
    rounds = []
    for t in range(STEPS):
        r = t // run.fed.local_steps
        key, sub = jax.random.split(key)
        batch = jrun.batch_fn(sub)
        jmask = jpart.mask_fn(jax.numpy.int32(r))
        want = jstrag.round_decision(r, jmask, jstate.deadline)
        jstate, _ = jstep(jstate, batch)
        before = state
        state, metrics = run.step(state, to_torch(batch))
        decided = metrics["decision"]
        np.testing.assert_array_equal(part.mask_fn(r).numpy(),
                                      np.asarray(jmask))
        np.testing.assert_array_equal(decided["arrivals"].numpy(),
                                      np.asarray(want[0]))
        assert decided["extensions"] == int(want[2])
        assert _ulps(decided["deadline"], want[1]) <= DL_ULPS
        assert _ulps(decided["deadline_next"], want[3]) <= DL_ULPS
        assert _ulps(state.deadline, jstate.deadline) <= DL_ULPS
        np.testing.assert_array_equal(state.stale.numpy(),
                                      np.asarray(jstate.stale))
        arrived = decided["arrivals"]
        assert int(arrived.sum()) >= decided["quorum"]
        out = [m for m in range(8) if arrived[m] == 0]
        for b0, b1 in zip(before.vars + before.mom, state.vars + state.mom):
            for m in out:
                np.testing.assert_array_equal(bits(b0[m]), bits(b1[m]))
        if t % run.fed.local_steps == 0:
            rounds.append((np.asarray(jmask).tolist(),
                           arrived.tolist(), decided["extensions"]))
    # the rounds leave stragglers behind: the test exercises the policy
    for sampled, arrived, _ in rounds:
        assert sum(arrived) < sum(sampled) == 6
    assert state.step == metrics["step"] == int(jstate.step) == STEPS
    want = dict.fromkeys(tk.CALLS, 0)
    want["storm3_step"] = STEPS * len(spec.groups)
    assert tk.CALLS == want
    for js, ts in ((jstate.vars, state.vars), (jstate.mom, state.mom)):
        for j, t in zip(js, ts):
            j = np.asarray(j, np.float32)
            assert np.linalg.norm(f32(t) - j) <= SPEC_TOL * np.linalg.norm(j)
    view = run.views(state)
    assert type(view).__name__ == "FedBiOAccTrainState"
    assert view.stale is state.stale and view.deadline is state.deadline


def test_train_cli_runs_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--experiment",
         str(SPEC), "--device", "cpu", "--steps", "2", "--log-every", "1"],
        capture_output=True, text=True, timeout=240, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr
    assert "algo=fedbioacc" in out.stdout
    assert "stragglers: policy=drop deadline=1.5 quorum=0.5 " \
           "over_provision=2 tail=1.0" in out.stdout
    lines = [json.loads(ln) for ln in out.stdout.splitlines()
             if ln.startswith("{")]
    assert [ln["step"] for ln in lines] == [1, 2]
    assert all(math.isfinite(ln["val_loss"]) for ln in lines)
    for ln in lines:
        assert ln["deadline"] == 1.5           # round 0's effective deadline
        assert 3 <= len(ln["arrivals"]) <= 6   # quorum 3 of 6 sampled
        assert all(0 <= c < 8 for c in ln["arrivals"])
