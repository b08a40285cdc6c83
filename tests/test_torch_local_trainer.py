"""FedBiOAcc-Local (Alg. 4) at model scale with partial participation,
against the JAX package: ``experiments/fedbioacc_local.json`` (reduced
Mamba-2, 4 clients of which the ``uniform`` sampler takes 2 a round, seq
32, fused updates and oracles), four steps, two communication rounds.

The port starts from the reference's initial ``FlatState`` (its threefry
draws of the initial heads are not reproduced) and is handed the
reference's batches.  Every variable and momentum buffer must agree within
1e-4 of its norm (the oracles' reductions run in other orders), the
staleness counters must be equal, and each step must call ``storm3_step``
once per dtype buffer.  Within the port, each step must leave the round's
non-participants' rows bit for bit as they were, and after each round the
participants' communicated rows (x, ν) must be bit-identical while their
private ones (y, ω) are not."""
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
SPEC = ROOT / "experiments" / "fedbioacc_local.json"
STEPS = 4


def test_four_steps_match_reference_with_two_of_four_clients():
    jrun = jbuild(JExperiment.load(str(SPEC)))
    key = jax.random.PRNGKey(jrun.spec.schedule.seed)
    jstate = jrun.init(key)
    run = build(Experiment.load(str(SPEC)), device="cpu")
    part = run.init.participation
    assert part is not None and part.spec.clients_per_round == 2
    assert run.participation.sampler == "uniform"
    spec = run.init.spec
    assert spec.sections == ("x", "y")
    assert [g.padded for g in spec.groups] == \
           [g.padded for g in jrun.step.spec.groups]
    state = seqs.FlatState(tuple(to_torch(list(jstate.vars))),
                           tuple(to_torch(list(jstate.mom))), 0,
                           stale=torch.zeros(4, dtype=torch.int32))
    jstep = jax.jit(jrun.step)
    private = {s for s, q in zip(spec.sections,
                                 seqs.SPECS["fedbioacc_local"].sequences)
               if q.comm == seqs.PRIVATE}
    assert private == {"y"}
    tk.reset_counts()
    for t in range(STEPS):
        key, sub = jax.random.split(key)
        batch = jrun.batch_fn(sub)
        jstate, _ = jstep(jstate, batch)
        before = state
        state, metrics = run.step(state, to_torch(batch))
        mask = part.mask_fn(t // run.fed.local_steps)
        np.testing.assert_array_equal(
            mask.numpy(),
            np.asarray(jrun.step.participation.mask_fn(
                jax.numpy.int32(t // run.fed.local_steps))))
        out = [m for m in range(4) if mask[m] == 0]
        ins = [m for m in range(4) if mask[m] > 0]
        assert len(out) == 2
        for b0, b1 in zip(before.vars + before.mom, state.vars + state.mom):
            for m in out:
                np.testing.assert_array_equal(bits(b0[m]), bits(b1[m]))
        if (t + 1) % run.fed.local_steps == 0:
            for bufs in (state.vars, state.mom):
                for grp, buf in zip(spec.groups, bufs):
                    for s, a, b in grp.extents:
                        row0, row1 = (bits(buf[m, a:b]) for m in ins)
                        if spec.sections[s] in private:
                            assert not np.array_equal(row0, row1)
                        else:
                            np.testing.assert_array_equal(row0, row1)
    assert state.step == metrics["step"] == int(jstate.step) == STEPS
    want = dict.fromkeys(tk.CALLS, 0)
    want["storm3_step"] = STEPS * len(spec.groups)
    assert tk.CALLS == want
    np.testing.assert_array_equal(state.stale.numpy(),
                                  np.asarray(jstate.stale))
    for js, ts in ((jstate.vars, state.vars), (jstate.mom, state.mom)):
        for j, t in zip(js, ts):
            j = np.asarray(j, np.float32)
            assert np.linalg.norm(f32(t) - j) <= 1e-4 * np.linalg.norm(j)
    view = run.views(state)
    assert type(view).__name__ == "FedBiOAccLocalTrainState"
    assert view.stale is state.stale


def test_train_cli_runs_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--experiment",
         str(SPEC), "--device", "cpu", "--steps", "2", "--log-every", "1"],
        capture_output=True, text=True, timeout=240, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr
    assert "algo=fedbioacc_local" in out.stdout
    lines = [json.loads(ln) for ln in out.stdout.splitlines()
             if ln.startswith("{")]
    assert [ln["step"] for ln in lines] == [1, 2]
    assert all(math.isfinite(ln["val_loss"]) for ln in lines)
