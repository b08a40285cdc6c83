"""The port's main path end to end against the JAX package: FedBiOAcc as
``experiments/fedbioacc.json`` runs it (reduced Mamba-2, 2 clients, seq 32,
fused STORM + fused oracles), two steps including one communication round
(``local_steps`` is 2).  The port starts from the reference's initial
``FlatState`` and is handed the reference's batches; the variable and
momentum buffers must agree within rtol 1e-4 of each buffer's norm."""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.api import Experiment as JExperiment  # noqa: E402
from repro.api import build as jbuild  # noqa: E402
from repro.config import FederatedConfig as JFederatedConfig  # noqa: E402
from repro.optim import sequences as jseqs  # noqa: E402
from repro_torch.api import Experiment, build  # noqa: E402
from repro_torch.config import FederatedConfig  # noqa: E402
from repro_torch.kernels.storm import kernel as tk  # noqa: E402
from repro_torch.optim import sequences as seqs  # noqa: E402
from torch_parity import bits, f32, to_torch  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SPEC = ROOT / "experiments" / "fedbioacc.json"


def test_storm_schedule_matches_reference_bitwise():
    """α_t and the per-section (lr, decay) scalars are the reference's f32
    values (they feed the kernels' per-tile tables)."""
    jcfg, cfg = JFederatedConfig(), FederatedConfig()
    aspec = seqs.SPECS["fedbioacc"]

    @jax.jit
    def jscalars(t):
        a = jseqs.alpha_schedule(jcfg, t)
        return a, [getattr(jcfg, q.lr) * a for q in aspec.sequences], \
            [1.0 - getattr(jcfg, q.decay) * a * a for q in aspec.sequences]

    for t in (0, 1, 7, 100):
        ja, jl, jd = jscalars(jnp.int32(t))
        a = seqs.alpha_schedule(cfg, t)
        lrs = [seqs._f32(getattr(cfg, q.lr)) * a for q in aspec.sequences]
        dcs = [seqs._f32(1.0) - seqs._f32(getattr(cfg, q.decay)) * a * a
               for q in aspec.sequences]
        for x, y in zip([a, *lrs, *dcs], [ja, *jl, *jd]):
            np.testing.assert_array_equal(bits(x), bits(y))


def test_two_steps_match_reference_and_go_through_the_kernel():
    jrun = jbuild(JExperiment.load(str(SPEC)))
    key = jax.random.PRNGKey(jrun.spec.schedule.seed)
    jstate = jrun.init(key)
    run = build(Experiment.load(str(SPEC)), device="cpu")
    assert [g.padded for g in run.init.spec.groups] == \
           [g.padded for g in jrun.step.spec.groups]
    state = seqs.FlatState(tuple(to_torch(list(jstate.vars))),
                           tuple(to_torch(list(jstate.mom))), 0)
    jstep = jax.jit(jrun.step)
    tk.reset_counts()
    for _ in range(2):
        key, sub = jax.random.split(key)
        batch = jrun.batch_fn(sub)
        jstate, _ = jstep(jstate, batch)
        state, metrics = run.step(state, to_torch(batch))
    assert state.step == metrics["step"] == int(jstate.step) == 2
    # one storm3_step call per dtype buffer per step
    assert tk.CALLS["storm3_step"] == 2 * len(run.init.spec.groups)
    for js, ts in ((jstate.vars, state.vars), (jstate.mom, state.mom)):
        for j, t in zip(js, ts):
            j = np.asarray(j, np.float32)
            assert np.linalg.norm(f32(t) - j) <= 1e-4 * np.linalg.norm(j)
    # the round communicated: every client holds the same variables
    for t in state.vars:
        np.testing.assert_array_equal(bits(t[0]), bits(t[1]))


def test_train_cli_runs_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--experiment",
         str(SPEC), "--device", "cpu", "--steps", "2", "--log-every", "1"],
        capture_output=True, text=True, timeout=240, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr
    lines = [json.loads(ln) for ln in out.stdout.splitlines()
             if ln.startswith("{")]
    assert [ln["step"] for ln in lines] == [1, 2]
    assert all(math.isfinite(ln["val_loss"]) for ln in lines)
