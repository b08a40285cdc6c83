"""The engine's sgd kind end to end against the JAX package: FedBiO
(Alg. 1), FedBiO-Local (Alg. 3) and FedAvg as ``experiments/fedbio.json``,
``fedbio_local.json`` and ``fedavg.json`` run them (reduced Mamba-2,
2 clients, seq 32, fused updates and oracles), two steps including one
communication round (``local_steps`` is 2).

The port starts from the reference's initial ``FlatState`` (its threefry
draws are not reproduced) and is handed the reference's batches; every
variable and momentum buffer must agree within 1e-4 of its norm, and each
step must call the spec's kernel once per dtype buffer.  After the round the
communicated sections are bit-identical across clients, and FedBiO-Local's
private heads are not."""
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
from repro_torch.core.tree_util import tree_leaves  # noqa: E402
from repro_torch.kernels.storm import kernel as tk  # noqa: E402
from repro_torch.optim import sequences as seqs  # noqa: E402
from torch_parity import bits, f32, to_torch  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
# spec → the kernel its step launches once per dtype buffer
KERNEL = {"fedbio": "sgd3_step", "fedbio_local": "sgd3_step",
          "fedavg": "momsgd3_step"}


def _spec(name: str) -> str:
    return str(ROOT / "experiments" / f"{name}.json")


@pytest.mark.parametrize("name", sorted(KERNEL))
def test_two_steps_match_reference_and_go_through_the_kernel(name):
    jrun = jbuild(JExperiment.load(_spec(name)))
    key = jax.random.PRNGKey(jrun.spec.schedule.seed)
    jstate = jrun.init(key)
    run = build(Experiment.load(_spec(name)), device="cpu")
    groups = run.init.spec.groups
    assert [g.padded for g in groups] == \
           [g.padded for g in jrun.step.spec.groups]
    assert (len(jstate.mom) > 0) == (name == "fedavg")
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
    want = dict.fromkeys(tk.CALLS, 0)
    want[KERNEL[name]] = 2 * len(groups)
    assert tk.CALLS == want
    assert len(state.mom) == len(jstate.mom)
    for js, ts in ((jstate.vars, state.vars), (jstate.mom, state.mom)):
        for j, t in zip(js, ts):
            j = np.asarray(j, np.float32)
            assert np.linalg.norm(f32(t) - j) <= 1e-4 * np.linalg.norm(j)
    # after the round: communicated sections equal across clients, private
    # ones (FedBiO-Local's heads y) not
    sections = run.init.spec.sections
    private = {q.section for q in seqs.SPECS[name].sequences
               if q.comm == seqs.PRIVATE}
    for bufs in (state.vars, state.mom):
        for grp, buf in zip(groups, bufs):
            for s, a, b in grp.extents:
                row0, row1 = bits(buf[0, a:b]), bits(buf[1, a:b])
                if sections[s] in private:
                    assert not np.array_equal(row0, row1), sections[s]
                else:
                    np.testing.assert_array_equal(row0, row1)
    assert private == ({"y"} if name == "fedbio_local" else set())


def test_private_heads_start_distinct_per_client():
    run = build(Experiment.load(_spec("fedbio_local")), device="cpu")
    s = run.views(run.init(torch.Generator().manual_seed(0)))
    assert all(torch.equal(x[0], x[1]) for x in tree_leaves(s.x))
    assert not torch.equal(s.y["w"][0], s.y["w"][1])
    assert all(torch.count_nonzero(u) == 0 for u in tree_leaves(s.u))


@pytest.mark.parametrize("name", sorted(KERNEL))
def test_train_cli_runs_on_cpu(name):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--experiment",
         _spec(name), "--device", "cpu", "--steps", "2", "--log-every", "1"],
        capture_output=True, text=True, timeout=240, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr
    assert f"algo={name}" in out.stdout
    lines = [json.loads(ln) for ln in out.stdout.splitlines()
             if ln.startswith("{")]
    assert [ln["step"] for ln in lines] == [1, 2]
    assert all(math.isfinite(ln["val_loss"]) for ln in lines)
