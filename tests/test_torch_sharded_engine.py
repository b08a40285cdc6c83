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
  same bits."""
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


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """What rank 0 of the engine group wrote: each case's whole final
    fields and its wrapper calls, the committed spec's losses and final
    buffers."""
    tmp = str(tmp_path_factory.mktemp("sharded_engine"))
    out = os.path.join(tmp, "engine.npz")
    tm.run_ranks(tm.engine_ranks, tmp, out, ROOT, timeout=600)
    return dict(np.load(out))


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
    seconds; returns (exit code, the step lines)."""
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
    lines = [json.loads(ln) for ln in out.splitlines()
             if ln.startswith('{"step"')]
    return proc.returncode, lines, err


def test_train_cli_runs_the_committed_spec_over_gloo_ranks(sharded,
                                                          tmp_path):
    ck = str(tmp_path / "ck")
    rc, history, err = _cli(["--experiment", SPEC, "--device", "cpu",
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
    rc, history, err = _cli(["--experiment", SPEC, "--device", "cpu",
                             "--ckpt-dir", ck, "--ckpt-every", "2",
                             "--crash-at-step", "2"])
    assert rc == 17, err[-3000:]
    rc, history, err = _cli(["--resume", ck, "--device", "cpu",
                             "--ckpt-dir", ck, "--ckpt-every", "2",
                             "--log-every", "1"])
    assert rc == 0, err[-3000:]
    assert [h["step"] for h in history] == [3, 4]
    _same_as_build(sharded, ck)
