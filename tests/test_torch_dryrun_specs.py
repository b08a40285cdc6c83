"""The dry run over the committed specs that take longest to trace, and
the grid's train kind: each spec traces in its own subprocess, all started
at once, while the reference compiles in this one.

* ``fedbioacc_int8_topk.json`` (unsharded): its argument and output bytes
  are the reference's compiled ``memory_analysis()`` less the host fields
  the port keeps on the host (listed with their bytes) and XLA's output
  tuple table; ``compression_check`` reads as the reference's does for an
  unsharded spec;
* ``fedbioacc_straggler.json`` and ``fedbioacc_faulty.json`` trace to
  ``status: OK`` (their host draws on real host tensors);
* ``fedbioacc_sharded_overlap.json`` on rank 0 of a fake group of 8 issues
  exactly ``analysis.collectives.expected_step_collectives(run)``'s
  multiset;
* the compressed spec moved onto a ``[4, 2]`` mesh (an edit made here, at
  run time) passes ``check_compressed_collectives``;
* the straggler, faulty and telemetry specs moved onto that mesh (the
  telemetry spec also with int8 + top-k sends: the compression group)
  trace on rank 0 of a fake group of 8, each step issuing exactly the
  audit's multiset (the faulty one's screen traced on the device, its
  decision record handed a healthy round's verdicts:
  ``dryrun.healthy_round``);
* ``--fused-mesh 4,2`` on a reduced Mamba-2 at a small train shape and
  one microbatch: the sharded substrate on rank 0 of a fake group of 8
  (two clients a data shard), its kernels and collectives; a decode shape
  is skipped."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

jax = pytest.importorskip("jax")

import torch  # noqa: E402

from repro_torch.api import Experiment  # noqa: E402
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402

from test_torch_dryrun import _reduced_grid  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
EXP = ROOT / "experiments"

_FUSED = """
import json, sys
sys.path.insert(0, "src")
import repro_torch.configs as configs
from repro_torch.config import InputShape
from repro_torch.launch import archspec, dryrun
# one microbatch: the microbatched trace is the grid's train test's
archspec._DEFAULT = archspec.DeploySpec("client_sharded", 16, "fedbioacc", 1,
                                        False)
full = configs.get_config
configs.get_config = dryrun.get_config = lambda a: full(a).reduced()
dryrun.INPUT_SHAPES = {k: InputShape(k, 32, 64 if v.kind == "train" else 2,
                                     v.kind)
                       for k, v in dryrun.INPUT_SHAPES.items()}
rec = dryrun.run_one("mamba2-130m", "train_4k", fused_mesh=(4, 2),
                     device="cuda")
skip = dryrun.run_one("mamba2-130m", "decode_32k", fused_mesh=(4, 2))
print(json.dumps({"rec": {k: v for k, v in rec.items()
                          if not k.startswith("_")}, "skip": skip}))
"""

_SHARDED = """
import json, sys
sys.path.insert(0, "src")
from repro_torch.analysis.collectives import expected_step_collectives
from repro_torch.api import Experiment
from repro_torch.launch import dryrun
out, run = dryrun.trace_experiment(Experiment.load(sys.argv[1]), "cpu")
want, _ = expected_step_collectives(run)
got = out["_entries"]
print(json.dumps({"equal": got == want, "n": sum(got.values()),
                  "mesh": out["mesh"], "extra": repr(got - want),
                  "missing": repr(want - got)}))
"""

_GUARDS = """
import json, sys
sys.path.insert(0, "src")
from repro_torch.analysis.collectives import expected_step_collectives
from repro_torch.api import Experiment
from repro_torch.launch import dryrun
res = {}
for path in sys.argv[1:]:
    out, run = dryrun.trace_experiment(Experiment.load(path), "cpu")
    want, info = expected_step_collectives(run)
    got = out["_entries"]
    res[path] = {"equal": got == want, "mesh": out["mesh"],
                 "telemetry": sum(info["telemetry"].values()),
                 "host": sorted(out["memory"]["host_fields"]),
                 "extra": repr(got - want), "missing": repr(want - got)}
print(json.dumps(res))
"""
GUARDS = {"fedbioacc_straggler": {"[0].step", "[0].stale", "[0].deadline"},
          "fedbioacc_faulty": {"[0].step", "[0].retry"},
          "fedbioacc_telemetry": {"[0].step"}}
# the telemetry spec with int8 + top-k sends: the compression group's
# passes (quant_err, ef_norm) on the mesh
INT8_TELEMETRY = {"compression.quant": "int8", "compression.topk_frac": 0.1,
                  "execution.storm_block": 256}


def _start(args):
    env = dict(os.environ, PYTHONPATH="src", OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    return subprocess.Popen([sys.executable, *args], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    mesh_spec = tmp / "int8_on_mesh.json"
    Experiment.load(str(EXP / "fedbioacc_int8_topk.json")).edit(**{
        "execution.mesh": (4, 2)}).save(str(mesh_spec))
    procs = {}
    for name in ("fedbioacc_int8_topk", "fedbioacc_straggler",
                 "fedbioacc_faulty"):
        procs[name] = _start(["-m", "repro_torch.launch.dryrun",
                              "--experiment", str(EXP / f"{name}.json"),
                              "--device", "cpu", "--out",
                              str(tmp / f"{name}.jsonl")])
    procs["int8_on_mesh"] = _start(
        ["-m", "repro_torch.launch.dryrun", "--experiment", str(mesh_spec),
         "--device", "cpu", "--out", str(tmp / "int8_on_mesh.jsonl")])
    guards = []
    for name in GUARDS:
        guards.append(str(tmp / f"{name}_on_mesh.json"))
        Experiment.load(str(EXP / f"{name}.json")).edit(**{
            "execution.mesh": (4, 2)}).save(guards[-1])
    guards.append(str(tmp / "fedbioacc_telemetry_int8_on_mesh.json"))
    Experiment.load(str(EXP / "fedbioacc_telemetry.json")).edit(**{
        "execution.mesh": (4, 2), **INT8_TELEMETRY}).save(guards[-1])
    procs["guards"] = _start(["-c", _GUARDS, *guards])
    procs["fused"] = _start(["-c", _FUSED])
    procs["sharded"] = _start(
        ["-c", _SHARDED, str(EXP / "fedbioacc_sharded_overlap.json")])
    yield procs, tmp
    for p in procs.values():
        if p.poll() is None:
            p.kill()


def _record(runs, name):
    procs, tmp = runs
    out, err = procs[name].communicate(timeout=600)
    assert procs[name].returncode == 0, err[-3000:] + out[-2000:]
    if name in ("sharded", "fused", "guards"):
        return json.loads(out.strip().splitlines()[-1])
    return json.loads((tmp / f"{name}.jsonl").read_text())


def test_grid_train_kind_on_a_reduced_config(runs, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a fake call reached the kernel build")
    monkeypatch.setattr(kbuild, "load", refuse)
    _reduced_grid(monkeypatch)
    rec = dryrun.run_one("granite-8b", "train_4k", device="cuda")
    assert rec["status"] == "OK", rec
    assert rec["n_micro"] == 2 and rec["remat_layers"] is False
    assert rec["kernels"] == {}            # the tree path: no engine kernel
    assert 0 < rec["per_device_argument_bytes"] < \
        rec["memory"]["argument_size_in_bytes"]
    assert rec["memory"]["host_fields"] == {"[0].step": 4}


def test_compressed_spec_memory_equals_reference(runs):
    from repro.api import Experiment as JExperiment
    from repro.api import build as jbuild
    spec = str(EXP / "fedbioacc_int8_topk.json")
    run = jbuild(JExperiment.load(spec))
    st = jax.eval_shape(run.init, jax.random.PRNGKey(0))
    bt = jax.eval_shape(run.batch_fn, jax.random.PRNGKey(0))
    ma = jax.jit(run.step, donate_argnums=(0,)).lower(st, bt).compile() \
        .memory_analysis()
    n_out = len(jax.tree.leaves(jax.eval_shape(run.step, st, bt)))
    rec = _record(runs, "fedbioacc_int8_topk")
    mem = rec["memory"]
    assert rec["status"] == "OK"
    assert rec["compression_check"] == "unsharded: no collectives to audit"
    assert rec["kernels"] == {}             # the CPU target: plain versions
    assert mem["host_fields"] == {"[0].step": 4}
    assert ma.argument_size_in_bytes == \
        mem["argument_size_in_bytes"] + sum(mem["host_fields"].values())
    assert ma.output_size_in_bytes == mem["output_size_in_bytes"] + sum(
        mem["output_host_fields"].values()) + 8 * n_out


@pytest.mark.parametrize("name,host", [
    ("fedbioacc_straggler", {"[0].step", "[0].stale", "[0].deadline"}),
    ("fedbioacc_faulty", {"[0].step", "[0].retry"}),
])
def test_host_decision_specs_trace(runs, name, host):
    rec = _record(runs, name)
    assert rec["status"] == "OK"
    assert set(rec["memory"]["host_fields"]) == host
    assert rec["cost"]["flops"] > 0


def test_sharded_spec_issues_the_expected_collectives(runs):
    res = _record(runs, "sharded")
    assert res["mesh"] == {"data": 4, "model": 2}
    assert res["equal"], (res["extra"], res["missing"])
    assert res["n"] > 0


@pytest.mark.parametrize("name", sorted(GUARDS) + ["fedbioacc_telemetry_int8"])
def test_guarded_spec_on_a_mesh_issues_the_expected_collectives(runs, name):
    res = _record(runs, "guards")
    rec = next(v for k, v in res.items() if k.endswith(f"/{name}_on_mesh.json"))
    assert rec["mesh"] == {"data": 4, "model": 2}
    assert rec["equal"], (rec["extra"], rec["missing"])
    assert set(rec["host"]) == GUARDS.get(name, {"[0].step"})
    assert (rec["telemetry"] > 0) == name.startswith("fedbioacc_telemetry")


def test_compressed_spec_on_a_mesh_passes_the_wire_check(runs):
    rec = _record(runs, "int8_on_mesh")
    assert rec["status"] == "OK"
    assert rec["mesh"] == {"data": 4, "model": 2}
    check = rec["compression_check"]
    assert check["ok"] and check["narrow_bytes"] >= check["expected_bytes"]
    assert rec["collectives"]["bytes_by_dtype"].get("s8", 0) > 0


def test_fused_mesh_on_a_reduced_config(runs):
    res = _record(runs, "fused")
    rec, skip = res["rec"], res["skip"]
    assert rec["status"] == "OK", rec
    assert rec["fused_mesh"] == [4, 2] and rec["overlap"] is False
    assert rec["mesh"] == {"data": 4, "model": 2}
    assert rec["kernels"] == {"storm3_step": 2}     # bf16 and f32 blocks
    counts = rec["collectives"]["counts"]
    assert counts["all-reduce"] > 0 and counts["all-gather"] > 0
    assert skip["status"] == "SKIP" and \
        skip["reason"] == "--fused-mesh applies to train shapes only"
