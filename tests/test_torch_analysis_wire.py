"""The verifier's collective and wire audits (``repro_torch.analysis``) on
spawned gloo ranks on the CPU, and its CLI.

* A 1-rank world at mesh ``(1, 1)`` (``fedbioacc_local.json`` edited so):
  the clean step issues exactly its planned collectives and audits clean;
  an extra 7-element f32 ``all_reduce`` on the data group, wrapped into
  the step (``testing.seeded_all_reduce``), fires W101; one of a private
  run's length fires W102, with ``PRIVATE`` in its message; the guarded
  means (unguarded, mean, clip, trim, no screen), called on the substrate,
  issue the collectives the model's mirror expects; with x at a cadence
  of 2 the audit records rounds 1 and 2 and audits clean.
* An 8-rank world: ``experiments/fedbioacc_sharded_overlap.json`` audits
  clean for W101–W105 on its ``[4, 2]`` mesh, and so does its edit with
  ``hierarchy_period`` 2 (rounds 1 and 2: pod-local, then global); so do
  the straggler, faulty and telemetry specs edited to that mesh, the
  faulty one also with every telemetry group it allows (the health
  screen's gathers), each step's telemetry collectives planned.
* A 2-rank world: the compressed spec's wire probe at ``(2, 1)`` audits
  clean, and the bytes its communication subprogram moves equal
  ``expected_wire_bytes`` dtype for dtype.
* ``python -m repro_torch.analysis --all experiments/ --lint src/repro_torch
  --device cpu`` (a subprocess in a session of its own, killed whole past
  its time) exits 0 with an OK line for each of the ten specs.

Each world is one spawn over a ``FileStore`` under ``tmp_path``
(``tests/torch_mesh.py:run_ranks`` joins its ranks within a timeout); no
process group is set up in the pytest worker.  JAX-free: the ranks import
this module to find their targets."""
import json
import os
import signal
import subprocess
import sys

import pytest
import torch

import torch_mesh as tm

torch.set_num_threads(1)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SHARDED = "fedbioacc_sharded_overlap.json"
# the specs edited to the [4, 2] mesh whose steps the audit holds
MESH_VARIANTS = {
    "straggler": ("fedbioacc_straggler.json", {}),
    "faulty": ("fedbioacc_faulty.json", {}),
    "telemetry": ("fedbioacc_telemetry.json", {}),
    "faulty-telemetry": ("fedbioacc_faulty.json",
                         {"telemetry.metrics": None}),
}


def _spec(name: str, **edits):
    from repro_torch.api import Experiment
    exp = Experiment.load(os.path.join(ROOT, "experiments", name))
    return exp.edit(**edits) if edits else exp


def _leave(rank: int, out: str, res: dict) -> None:
    import torch.distributed as dist
    if rank == 0:
        with open(out, "w") as fh:
            json.dump(res, fh)
    dist.barrier()
    dist.destroy_process_group()


def _findings(fs) -> list:
    return [list(f) for f in fs]


def local_ranks(rank: int, world: int, store: str, out: str) -> None:
    """The 1-rank world: the clean and the two seeded audits."""
    from repro_torch.analysis import collectives as coll
    from repro_torch.api import build
    from repro_torch.launch.mesh import init_ranks
    from repro_torch.testing import seeded_all_reduce

    init_ranks(rank, world, store)
    torch.set_num_threads(1)
    run = build(_spec("fedbioacc_local.json", **{"execution.mesh": (1, 1)}),
                device="cpu")
    expected, info = coll.expected_step_collectives(run)
    actual = coll.step_collectives(run, 1)
    private = sorted(info["private_elems"])
    _leave(rank, out, {
        "expected": sorted(map(list, expected.items())),
        "actual": sorted(map(list, actual.items())),
        "private": private,
        "clean": _findings(coll.audit_step_collectives(run)),
        "w101": _findings(coll.audit_step_collectives(
            seeded_all_reduce(run, 7))),
        "w102": _findings(coll.audit_step_collectives(
            seeded_all_reduce(run, private[0]))),
        "guarded": guarded_means(run.shard.mesh),
        "cadence": _cadence_audit(),
    })


def _cadence_audit() -> dict:
    """``fedbioacc_local.json`` at (1, 1) with x at a cadence of 2: the
    audit records rounds 1 and 2, and round 1 reduces nothing."""
    from repro_torch.analysis import collectives as coll
    from repro_torch.api import build
    run = build(_spec("fedbioacc_local.json", **{
        "execution.mesh": (1, 1), "schedule.comm_every": {"x": 2}}),
        device="cpu")
    expected, info = coll.expected_step_collectives(run, 1)
    return {"rounds": list(coll.audit_rounds(run)),
            "round1_is_oracle_only": expected == info["oracle_gathers"],
            "findings": _findings(coll.audit_step_collectives(run))}


def guarded_means(mesh) -> dict:
    """The guarded means' collectives (``flat._robust_mean_sharded``; the
    engine refuses faults and robustness on a mesh, so the substrate is
    called directly) against the model's ``robust_run``: case → (recorded,
    expected), each sorted."""
    from repro_torch.analysis import collectives as coll
    from repro_torch.optim import flat

    m = 4
    tmpl = {"x": torch.zeros(70), "y": torch.zeros(30)}
    spec = flat.make_spec(tmpl, sections=("x", "y"), block=8)
    gen = torch.Generator().manual_seed(0)
    bufs = flat.flatten_tree(spec, {k: torch.randn((m, v.numel()),
                                                   generator=gen)
                                    for k, v in tmpl.items()}, batch_dims=1)
    corrupt = (torch.tensor([0.0, 0.0, 1.0, 0.0]),
               torch.tensor([0.0, 0.0, 0.0, 1.0]), 25.0)
    cases = {"unguarded": None,
             **{a: flat.RobustCfg(aggregator=a) for a in ("mean", "clip",
                                                          "trim")},
             "no-screen": flat.RobustCfg(screen=False)}
    out = {}
    for name, robust in cases.items():
        with coll.record_collectives(mesh) as rec:
            flat.client_mean_masked(
                spec, tuple(b.clone() for b in bufs), ("mean", "none"),
                weights=torch.ones(m), corrupt=corrupt, robust=robust,
                verdicts=[], shard=flat.make_shard_ctx(mesh))
        want = coll._Expect(data_size=1, use_scatter=False, m_local=m)
        for mode, a, b, _, _ in flat._section_runs(spec.groups[0],
                                                   ("mean", "none")):
            if mode == "mean":
                want.robust_run(b - a, "float32", robust, verdicts=True)
        out[name] = (sorted(map(list, rec.counter().items())),
                     sorted(map(list, want.c.items())))
    return out


def sharded_ranks(rank: int, world: int, store: str, out: str) -> None:
    """The 8-rank world: the committed sharded spec's pass 1."""
    from repro_torch.analysis.verify import mesh_pass
    from repro_torch.launch.mesh import init_ranks

    init_ranks(rank, world, store)
    torch.set_num_threads(1)
    findings, notes = mesh_pass(_spec(SHARDED), device="cpu")
    # the hierarchical schedule on the mesh: round 1 pod-local (grouped
    # all-reduces over 2 pods of the data axis), round 2 global
    hier, _ = mesh_pass(_spec(SHARDED, **{"schedule.hierarchy_period": 2}),
                        device="cpu")
    guards = {}
    for name, (path, edits) in MESH_VARIANTS.items():
        f, n = mesh_pass(_spec(path, **{"execution.mesh": list(tm.MESH),
                                        **edits}), device="cpu")
        guards[name] = {"findings": _findings(f), "notes": n}
    _leave(rank, out, {"findings": _findings(findings), "notes": notes,
                       "hierarchical": _findings(hier), "guards": guards})


def probe_ranks(rank: int, world: int, store: str, out: str) -> None:
    """The 2-rank world: the compressed spec's wire probe."""
    from repro_torch.analysis import collectives as coll
    from repro_torch.analysis.verify import PROBE_MESH
    from repro_torch.api import build
    from repro_torch.launch.mesh import init_ranks

    init_ranks(rank, world, store)
    torch.set_num_threads(1)
    run = build(_spec("fedbioacc_int8_topk.json",
                      **{"execution.mesh": PROBE_MESH}), device="cpu")
    with coll.record_collectives(run.shard.mesh) as rec:
        run.step.comm_fn(coll.state_at(run, 1))
    _leave(rank, out, {
        "step": _findings(coll.audit_step_collectives(run)),
        "wire": _findings(coll.audit_wire(run)),
        "bytes": rec.wire()["bytes_by_dtype"],
        "want": coll.expected_wire_bytes(coll.comm_expected(run),
                                         PROBE_MESH[0]),
    })


def _world(target, tmp_path, world: int) -> dict:
    out = str(tmp_path / "out.json")
    tm.run_ranks(target, str(tmp_path), out, world=world, timeout=600)
    with open(out) as fh:
        return json.load(fh)


def test_w101_w102_seeds_fire_on_a_one_rank_mesh(tmp_path):
    res = _world(local_ranks, tmp_path, 1)
    # the clean step issues exactly its planned collectives: two f32
    # reductions of the averaged run and two oracle gathers of the rows
    assert res["actual"] == res["expected"]
    assert res["clean"] == []
    assert {f[0] for f in res["w101"]} == {"W101"}
    assert len(res["w101"]) == 1 and "x7 over data" in res["w101"][0][2]
    assert {f[0] for f in res["w102"]} == {"W102"}
    assert "PRIVATE" in res["w102"][0][2]
    # the model's mirror of the guarded means holds their collectives
    for case, (recorded, expected) in res["guarded"].items():
        assert recorded == expected, case
    assert res["cadence"] == {"rounds": [1, 2], "round1_is_oracle_only": True,
                              "findings": []}


@pytest.fixture(scope="module")
def eight(tmp_path_factory):
    """What rank 0 of the 8-rank world wrote (:func:`sharded_ranks`)."""
    return _world(sharded_ranks, tmp_path_factory.mktemp("eight"), tm.WORLD)


def test_sharded_spec_audits_clean_on_eight_ranks(eight):
    res = eight
    assert res["findings"] == [] and res["hierarchical"] == []
    step, wire = res["notes"]
    assert step.startswith("step: ") and "== plan" in step
    assert wire.startswith("wire: ")


@pytest.mark.parametrize("name", sorted(MESH_VARIANTS))
def test_mesh_variant_audits_clean_on_eight_ranks(eight, name):
    """Stragglers, faults with the guarded means and in-band telemetry on
    the mesh: every collective of the step planned, the telemetry passes'
    among them (none without telemetry), and the wire byte-exact."""
    res = eight["guards"][name]
    assert res["findings"] == []
    step, wire = res["notes"]
    assert step.startswith("step: ") and "== plan" in step
    assert wire.startswith("wire: ")
    with_telemetry = "telemetry" in name
    assert (" + 0 telemetry;" not in step) == with_telemetry, step


def test_int8_wire_probe_bytes_equal_the_model(tmp_path):
    res = _world(probe_ranks, tmp_path, 2)
    assert res["step"] == [] and res["wire"] == []
    assert res["bytes"] == res["want"]
    assert res["want"]["s8"] > 0 and set(res["want"]) == {"f32", "s8"}


def test_cli_verifies_every_committed_spec_on_the_cpu():
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.analysis", "--all",
         "experiments/", "--lint", "src/repro_torch", "--device", "cpu"],
        cwd=ROOT, env=env, text=True, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    assert proc.returncode == 0, out + err
    lines = out.splitlines()
    specs = sorted(n for n in os.listdir(os.path.join(ROOT, "experiments"))
                   if n.endswith(".json"))
    ok = [ln for ln in lines if ln.startswith("OK experiments/")]
    assert sorted(ln.split()[1].rstrip(":").split("/")[-1]
                  for ln in ok) == specs
    assert "lint src/repro_torch: OK" in lines
    sharded = next(ln for ln in ok if SHARDED in ln)
    assert "step: " in sharded and "wire: " in sharded
    assert lines[-1] == ("repro_torch.analysis: 10 spec(s), 0 finding(s), "
                         "0 error(s)")
