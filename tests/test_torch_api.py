"""The port's package boundary and its spec surface: no file of
``repro_torch`` (nor ``chip_smoke.py``) imports JAX or the JAX package; every committed experiment
parses; ``fedbioacc.json``, ``fedbio.json``, ``fedbio_local.json``,
``fedavg.json``, ``fedbioacc_int8_topk.json``, ``fedbioacc_local.json``,
``fedbioacc_straggler.json``, ``fedbioacc_faulty.json`` and
``fedbioacc_telemetry.json`` build; the other committed spec (sharded)
asks for nothing unported (it builds in a world of 8 ranks:
``tests/test_torch_sharded_engine.py``), and its edit with in-band
telemetry metrics is refused with ``NotImplementedError`` naming the
feature the port does not run yet on a mesh (so is training through the
model kernels); the edits that were
refused until their slice ported them (the hierarchical schedule,
per-sequence cadences, compression with participation or stragglers, the
unfused tree path, rematerialization) build and step; and the entry
points want a card unless the CPU is asked for."""
import ast
from pathlib import Path

import pytest
import torch

from repro_torch.api import Experiment, build
from repro_torch.api.build import resolve_device, unported_features
from repro_torch.core.tree_util import tree_leaves

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
EXPERIMENTS = sorted((ROOT / "experiments").glob("*.json"))

# committed specs of the engine's sgd kind, and their sections
SGD_KIND = {"fedavg.json": ("params",), "fedbio.json": ("x", "y", "u"),
            "fedbio_local.json": ("x", "y")}
# committed specs with a compression block: (quant, top-k fraction)
COMPRESSED = {"fedbioacc_int8_topk.json": ("int8", 0.1)}
# committed specs that sample clients: (sampler, clients a round)
SAMPLED = {"fedbioacc_local.json": ("uniform", 2)}
# committed specs with stragglers: (late policy, clients the over-provisioned
# sampler takes a round)
STRAGGLED = {"fedbioacc_straggler.json": ("drop", 6)}
# committed specs with faults: (aggregator, retry budget)
FAULTED = {"fedbioacc_faulty.json": ("clip", 2)}
# committed specs with telemetry: the metric groups each step computes
TELEMETRIED = {"fedbioacc_telemetry.json": ("norms", "drift")}
# each other committed spec, and the telemetry spec edited to ask for
# rematerialization: (edits, what the port refuses in it; None where the
# slice that ported the feature now runs it)
REFUSED = {
    "fedbioacc_sharded_overlap.json": ({"telemetry.metrics": ["norms"]},
                                       None),
    "fedbioacc_telemetry.json": ({"execution.remat": True}, None),
}


def _imported_names(path: Path):
    """Every module name ``path`` imports, at any depth of its code; for
    ``from a import b`` both ``a`` and ``a.b`` (``b`` may be a module)."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
            yield from (f"{node.module}.{a.name}" for a in node.names)


def _repo_file(name: str):
    """The file of this repo that module ``name`` would load, if any."""
    for base in (ROOT / "src", ROOT / "tests", ROOT):
        stem = base.joinpath(*name.split("."))
        for path in (stem.with_suffix(".py"), stem / "__init__.py"):
            if path.is_file():
                return path
    return None


def test_port_imports_neither_jax_nor_the_reference():
    """Every file of ``repro_torch`` and ``chip_smoke.py``, and every module
    of this repo that they import (followed to the end), imports neither
    JAX nor the JAX package."""
    offenders = []
    todo = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    todo.append(ROOT / "chip_smoke.py")
    seen = set(todo)
    while todo:
        path = todo.pop()
        for name in _imported_names(path):
            if name.split(".")[0] in ("jax", "jaxlib", "repro"):
                offenders.append(f"{path.relative_to(ROOT)}: {name}")
                continue
            dep = _repo_file(name)
            if dep is not None and dep not in seen:
                seen.add(dep)
                todo.append(dep)
    assert not offenders, offenders
    # the walk follows test code too: the tests' JAX bridge would be caught
    bridge = _repo_file("torch_parity")
    assert bridge == ROOT / "tests" / "torch_parity.py"
    assert "jax" in set(_imported_names(bridge))


def test_committed_specs_are_all_covered():
    assert sorted(p.name for p in EXPERIMENTS) == \
        sorted(set(["fedbioacc.json", *SGD_KIND, *COMPRESSED, *SAMPLED,
                    *STRAGGLED, *FAULTED, *TELEMETRIED, *REFUSED]))


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_unported_features_are_refused_by_name(name):
    """The sharded spec, which the port runs (outside a process group
    ``build`` asks for its 8 ranks), also with in-band telemetry metrics,
    refused until the mesh ran them: nothing is refused and ``build``
    again asks for its ranks (the metrics on the mesh:
    ``tests/test_torch_sharded_engine.py``).  The telemetry spec with
    remat, refused until rematerialization was ported, takes a step with
    its in-band metrics, bit for bit the step without remat."""
    edits, features = REFUSED[name]
    base = Experiment.load(str(ROOT / "experiments" / name))
    exp = base.edit(**edits)
    if base.execution.mesh is not None:
        for e in (base, exp):
            assert unported_features(e.validate().normalize()) == []
            with pytest.raises(RuntimeError, match="needs 8 devices"):
                build(e, device="cpu")
        if features is None:
            return
    if features is None:
        states = []
        for e in (edits, {k: False for k in edits}):
            run = build(exp.edit(**e, **{"schedule.steps": 1}), device="cpu")
            state, metrics = run.step(run.init(torch.Generator().manual_seed(
                0)), run.batch_fn(torch.Generator().manual_seed(1)))
            assert metrics["step"] == 1 and run.step.telemetry_groups
            states.append(state)
        assert all(torch.equal(a, b) for a, b in
                   zip(states[0].vars + states[0].mom,
                       states[1].vars + states[1].mom))
        return
    with pytest.raises(NotImplementedError) as err:
        build(exp, device="cpu")
    for feature in features:
        assert feature in str(err.value), (feature, str(err.value))
    assert "ROADMAP" in str(err.value)


@pytest.mark.parametrize("name", sorted(TELEMETRIED))
def test_telemetry_spec_builds_and_steps_on_cpu(name):
    exp = Experiment.load(str(ROOT / "experiments" / name))
    run = build(exp.edit(**{"schedule.steps": 1}), device="cpu")
    assert run.step.telemetry_groups == TELEMETRIED[name]
    assert run.step.telemetry == exp.telemetry
    state = run.init(torch.Generator().manual_seed(0))
    state, metrics = run.step(state, run.batch_fn(
        torch.Generator().manual_seed(1)))
    assert state.step == metrics["step"] == 1
    for sec in run.init.spec.sections:
        # STORM steps with the entering momentum: step 1 does not move
        assert float(metrics[f"upd_norm/{sec}"]) == 0.0
        assert float(metrics[f"mom_norm/{sec}"]) > 0.0
        assert float(metrics[f"drift/{sec}"]) == 0.0   # equal clients


def test_fedbioacc_spec_builds_on_cpu():
    exp = Experiment.load(str(ROOT / "experiments" / "fedbioacc.json"))
    run = build(exp, device="cpu")
    assert run.device == torch.device("cpu") and run.steps == 2
    # full width is accepted as an edit (built here only as a spec check)
    big = exp.edit(**{"problem.reduced": False, "problem.seq_len": 512})
    assert big.problem.reduced is False


@pytest.mark.parametrize("name", sorted(SGD_KIND))
def test_sgd_kind_spec_builds_on_cpu(name):
    exp = Experiment.load(str(ROOT / "experiments" / name))
    run = build(exp, device="cpu")
    assert run.device == torch.device("cpu") and run.steps == 2
    assert run.init.spec.sections == SGD_KIND[name]


@pytest.mark.parametrize("name", sorted(COMPRESSED))
def test_compressed_spec_builds_on_cpu(name):
    exp = Experiment.load(str(ROOT / "experiments" / name))
    run = build(exp, device="cpu")
    assert run.device == torch.device("cpu") and run.steps == 4
    cp = run.spec.compression
    assert (cp.quant, cp.topk_frac) == COMPRESSED[name]
    state = run.init(torch.Generator().manual_seed(0))
    # error feedback: one f32 zero buffer per variable and momentum buffer
    assert [len(e) for e in state.ef] == [len(state.vars), len(state.mom)]
    assert all(e.dtype == torch.float32 and not torch.any(e)
               for side in state.ef for e in side)


@pytest.mark.parametrize("name", sorted(SAMPLED))
def test_sampled_spec_builds_on_cpu(name):
    exp = Experiment.load(str(ROOT / "experiments" / name))
    run = build(exp, device="cpu")
    assert run.device == torch.device("cpu")
    part = run.init.participation
    assert part is run.step.participation is not None
    assert (run.participation.sampler, part.spec.clients_per_round) == \
        SAMPLED[name]
    state = run.init(torch.Generator().manual_seed(0))
    assert state.stale.dtype == torch.int32 and not torch.any(state.stale)
    assert state.stale.shape == (exp.problem.num_clients,)


@pytest.mark.parametrize("name", sorted(STRAGGLED))
def test_straggled_spec_builds_and_steps_on_cpu(name):
    exp = Experiment.load(str(ROOT / "experiments" / name))
    run = build(exp.edit(**{"schedule.steps": 1}), device="cpu")
    assert run.device == torch.device("cpu")
    strag, part = run.step.stragglers, run.init.participation
    assert strag is run.init.stragglers is not None
    assert (strag.spec.late_policy, part.spec.clients_per_round) == \
        STRAGGLED[name]
    # the reference's Run.participation: the spec before over-provisioning
    # (4 of 8); the step samples with the over-provisioned one (6 of 8)
    assert run.participation == exp.participation
    assert part.spec == exp.participation._replace(
        clients_per_round=STRAGGLED[name][1])
    state = run.init(torch.Generator().manual_seed(0))
    assert state.deadline.dtype == torch.float32
    assert float(state.deadline) == exp.stragglers.deadline
    assert state.stale.shape == (exp.problem.num_clients,)
    state, metrics = run.step(state, run.batch_fn(
        torch.Generator().manual_seed(1)))
    assert state.step == metrics["step"] == 1
    decided = metrics["decision"]
    assert decided["quorum"] <= int(decided["arrivals"].sum()) <= 6
    assert decided["deadline"] == exp.stragglers.deadline


def _two_steps(exp: Experiment):
    """Build ``exp`` on the CPU and take one round (2 steps); returns the
    run, the entering state, the state after and the last step's
    metrics."""
    run = build(exp.edit(**{"schedule.steps": 2}), device="cpu")
    state = run.init(torch.Generator().manual_seed(0))
    entering, data = state, torch.Generator().manual_seed(1)
    for _ in range(2):
        state, metrics = run.step(state, run.batch_fn(data))
    assert state.step == metrics["step"] == 2
    return run, entering, state, metrics


def _rows(run, bufs, sec: str) -> torch.Tensor:
    """Section ``sec`` of [M, N] buffers, [M, n] in f32."""
    spec = run.init.spec
    s = spec.sections.index(sec)
    return torch.cat([b[:, a:z].float() for grp, b in zip(spec.groups, bufs)
                      for t, a, z in grp.extents if t == s], 1)


def _one_mean(rows: torch.Tensor, clients) -> bool:
    return all(torch.equal(rows[clients[0]], rows[i]) for i in clients)


@pytest.mark.parametrize("edit", [
    {"compression.quant": "int8"},
    {"compression.quant": "bf16", "participation.sampler": "full",
     "stragglers.over_provision": 0},
])
def test_stragglers_with_compression_are_refused_by_name(edit):
    """Refused until the arrival-weighted compressed mean was ported
    (ROADMAP queue 1, 'Compression, the rest'): now one round builds and
    runs, the arrivals leave it on one mean row and the late clients
    (``drop``) keep their entering rows."""
    exp = Experiment.load(str(ROOT / "experiments" /
                              "fedbioacc_straggler.json"))
    run, entering, state, metrics = _two_steps(exp.edit(**edit))
    assert run.spec.compression.quant == edit["compression.quant"]
    arrivals = metrics["decision"]["arrivals"]
    ins = [i for i in range(8) if arrivals[i] > 0]
    assert 0 < len(ins) < 8
    for sec in ("x", "y", "u"):
        rows, before = (_rows(run, s.vars, sec) for s in (state, entering))
        assert _one_mean(rows, ins)
        for i in range(8):
            if i not in ins:
                assert torch.equal(rows[i], before[i])


@pytest.mark.parametrize("edit,item", [
    ({"schedule.hierarchy_period": 2},
     "'Participation, staleness and cadence'"),
    ({"schedule.comm_every": {"x": 2}},
     "'Participation, staleness and cadence'"),
    ({"compression.quant": "int8"}, "'Compression, the rest'"),
])
def test_sampled_spec_refuses_unported_features_by_item(edit, item):
    """``fedbioacc_local.json`` (2 of 4 clients a round) with an edit that
    was refused until ROADMAP queue 1 ``item`` ported it: one round builds
    and runs.  Pod-local (groups {0, 1} and {2, 3}): each pod's
    participants share their x rows; x at a cadence of 2: round 1 reduces
    nothing; int8: the participants share one x row."""
    exp = Experiment.load(str(ROOT / "experiments" / "fedbioacc_local.json"))
    run, _, state, _ = _two_steps(exp.edit(**edit))
    ins = [i for i in range(4) if run.init.participation.mask_fn(0)[i] > 0]
    x = _rows(run, state.vars, "x")
    assert len(ins) == 2 and item in ("'Participation, staleness and "
                                      "cadence'", "'Compression, the rest'")
    if "schedule.hierarchy_period" in edit:
        for pod in ((0, 1), (2, 3)):
            assert _one_mean(x, [i for i in pod if i in ins] or [pod[0]])
        assert _one_mean(x, ins) == (ins[0] // 2 == ins[1] // 2)
    else:
        assert _one_mean(x, ins) == ("compression.quant" in edit)


@pytest.mark.parametrize("edit,feature", [
    ({"schedule.hierarchy_period": 2}, "schedule.hierarchy_period"),
    ({"participation.clients_per_round": 4},
     "the participation-weighted compressed mean (ROADMAP queue 1, "
     "'Compression, the rest')"),
    ({"execution.mesh": [2, 1]}, "execution.mesh"),
])
def test_compression_with_unported_features_is_refused_by_name(edit,
                                                                feature):
    """``fedbioacc_int8_topk.json`` quantizing only (8 clients): the grouped
    int8 mean (2 pods of 4) and the participation-weighted int8 mean run a
    round; on a mesh, refused until the sharded substrate was ported, the
    spec asks for nothing unported, and outside a process group ``build``
    asks for the mesh's 2 ranks (the compressed means on a mesh run in
    ``tests/test_torch_sharded_substrate.py`` and
    ``tests/test_torch_sharded_engine.py``)."""
    exp = Experiment.load(str(ROOT / "experiments" / "fedbioacc_int8_topk.json"))
    exp = exp.edit(**{"compression.topk_frac": 0.0, **edit})
    if "execution.mesh" in edit:
        assert feature == "execution.mesh" and exp.execution.mesh == (2, 1)
        assert unported_features(exp.validate().normalize()) == []
        with pytest.raises(RuntimeError, match="needs 2 devices"):
            build(exp, device="cpu")
        return
    run, entering, state, _ = _two_steps(exp)
    x, before = (_rows(run, s.vars, "x") for s in (state, entering))
    if "schedule.hierarchy_period" in edit:
        assert _one_mean(x, [0, 1, 2, 3]) and _one_mean(x, [4, 5, 6, 7])
        assert not torch.equal(x[0], x[4])
    else:
        ins = [i for i in range(8)
               if run.init.participation.mask_fn(0)[i] > 0]
        assert len(ins) == 4 and _one_mean(x, ins)
        assert all(torch.equal(x[i], before[i]) for i in range(8)
                   if i not in ins)


@pytest.mark.parametrize("edit", [{"schedule.hierarchy_period": 2},
                                  {"schedule.comm_every": {"u": 2}},
                                  {"execution.use_flash": True},
                                  {"execution.fuse_storm": False},
                                  {"execution.remat": True}])
def test_single_feature_edits_are_refused(edit):
    """``fedbioacc.json`` (2 clients) with one edit.  The hierarchical
    schedule and the per-sequence cadence run a round: with 2 pods of one
    client round 1 averages nothing; with u at a cadence of 2 it averages x
    and not u.  The unfused tree path and remat, refused until they were
    ported, run a round too, averaging x and u (on the tree path every
    leaf of both).  ``use_flash`` stays refused."""
    exp = Experiment.load(str(ROOT / "experiments" / "fedbioacc.json"))
    if "execution.use_flash" in edit:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            build(exp.edit(**edit), device="cpu")
        return
    run, _, state, _ = _two_steps(exp.edit(**edit))
    if "execution.fuse_storm" in edit:
        assert type(state).__name__ == "FedBiOAccTrainState"
        for sec in ("x", "u", "nu", "q"):
            assert all(torch.equal(v[0], v[1])
                       for v in tree_leaves(getattr(state, sec)))
        return
    x, u = (_rows(run, state.vars, sec) for sec in ("x", "u"))
    averaged = "schedule.hierarchy_period" not in edit
    assert _one_mean(x, [0, 1]) == averaged
    assert _one_mean(u, [0, 1]) == ("execution.remat" in edit)


@pytest.mark.parametrize("edit,why", [
    ({"execution.use_flash": True}, "differentiate through its Pallas flash"),
    ({"execution.use_lru_kernel": True},
     "differentiate through its Pallas LRU-scan"),
    ({"problem.arch": "recurrentgemma-9b"}, "family 'hybrid'"),
])
def test_training_through_model_kernels_is_refused_by_name(edit, why):
    """The model kernels run forward only (serving): a training spec that
    turns them on is refused with its reason and its ROADMAP item.  The
    hybrid family, refused here until its training was held to the
    reference, now trains on the plain model path (through its kernels it
    stays refused)."""
    exp = Experiment.load(str(ROOT / "experiments" / "fedbioacc.json"))
    if "problem.arch" in edit:
        run = build(exp.edit(**edit), device="cpu")
        assert why == f"family {run.model_cfg.family!r}"
        edit = {**edit, "execution.use_lru_kernel": True}
        why = "differentiate through its Pallas LRU-scan"
    with pytest.raises(NotImplementedError) as err:
        build(exp.edit(**edit), device="cpu")
    assert why in str(err.value)
    assert "ROADMAP queue 1, 'Training through the model kernels'" in \
        str(err.value)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    exp = Experiment.load(str(ROOT / "experiments" / "fedbioacc.json"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build(exp)


@pytest.mark.parametrize("name", sorted(FAULTED))
def test_faulty_spec_builds_and_steps_on_cpu(name):
    exp = Experiment.load(str(ROOT / "experiments" / name))
    run = build(exp.edit(**{"schedule.steps": 1}), device="cpu")
    faults, rob = run.step.faults, run.step.robustness
    assert faults is run.init.faults is not None
    assert faults.spec == exp.faults and rob == exp.robustness
    assert (rob.aggregator, rob.retry_budget) == FAULTED[name]
    state = run.init(torch.Generator().manual_seed(0))
    assert state.retry.dtype == torch.int32 and int(state.retry) == 0
    assert state.retry.shape == ()
    state, metrics = run.step(state, run.batch_fn(
        torch.Generator().manual_seed(1)))
    assert state.step == metrics["step"] == 1
    keep, nan, byz = metrics["decision"]["faults"]
    # round 0 is before the spec's start_round: clean, all 8 clients sent
    assert keep.tolist() == [1.0] * 8 and not nan.any() and not byz.any()
    # step 1 does not communicate: no guarded reduction ran
    assert metrics["decision"]["health"] == [] and \
        metrics["decision"]["screened"] == []
