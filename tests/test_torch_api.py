"""The port's package boundary and its spec surface: no file of
``repro_torch`` (nor ``chip_smoke.py``) imports JAX or the JAX package; every committed experiment
parses; ``fedbioacc.json``, ``fedbio.json``, ``fedbio_local.json``,
``fedavg.json`` and ``fedbioacc_int8_topk.json`` build; every other
committed spec is refused with
``NotImplementedError`` naming the feature the port does not run yet; and the
entry points want a card unless the CPU is asked for."""
import ast
from pathlib import Path

import pytest
import torch

from repro_torch.api import Experiment, build
from repro_torch.api.build import resolve_device

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
EXPERIMENTS = sorted((ROOT / "experiments").glob("*.json"))

# committed specs of the engine's sgd kind, and their sections
SGD_KIND = {"fedavg.json": ("params",), "fedbio.json": ("x", "y", "u"),
            "fedbio_local.json": ("x", "y")}
# committed specs with a compression block: (quant, top-k fraction)
COMPRESSED = {"fedbioacc_int8_topk.json": ("int8", 0.1)}
# what each other committed spec sets that the port does not run yet
REFUSED = {
    "fedbioacc_faulty.json": ["faults", "robustness"],
    "fedbioacc_local.json": ["algorithm 'fedbioacc_local'",
                             "participation sampling"],
    "fedbioacc_sharded_overlap.json": ["execution.mesh", "execution.overlap"],
    "fedbioacc_straggler.json": ["participation sampling", "stragglers"],
    "fedbioacc_telemetry.json": ["telemetry"],
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
        sorted(["fedbioacc.json", *SGD_KIND, *COMPRESSED, *REFUSED])


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_unported_features_are_refused_by_name(name):
    exp = Experiment.load(str(ROOT / "experiments" / name))
    with pytest.raises(NotImplementedError) as err:
        build(exp, device="cpu")
    for feature in REFUSED[name]:
        assert feature in str(err.value), (feature, str(err.value))
    assert "ROADMAP" in str(err.value)


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


@pytest.mark.parametrize("edit,feature", [
    ({"schedule.hierarchy_period": 2}, "schedule.hierarchy_period"),
    ({"participation.clients_per_round": 4}, "participation sampling"),
    ({"execution.mesh": [2, 1]}, "execution.mesh"),
])
def test_compression_with_unported_features_is_refused_by_name(edit,
                                                                feature):
    exp = Experiment.load(str(ROOT / "experiments" / "fedbioacc_int8_topk.json"))
    exp = exp.edit(**{"compression.topk_frac": 0.0, **edit})
    with pytest.raises(NotImplementedError, match="ROADMAP") as err:
        build(exp, device="cpu")
    assert feature in str(err.value)


@pytest.mark.parametrize("edit", [{"schedule.hierarchy_period": 2},
                                  {"schedule.comm_every": {"u": 2}},
                                  {"execution.use_flash": True},
                                  {"execution.fuse_storm": False},
                                  {"execution.remat": True}])
def test_single_feature_edits_are_refused(edit):
    exp = Experiment.load(str(ROOT / "experiments" / "fedbioacc.json"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build(exp.edit(**edit), device="cpu")


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    exp = Experiment.load(str(ROOT / "experiments" / "fedbioacc.json"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build(exp)
