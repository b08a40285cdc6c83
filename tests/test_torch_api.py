"""The port's package boundary and its spec surface: no file of
``repro_torch`` (nor ``chip_smoke.py``) imports JAX or the JAX package; every committed experiment
parses; ``fedbioacc.json``, ``fedbio.json``, ``fedbio_local.json`` and
``fedavg.json`` build; every other committed spec is refused with
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
# what each other committed spec sets that the port does not run yet
REFUSED = {
    "fedbioacc_faulty.json": ["faults", "robustness"],
    "fedbioacc_int8_topk.json": ["compression"],
    "fedbioacc_local.json": ["algorithm 'fedbioacc_local'",
                             "participation sampling"],
    "fedbioacc_sharded_overlap.json": ["execution.mesh", "execution.overlap"],
    "fedbioacc_straggler.json": ["participation sampling", "stragglers"],
    "fedbioacc_telemetry.json": ["telemetry"],
}


def test_port_imports_neither_jax_nor_the_reference():
    offenders = []
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    for path in files + [ROOT / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                if name.split(".")[0] in ("jax", "jaxlib", "repro"):
                    offenders.append(f"{path.relative_to(ROOT)}: {name}")
    assert not offenders, offenders


def test_committed_specs_are_all_covered():
    assert sorted(p.name for p in EXPERIMENTS) == \
        sorted(["fedbioacc.json", *SGD_KIND, *REFUSED])


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
