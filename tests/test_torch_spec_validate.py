"""The port's ``Experiment.validate`` against the reference's.

Every case is one invalid edit of a committed spec, made in its JSON: the
reference's ``Experiment.validate`` and the port's must both raise their
``SpecError`` with the same message, so the same field path.  All ten
committed specs validate in both; a spec the reference accepts and the
port does not run yet (``fedbioacc_faulty.json``) passes ``validate`` and is
refused by ``build`` naming its ROADMAP item.  The port's copies of the
reference's name lists (algorithms with their hyperparameters and sections,
architectures, samplers, ...) equal the reference's."""
import copy
import json
import re
from pathlib import Path

import pytest

pytest.importorskip("jax")
from repro.api import registry as jregistry  # noqa: E402
from repro.api.spec import Experiment as JExperiment  # noqa: E402
from repro.api.spec import SpecError as JSpecError  # noqa: E402

from repro_torch.api import Experiment, build  # noqa: E402
from repro_torch.api.build import unported_features  # noqa: E402
from repro_torch.api import spec as tspec  # noqa: E402
from repro_torch.api.spec import SpecError  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
EXPERIMENTS = sorted((ROOT / "experiments").glob("*.json"))

FAULTY, TELEMETRY = "fedbioacc_faulty.json", "fedbioacc_telemetry.json"
SHARDED = "fedbioacc_sharded_overlap.json"
STRAGGLER, COMPRESSED = "fedbioacc_straggler.json", "fedbioacc_int8_topk.json"
INT8_ON = {"compression": {"quant": "int8", "sections": ["y"]}}

# (committed spec, edits of its JSON by dotted path, the field named)
CASES = [
    ("fedbioacc.json", {"algorithm.name": "fednest"}, "algorithm.name"),
    ("fedbioacc.json", {"algorithm.params": {"bogus": 1.0}},
     "algorithm.params"),
    ("fedavg.json", {"algorithm.params": {"c_nu": 1.0}}, "algorithm.params"),
    ("fedbioacc.json", {"problem.arch": "gpt2"}, "problem.arch"),
    ("fedbioacc.json", {"problem.num_clients": 0}, "problem.num_clients"),
    ("fedbioacc.json", {"problem.param_dtype": "float16"},
     "problem.param_dtype"),
    ("fedbioacc.json", {"problem.client_sizes": [1.0]},
     "problem.client_sizes"),
    ("fedbioacc.json", {"participation.sampler": "roundrobin"},
     "participation.sampler"),
    ("fedbioacc.json", {"participation.sampler": "weighted"},
     "participation"),
    ("fedbioacc.json", {"participation.clients_per_round": 3},
     "participation.clients_per_round"),
    ("fedbioacc_local.json", {"participation.trace_path": "avail.jsonl"},
     "participation.trace_path"),
    ("fedbioacc.json", {"participation.sampler": "trace",
                        "participation.clients_per_round": 1},
     "participation.clients_per_round"),
    ("fedbio.json", {"execution.fuse_storm": False,
                     "execution.mesh": [2, 1]}, "execution"),
    ("fedbioacc.json", {"execution.overlap": True}, "execution.overlap"),
    ("fedbioacc.json", {"execution.scatter_comm": True},
     "execution.scatter_comm"),
    ("fedbioacc.json", {"execution.mesh": [2, 1, 1]}, "execution.mesh"),
    ("fedbioacc_sharded_overlap.json", {"problem.num_clients": 6},
     "execution.mesh"),
    ("fedbioacc.json", {"schedule.steps": 0}, "schedule"),
    ("fedavg.json", {"schedule.comm_every": {"u": 2}}, "schedule.comm_every"),
    ("fedbioacc.json", {"schedule.comm_every": {"u": 0}},
     "schedule.comm_every"),
    (FAULTY, {"execution.fuse_storm": False}, "faults"),
    (FAULTY, {"schedule.hierarchy_period": 2}, "faults"),
    (FAULTY, {"faults.nan_rate": 1.5}, "faults.nan_rate"),
    (FAULTY, {"faults.start_round": -1}, "faults.start_round"),
    (FAULTY, {"robustness.aggregator": "median"}, "robustness.aggregator"),
    (FAULTY, {"robustness.trim_frac": 0.5}, "robustness.trim_frac"),
    (FAULTY, {"robustness.clip_factor": 0.0}, "robustness.clip_factor"),
    (FAULTY, {"robustness.spike_factor": 1.0}, "robustness.spike_factor"),
    (FAULTY, {"robustness.ring": 0}, "robustness"),
    (COMPRESSED, {"execution.fuse_storm": False}, "compression"),
    (COMPRESSED, {"compression.quant": "fp4"}, "compression.quant"),
    (COMPRESSED, {"compression.topk_frac": 1.0}, "compression.topk_frac"),
    (COMPRESSED, {"compression.sections": []}, "compression.sections"),
    ("fedbio_local.json", INT8_ON, "compression.sections"),
    ("fedbioacc_local.json", INT8_ON, "compression.sections"),
    (TELEMETRY, {"telemetry.sink": 3}, "telemetry.sink"),
    (TELEMETRY, {"telemetry.metrics": ["latency"]}, "telemetry.metrics"),
    (TELEMETRY, {"telemetry.metrics": ["health"]}, "telemetry.metrics"),
    (TELEMETRY, {"telemetry.metrics": ["stragglers"]}, "telemetry.metrics"),
    (STRAGGLER, {"schedule.hierarchy_period": 2}, "stragglers"),
    (STRAGGLER, {"stragglers.late_policy": "wait"}, "stragglers.late_policy"),
    (STRAGGLER, {"stragglers.deadline": 0.0}, "stragglers.deadline"),
    (STRAGGLER, {"participation.sampler": "full",
                 "participation.clients_per_round": 0},
     "stragglers.over_provision"),
    (STRAGGLER, {"stragglers.quorum": 0.0}, "stragglers.quorum"),
    (STRAGGLER, {"stragglers.backoff": 0.5}, "stragglers.backoff"),
    (STRAGGLER, {"stragglers.adapt_rate": 2.0}, "stragglers.adapt_rate"),
]


def _json(name: str) -> dict:
    return json.loads((ROOT / "experiments" / name).read_text())


def _edited(name: str, edits: dict) -> str:
    d = copy.deepcopy(_json(name))
    for path, value in edits.items():
        head, _, rest = path.partition(".")
        if rest:
            d.setdefault(head, {})[rest] = value
        else:
            d[head] = value
    return json.dumps(d)


def _field(err: Exception) -> str:
    m = re.match(r"Experiment\.([\w.]+):", str(err))
    assert m, str(err)
    return m.group(1)


@pytest.mark.parametrize("name,edits,field", CASES,
                         ids=[f"{n}:{','.join(e)}" for n, e, _ in CASES])
def test_invalid_spec_is_refused_alike(name, edits, field):
    text = _edited(name, edits)
    with pytest.raises(JSpecError) as want:
        JExperiment.from_json(text).validate()
    with pytest.raises(SpecError) as got:
        Experiment.from_json(text).validate()
    assert _field(want.value) == _field(got.value) == field
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("edits", [{"problem.client_sizes": [1.0]},
                                   {"algorithm.params": {"bogus": 1.0}}])
def test_build_refuses_with_spec_error_first(edits):
    """Two specs the port's ``build`` used to accept (``client_sizes`` of
    the wrong length) or refuse with a ``TypeError`` (an unknown
    hyperparameter): it raises ``SpecError``, as the reference does."""
    exp = Experiment.from_json(_edited("fedbioacc.json", edits))
    with pytest.raises(SpecError):
        build(exp, device="cpu")


def test_unsupported_version_is_refused_alike():
    with pytest.raises(JSpecError) as want:
        JExperiment().edit(version=2).validate()
    with pytest.raises(SpecError) as got:
        Experiment().edit(version=2).validate()
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("path", EXPERIMENTS, ids=lambda p: p.name)
def test_committed_spec_validates_in_both(path):
    JExperiment.load(str(path)).validate()
    Experiment.load(str(path)).validate()


def test_known_but_unported_spec_validates_then_build_refuses():
    # the sharded spec validates and asks for nothing unported: outside a
    # process group build asks for its 8 ranks; so does the straggler spec
    # on a mesh, which the sharded substrate now runs (it was refused by
    # name until it did)
    exp = Experiment.load(str(ROOT / "experiments" / SHARDED))
    assert exp.validate() is exp
    with pytest.raises(RuntimeError, match="needs 8 devices"):
        build(exp, device="cpu")
    strag = Experiment.load(str(ROOT / "experiments" /
                                "fedbioacc_straggler.json")).edit(
        **{"execution.mesh": [4, 2], "execution.fuse_storm": True})
    assert unported_features(strag.validate().normalize()) == []
    with pytest.raises(RuntimeError, match="needs 8 devices"):
        build(strag, device="cpu")
    # what the port still refuses is named with its item
    with pytest.raises(NotImplementedError) as err:
        build(strag.edit(**{"execution.use_flash": True}), device="cpu")
    assert "execution.use_flash" in str(err.value)
    assert ("ROADMAP queue 1, 'Training through the model kernels'"
            in str(err.value))


def test_name_lists_equal_the_reference():
    from repro.configs import ARCHS
    from repro.federation.faults import AGGREGATORS
    from repro.federation.participation import SAMPLERS
    from repro.federation.stragglers import LATE_POLICIES
    from repro.optim.sequences import PRIVATE, SPECS
    from repro.telemetry.spec import METRIC_GROUPS

    from repro_torch.api import registry as tregistry
    assert set(tspec.ALGORITHMS) == set(jregistry.algorithms())
    for name, algo in tspec.ALGORITHMS.items():
        entry = jregistry.get(name)
        assert set(algo.hparams) == set(entry.hparams), name
        assert algo.sections == entry.sections, name
        assert algo.private == tuple(q.section for q in SPECS[name].sequences
                                     if q.comm == PRIVATE), name
    for name in tregistry.names():      # the ported trainers agree too
        entry = tregistry.get(name)
        assert set(entry.hparams) == set(tspec.ALGORITHMS[name].hparams)
        assert entry.sections == tspec.ALGORITHMS[name].sections
    assert set(tspec.ARCH_NAMES) == set(ARCHS)
    assert (tspec.SAMPLERS, tspec.AGGREGATORS, tspec.LATE_POLICIES,
            tspec.METRIC_GROUPS) == (SAMPLERS, AGGREGATORS, LATE_POLICIES,
                                     METRIC_GROUPS)


@pytest.mark.parametrize("name, change", [
    ("fedavg", {"hparams": {}}),                       # a missing hparam
    ("fedbio", {"hparams": {"momentum": 0.9}}),        # an unknown one
    ("fedbio", {"sequences": "fedbio_local"}),         # other sections
    ("fedbio_local", {"sequences": "no_private"}),     # y not PRIVATE
])
def test_register_refuses_a_trainer_that_disagrees(name, change):
    from repro_torch.api import registry as tregistry
    from repro_torch.optim import sequences as tseqs
    aspec = tseqs.SPECS[name]
    if change.get("sequences") == "no_private":
        aspec = aspec._replace(sequences=tuple(
            q._replace(comm=tseqs.AVERAGED) for q in aspec.sequences))
    elif "sequences" in change:
        aspec = tseqs.SPECS[change["sequences"]]
    hparams = change.get("hparams",
                         {k: 1.0 for k in tspec.ALGORITHMS[name].hparams})
    with pytest.raises(ValueError, match="disagrees with spec.ALGORITHMS"):
        tregistry.register(name, aspec, hparams=hparams)
