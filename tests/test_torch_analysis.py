"""The port's static verifier, ``repro_torch.analysis``, in one process:
every rule that needs no ranks demonstrated to FIRE on a seeded violation,
the clean builds and the committed tree silent, and parity with the
reference's ``repro.analysis`` (the restated ``tests/test_analysis.py``).

* The registry: the reference's fourteen IDs and names.
* The lint, one seeded source per rule in torch spellings
  (``torch.manual_seed(0)`` and ``torch.randn(3)`` for L302,
  ``x.sum().item()`` and ``float(torch.mean(x))`` in engine layers only for
  L303, ``jr.split(key)`` under ``from repro_torch import random as jr``
  in round-loop layers only for L304), the waiver, the committed
  ``src/repro_torch`` tree, and the reference's own L301/L302/L305/L306
  seeds giving the same rules under both packages.
* S201 both ways, S202 through ``BARE_EDITS`` without
  ``participation.clients_per_round``, S203 through a monkeypatched
  ``resolve_metric_groups``.
* W103–W105 through injected wire records, on the compressed spec's
  expected model at mesh ``(1, 1)``.  Runs on a mesh need ranks
  (``tests/test_torch_analysis_wire.py``), so the model is taken from the
  unsharded build with a stand-in ``(1, 1)`` shard context: its flat
  layout is the ``(1, 1)`` build's (``shards`` 1).
* Parity of the expected collectives with the reference's at ``(1, 1)``
  (``fedbioacc_local`` and ``fedbioacc_int8_topk``, as its fixtures): the
  port's multiset, less its oracle gathers, is the reference's less the
  weight-sum psums (the port's weights are host values every rank holds
  for all M clients); ``private_elems``, ``comm_elems``, ``events`` and the
  wire bytes agree.
* The two seed-red reference tests pinned (ROADMAP queue 3 item 7):
  under jax 0.9.0 their seeded ``shard_map`` psum binds ``psum_invariant``,
  which ``repro.analysis.collectives`` does not count."""
import os
from collections import Counter

import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from jax.experimental.shard_map import shard_map  # noqa: E402
from jax.sharding import Mesh as JaxMesh  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.analysis import RULES as REF_RULES  # noqa: E402
from repro.analysis import collectives as ref_coll  # noqa: E402
from repro.analysis.lint import lint_source as ref_lint  # noqa: E402
from repro.api import Experiment as RefExperiment  # noqa: E402
from repro.api import build as ref_build  # noqa: E402
from repro_torch.analysis import LINT_RULES, RULES  # noqa: E402
from repro_torch.analysis import collectives as coll  # noqa: E402
from repro_torch.analysis import structure as struct  # noqa: E402
from repro_torch.analysis.lint import lint_paths, lint_source  # noqa: E402
from repro_torch.api import Experiment, build  # noqa: E402
from repro_torch.optim import flat  # noqa: E402

torch.set_num_threads(1)

_ROOT = os.path.join(os.path.dirname(__file__), "..")


def _spec(name):
    return Experiment.load(os.path.join(_ROOT, "experiments", name))


def _rules(findings):
    return {f.rule for f in findings}


# ---------------------------------------------------------------------------
# rule registry
# ---------------------------------------------------------------------------

def test_registry_complete_and_the_references():
    assert set(LINT_RULES) == {r for r in RULES if r.startswith("L")}
    for r, rule in RULES.items():
        assert rule.id == r
        assert rule.proves and rule.fixit, r
    assert [(r.id, r.name) for r in RULES.values()] == \
        [(r.id, r.name) for r in REF_RULES.values()]


# ---------------------------------------------------------------------------
# L3xx: the source lint, one seeded violation per rule
# ---------------------------------------------------------------------------

def test_l301_wall_clock_fires_and_the_waiver_holds():
    assert _rules(lint_source("import time\nt = time.perf_counter()\n",
                              "x.py")) == {"L301"}
    src = ("import time\n"
           "t = time.time()  # analysis: ignore[L301] driver\n")
    assert lint_source(src, "x.py") == []


@pytest.mark.parametrize("src,n", [
    ("import torch\ntorch.manual_seed(0)\n", 1),
    ("import torch\nv = torch.randn(3)\n", 1),
    ("import torch\nv = torch.randint(0, 5, (3,))\n", 1),
    ("import torch\ntorch.cuda.manual_seed_all(0)\n", 1),
    ("import numpy as np\nv = np.random.rand(3)\n", 1),
    ("import random\nv = random.random()\n", 2),      # import + call
])
def test_l302_global_rng_fires(src, n):
    fs = lint_source(src, "x.py")
    assert _rules(fs) == {"L302"} and len(fs) == n


def test_l302_explicit_generator_passes():
    src = ("import torch\n"
           "gen = torch.Generator().manual_seed(0)\n"
           "gen.manual_seed(1)\n"
           "v = torch.randn(3, generator=gen)\n"
           "from repro_torch import random\n"
           "k = random.split(random.PRNGKey(0))\n")
    assert lint_source(src, "x.py") == []


def test_l303_host_sync_fires_in_engine_only():
    src = ("import torch\n"
           "def f(x):\n"
           "    return float(torch.mean(x)) + x.sum().item()\n")
    fs = lint_source(src, "x.py", engine=True)
    assert _rules(fs) == {"L303"} and len(fs) == 2
    assert lint_source(src, "x.py", engine=False) == []


@pytest.mark.parametrize("imp,call", [
    ("from repro_torch import random as jr", "jr.split(key)"),
    ("import repro_torch.random as rnd", "rnd.split(key)"),
    ("from repro_torch.random import split", "split(key)"),
    ("from repro_torch import random as jr", "jr.PRNGKey(r)"),
])
def test_l304_key_chain_fires_in_round_loop(imp, call):
    src = f"{imp}\ndef f(key, r):\n    return {call}\n"
    assert _rules(lint_source(src, "x.py", round_loop=True)) == {"L304"}
    assert lint_source(src, "x.py", round_loop=False) == []


def test_l304_fold_in_and_seeded_keys_pass():
    ok = ("from repro_torch import random as jr\n"
          "def g(spec, r):\n"
          "    return jr.fold_in(jr.PRNGKey(spec.seed), r)\n")
    assert lint_source(ok, "x.py", round_loop=True) == []


def test_l305_unfrozen_spec_fires():
    src = ("from dataclasses import dataclass\n"
           "@dataclass\n"
           "class FooSpec:\n"
           "    a: int = 0\n")
    assert _rules(lint_source(src, "x.py")) == {"L305"}
    assert lint_source(src.replace("@dataclass",
                                   "@dataclass(frozen=True)"),
                       "x.py") == []


def test_l306_mutable_default_fires():
    assert _rules(lint_source("def f(xs=[]):\n    return xs\n",
                              "x.py")) == {"L306"}


def test_layers_scope_the_rules():
    src = "import torch\ndef f(x):\n    return x.item()\n"
    for layer, fires in (("optim", True), ("models", True),
                         ("launch", False), ("telemetry", False)):
        path = os.path.join("src", "repro_torch", layer, "m.py")
        assert bool(lint_source(src, path)) == fires, layer


def test_committed_tree_lints_clean():
    assert lint_paths([os.path.join(_ROOT, "src", "repro_torch")]) == []


# the reference's own seeds (tests/test_analysis.py) of the rules that do
# not name JAX: the same rules fire under both packages
REF_SEEDS = [
    "import time\nt = time.perf_counter()\n",
    "import time\nt = time.time()  # analysis: ignore[L301] driver\n",
    "import numpy as np\nv = np.random.rand(3)\n",
    "import random\nv = random.random()\n",
    ("from dataclasses import dataclass\n@dataclass\nclass FooSpec:\n"
     "    a: int = 0\n"),
    ("from dataclasses import dataclass\n@dataclass(frozen=True)\n"
     "class FooSpec:\n    a: int = 0\n"),
    "def f(xs=[]):\n    return xs\n",
]


@pytest.mark.parametrize("src", REF_SEEDS)
def test_reference_seeds_give_the_same_rules(src):
    mine, ref = lint_source(src, "x.py"), ref_lint(src, "x.py")
    assert [(f.rule, f.where) for f in mine] == \
        [(f.rule, f.where) for f in ref]


# ---------------------------------------------------------------------------
# S2xx: structure — slot, trace-identity and telemetry-inertness seeds
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def local_run():
    return build(_spec("fedbioacc_local.json"), device="cpu")


def test_s201_fires_both_directions(local_run):
    assert struct.audit_state_slots(local_run) == []
    # participation on, stale leaf dropped -> "expects a stale leaf"
    missing = local_run._replace(
        init=lambda gen: local_run.init(gen)._replace(stale=()))
    fs = struct.audit_state_slots(missing)
    assert _rules(fs) == {"S201"} and "stale" in fs[0].message

    # featureless spec, stale leaf present -> "zero-leaf contract broken"
    run = build(_spec("fedavg.json"), device="cpu")
    assert struct.audit_state_slots(run) == []
    extra = run._replace(
        init=lambda gen: run.init(gen)._replace(
            stale=torch.zeros((2,), dtype=torch.int32)))
    fs = struct.audit_state_slots(extra)
    assert _rules(fs) == {"S201"} and "zero-leaf" in fs[0].message


def test_s202_clean_and_leaked_feature_fires(monkeypatch):
    exp = _spec("fedbioacc_local.json")
    assert struct.audit_bare_jaxpr(exp, device="cpu") == []
    # the regression the rule exists for: a bare form whose edits miss a
    # normalize() promotion trigger, so the "feature-off" build still
    # carries the uniform sampler's mask and staleness machinery
    edits = {k: v for k, v in struct.BARE_EDITS.items()
             if k != "participation.clients_per_round"}
    monkeypatch.setattr(struct, "BARE_EDITS", edits)
    fs = struct.audit_bare_jaxpr(exp, device="cpu")
    assert _rules(fs) == {"S202"}
    assert "not the pre-feature baseline" in fs[0].message


def test_s203_clean_and_noninert_telemetry_fires(monkeypatch):
    from repro_torch.optim import sequences
    exp = _spec("fedbioacc_telemetry.json")
    assert struct.audit_telemetry_inert(exp, device="cpu") == []
    # events-only telemetry (metrics=()) resolved to the default groups:
    # the "telemetry stopped switching off" bug
    orig = sequences.resolve_metric_groups
    monkeypatch.setattr(sequences, "resolve_metric_groups",
                        lambda metrics, **kw: orig(None, **kw))
    fs = struct.audit_telemetry_inert(exp, device="cpu")
    assert _rules(fs) == {"S203"}


def test_step_trace_is_canonical_and_counts_the_kernels():
    exp = _spec("fedbioacc_int8_topk.json")
    a, b = (struct.run_trace(build(exp, device="cpu")) for _ in range(2))
    assert a == b
    last = a.splitlines()[-1]
    assert "storm3_step=1" in last and "quantpack=2" in last
    assert "0x" not in a                    # no address in the text


# ---------------------------------------------------------------------------
# W1xx: the expected model at (1, 1) and the wire rules on injected records
# ---------------------------------------------------------------------------

class _Mesh11:
    """A stand-in ``(1, 1)`` mesh: what the expected model reads."""
    shape = {"data": 1, "model": 1}


def _at_1x1(run):
    return run._replace(shard=flat.ShardCtx(_Mesh11()))


@pytest.fixture(scope="module")
def int8_run():
    return _at_1x1(build(_spec("fedbioacc_int8_topk.json"), device="cpu"))


def _wire(run):
    return coll.expected_wire_bytes(coll.comm_expected(run), 1)


def test_wire_model_accepts_exact_bytes(int8_run):
    ok = {"bytes": {}, "counts": {}, "bytes_by_dtype": _wire(int8_run)}
    assert coll.audit_wire(int8_run, coll=ok) == []


def test_w103_f32_wire_under_int8_fires(int8_run):
    want = _wire(int8_run)
    bad = {"bytes": {}, "counts": {},
           "bytes_by_dtype": {"f32": sum(want.values())}}
    assert "W103" in _rules(coll.audit_wire(int8_run, coll=bad))
    with pytest.raises(RuntimeError, match="int8"):
        coll.check_compressed_collectives(int8_run.spec, int8_run.step.spec,
                                          bad)


def test_w104_byte_mismatch_fires(int8_run):
    want = _wire(int8_run)
    off = dict(want, f32=want.get("f32", 0) + 4)   # one f32 element extra
    fs = coll.audit_wire(int8_run, coll={"bytes": {}, "counts": {},
                                         "bytes_by_dtype": off})
    assert _rules(fs) == {"W104"}


@pytest.mark.parametrize("op", ["all-to-all", "collective-permute",
                                "all-gather"])
def test_w105_resharding_op_fires(int8_run, op):
    fs = coll.audit_wire(int8_run, coll={
        "bytes": {op: 64}, "counts": {op: 1},
        "bytes_by_dtype": _wire(int8_run)})
    assert "W105" in _rules(fs)


# the reference's weight-sum psum of a weighted run: the port's weights are
# host values every rank holds, so it issues none
WSUM = ("psum", ("data",), False, "float32", 1)


@pytest.mark.parametrize("name,weighted_runs", [
    ("fedbioacc_local.json", 1), ("fedbioacc_int8_topk.json", 0)])
def test_expected_collectives_match_the_reference(name, weighted_runs):
    ref_run = ref_build(RefExperiment.load(
        os.path.join(_ROOT, "experiments", name)).edit(
            **{"execution.mesh": (1, 1), "schedule.steps": 2}))
    ref_exp, ref_info = ref_coll.expected_step_collectives(ref_run)
    run = _at_1x1(build(_spec(name), device="cpu"))
    mine, info = coll.expected_step_collectives(run)
    oracle = info["oracle_gathers"]
    # two oracle evaluations a step, each gathering the one f32 buffer's
    # rows over the model axis
    assert sum(oracle.values()) == 2 and all(
        e[0] == "all_gather" and e[1] == ("model",) for e in oracle)
    events = ref_info["events"]
    assert ref_exp - (mine - oracle) == Counter(
        {WSUM: events * weighted_runs} if weighted_runs else {})
    assert (mine - oracle) - ref_exp == Counter()
    for k in ("events", "comm_elems", "private_elems"):
        assert info[k] == ref_info[k], k
    want = ref_coll.expected_wire_bytes(ref_exp, 1)
    want["f32"] -= 4 * events * weighted_runs
    assert _wire(run) == want


# ---------------------------------------------------------------------------
# the two seed-red reference tests (ROADMAP queue 3 item 7), pinned
# ---------------------------------------------------------------------------

def _psum_fn(check_rep: bool):
    mesh = JaxMesh(np.array(jax.devices()[:1]).reshape(1, 1),
                   ("data", "model"))
    return shard_map(lambda x: jax.lax.psum(x, "data"), mesh=mesh,
                     in_specs=P(), out_specs=P(), check_rep=check_rep)


def _prims(jaxpr) -> list:
    out = []
    for eqn in jaxpr.eqns:
        out.append(eqn.primitive.name)
        for sub in ref_coll._sub_jaxprs(eqn.params):
            out += _prims(sub)
    return out


def test_reference_seed_binds_psum_invariant_which_it_does_not_count():
    x = jnp.zeros((7,), jnp.float32)
    seeded = _psum_fn(check_rep=True)      # the reference test's default
    assert "psum_invariant" in _prims(jax.make_jaxpr(seeded)(x).jaxpr)
    assert "psum_invariant" not in ref_coll.COLLECTIVE_PRIMS
    assert ref_coll.collect_collectives(seeded, x) == Counter()
    # the engine's own shard_maps pass check_rep=False: psum, counted
    engine_like = _psum_fn(check_rep=False)
    assert "psum" in _prims(jax.make_jaxpr(engine_like)(x).jaxpr)
    assert ref_coll.collect_collectives(engine_like, x) == Counter(
        {("psum", ("data",), False, "float32", 7): 1})
