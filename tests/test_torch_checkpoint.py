"""The port's checkpoints (``repro_torch.checkpoint``) against the
reference's (``repro.checkpoint``).

The reference's own checkpoint tests restated on the port (the roundtrip
of ``tests/test_substrate.py``, the atomic, partial-write, corruption and
legacy-layout tests of ``tests/test_fault_tolerance.py``, the exact resume
of ``tests/test_api_spec.py`` on a fused ``FlatState``), then the format
both ways: a checkpoint either package writes is read by the other leaf
for leaf, bit for bit, for the straggler spec's fused ``FlatState`` (the
reference's field order, ``stale`` and ``deadline`` included) and for a
plain tree with a bf16 leaf; and the manifests' leaves and structure are
the same text."""
import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.api import Experiment as JExperiment  # noqa: E402
from repro.api import build as jbuild  # noqa: E402
from repro.checkpoint import load_checkpoint as jload  # noqa: E402
from repro.checkpoint import save_checkpoint as jsave  # noqa: E402
from repro_torch.api import Experiment, build  # noqa: E402
from repro_torch.api.spec import (AlgorithmSpec, ProblemSpec,  # noqa: E402
                                  ScheduleSpec)
from repro_torch.checkpoint import (CheckpointCorruptError,  # noqa: E402
                                    checkpoint_metadata, load_checkpoint,
                                    load_experiment, save_checkpoint)
from repro_torch.core.tree_util import (tree_flatten,  # noqa: E402
                                        tree_leaves, tree_structure)
from repro_torch.optim.sequences import FlatState  # noqa: E402
from torch_parity import bits  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STRAGGLER = os.path.join(ROOT, "experiments", "fedbioacc_straggler.json")


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _tree(v):
    return {"a": torch.full((3,), float(v)),
            "b": torch.full((2, 2), float(v), dtype=torch.bfloat16)}


def _jtree(v):
    return {"a": jnp.full((3,), float(v)),
            "b": jnp.full((2, 2), float(v), jnp.bfloat16)}


def _manifest(d):
    with open(os.path.join(d, "manifest.json")) as fh:
        return json.load(fh)


# ---------------------------------------------------------------------------
# tree paths and structure, as jax.tree_util writes them
# ---------------------------------------------------------------------------

def test_paths_and_structure_are_jax_keystr_and_treedef():
    port = {"a": torch.zeros(3), "b": {"c": torch.zeros(2)},
            "l": [torch.zeros(()), (torch.zeros(1),)], "t": ()}
    ref = {"a": jnp.zeros(3), "b": {"c": jnp.zeros(2)},
           "l": [jnp.zeros(()), (jnp.zeros(1),)], "t": ()}
    _, treedef = tree_flatten(port)
    jpairs, jtreedef = jax.tree_util.tree_flatten_with_path(ref)
    assert treedef.paths() == [jax.tree_util.keystr(p) for p, _ in jpairs]
    assert str(treedef) == str(jtreedef)
    # a NamedTuple is a node that unflattens to its own class
    state = FlatState((torch.zeros(2),), (), 3, (), torch.zeros(2), ())
    st = tree_structure(state)
    assert st.paths() == [".vars[0]", ".step", ".stale"]
    back = st.unflatten(tree_leaves(state))
    assert type(back) is FlatState and back.step == 3


# ---------------------------------------------------------------------------
# the reference's checkpoint tests, on the port
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    g = _gen(1)
    tree = {"a": torch.randn(4, 5, generator=g),
            "b": {"c": torch.arange(7, dtype=torch.int32),
                  "d": torch.randn(3, generator=g).to(torch.bfloat16)}}
    save_checkpoint(str(tmp_path / "ck"), tree, {"step": 42})
    like = {"a": torch.zeros(4, 5),
            "b": {"c": torch.zeros(7, dtype=torch.int32),
                  "d": torch.zeros(3, dtype=torch.bfloat16)}}
    loaded = load_checkpoint(str(tmp_path / "ck"), like)
    for a, b, c in zip(tree_leaves(tree), tree_leaves(loaded),
                       tree_leaves(like)):
        assert a.dtype == b.dtype and b is c      # copied in place
        np.testing.assert_array_equal(bits(a), bits(b))
    assert checkpoint_metadata(str(tmp_path / "ck"))["step"] == 42


def test_checkpoint_atomic_and_pruned(tmp_path):
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, _tree(1), {"step": 2})
    save_checkpoint(d, _tree(2), {"step": 4})
    got = load_checkpoint(d, _tree(0))
    np.testing.assert_array_equal(got["a"].numpy(), np.full((3,), 2.0))
    assert checkpoint_metadata(d)["step"] == 4
    names = sorted(os.listdir(d))
    assert "arrays-00000004.npz" in names       # stale step-2 file pruned
    assert "arrays-00000002.npz" not in names
    assert not any(n.endswith(".tmp") for n in names)


def test_checkpoint_survives_partial_write(tmp_path):
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, _tree(7), {"step": 2})
    # dying at every stage of the next save
    open(os.path.join(d, "arrays-00000004.npz.tmp"), "wb").write(b"\x00" * 9)
    open(os.path.join(d, "arrays-00000004.npz"), "wb").write(b"garbage")
    open(os.path.join(d, "manifest.json.tmp"), "wb").write(b"{ tru")
    got = load_checkpoint(d, _tree(0))
    np.testing.assert_array_equal(got["a"].numpy(), np.full((3,), 7.0))
    save_checkpoint(d, _tree(8), {"step": 4})
    names = sorted(os.listdir(d))
    assert not any(n.endswith(".tmp") for n in names)
    assert "arrays-00000004.npz" in names
    got = load_checkpoint(d, _tree(0))
    np.testing.assert_array_equal(got["a"].numpy(), np.full((3,), 8.0))


def test_checkpoint_corruption_drill(tmp_path):
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, _tree(5), {"step": 2})
    name = "arrays-00000002.npz"
    path = os.path.join(d, name)
    blob = bytearray(open(path, "rb").read())
    blob[len(blob) // 2] ^= 0xFF                  # one flipped byte
    open(path, "wb").write(bytes(blob))
    like = _tree(0)
    with pytest.raises(CheckpointCorruptError, match=name):
        load_checkpoint(d, like)
    assert float(like["a"][0]) == 0.0             # nothing was copied
    # manifests without digests are not checked
    save_checkpoint(d, _tree(6), {"step": 4})
    manifest = _manifest(d)
    del manifest["sha256"]
    with open(os.path.join(d, "manifest.json"), "w") as fh:
        json.dump(manifest, fh)
    got = load_checkpoint(d, _tree(0))
    np.testing.assert_array_equal(got["a"].numpy(), np.full((3,), 6.0))


def test_checkpoint_legacy_layout_fallback(tmp_path):
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, _tree(3), {"step": 1})
    manifest = _manifest(d)
    os.rename(os.path.join(d, manifest.pop("arrays")),
              os.path.join(d, "arrays.npz"))
    with open(os.path.join(d, "manifest.json"), "w") as fh:
        json.dump(manifest, fh)
    got = load_checkpoint(d, _tree(0))
    np.testing.assert_array_equal(got["a"].numpy(), np.full((3,), 3.0))


@pytest.mark.parametrize("like", [
    {"a": torch.zeros(4), "b": torch.zeros(2, 2, dtype=torch.bfloat16)},
    {"a": torch.zeros(3), "b": torch.zeros(2, 2)},
    {"a": torch.zeros(3)},
], ids=["shape", "dtype", "leaves"])
def test_load_refuses_a_different_structure(tmp_path, like):
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, _tree(4), {"step": 1})
    with pytest.raises(ValueError):
        load_checkpoint(d, like)


def test_checkpoint_embeds_spec_and_resumes_exactly(tmp_path):
    """The reference's resume test on the port: an interrupted fused run,
    rebuilt from the embedded spec alone, continues the uninterrupted one
    bit for bit."""
    exp = Experiment(
        algorithm=AlgorithmSpec("fedbioacc"),
        problem=ProblemSpec(arch="mamba2-130m", reduced=True, num_clients=4,
                            per_client=1, seq_len=16),
        schedule=ScheduleSpec(steps=4, local_steps=2, lr_x=0.05, lr_y=0.05,
                              lr_u=0.05, neumann_q=2, neumann_tau=0.3)
    ).edit(**{"execution.fuse_storm": True, "execution.storm_block": 256})
    run = build(exp, device="cpu")
    data = _gen(7)
    batches = [run.batch_fn(data) for _ in range(4)]

    state = run.init(_gen(exp.schedule.seed))
    for b in batches[:2]:
        state, _ = run.step(state, b)
    ckpt = str(tmp_path / "ck")
    save_checkpoint(ckpt, state, {"step": 2}, experiment=exp)
    for b in batches[2:]:
        state, _ = run.step(state, b)

    exp2 = load_experiment(ckpt)
    assert exp2 == exp
    run2 = build(exp2, device="cpu")
    state2 = load_checkpoint(ckpt, run2.init(_gen(123)))
    assert state2.step == 2
    for b in batches[2:]:
        state2, _ = run2.step(state2, b)
    assert state2.step == state.step == 4
    for a, b in zip(tree_leaves(state), tree_leaves(state2)):
        np.testing.assert_array_equal(bits(a), bits(b))


# ---------------------------------------------------------------------------
# the format, both ways
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def straggler_init():
    """The reduced straggler spec's initial state on both packages."""
    jrun = jbuild(JExperiment.load(STRAGGLER))
    key = jax.random.PRNGKey(jrun.spec.schedule.seed)
    run = build(Experiment.load(STRAGGLER), device="cpu")
    return jrun, key, run


def test_reference_checkpoint_loads_into_the_port_state(tmp_path,
                                                        straggler_init):
    jrun, key, run = straggler_init
    jstate = jrun.init(key)
    d = str(tmp_path / "ref")
    jsave(d, jstate, {"step": 0}, experiment=jrun.spec)
    state = load_checkpoint(d, run.init(_gen(5)))
    assert isinstance(state, FlatState) and state.step == int(jstate.step)
    pairs = [(state.vars, jstate.vars), (state.mom, jstate.mom),
             ((state.stale,), (jstate.stale,)),
             ((state.deadline,), (jstate.deadline,))]
    assert state.stale.dtype == torch.int32
    assert state.deadline.dtype == torch.float32
    for port, ref in pairs:
        assert len(port) == len(ref) > 0
        for p, r in zip(port, ref):
            assert tuple(p.shape) == r.shape
            np.testing.assert_array_equal(bits(p), bits(r))
    # the embedded spec is the port's too
    assert load_experiment(d) == Experiment.load(STRAGGLER).normalize()


def test_port_checkpoint_loads_into_the_reference_state(tmp_path,
                                                        straggler_init):
    jrun, key, run = straggler_init
    state = run.init(_gen(5))
    state = state._replace(stale=torch.arange(8, dtype=torch.int32),
                           deadline=torch.tensor(1.75))
    d, dref = str(tmp_path / "port"), str(tmp_path / "ref")
    save_checkpoint(d, state, {"step": 0}, experiment=run.spec)
    jstate = jload(d, jax.eval_shape(jrun.init, key))
    for field, leaf in (("vars", state.vars[0]), ("mom", state.mom[0]),
                        ("stale", state.stale),
                        ("deadline", state.deadline)):
        got = getattr(jstate, field)
        got = got[0] if field in ("vars", "mom") else got
        assert got.dtype == np.dtype(str(leaf.dtype).replace("torch.", ""))
        np.testing.assert_array_equal(bits(leaf), bits(got))
    assert int(jstate.step) == 0 and jstate.retry == () and jstate.ef == ()
    # the two manifests describe the state in the same words
    jsave(dref, jrun.init(key), {"step": 0})
    mine, theirs = _manifest(d), _manifest(dref)
    for k in ("leaves", "treedef", "arrays"):
        assert mine[k] == theirs[k], k


def test_plain_tree_both_ways(tmp_path):
    d, dref = str(tmp_path / "port"), str(tmp_path / "ref")
    save_checkpoint(d, _tree(2.5), {"step": 3})
    got = jload(d, jax.eval_shape(lambda: _jtree(0)))
    assert got["b"].dtype == jnp.bfloat16
    for k in ("a", "b"):
        np.testing.assert_array_equal(bits(_tree(2.5)[k]), bits(got[k]))
    jsave(dref, _jtree(-1.25), {"step": 3})
    mine = load_checkpoint(dref, _tree(0))
    assert mine["b"].dtype == torch.bfloat16
    for k in ("a", "b"):
        np.testing.assert_array_equal(bits(mine[k]), bits(_jtree(-1.25)[k]))
    assert {k: _manifest(d)[k] for k in ("leaves", "treedef", "metadata")} \
        == {k: _manifest(dref)[k] for k in ("leaves", "treedef", "metadata")}
