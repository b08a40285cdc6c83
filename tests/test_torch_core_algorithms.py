"""The problem-level algorithms of the port (``repro_torch.core``: the
paper's Algorithms 1-4 and the Table-1 baselines, built by
``make_algorithm``) against the JAX package's, and the model-scale
trainer's unfused oracles.

One round of every algorithm from the same keys, the reference's round
jitted as its examples run it, the port's problem built from the
reference's arrays: every state leaf within ``RTOL``/``ATOL`` (the
reference's own bound between its fused and tree loops,
``tests/test_sequences.py``), the step counter and ``comm_floats`` equal.
CommFedBiO's top-k over a whole leaf is discontinuous: an entry the two
sides rank on either side of the threshold must lie within 2·D of it (D
the largest difference of the two compressor inputs;
``testing.leaf_topk_flips``), and the port then takes the reference's
decision, so the rest is held at the same bound.
On the port alone, ``fuse_storm`` changes how a round runs and nothing
else (three rounds, also with ``hierarchy_period`` set), and the PRIVATE y
of the local-lower specs never enters a reduction."""
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.api import Experiment as JExperiment  # noqa: E402
from repro.api import build as jbuild  # noqa: E402
from repro.api.registry import make_algorithm as jmake  # noqa: E402
from repro.config import FederatedConfig as JConfig  # noqa: E402
from repro.core import baselines as jbase  # noqa: E402
from repro.core import problems as jp  # noqa: E402
from repro_torch import random as jr  # noqa: E402
from repro_torch.api import Experiment, build  # noqa: E402
from repro_torch.config import FederatedConfig  # noqa: E402
from repro_torch.core import baselines as tbase  # noqa: E402
from repro_torch.core import make_algorithm  # noqa: E402
from repro_torch.core import problems as tp  # noqa: E402
from repro_torch.core.tree_util import tree_flatten, tree_leaves  # noqa: E402
from repro_torch.kernels.storm import kernel as tk  # noqa: E402
from repro_torch.optim import flat  # noqa: E402
from repro_torch.optim import sequences as seqs  # noqa: E402
from repro_torch.testing import leaf_topk_flips  # noqa: E402
from torch_parity import f32, to_torch  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
RTOL = ATOL = 1e-5
CORE = ("fedbio", "fedbioacc", "fedbio_local", "fedbioacc_local")
BASELINES = ("fednest", "commfedbio", "stocbio", "mrbo")
# algorithm → its kernel on the flat substrate
KERNEL = {"fedbio": "sgd3_step", "fedbio_local": "sgd3_step",
          "fedbioacc": "storm3_step", "fedbioacc_local": "storm3_step"}
GRID = [(a, fo, fs) for a in CORE for fo in (False, True)
        for fs in (False, True)] + [(a, False, False) for a in BASELINES]


def _quadratic():
    jprob = jp.quadratic_problem(jax.random.PRNGKey(4), num_clients=8,
                                 dx=10, dy=10, noise=0.3, hetero=1.0)
    b = jprob.sample_batches(jax.random.PRNGKey(0))
    arrays = to_torch({k: b[k] for k in ("Ag", "B", "c", "D", "x0", "y0")})
    return jprob, tp.quadratic_from_arrays(arrays, noise=0.3)


def _cleaning():
    jprob = jp.data_cleaning_problem(jax.random.PRNGKey(1), num_clients=8,
                                     n_train=256, corrupt_frac=0.4)
    data = to_torch(dict(jprob.data))
    data["ytr"], data["yval"] = data["ytr"].long(), data["yval"].long()
    return jprob, tp.data_cleaning_from_data(data)


def _hyperrep():
    jprob = jp.hyperrep_problem(jax.random.PRNGKey(2), num_clients=8,
                                hetero=0.5)
    data = to_torch(dict(jprob.data))
    data["y"] = data["y"].long()
    return jprob, tp.hyperrep_from_data(data)


def _fairness():
    jprob = jp.fair_federated_problem(jax.random.PRNGKey(0), num_clients=8,
                                      hard_clients=2)
    data = to_torch(dict(jprob.data))
    data["y"] = data["y"].long()
    return jprob, tp.fair_federated_from_data(data)


PROBLEMS = {"quadratic": _quadratic, "cleaning": _cleaning,
            "hyperrep": _hyperrep, "fairness": _fairness}


def _aligned_topk(monkeypatch, flips: list):
    """Record the reference's compressor calls; make the port's take the
    reference's keep decisions, after bounding every entry the two sides
    decided otherwise (their counts appended to ``flips``, one per leaf)."""
    calls, orig, torig = [], jbase._topk_compress, tbase._topk_compress

    def ref(tree, ratio):
        out = orig(tree, ratio)
        jax.debug.callback(lambda a, b: calls.append((a, b)),
                           jax.tree.leaves(tree), jax.tree.leaves(out),
                           ordered=True)
        return out

    def port(tree, ratio):
        jin, jout = calls[len(flips) // len(jax.tree.leaves(tree))]
        leaves, treedef = tree_flatten(tree)
        kept = []
        for a, sa, t in zip(jin, jout, leaves):
            keep_a = np.asarray(sa) != 0
            flips.append(int(leaf_topk_flips(
                a, keep_a, t.numpy(), torig(t, ratio).numpy() != 0,
                ratio).sum()))
            kept.append(torch.where(torch.from_numpy(keep_a), t, 0.0))
        return treedef.unflatten(kept)

    monkeypatch.setattr(jbase, "_topk_compress", ref)
    monkeypatch.setattr(tbase, "_topk_compress", port)


QUADRATIC = dict(lr_x=0.03, lr_y=0.1, lr_u=0.1, neumann_q=4, neumann_tau=0.2)
# the examples' settings (examples/data_cleaning.py, hyper_representation.py)
EXAMPLES = {"cleaning": dict(lr_x=0.3, lr_y=0.3, lr_u=0.3),
            "hyperrep": dict(lr_x=0.1, lr_y=0.2, lr_u=0.2, neumann_q=10,
                             neumann_tau=0.15),
            "fairness": dict(lr_x=0.5, lr_y=0.5, lr_u=0.3),   # test_fairness
            "defaults": {}}


def _one_round(problem: str, algo: str, fo: bool, fs: bool, monkeypatch,
               settings: dict):
    jprob, tprob = PROBLEMS[problem]()
    flips = []
    kw = dict(algorithm=algo, num_clients=8, local_steps=4, fuse_oracles=fo,
              fuse_storm=fs, fuse_storm_block=64, **settings)
    if algo == "commfedbio":
        _aligned_topk(monkeypatch, flips)
    ja, ta = jmake(jprob, JConfig(**kw)), make_algorithm(tprob,
                                                         FederatedConfig(**kw))
    assert ta.name == ja.name == algo
    assert ta.comm_floats == ja.comm_floats
    js, ts = ja.init(jax.random.PRNGKey(1)), ta.init(jr.PRNGKey(1))
    js, _ = jax.jit(ja.round)(js, jax.random.PRNGKey(2))
    jax.effects_barrier()
    tk.reset_counts()
    ts, metrics = ta.round(ts, jr.PRNGKey(2))
    assert metrics["t"] == ts.t == int(js.t)
    assert ts._fields == js._fields
    for name in ts._fields[:-1]:
        for a, b in zip(jax.tree.leaves(getattr(js, name)),
                        tree_leaves(getattr(ts, name))):
            np.testing.assert_allclose(f32(b), np.asarray(a), rtol=RTOL,
                                       atol=ATOL, err_msg=name)
    _close_trees(ja.mean_x(js), ta.mean_x(ts))
    # the fused path launches its kernel once a local step (one f32 buffer)
    want = dict.fromkeys(tk.CALLS, 0)
    if fs:
        want[KERNEL[algo]] = 4
    assert tk.CALLS == want
    return flips


def test_leaf_topk_flips_passes_near_flips_and_catches_far_ones():
    """A decision that differs where the two inputs straddle the threshold
    is returned; one far from it (a different selection rule) fails."""
    a = np.array([5.0, 4.0, 3.0, 2.0, 1.0, 0.5, 0.25, 0.1, 0.05, 0.01],
                 np.float32)
    b = a.copy()
    b[2], b[3] = 2.0, 3.0 + 1e-3            # ranks 3 and 4 swap
    keep_a, keep_b = np.abs(a) >= 3.0, np.abs(b) >= 3.0
    flips = leaf_topk_flips(a, keep_a, b, keep_b, 0.3)
    assert flips.tolist() == [False, False, True, True] + [False] * 6
    with pytest.raises(AssertionError):
        leaf_topk_flips(a, keep_a, a, np.abs(a) >= 0.5, 0.3)


def _close_trees(want, got):
    for a, b in zip(jax.tree.leaves(want), tree_leaves(got)):
        np.testing.assert_allclose(f32(b), np.asarray(a), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("algo,fuse_oracles,fuse_storm", GRID)
def test_one_round_on_the_quadratic_matches_reference(algo, fuse_oracles,
                                                      fuse_storm,
                                                      monkeypatch):
    _one_round("quadratic", algo, fuse_oracles, fuse_storm, monkeypatch,
               QUADRATIC)


@pytest.mark.parametrize("problem,algo,fuse_storm,settings", [
    ("cleaning", "fedbio", True, "cleaning"),
    ("cleaning", "fedbioacc", False, "cleaning"),
    ("cleaning", "fednest", False, "cleaning"),
    ("hyperrep", "fedbio_local", True, "hyperrep"),
    ("hyperrep", "fedbioacc_local", False, "hyperrep"),
    ("hyperrep", "commfedbio", False, "hyperrep"),
    ("hyperrep", "commfedbio", False, "defaults"),
    ("fairness", "fedbio", False, "fairness"),
    ("fairness", "fedbio", True, "fairness")])
def test_one_round_on_the_papers_problems_matches_reference(
        problem, algo, fuse_storm, settings, monkeypatch):
    """The examples' problems at their sizes and settings, unfused oracles
    as the examples run them; CommFedBiO also at the config's defaults,
    where top-k decides two entries otherwise on the two sides; the fair-FL
    problem under FedBiO as ``tests/test_fairness.py`` trains it (its
    client weight, read at a batched client id under ``vmap``)."""
    flips = _one_round(problem, algo, False, fuse_storm, monkeypatch,
                       EXAMPLES[settings])
    # CommFedBiO compresses the four leaves of the backbone each local step
    assert len(flips) == (4 * 4 if algo == "commfedbio" else 0)


def _rounds(algo: str, n: int = 3, **kw):
    _, prob = _quadratic()
    cfg = FederatedConfig(algorithm=algo, num_clients=8, local_steps=4,
                          **QUADRATIC, **kw)
    alg = make_algorithm(prob, cfg)
    state = alg.init(jr.PRNGKey(1))
    key = jr.PRNGKey(2)
    for _ in range(n):
        key, sub = jr.split(key)
        state, _ = alg.round(state, sub)
    return state


@pytest.mark.parametrize("algo", CORE)
def test_fuse_storm_changes_nothing_but_how_a_round_runs(algo, monkeypatch):
    """Three rounds on the tree loop and on the flat substrate agree within
    the reference's bound, also with hierarchy_period set (the paper's flat
    averaging either way); on the engine every reduction covers the
    communicated tiles alone, so a PRIVATE y stays per client."""
    reduced = []
    mean = flat._bcast_mean

    def recording(seg, w=None):
        reduced.append(seg.shape[-1])
        return mean(seg, w)

    a = _rounds(algo)
    monkeypatch.setattr(flat, "_bcast_mean", recording)
    b = _rounds(algo, fuse_storm=True, fuse_storm_block=64)
    monkeypatch.setattr(flat, "_bcast_mean", mean)
    c = _rounds(algo, hierarchy_period=2)
    d = _rounds(algo, hierarchy_period=2, fuse_storm=True,
                fuse_storm_block=64)
    for name in a._fields[:-1]:
        for other in (b, c, d):
            for x, y in zip(tree_leaves(getattr(a, name)),
                            tree_leaves(getattr(other, name))):
                np.testing.assert_allclose(f32(y), f32(x), rtol=RTOL,
                                           atol=ATOL, err_msg=name)
    # sections are padded to the 64-element tile: x (10) one tile, y and u
    # one each; one reduction a communication of the variables, one of the
    # momenta on the storm kind, over every communicated tile run
    private = algo.endswith("_local")
    width = 64 if private else 3 * 64
    per_comm = 2 if algo.startswith("fedbioacc") else 1
    assert reduced == [width] * (3 * per_comm)
    if private:
        y = b.y
        assert not torch.equal(y[0], y[1])


def test_make_algorithm_table_and_refusal():
    _, prob = _quadratic()
    jprob, _ = _quadratic()
    for algo in CORE + BASELINES:
        assert make_algorithm(prob, FederatedConfig(algorithm=algo,
                                                    num_clients=8)).name \
            == algo
    with pytest.raises(KeyError) as want:
        jmake(jprob, JConfig(algorithm="fedavg"))
    with pytest.raises(KeyError) as got:
        make_algorithm(prob, FederatedConfig(algorithm="fedavg"))
    assert str(got.value) == str(want.value)
    from repro_torch.core.api import make_algorithm as alias
    assert alias is make_algorithm


@pytest.mark.parametrize("name", ["fedbio", "fedbioacc", "fedbio_local"])
def test_trainer_unfused_oracles_match_reference(name):
    """The model-scale trainer with ``execution.fuse_oracles=false``
    (reduced Mamba-2, 2 clients, seq 32): two steps, one communication,
    from the reference's initial state and batches, every buffer within
    1e-4 of its norm (the bound of the fused-oracle trainer tests)."""
    path = str(ROOT / "experiments" / f"{name}.json")
    change = {"execution.fuse_oracles": False}
    jrun = jbuild(JExperiment.load(path).edit(**change))
    run = build(Experiment.load(path).edit(**change), device="cpu")
    key = jax.random.PRNGKey(jrun.spec.schedule.seed)
    jstate = jrun.init(key)
    state = seqs.FlatState(tuple(to_torch(list(jstate.vars))),
                           tuple(to_torch(list(jstate.mom))), 0)
    jstep = jax.jit(jrun.step)
    for _ in range(2):
        key, sub = jax.random.split(key)
        batch = jrun.batch_fn(sub)
        jstate, _ = jstep(jstate, batch)
        state, _ = run.step(state, to_torch(batch))
    for js, ts in ((jstate.vars, state.vars), (jstate.mom, state.mom)):
        for j, t in zip(js, ts):
            j = np.asarray(j, np.float32)
            assert np.linalg.norm(f32(t) - j) <= 1e-4 * np.linalg.norm(j)


def test_examples_run_on_the_cpu():
    """The example scripts' runs, shortened, on the CPU; the sort-based
    AUC equals the reference script's pairwise mean (ties count 0)."""
    from repro_torch.examples import data_cleaning, hyper_representation
    x = torch.tensor([0.3, -1.0, 0.3, 2.0, -0.5, 0.3])
    mask = torch.tensor([True, False, True, False, False, True])
    pairs = ((-x[mask])[:, None] > (-x[~mask])[None, :]).double().mean()
    assert data_cleaning.detection_auc(x, mask) == float(pairs)
    _, auc = data_cleaning.run("fedbio", 2, "cpu", fuse_storm=True,
                               log=lambda s: None)
    assert 0.0 <= auc <= 1.0
    v0, v1 = hyper_representation.run("fedbio_local", 1, "cpu",
                                      log=lambda s: None)
    assert np.isfinite(v0) and np.isfinite(v1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        data_cleaning.run("fedbio", 1, None)
