"""The hierarchical (pod-local / global) schedule and the per-sequence
communication cadence (``comm_every``) of the port against the JAX
package's, on the CPU, from inputs drawn with numpy from a seed.

* The grouped client mean of ``core.tree_util`` and of the flat substrate,
  plain and participation-weighted, with an empty group: bit for bit the
  reference's (its compiled ``jnp.mean`` over the group, and its
  multiply-add weighted sums), restating
  ``tests/test_hierarchical.py::test_grouped_mean`` and
  ``tests/test_participation.py::test_partial_grouped_mean_and_empty_group``
  on both packages.
* ``comm_buffers`` over a pod-local and a global round with a cadence of 2
  on one section, plain and int8-compressed (the reference's int8 round
  trip through its Pallas kernels in interpret mode, as on a TPU),
  weighted: bit for bit.
* Toy engines of both packages (oracle ``0.1·v + b``, 8-element tiles):
  ``test_pod_local_then_global_sync``, ``test_flat_schedule_unchanged``
  and ``test_comm_every_decouples_sequence_cadence`` restated, and the two
  engines within ``TOY_TOL`` (1e-6) of each buffer's norm.
* ``experiments/fedbioacc.json`` edited to 4 clients, ``hierarchy_period``
  2, ``hierarchy_groups`` 2 and ``comm_every {"u": 2}`` (reduced Mamba-2,
  fused updates and oracles), four steps from the reference's initial
  state on its batches: every buffer within ``ENGINE_TOL`` (1e-4) of its
  norm after each step, the tolerance of the other FedBiOAcc step parity
  tests (the oracles' reductions run in other orders); on both packages
  the pods' rows agree bit for bit after round 1 and every client's after
  round 2.
* ``test_comm_every_spec_reaches_engine`` (``tests/test_api_spec.py``)
  restated on the port; the comm plan under a cadence against the
  reference's; the train CLI with ``--hierarchy-period``/``--comm-every``,
  its ``comm`` events, and a crash and ``--resume`` across a pod-local
  round bit for bit; the reference's composition errors word for word."""
import functools
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.api import Experiment as JExperiment  # noqa: E402
from repro.api import build as jbuild  # noqa: E402
from repro.config import FederatedConfig as JConfig  # noqa: E402
from repro.core import tree_util as jtu  # noqa: E402
from repro.kernels.storm import quantpack as jqp  # noqa: E402
from repro.optim import flat as jflat  # noqa: E402
from repro.optim import sequences as jseqs  # noqa: E402
from repro.telemetry.comm import comm_plan as jcomm_plan  # noqa: E402
from repro.telemetry.comm import round_bytes as jround_bytes  # noqa: E402
from repro_torch.api import Experiment, build  # noqa: E402
from repro_torch.checkpoint import checkpoint_metadata  # noqa: E402
from repro_torch.config import FederatedConfig as TConfig  # noqa: E402
from repro_torch.core import tree_util as ttu  # noqa: E402
from repro_torch.kernels.storm import kernel as tk  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.optim import flat as tflat  # noqa: E402
from repro_torch.optim import sequences as tseqs  # noqa: E402
from repro_torch.telemetry import read_events  # noqa: E402
from repro_torch.telemetry.comm import comm_plan, round_bytes  # noqa: E402
from torch_parity import bits, f32, to_torch  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = os.path.join(ROOT, "experiments", "fedbioacc.json")
HIER = {"problem.num_clients": 4, "schedule.steps": 4,
        "schedule.hierarchy_period": 2, "schedule.hierarchy_groups": 2,
        "schedule.comm_every": {"u": 2}}
M, STEPS = 4, 4
TOY_TOL, ENGINE_TOL = 1e-6, 1e-4


@pytest.fixture
def tpu_reference(monkeypatch):
    """Route the reference substrate's int8 round trip through its Pallas
    kernels (interpret mode), as on a TPU, instead of their jnp lowerings
    (as in ``test_torch_compress.py``)."""
    monkeypatch.setattr(jflat, "quantpack_flat_jnp", functools.partial(
        jqp.quantpack_flat, interpret=True))
    monkeypatch.setattr(jflat, "quantunpack_flat_jnp", functools.partial(
        jqp.quantunpack_flat, interpret=True))


# ---------------------------------------------------------------------------
# the grouped means
# ---------------------------------------------------------------------------

def test_grouped_mean():
    """The reference's example on both packages: clients {0, 1} and
    {2, 3} average separately."""
    x = np.arange(8.0, dtype=np.float32).reshape(4, 2)
    jout = jtu.client_mean_grouped({"w": jnp.asarray(x)}, 2)
    tout = ttu.client_mean_grouped({"w": torch.from_numpy(x)}, 2)
    for out in (np.asarray(jout["w"]), tout["w"].numpy()):
        assert out[0, 0] == out[1, 0] == 1.0
        assert out[2, 0] == out[3, 0] == 5.0
    np.testing.assert_array_equal(bits(tout["w"]), bits(jout["w"]))


TREE_W = {"plain": None, "three_of_four": [1.0, 0.0, 2.0, 1.0],
          "empty_group": [1.0, 1.0, 0.0, 0.0]}


@pytest.mark.parametrize("case", sorted(TREE_W))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tree_means_match_reference_bitwise(dtype, case):
    rng = np.random.default_rng(3)
    tree = {"a": rng.standard_normal((M, 5, 7)).astype(np.float32),
            "b": rng.standard_normal((M, 33)).astype(np.float32)}
    jt = {k: jnp.asarray(v).astype(dtype) for k, v in tree.items()}
    tt = to_torch(jt)
    w = TREE_W[case]
    if w is None:
        pairs = [(jtu.client_mean_grouped(jt, 2),
                  ttu.client_mean_grouped(tt, 2))]
    else:
        jw, tw = jnp.asarray(w, jnp.float32), torch.tensor(w)
        pairs = [(jax.jit(jtu.client_mean_weighted)(jt, jw),
                  ttu.client_mean_weighted(tt, tw)),
                 (jax.jit(lambda t, v: jtu.client_mean_grouped_weighted(
                     t, 2, v))(jt, jw),
                  ttu.client_mean_grouped_weighted(tt, 2, tw))]
    for jo, to in pairs:
        for k in tree:
            np.testing.assert_array_equal(bits(to[k]), bits(jo[k]))
            if w is not None:     # weight 0: the row stays
                for i in range(M):
                    if w[i] == 0:
                        assert torch.equal(to[k][i], tt[k][i])


SHAPES = {"x": (700,), "y": (300,), "z": (50,)}


def _flat_pair(dtype: str, seed: int = 0):
    """(jax spec, torch spec, jax buffers, torch buffers): sections x | y |
    z over 256-element tiles, M clients drawn with numpy."""
    jt = {k: jax.ShapeDtypeStruct(v, jnp.dtype(dtype))
          for k, v in SHAPES.items()}
    js = jflat.make_spec(jt, sections=tuple(SHAPES), block=256)
    ts = tflat.make_spec({k: torch.empty(v, dtype=getattr(torch, dtype),
                                         device="meta")
                          for k, v in SHAPES.items()},
                         sections=tuple(SHAPES), block=256)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, js.groups[0].padded)).astype(np.float32)
    jb = (jnp.asarray(x).astype(dtype),)
    return js, ts, jb, tuple(to_torch(list(jb)))


@pytest.mark.parametrize("case", sorted(TREE_W))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flat_grouped_mean_matches_reference_bitwise(dtype, case):
    """x grouped, y private, z averaged in full (an AVERAGED section in a
    pod-local round)."""
    js, ts, jb, tb = _flat_pair(dtype)
    w = TREE_W[case]
    jw = None if w is None else jnp.asarray(w, jnp.float32)
    tw = None if w is None else torch.tensor(w)
    modes = ("group", "none", "mean")
    want = jax.jit(lambda b, v: jflat.client_mean_masked(
        js, b, modes, num_groups=2, weights=v))(jb, jw)
    entering = tb[0].clone()
    got = tflat.client_mean_masked(ts, tb, modes, num_groups=2, weights=tw)
    np.testing.assert_array_equal(bits(got[0]), bits(want[0]))
    a, b = ts.groups[0].extents[0][1:]
    if case == "empty_group":
        # the reference's partial grouped mean: pod {0, 1} averages, the
        # absent pod {2, 3} passes through
        np.testing.assert_allclose(
            f32(got[0][0, :8]), f32((entering[0] + entering[1]) / 2.0)[:8],
            rtol=1e-2 if dtype == "bfloat16" else 1e-6)
        assert torch.equal(got[0][2:, a:b], entering[2:, a:b])
    y0, y1 = ts.groups[0].extents[1][1:]
    assert torch.equal(got[0][:, y0:y1], entering[:, y0:y1])


# ---------------------------------------------------------------------------
# comm_buffers: a pod-local and a global round with a cadence
# ---------------------------------------------------------------------------

POLICIES = (tseqs.HIERARCHICAL, tseqs.AVERAGED, tseqs.HIERARCHICAL)
CADENCE = (1, 1, 2)


@pytest.mark.parametrize("quant", [None, "int8"])
@pytest.mark.parametrize("weighted", [False, True])
def test_comm_buffers_over_local_and_global_rounds(weighted, quant,
                                                   tpu_reference):
    """local_steps 1, hierarchy_period 2: round 1 (step 0) is pod-local,
    x takes the pod mean, y the full mean, z (cadence 2) does not reduce;
    round 2 (step 1) is global and all three take the full mean."""
    js, ts, jb, tb = _flat_pair("float32", seed=4)
    kw = dict(num_clients=M, local_steps=1, hierarchy_period=2,
              hierarchy_groups=2)
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    w = [1.0, 1.0, 1.0, 0.0] if weighted else None
    jw = None if w is None else jnp.asarray(w, jnp.float32)
    tw = None if w is None else torch.tensor(w)
    jc = None if quant is None else jflat.CompressCfg(quant=quant)
    tc = None if quant is None else tflat.CompressCfg(quant=quant)
    jpol = (jseqs.HIERARCHICAL, jseqs.AVERAGED, jseqs.HIERARCHICAL)
    ext = {s: (a, b) for s, a, b in ts.groups[0].extents}
    for step in (0, 1):
        entering = tb[0].clone()
        want = jax.jit(lambda b, v: jseqs.comm_buffers(
            js, jcfg, step, b, jpol, weights=v, comm_every=CADENCE,
            compress=jc, ef=()))(jb, jw)
        got = tseqs.comm_buffers(ts, tcfg, step, tb, POLICIES, weights=tw,
                                 comm_every=CADENCE, compress=tc, ef=())
        if quant is not None:
            (want, wef), (got, gef) = want, got
            assert wef == () and gef == ()
        np.testing.assert_array_equal(bits(got[0]), bits(want[0]))
        jb, tb = want, got
        x = got[0][:, slice(*ext[0])]
        z = got[0][:, slice(*ext[2])]
        live = [i for i in range(M) if w is None or w[i] > 0]
        if step == 0:
            assert torch.equal(x[0], x[1]) and not torch.equal(x[0], x[2])
            assert torch.equal(z, entering[:, slice(*ext[2])])
        else:
            assert all(torch.equal(x[live[0]], x[i]) for i in live)
            assert all(torch.equal(z[live[0]], z[i]) for i in live)
        if w is not None:
            assert torch.equal(got[0][3], entering[3])


# ---------------------------------------------------------------------------
# toy engines of both packages
# ---------------------------------------------------------------------------

TOY = {"x": (6,), "y": (3,), "u": (3,)}


def _toy(cfg_kw: dict, comm_every=None, seed: int = 0):
    """Both packages' fedbioacc toy engines (oracle 0.1·v + b per section,
    8-element tiles) with the HIERARCHICAL policy, and their states."""
    jcfg, tcfg = JConfig(**cfg_kw), TConfig(**cfg_kw)
    ja, ta = jseqs.SPECS["fedbioacc"], tseqs.SPECS["fedbioacc"]
    if comm_every:
        ja = jseqs.with_comm_every(ja, comm_every)
        ta = tseqs.with_comm_every(ta, comm_every)
    assert ta.policies == ja.policies == (tseqs.HIERARCHICAL,) * 3

    def jorc(v, b):
        return {s: jax.tree.map(lambda a: 0.1 * a + b, v[s]) for s in TOY}

    def torc(v, b):
        return {s: ttu.tree_map(lambda a: 0.1 * a + b, v[s]) for s in TOY}

    m = cfg_kw["num_clients"]
    je = jseqs.make_engine(jcfg, ja, {s: jnp.zeros(TOY[s]) for s in TOY},
                           jorc, block=8)
    te = tseqs.make_engine(tcfg, ta, {s: torch.empty(TOY[s], device="meta")
                                      for s in TOY}, torc, block=8)
    rng = np.random.default_rng(seed)
    vt = {s: rng.standard_normal((m,) + TOY[s]).astype(np.float32)
          for s in TOY}
    return (jax.jit(je.step), je.init_state({k: jnp.asarray(v)
                                             for k, v in vt.items()}),
            te, te.init_state({k: torch.from_numpy(v)
                               for k, v in vt.items()}))


def _sec(engine_spec, bufs, sec: str) -> np.ndarray:
    """Section ``sec`` of [M, N] buffers as an f32 [M, n] array."""
    s = engine_spec.sections.index(sec)
    return np.concatenate([f32(b[:, a:z]) if torch.is_tensor(b) else
                           np.asarray(b[:, a:z], np.float32)
                           for grp, b in zip(engine_spec.groups, bufs)
                           for t, a, z in grp.extents if t == s], axis=1)


def _spread(rows: np.ndarray, a: int, b: int) -> float:
    return float(np.max(np.abs(rows[a] - rows[b])))


def _toy_close(jst, tst):
    for j, t in zip(jst.vars + jst.mom, tst.vars + tst.mom):
        j = np.asarray(j)
        assert np.linalg.norm(f32(t) - j) <= TOY_TOL * np.linalg.norm(j)


def test_pod_local_then_global_sync():
    """The reference's schedule (4 clients, local_steps 1,
    hierarchy_period 3, 2 groups) on both packages: rounds 1 and 2 are
    pod-local (clients 0 and 1 agree, the pods differ), round 3 is
    global."""
    jstep, jst, te, tst = _toy(dict(num_clients=4, local_steps=1,
                                    hierarchy_period=3, hierarchy_groups=2,
                                    lr_x=0.05, lr_y=0.05, lr_u=0.05))
    for t, b in enumerate((0.2, 0.5, 0.9)):
        jst = jstep(jst, jnp.float32(b))
        tst = te.step(tst, torch.tensor(b))
        _toy_close(jst, tst)
        for bufs, spec in ((jst.vars, te.spec), (tst.vars, te.spec)):
            x = _sec(spec, bufs, "x")
            if t < 2:
                assert _spread(x, 0, 1) < 1e-6 and _spread(x, 2, 3) < 1e-6
                if t:      # step 0 moves nothing (the entering momentum)
                    assert _spread(x, 0, 2) > 1e-6
            else:
                assert _spread(x, 0, 2) < 1e-6 and _spread(x, 1, 3) < 1e-6


def test_flat_schedule_unchanged():
    """hierarchy_period 1 with one group reproduces hierarchy_period 0 (the
    paper's flat averaging), bit for bit on both packages."""
    base = dict(num_clients=2, local_steps=2, lr_x=0.05, lr_y=0.05,
                lr_u=0.05)
    runs = [_toy(base), _toy({**base, "hierarchy_period": 1,
                              "hierarchy_groups": 1})]
    states = []
    for jstep, jst, te, tst in runs:
        for b in (0.3, 0.4, 0.7, 0.1):
            jst = jstep(jst, jnp.float32(b))
            tst = te.step(tst, torch.tensor(b))
        _toy_close(jst, tst)
        states.append((jst, tst))
    (j0, t0), (j1, t1) = states
    for a, b in zip(j0.vars + j0.mom, j1.vars + j1.mom):
        np.testing.assert_array_equal(bits(a), bits(b))
    for a, b in zip(t0.vars + t0.mom, t1.vars + t1.mom):
        np.testing.assert_array_equal(bits(a), bits(b))


def test_comm_every_decouples_sequence_cadence():
    """comm_every 2 on u: at the first round x is averaged while u still
    differs across clients; at the second both agree (both packages)."""
    jstep, jst, te, tst = _toy(dict(num_clients=4, local_steps=1,
                                    lr_x=0.01, lr_y=0.01, lr_u=0.01),
                               comm_every={"u": 2})
    assert [q.comm_every for q in te.aspec.sequences] == [1, 1, 2]
    for t in range(2):
        jst = jstep(jst, jnp.float32(0.2))
        tst = te.step(tst, torch.tensor(0.2))
        _toy_close(jst, tst)
        for bufs in (jst.vars, tst.vars):
            assert np.max(np.std(_sec(te.spec, bufs, "x"), axis=0)) < 1e-7
            u = np.max(np.std(_sec(te.spec, bufs, "u"), axis=0))
            assert (u > 1e-4) if t == 0 else (u < 1e-7)


def test_with_comm_every_errors_match_reference():
    for bad in ({"zz": 2}, {"u": 0}):
        with pytest.raises(ValueError) as jerr:
            jseqs.with_comm_every(jseqs.SPECS["fedbio"], bad)
        with pytest.raises(ValueError) as terr:
            tseqs.with_comm_every(tseqs.SPECS["fedbio"], bad)
        assert str(terr.value) == str(jerr.value)


def test_composition_errors_match_reference_word_for_word():
    """Top-k, faults, robustness or stragglers with the hierarchical
    schedule, and compression with faults: the engines' refusals."""
    from repro.federation import faults as jf
    from repro.federation import stragglers as js
    from repro.federation.compression import CompressionSpec as JComp
    from repro_torch.federation import faults as tf
    from repro_torch.federation import stragglers as ts
    from repro_torch.federation.compression import CompressionSpec as TComp
    cases = [
        ({"hierarchy_period": 2},
         lambda p: dict(compression=p[0](quant="int8", topk_frac=0.1))),
        ({"hierarchy_period": 2},
         lambda p: dict(faults=p[1].make_faults(p[1].FaultSpec(
             nan_rate=0.1), M))),
        ({"hierarchy_period": 2},
         lambda p: dict(robustness=p[1].RobustnessSpec())),
        ({"hierarchy_period": 2},
         lambda p: dict(stragglers=p[2].make_stragglers(
             p[2].StragglerSpec(), M))),
        ({}, lambda p: dict(compression=p[0](quant="int8"),
                            robustness=p[1].RobustnessSpec())),
    ]
    for cfg_kw, kw in cases:
        with pytest.raises(ValueError) as jerr:
            jseqs.make_engine(JConfig(num_clients=M, **cfg_kw),
                              jseqs.SPECS["fedbio"],
                              {s: jnp.zeros(TOY[s]) for s in TOY}, None,
                              block=8, **kw((JComp, jf, js)))
        with pytest.raises(ValueError) as terr:
            tseqs.make_engine(TConfig(num_clients=M, **cfg_kw),
                              tseqs.SPECS["fedbio"],
                              {s: torch.empty(TOY[s], device="meta")
                               for s in TOY}, None, block=8,
                              **kw((TComp, tf, ts)))
        assert str(terr.value) == str(jerr.value)


# ---------------------------------------------------------------------------
# the reduced FedBiOAcc engine and the spec API
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def engines():
    """The reference's and the port's builds of the hierarchical spec; the
    port starts from the reference's initial FlatState and takes its
    batches.  Each side's state after every step."""
    jrun = jbuild(JExperiment.load(SPEC).edit(**HIER))
    run = build(Experiment.load(SPEC).edit(**HIER), device="cpu")
    key = jax.random.PRNGKey(jrun.spec.schedule.seed)
    jstate = jrun.init(key)
    state = tseqs.FlatState(tuple(to_torch(list(jstate.vars))),
                            tuple(to_torch(list(jstate.mom))), 0)
    jstep = jax.jit(jrun.step)
    tk.reset_counts()
    jstates, states = [], []
    for _ in range(STEPS):
        key, sub = jax.random.split(key)
        batch = jrun.batch_fn(sub)
        jstate, _ = jstep(jstate, batch)
        state, _ = run.step(state, to_torch(batch))
        jstates.append(jstate)
        states.append(state)
    calls = dict(tk.CALLS)
    return jrun, run, jstates, states, calls


def test_engine_matches_reference_over_two_rounds(engines):
    jrun, run, jstates, states, calls = engines
    spec = run.init.spec
    assert [g.padded for g in spec.groups] == \
        [g.padded for g in jrun.step.spec.groups]
    assert [q.comm_every for q in run.step.aspec.sequences] == [1, 1, 2]
    for t, (js, ts) in enumerate(zip(jstates, states)):
        assert ts.step == int(js.step) == t + 1
        for j, g in zip(js.vars + js.mom, ts.vars + ts.mom):
            j = np.asarray(j, np.float32)
            assert np.linalg.norm(f32(g) - j) <= \
                ENGINE_TOL * np.linalg.norm(j), t
    want = dict.fromkeys(tk.CALLS, 0)
    want["storm3_step"] = STEPS * len(spec.groups)
    assert calls == want


@pytest.mark.parametrize("package", ["reference", "port"])
def test_pods_agree_after_round_1_and_all_after_round_2(engines, package):
    """Round 1 (step 2) is pod-local: within each pod the x, y and their
    momenta rows are bit-identical, across pods they differ; u and q (the
    cadence of 2) differ across every client.  Round 2 (step 4) is global:
    every client's rows are bit-identical."""
    jrun, run, jstates, states, _ = engines
    spec = run.init.spec
    seq = jstates if package == "reference" else states
    for t, pods in ((1, ((0, 1), (2, 3))), (3, ((0, 1, 2, 3),))):
        st = seq[t]
        for bufs in (st.vars, st.mom):
            for sec in spec.sections:
                rows = [bits(r) for r in _sec(spec, bufs, sec)]
                same = lambda a, b: np.array_equal(rows[a], rows[b])  # noqa
                if sec == "u" and t == 1:
                    assert not any(same(a, b) for a in range(M)
                                   for b in range(a + 1, M))
                    continue
                for pod in pods:
                    assert all(same(pod[0], i) for i in pod)
                if len(pods) == 2:
                    assert not same(0, 2)


def test_comm_plan_under_a_cadence_matches_reference(engines):
    jrun, run, _, _, _ = engines
    plan = comm_plan(run.step.spec, run.step.aspec, run.spec.compression)
    jplan = jcomm_plan(jrun.step.spec, jrun.step.aspec, jrun.spec.compression)
    assert tuple(plan) == tuple(jplan)
    assert [c for _, _, c, _ in plan.sections] == [1, 1, 2]
    for r in range(1, 5):
        assert round_bytes(plan, r) == jround_bytes(jplan, r)
    e = {n: el for n, el, _, _ in plan.sections}
    assert round_bytes(plan, 1)["elems"] == e["x"] + e["y"]
    assert round_bytes(plan, 2)["elems"] == e["x"] + e["y"] + e["u"]
    # every section skips round 1: no event
    skip = plan._replace(sections=tuple((n, el, 2, c) for n, el, _, c
                                        in plan.sections))
    assert round_bytes(skip, 1) is None is jround_bytes(skip, 1)


def test_comm_every_spec_reaches_engine():
    """schedule.comm_every {'u': 2}: at the first round x averages while u
    still differs across clients (the reference's ``tests/test_api_spec.py``
    case, FedBiO on the reduced Mamba-2, 4 clients, one local step)."""
    exp = Experiment.load(SPEC).edit(**{
        "algorithm.name": "fedbio", "problem.num_clients": 4,
        "problem.seq_len": 16, "schedule.steps": 1,
        "schedule.local_steps": 1, "schedule.comm_every": {"u": 2}})
    run = build(exp, device="cpu")
    state = run.init(torch.Generator().manual_seed(0))
    state, _ = run.step(state, run.batch_fn(torch.Generator().manual_seed(1)))
    view = run.views(state)

    def spread(tree):
        return max(float(v.to(torch.float32).std(dim=0).max())
                   for v in ttu.tree_leaves(tree))

    assert spread(view.x) < 1e-7
    assert spread(view.u) > 1e-6


# ---------------------------------------------------------------------------
# the train CLI
# ---------------------------------------------------------------------------

def _arrays(d: str) -> dict:
    path = os.path.join(d, f"arrays-{checkpoint_metadata(d)['step']:08d}.npz")
    with np.load(path) as data:
        return {k: data[k].copy() for k in data.files}


def test_cli_crash_and_resume_across_a_pod_local_round(tmp_path,
                                                       monkeypatch):
    """``--hierarchy-period 2 --comm-every u=2`` on fedbioacc.json with 4
    clients: a run crashed after step 1 (inside pod-local round 1) and
    resumed equals the uninterrupted run bit for bit; the uninterrupted
    run's ``comm`` events are the plan's, round 1 without u."""
    flags = ["--experiment", SPEC, "--clients", "4", "--steps", "4",
             "--hierarchy-period", "2", "--comm-every", "u=2",
             "--device", "cpu", "--log-every", "1", "--ckpt-every", "1"]
    crashed, whole = str(tmp_path / "crashed"), str(tmp_path / "whole")
    sink = str(tmp_path / "ev.jsonl")

    def hard_exit(code):
        raise SystemExit(code)

    monkeypatch.setattr(train.os, "_exit", hard_exit)
    with pytest.raises(SystemExit) as err:
        train.main(flags + ["--ckpt-dir", crashed, "--crash-at-step", "1"])
    assert err.value.code == 17 and checkpoint_metadata(crashed)["step"] == 1
    resumed = train.main(["--resume", crashed, "--ckpt-dir", crashed,
                          "--device", "cpu", "--log-every", "1",
                          "--ckpt-every", "1"])
    full = train.main(flags + ["--ckpt-dir", whole,
                               "--telemetry-sink", sink])
    strip = lambda hs: [{k: v for k, v in h.items()  # noqa: E731
                         if k != "wall_s"} for h in hs]
    assert [h["step"] for h in resumed] == [2, 3, 4]
    assert strip(resumed) == strip(full)[1:]
    mine, want = _arrays(crashed), _arrays(whole)
    assert checkpoint_metadata(crashed) == checkpoint_metadata(whole)
    assert sorted(mine) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(bits(mine[k]), bits(want[k]))
    run = build(Experiment.load(SPEC).edit(**HIER), device="cpu")
    plan = comm_plan(run.step.spec, run.step.aspec, None)
    comm = [e for e in read_events(sink) if e["event"] == "comm"]
    assert [e["round"] for e in comm] == [1, 2]
    for e in comm:
        rb = round_bytes(plan, e["round"])
        assert {k: e[k] for k in rb} == rb
    assert comm[0]["elems"] < comm[1]["elems"]


def test_cli_writes_no_comm_event_for_a_skipped_round(tmp_path):
    """Every section at a cadence of 2 and one local step: round 1
    reduces nothing and has no ``comm`` event, as in the reference's
    CLI."""
    sink = str(tmp_path / "ev.jsonl")
    train.main(["--experiment", SPEC, "--clients", "4", "--steps", "2",
                "--local-steps", "1", "--comm-every", "x=2,y=2,u=2",
                "--device", "cpu", "--log-every", "1",
                "--telemetry-sink", sink])
    comm = [e for e in read_events(sink) if e["event"] == "comm"]
    assert [(e["step"], e["round"]) for e in comm] == [(2, 2)]
