"""Stragglers in the port against the JAX package
(``repro.federation.stragglers`` and the straggler half of
``repro.optim.sequences``), on the CPU.

* Times: ``round_times`` over seeds {0, 3, 5}, rounds 0-15 and M ∈ {4, 16}
  within ``TIME_ULPS`` f32 ulps of the reference's (``normal`` within 4
  ulps of ``z``, which ``exp`` turns into a relative error of ``tail · 4
  ulp(z)``, plus a rounding or two of ``exp`` and the product).
* Decisions: ``round_decision`` for the reference test file's cases on the
  same seeds and rounds: ``arrivals`` and ``ext`` equal, ``eff`` and
  ``next_dl`` within ``DL_ULPS`` ulps.  That equal decisions are not luck
  is asserted: every sampled time lies farther than ``MARGIN`` (relative)
  from every rung of the reference's ladder, and, where the round falls
  back to the quorum-th time, from that time.
* The rest of the module: ``make_stragglers``' checks with the reference's
  messages, ``over_provision`` and ``simulate_rounds`` (integer fields
  equal, simulated seconds within ``DL_ULPS`` ulps).
* The engine: the toy engines of ``test_torch_participation`` with
  stragglers attached, the five algorithms × the three late policies, two
  rounds against the jitted reference (buffers within ``ENGINE_TOL``,
  ``stale`` equal, the deadline, an EMA toward a drawn time, within
  ``DL_ULPS``), non-arrivals' rows frozen bit for bit
  under ``drop`` and ``cancel`` and advanced under ``carry``; the
  reference's late-policy test restated for the client jax 0.9.0 draws
  late; warmup-only stragglers bit for bit the engine without them; and
  the full sampler with stragglers; the round's decision as each step
  records it in its metrics, against ``simulate_rounds``' replay.

The reference's ``test_round_decision_mixed_round`` and
``test_late_policy_semantics_on_engine`` hard-code the seed-0 round's late
client as client 1; what the reference computes under jax 0.9.0
(``jax_threefry_partitionable``) is client 3, and the tests below hold
both packages to that.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.federation import participation as jp  # noqa: E402
from repro.federation import stragglers as js  # noqa: E402
from repro_torch.federation import participation as tp  # noqa: E402
from repro_torch.federation import stragglers as ts  # noqa: E402
from repro_torch.kernels.storm import kernel as tk  # noqa: E402
from test_torch_participation import (ENGINE_TOL, M, TOY,  # noqa: E402
                                      _batches, _engines)
from torch_parity import bits  # noqa: E402

torch.set_num_threads(1)

SEEDS = (0, 3, 5)
ROUNDS = 16
CLIENTS = (4, 16)
TIME_ULPS = 8
DL_ULPS = 16
MARGIN = 2.0 ** -16
ALGOS = ("fedbio", "fedbioacc", "fedbio_local", "fedbioacc_local", "fedavg")

# the reference test file's seed-0 spec: quorum 0.25 without extensions
MIXED = dict(base_time=1.0, tail=1.0, deadline=1.0, quorum=0.25,
             max_extensions=0, adapt_rate=0.0, seed=0, over_provision=0)


def _pair(fields: dict, m: int):
    return (js.make_stragglers(js.StragglerSpec(**fields), m),
            ts.make_stragglers(ts.StragglerSpec(**fields), m))


def _ulps(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want) / np.spacing(np.abs(want))))


@pytest.mark.parametrize("m", CLIENTS)
@pytest.mark.parametrize("seed", SEEDS)
def test_round_times_within_stated_ulps(seed, m):
    jst, tst = _pair(dict(seed=seed, tail=1.0, base_time=1.3), m)
    for r in range(ROUNDS):
        got = tst.round_times(r)
        assert got.dtype == torch.float32 and got.shape == (m,)
        assert _ulps(got, jst.round_times(r)) <= TIME_ULPS
    # tail 0 is base_time exactly on both
    jst, tst = _pair(dict(seed=seed, tail=0.0, base_time=2.5), m)
    np.testing.assert_array_equal(bits(tst.round_times(0)),
                                  bits(jst.round_times(0)))


def test_seed0_round0_late_client_is_client_3():
    """What the reference computes for the seed-0 round its tests name:
    client 3, not client 1, misses the 1.0 deadline."""
    jst, tst = _pair(MIXED, M)
    want = np.asarray(jst.round_times(0))
    assert _ulps(tst.round_times(0), want) <= TIME_ULPS
    np.testing.assert_allclose(want, [0.5628286, 0.2843704, 0.47528276,
                                      1.404823], rtol=1e-6)
    for strag in (jst, tst):
        arr, eff, ext, _ = strag.round_decision(0, np.ones(M, np.float32),
                                                np.float32(1.0))
        np.testing.assert_array_equal(np.asarray(arr), [1.0, 1.0, 1.0, 0.0])
        assert float(eff) == 1.0 and int(ext) == 0


def _ladder_dl(t, q):
    """Just below the quorum-th time: rung 0 misses the quorum."""
    return np.float32(0.9) * t[q - 1]


# case → (spec fields over MIXED, the deadline from the reference's sorted
# sampled times and the quorum)
DECISION_CASES = {
    "generous": (dict(), lambda t, q: np.float32(100.0)),
    "mixed": (dict(), lambda t, q: np.float32(1.0)),
    "ladder": (dict(quorum=0.75, backoff=2.0, max_extensions=3), _ladder_dl),
    "full_miss": (dict(max_extensions=1, backoff=1.5),
                  lambda t, q: np.float32(0.01)),
    "warmup": (dict(start_round=2, adapt_rate=0.5, target_percentile=0.75),
               lambda t, q: np.float32(1.0)),
}


def _sampled(m: int, r: int) -> np.ndarray:
    """Every client in even rounds; in odd ones all but every third."""
    s = np.ones(m, np.float32)
    if r % 2:
        s[::3] = 0.0
    return s


def _assert_margin(strag, r, t, sampled, dl, eff, fallback):
    """Every sampled time farther than MARGIN from every rung of the
    ladder; on a fallback round, every other sampled time farther than
    MARGIN from the quorum-th one."""
    spec = strag.spec
    if r < spec.start_round:
        return
    ts_ = t[sampled > 0]
    rungs = np.float32(dl) * np.float32(spec.backoff) ** np.arange(
        spec.max_extensions + 1, dtype=np.float32)
    gap = np.abs(ts_[:, None] - rungs[None, :]) / rungs[None, :]
    assert gap.min() > MARGIN, (r, gap.min())
    if fallback:
        others = ts_[ts_ != eff]
        assert len(others) == len(ts_) - 1
        assert np.min(np.abs(others - eff) / eff) > MARGIN


@pytest.mark.parametrize("m", CLIENTS)
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("case", sorted(DECISION_CASES))
def test_round_decision_matches_reference(case, seed, m):
    fields, deadline = DECISION_CASES[case]
    jst, tst = _pair({**MIXED, **fields, "seed": seed}, m)
    for r in range(ROUNDS):
        sampled = _sampled(m, r)
        t = np.asarray(jst.round_times(r))
        q = int(jst.quorum_count(jnp.asarray(sampled)))
        assert int(tst.quorum_count(torch.from_numpy(sampled))) == q
        dl = deadline(np.sort(t[sampled > 0]), q)
        want = [np.asarray(v) for v in jst.round_decision(
            r, jnp.asarray(sampled), jnp.float32(dl))]
        got = tst.round_decision(r, torch.from_numpy(sampled),
                                 torch.tensor(dl))
        np.testing.assert_array_equal(bits(got[0]), bits(want[0]))
        assert int(got[2]) == int(want[2])
        for g, w in zip((got[1], got[3]), (want[1], want[3])):
            assert g.dtype == torch.float32 and g.shape == ()
            assert float(g) == float(w) == 0.0 or _ulps(g, w) <= DL_ULPS
        fallback = int(want[2]) == jst.spec.max_extensions + 1
        _assert_margin(jst, r, t, sampled, dl, float(want[1]), fallback)
        assert int(want[0].sum()) >= q or r < jst.spec.start_round
        if case == "warmup" and r < 2:
            np.testing.assert_array_equal(got[0].numpy(), sampled)
            assert float(got[1]) == 0.0 and float(got[3]) == dl
        if case == "full_miss":
            assert fallback and int(want[0].sum()) == q


@pytest.mark.parametrize("seed", SEEDS)
def test_adaptive_deadline_over_sixteen_rounds(seed):
    """The spec's own adaptive policy (deadline 1.5, quorum 0.5, EMA 0.2
    toward the 0.9 quantile), each side threading its own deadline through
    16 rounds of a uniform 6-of-8 sampler: every round's arrivals and ext
    equal, the deadlines within DL_ULPS."""
    fields = dict(seed=seed, deadline=1.5, quorum=0.5, adapt_rate=0.2,
                  target_percentile=0.9, max_extensions=2, backoff=1.5)
    jst, tst = _pair(fields, 8)
    pfields = dict(sampler="uniform", clients_per_round=6, seed=seed)
    jpart = jp.make_participation(jp.ParticipationSpec(**pfields), 8)
    tpart = tp.make_participation(tp.ParticipationSpec(**pfields), 8)
    jdl, tdl = jnp.float32(1.5), torch.tensor(1.5)
    for r in range(ROUNDS):
        jm, tm = jpart.mask_fn(jnp.int32(r)), tpart.mask_fn(r)
        np.testing.assert_array_equal(np.asarray(jm), tm.numpy())
        want = jst.round_decision(r, jm, jdl)
        got = tst.round_decision(r, tm, tdl)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        assert int(got[2]) == int(want[2])
        assert _ulps(got[1], want[1]) <= DL_ULPS
        assert _ulps(got[3], want[3]) <= DL_ULPS
        _assert_margin(jst, r, np.asarray(jst.round_times(r)),
                       np.asarray(jm), float(jdl), float(want[1]),
                       int(want[2]) == 3)
        jdl, tdl = want[3], got[3]


BAD_SPECS = ({"late_policy": "defer"}, {"base_time": 0.0}, {"tail": -1.0},
             {"deadline": 0.0}, {"over_provision": -1}, {"quorum": 0.0},
             {"quorum": 1.5}, {"backoff": 0.5}, {"max_extensions": -1},
             {"target_percentile": 0.0}, {"adapt_rate": 1.5},
             {"start_round": -1})


@pytest.mark.parametrize("bad", BAD_SPECS, ids=lambda b: "-".join(
    f"{k}={v}" for k, v in b.items()))
def test_make_stragglers_refuses_alike(bad):
    with pytest.raises(ValueError) as want:
        js.make_stragglers(js.StragglerSpec(**bad), 4)
    with pytest.raises(ValueError) as got:
        ts.make_stragglers(ts.StragglerSpec(**bad), 4)
    assert str(got.value) == str(want.value)
    assert next(iter(bad)) in str(got.value)


def test_names_defaults_and_none_match_reference():
    assert ts.LATE_POLICIES == js.LATE_POLICIES
    assert ts.StragglerSpec._fields == js.StragglerSpec._fields
    assert tuple(ts.StragglerSpec()) == tuple(js.StragglerSpec())
    assert ts.make_stragglers(None, 4) is None


def test_over_provision_matches_reference():
    cases = [(dict(over_provision=2), dict(sampler="uniform",
                                           clients_per_round=4), 8),
             (dict(over_provision=2), dict(sampler="uniform",
                                           clients_per_round=7), 8),
             (dict(over_provision=3), dict(sampler="weighted",
                                           clients_per_round=2,
                                           client_weights=(1.0,) * 6), 6),
             (dict(over_provision=2), dict(sampler="uniform"), 8),
             (dict(over_provision=2), dict(sampler="full"), 8),
             (dict(over_provision=2), dict(sampler="trace"), 8),
             (dict(over_provision=0), dict(sampler="uniform",
                                           clients_per_round=4), 8)]
    for sfields, pfields, m in cases:
        want = js.over_provision(js.StragglerSpec(**sfields),
                                 jp.ParticipationSpec(**pfields), m)
        got = ts.over_provision(ts.StragglerSpec(**sfields),
                                tp.ParticipationSpec(**pfields), m)
        assert tuple(got) == tuple(want)
    assert ts.over_provision(ts.StragglerSpec(), None, 8) is None


SIMULATED = ("deadline", "wall_clock", "wait_for_slowest")


@pytest.mark.parametrize("sampler", [None, "uniform"])
def test_simulate_rounds_matches_reference(sampler):
    fields = dict(tail=1.0, deadline=1.5, quorum=0.5, seed=1,
                  start_round=2)
    jst, tst = _pair(fields, 8)
    jpart = tpart = None
    if sampler is not None:
        pf = dict(sampler=sampler, clients_per_round=6)
        jpart = jp.make_participation(jp.ParticipationSpec(**pf), 8)
        tpart = tp.make_participation(tp.ParticipationSpec(**pf), 8)
    want = js.simulate_rounds(jst, jpart, 24)
    got = ts.simulate_rounds(tst, tpart, 24)
    assert len(got) == len(want) == 24
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in set(w) - set(SIMULATED):
            assert g[k] == w[k], (k, g, w)
        for k in SIMULATED:
            # the rows round to 6 decimals, which a few ulps can tip
            assert abs(g[k] - w[k]) <= 1e-6 + DL_ULPS * np.spacing(
                np.float32(w[k])), (k, g, w)
        assert g["wall_clock"] <= g["wait_for_slowest"] + 1e-9


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

# two rounds of the MIXED draws: round 0 leaves client 3 out, round 1
# clients 0, 2 and 3; the deadline adapts between them
ENGINE_STRAG = dict(MIXED, adapt_rate=0.5)


def _run(algo, fields, sfields):
    """Four steps (two rounds) of the toy engines; per step, the port's
    non-arrivals' rows against their entering bits as the policy asks."""
    je, jstate, te, tstate, tpart = _engines(algo, fields,
                                             stragglers=sfields)
    jstep = jax.jit(je.step)
    policy = sfields.get("late_policy", "drop")
    tk.reset_counts()
    for t, b in enumerate(_batches()):
        sampled = torch.ones(M) if tpart is None else tpart.mask_fn(t // 2)
        jstate = jstep(jstate, jnp.float32(b))
        before, metrics = tstate, {}
        tstate = te.step(tstate, torch.tensor(b), metrics)
        arrivals = metrics["decision"]["arrivals"]
        late = [c for c in range(M) if sampled[c] > 0 and arrivals[c] == 0]
        for c in late:
            # a STORM step from zero momenta leaves the variables as they
            # are, so "advanced" means some buffer moved
            frozen = [np.array_equal(bits(b1[c]), bits(b0[c]))
                      for b0, b1 in zip(before.vars + before.mom,
                                        tstate.vars + tstate.mom)]
            if policy == "carry":
                assert not all(frozen), (t, c)
            else:
                assert all(frozen), (t, c, policy)
        if t == 1:
            # the arrivals leave round 0 on their mean; a straggler's rows
            # stay out of it (in round 1 the toy oracle, the same for every
            # client, keeps rows that entered equal equal)
            ins = [c for c in range(M) if arrivals[c] > 0]
            for c in late:
                assert not np.array_equal(bits(tstate.vars[0][c]),
                                          bits(tstate.vars[0][ins[0]]))
        np.testing.assert_array_equal(tstate.stale.numpy(),
                                      np.asarray(jstate.stale))
        # the deadline follows a drawn time, so it is as close as they are
        assert _ulps(tstate.deadline, jstate.deadline) <= DL_ULPS
    assert tstate.step == int(jstate.step) == 4
    for jb, tb in zip(jstate.vars + jstate.mom, tstate.vars + tstate.mom):
        jb = np.asarray(jb)
        assert np.linalg.norm(tb.numpy() - jb) <= \
            ENGINE_TOL * np.linalg.norm(jb)
    return tstate


@pytest.mark.parametrize("policy", ["drop", "carry", "cancel"])
@pytest.mark.parametrize("algo", ALGOS)
def test_toy_engine_matches_reference_per_policy(algo, policy):
    tstate = _run(algo, None, dict(ENGINE_STRAG, late_policy=policy))
    # the rounds the draws give: 3 of 4 arrive, then 1 of 4
    assert float(tstate.deadline) != ENGINE_STRAG["deadline"]
    want_stale = [0, 0, 0, 0] if policy == "cancel" else [1, 0, 1, 2]
    assert tstate.stale.tolist() == want_stale
    kernel = {"fedbio": "sgd3_step", "fedbio_local": "sgd3_step",
              "fedavg": "momsgd3_step"}.get(algo, "storm3_step")
    assert tk.CALLS[kernel] == 4 and sum(tk.CALLS.values()) == 4


def test_late_policies_restated_for_client_3_on_both_packages():
    """The reference's ``test_late_policy_semantics_on_engine`` with the
    late client the draws give (client 3): one round of FedBiOAcc; ``drop``
    and ``cancel`` freeze its rows bit for bit and move client 0's,
    ``carry`` moves them; ``drop`` and ``carry`` age it, ``cancel`` does
    not; ``drop`` and ``cancel`` average the same arrivals, so their
    arrived rows agree bit for bit; on each package."""
    states = {}
    for policy in ("drop", "carry", "cancel"):
        je, js0, te, ts0, _ = _engines("fedbioacc", None,
                                       stragglers=dict(MIXED,
                                                       late_policy=policy))
        jstep = jax.jit(je.step)
        js1, ts1 = js0, ts0
        for b in _batches()[:2]:
            js1 = jstep(js1, jnp.float32(b))
            ts1 = te.step(ts1, torch.tensor(b))
        states[policy] = {"ref": (js0, js1), "port": (ts0, ts1)}
    for side in ("ref", "port"):
        for policy in ("drop", "cancel"):
            s0, s1 = states[policy][side]
            for v0, v1 in zip(s0.vars, s1.vars):
                np.testing.assert_array_equal(bits(v1[3]), bits(v0[3]))
                assert not np.array_equal(bits(v1[0]), bits(v0[0]))
        s0, s1 = states["carry"][side]
        assert any(not np.array_equal(bits(v1[3]), bits(v0[3]))
                   for v0, v1 in zip(s0.vars, s1.vars))
        for policy, want in (("drop", [0, 0, 0, 1]), ("carry", [0, 0, 0, 1]),
                             ("cancel", [0, 0, 0, 0])):
            np.testing.assert_array_equal(
                np.asarray(states[policy][side][1].stale), want)
        np.testing.assert_array_equal(
            bits(states["drop"][side][1].vars[0][:3]),
            bits(states["cancel"][side][1].vars[0][:3]))


@pytest.mark.parametrize("fields", [None, dict(sampler="uniform",
                                               clients_per_round=3)],
                         ids=["no_sampler", "uniform"])
@pytest.mark.parametrize("algo", ["fedbioacc", "fedbio_local", "fedavg"])
def test_warmup_stragglers_are_the_engine_without_them_bitwise(algo, fields):
    _, _, te_s, st_s, _ = _engines(algo, fields,
                                   stragglers=dict(start_round=10 ** 6))
    _, _, te_n, st_n, _ = _engines(algo, fields)
    assert st_n.deadline == () and float(st_s.deadline) == 2.0
    for b in _batches():
        st_s = te_s.step(st_s, torch.tensor(b))
        st_n = te_n.step(st_n, torch.tensor(b))
    for a, b in zip(st_s.vars + st_s.mom, st_n.vars + st_n.mom):
        np.testing.assert_array_equal(bits(a), bits(b))
    if fields is not None:
        np.testing.assert_array_equal(st_s.stale.numpy(), st_n.stale.numpy())
    else:
        assert st_n.stale == () and st_s.stale.tolist() == [0] * M
    assert float(st_s.deadline) == 2.0


@pytest.mark.parametrize("algo", ["fedbioacc_local", "fedbio"])
def test_full_sampler_with_stragglers_carries_stale(algo):
    tstate = _run(algo, dict(sampler="full"), ENGINE_STRAG)
    assert tstate.stale.tolist() == [1, 0, 1, 2]


def test_init_state_takes_a_deadline_and_refusals():
    from repro_torch.federation.compression import CompressionSpec
    _, _, te, st, _ = _engines("fedbioacc", None, stragglers=MIXED)
    assert st.deadline.dtype == torch.float32 and float(st.deadline) == 1.0
    v = {s: torch.zeros((M,) + TOY[s]) for s in ("x", "y", "u")}
    st = te.init_state(v, deadline=1.25, stale=[0, 1, 0, 2])
    assert float(st.deadline) == 1.25 and st.stale.tolist() == [0, 1, 0, 2]
    # stragglers with compression, once refused (ROADMAP queue 1,
    # 'Compression, the rest'), run the arrival-weighted compressed mean:
    # after round 0 the arrivals share one mean row, a late client keeps
    # its entering row
    _, _, te, st, _ = _engines("fedbio", None,
                               compression=CompressionSpec(quant="bf16"),
                               stragglers=MIXED)
    entering = st.vars[0].clone()
    metrics = {}
    for b in _batches()[:2]:
        st = te.step(st, torch.tensor(b), metrics)
    arrivals = metrics["decision"]["arrivals"]
    ins = [c for c in range(M) if arrivals[c] > 0]
    assert 0 < len(ins) < M
    for c in range(M):
        if c in ins:
            assert torch.equal(st.vars[0][c], st.vars[0][ins[0]])
        else:
            assert torch.equal(st.vars[0][c], entering[c])
    from repro_torch.config import FederatedConfig
    from repro_torch.optim import sequences as tseqs
    with pytest.raises(ValueError, match="hierarchical grouped mean"):
        tseqs.make_engine(
            FederatedConfig(num_clients=M, hierarchy_period=2),
            tseqs.SPECS["fedbio"],
            {s: torch.empty(TOY[s], device="meta") for s in ("x", "y", "u")},
            None, block=8, stragglers=ts.make_stragglers(
                ts.StragglerSpec(**MIXED), M))


@pytest.mark.parametrize("fields", [None, dict(sampler="uniform",
                                               clients_per_round=3)],
                         ids=["no_sampler", "uniform"])
def test_step_metrics_record_the_round_decision(fields):
    """Each step writes its round's decision into the metrics it is given:
    the same on both local steps of a round, and round by round what
    ``simulate_rounds`` replays; without stragglers it writes nothing."""
    _, _, te, st, tpart = _engines("fedbioacc", fields,
                                   stragglers=ENGINE_STRAG)
    rows = ts.simulate_rounds(
        ts.make_stragglers(ts.StragglerSpec(**ENGINE_STRAG), M), tpart, 2)
    seen = []
    for t, b in enumerate(_batches()):
        metrics = {}
        st = te.step(st, torch.tensor(b), metrics)
        decided = metrics["decision"]
        row = rows[t // 2]
        sampled = torch.ones(M) if tpart is None else tpart.mask_fn(t // 2)
        assert not torch.any(decided["arrivals"] > sampled)
        assert (int(decided["arrivals"].sum()), decided["extensions"],
                round(decided["deadline"], 6), decided["quorum"]) == \
            (row["arrivals"], row["extensions"], row["deadline"],
             row["quorum"])
        if t % 2:
            assert torch.equal(decided["arrivals"], seen[-1]["arrivals"])
            assert decided["deadline_next"] == float(st.deadline)
        seen.append(decided)
    _, _, te_n, st_n, _ = _engines("fedbioacc", fields)
    decided = {}
    te_n.step(st_n, torch.tensor(0.3), decided)
    assert decided == {}
