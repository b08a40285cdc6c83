"""Partial participation in the port against the JAX package's
(``repro.federation.participation``, the participation half of
``repro.optim.flat`` and of ``repro.optim.sequences``), on the CPU, with
inputs drawn with numpy from a seed.

* Masks: the four samplers for rounds 0-63 and three seeds, bit for bit.
  ``weighted`` rests on ``gumbel``, within 4 ulps of max(|v|, 1) of the
  reference's, and ``log``, within 1 ulp: its mask could differ only where
  the m-th and (m+1)-th scores lie within ``TIE`` (16 ulps of max(|s|, 1))
  of each other, and the test checks that no seed and round it uses comes
  that close.
* Weighted means: bit for bit with the reference's compiled
  ``client_mean_masked`` (which fuses ``x · col`` into the sum as
  multiply-adds, in f32, with ``col`` in the buffer's dtype).
* Gating: non-participants come out of the three gated launches (plain
  versions of ``storm3_step``, ``sgd3_step``, ``momsgd3_step``) bit for
  bit as they went in, non-finite gradients included.
* Toy engines (storm kind with a PRIVATE section, sgd kind; uniform 2 of 4,
  α = 0.5): variables and momenta within ``ENGINE_TOL`` of each buffer's
  norm after 4 steps, staleness counters equal.  The reference's jitted
  step contracts multiply-adds that the port's kernels round separately
  (``v − lr·g``; and, with a mask set, ``decay·(m − g_old) + g_new``, the
  partial momentum's product with the correction add): each step differs
  by at most a rounding of a product an element, ~1e-7 of the norm here.
* The port's own invariant: uniform(m = M) through the port's engine is bit
  for bit the engine without participation.  The reference breaks it under
  ``jit`` through that contraction, which only its masked step makes
  (``tests/test_participation.py::
  test_uniform_m_equals_no_participation_engine_bitwise``); the last test
  pins that down.
"""
import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.config import FederatedConfig as JConfig  # noqa: E402
from repro.federation import participation as jp  # noqa: E402
from repro.optim import flat as jflat  # noqa: E402
from repro.optim import sequences as jseqs  # noqa: E402
from repro_torch.config import FederatedConfig as TConfig  # noqa: E402
from repro_torch.core.tree_util import tree_map  # noqa: E402
from repro_torch.federation import participation as tp  # noqa: E402
from repro_torch.kernels.storm import kernel as tk  # noqa: E402
from repro_torch.optim import flat as tflat  # noqa: E402
from repro_torch.optim import sequences as tseqs  # noqa: E402
from torch_parity import bits, to_torch  # noqa: E402

torch.set_num_threads(1)

M = 4
SEEDS = (0, 3, 11)
ROUNDS = 64
TIE = 16
ENGINE_TOL = 1e-6
# sampler → (spec fields, number of clients)
SAMPLER_CASES = {
    "full": (dict(sampler="full"), 4),
    "uniform": (dict(sampler="uniform", clients_per_round=3), 7),
    "weighted": (dict(sampler="weighted", clients_per_round=3,
                      client_weights=(1.0, 2.0, 3.0, 4.0, 0.5, 8.0)), 6),
    "trace": (dict(sampler="trace", availability_rate=0.5, min_clients=2),
              5),
}


def _pair(fields: dict, m: int):
    return (jp.make_participation(jp.ParticipationSpec(**fields), m),
            tp.make_participation(tp.ParticipationSpec(**fields), m))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("sampler", sorted(SAMPLER_CASES))
def test_sampler_masks_match_reference(sampler, seed):
    fields, m = SAMPLER_CASES[sampler]
    jpart, tpart = _pair({**fields, "seed": seed}, m)
    for r in range(ROUNDS):
        want = np.asarray(jpart.mask_fn(jnp.int32(r)))
        if sampler == "weighted":
            k = jax.random.fold_in(jax.random.PRNGKey(seed), jnp.int32(r))
            s = np.sort(np.asarray(jnp.log(jpart.base_weights)
                                   + jax.random.gumbel(k, (m,))))[::-1]
            gap = s[fields["clients_per_round"] - 1] - \
                s[fields["clients_per_round"]]
            assert gap > TIE * np.spacing(np.float32(max(abs(s).max(), 1)))
        got = tpart.mask_fn(r)
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_array_equal(bits(got), bits(want))
        _, w = tpart.round_weights(r)
        _, jw = jpart.round_weights(jnp.int32(r))
        np.testing.assert_array_equal(bits(w), bits(jw))
    assert tp.expected_comm_fraction(tpart) == \
        jp.expected_comm_fraction(jpart)


def test_expected_comm_fraction_without_participation():
    assert tp.expected_comm_fraction(None) == jp.expected_comm_fraction(None)
    assert tp.make_participation(None, 4) is None


@pytest.mark.parametrize("envelope", [False, True])
def test_trace_file_replay_matches_reference(tmp_path, envelope):
    rows = [[1, 0, 1, 1], [0, 1, 1, 0], [1, 1, 0, 0]]
    path = tmp_path / "avail.json"
    path.write_text(json.dumps({"masks": rows} if envelope else rows))
    jpart, tpart = _pair(dict(sampler="trace", trace_path=str(path)), 4)
    for r in range(8):
        np.testing.assert_array_equal(
            bits(tpart.mask_fn(r)), bits(jpart.mask_fn(jnp.int32(r))))
    assert tp.expected_comm_fraction(tpart, num_rounds=6) == \
        jp.expected_comm_fraction(jpart, num_rounds=6)


TRACE_ERRORS = [
    ([[1, 0, 1]], {}),
    ([[2, 0, 1, 1]], {}),
    ([[1, 1, 1, 1], [0, 0, 0, 0]], {}),
    ([[1, 1, 0, 0], [1, 0, 0, 0]], {"min_clients": 2}),
    ([[1, 0, 1, 1]], {"sampler": "uniform", "clients_per_round": 2}),
    ([[1, 0, 1, 1]], {"clients_per_round": 2}),
    ([[1, 0, 1, 1]], {"min_clients": 5}),
]
SPEC_ERRORS = [
    dict(sampler="uniform", clients_per_round=9),
    dict(sampler="nope"),
    dict(sampler="full", client_weights=(1.0, 2.0)),
    dict(sampler="uniform", client_weights=(1.0, 2.0, 0.0, 1.0)),
    dict(sampler="weighted", clients_per_round=2),
    dict(sampler="weighted", clients_per_round=5,
         client_weights=(1.0, 1.0, 1.0, 1.0)),
    dict(sampler="trace", clients_per_round=2),
    dict(sampler="trace", min_clients=0),
]


def _message(make, spec, m):
    with pytest.raises(ValueError) as err:
        make(spec, m)
    return str(err.value)


@pytest.mark.parametrize("rows,fields", TRACE_ERRORS)
def test_trace_validation_errors_match_reference(tmp_path, rows, fields):
    path = tmp_path / "bad.json"
    path.write_text(json.dumps(rows))
    fields = {"sampler": "trace", "trace_path": str(path), **fields}
    assert _message(tp.make_participation, tp.ParticipationSpec(**fields),
                    4) == \
        _message(jp.make_participation, jp.ParticipationSpec(**fields), 4)


@pytest.mark.parametrize("fields", SPEC_ERRORS)
def test_spec_validation_errors_match_reference(fields):
    assert _message(tp.make_participation, tp.ParticipationSpec(**fields),
                    4) == \
        _message(jp.make_participation, jp.ParticipationSpec(**fields), 4)


# ---------------------------------------------------------------------------
# the weighted masked mean
# ---------------------------------------------------------------------------

SHAPES = {"x": (700,), "y": (300,), "z": (50,)}


def _flat_pair(dtype: str, seed: int = 0):
    """(jax spec, torch spec, jax buffers, torch buffers): sections x | y | z
    over 256-element tiles, M clients drawn with numpy."""
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


def _aged(alpha: float):
    stale = np.array([0, 2, 1, 0], np.int32)
    base = np.array([1.0, 1.0, 0.0, 1.0], np.float32)
    jw = jseqs.staleness_weights(jnp.asarray(base), jnp.asarray(stale),
                                 (alpha,))[0]
    tw = tseqs.staleness_weights(torch.from_numpy(base),
                                 torch.from_numpy(stale), alpha)
    np.testing.assert_array_equal(bits(tw), bits(jw))
    return jw, tw


def _weights(case: str):
    """(jax weights, torch weights, modes) of a case."""
    if case == "aged":
        jw, tw = _aged(0.5)
    else:
        w = {"two_of_four": [2.0, 0.0, 1.0, 0.0],
             "ones": [1.0, 1.0, 1.0, 1.0],
             "nobody": [0.0, 0.0, 0.0, 0.0]}[case]
        jw, tw = jnp.asarray(w, jnp.float32), torch.tensor(w)
    return jw, tw, ("mean", "none", "mean")


@pytest.mark.parametrize("case", ["two_of_four", "ones", "nobody", "aged"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weighted_mean_matches_reference_bitwise(dtype, case):
    js, ts, jb, tb = _flat_pair(dtype)
    jw, tw, modes = _weights(case)
    want = jax.jit(lambda b: jflat.client_mean_masked(
        js, b, modes, weights=jw))(jb)
    entering = tuple(b.clone() for b in tb)
    got = tflat.client_mean_masked(ts, tb, modes, weights=tw)
    np.testing.assert_array_equal(bits(got[0]), bits(want[0]))
    # non-participant and private rows pass through bit for bit (with no
    # participant at all, every row does)
    for s, a, b in ts.groups[0].extents:
        for m in range(M):
            if modes[s] == "none" or tw[m] == 0:
                np.testing.assert_array_equal(bits(got[0][m, a:b]),
                                              bits(entering[0][m, a:b]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_all_ones_weights_are_the_unweighted_mean_bitwise(dtype):
    _, ts, _, tb = _flat_pair(dtype, seed=1)
    modes = ("mean", "none", "mean")
    plain = tflat.client_mean_masked(ts, tuple(b.clone() for b in tb), modes)
    ones = tflat.client_mean_masked(ts, tuple(b.clone() for b in tb), modes,
                                    weights=torch.ones(M))
    np.testing.assert_array_equal(bits(ones[0]), bits(plain[0]))


def test_weighted_compressed_mean_is_refused_by_name():
    """Once refused (ROADMAP queue 1, 'Compression, the rest'), the
    participation-weighted compressed mean runs (held to the reference in
    ``test_torch_compress_weighted.py``): all-ones weights give the
    unweighted compressed mean bit for bit, and a client of weight 0 keeps
    its row."""
    _, ts, _, tb = _flat_pair("float32")
    modes, cfg = ("mean", "none", "mean"), tflat.CompressCfg(quant="bf16")
    plain, _ = tflat.client_mean_masked(ts, tuple(b.clone() for b in tb),
                                        modes, compress=cfg)
    ones, _ = tflat.client_mean_masked(ts, tuple(b.clone() for b in tb),
                                       modes, weights=torch.ones(M),
                                       compress=cfg)
    np.testing.assert_array_equal(bits(ones[0]), bits(plain[0]))
    w = torch.tensor([1.0, 0.0, 1.0, 1.0])
    some, ef = tflat.client_mean_masked(ts, tuple(b.clone() for b in tb),
                                        modes, weights=w, compress=cfg)
    assert ef == () and torch.equal(some[0][1], tb[0][1])
    a, b = ts.groups[0].extents[0][1:]          # x, communicated
    assert torch.equal(some[0][0, a:b], some[0][2, a:b])
    assert not torch.equal(some[0][0, a:b], plain[0][0, a:b])


# ---------------------------------------------------------------------------
# gated launches
# ---------------------------------------------------------------------------

def _gated_inputs(dtype: str, seed: int):
    """Buffers, momenta, gradients (inf/nan in a left-out client's rows),
    per-section lrs and decays, the mask, jax and torch sides."""
    js, ts, jb, tb = _flat_pair(dtype, seed)
    rng = np.random.default_rng(seed + 100)
    n = js.groups[0].padded
    mom = rng.standard_normal((M, n)).astype(np.float32)
    g = rng.standard_normal((M, n)).astype(np.float32)
    g[1, :5] = [np.inf, -np.inf, np.nan, 1e38, -0.0]
    lrs = rng.uniform(0.01, 0.2, 3).astype(np.float32)
    decays = rng.uniform(0.5, 1.0, 3).astype(np.float32)
    mask = np.array([1.0, 0.0, 1.0, 0.0], np.float32)
    jside = (jb, (jnp.asarray(mom),), (jnp.asarray(g),),
             tuple(jnp.asarray(v) for v in lrs),
             tuple(jnp.asarray(v) for v in decays), jnp.asarray(mask))
    tside = (tb, (torch.from_numpy(mom),), (torch.from_numpy(g),),
             tuple(torch.tensor(v) for v in lrs),
             tuple(torch.tensor(v) for v in decays), torch.from_numpy(mask))
    return js, ts, jside, tside


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gate_and_mask_buffers_match_reference(dtype):
    js, ts, jside, tside = _gated_inputs(dtype, 2)
    jg = jflat.mask_buffers(jside[2], jside[5])
    tg = tflat.mask_buffers(tside[2], tside[5])
    np.testing.assert_array_equal(bits(tg[0]), bits(jg[0]))
    assert not torch.any(tg[0][1]) and not torch.any(tg[0][3])
    grp, jgrp = ts.groups[0], js.groups[0]
    jl, jd = jflat._gate(jflat._tile_table(jgrp, jside[0][0], jside[3]),
                         jflat._tile_table(jgrp, jside[0][0], jside[4]),
                         jside[5], 1.0)
    tl, td = tflat._gate(tflat._tile_table(grp, tside[0][0], tside[3]),
                         tflat._tile_table(grp, tside[0][0], tside[4]),
                         tside[5], 1.0)
    np.testing.assert_array_equal(bits(tl), bits(jl))
    np.testing.assert_array_equal(bits(td), bits(jd))
    assert tflat.mask_buffers(tside[2], None) is tside[2]


@pytest.mark.parametrize("launch", ["storm3_step", "sgd3_step",
                                    "momsgd3_step"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gated_launches_freeze_non_participants(dtype, launch):
    """Non-participants' rows leave each gated launch bit for bit as they
    entered, with inf/nan in their gradients; one call per dtype buffer."""
    _, ts, _, (v, m, g, lrs, decays, mask) = _gated_inputs(dtype, 4)
    g = tflat.mask_buffers(g, mask)
    tk.reset_counts()
    if launch == "storm3_step":
        outs = tflat.storm_partial_step(ts, v, m, g, lrs, decays, mask=mask)
        ins = (v, m)
    elif launch == "momsgd3_step":
        outs = tflat.momentum_sgd_step(ts, v, m, g, lrs, decays, mask=mask)
        ins = (v, m)
    else:
        outs = (tflat.sgd_step(ts, v, g, lrs, mask=mask),)
        ins = (v,)
    assert tk.CALLS[launch] == 1 and sum(tk.CALLS.values()) == 1
    for before, after in zip(ins, outs):
        for c in (1, 3):
            np.testing.assert_array_equal(bits(after[0][c]),
                                          bits(before[0][c]))
        for c in (0, 2):
            assert not np.array_equal(bits(after[0][c]), bits(before[0][c]))
        assert bool(torch.isfinite(after[0].float()).all())


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

TOY = {"x": (6,), "y": (3,), "u": (3,), "params": (9,)}


def _engines(algo: str, fields: dict | None, compression=None,
             stragglers: dict | None = None):
    """The reference's and the port's toy engines (the oracle 0.1·v + b per
    section, 8-element tiles, 2 local steps) and their initial states;
    ``stragglers``: the fields of a ``StragglerSpec`` to attach to both."""
    kw = dict(num_clients=M, local_steps=2, lr_x=0.05, lr_y=0.1, lr_u=0.1)
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    ja = jseqs.SPECS[algo].without_hierarchy()
    ta = tseqs.SPECS[algo].without_hierarchy()

    def jorc(v, b):
        return {s: jax.tree.map(lambda a: 0.1 * a + b, v[s])
                for s in ja.sections}

    def torc(v, b):
        return {s: tree_map(lambda a: 0.1 * a + b, v[s])
                for s in ta.sections}

    jpart = None if fields is None else jp.make_participation(
        jp.ParticipationSpec(**fields), M)
    tpart = None if fields is None else tp.make_participation(
        tp.ParticipationSpec(**fields), M)
    jstrag = tstrag = None
    if stragglers is not None:
        from repro.federation import stragglers as js
        from repro_torch.federation import stragglers as ts
        jstrag = js.make_stragglers(js.StragglerSpec(**stragglers), M)
        tstrag = ts.make_stragglers(ts.StragglerSpec(**stragglers), M)
    je = jseqs.make_engine(jcfg, ja, {s: jnp.zeros(TOY[s])
                                      for s in ja.sections},
                           jorc, block=8, participation=jpart,
                           stragglers=jstrag)
    te = tseqs.make_engine(tcfg, ta, {s: torch.empty(TOY[s], device="meta")
                                      for s in ta.sections},
                           torc, block=8, participation=tpart,
                           compression=compression, stragglers=tstrag)
    rng = np.random.default_rng(0)
    vt = {s: rng.standard_normal((M,) + TOY[s]).astype(np.float32)
          for s in ja.sections}
    return (je, je.init_state({k: jnp.asarray(v) for k, v in vt.items()}),
            te, te.init_state({k: torch.from_numpy(v)
                               for k, v in vt.items()}), tpart)


def _batches():
    return [np.float32(0.3 + 0.1 * t) for t in range(4)]


@pytest.mark.parametrize("algo", ["fedbioacc_local", "fedbio"])
def test_toy_engine_matches_reference_over_two_rounds(algo):
    fields = dict(sampler="uniform", clients_per_round=2, stale_discount=0.5,
                  seed=5)
    je, js, te, ts, tpart = _engines(algo, fields)
    jstep = jax.jit(je.step)
    assert ts.stale.dtype == torch.int32 and not torch.any(ts.stale)
    for t, b in enumerate(_batches()):
        js = jstep(js, jnp.float32(b))
        before = ts
        ts = te.step(ts, torch.tensor(b))
        mask = tpart.mask_fn(t // 2)
        for b0, b1 in zip(before.vars + before.mom, ts.vars + ts.mom):
            for c in range(M):
                if mask[c] == 0:
                    np.testing.assert_array_equal(bits(b1[c]), bits(b0[c]))
        np.testing.assert_array_equal(ts.stale.numpy(), np.asarray(js.stale))
    assert ts.step == int(js.step) == 4
    assert len(ts.mom) == len(js.mom) == (1 if algo == "fedbioacc_local"
                                          else 0)
    for jb, tb in zip(js.vars + js.mom, ts.vars + ts.mom):
        jb = np.asarray(jb)
        assert np.linalg.norm(tb.numpy() - jb) <= \
            ENGINE_TOL * np.linalg.norm(jb)


@pytest.mark.parametrize("algo", ["fedbioacc_local", "fedbio", "fedavg"])
def test_uniform_m_equals_no_participation_bitwise(algo):
    """The port's invariant: all-ones masks and weights change no bit."""
    _, _, te_p, ts_p, _ = _engines(
        algo, dict(sampler="uniform", clients_per_round=M))
    _, _, te_n, ts_n, _ = _engines(algo, None)
    for b in _batches():
        ts_p = te_p.step(ts_p, torch.tensor(b))
        ts_n = te_n.step(ts_n, torch.tensor(b))
    for a, b in zip(ts_p.vars + ts_p.mom, ts_n.vars + ts_n.mom):
        np.testing.assert_array_equal(bits(a), bits(b))
    assert ts_n.stale == () and ts_p.stale.tolist() == [0] * M


def test_engine_refuses_participation_with_compression():
    """Once refused (ROADMAP queue 1, 'Compression, the rest'),
    participation with compression runs: over two rounds of the toy FedBiO
    engine with bf16 sends, every step leaves the non-participants' rows
    at their entering bits and every round the participants' rows on one
    mean."""
    from repro_torch.federation.compression import CompressionSpec
    _, _, te, ts, tpart = _engines(
        "fedbio", dict(sampler="uniform", clients_per_round=2),
        compression=CompressionSpec(quant="bf16"))
    for t, b in enumerate(_batches()):
        before = ts
        ts = te.step(ts, torch.tensor(b))
        mask = tpart.mask_fn(t // 2)
        ins = [c for c in range(M) if mask[c] > 0]
        for c in range(M):
            if mask[c] == 0:
                np.testing.assert_array_equal(bits(ts.vars[0][c]),
                                              bits(before.vars[0][c]))
        if t % 2:
            assert torch.equal(ts.vars[0][ins[0]], ts.vars[0][ins[1]])
    missed = [(tpart.mask_fn(r) == 0).tolist() for r in (0, 1)]
    assert ts.stale.tolist() == [(m0 + 1) * m1 for m0, m1 in zip(*missed)]


def test_init_state_takes_staleness_counters():
    _, _, te, _, _ = _engines("fedbio", dict(sampler="uniform",
                                             clients_per_round=2))
    v = {s: torch.zeros((M,) + TOY[s]) for s in ("x", "y", "u")}
    st = te.init_state(v, stale=[0, 3, 1, 0], step=6)
    assert st.stale.dtype == torch.int32 and st.stale.tolist() == [0, 3, 1, 0]
    assert st.step == 6


def test_reference_contracts_the_storm_correction_under_participation():
    """What the reference computes on the input of its seed-red
    ``test_uniform_m_equals_no_participation_engine_bitwise``: after one
    jitted step from zero momenta, its momentum with a participation mask
    is ``fma(decay, −g_old, g_new)``, one rounding, and without one
    ``decay·(−g_old)`` rounded and then ``+ g_new``.  The port rounds the
    product in both cases (its kernel writes it, as the TPU's does)."""
    cfg = JConfig(num_clients=M, local_steps=2, lr_x=0.05, lr_y=0.1,
                  lr_u=0.1)
    aspec = jseqs.SPECS["fedbioacc"].without_hierarchy()
    tmpl = {s: jnp.zeros(TOY[s]) for s in aspec.sections}

    def oracle(v, batch):
        return {s: jax.tree.map(lambda a: 0.1 * a + batch, v[s])
                for s in aspec.sections}

    key = jax.random.PRNGKey(0)
    vt = {s: jax.random.normal(jax.random.fold_in(key, i), (M,) + TOY[s])
          for i, s in enumerate(aspec.sections)}
    part = jp.make_participation(jp.ParticipationSpec("uniform", M), M)
    outs = {}
    for name, p in (("masked", part), ("plain", None)):
        eng = jseqs.make_engine(cfg, aspec, tmpl, oracle, block=8,
                                participation=p)
        st = eng.init_state(vt)
        outs[name] = (st, jax.jit(eng.step)(st, jnp.float32(0.0)))
    st0, st1 = outs["masked"]
    a = np.float32(jseqs.alpha_schedule(cfg, jnp.int32(0)))
    dec = np.array([np.float32(1.0) - np.float32(getattr(cfg, q.decay)) * a
                    * a for q in aspec.sequences], np.float32)
    dec = np.repeat(dec[np.asarray(eng.spec.groups[0].section_ids)], 8)
    g_old = np.float32(0.1) * np.asarray(st0.vars[0])
    g_new = np.float32(0.1) * np.asarray(st1.vars[0])
    rounded = (dec * (np.float32(0.0) - g_old)) + g_new
    fused = (dec.astype(np.float64) * -g_old.astype(np.float64)
             + g_new).astype(np.float32)
    assert not np.array_equal(rounded, fused)
    np.testing.assert_array_equal(np.asarray(st1.mom[0]), fused)
    np.testing.assert_array_equal(np.asarray(outs["plain"][1].mom[0]),
                                  rounded)
