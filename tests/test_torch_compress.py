"""Compressed communication in the port against the JAX package's.

The reference is run as the TPU runs it (the ``tpu_reference`` fixture):
its int8 round trip goes through its Pallas ``quantpack_flat`` /
``quantunpack_flat`` kernels, in interpret mode, which write the rounded
f32 products that the client mean then sums.  (Under ``jit`` on the CPU its
jnp lowering lets XLA fuse those products into the sums as multiply-adds;
:func:`test_int8_mean_differs_from_cpu_fused_reference_by_rounding` bounds
that difference.)

* the compressed client mean with error feedback
  (``flat.client_mean_masked(compress=, ef=)``) equals the reference's
  jitted one bit for bit, for int8, bf16 and no quantization, with and
  without top-k, with and without error feedback, at M = 2 and 8; a private
  section stays untouched and a ``sections=`` subset leaves the other runs
  at the exact mean;
* the engines (``make_engine(compression=)``) of both kinds equal the
  reference's bit for bit over 4 steps (two rounds) with int8 + top-k 10 %
  + error feedback at M = 8, when both are fed the same gradient table
  (see :func:`test_engine_matches_reference_bitwise`); the storm kind at
  its real rates agrees under the flip rules;
* ``experiments/fedbioacc_int8_topk.json`` as committed, two steps from the
  reference's initial state and batches, under the flip rules of
  :func:`repro_torch.testing.topk_flips` and
  :func:`repro_torch.testing.int8_flips`;
* the engine and spec rejections, and the CLI on the CPU."""
import functools
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.api import Experiment as JExperiment  # noqa: E402
from repro.api import build as jbuild  # noqa: E402
from repro.config import FederatedConfig as JFederatedConfig  # noqa: E402
from repro.federation.compression import \
    CompressionSpec as JCompressionSpec  # noqa: E402
from repro.kernels.storm import quantpack as jqp  # noqa: E402
from repro.optim import flat as jflat  # noqa: E402
from repro.optim import sequences as jseqs  # noqa: E402
from repro_torch.api import Experiment, build  # noqa: E402
from repro_torch.api.spec import SpecError  # noqa: E402
from repro_torch.config import FederatedConfig  # noqa: E402
from repro_torch.federation.compression import CompressionSpec  # noqa: E402
from repro_torch.kernels.storm import quantpack as tqp  # noqa: E402
from repro_torch.optim import flat as tflat  # noqa: E402
from repro_torch.optim import sequences as seqs  # noqa: E402
from repro_torch.testing import int8_flips, topk_flips  # noqa: E402
from torch_parity import bits, f32, to_torch  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SPEC = ROOT / "experiments" / "fedbioacc_int8_topk.json"
SECTIONS, BLOCK = ("x", "y", "u"), 128


@pytest.fixture
def tpu_reference(monkeypatch):
    """Route the reference substrate's int8 round trip through its Pallas
    kernels (interpret mode), as on a TPU, instead of their jnp lowerings."""
    monkeypatch.setattr(jflat, "quantpack_flat_jnp", functools.partial(
        jqp.quantpack_flat, interpret=True))
    monkeypatch.setattr(jflat, "quantunpack_flat_jnp", functools.partial(
        jqp.quantunpack_flat, interpret=True))


# ---------------------------------------------------------------------------
# the compressed client mean
# ---------------------------------------------------------------------------

def _tree(m: int, seed: int):
    """[m, ...] leaves of a mixed bf16/f32 x|y|u tree; each section spans
    several 128-element tiles of at least one buffer."""
    rng = np.random.default_rng(seed)

    def n(*s, dt="float32"):
        v = rng.standard_normal((m,) + s) * rng.lognormal(0.0, 1.0, (m,) + s)
        return jnp.asarray(v.astype(np.float32)).astype(dt)

    return {"x": {"w": n(3, 100, dt="bfloat16"), "b": n(150)},
            "y": {"w": n(200, dt="bfloat16")},
            "u": {"w": n(90, dt="bfloat16"), "s": n(300)}}


def _case(m: int, seed: int):
    tree = _tree(m, seed)
    tmpl = jax.tree.map(lambda a: a[0], tree)
    jspec = jflat.make_spec(tmpl, sections=SECTIONS, block=BLOCK)
    tspec = tflat.make_spec(to_torch(tmpl), sections=SECTIONS, block=BLOCK)
    jbufs = jflat.flatten_tree(jspec, tree, batch_dims=1)
    rng = np.random.default_rng(seed + 100)
    jef = tuple(jnp.asarray((0.3 * rng.standard_normal(b.shape))
                            .astype(np.float32)) for b in jbufs)
    return jspec, tspec, jbufs, jef


def _run_both(jspec, tspec, jbufs, jef, modes, ccfg_kw):
    jcfg = jflat.CompressCfg(**ccfg_kw)
    tcfg = tflat.CompressCfg(**ccfg_kw)
    ef_in = jef if jcfg.has_ef else ()
    jout, jnew = jax.jit(lambda b, e: jflat.client_mean_masked(
        jspec, b, modes, compress=jcfg, ef=e))(jbufs, ef_in)
    tbufs = tuple(to_torch(list(jbufs)))
    tef = tuple(to_torch(list(ef_in)))
    tout, tnew = tflat.client_mean_masked(tspec, tbufs, modes, compress=tcfg,
                                          ef=tef)
    return (jout, jnew), (tout, tnew), tef


COMPRESSORS = [(q, k) for q in (None, "bf16", "int8") for k in (0.0, 0.1)
               if (q, k) != (None, 0.0)]


@pytest.mark.parametrize("m", [2, 8])
@pytest.mark.parametrize("error_feedback", [True, False])
@pytest.mark.parametrize("quant,topk", COMPRESSORS)
def test_compressed_mean_matches_reference_bitwise(quant, topk,
                                                   error_feedback, m,
                                                   tpu_reference):
    jspec, tspec, jbufs, jef = _case(m, seed=m)
    kw = dict(quant=quant, topk_frac=topk, error_feedback=error_feedback)
    (jout, jnew), (tout, tnew), tef = _run_both(
        jspec, tspec, jbufs, jef, ("mean",) * 3, kw)
    for jb, tb in zip(jout, tout):
        np.testing.assert_array_equal(bits(tb), bits(jb))
    assert len(tnew) == len(jnew) == (len(jbufs) if topk and error_feedback
                                      else 0)
    for je, te, e_in in zip(jnew, tnew, tef):
        np.testing.assert_array_equal(bits(te), bits(je))
        assert not torch.equal(te, e_in)      # the caller's buffers stay
    for tb in tout:                           # one mean for every client
        assert torch.equal(tb[0], tb[-1])


def test_private_section_and_section_subset(tpu_reference):
    """int8 + top-k with feedback on x only, y private, u averaged exactly:
    bitwise against the reference; y untouched; u at the exact mean; the EF
    of y and u unchanged."""
    m = 8
    jspec, tspec, jbufs, jef = _case(m, seed=11)
    modes = ("mean", "none", "mean")
    kw = dict(quant="int8", topk_frac=0.1, sections=("x",))
    (jout, jnew), (tout, tnew), tef = _run_both(jspec, tspec, jbufs, jef,
                                                modes, kw)
    tin = tuple(to_torch(list(jbufs)))
    exact = tflat.client_mean_masked(tspec, tuple(b.clone() for b in tin),
                                     modes)
    for g, grp in enumerate(tspec.groups):
        np.testing.assert_array_equal(bits(tout[g]), bits(jout[g]))
        np.testing.assert_array_equal(bits(tnew[g]), bits(jnew[g]))
        for s, a, b in grp.extents:
            name = SECTIONS[s]
            if name == "x":
                assert not torch.equal(tout[g][:, a:b], exact[g][:, a:b])
                continue
            want = tin[g] if name == "y" else exact[g]
            np.testing.assert_array_equal(bits(tout[g][:, a:b]),
                                          bits(want[:, a:b]))
            np.testing.assert_array_equal(bits(tnew[g][:, a:b]),
                                          bits(tef[g][:, a:b]))


def _spacing(x) -> np.ndarray:
    """One unit in the last place of each |x| in f32, as f64."""
    return np.spacing(np.abs(np.asarray(x, np.float64)).astype(np.float32)) \
        .astype(np.float64)


@pytest.mark.parametrize("m", [2, 8])
def test_int8_mean_differs_from_cpu_fused_reference_by_rounding(
        m, monkeypatch):
    """Against the reference's default CPU lowering, where XLA fuses the
    products ``p = q·s`` into the sums, the port's int8 mean and error
    feedback differ by the products' roundings alone.  Both sides quantize
    the same f32 sends (bit for bit), so the exact products agree.

    Error feedback: the port's ``e = rn(a − rn(p))`` and the reference's
    ``e' = rn(a − p)`` differ by at most ``½ulp(p) + ½ulp(e) + ½ulp(e')``.
    Mean: the port's partial sums ``T_k = rn(T_{k−1} + rn(p_k))`` and the
    reference's ``T'_k = rn(T'_{k−1} + p_k)`` drift apart by at most
    ``d_k = d_{k−1} + ½ulp(p_k) + ½ulp(T_k) + ½ulp(T'_k)`` with
    ``|T'_k| ≤ |T_k| + d_k``; the means ``rn(T·(1/M))`` then differ by at
    most ``d_M/M + ½ulp(mean) + ½ulp(mean')``.  ulp(T'_k) is taken at
    ``(|T_k| + d_{k−1} + ulp(p_k) + ulp(T_k))·(1 + 2⁻²⁰)``, which bounds
    ``|T'_k|``.  The means are checked on the f32 buffer (the bf16 one
    rounds them once more), the error feedback on both."""
    jspec, tspec, jbufs, jef = _case(m, seed=20 + m)
    kw = dict(quant="int8", topk_frac=0.1)
    tcalls = []
    orig = tflat.quantunpack_flat

    def recording(q, sc, *, block):
        tcalls.append((q.numpy().astype(np.float64)
                       * np.repeat(sc.numpy().astype(np.float64), block)))
        return orig(q, sc, block=block)

    monkeypatch.setattr(tflat, "quantunpack_flat", recording)
    (jout, jnew), (tout, tnew), _ = _run_both(jspec, tspec, jbufs, jef,
                                              ("mean",) * 3, kw)
    assert len(tcalls) == len(tspec.groups)   # one whole-buffer run each
    inv = np.float64(np.float32(1.0) / np.float32(m))
    differ = 0
    for g, prod in enumerate(tcalls):
        p = prod.reshape(m, -1)
        e, ej = f32(tnew[g]).astype(np.float64), np.asarray(jnew[g], np.float64)
        tol = 0.5 * (_spacing(p) + _spacing(e) + _spacing(ej))
        assert np.all(np.abs(e - ej) <= tol)
        differ += int(np.sum(e != ej))
        if tout[g].dtype != torch.float32:
            continue      # the bf16 group's means are rounded once more
        t = np.zeros(p.shape[1], np.float32)
        d = np.zeros(p.shape[1])
        for k in range(m):
            t = t + p[k].astype(np.float32)
            big = (np.abs(t) + d + _spacing(p[k]) + _spacing(t)) \
                * (1 + 2.0 ** -20)
            d = d + 0.5 * (_spacing(p[k]) + _spacing(t) + _spacing(big))
        mean = (t * np.float32(inv)).astype(np.float32)
        got = f32(tout[g][0])
        np.testing.assert_array_equal(bits(got), bits(mean))   # the port's sum
        want = np.asarray(jout[g][0], np.float32)
        d_mean = d * inv
        tol = d_mean + 0.5 * (_spacing(got) + _spacing(np.abs(got) + d_mean))
        assert np.all(np.abs(got.astype(np.float64) - want) <= tol)
        differ += int(np.sum(got != want))
    assert differ      # the fusion shows on this data


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

STEPS, EM = 4, 8
# the update's products are exact in f32 (powers of two, or zero), so XLA's
# contraction of them into FMAs on the reference's side changes no bit
ENGINE_CFG = {
    "fedbioacc": dict(lr_x=0.0, lr_y=0.0, lr_u=0.0, c_nu=0.0, c_omega=0.0,
                      c_u=0.0),
    "fedbio_local": dict(lr_x=2.0 ** -5, lr_y=2.0 ** -4),
    "fedavg": dict(lr_x=2.0 ** -5),
}


def _engine_case(name: str):
    rng = np.random.default_rng(7)
    shapes = {"w": (EM, 5, 60), "b": (EM, 70)}
    sections = seqs.SPECS[name].sections
    init = {s: {k: (rng.standard_normal(sh) * 2.0).astype(np.float32)
                for k, sh in shapes.items()} for s in sections}
    table = {s: {k: (rng.standard_normal((STEPS,) + sh)
                     * rng.lognormal(0.0, 1.0, (STEPS,) + sh)).astype(
                         np.float32) for k, sh in shapes.items()}
             for s in sections}
    return init, table


@pytest.mark.parametrize("name", sorted(ENGINE_CFG))
def test_engine_matches_reference_bitwise(name, tpu_reference):
    """Both engines over the same templates, fed one gradient table: at
    step t the oracle returns ``table[t] + views / 2`` (exact in f32, and
    dependent on the iterate, so what compression does to the variables
    feeds back).  The fused updates' products must be exact for the two
    sides to agree bit for bit (the reference's compiled update contracts
    ``p − lr·m`` and ``decay·(m − g_old) + g_new`` into FMAs, the port's
    kernels do not), so the sgd kinds use power-of-two rates (FedAvg
    β = ½) and the storm kind lr = 0 with decay 1: its variables move only
    through the compressed means, and its momenta carry the differences of
    the gradients.  int8 + top-k 10 % + feedback, M = 8, two rounds."""
    init, table = _engine_case(name)
    aspec = seqs.SPECS[name]
    jaspec = jseqs.SPECS[name]
    if name == "fedavg":
        aspec, jaspec = aspec._replace(beta=0.5), jaspec._replace(beta=0.5)
    kw = dict(num_clients=EM, local_steps=2, **ENGINE_CFG[name])
    csp = dict(quant="int8", topk_frac=0.1)
    jtab = jax.tree.map(jnp.asarray, table)

    def joracle(views, t):
        return {s: jax.tree.map(lambda g, v: g[t] + v.astype(jnp.float32) / 2,
                                jtab[s], views[s]) for s in views}

    def toracle(views, t):
        return {s: {k: torch.from_numpy(table[s][k][t]) + v.float() / 2
                    for k, v in views[s].items()} for s in views}

    jtmpl = {s: jax.tree.map(lambda a: a[0], init[s]) for s in init}
    jeng = jseqs.make_engine(JFederatedConfig(**kw), jaspec, jtmpl, joracle,
                             block=BLOCK,
                             compression=JCompressionSpec(**csp))
    teng = seqs.make_engine(FederatedConfig(**kw), aspec,
                            {s: {k: torch.from_numpy(a[0])
                                 for k, a in init[s].items()} for s in init},
                            toracle, block=BLOCK,
                            compression=CompressionSpec(**csp))
    jstate = jeng.init_state(jax.tree.map(jnp.asarray, init))
    tstate = teng.init_state({s: {k: torch.from_numpy(a)
                                  for k, a in init[s].items()} for s in init})
    assert len(tstate.ef) == 2 and len(tstate.ef[0]) == len(tstate.vars)
    jstep = jax.jit(jeng.step)
    tqp.reset_counts()
    for t in range(STEPS):
        jstate = jstep(jstate, jnp.int32(t))
        tstate = teng.step(tstate, t)
    assert tstate.step == int(jstate.step) == STEPS
    n_mom = 1 if aspec.has_momentum else 0
    assert tqp.CALLS == dict.fromkeys(tqp.CALLS, 2 * (1 + n_mom))
    assert len(jstate.ef[1]) == len(tstate.ef[1]) == n_mom
    pairs = [(jstate.vars, tstate.vars), (jstate.mom, tstate.mom),
             (jstate.ef[0], tstate.ef[0]), (jstate.ef[1], tstate.ef[1])]
    for js, ts in pairs:
        assert len(js) == len(ts)
        for j, t in zip(js, ts):
            np.testing.assert_array_equal(bits(t), bits(j))
    assert any(torch.count_nonzero(e) for e in tstate.ef[0])


def test_storm_engine_at_real_rates_within_flip_rules(monkeypatch,
                                                     tpu_reference):
    """The storm kind at its real rates (the default lr, c and α schedule:
    lr_x·α_0 = 0.025, decay 0.75 at t = 0), int8 + top-k 10 % + feedback,
    M = 8, 4 steps (two rounds), both engines fed the gradient table of
    :func:`test_engine_matches_reference_bitwise`.  The reference's
    compiled update contracts its products into FMAs and the port's
    kernels round each one, so the compressed inputs differ in their last
    bits, and top-k and int8 rounding may decide an entry differently.
    Every such flip is bounded by the rules of :func:`topk_flips` and
    :func:`int8_flips`; a flip reaches its column in every client (through
    the mean) and, in the next round, the whole column again, so the
    variables, momenta and error feedback are held at 1e-4 of their norm
    off the columns flipped in any round."""
    init, table = _engine_case("fedbioacc")
    kw = dict(num_clients=EM, local_steps=2)
    csp = dict(quant="int8", topk_frac=0.1)
    jtab = jax.tree.map(jnp.asarray, table)
    jcalls, tcalls = [], []

    def jrecord(x, block, frac):
        y = orig_j(x, block, frac)
        jax.debug.callback(lambda a, b: jcalls.append(
            (np.asarray(a, np.float32), np.asarray(b, np.float32))), x, y)
        return y

    orig_j = jflat._topk_tiles
    monkeypatch.setattr(jflat, "_topk_tiles", jrecord)
    monkeypatch.setattr(tflat, "_topk_tiles", _record(tcalls,
                                                      tflat._topk_tiles))

    def joracle(views, t):
        return {s: jax.tree.map(lambda g, v: g[t] + v.astype(jnp.float32) / 2,
                                jtab[s], views[s]) for s in views}

    def toracle(views, t):
        return {s: {k: torch.from_numpy(table[s][k][t]) + v.float() / 2
                    for k, v in views[s].items()} for s in views}

    jeng = jseqs.make_engine(
        JFederatedConfig(**kw), jseqs.SPECS["fedbioacc"],
        {s: jax.tree.map(lambda a: a[0], init[s]) for s in init}, joracle,
        block=BLOCK, compression=JCompressionSpec(**csp))
    teng = seqs.make_engine(
        FederatedConfig(**kw), seqs.SPECS["fedbioacc"],
        {s: {k: torch.from_numpy(a[0]) for k, a in init[s].items()}
         for s in init}, toracle, block=BLOCK,
        compression=CompressionSpec(**csp))
    jstate = jeng.init_state(jax.tree.map(jnp.asarray, init))
    tstate = teng.init_state({s: {k: torch.from_numpy(a)
                                  for k, a in init[s].items()} for s in init})
    jstep = jax.jit(jeng.step)
    for t in range(STEPS):
        jstate = jstep(jstate, jnp.int32(t))
        tstate = teng.step(tstate, t)
    jax.effects_barrier()
    assert len(tcalls) == len(jcalls) == 2 * len(tstate.vars) * STEPS // 2
    cols = np.zeros(tcalls[0][0].shape[1], bool)
    for (t_in, t_out), (j_in, j_out) in zip(tcalls, _paired(tcalls, jcalls)):
        flips = (topk_flips(t_in, t_out, j_in, j_out, BLOCK, 0.1)
                 | int8_flips(t_out, j_out, BLOCK))
        cols |= flips.any(axis=0)
    assert cols.mean() < 0.05       # the flips are a few columns
    mask = np.broadcast_to(cols, (EM, cols.size))
    for side in ("vars", "mom"):
        for t, j in zip(getattr(tstate, side), getattr(jstate, side)):
            _assert_close_outside(f32(t), np.asarray(j, np.float32), mask)
    for tside, jside in zip(tstate.ef, jstate.ef):
        for t, j in zip(tside, jside):
            _assert_close_outside(f32(t), np.asarray(j, np.float32), mask)


# ---------------------------------------------------------------------------
# the committed spec
# ---------------------------------------------------------------------------

def _record(calls: list, fn):
    """Wrap a ``_topk_tiles`` so that each call also records its input and
    output as f32 numpy arrays."""
    def wrapped(x, block, frac):
        y = fn(x, block, frac)
        calls.append((np.array(x, np.float32), np.array(y, np.float32)))
        return y
    return wrapped


def test_committed_spec_two_steps_match_reference(monkeypatch,
                                                  tpu_reference):
    """Two steps (one round) of ``fedbioacc_int8_topk.json`` from the
    reference's initial state and batches.  The oracles differ in their
    last bits between the two sides, and top-k is discontinuous: an entry
    near its tile's threshold may be kept on one side and dropped on the
    other.  Each such flip must sit within ``2·D`` of the threshold, D being
    the largest difference of the compressed inputs in its tile
    (:func:`repro_torch.testing.topk_flips`).  The int8 rounding is discontinuous
    in the same way: an entry kept on both sides may round to neighbouring
    values, and must then lie within the two sides' difference of a
    half-way point (:func:`repro_torch.testing.int8_flips`).  Everything a flip
    does not reach is held at 1e-4 of its buffer's norm, as the
    uncompressed paths are: the variables and momenta off the flipped
    columns (a send reaches every client's mean), the error feedback off
    the flipped entries (a client's residual is its own).  A handful of
    rounding flips alone move the momenta past 1e-4 of their norm, which is
    why they are excluded as well."""
    jcalls, tcalls = [], []

    def jrecord(x, block, frac):
        y = orig_j(x, block, frac)
        jax.debug.callback(lambda a, b: jcalls.append(
            (np.asarray(a, np.float32), np.asarray(b, np.float32))), x, y)
        return y

    orig_j = jflat._topk_tiles
    monkeypatch.setattr(jflat, "_topk_tiles", jrecord)
    monkeypatch.setattr(tflat, "_topk_tiles", _record(tcalls,
                                                      tflat._topk_tiles))
    jrun = jbuild(JExperiment.load(str(SPEC)))
    key = jax.random.PRNGKey(jrun.spec.schedule.seed)
    jstate = jrun.init(key)
    run = build(Experiment.load(str(SPEC)), device="cpu")
    assert [g.padded for g in run.init.spec.groups] == \
           [g.padded for g in jrun.step.spec.groups]
    state = seqs.FlatState(tuple(to_torch(list(jstate.vars))),
                           tuple(to_torch(list(jstate.mom))), 0,
                           tuple(tuple(to_torch(list(e))) for e in jstate.ef))
    jstep = jax.jit(jrun.step)
    tqp.reset_counts()
    for _ in range(2):
        key, sub = jax.random.split(key)
        batch = jrun.batch_fn(sub)
        jstate, _ = jstep(jstate, batch)
        state, _ = run.step(state, to_torch(batch))
    jax.effects_barrier()
    assert state.step == int(jstate.step) == 2
    # one round, one buffer: the variables and the momenta, once each
    assert tqp.CALLS == {"quantpack": 2, "quantunpack": 2}
    assert len(tcalls) == len(jcalls) == 2
    block = run.init.spec.groups[0].block
    frac = run.spec.compression.topk_frac
    for (t_in, t_out), j, (tb, jb), (te, je) in zip(
            tcalls, _paired(tcalls, jcalls),
            ((state.vars, jstate.vars), (state.mom, jstate.mom)),
            ((state.ef[0], jstate.ef[0]), (state.ef[1], jstate.ef[1]))):
        flips = (topk_flips(t_in, t_out, j[0], j[1], block, frac)
                 | int8_flips(t_out, j[1], block))
        cols = flips.any(axis=0)
        for t, jj in zip(tb, jb):
            _assert_close_outside(f32(t), np.asarray(jj, np.float32),
                                  np.broadcast_to(cols, flips.shape))
        for t, jj in zip(te, je):
            _assert_close_outside(f32(t), np.asarray(jj, np.float32), flips)


def _paired(tcalls, jcalls):
    """The reference's records in the port's order (callbacks under ``jit``
    are unordered): each port input with the closest reference input."""
    return [min(jcalls, key=lambda j: float(np.abs(j[0] - t[0]).max()))
            for t in tcalls]


def _assert_close_outside(t, j, mask):
    keep = ~mask
    assert np.linalg.norm(t[keep] - j[keep]) <= 1e-4 * np.linalg.norm(j[keep])


# ---------------------------------------------------------------------------
# rejections and the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("csp,cfg_kw,match", [
    (CompressionSpec(), {}, "no compressor"),
    (CompressionSpec(quant="fp4"), {}, "unknown"),
    (CompressionSpec(quant="int8", topk_frac=1.5), {}, "0, 1"),
    (CompressionSpec(quant="int8", sections=("zz",)), {}, "unknown"),
    (CompressionSpec(quant="int8", topk_frac=0.1), {"hierarchy_period": 2},
     "hierarch"),
    (CompressionSpec(quant="int8", sections=("y",)), {}, "private"),
])
def test_make_engine_rejects_inconsistent_compression(csp, cfg_kw, match):
    name = "fedbio_local" if match == "private" else "fedbioacc"
    tmpl = {s: {"w": torch.zeros(4)} for s in seqs.SPECS[name].sections}
    with pytest.raises(ValueError, match=match):
        seqs.make_engine(FederatedConfig(**cfg_kw), seqs.SPECS[name], tmpl,
                         None, block=8, compression=csp)


@pytest.mark.parametrize("edits,match", [
    ({"execution.fuse_storm": False, "compression.quant": "int8"},
     "fuse_storm"),
    ({"compression.quant": "fp4"}, "unknown quant"),
    ({"compression.topk_frac": 1.5}, "not in"),
    ({"compression.error_feedback": False}, "no compressor"),
    ({"compression.topk_frac": 0.1, "schedule.hierarchy_period": 2},
     "hierarch"),
    ({"compression.quant": "int8", "compression.sections": ["zz"]},
     "not sections"),
    ({"compression.quant": "int8", "compression.sections": []},
     "compresses nothing"),
    ({"compression.quant": "int8", "faults.nan_rate": 0.1}, "faults"),
    ({"algorithm.name": "fedbio_local", "compression.quant": "int8",
      "compression.sections": ["y"]}, "PRIVATE"),
])
def test_experiment_spec_rejections(edits, match):
    base = Experiment().edit(**{"execution.fuse_storm": True,
                                "schedule.steps": 2})
    good = base.edit(**{"compression.quant": "int8",
                        "compression.topk_frac": 0.1,
                        "compression.sections": ["x"]})
    assert good.validate().compression.sections == ("x",)
    with pytest.raises(SpecError, match=match):
        base.edit(**edits).validate()


def test_train_cli_runs_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--experiment",
         str(SPEC), "--device", "cpu", "--steps", "2", "--log-every", "1"],
        capture_output=True, text=True, timeout=240, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr
    lines = [json.loads(ln) for ln in out.stdout.splitlines()
             if ln.startswith("{")]
    assert [ln["step"] for ln in lines] == [1, 2]
    assert all(math.isfinite(ln["val_loss"]) for ln in lines)
