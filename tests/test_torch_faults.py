"""The fault engine in the port against the JAX package
(``repro.federation.faults``, the guarded half of ``repro.optim.flat`` and
the fault half of ``repro.optim.sequences``), on the CPU; restates
``tests/test_fault_tolerance.py``'s fault, reduction, engine and guard
tests on the port.

* Masks: ``round_masks`` bit for bit the reference's for rounds 0-63 ×
  retries 0-3 with the committed spec's seed, and the reference's
  determinism, re-draw, exclusivity and validation claims.
* Reductions: every guarded-reduction case of the reference's tests, in
  f32 and bf16, port against the jitted reference on the same numpy rows.
  Before a health verdict is held equal to the reference's, its margin is
  asserted: every finite participant's ``|n − mu|`` lies farther than
  ``MARGIN`` (relative) from ``tol``.  The ``mean`` aggregator is bit for
  bit the reference's; ``clip`` and ``trim`` within ``RTOL`` (their norms
  and order statistics are summed in other orders).
* The guard: the reference's unit semantics with a ``torch.Generator`` as
  the batch stream, and an in-place restore.
* The engine: the reference's model-scale claims on the port (guards-off
  bit identity, the divergence claim, budget exhaustion); and the reduced
  ``experiments/fedbioacc_faulty.json`` (8 clients, four steps) against
  the reference from its initial state and batches: masks bitwise,
  verdicts equal with margins, each guarded reduction of the port on the
  reference's inputs within ``RTOL`` of the reference's output, the
  variables within ``SPEC_TOL`` after every step.  The momenta are within
  ``SPEC_TOL`` until round 1's aggregate (two ×25 rows clipped, not
  screened: the validation loss goes from ~7 to ~21) puts the oracles in a
  saturated region where a 1e-7 relative change of the variables moves the
  momenta by several per cent: a buffer whose step responds to such a
  change (the reference's, measured) by more than ``ILL_CONDITIONED`` is
  not compared end to end, and the test asserts that only the last
  step's momenta are.  Two smaller runs compose faults with the uniform
  sampler and with stragglers.
* Checkpoints: a faulty ``FlatState`` with its ``retry`` leaf read by each
  package from the other's files.
"""
import dataclasses
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
from repro.federation import faults as jf  # noqa: E402
from repro.optim import flat as jflat  # noqa: E402
from repro_torch.api import Experiment, build  # noqa: E402
from repro_torch.checkpoint import (load_checkpoint,  # noqa: E402
                                    save_checkpoint)
from repro_torch.federation import faults as tf  # noqa: E402
from repro_torch.optim import flat  # noqa: E402
from repro_torch.optim import sequences as seqs  # noqa: E402
from torch_parity import bits, f32, to_torch  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAULTY = os.path.join(ROOT, "experiments", "fedbioacc_faulty.json")
MARGIN = 1e-3
RTOL = {jnp.float32: 1e-5, jnp.bfloat16: 2.0 ** -7}
SPEC_TOL = 1e-4
ILL_CONDITIONED = 1e-3
DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


# ---------------------------------------------------------------------------
# fault draws
# ---------------------------------------------------------------------------

def _committed_faults():
    return tf.FaultSpec(**json.load(open(FAULTY))["faults"])


@pytest.mark.parametrize("dropout", [0.0, 0.3])
def test_fault_masks_bitwise_reference(dropout):
    """The committed spec's process (and the same with dropout, so that
    ``keep`` varies) over rounds 0-63 × retries 0-3."""
    spec = _committed_faults()._replace(dropout_rate=dropout)
    port = tf.make_faults(spec, 8)
    ref = jf.make_faults(jf.FaultSpec(**spec._asdict()), 8)
    jm = jax.jit(ref.round_masks)
    seen = np.zeros(3)
    for r in range(64):
        for retry in range(4):
            want = jm(jnp.int32(r), jnp.int32(retry))
            got = port.round_masks(r, retry)
            for g, w in zip(got, want):
                assert g.dtype == torch.float32 and g.shape == (8,)
                np.testing.assert_array_equal(bits(g), bits(w))
            seen += [float((1 - got[0]).sum()), float(got[1].sum()),
                     float(got[2].sum())]
    # every kind of fault the spec has is drawn somewhere
    assert (seen > 0).tolist() == [dropout > 0, True, True]


def _masks(f, r, retry=0):
    return tuple(m.numpy() for m in f.round_masks(r, retry))


def test_fault_masks_deterministic_and_resumable():
    spec = tf.FaultSpec(dropout_rate=0.3, nan_rate=0.3, byzantine_rate=0.3,
                        seed=5)
    f1, f2 = tf.make_faults(spec, 8), tf.make_faults(spec, 8)
    seq1 = [_masks(f1, r) for r in range(10)]
    for r in (0, 4, 9):                       # f2 jumps straight to round r
        for a, b in zip(seq1[r], _masks(f2, r)):
            np.testing.assert_array_equal(a, b)
    f3 = tf.make_faults(spec._replace(seed=6), 8)
    assert any(not np.array_equal(a, b)
               for r in range(10) for a, b in zip(seq1[r], _masks(f3, r)))


def test_fault_masks_retry_redraws():
    f = tf.make_faults(tf.FaultSpec(nan_rate=0.5, seed=0), 16)
    base = _masks(f, 2, retry=0)
    for a, b in zip(base, _masks(f, 2, retry=0)):
        np.testing.assert_array_equal(a, b)
    assert any(not np.array_equal(base[1], _masks(f, 2, retry=k)[1])
               for k in (1, 2))


def test_fault_mask_exclusivity_and_start_round():
    spec = tf.FaultSpec(dropout_rate=0.5, nan_rate=0.9, byzantine_rate=0.9,
                        seed=1, start_round=3)
    f = tf.make_faults(spec, 32)
    for r in range(3):
        keep, nan, byz = _masks(f, r)
        np.testing.assert_array_equal(keep, np.ones(32))
        assert nan.sum() == 0 and byz.sum() == 0
    keep, nan, byz = _masks(f, 5)
    assert (1 - keep).sum() > 0 and nan.sum() > 0 and byz.sum() > 0
    assert np.all(nan * (1 - keep) == 0)      # dropped ⇒ sends nothing
    assert np.all(byz * (1 - keep) == 0)
    assert np.all(byz * nan == 0)             # NaN rows aren't also scaled


def test_fault_spec_validation_and_names():
    with pytest.raises(ValueError, match="nan_rate"):
        tf.make_faults(tf.FaultSpec(nan_rate=1.5), 4)
    with pytest.raises(ValueError, match="dropout_rate"):
        tf.make_faults(tf.FaultSpec(dropout_rate=-0.1), 4)
    assert tf.make_faults(None, 4) is None
    assert tf.AGGREGATORS == jf.AGGREGATORS
    assert tf.FaultSpec()._asdict() == jf.FaultSpec()._asdict()
    assert tf.RobustnessSpec()._asdict() == jf.RobustnessSpec()._asdict()
    assert flat.RobustCfg()._asdict() == jflat.RobustCfg()._asdict()


# ---------------------------------------------------------------------------
# guarded reductions on the flat substrate
# ---------------------------------------------------------------------------

def _flat_setup(M=4, dtype=jnp.float32):
    """The reference test's buffers and spec, and the port's spec."""
    tree = {"x": jnp.zeros((6,), dtype), "y": jnp.zeros((3,), dtype)}
    spec = jflat.make_spec(jax.tree.map(
        lambda v: jax.ShapeDtypeStruct(v.shape, v.dtype), tree),
        sections=("x", "y"), block=8)
    key = jax.random.PRNGKey(0)
    btree = {s: jax.random.normal(jax.random.fold_in(key, i),
                                  (M,) + tree[s].shape).astype(dtype)
             for i, s in enumerate(tree)}
    tdt = DTYPES[dtype]
    tspec = flat.make_spec({"x": torch.zeros(6, dtype=tdt),
                            "y": torch.zeros(3, dtype=tdt)},
                           sections=("x", "y"), block=8)
    return spec, jflat.flatten_tree(spec, btree, batch_dims=1), tspec


def _no_fault(M):
    return (np.zeros(M, np.float32), np.zeros(M, np.float32), 10.0)


def _assert_margins(seg, w, corrupt, robust):
    """The port's screen statistics of one run: every finite participant's
    distance to the threshold exceeds ``MARGIN`` of it."""
    p = torch.ones(seg.shape[0], dtype=torch.bool) if w is None else w > 0
    finite, sq = flat._row_stats(seg, w, corrupt)
    hf, stats = flat._health_stats(finite, sq, p, robust)
    if stats is not None:
        n, mu, tol = stats
        for i in range(len(n)):
            if p[i] and finite[i]:
                gap = abs(float((n[i] - mu).abs() - tol))
                assert gap > MARGIN * float(tol), (i, n, mu, tol)
    return hf


def _run_both(spec, jbufs, tspec, modes, *, w=None, corrupt=None,
              robust=None):
    """(reference outputs, port outputs, port verdicts, reference
    verdicts) of one guarded ``client_mean_masked`` on the same rows; the
    port's verdicts are asserted to have their margins first."""
    rc = None if robust is None else jflat.RobustCfg(**robust._asdict())
    jw = None if w is None else jnp.asarray(w)
    jc = None if corrupt is None else (jnp.asarray(corrupt[0]),
                                       jnp.asarray(corrupt[1]), corrupt[2])
    want = jax.jit(lambda b, ww, c: jflat.client_mean_masked(
        spec, b, modes, weights=ww, corrupt=c, robust=rc))(jbufs, jw, jc)
    tw = None if w is None else torch.as_tensor(w)
    tc = None if corrupt is None else (torch.as_tensor(corrupt[0]),
                                       torch.as_tensor(corrupt[1]),
                                       corrupt[2])
    tbufs = tuple(to_torch(list(jbufs)))
    verdicts, jverdicts = [], []
    if robust is not None and robust.screen:
        for grp, jb, tb in zip(tspec.groups, jbufs, tbufs):
            for mode, a, b, *_ in flat._section_runs(grp, modes):
                if mode != "mean":
                    continue
                _assert_margins(tb[:, a:b], tw, tc, robust)
                x = jflat._corrupt_rows(jb[:, a:b], jc)
                if jw is not None:
                    x = jnp.where((jw > 0)[:, None], x, jb[:, a:b])
                p = jnp.ones(x.shape[0], bool) if jw is None else jw > 0
                jverdicts.append(np.asarray(jflat._health_mask(x, p, rc)))
    got = flat.client_mean_masked(tspec, tbufs, modes, weights=tw,
                                  corrupt=tc, robust=robust,
                                  verdicts=verdicts)
    for v, jv in zip(verdicts, jverdicts):
        np.testing.assert_array_equal(v.numpy(), jv)
    assert len(verdicts) == len(jverdicts)
    return want, got, verdicts


def _close(got, want, dtype, exact=False):
    if exact:
        np.testing.assert_array_equal(bits(got), bits(want))
    else:
        np.testing.assert_allclose(f32(got), np.asarray(want, np.float32),
                                   rtol=RTOL[dtype], atol=1e-6,
                                   equal_nan=True)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
def test_all_healthy_robust_mean_bitwise_identical(dtype):
    """Zero fault masks and the "mean" aggregator: the guarded reduction
    is the unguarded client mean bit for bit, on the port as on the
    reference, and equal to the reference's."""
    spec, jb, tspec = _flat_setup(4, dtype)
    plain = flat.client_mean_masked(tspec, tuple(to_torch(list(jb))),
                                    ("mean", "mean"))
    want, guard, v = _run_both(spec, jb, tspec, ("mean", "mean"),
                               corrupt=_no_fault(4),
                               robust=flat.RobustCfg("mean", z_thresh=3.0))
    _, unguard, _ = _run_both(spec, jb, tspec, ("mean", "mean"),
                              corrupt=_no_fault(4))
    assert [x.tolist() for x in v] == [[1.0] * 4]
    for a, b, c, r in zip(plain, guard, unguard, want):
        _close(b, a, dtype, exact=True)
        _close(c, a, dtype, exact=True)
        _close(b, r, dtype, exact=True)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
def test_nan_sender_screened_and_recovered(dtype):
    spec, jb, tspec = _flat_setup(4, dtype)
    nan = np.array([0.0, 1.0, 0.0, 0.0], np.float32)
    corrupt = (nan, np.zeros(4, np.float32), 10.0)
    want, out, v = _run_both(spec, jb, tspec, ("mean", "none"),
                             corrupt=corrupt, robust=flat.RobustCfg("mean"))
    assert v[0].tolist() == [1.0, 0.0, 1.0, 1.0]
    _close(out[0], want[0], dtype, exact=True)
    x = f32(to_torch(list(jb))[0])
    healthy = (x[0, :8] + x[2, :8] + x[3, :8]) / 3.0
    for m in range(4):                        # all rows get the healthy mean
        np.testing.assert_allclose(f32(out[0][m, :8]), healthy,
                                   rtol=RTOL[dtype], atol=1e-2
                                   if dtype == jnp.bfloat16 else 1e-6)
    np.testing.assert_array_equal(bits(out[0][:, 8:]),
                                  bits(jb[0][:, 8:]))   # private untouched
    bad_want, bad, _ = _run_both(spec, jb, tspec, ("mean", "none"),
                                 corrupt=corrupt)
    assert not bool(torch.isfinite(bad[0][:, :8].float()).all())
    _close(bad[0], bad_want[0], dtype)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
def test_byzantine_sender_z_screened(dtype):
    spec, jb, tspec = _flat_setup(8, dtype)
    byz = np.zeros(8, np.float32)
    byz[3] = 1.0
    want, out, v = _run_both(spec, jb, tspec, ("mean", "none"),
                             corrupt=(np.zeros(8, np.float32), byz, 1e4),
                             robust=flat.RobustCfg("mean", z_thresh=2.0))
    assert v[0][3] == 0.0 and float(v[0].sum()) == 7.0
    _close(out[0], want[0], dtype, exact=True)
    assert float(out[0].float().abs().max()) < 100.0


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
def test_clip_bounds_byzantine_pull(dtype):
    spec, jb, tspec = _flat_setup(8, dtype)
    byz = np.zeros(8, np.float32)
    byz[1] = 1.0
    corrupt = (np.zeros(8, np.float32), byz, 1e4)
    _, unclipped, _ = _run_both(spec, jb, tspec, ("mean", "none"),
                                corrupt=corrupt)
    rob = flat.RobustCfg(aggregator="clip", screen=False, clip_factor=2.0)
    want, clipped, _ = _run_both(spec, jb, tspec, ("mean", "none"),
                                 corrupt=corrupt, robust=rob)
    _close(clipped[0], want[0], dtype)
    assert (float(clipped[0][:, :8].float().abs().max())
            < 0.6 * float(unclipped[0][:, :8].float().abs().max()))
    want, screened, v = _run_both(
        spec, jb, tspec, ("mean", "none"), corrupt=corrupt,
        robust=rob._replace(screen=True, z_thresh=2.0))
    assert v[0][1] == 0.0
    _close(screened[0], want[0], dtype)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
def test_trimmed_mean_drops_outlier_coordinates(dtype):
    M = 5
    spec, jb, tspec = _flat_setup(M, dtype)
    byz = np.zeros(M, np.float32)
    byz[2] = 1.0
    rob = flat.RobustCfg(aggregator="trim", screen=False, trim_frac=0.2)
    want, out, _ = _run_both(spec, jb, tspec, ("mean", "none"),
                             corrupt=(np.zeros(M, np.float32), byz, 1e4),
                             robust=rob)
    _close(out[0], want[0], dtype)
    assert float(out[0][:, :8].float().abs().max()) < 100.0
    plain = flat.client_mean_masked(tspec, tuple(to_torch(list(jb))),
                                    ("mean", "none"))
    want, out2, _ = _run_both(spec, jb, tspec, ("mean", "none"),
                              corrupt=_no_fault(M), robust=rob)
    _close(out2[0], want[0], dtype)
    assert (float((out2[0].float() - plain[0].float()).abs().max())
            < float(plain[0].float().abs().max()))


@pytest.mark.parametrize("agg", ["mean", "clip", "trim"])
def test_all_unhealthy_round_passes_through(agg):
    spec, jb, tspec = _flat_setup(4)
    corrupt = (np.ones(4, np.float32), np.zeros(4, np.float32), 10.0)
    want, out, v = _run_both(spec, jb, tspec, ("mean", "mean"),
                             corrupt=corrupt, robust=flat.RobustCfg(agg))
    assert v[0].tolist() == [0.0] * 4
    for a, b, r in zip(out, jb, want):
        np.testing.assert_array_equal(bits(a), bits(b))
        np.testing.assert_array_equal(bits(a), bits(r))


@pytest.mark.parametrize("agg", [None, "mean", "clip", "trim"])
def test_nonparticipants_never_touched_by_faults(agg):
    spec, jb, tspec = _flat_setup(4)
    w = np.array([1.0, 0.0, 1.0, 1.0], np.float32)
    nan = np.array([0.0, 1.0, 0.0, 0.0], np.float32)   # the absent client
    rob = None if agg is None else flat.RobustCfg(agg)
    want, out, _ = _run_both(spec, jb, tspec, ("mean", "none"), w=w,
                             corrupt=(nan, np.zeros(4, np.float32), 10.0),
                             robust=rob)
    assert bool(torch.isfinite(out[0]).all())
    np.testing.assert_array_equal(bits(out[0][1]), bits(jb[0][1]))
    _close(out[0], want[0], jnp.float32, exact=agg in (None, "mean"))


def test_guarded_rejects_grouped_means_and_compression():
    spec, jb, tspec = _flat_setup(4)
    bufs = tuple(to_torch(list(jb)))
    with pytest.raises(AssertionError):
        jflat.client_mean_masked(spec, jb, ("group", "none"), num_groups=2,
                                 corrupt=_no_fault(4),
                                 robust=jflat.RobustCfg())
    with pytest.raises(ValueError, match="grouped"):
        flat.client_mean_masked(tspec, bufs, ("group", "none"),
                                corrupt=_no_fault(4), robust=flat.RobustCfg())
    with pytest.raises(ValueError, match="compress"):
        flat.client_mean_masked(tspec, bufs, ("mean", "none"),
                                robust=flat.RobustCfg(),
                                compress=flat.CompressCfg(quant="bf16"))


# ---------------------------------------------------------------------------
# RollbackGuard unit semantics
# ---------------------------------------------------------------------------

class _Toy:
    def __init__(self, v, retry=torch.zeros((), dtype=torch.int32)):
        self.v, self.retry = v, retry

    def _replace(self, retry):
        return _Toy(self.v, retry)


def _draws(gen, n=4):
    return torch.randint(0, 1 << 30, (n,), generator=gen).tolist()


def test_rollback_guard_snapshot_and_rollback():
    g = tf.RollbackGuard(tf.RobustnessSpec(spike_factor=10.0, retry_budget=3,
                                           ring=2))
    gen = torch.Generator().manual_seed(0)
    assert g.observe(1, _Toy(1), gen, 5.0) is None
    _draws(gen)
    assert g.observe(2, _Toy(2), gen, 6.0) is None
    first = _draws(torch.Generator().manual_seed(0).set_state(
        gen.get_state()))                    # what step 3 drew the first time
    _draws(gen)
    step, state, key = g.observe(3, _Toy(3), gen, float("nan"))
    assert step == 2 and state.v == 2 and g.retries == 1
    assert int(state.retry) == 1              # fault re-draw keyed
    assert key is gen and _draws(gen) != first   # fresh batches
    # a spike (not just NaN) also rolls back; within-factor losses don't
    assert g.observe(3, _Toy(3), gen, 6.5) is None
    step, _, _ = g.observe(4, _Toy(4), gen, 100.0)
    assert step == 3 and g.retries == 2
    assert g.rollback_steps == [3, 4]

    class _Plain:
        retry = ()
    g2 = tf.RollbackGuard(tf.RobustnessSpec())
    g2.observe(1, _Plain(), gen, 1.0)
    _, s, _ = g2.observe(2, _Plain(), gen, float("inf"))
    assert s.retry == ()


def test_rollback_guard_failure_modes():
    g = tf.RollbackGuard(tf.RobustnessSpec(retry_budget=1))
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(tf.RollbackError, match="no .*good"):
        g.observe(1, _Toy(1), gen, float("nan"))
    g.observe(1, _Toy(1), gen, 1.0)
    g.observe(2, _Toy(1), gen, float("nan"))
    with pytest.raises(tf.RollbackError, match="retry budget"):
        g.observe(2, _Toy(1), gen, float("nan"))
    with pytest.raises(ValueError):
        tf.RollbackGuard(tf.RobustnessSpec(retry_budget=-1))


def test_rollback_restores_in_place_and_reseeds_alike():
    """A rollback copies the host snapshot into the live state's own
    tensors (same storage), sets ``retry`` and re-seeds the batch stream;
    two guards fed alike re-seed alike; the ring reuses its host
    tensors."""
    def state(v):
        return seqs.FlatState((torch.full((2, 8), v),), (), 3,
                              retry=torch.tensor(0, dtype=torch.int32))

    seeds = []
    for _ in range(2):
        g = tf.RollbackGuard(tf.RobustnessSpec(ring=2))
        gen = torch.Generator().manual_seed(11)
        assert g.observe(2, state(1.0), gen, 1.0) is None
        assert g.observe(4, state(2.0), gen, 1.0) is None
        held = g._good[0][1].vars[0]
        assert g.observe(6, state(3.0), gen, 1.0) is None   # evicts step 2
        assert g._good[-1][1].vars[0] is held   # its host tensor reused
        live = state(float("nan"))
        ptr = live.vars[0].data_ptr()
        step, back, _ = g.observe(8, live, gen, float("nan"))
        assert step == 6 and back.vars[0].data_ptr() == ptr
        np.testing.assert_array_equal(bits(back.vars[0]),
                                      bits(torch.full((2, 8), 3.0)))
        assert int(back.retry) == 1 and back.step == 3
        seeds.append(_draws(gen))
    assert seeds[0] == seeds[1]


# ---------------------------------------------------------------------------
# model scale: guards-off bit identity, divergence, budget exhaustion
# ---------------------------------------------------------------------------

def _small(**edits):
    """``fedbioacc.json`` cut to 4 clients, 16 tokens, tile 128, as the
    reference's model-scale fault tests cut theirs."""
    base = Experiment.load(os.path.join(ROOT, "experiments",
                                        "fedbioacc.json"))
    return base.edit(**{"problem.num_clients": 4, "problem.per_client": 1,
                        "problem.seq_len": 16, "schedule.steps": 4,
                        "schedule.local_steps": 2, "schedule.lr_x": 0.05,
                        "schedule.lr_y": 0.05, "schedule.lr_u": 0.05,
                        "execution.storm_block": 128, **edits})


def _run(exp, steps=2):
    run = build(exp, device="cpu")
    state = run.init(torch.Generator().manual_seed(0))
    data = torch.Generator().manual_seed(1)
    for _ in range(steps):
        state, _ = run.step(state, run.batch_fn(data))
    return state, run


def test_guards_off_bit_identity_and_divergence_claim():
    """One round (the reference's test runs four; round 0 already holds
    NaN senders 0 and 2 under seed 2)."""
    clean, crun = _run(_small())
    for edits in ({"faults.nan_rate": 0.0},
                  {"robustness.aggregator": "mean"},
                  {"faults.nan_rate": 0.0, "robustness.aggregator": "mean"}):
        got, _ = _run(_small(**edits))
        for a, b in zip(clean.vars + clean.mom, got.vars + got.mom):
            np.testing.assert_array_equal(bits(a), bits(b))
    bad, _ = _run(_small(**{"faults.nan_rate": 0.4, "faults.seed": 2}))
    assert not all(bool(torch.isfinite(b).all()) for b in bad.vars), \
        "unguarded NaN injection must poison the trajectory"
    good, grun = _run(_small(**{"faults.nan_rate": 0.4, "faults.seed": 2,
                                "robustness.aggregator": "clip"}))
    assert all(bool(torch.isfinite(b).all()) for b in good.vars)
    l_clean, l_good = crun.eval_fn(clean), grun.eval_fn(good)
    assert np.isfinite(l_good) and l_good <= 2.0 * l_clean, (l_good, l_clean)


def test_faults_require_fused_engine_and_flat_averaging():
    from repro_torch.federation.trainer import make_fedbioacc_train_step
    run = build(_small(), device="cpu")
    with pytest.raises(ValueError, match="fuse_storm"):
        make_fedbioacc_train_step(run.model, run.fed,
                                  faults=tf.FaultSpec(nan_rate=0.1))
    with pytest.raises(ValueError, match="hierarch"):
        make_fedbioacc_train_step(
            run.model, dataclasses.replace(run.fed, hierarchy_period=2),
            fuse_storm=True, storm_block=128,
            robustness=tf.RobustnessSpec(aggregator="clip"))


def test_rollback_guard_exhausts_budget_on_persistent_faults():
    """nan_rate 1.0 from round 1, screen off: the guard snapshots the clean
    round, rolls back on the NaN loss (bumping ``retry`` so the masks
    re-draw) and raises once the budget is spent."""
    run = build(_small(**{"schedule.steps": 8, "faults.nan_rate": 1.0,
                          "faults.start_round": 1,
                          "robustness.aggregator": "mean",
                          "robustness.screen": False,
                          "robustness.retry_budget": 2}), device="cpu")
    guard = tf.RollbackGuard(run.spec.robustness)
    state = run.init(torch.Generator().manual_seed(0))
    data = torch.Generator().manual_seed(1)
    t = 0
    with pytest.raises(tf.RollbackError, match="retry budget"):
        while t < 8:
            state, _ = run.step(state, run.batch_fn(data))
            t += 1
            rb = guard.observe(t, state, data, run.eval_fn(state))
            if rb is not None:
                t, state, data = rb
    assert guard.retries == 2 and guard.rollback_steps == [4, 4]
    assert int(state.retry) >= 1              # fault draws were re-keyed


# ---------------------------------------------------------------------------
# the reduced faulty spec against the reference
# ---------------------------------------------------------------------------

def _reference_health(calls: list):
    """Patch the reference's ``_health_mask`` and ``_robust_bcast_mean`` to
    record, in order, each verdict and each guarded reduction's (input,
    output) through ordered debug callbacks."""
    orig_h, orig_r = jflat._health_mask, jflat._robust_bcast_mean

    def health(x, p, robust):
        h = orig_h(x, p, robust)
        jax.debug.callback(lambda v: calls.append(("h", np.asarray(v))), h,
                           ordered=True)
        return h

    def reduce(x0, w, corrupt, robust):
        out = orig_r(x0, w, corrupt, robust)
        jax.debug.callback(
            lambda a, b: calls.append(("r", np.asarray(a), np.asarray(b))),
            x0, out, ordered=True)
        return out
    return (("_health_mask", health, orig_h),
            ("_robust_bcast_mean", reduce, orig_r))


def _spread(jrun, jstate, batch):
    """The reference's own relative response of each buffer of one step to
    a 1e-7 relative change of the entering variables."""
    jstep = jax.jit(jrun.step)
    a, _ = jstep(jstate, batch)
    b, _ = jstep(jstate._replace(vars=tuple(v * (1 + 1e-7)
                                            for v in jstate.vars)), batch)
    return [float(np.linalg.norm(np.asarray(x, np.float32)
                                 - np.asarray(y, np.float32))
                  / np.linalg.norm(np.asarray(x, np.float32)))
            for x, y in zip(a.vars + a.mom, b.vars + b.mom)]


def _parity(exp_json: dict, steps: int, monkeypatch):
    """Run ``steps`` steps of the spec on both packages from the
    reference's initial state and batches; check masks, verdicts, each
    guarded reduction and the buffers.  Returns the port's decision
    records (``metrics["decision"]``)."""
    jexp, exp = JExperiment.from_json(json.dumps(exp_json)), \
        Experiment.from_json(json.dumps(exp_json))
    calls = []
    for name, new, _ in _reference_health(calls):
        monkeypatch.setattr(jflat, name, new)
    jrun = jbuild(jexp)
    run = build(exp, device="cpu")
    key = jax.random.PRNGKey(jrun.spec.schedule.seed)
    jstate = jrun.init(key)
    state = seqs.FlatState(
        tuple(to_torch(list(jstate.vars))), tuple(to_torch(list(jstate.mom))),
        0, stale=(() if isinstance(jstate.stale, tuple)
                  else torch.from_numpy(np.asarray(jstate.stale))),
        deadline=(() if isinstance(jstate.deadline, tuple)
                  else torch.tensor(float(jstate.deadline))),
        retry=torch.tensor(0, dtype=torch.int32))
    jfaults, robust = jrun.step.faults, exp.robustness
    rcfg = flat.RobustCfg(robust.aggregator, robust.screen, robust.z_thresh,
                          robust.clip_factor, robust.trim_frac)
    jstep = jax.jit(jrun.step)
    port_in = []
    orig = flat._robust_mean_into

    def record(seg, w, corrupt, rob, verdicts=None):
        port_in.append((w, corrupt))
        return orig(seg, w, corrupt, rob, verdicts)
    monkeypatch.setattr(flat, "_robust_mean_into", record)
    out = []
    for t in range(steps):
        key, sub = jax.random.split(key)
        batch = jrun.batch_fn(sub)
        r = t // run.fed.local_steps
        want = jfaults.round_masks(jnp.int32(r), jnp.int32(0))
        if t == steps - 1:
            spread = _spread(jrun, jstate, batch)
        n_calls = len(calls)
        jstate, _ = jstep(jstate, batch)
        jax.effects_barrier()
        state, metrics = run.step(state, to_torch(batch))
        out.append(metrics["decision"])
        for g, w in zip(metrics["decision"]["faults"], want):
            np.testing.assert_array_equal(bits(g), bits(w))
        jh = [c[1] for c in calls[n_calls:] if c[0] == "h"]
        jr = [c[1:] for c in calls[n_calls:] if c[0] == "r"]
        assert [v.tolist() for v in out[-1].get("health", [])] == \
            [v.tolist() for v in jh]
        # each guarded reduction of the port on the reference's input
        for (x0, y), (w, corrupt) in zip(jr, port_in[-len(jr):]
                                         if jr else []):
            seg = torch.from_numpy(x0.copy())
            if robust.screen:
                _assert_margins(seg, w, corrupt, rcfg)
            orig(seg, w, corrupt, rcfg)
            np.testing.assert_allclose(seg.numpy(), y, rtol=RTOL[jnp.float32],
                                       atol=1e-6, equal_nan=True)
        held = [True] * (len(state.vars) + len(state.mom))
        if t == steps - 1:
            held = [s <= ILL_CONDITIONED for s in spread]
            assert all(held[:len(state.vars)])
        for (j, p), h in zip(zip(jstate.vars + jstate.mom,
                                 state.vars + state.mom), held):
            j = np.asarray(j, np.float32)
            if h:
                assert np.linalg.norm(f32(p) - j) <= \
                    SPEC_TOL * np.linalg.norm(j), t
    assert int(state.retry) == int(jstate.retry) == 0
    return out, spread


def test_reduced_faulty_spec_matches_reference(monkeypatch):
    exp = json.load(open(FAULTY))
    out, spread = _parity(exp, 4, monkeypatch)
    # round 1 (steps 3-4): clients 2, 5 send NaN and are screened; 4, 7
    # send ×25 rows the z-score keeps and clip bounds
    _, nan, byz = out[3]["faults"]
    assert nan.nonzero().flatten().tolist() == [2, 5]
    assert byz.nonzero().flatten().tolist() == [4, 7]
    assert out[3]["screened"] == [2, 5] and out[1]["screened"] == []
    # the last step's momenta are ill-conditioned (they alone are not held
    # end to end), its variables are not
    assert [s > ILL_CONDITIONED for s in spread] == [False, True]


@pytest.mark.parametrize("layer", ["uniform", "stragglers"])
def test_faults_compose_with_sampler_and_stragglers(layer, monkeypatch):
    """One round (two steps) of 4 clients with dropout and NaN sends from
    round 0, composed with the uniform sampler (3 of 4) or with the
    reduced straggler spec's process (its sampler cut to 2 of 4, which its
    over-provisioning takes to 4)."""
    exp = json.load(open(FAULTY))
    exp["problem"]["num_clients"] = 4
    exp["schedule"]["steps"] = 2
    exp["faults"].update(dropout_rate=0.25, nan_rate=0.3, byzantine_rate=0.0,
                         start_round=0, seed=16)
    if layer == "uniform":
        exp["participation"].update(sampler="uniform", clients_per_round=3)
    else:
        strag = json.load(open(os.path.join(ROOT, "experiments",
                                            "fedbioacc_straggler.json")))
        exp["stragglers"] = strag["stragglers"]
        exp["participation"] = dict(strag["participation"],
                                    clients_per_round=2)
    out, _ = _parity(exp, 2, monkeypatch)
    keep, nan, _ = out[0]["faults"]
    assert float(keep.sum()) < 4 and float(nan.sum()) > 0


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_faulty_state_checkpoints_read_both_ways(tmp_path):
    exp = json.load(open(FAULTY))
    run = build(Experiment.from_json(json.dumps(exp)), device="cpu")
    jrun = jbuild(JExperiment.from_json(json.dumps(exp)))
    state = run.init(torch.Generator().manual_seed(0))._replace(
        step=6, retry=torch.tensor(2, dtype=torch.int32))
    save_checkpoint(str(tmp_path / "p"), state, {"step": 6})
    like = jax.eval_shape(jrun.init, jax.random.PRNGKey(0))
    got = jload(str(tmp_path / "p"), like)
    assert int(got.retry) == 2 and got.retry.dtype == jnp.int32
    assert int(got.step) == 6
    for a, b in zip(got.vars + got.mom, state.vars + state.mom):
        np.testing.assert_array_equal(bits(a), bits(b))
    jstate = jrun.init(jax.random.PRNGKey(3))._replace(
        step=jnp.int32(4), retry=jnp.int32(1))
    jsave(str(tmp_path / "j"), jstate, {"step": 4})
    back = load_checkpoint(str(tmp_path / "j"), run.init(
        torch.Generator().manual_seed(0)))
    assert back.step == 4 and int(back.retry) == 1
    assert back.retry.dtype == torch.int32 and back.retry.shape == ()
    for a, b in zip(back.vars + back.mom, jstate.vars + jstate.mom):
        np.testing.assert_array_equal(bits(a), bits(b))
