"""Telemetry on the port (``repro_torch.telemetry``, the engine's in-band
metrics, the train CLI's event stream) against the reference's
(``repro.telemetry``).

- The reference's ``tests/test_telemetry.py``, restated on the port: the
  telemetry-off step is the telemetry-free step and turning metrics on
  leaves every trajectory bit for bit as it was (uint8 views, all five
  algorithms); step 1's STORM update norm is exactly 0; group resolution
  and its refusals; the event log's append, resume and tail repair; the
  validator's comm-bytes reconciliation, ``--expect`` and
  ``--trend-decreasing``; the spec's JSON round trip; a faulty run's
  ``rollback`` events through the port's CLI; the comm plan against the
  flat layout.
- Parity, function by function, on the same numpy-seeded buffers in f32
  and bf16: ``section_norms`` (with ``minus=``), ``section_drift``,
  ``quant_roundtrip_err`` and ``health_screen`` (each verdict's margin to
  the screen's threshold asserted first) within ``RTOL``;
  ``arrival_histogram`` bin for bin, each drawn time's margin to its bin
  edge asserted first (the draws agree within 8 ulps).
- Parity, engine level: the toy engines' in-band metrics over two rounds
  under each layer (plain, compressed, faulty, straggled) within
  ``RTOL`` of the reference's, counts and histograms equal.
- Parity, spec level: the reduced ``fedbioacc_telemetry.json`` through both
  CLIs in process, the port's run fed the reference's initial state and
  batches: the same ``(event, step, round, retry)`` sequence, ``comm``
  events equal, every ``metrics`` value within ``SPEC_TOL``; each stream
  passes the other package's validator.  The straggler spec's stream
  validates, its ``deadline`` events equal the engine's decision record.
- Resume: ``--crash-at-step 2`` then ``--resume`` leaves two segments that
  validate, the resumed ``comm`` events the uninterrupted run's.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.config import FederatedConfig as JConfig  # noqa: E402
from repro.federation import compression as jc  # noqa: E402
from repro.federation import faults as jf  # noqa: E402
from repro.federation import participation as jp  # noqa: E402
from repro.federation import stragglers as js  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.optim import flat as jflat  # noqa: E402
from repro.optim import sequences as jseqs  # noqa: E402
from repro.telemetry import TelemetrySpec as JTelemetrySpec  # noqa: E402
from repro.telemetry import validate_events as jvalidate  # noqa: E402
from repro_torch.api import Experiment  # noqa: E402
from repro_torch.config import FederatedConfig  # noqa: E402
from repro_torch.core.tree_util import client_slice, tree_map  # noqa: E402
from repro_torch.federation import compression as tc  # noqa: E402
from repro_torch.federation import faults as tf  # noqa: E402
from repro_torch.federation import participation as tp  # noqa: E402
from repro_torch.federation import stragglers as ts  # noqa: E402
from repro_torch.launch import metrics as tmetrics  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.optim import flat  # noqa: E402
from repro_torch.optim import sequences as seqs  # noqa: E402
from repro_torch.telemetry import (EventLog, TelemetrySpec,  # noqa: E402
                                   comm_plan, read_events,
                                   resolve_metric_groups, round_bytes,
                                   validate_events)
from repro_torch.telemetry.comm import compressed_chunk_elems  # noqa: E402
from repro_torch.telemetry.events import TelemetryError  # noqa: E402
from torch_parity import bits, to_torch  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TELEMETRY = os.path.join(ROOT, "experiments", "fedbioacc_telemetry.json")
STRAGGLER = os.path.join(ROOT, "experiments", "fedbioacc_straggler.json")
FAULTY = os.path.join(ROOT, "experiments", "fedbioacc_faulty.json")
ALGOS = ("fedbio", "fedbioacc", "fedbio_local", "fedbioacc_local", "fedavg")
M = 4
# metric values against the reference's on the same inputs: f32 sums in
# another order (the port sums squares in f64 per row, XLA in f32)
RTOL = 1e-5
# a drawn time's or a norm's distance to the edge that decides it, relative
MARGIN = 1e-4
# the CLIs' metrics: the port's and the reference's oracles differ in the
# last bits and those differences grow over the run's steps
SPEC_TOL = 1e-4

_SHAPES = {"x": {"w": (3, 5)}, "y": {"h": (7,)}, "u": {"v": (11,)},
           "params": {"w": (3, 5), "h": (7,)}}


def _cfg_kw(algo):
    return dict(algorithm=algo, num_clients=M, local_steps=2, lr_x=0.05,
                lr_y=0.05, lr_u=0.05, c_nu=1.0, c_omega=1.0, c_u=1.0,
                alpha_delta=1.0, alpha_u0=4.0, hierarchy_period=0,
                hierarchy_groups=2)


def _init_trees(aspec, m=M):
    rng = np.random.default_rng(0)
    return {s: {k: rng.standard_normal((m,) + shape).astype(np.float32)
                for k, shape in _SHAPES[s].items()}
            for s in aspec.sections}


def _make(algo, telemetry=None, m=M, **layers):
    """The port's toy engine (the reference test's: ``tanh(v) + 0.01·b``
    per leaf, 8-element tiles, 2 local steps) and its initial state."""
    cfg = FederatedConfig(**dict(_cfg_kw(algo), num_clients=m))
    aspec = seqs.SPECS[algo]
    tmpl = {s: {k: torch.empty(shape, device="meta")
                for k, shape in _SHAPES[s].items()} for s in aspec.sections}

    def oracle(v, b):
        col = lambda t: b.reshape((-1,) + (1,) * (t.dim() - 1))  # noqa: E731
        return {s: tree_map(lambda t: torch.tanh(t) + 0.01 * col(t), v[s])
                for s in v}

    eng = seqs.make_engine(cfg, aspec, tmpl, oracle, block=8,
                           telemetry=telemetry, **layers)
    vt = {s: {k: torch.from_numpy(a) for k, a in d.items()}
          for s, d in _init_trees(aspec, m).items()}
    return eng, eng.init_state(vt)


def _make_ref(algo, telemetry=None, m=M, **layers):
    """The reference's toy engine on the same initial state."""
    cfg = JConfig(**dict(_cfg_kw(algo), num_clients=m))
    aspec = jseqs.SPECS[algo]
    tmpl = {s: {k: jax.ShapeDtypeStruct(shape, jnp.float32)
                for k, shape in _SHAPES[s].items()} for s in aspec.sections}

    def one(v, b):
        return {s: jax.tree.map(lambda t: jnp.tanh(t) + 0.01 * b, v[s])
                for s in v}

    eng = jseqs.make_engine(cfg, aspec, tmpl, jax.vmap(one), block=8,
                            telemetry=telemetry, **layers)
    vt = jax.tree.map(jnp.asarray, _init_trees(aspec, m))
    return eng, eng.init_state(vt)


def _batches(steps, m=M):
    rng = np.random.default_rng(7)
    return [rng.standard_normal(m).astype(np.float32) for _ in range(steps)]


def _assert_bit_identical(sa, sb):
    for a, b in zip(sa.vars + sa.mom, sb.vars + sb.mom):
        np.testing.assert_array_equal(bits(a), bits(b))
    assert sa.step == sb.step


# ---------------------------------------------------------------------------
# the reference's tests, restated
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("algo", ALGOS)
def test_telemetry_off_on_bit_identity(algo):
    """Telemetry off computes no metric group (the step's dict stays
    empty), and turning metrics on leaves the trajectory bit for bit
    (uint8 view): the metrics are read off the step's buffers, never fed
    back."""
    eng_off, s_off = _make(algo)
    eng_on, s_on = _make(algo, telemetry=TelemetrySpec())
    assert eng_off.step.telemetry_groups == ()
    assert eng_on.step.telemetry_groups == ("norms", "drift")
    mets = None
    for b in _batches(4):
        off = {}
        s_off = eng_off.step(s_off, torch.from_numpy(b), off)
        assert off == {}
        mets = {}
        s_on = eng_on.step(s_on, torch.from_numpy(b), mets)
    _assert_bit_identical(s_off, s_on)
    aspec = seqs.SPECS[algo]
    sec = aspec.sections[0]
    keys = [f"upd_norm/{sec}", f"drift/{sec}"]
    if aspec.has_momentum:          # fedbio/fedbio_local carry no momentum
        keys.append(f"mom_norm/{sec}")
    for k in keys:
        assert k in mets and np.isfinite(float(mets[k])), (k, mets)


def test_storm_step1_update_norm_is_zero():
    """STORM sequences update with the ENTERING momentum: the first step's
    update norm is exactly 0 (the leading zero the validator's trend check
    drops)."""
    eng, s = _make("fedbioacc", telemetry=TelemetrySpec())
    mets = {}
    eng.step(s, torch.from_numpy(_batches(1)[0]), mets)
    assert float(mets["upd_norm/u"]) == 0.0
    assert float(mets["mom_norm/u"]) > 0.0


def test_metric_group_resolution_and_rejections():
    assert resolve_metric_groups(None) == ("norms", "drift")
    assert resolve_metric_groups(None, compressed=True, guarded=True) == (
        "norms", "drift", "compression", "health")
    with pytest.raises(ValueError, match="unknown telemetry metric"):
        resolve_metric_groups(("norms", "bogus"))
    # explicit groups whose inputs the run does not have: clear errors
    with pytest.raises(ValueError, match="'compression' needs"):
        _make("fedbioacc", telemetry=TelemetrySpec(metrics=("compression",)))
    with pytest.raises(ValueError, match="'health' needs"):
        _make("fedbioacc", telemetry=TelemetrySpec(metrics=("health",)))
    with pytest.raises(ValueError, match="'stragglers' needs"):
        _make("fedbioacc", telemetry=TelemetrySpec(metrics=("stragglers",)))


def test_trainer_rejects_unfused_inband_metrics():
    from repro_torch.federation.trainer import _telemetry_setup
    with pytest.raises(ValueError, match="fuse_storm"):
        _telemetry_setup(TelemetrySpec(metrics=("norms",)), False)
    # an events-only spec is fine unfused; fused passes through
    assert _telemetry_setup(TelemetrySpec(metrics=()), False) is None
    t = TelemetrySpec()
    assert _telemetry_setup(t, True) is t


def test_eventlog_append_resume_and_tail_repair(tmp_path):
    p = str(tmp_path / "events.jsonl")
    with EventLog(p, experiment=None) as log:
        log.emit("metrics", step=1, val_loss=2.5)
    # a crashed writer leaves a partial tail line; the next open repairs it
    with open(p, "a") as f:
        f.write('{"event": "metrics", "seq": 2, "ts": 0, "st')
    with pytest.raises(TelemetryError, match="unterminated"):
        read_events(p)
    with EventLog(p, experiment=None) as log:      # repair + new segment
        log.emit("run_end", step=1, status="ok")
    evs = read_events(p)
    assert [e["event"] for e in evs] == ["run_start", "metrics",
                                         "run_start", "run_end"]
    s = validate_events(p)
    assert s["segments"] == 2 and s["events"] == 4


def test_eventlog_rejects_missing_required_keys(tmp_path):
    with EventLog(str(tmp_path / "e.jsonl"), experiment=None) as log:
        with pytest.raises(TelemetryError, match="missing required"):
            log.emit("comm", step=2, round=1)      # no elems/bytes_wire


def test_validate_reconciles_comm_bytes(tmp_path):
    """Exact comm: bytes_wire = reductions × elems × 4 B; a tampered byte
    count fails reconciliation against the embedded spec's model."""
    p = str(tmp_path / "e.jsonl")
    with EventLog(p, experiment={"compression": None}) as log:
        log.emit("comm", step=2, round=1, elems=1000, reductions=2,
                 bytes_wire=8000)
    assert validate_events(p)["comm_reconciled"] == 1
    with EventLog(p, experiment={"compression": None}) as log:
        log.emit("comm", step=4, round=2, elems=1000, reductions=2,
                 bytes_wire=16000)                  # tampered: doubled
    with pytest.raises(TelemetryError, match="disagrees with the analytic"):
        validate_events(p)


def test_validate_reconciles_compressed_comm(tmp_path):
    cp = tc.CompressionSpec(quant="int8", topk_frac=0.10)
    wire = tc.wire_bytes_per_elem(cp, 256)
    assert wire == jc.wire_bytes_per_elem(
        jc.CompressionSpec(quant="int8", topk_frac=0.10), 256)
    p = str(tmp_path / "e.jsonl")
    with EventLog(p, experiment={"compression": cp._asdict()}) as log:
        log.emit("comm", step=2, round=1, elems=4096, reductions=2,
                 block=256, bytes_wire=int(2 * 4096 * wire))
    assert validate_events(p)["comm_reconciled"] == 1


def test_validate_expect_and_trend(tmp_path):
    p = str(tmp_path / "e.jsonl")
    with EventLog(p, experiment=None) as log:
        for t, v in enumerate((0.0, 3.0, 2.0, 1.0)):   # leading zero dropped
            log.emit("metrics", step=t + 1, **{"mom_norm/u": v})
    validate_events(p, trend_decreasing=("mom_norm/u",))
    with pytest.raises(TelemetryError, match="expected at least one"):
        validate_events(p, expect=("rollback",))
    with pytest.raises(TelemetryError, match="does not trend down"):
        validate_events(p, trend_decreasing=("step",))


def test_telemetry_spec_experiment_roundtrip():
    from repro_torch.api.spec import TelemetrySpec as SpecTelemetry
    assert SpecTelemetry is TelemetrySpec           # re-exported, one class
    exp = Experiment().edit(**{
        "execution.fuse_storm": True, "execution.fuse_oracles": True,
        "telemetry.metrics": ["norms", "drift"],
        "telemetry.sink": "events.jsonl"})
    exp.validate()
    back = Experiment.from_json(exp.to_json())
    assert back.telemetry == exp.telemetry
    assert back.telemetry.metrics == ("norms", "drift")
    with pytest.raises(ValueError, match="telemetry"):
        exp.edit(**{"telemetry.metrics": ["bogus"]}).validate()
    with pytest.raises(ValueError, match="fuse_storm"):
        exp.edit(**{"execution.fuse_storm": False}).validate()


def test_faulty_run_emits_rollback_events(tmp_path):
    """A run whose NaNs reach the unscreened mean rolls back, exhausts the
    retry budget, and the event stream records the whole trail: rollback
    events with (step, retry, bad_loss), retry_budget_exhausted, and a
    run_end with that status; the CLI exits non-zero.  The committed
    faulty spec cut to 4 clients (the reference's test keeps 8), in
    process."""
    exp = Experiment.load(FAULTY).edit(**{
        "faults.nan_rate": 1.0, "schedule.steps": 6,
        "problem.num_clients": 4,
        "robustness.screen": False, "robustness.aggregator": "mean"})
    spec = str(tmp_path / "faulty.json")
    exp.save(spec)
    sink = str(tmp_path / "events.jsonl")
    with pytest.raises(SystemExit) as err:
        train.main(["--experiment", spec, "--telemetry-sink", sink,
                    "--log-every", "1", "--device", "cpu"])
    assert str(err.value).startswith("round ")
    validate_events(sink, expect=("rollback", "retry_budget_exhausted"))
    jvalidate(sink, expect=("rollback", "retry_budget_exhausted"))
    evs = read_events(sink)
    rb = [e for e in evs if e["event"] == "rollback"]
    assert len(rb) == exp.robustness.retry_budget
    assert {"step", "retry", "bad_loss"} <= set(rb[0])
    assert [e["retry"] for e in rb] == [1, 2]
    assert evs[-1]["event"] == "run_end"
    assert evs[-1]["status"] == "retry_budget_exhausted"


def test_comm_plan_matches_flat_spec():
    """The analytic plan counts exactly the communicated elements of the
    engine's flat layout (padded extents), doubled for the momentum
    reduction; the reference's plan on the same spec is the same."""
    eng, _ = _make("fedbioacc_local")   # y PRIVATE: only x communicates
    plan = comm_plan(eng.spec, eng.aspec, None)
    assert plan is not None and plan.reductions == 2   # storm: vars + mom
    assert [s[0] for s in plan.sections] == ["x"]      # private y excluded
    b1 = round_bytes(plan, 1)
    assert b1 is not None and b1["bytes_wire"] == pytest.approx(
        plan.reductions * b1["elems"] * 4.0)
    # the x group extent covers the padded x run: elems >= 3*5, < 2 blocks
    assert 15 <= b1["elems"] <= 16
    from repro.telemetry import comm_plan as jplan
    from repro.telemetry.comm import compressed_chunk_elems as jchunk
    jeng, _ = _make_ref("fedbioacc_local")
    assert tuple(jplan(jeng.spec, jeng.aspec, None)) == tuple(plan)
    # with compression of one section: the plan, its round payload and the
    # compressed elements are the reference's integers
    eng, _ = _make("fedbioacc")
    jeng, _ = _make_ref("fedbioacc")
    tcp = tc.CompressionSpec(quant="int8", topk_frac=0.1, sections=("u",))
    jcp = jc.CompressionSpec(quant="int8", topk_frac=0.1, sections=("u",))
    plan, want = comm_plan(eng.spec, eng.aspec, tcp), \
        jplan(jeng.spec, jeng.aspec, jcp)
    assert tuple(plan) == tuple(want)
    from repro.telemetry import round_bytes as jround
    assert round_bytes(plan, 3) == jround(want, 3)
    assert compressed_chunk_elems(eng.spec, eng.aspec, tcp) == \
        jchunk(jeng.spec, jeng.aspec, jcp) == 16


# ---------------------------------------------------------------------------
# parity, function by function
# ---------------------------------------------------------------------------

_LEAVES = {"x": {"w": 45, "b": 20}, "y": {"h": 11}, "u": {"v": 13}}


def _flat_inputs(dtype, seed=0, m=8):
    """The same layout on both packages (``bf16``: bf16 leaves and one f32
    leaf, as the model's buffers are) and numpy-seeded [m, N] buffers."""
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    tmpl_j = {s: {k: jax.ShapeDtypeStruct(
        (n,), jnp.float32 if (dtype == "bf16" and k == "b") else jdt)
        for k, n in d.items()} for s, d in _LEAVES.items()}
    tmpl_t = {s: {k: torch.empty(n, device="meta",
                                 dtype=torch.float32 if (dtype == "bf16"
                                                         and k == "b")
                                 else {"f32": torch.float32,
                                       "bf16": torch.bfloat16}[dtype])
                  for k, n in d.items()} for s, d in _LEAVES.items()}
    secs = tuple(_LEAVES)
    jspec = jflat.make_spec(tmpl_j, sections=secs, block=8)
    tspec = flat.make_spec(tmpl_t, sections=secs, block=8)
    assert [g.extents for g in tspec.groups] == \
        [tuple(g.extents) for g in jspec.groups]
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        tb = []
        for g in tspec.groups:
            a = rng.standard_normal((m, g.padded)).astype(np.float32)
            # zero padding, as flatten_tree lays the buffers out
            pad = np.ones(g.padded, bool)
            for lf in g.leaves:
                pad[lf.offset:lf.offset + lf.size] = False
            a[:, pad] = 0.0
            tb.append(torch.from_numpy(a).to(g.dtype))
        out.append(tuple(tb))
    jb = [tuple(jnp.asarray(b.float().numpy()).astype(
        jnp.bfloat16 if b.dtype == torch.bfloat16 else jnp.float32)
        for b in side) for side in out]
    return jspec, tspec, jb, out


def _close(got: dict, want: dict, rtol=RTOL):
    # the reference's jitted step returns its dict with sorted keys
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                   np.asarray(want[k], np.float64),
                                   rtol=rtol, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_section_norms_and_drift_match_reference(dtype):
    jspec, tspec, (jn, jo), (tn, to_) = _flat_inputs(dtype)
    mask = np.array([1, 0, 1, 1, 0, 1, 1, 1], np.float32)
    jm, tm = jnp.asarray(mask), torch.from_numpy(mask)
    diff = tuple(n - o for n, o in zip(jn, jo))
    _close(flat.section_norms(tspec, tn, mask=tm, prefix="upd_norm",
                              minus=to_),
           jflat.section_norms(jspec, diff, mask=jm, prefix="upd_norm"))
    _close(flat.section_norms(tspec, tn, prefix="mom_norm"),
           jflat.section_norms(jspec, jn, prefix="mom_norm"))
    for m_j, m_t in ((jm, tm), (None, None)):
        _close(flat.section_drift(tspec, tn, mask=m_t),
               jflat.section_drift(jspec, jn, mask=m_j))
    # a left-out row's NaN never reaches a norm
    poisoned = tuple(b.clone() for b in tn)
    poisoned[0][1] = float("nan")
    got = flat.section_norms(tspec, poisoned, mask=tm)
    assert all(np.isfinite(float(v)) for v in got.values())
    got = flat.section_drift(tspec, poisoned, mask=tm)
    assert all(np.isfinite(float(v)) for v in got.values())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("quant", ["int8", "bf16"])
def test_quant_roundtrip_err_matches_reference(dtype, quant, monkeypatch):
    """Through the port's quantization wrappers (their plain versions on
    the CPU); chunked over columns, a whole tile per chunk, the result is
    the one-pass one."""
    jspec, tspec, (jn, _), (tn, _) = _flat_inputs(dtype)
    want = float(jflat.quant_roundtrip_err(jn, 8, quant))
    got = flat.quant_roundtrip_err(tn, 8, quant)
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), want, rtol=RTOL)
    monkeypatch.setattr(flat, "_CHUNK", 20)        # 2 tiles a chunk
    np.testing.assert_allclose(float(flat.quant_roundtrip_err(tn, 8, quant)),
                               float(got), rtol=1e-6)


def _screen_margins(tspec, bufs, mask, corrupt, rcfg):
    """Every finite participant's whole-row norm lies farther than
    ``MARGIN`` of the threshold from it (port's statistics)."""
    m = bufs[0].shape[0]
    p = torch.ones(m, dtype=torch.bool) if mask is None else mask > 0
    x = torch.cat([b.float() for b in bufs], dim=-1)
    x = flat._corrupt_rows(x, corrupt)
    finite = torch.isfinite(x).all(dim=1)
    sq = x.double().square().sum(dim=1)
    _, stats = flat._health_stats(finite, sq, p, rcfg)
    n, mu, tol = stats
    for i in range(m):
        if p[i] and finite[i] and torch.isfinite(tol):
            gap = abs(float((n[i] - mu).abs() - tol))
            assert gap > MARGIN * float(tol), (i, n, mu, tol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", ["nan_byz", "masked", "z_off"])
def test_health_screen_matches_reference(dtype, case, monkeypatch):
    jspec, tspec, (jn, _), (tn, _) = _flat_inputs(dtype, seed=3)
    nan = np.zeros(8, np.float32)
    byz = np.zeros(8, np.float32)
    nan[2], byz[5] = 1.0, 1.0
    mask = None
    if case == "masked":
        mask = np.array([1, 1, 0, 1, 1, 1, 0, 1], np.float32)
    z = 0.0 if case == "z_off" else 2.0
    rob = dict(aggregator="clip", screen=True, z_thresh=z, clip_factor=2.0,
               trim_frac=0.2)
    tcorrupt = (torch.from_numpy(nan), torch.from_numpy(byz), 25.0)
    jcorrupt = (jnp.asarray(nan), jnp.asarray(byz), 25.0)
    tmask = None if mask is None else torch.from_numpy(mask)
    rcfg = flat.RobustCfg(**rob)
    if z > 0:
        _screen_margins(tspec, tn, tmask, tcorrupt, rcfg)
    got = flat.health_screen(tspec, tn, tmask, tcorrupt, rcfg)
    want = jflat.health_screen(jspec, jn,
                               None if mask is None else jnp.asarray(mask),
                               jcorrupt, jflat.RobustCfg(**rob))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[2] == 1.0 or (mask is not None and mask[2] == 0)
    # chunked statistics are the one-pass ones
    monkeypatch.setattr(flat, "_CHUNK", 16)
    np.testing.assert_array_equal(
        flat.health_screen(tspec, tn, tmask, tcorrupt, rcfg).numpy(),
        got.numpy())


def test_arrival_histogram_matches_reference():
    """Each round's sampled times over the effective deadline, binned as
    the reference bins them; each ratio's distance to its bin edge is
    asserted first (the port's draws are within 8 ulps of the
    reference's)."""
    fields = dict(base_time=1.0, tail=1.0, deadline=1.5, quorum=0.5,
                  over_provision=2, seed=3, adapt_rate=0.3)
    m = 8
    tstrag = ts.make_stragglers(ts.StragglerSpec(**fields), m)
    jstrag = js.make_stragglers(js.StragglerSpec(**fields), m)
    assert ts.ARRIVAL_HIST_BINS == js.ARRIVAL_HIST_BINS == 8
    sampled = np.array([1, 1, 0, 1, 1, 1, 1, 0], np.float32)
    checked = 0
    for r in range(12):
        times = tstrag.round_times(r)
        for dl in (1.5, 0.7, 2.3):
            ratio = times.double() * 4.0 / dl
            edge = torch.round(ratio)
            assert torch.all((ratio - edge).abs() > MARGIN * ratio), r
            got = ts.arrival_histogram(times, torch.tensor(dl), sampled)
            want = js.arrival_histogram(jstrag.round_times(r),
                                        jnp.float32(dl), jnp.asarray(sampled))
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            assert float(got.sum()) == sampled.sum()
            checked += 1
    assert checked == 36


# ---------------------------------------------------------------------------
# parity, engine level
# ---------------------------------------------------------------------------

def _layers(kind, m):
    """(port layers, reference layers) of a toy engine case."""
    if kind == "plain":
        return {}, {}
    if kind == "compressed":
        f = dict(quant="int8", topk_frac=0.25)
        return ({"compression": tc.CompressionSpec(**f)},
                {"compression": jc.CompressionSpec(**f)})
    if kind == "faulty":
        f = dict(nan_rate=0.25, byzantine_rate=0.25, byzantine_scale=25.0,
                 start_round=1, seed=7)
        r = dict(aggregator="clip", screen=True, z_thresh=2.5)
        return ({"faults": tf.make_faults(tf.FaultSpec(**f), m),
                 "robustness": tf.RobustnessSpec(**r)},
                {"faults": jf.make_faults(jf.FaultSpec(**f), m),
                 "robustness": jf.RobustnessSpec(**r)})
    f = dict(base_time=1.0, tail=1.0, deadline=1.2, quorum=0.5,
             over_provision=0, seed=2, adapt_rate=0.5)
    p = dict(sampler="uniform", clients_per_round=6, seed=5)
    return ({"stragglers": ts.make_stragglers(ts.StragglerSpec(**f), m),
             "participation": tp.make_participation(
                 tp.ParticipationSpec(**p), m)},
            {"stragglers": js.make_stragglers(js.StragglerSpec(**f), m),
             "participation": jp.make_participation(
                 jp.ParticipationSpec(**p), m)})


@pytest.mark.parametrize("kind,groups", [
    ("plain", ("norms", "drift")),
    ("compressed", ("norms", "drift", "compression")),
    ("faulty", ("norms", "drift", "health")),
    ("straggled", ("norms", "drift", "health", "stragglers")),
])
def test_engine_metrics_match_reference(kind, groups):
    """FedBiOAcc's toy engines over two rounds with every applicable group:
    the same keys, norms within ``RTOL``, counts,
    histograms and verdicts equal; and the port's trajectory is its
    telemetry-free one bit for bit."""
    m = 8
    tl, jl = _layers(kind, m)
    eng, st = _make("fedbioacc", telemetry=TelemetrySpec(), m=m, **tl)
    bare, sb = _make("fedbioacc", m=m, **tl)
    jeng, js_ = _make_ref("fedbioacc", telemetry=JTelemetrySpec(), m=m,
                          **jl)
    assert eng.step.telemetry_groups == jeng.step.telemetry_groups == groups
    jstep = jax.jit(jeng.step)
    for b in _batches(4, m):
        js_, jm = jstep(js_, jnp.asarray(b))
        got = {}
        st = eng.step(st, torch.from_numpy(b), got)
        sb = bare.step(sb, torch.from_numpy(b), {})
        got = {k: v for k, v in got.items() if k != "decision"}
        want = {k: np.asarray(v) for k, v in jm.items() if k != "step"}
        exact = [k for k in want if not k.split("/")[0].endswith("norm")
                 and not k.startswith("drift") and k != "quant_err"
                 and not k.startswith("deadline")]
        _close({k: v for k, v in got.items() if k not in exact},
               {k: v for k, v in want.items() if k not in exact},
               rtol=1e-5 if kind != "compressed" else 1e-4)
        for k in exact:
            np.testing.assert_array_equal(np.asarray(got[k]), want[k], k)
        for k in ("deadline", "deadline_next"):
            if k in want:      # host f32 arithmetic on times within ulps
                np.testing.assert_allclose(float(got[k]), float(want[k]),
                                           rtol=1e-5)
    _assert_bit_identical(st, sb)


# ---------------------------------------------------------------------------
# parity, spec level: the CLIs' event streams
# ---------------------------------------------------------------------------

def _seq(events):
    return [(e["event"], e.get("step"), e.get("round"), e.get("retry"))
            for e in events]


def _feed_reference(monkeypatch, path, steps):
    """Patch the port CLI's ``build`` so that its run starts from the
    reference's initial state, draws the reference CLI's batches and
    evaluates on the reference's evaluation batch (what the reference's
    CLI does with ``schedule.seed``)."""
    from repro.api import Experiment as JExperiment
    from repro.api import build as jbuild
    jexp = JExperiment.load(path)
    jrun = jbuild(jexp)
    key = jax.random.PRNGKey(jexp.schedule.seed)
    jstate = jrun.init(key)
    batches = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        batches.append(to_torch(jrun.batch_fn(sub)))
    eval_batch = to_torch(jax.tree.map(
        lambda v: v[0], jrun.batch_fn(jax.random.PRNGKey(123)))["val"])
    orig = train.build

    def fed(exp, device=None):
        run = orig(exp, device=device)

        def init(_gen):
            return seqs.FlatState(tuple(to_torch(list(jstate.vars))),
                                  tuple(to_torch(list(jstate.mom))), 0)

        def eval_fn(state):
            s = run.views(state)
            p = client_slice({"body": s.x, "head": s.y}, 0)
            with torch.no_grad():
                return float(run.model.loss(p, eval_batch)[0])

        feed = iter(batches)
        return run._replace(init=init, batch_fn=lambda _gen: next(feed),
                            eval_fn=eval_fn)
    monkeypatch.setattr(train, "build", fed)


def test_reduced_telemetry_spec_matches_reference_cli(tmp_path, monkeypatch):
    """The reduced ``fedbioacc_telemetry.json``, 4 steps (two rounds),
    ``--log-every 2``, through both CLIs in process; each stream passes
    both validators."""
    steps = 4
    exp = Experiment.load(TELEMETRY).edit(**{"schedule.steps": steps})
    spec = str(tmp_path / "telemetry.json")
    exp.save(spec)
    mine, theirs = str(tmp_path / "mine.jsonl"), str(tmp_path / "ref.jsonl")
    _feed_reference(monkeypatch, spec, steps)
    train.main(["--experiment", spec, "--telemetry-sink", mine,
                "--log-every", "2", "--device", "cpu"])
    jtrain.main(["--experiment", spec, "--telemetry-sink", theirs,
                 "--log-every", "2"])
    got, want = read_events(mine), read_events(theirs)
    assert _seq(got) == _seq(want)
    # the embedded specs differ only in the sink each run was given
    spec_of = lambda e: {**e["experiment"], "telemetry": {  # noqa: E731
        **e["experiment"]["telemetry"], "sink": None}}
    assert spec_of(got[0]) == spec_of(want[0])
    assert got[0]["schema"] == want[0]["schema"] == 1
    n_metrics = 0
    for g, w in zip(got, want):
        if g["event"] == "comm":
            assert {k: v for k, v in g.items() if k not in ("seq", "ts")} \
                == {k: v for k, v in w.items() if k not in ("seq", "ts")}
        elif g["event"] == "metrics":
            keys = [k for k in w if k not in ("event", "seq", "ts",
                                               "wall_s")]
            assert [k for k in g if k not in ("event", "seq", "ts",
                                              "wall_s")] == keys
            for k in keys:
                if isinstance(w[k], float):
                    assert g[k] == pytest.approx(w[k], rel=SPEC_TOL,
                                                 abs=1e-7), k
                else:
                    assert g[k] == w[k], k
            n_metrics += 1
        elif g["event"] == "span":
            assert g["name"] == w["name"] == "eval"
    assert n_metrics == 6          # in-band at steps 1, 2, 4; eval at 1, 2, 4
    assert _seq(got).count(("metrics", 4, None, 0)) == 1
    for path in (mine, theirs):
        for check in (validate_events, jvalidate):
            s = check(path, expect=("run_start", "metrics", "comm",
                                    "run_end"),
                      trend_decreasing=())
            assert s["comm_reconciled"] == 2 and s["segments"] == 1
    # the summarizer reads both streams alike
    assert tmetrics.summarize(got)["wire_bytes_total"] == \
        tmetrics.summarize(want)["wire_bytes_total"]
    rows = tmetrics.round_table(got)
    assert [r["round"] for r in rows] == [1, 2]
    assert all(r["upd_norm/u"] is not None for r in rows)


def test_straggler_stream_carries_the_engine_decisions(tmp_path, capsys):
    """The reduced straggler spec with ``--telemetry-sink`` (the health and
    stragglers groups at 8 clients): the stream validates with its
    deadline events checked, and each ``deadline`` event is the engine's
    recorded decision of that step, as the CLI's lines print it."""
    sink = str(tmp_path / "ev.jsonl")
    hist = train.main(["--experiment", STRAGGLER, "--steps", "4",
                       "--telemetry-sink", sink, "--log-every", "1",
                       "--device", "cpu"])
    s = validate_events(sink, expect=("deadline", "comm"))
    assert s["deadlines_checked"] == 2 and s["comm_reconciled"] == 2
    jvalidate(sink)
    evs = read_events(sink)
    dl = [e for e in evs if e["event"] == "deadline"]
    lines = {h["step"]: h for h in hist}
    for e in dl:
        assert e["deadline"] == round(lines[e["step"]]["deadline"], 6)
        assert e["arrivals"] == len(lines[e["step"]]["arrivals"]) >= \
            e["quorum"]
        assert sum(e["arrival_hist"]) == 6        # the sampled clients
    inband = [e for e in evs if e["event"] == "metrics" and "upd_norm/x" in e]
    assert all(len(e["stale_hist"]) == 8 and e["participants"] >= 3
               for e in inband)
    # the summarizer's CLI
    assert tmetrics.main([sink, "--table", "--comm"]) == 0
    assert "rounds communicated: 2" in capsys.readouterr().out


def test_crash_then_resume_appends_a_validating_segment(tmp_path):
    """``--crash-at-step 2`` (a hard exit, so in a subprocess) then
    ``--resume``: one stream in the checkpoint directory, two segments
    that validate, and the resumed run's ``comm`` events those of the
    uninterrupted run."""
    spec = str(tmp_path / "telemetry.json")
    Experiment.load(TELEMETRY).edit(**{"schedule.steps": 4}).save(spec)
    crashed, whole = str(tmp_path / "crashed"), str(tmp_path / "whole")
    common = ["--device", "cpu", "--ckpt-every", "2", "--log-every", "2"]
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--experiment",
         spec, "--ckpt-dir", crashed, "--crash-at-step", "2", *common],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
             "OMP_NUM_THREADS": "1"})
    assert out.returncode == 17, out.stderr
    train.main(["--resume", crashed, "--ckpt-dir", crashed, *common])
    train.main(["--experiment", spec, "--ckpt-dir", whole, *common])
    stream = os.path.join(crashed, "events.jsonl")
    s = validate_events(stream, expect=("checkpoint", "comm", "run_end"))
    assert s["segments"] == 2
    jvalidate(stream)
    evs = read_events(stream)
    starts = [i for i, e in enumerate(evs) if e["event"] == "run_start"]
    assert [evs[i]["start_step"] for i in starts] == [0, 2]
    # the crashed segment ends without a run_end; the resumed one has one
    assert "run_end" not in [e["event"] for e in evs[:starts[1]]]
    full = read_events(os.path.join(whole, "events.jsonl"))
    strip = lambda e: {k: v for k, v in e.items()  # noqa: E731
                       if k not in ("seq", "ts")}
    assert [strip(e) for e in evs if e["event"] == "comm"] == \
        [strip(e) for e in full if e["event"] == "comm"]
    resumed = [e for e in evs[starts[1]:] if e["event"] == "metrics"
               and "upd_norm/x" in e]
    uninterrupted = [e for e in full if e["event"] == "metrics"
                     and "upd_norm/x" in e and e["step"] > 2]
    # a resume's first step is a log step (step 3), as in the reference's
    # CLI; the steps both runs logged carry the same metrics, bit for bit
    assert [e["step"] for e in resumed] == [3, 4]
    assert [e["step"] for e in uninterrupted] == [4]
    assert [strip(e) for e in resumed[1:]] == \
        [strip(e) for e in uninterrupted]
