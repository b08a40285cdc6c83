"""Collective/wire auditor, the ``W1xx`` rules (counterpart of
``repro/analysis/collectives.py``).

Two surfaces, one expected model:

* **the step** — one full step of a built sharded run (at the
  communication step of each round the audit covers) runs on the mesh's
  ranks under :func:`record_collectives`, which observes every
  ``torch.distributed`` collective the port issues and records the
  reference's entry ``(primitive, axes, grouped, dtype, operand elems)``.
  The expected multiset is derived from the SAME section-extent merge the
  reduction uses (``flat._section_runs``) — one sliced reduction per
  communicated merged run per reduction event, plus the policy's stats
  collectives (the int8 scale exchange, the guarded means' screen, clip
  and trim) and the oracle's row gathers over the model axis.  Counts and
  operand sizes are exact (W101), and an unexplained operand whose size
  matches a private run is private state on the wire (W102).

* **the wire** — the engine's communication-only subprogram
  (``run.step.comm_fn``: no oracle, no fused update) runs under the same
  recorder, which also sums each collective's RESULT bytes by dtype (the
  reference's HLO accounting), so the contract is byte-exact per dtype
  (W104), the narrow dtype of a quantized policy covers its reductions
  (W103), and no resharding collective sits between oracle and fused update
  (W105).

Where the port departs from the reference's model, the model says why: the
participation weights are host values every rank holds for all M clients,
so a weighted run's weight sum is no collective (the reference psums it);
the oracle's all-gathers of the rows over the model axis, which GSPMD
inserts into the reference's program at compile time, are explicit
collectives of the port's step; and so are the in-band telemetry passes'
reductions (:func:`telemetry_collectives`), which the reference computes
on global arrays outside ``shard_map``, where GSPMD inserts them.  Neither
is in the communication-only subprogram.
"""
from __future__ import annotations

import contextlib
import inspect
import math
from collections import Counter
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.analysis.rules import Finding
from repro_torch.analysis.structure import TRACE_SEED, init_generator

#: torch dtype name -> HLO dtype token (the reference's wire keying)
_HLO_DTYPE = {"float32": "f32", "bfloat16": "bf16", "float16": "f16",
              "int8": "s8", "uint8": "u8", "int32": "s32",
              "float64": "f64", "bool": "pred"}
_DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2, "int8": 1,
                "uint8": 1, "int32": 4, "float64": 8, "bool": 1}

#: one expected-collective entry: (prim, axes, grouped, dtype, elems)
Entry = Tuple[str, tuple, bool, str, int]

#: the ``torch.distributed`` functions the recorder observes: name →
#: (the reference's primitive, the HLO op it would be, the operand
#: parameter, the result parameter)
_OBSERVED = {
    "all_reduce": ("psum", "all-reduce", "tensor", "tensor"),
    "reduce_scatter_tensor": ("psum_scatter", "reduce-scatter", "input",
                              "output"),
    "all_gather_into_tensor": ("all_gather", "all-gather", "input_tensor",
                               "output_tensor"),
    "broadcast": ("broadcast", "collective-broadcast", "tensor", "tensor"),
    "all_to_all_single": ("all_to_all", "all-to-all", "input", "output"),
    "all_to_all": ("all_to_all", "all-to-all", "input_tensor_list",
                   "output_tensor_list"),
    "send": ("ppermute", "collective-permute", "tensor", "tensor"),
    "recv": ("ppermute", "collective-permute", "tensor", "tensor"),
    "isend": ("ppermute", "collective-permute", "tensor", "tensor"),
    "irecv": ("ppermute", "collective-permute", "tensor", "tensor"),
}


def _tensors(x) -> list:
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _dtype(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


# ---------------------------------------------------------------------------
# what a step actually issues
# ---------------------------------------------------------------------------

class Record:
    """The collectives observed in order: ``entries`` (the reference's
    entries) and ``ops`` (``(hlo op, result bytes by dtype)``)."""

    def __init__(self):
        self.entries: List[Entry] = []
        self.ops: List[Tuple[str, Dict[str, int]]] = []

    def counter(self) -> Counter:
        return Counter(self.entries)

    def wire(self) -> Dict[str, Any]:
        """The record in the form of the reference's
        ``hlo_stats.collective_bytes``: per-op ``bytes`` and ``counts``,
        ``bytes_by_dtype`` (HLO tokens), ``total_bytes`` and ``ops``."""
        from repro_torch.launch.hlo_stats import collective_bytes
        return collective_bytes(self.ops)


def _observed(fn, name: str, rec: Record, mesh):
    prim, op, operand, result = _OBSERVED[name]
    sig = inspect.signature(fn)

    def wrapper(*args, **kwargs):
        bound = sig.bind(*args, **kwargs)
        src = _tensors(bound.arguments[operand])
        group = bound.arguments.get("group")
        axes, grouped = (mesh.axes_of(group) if mesh is not None
                         else (("data", "model"), False))
        rec.entries.append((prim, axes, grouped, _dtype(src[0].dtype),
                            sum(t.numel() for t in src)))
        nbytes: Dict[str, int] = {}
        for t in _tensors(bound.arguments[result]):
            tok = _HLO_DTYPE.get(_dtype(t.dtype), _dtype(t.dtype))
            nbytes[tok] = nbytes.get(tok, 0) + t.numel() * t.element_size()
        rec.ops.append((op, nbytes))
        return fn(*args, **kwargs)

    return wrapper


@contextlib.contextmanager
def record_collectives(mesh=None):
    """Observe every ``torch.distributed`` collective issued inside the
    block (see :data:`_OBSERVED`); yields the :class:`Record`.  ``mesh``
    (a ``launch.mesh.Mesh``) names each call's axes from its group.  The
    wrappers only observe: each calls the collective unchanged."""
    rec = Record()
    saved = {name: getattr(dist, name) for name in _OBSERVED
             if hasattr(dist, name)}
    for name, fn in saved.items():
        setattr(dist, name, _observed(fn, name, rec, mesh))
    try:
        yield rec
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


# ---------------------------------------------------------------------------
# expected side: mirror of flat._client_mean_masked_sharded
# ---------------------------------------------------------------------------

class _Expect:
    """Accumulates expected entries while mirroring one reduction call."""

    def __init__(self, *, data_size: int, use_scatter: bool, m_local: int):
        self.c: Counter = Counter()
        self.verdicts: Counter = Counter()    # the screen's verdict gathers
        self.nds = data_size
        self.use_scatter = use_scatter
        self.m_local = m_local

    def psum(self, elems: int, dtype: str = "float32", *,
             axes=("data",), grouped: bool = False) -> None:
        self.c[("psum", axes, grouped, dtype, elems)] += 1

    def gather(self, elems: int, dtype: str = "float32", *,
               axes=("data",)) -> Entry:
        key = ("all_gather", axes, False, dtype, elems)
        self.c[key] += 1
        return key

    def allreduce(self, elems: int, dtype: str, *,
                  grouped: bool = False) -> None:
        # flat._allreduce: reduce-scatter + all-gather iff use_scatter, no
        # pod group and the run tiles evenly over the data axis
        if self.use_scatter and not grouped and elems % self.nds == 0:
            self.c[("psum_scatter", ("data",), False, dtype, elems)] += 1
            self.gather(elems // self.nds, dtype)
        else:
            self.psum(elems, dtype, grouped=grouped)

    def robust_run(self, L: int, dtype: str, robust, verdicts: bool) -> None:
        """flat._robust_mean_sharded on one run of ``L`` elements."""
        m = self.m_local
        if robust is None:
            self.psum(1)                              # wsum (faulty mean)
            self.allreduce(L, dtype)
            return
        if robust.screen:
            self.psum(m, axes=("model",))             # nonfinite counts
        self.psum(m, axes=("model",))                 # row norms squared
        if robust.screen and robust.z_thresh > 0:
            self.psum(1)                              # cnt
            self.psum(1)                              # mu
            self.psum(1)                              # sd
        if verdicts and robust.screen:
            self.verdicts[self.gather(m)] += 1        # the health verdicts
        self.psum(1)                                  # wsum_eff
        if robust.aggregator == "trim":
            self.gather(m * L)                        # every client's rows
            self.psum(1)                              # nh
        else:
            if robust.aggregator == "clip":
                self.psum(1)                          # tau
            self.allreduce(L, dtype)

    def mean_run(self, L: int, dtype: str, *, comp: bool, grouped: bool,
                 block: int, compress) -> None:
        """One communicated merged run of ``L`` elements of a buffer of
        ``dtype``.  A weighted run adds no collective: the weights are
        host values every rank holds for all M clients."""
        if not (comp and compress is not None):
            self.allreduce(L, dtype, grouped=grouped)
        elif compress.quant == "int8":
            # _wire_allreduce: the shared per-tile scales, then the sum
            self.psum(L // block, grouped=grouped)
            self.allreduce(L, "int8", grouped=grouped)
        elif compress.quant == "bf16":
            self.allreduce(L, "bfloat16", grouped=grouped)
        else:                             # top-k only: dense f32 wire
            self.allreduce(L, "float32", grouped=grouped)


def audit_rounds(run) -> range:
    """The communication rounds the audit records: 1 to the least common
    multiple of the sections' cadences and the hierarchical period, so
    that every reduction the schedule issues (every cadence, pod-local
    and global rounds) is seen once; round 1 alone for a flat schedule."""
    sch = run.spec.schedule
    cadences = [q.comm_every for q in run.step.aspec.sequences]
    period = math.lcm(*cadences, max(sch.hierarchy_period, 1))
    return range(1, period + 1)


def expected_step_collectives(run, round_idx: Optional[int] = None
                              ) -> Tuple[Counter, Dict[str, Any]]:
    """(expected multiset, info) for the communication step of round
    ``round_idx`` (default: the last of :func:`audit_rounds`, where every
    section reduces) of a built sharded run — empty off-mesh (the
    unsharded reduction is collective-free).

    ``info`` carries ``private_elems`` (merged private-run lengths, for
    W102 classification), ``comm_elems`` (per-event communicated payload
    elems, one shard chunk), ``events`` (reduction events per step) and
    ``oracle_gathers``, ``telemetry`` and ``verdicts`` (the entries of
    the oracle's row gathers, of the in-band telemetry passes and of the
    screen's verdict gathers for the step's decision record, which the
    communication-only subprogram does not issue)."""
    from repro_torch.optim import flat
    from repro_torch.optim.sequences import HIERARCHICAL, PRIVATE

    step = run.step
    flat_spec, aspec = step.spec, step.aspec
    exp = run.spec
    info: Dict[str, Any] = {"events": 0, "comm_elems": 0,
                            "private_elems": set(),
                            "oracle_gathers": Counter(),
                            "telemetry": Counter(), "verdicts": Counter()}
    shard = run.shard
    if shard is None:
        return Counter(), info
    if round_idx is None:
        round_idx = audit_rounds(run)[-1]
    data_size, k = shard.data_size, shard.model_size
    m_local = exp.problem.num_clients // data_size
    guarded = step.faults is not None or step.robustness is not None
    robust = None
    if step.robustness is not None:
        r = step.robustness
        robust = flat.RobustCfg(
            aggregator=r.aggregator, screen=r.screen, z_thresh=r.z_thresh,
            clip_factor=r.clip_factor, trim_frac=r.trim_frac)
    # the step's decision record reaches the guarded means with faults
    verdicts = step.faults is not None
    compress = step.compression
    comm_secs = tuple(q.section for q in aspec.sequences
                      if q.comm != PRIVATE)
    comp_of_sec = None
    if compress is not None:
        csecs = set(compress.sections or comm_secs)
        comp_of_sec = tuple(nm in csecs for nm in flat_spec.sections)
    policies = aspec.policies
    cadence = tuple(q.comm_every for q in aspec.sequences)
    n = len(policies)
    sch = exp.schedule
    hier_on = sch.hierarchy_period > 0
    is_global = round_idx % max(sch.hierarchy_period, 1) == 0
    has_mom = aspec.has_momentum
    events = 2 if has_mom else 1
    info["events"] = events

    exp_c = _Expect(data_size=data_size, use_scatter=shard.use_scatter,
                    m_local=m_local)

    def one_call(modes, mom: bool):
        for grp in flat_spec.groups:
            # the momenta live in f32 buffers whatever the variable dtype
            dtype = "float32" if mom else _dtype(grp.dtype)
            for mode, a, stop, comp, _ in flat._section_runs(
                    grp, modes, comp_of_sec):
                L = stop - a
                if mode == "none":
                    info["private_elems"].add(L)
                elif guarded:
                    exp_c.robust_run(L, dtype, robust, verdicts)
                else:
                    exp_c.mean_run(L, dtype, comp=comp,
                                   grouped=(mode == "group"),
                                   block=grp.block, compress=compress)

    # comm_buffers: one reduction a cadence class that reduces this round
    for mom in ((False, True) if has_mom else (False,)):
        for c in sorted(set(cadence)):
            live = tuple(i for i in range(n)
                         if cadence[i] == c and policies[i] != PRIVATE)
            if not live or round_idx % c:
                continue
            local = (hier_on and not is_global
                     and any(policies[i] == HIERARCHICAL for i in live))
            one_call(tuple("none" if i not in live else
                           "group" if local and policies[i] == HIERARCHICAL
                           else "mean" for i in range(n)), mom)

    # The oracle needs whole rows: each evaluation all-gathers every dtype
    # buffer's block over the model axis (sequences._whole_rows), even at
    # model size 1.  GSPMD inserts these into the reference's program at
    # compile time, so its jaxpr never shows them; the port issues them.
    oracles = 2 if aspec.kind == "storm" else 1
    for grp in flat_spec.groups:
        info["oracle_gathers"][(
            "all_gather", ("model",), False,
            _dtype(grp.dtype),
            m_local * (grp.padded // k))] += oracles
    exp_c.c.update(info["oracle_gathers"])
    info["telemetry"] = telemetry_collectives(run)
    exp_c.c.update(info["telemetry"])
    info["verdicts"] = exp_c.verdicts

    # per-event communicated payload elems (cadence-1 view, one chunk)
    modes_all = tuple("mean" if p != PRIVATE else "none" for p in policies)
    for grp in flat_spec.groups:
        for mode, a, stop, _, _ in flat._section_runs(grp, modes_all,
                                                       comp_of_sec):
            if mode != "none":
                info["comm_elems"] += stop - a
    return exp_c.c, info


def telemetry_collectives(run) -> Counter:
    """The collectives of one step's in-band telemetry passes on a mesh
    (``flat.section_norms``, ``section_drift``, ``quant_roundtrip_err``
    and ``health_screen`` with ``shard=``, as ``sequences.make_engine``
    calls them): each pass's f64 partial sums, one per section, are
    all-reduced over the model and then the data axis
    (``flat._mesh_sums``); drift first all-reduces its mean row's f32
    column sums over the data axis, a chunk of each section run at a
    time; the screen all-reduces each row's (non-finite count, squared
    norm) over the model axis and all-gathers them over the data axis."""
    from repro_torch.optim import flat

    groups = getattr(run.step, "telemetry_groups", ())
    shard = run.shard
    c: Counter = Counter()
    if not groups or shard is None:
        return c
    spec, step = run.step.spec, run.step
    m_local = run.spec.problem.num_clients // shard.data_size
    n_sec = len({int(s) for grp in spec.groups for s, _, _ in grp.extents})

    def sums(n: int) -> None:
        c[("psum", ("model",), False, "float64", n)] += 1
        c[("psum", ("data",), False, "float64", n)] += 1

    compress = step.compression
    if "drift" in groups:
        for grp in spec.groups:
            for runs in flat._section_cols(spec, grp, shard).values():
                for a, b in runs:
                    for c0, c1 in flat._chunks(a, b):
                        c[("psum", ("data",), False, "float32",
                           c1 - c0)] += 1
        sums(n_sec)
    if "compression" in groups and compress.quant is not None:
        sums(1)                                   # quant_err
    if "health" in groups and step.robustness is not None:
        c[("psum", ("model",), False, "float64", 2 * m_local)] += 1
        c[("all_gather", ("data",), False, "float64", 2 * m_local)] += 1
    if "norms" in groups:
        sums(n_sec)                               # upd_norm
        if step.aspec.has_momentum:
            sums(n_sec)                           # mom_norm
    if ("compression" in groups and compress.topk_frac > 0
            and compress.error_feedback):
        sums(n_sec)                               # ef_norm
    return c


def _fmt_entry(e: Entry, k: int) -> str:
    prim, axes, grouped, dtype, elems = e
    g = " grouped" if grouped else ""
    return f"{k}x {prim}[{dtype} x{elems} over {'/'.join(axes)}{g}]"


def state_at(run, round_idx: int):
    """The run's initial state with the step counter at the communication
    step of round ``round_idx``."""
    state = run.init(init_generator(run.device))
    return state._replace(
        step=round_idx * run.spec.schedule.local_steps - 1)


def step_collectives(run, round_idx: int) -> Counter:
    """The collectives one step issues at round ``round_idx``'s
    communication step, recorded on this rank."""
    state = state_at(run, round_idx)
    batch = run.place_batch(run.batch_fn(
        torch.Generator().manual_seed(TRACE_SEED)))
    with record_collectives(run.shard.mesh) as rec:
        run.step(state, batch)
    return rec.counter()


def audit_step_collectives(run) -> List[Finding]:
    """W101/W102 on one full step of a built run at the communication step
    of each of :func:`audit_rounds`, cross-checked against the analytic
    telemetry.comm plan.  A collective of every rank of the mesh: every
    rank calls it."""
    from repro_torch.telemetry.comm import comm_plan

    where = f"spec {run.spec.algorithm.name}"
    if run.shard is None:
        return []
    findings: List[Finding] = []
    _, info = expected_step_collectives(run)
    plan = comm_plan(run.step.spec, run.step.aspec, run.spec.compression)
    if plan is not None:
        shards = run.step.spec.shards
        plan_elems = sum(e for _, e, _, _ in plan.sections)
        if plan.reductions != info["events"] or \
                plan_elems != info["comm_elems"] * shards:
            findings.append(Finding(
                "W101", where,
                f"analytic comm plan disagrees with the section-extent "
                f"walk: plan {plan.reductions} reductions x {plan_elems} "
                f"elems vs {info['events']} events x "
                f"{info['comm_elems'] * shards} elems"))

    for r in audit_rounds(run):
        expected, info = expected_step_collectives(run, r)
        actual = step_collectives(run, r)
        at = "" if r == 1 else f" (round {r})"
        for e, k in sorted((actual - expected).items()):
            if e[4] in info["private_elems"]:
                findings.append(Finding(
                    "W102", where,
                    f"collective operand matches a PRIVATE section run"
                    f"{at}: {_fmt_entry(e, k)}"))
            else:
                findings.append(Finding(
                    "W101", where,
                    f"unplanned collective in the step{at}: "
                    f"{_fmt_entry(e, k)}"))
        for e, k in sorted((expected - actual).items()):
            findings.append(Finding(
                "W101", where,
                f"planned collective missing from the step{at}: "
                f"{_fmt_entry(e, k)}"))
    return findings


# ---------------------------------------------------------------------------
# wire side: the communication-only subprogram
# ---------------------------------------------------------------------------

def check_compressed_collectives(exp, flat_spec,
                                 coll: Dict[str, Any]) -> Dict[str, Any]:
    """Audit a compressed spec's recorded collectives against the analytic
    wire model: a quantized policy must move the reduction bytes in the
    narrow dtype.  Raises ``RuntimeError`` if it moved f32 instead (fail
    LOUDLY — that is a silent 4x comm regression).

    The comparison is per-dtype, not total: the criterion is that the
    narrow-dtype bytes cover what the compressed reductions analytically
    move — the per-shard-chunk extents of every compressed section at the
    quant's value width, for BOTH the variables and the momentum reduction
    of each comm event."""
    from repro_torch.optim.sequences import SPECS
    from repro_torch.telemetry.comm import compressed_chunk_elems
    cp = exp.compression
    narrow = {"bf16": ("bf16",), "int8": ("s8", "u8")}[cp.quant]
    aspec = SPECS[exp.algorithm.name]
    elems = compressed_chunk_elems(flat_spec, aspec, cp)
    vbytes = {"bf16": 2, "int8": 1}[cp.quant]
    reductions = 2 if aspec.has_momentum else 1
    expected = reductions * elems * vbytes      # one shard chunk each
    by_dtype = coll.get("bytes_by_dtype", {})
    narrow_b = sum(by_dtype.get(d, 0) for d in narrow)
    if narrow_b < 0.9 * expected:
        raise RuntimeError(
            f"compressed spec (quant={cp.quant!r}) moved f32 "
            f"collectives: the narrow-dtype collective bytes "
            f"({narrow_b} B in {narrow}) do not cover the analytic wire "
            f"model of the compressed reductions ({expected} B = "
            f"{reductions} reductions x {elems} elems x {vbytes} B) — "
            f"dtype breakdown: {by_dtype}")
    return {"ok": True, "narrow_bytes": narrow_b,
            "expected_bytes": expected, "bytes_by_dtype": by_dtype}


def expected_wire_bytes(expected: Counter, data_size: int) -> Dict[str, int]:
    """Result bytes by dtype (HLO tokens) the expected multiset of the
    communication subprogram implies.  Entries carry OPERAND elems; the
    recorder sums RESULT bytes, as the reference's HLO accounting does, so
    the scattered reduction shrinks by the data axis size and its gather
    grows by it."""
    out: Dict[str, int] = {}
    for (prim, _, _, dtype, elems), k in expected.items():
        n = elems
        if prim == "psum_scatter":
            n = elems // data_size
        elif prim == "all_gather":
            n = elems * data_size
        hd = _HLO_DTYPE.get(dtype, dtype)
        out[hd] = out.get(hd, 0) + k * n * _DTYPE_BYTES[dtype]
    return out


def comm_expected(run) -> Counter:
    """The expected entries of the communication-only subprogram: the
    step's, less the oracle's row gathers, the telemetry passes' and the
    verdict gathers (the subprogram keeps no decision record)."""
    expected, info = expected_step_collectives(run)
    return (expected - info["oracle_gathers"] - info["telemetry"]
            - info["verdicts"])


def audit_wire(run, coll: Optional[Dict[str, Any]] = None) -> List[Finding]:
    """W103/W104/W105 on the communication-only subprogram at the last of
    :func:`audit_rounds`.

    ``coll`` injects a precomputed :meth:`Record.wire` (tests); otherwise
    ``run.step.comm_fn`` runs here under :func:`record_collectives` (a
    collective of every rank of the mesh)."""
    where = f"spec {run.spec.algorithm.name}"
    comm_fn = getattr(run.step, "comm_fn", None)
    if run.shard is None or comm_fn is None:
        return []
    expected = comm_expected(run)
    if coll is None:
        state = state_at(run, audit_rounds(run)[-1])
        with record_collectives(run.shard.mesh) as rec:
            comm_fn(state)
        coll = rec.wire()
    findings: List[Finding] = []
    counts = coll.get("counts", {})

    # W105: resharding ops have no business between oracle and update
    for op in ("all-to-all", "collective-permute"):
        if counts.get(op, 0):
            findings.append(Finding(
                "W105", where,
                f"{counts[op]} {op} op(s) in the comm subprogram "
                f"({coll['bytes'][op]} B) — the reduction path resharded"))
    exp_gathers = sum(k for (p, *_), k in expected.items()
                      if p == "all_gather")
    if exp_gathers == 0 and counts.get("all-gather", 0):
        findings.append(Finding(
            "W105", where,
            f"{counts['all-gather']} all-gather op(s) in the comm "
            f"subprogram but the plan has none (no scatter-comm, no "
            f"trimmed mean)"))

    # W103: quantized policies must keep the narrow dtype on the wire
    cp = run.spec.compression
    if cp is not None and cp.quant is not None:
        try:
            check_compressed_collectives(run.spec, run.step.spec, coll)
        except RuntimeError as e:
            findings.append(Finding("W103", where, str(e)))

    # W104: byte-exact per dtype.  The recorder sees the dtype the port
    # hands to torch.distributed, so bf16 policies are held exactly too
    # (the reference skips them on the CPU, where XLA widens bf16 reduces).
    want = expected_wire_bytes(expected, run.shard.data_size)
    got = {d: b for d, b in coll.get("bytes_by_dtype", {}).items() if b}
    if want != got:
        findings.append(Finding(
            "W104", where,
            f"comm-subprogram collective bytes {got} != analytic model "
            f"{want}"))
    return findings
