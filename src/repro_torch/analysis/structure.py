"""Bare-state / step-trace auditor, the ``S2xx`` rules (counterpart of
``repro/analysis/structure.py``).

The engine's feature contract is structural: every optional layer
(participation, faults, robustness, compression, telemetry, stragglers,
mesh/overlap, cadences) must vanish WITHOUT RESIDUE when its knob is off —
zero extra state leaves (S201), and a step identical to the pre-feature
factory build (S202) rather than merely numerically close.

The reference proves this on jaxprs traced from abstract shapes.  The port
has no abstract trace (its engine decides rounds on the host and launches
kernels through ``ctypes``), so it RUNS one step at the spec's own size
under a recorder: the **step trace** is ``init`` and one communication step
recorded as ``(ATen op, operand dtypes and shapes)`` in dispatch order,
followed by the calls of each kernel wrapper over the step (on the card
the kernels go through ``ctypes`` and no dispatch sees them; the counts put
them into the trace).  The text holds no address, timing or tensor value,
so two builds of the same program record the same text.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.rules import Finding

#: the edits that switch every optional layer off — what remains is the
#: pre-feature baseline an unadorned factory call builds
BARE_EDITS = {
    # all three participation knobs: ``normalize()`` promotes a full
    # sampler with a nonzero clients_per_round (or a trace_path) back to
    # uniform/trace, so the bare form must clear the promotion triggers too
    "participation.sampler": "full",
    "participation.clients_per_round": 0,
    "participation.trace_path": None,
    "faults": None, "robustness": None, "compression": None,
    "telemetry": None, "stragglers": None,
    "execution.mesh": None, "execution.overlap": False,
    "execution.scatter_comm": False,
    "schedule.comm_every": (),
}

#: the generator seed of the audited init and batch
TRACE_SEED = 0


def bare_spec(exp):
    """``exp`` with every optional feature off (still validates)."""
    return exp.edit(**BARE_EDITS)


def _meta(t: torch.Tensor) -> str:
    return f"{t.dtype}{list(t.shape)}"


class _Trace(TorchDispatchMode):
    """Records each dispatched ATen op with its tensor operands' dtypes
    and shapes."""

    def __init__(self, lines: List[str]):
        super().__init__()
        self.lines = lines

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = []
        for a in (*args, *kwargs.values()):
            if isinstance(a, torch.Tensor):
                ins.append(_meta(a))
            elif isinstance(a, (list, tuple)):
                ins.extend(_meta(t) for t in a if isinstance(t, torch.Tensor))
        self.lines.append(f"{func}({', '.join(ins)})")
        return func(*args, **kwargs)


def kernel_calls() -> Dict[str, int]:
    """Every kernel wrapper's call count (on any device), by name."""
    from repro_torch.kernels.flash import ops as flash_ops
    from repro_torch.kernels.lru import ops as lru_ops
    from repro_torch.kernels.storm import kernel, quantpack
    out: Dict[str, int] = {}
    for calls in (kernel.CALLS, quantpack.CALLS, lru_ops.CALLS,
                  flash_ops.CALLS):
        out.update(calls)
    return out


def init_generator(device) -> torch.Generator:
    """The generator of the audited init: seeded :data:`TRACE_SEED`, on
    the run's device (the trainers draw their initial state there)."""
    return torch.Generator(device=device).manual_seed(TRACE_SEED)


def step_jaxpr_str(init, step, batch_fn, *, local_steps: int, device,
                   place_batch=None, round_idx: int = 1) -> str:
    """The step trace: ``init`` on :func:`init_generator`, then the
    communication step of round ``round_idx`` on a batch drawn from a CPU
    generator of the same seed (the stream's own), recorded op by op, then
    the kernel wrappers' calls over both.  Two builds of the same program
    give the same text."""
    before = kernel_calls()
    lines: List[str] = ["init:"]
    with _Trace(lines):
        state = init(init_generator(device))
    batch = batch_fn(torch.Generator().manual_seed(TRACE_SEED))
    if place_batch is not None:
        batch = place_batch(batch)
    # the step counter of round ``round_idx``'s communication step
    state = state._replace(step=round_idx * local_steps - 1)
    lines.append("step:")
    with _Trace(lines):
        step(state, batch)
    after = kernel_calls()
    lines.append("kernels: " + " ".join(
        f"{k}={after[k] - before.get(k, 0)}" for k in sorted(after)))
    return "\n".join(lines)


def run_trace(run) -> str:
    """:func:`step_jaxpr_str` of a built run."""
    return step_jaxpr_str(run.init, run.step, run.batch_fn,
                          local_steps=run.spec.schedule.local_steps,
                          device=run.device, place_batch=run.place_batch)


def jaxpr_diff(a: str, b: str) -> str:
    """First structural divergence of two step traces, for rule
    messages."""
    la, lb = a.splitlines(), b.splitlines()
    if len(la) != len(lb):
        pre = f"{len(la)} vs {len(lb)} trace lines; "
    else:
        pre = ""
    for i, (x, y) in enumerate(zip(la, lb)):
        if x != y:
            return (f"{pre}first divergence at trace line {i + 1}: "
                    f"{x.strip()!r} vs {y.strip()!r}")
    return pre + "one trace is a prefix of the other"


def _fused(run) -> bool:
    return hasattr(run.step, "spec")


def audit_state_slots(run, state=None) -> List[Finding]:
    """S201: FlatState optional slots present iff their feature is on
    (``state``: the run's initial state, drawn here if not given)."""
    exp = run.spec
    where = f"spec {exp.algorithm.name}"
    if not _fused(run):
        return []                       # unfused path: no FlatState
    if state is None:
        state = run.init(init_generator(run.device))
    cp = exp.compression
    expect = {
        "stale": run.participation is not None or exp.stragglers is not None,
        "retry": exp.faults is not None,
        "ef": (cp is not None and cp.topk_frac > 0
               and bool(cp.error_feedback)),
        "deadline": exp.stragglers is not None,
    }
    findings: List[Finding] = []
    for slot, on in expect.items():
        empty = isinstance(getattr(state, slot), tuple) and \
            getattr(state, slot) == ()
        if on and empty:
            findings.append(Finding(
                "S201", where,
                f"feature expects a `{slot}` state leaf but the built "
                f"state carries ()"))
        elif not on and not empty:
            findings.append(Finding(
                "S201", where,
                f"`{slot}` state leaf present with its feature off — "
                f"the zero-leaf contract is broken"))
    return findings


def reference_pair(exp, model):
    """The pre-feature baseline: the registered factory invoked with ONLY
    the core execution knobs — no participation/mesh/overlap/cadence/
    faults/robustness/compression/telemetry/stragglers kwargs at all."""
    from repro_torch.api import registry
    from repro_torch.api.build import federated_config

    entry = registry.get(exp.algorithm.name)
    _, factory_kw = entry.split_params(exp.algorithm.params_dict)
    ex = exp.execution
    return entry.factory(
        model, federated_config(exp), n_micro=ex.n_micro, remat=ex.remat,
        use_flash=ex.use_flash, use_lru_kernel=ex.use_lru_kernel,
        fuse_oracles=ex.fuse_oracles, fuse_storm=ex.fuse_storm,
        storm_block=ex.storm_block, **factory_kw)


def audit_bare_jaxpr(exp, cache: Optional[Dict[str, Any]] = None, *,
                     device=None) -> List[Finding]:
    """S202: the all-features-off build of ``exp`` records a step trace
    identical to the pre-feature factory build's.  ``cache`` (keyed by the
    bare spec's JSON) dedupes across committed specs sharing a bare
    form."""
    from repro_torch.api.build import build

    bare = bare_spec(exp)
    key = bare.to_json()
    if cache is not None and key in cache:
        return list(cache[key])
    run = build(bare, device=device)
    findings: List[Finding] = []
    if _fused(run):
        got = run_trace(run)
        ref_init, ref_step = reference_pair(run.spec, run.model)
        want = step_jaxpr_str(ref_init, ref_step, run.batch_fn,
                              local_steps=run.spec.schedule.local_steps,
                              device=run.device)
        if got != want:
            findings.append(Finding(
                "S202", f"spec {exp.algorithm.name}",
                f"feature-off step is not the pre-feature baseline: "
                f"{jaxpr_diff(got, want)}"))
    if cache is not None:
        cache[key] = tuple(findings)
    return findings


def audit_telemetry_inert(exp, *, device=None) -> List[Finding]:
    """S203: events-only telemetry (metrics=()) records the identical step
    trace as telemetry=None — only specs carrying a telemetry block are
    checked."""
    from repro_torch.api.build import build

    if exp.telemetry is None:
        return []
    run_ev = build(exp.edit(**{"telemetry.metrics": ()}), device=device)
    run_off = build(exp.edit(telemetry=None), device=device)
    if not (_fused(run_ev) and _fused(run_off)):
        return []
    a, b = run_trace(run_ev), run_trace(run_off)
    if a == b:
        return []
    return [Finding(
        "S203", f"spec {exp.algorithm.name}",
        f"events-only telemetry perturbs the step trace: "
        f"{jaxpr_diff(a, b)}")]
