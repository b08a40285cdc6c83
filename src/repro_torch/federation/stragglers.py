"""Stragglers: deadline-driven elastic rounds (counterpart of
``repro/federation/stragglers.py``).

A synchronous round waits for every sampled client, so its clock is the
slowest of a heavy-tailed set of compute times.  An elastic round
over-provisions the sample, closes at a deadline, averages whoever arrived
and routes the rest by a late-arrival policy:

* per-(round, client) compute times are lognormal,
  ``base_time · exp(tail · z)`` with ``z`` standard normal from
  ``repro_torch.random``'s Threefry key ``fold_in(fold_in(PRNGKey(seed),
  round), client)``, so a resumed run sees the same times;
* :func:`make_stragglers` compiles a :class:`StragglerSpec` into
  ``round_decision(round, sampled, deadline) -> (arrivals, eff, ext,
  next_deadline)``: the sampled clients whose time beats the effective
  deadline; the deadline after quorum extensions through the capped ladder
  ``deadline · backoff^k``, or, when even the last rung misses quorum, the
  quorum-th order statistic of the times (so arrivals ≥ quorum on every
  round); the extension count (``max_extensions + 1`` marks the fallback);
  and the next round's deadline, an EMA toward this round's
  ``target_percentile`` time.  Rounds before ``start_round`` stay
  synchronous.
* late-arrival policies (``sequences.make_engine(..., stragglers=)``): the
  mean averages arrivals only; ``drop`` freezes a straggler's rows like a
  non-participant's and ages its staleness counter, ``carry`` lets its rows
  advance and ages it, ``cancel`` freezes them and does not age it.

Everything is computed on the host in f32, in the reference's operation
order: times are ``[M]`` f32 CPU tensors, as participation's masks are, and
the decision reads no device.  The draws are not bitwise with the
reference's (``normal`` is within a few ulps of ``jax.random.normal``, and
``exp`` may differ by an ulp), so a decision can differ only where a time
lies within that bound of a rung or of another time.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch import random as jr

LATE_POLICIES = ("drop", "carry", "cancel")

#: bins of the per-round arrival histogram: arrival time over effective
#: deadline, 8 bins of width 0.25 covering [0, 2x); the last bin is open.
ARRIVAL_HIST_BINS = 8


class StragglerSpec(NamedTuple):
    """Declarative straggler process and elastic-round policy.

    ``base_time`` is the median compute time (simulated seconds), ``tail``
    the lognormal sigma; ``deadline`` the initial round deadline;
    ``over_provision`` extra clients requested from a counted sampler;
    ``quorum`` the least accepted fraction of the round's sampled clients;
    ``backoff`` / ``max_extensions`` the quorum-miss ladder;
    ``late_policy`` one of :data:`LATE_POLICIES`; ``target_percentile`` /
    ``adapt_rate`` the adaptive deadline EMA (rate 0: static);
    ``start_round`` the first elastic round."""
    base_time: float = 1.0
    tail: float = 1.0
    deadline: float = 2.0
    over_provision: int = 2
    quorum: float = 0.5
    late_policy: str = "drop"
    backoff: float = 1.5
    max_extensions: int = 2
    target_percentile: float = 0.9
    adapt_rate: float = 0.2
    seed: int = 0
    start_round: int = 0


class Stragglers(NamedTuple):
    """A compiled :class:`StragglerSpec`: ``round_times(round)`` → [M] f32,
    ``round_decision(round, sampled, deadline)`` → ``(arrivals [M] f32 in
    {0, 1}, eff 0-d f32, ext 0-d int32, next_deadline 0-d f32)``, and
    ``quorum_count(sampled)`` → the round's quorum (0-d int32); all CPU
    tensors."""
    spec: StragglerSpec
    num_clients: int
    round_times: Any
    round_decision: Any
    quorum_count: Any


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32).cpu()


def make_stragglers(spec: StragglerSpec | None,
                    num_clients: int) -> Stragglers | None:
    """Compile ``spec`` for ``num_clients`` clients (None passes through:
    the engine then runs its path without stragglers)."""
    if spec is None:
        return None
    if spec.late_policy not in LATE_POLICIES:
        raise ValueError(f"StragglerSpec.late_policy={spec.late_policy!r} "
                         f"must be one of {LATE_POLICIES}")
    if not float(spec.base_time) > 0.0:
        raise ValueError(f"StragglerSpec.base_time={spec.base_time} "
                         f"must be > 0")
    if float(spec.tail) < 0.0:
        raise ValueError(f"StragglerSpec.tail={spec.tail} must be >= 0")
    if not float(spec.deadline) > 0.0:
        raise ValueError(f"StragglerSpec.deadline={spec.deadline} must be > 0")
    if int(spec.over_provision) < 0:
        raise ValueError(f"StragglerSpec.over_provision={spec.over_provision} "
                         f"must be >= 0")
    if not 0.0 < float(spec.quorum) <= 1.0:
        raise ValueError(f"StragglerSpec.quorum={spec.quorum} must be in "
                         f"(0, 1] (a fraction of the round's sampled clients)")
    if float(spec.backoff) < 1.0:
        raise ValueError(f"StragglerSpec.backoff={spec.backoff} must be >= 1")
    if int(spec.max_extensions) < 0:
        raise ValueError(f"StragglerSpec.max_extensions="
                         f"{spec.max_extensions} must be >= 0")
    if not 0.0 < float(spec.target_percentile) <= 1.0:
        raise ValueError(f"StragglerSpec.target_percentile="
                         f"{spec.target_percentile} must be in (0, 1]")
    if not 0.0 <= float(spec.adapt_rate) <= 1.0:
        raise ValueError(f"StragglerSpec.adapt_rate={spec.adapt_rate} must "
                         f"be in [0, 1]")
    if int(spec.start_round) < 0:
        raise ValueError(f"StragglerSpec.start_round={spec.start_round} "
                         f"must be >= 0")
    M = num_clients
    key0 = jr.PRNGKey(spec.seed)
    base, tail = _f32(spec.base_time), _f32(spec.tail)
    quorum, pct = _f32(spec.quorum), _f32(spec.target_percentile)
    keep, rate = _f32(1.0 - spec.adapt_rate), _f32(spec.adapt_rate)
    n_rungs = int(spec.max_extensions) + 1
    ladder = _f32(spec.backoff) ** torch.arange(n_rungs, dtype=torch.float32)

    def round_times(round_idx) -> torch.Tensor:
        k = jr.fold_in(key0, int(round_idx))
        keys = torch.stack([jr.fold_in(k, c) for c in range(M)])
        z = torch.stack(jr.normals(keys, [()] * M))
        return base * torch.exp(tail * z)

    def quorum_count(sampled) -> torch.Tensor:
        n = (_f32(sampled) > 0).to(torch.float32).sum()
        return torch.clamp_min(torch.ceil(quorum * n), 1.0).to(torch.int32)

    def round_decision(round_idx, sampled, deadline):
        sampled, deadline = _f32(sampled), _f32(deadline)
        if int(round_idx) < spec.start_round:
            # warmup rounds stay synchronous: everyone sampled arrives
            return (sampled.clone(), _f32(0.0),
                    torch.tensor(0, dtype=torch.int32), deadline.clone())
        on = sampled > 0
        t_eff = torch.where(on, round_times(round_idx), torch.inf)
        q = int(quorum_count(sampled))
        sorted_t = torch.sort(t_eff).values
        # the capped ladder deadline · backoff^k, k = 0 .. max_extensions;
        # the first rung that collects the quorum closes the round, else
        # the quorum-th order statistic does
        cands = deadline * ladder
        ok = (t_eff[None, :] <= cands[:, None]).sum(dim=1) >= q
        if bool(ok.any()):
            first = int(torch.argmax(ok.to(torch.int32)))  # analysis: ignore[L303] host decision
            eff, ext = cands[first], first
        else:
            eff, ext = sorted_t[max(q - 1, 0)], n_rungs
        arrivals = (t_eff <= eff).to(torch.float32)
        # adaptive controller: EMA toward the target-percentile time
        n = on.to(torch.float32).sum()
        i_p = torch.minimum(torch.clamp_min(torch.ceil(pct * n), 1.0), n)
        t_p = sorted_t[int(i_p) - 1]
        next_dl = keep * deadline + rate * t_p
        return (arrivals, eff.clone(), torch.tensor(ext, dtype=torch.int32),
                next_dl)

    return Stragglers(spec, M, round_times, round_decision, quorum_count)


def over_provision(spec: StragglerSpec, pspec, num_clients: int):
    """The participation spec an elastic round requests: a counted sampler
    (uniform, weighted) asks for ``min(M, m + over_provision)`` clients;
    full and trace samplers, and no sampler, pass through."""
    if pspec is None or int(spec.over_provision) <= 0:
        return pspec
    if getattr(pspec, "sampler", None) not in ("uniform", "weighted"):
        return pspec
    m = int(pspec.clients_per_round) or num_clients
    return pspec._replace(
        clients_per_round=min(num_clients, m + int(spec.over_provision)))


def arrival_histogram(times, arrivals_deadline, sampled) -> torch.Tensor:
    """[ARRIVAL_HIST_BINS] f32 histogram of the round's sampled compute
    times relative to the effective deadline: bin i counts sampled clients
    with ``t / deadline`` in ``[0.25 i, 0.25 (i + 1))`` (last bin open),
    the in-band arrival shape behind the ``deadline`` telemetry event.  On
    the host in f32, as the reference computes it."""
    times = _f32(times)
    ratio = times / torch.clamp_min(_f32(arrivals_deadline), 1e-12)
    idx = torch.clamp(torch.floor(ratio * 4.0), 0, ARRIVAL_HIST_BINS - 1)
    on = (_f32(sampled) > 0).to(torch.float32)
    return torch.zeros(ARRIVAL_HIST_BINS, dtype=torch.float32).index_add_(
        0, idx.to(torch.int64), on)


def simulate_rounds(strag: Stragglers, part, num_rounds: int) -> list:
    """The elastic round clock replayed on the host with the same
    :func:`round_decision` the engine runs, the adaptive deadline threaded
    through.  Per round: ``deadline`` (effective), ``wall_clock`` (the
    simulated round, ``min(deadline, slowest sampled time)``),
    ``wait_for_slowest`` (what a synchronous barrier takes), ``arrivals``,
    ``sampled``, ``quorum`` and ``extensions``.  Simulated seconds, not a
    measurement."""
    M = strag.num_clients
    dl = _f32(strag.spec.deadline)
    rows = []
    for r in range(num_rounds):
        if part is not None:
            sampled, _ = part.round_weights(r)
        else:
            sampled = torch.ones(M, dtype=torch.float32)
        arrivals, eff, ext, next_dl = strag.round_decision(r, sampled, dl)
        t = strag.round_times(r)
        slow = float(torch.max(torch.where(sampled > 0, t, -torch.inf)))  # analysis: ignore[L303] reporting
        eff_f = float(eff)
        active = r >= strag.spec.start_round
        rows.append({
            "round": r,
            "deadline": round(eff_f, 6),
            "wall_clock": round(min(eff_f, slow) if active else slow, 6),
            "wait_for_slowest": round(slow, 6),
            "arrivals": int(torch.sum(arrivals > 0)),  # analysis: ignore[L303] reporting
            "sampled": int(torch.sum(sampled > 0)),  # analysis: ignore[L303] reporting
            "quorum": int(strag.quorum_count(sampled)),
            "extensions": int(ext),
        })
        dl = next_dl
    return rows

