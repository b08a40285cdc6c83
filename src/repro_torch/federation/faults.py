"""Fault engine: deterministic failure injection, robustness policy, rollback
(counterpart of ``repro/federation/faults.py``).

* :class:`FaultSpec` — what goes wrong: per-round, per-client dropout (the
  client computes but never delivers), NaN-corrupted sends and scaled
  ("byzantine") sends.  :func:`make_faults` compiles it into
  ``round_masks(round, retry) -> (keep, nan, byz)``, [M] f32 CPU tensors
  drawn from ``repro_torch.random``'s Threefry key
  ``fold_in(fold_in(PRNGKey(seed), round), retry)``, bit for bit the
  reference's masks.  Like the participation masks they are drawn on the
  host: the round is the engine's host step counter and the retry count
  rides ``FlatState.retry`` on the CPU.  The engine multiplies ``keep``
  into the launch mask and the weights (a dropped client is frozen like a
  non-participant) and hands ``(nan, byz, byzantine_scale)`` to the
  reductions, which corrupt what the clients send
  (``flat.client_mean_masked(..., corrupt=)``).
* :class:`RobustnessSpec` — what the server does about it: the health
  screen and the robust aggregator (``mean``, ``clip``, ``trim``), lowered
  to ``flat.RobustCfg`` by the engine, and the rollback policy
  (``spike_factor``, ``retry_budget``, ``ring``) that
  :class:`RollbackGuard` applies.
* :class:`RollbackGuard` — last-known-good rollback.  The train loop
  snapshots (step, state, batch stream, loss) at healthy evaluations into a
  ring; a non-finite loss, or one above ``spike_factor`` × the last good
  one, copies the newest snapshot back into the live state, bumps
  ``FlatState.retry`` (so the retried rounds redraw their fault masks) and
  re-seeds the batch stream from the retry count (so they draw new
  batches), until ``retry_budget`` rollbacks are spent and
  :class:`RollbackError` is raised.

The ring holds host copies of the state: the card never holds a second
copy of it, and a rollback copies the snapshot into the live state's
tensors in place, as ``checkpoint.load_checkpoint`` does.

Departure from the reference (ROADMAP queue 3): the reference folds the
retry count into its JAX batch key.  The port's batches come from a CPU
``torch.Generator``; its snapshot keeps the generator's state, and a
rollback restores that state and then re-seeds the generator from a word
it draws and the retry count (``_reseed``), so the retried rounds draw
batches the first attempt did not, and a rerun draws the same ones.
"""
from __future__ import annotations

import collections
import math
from typing import Any, NamedTuple

import torch

from repro_torch import random as jr

AGGREGATORS = ("mean", "clip", "trim")


class FaultSpec(NamedTuple):
    """Declarative per-round client fault process.

    Each rate is an independent per-(round, client) Bernoulli probability.
    A dropped client sends nothing (it is masked out like a
    non-participant); a corrupted client's communicated rows are replaced
    with NaN; a byzantine client's are scaled by ``byzantine_scale``.
    ``start_round`` delays injection (clean warmup rounds)."""
    dropout_rate: float = 0.0
    nan_rate: float = 0.0
    byzantine_rate: float = 0.0
    byzantine_scale: float = 10.0
    seed: int = 0
    start_round: int = 0


class RobustnessSpec(NamedTuple):
    """Declarative guard policy.

    ``screen`` enables the per-client health mask (non-finite check and
    update-norm z-score with threshold ``z_thresh`` over the round's
    participants; ``z_thresh = 0`` keeps the finite check only).
    ``aggregator``: ``"mean"`` (participants-only weighted mean, bit for
    bit the unguarded mean when every client is healthy), ``"clip"``
    (per-client norm clipping to ``clip_factor`` × the healthy mean norm
    before the mean) or ``"trim"`` (coordinate-wise ``trim_frac``-trimmed
    mean).  ``spike_factor``, ``retry_budget`` and ``ring`` parameterize
    :class:`RollbackGuard`."""
    aggregator: str = "mean"
    screen: bool = True
    z_thresh: float = 3.0
    clip_factor: float = 2.0
    trim_frac: float = 0.2
    spike_factor: float = 10.0
    retry_budget: int = 3
    ring: int = 2


class Faults(NamedTuple):
    """A compiled :class:`FaultSpec`: ``round_masks(round, retry=0)``
    returns the round's ``(keep, nan, byz)``, each [M] f32 in {0, 1} on the
    CPU."""
    spec: FaultSpec
    num_clients: int
    round_masks: Any


def make_faults(spec: FaultSpec | None, num_clients: int) -> Faults | None:
    """Compile ``spec`` for ``num_clients`` clients (None passes through)."""
    if spec is None:
        return None
    for name in ("dropout_rate", "nan_rate", "byzantine_rate"):
        r = getattr(spec, name)
        if not 0.0 <= r <= 1.0:
            raise ValueError(f"FaultSpec.{name}={r} must be in [0, 1]")
    M = num_clients
    key0 = jr.PRNGKey(spec.seed)
    rates = torch.tensor([spec.dropout_rate, spec.nan_rate,
                          spec.byzantine_rate], dtype=torch.float32)

    def round_masks(round_idx, retry=0):
        k = jr.fold_in(jr.fold_in(key0, int(round_idx)), int(retry))
        below = (jr.uniform(k, (3, M)) < rates[:, None]).to(torch.float32)
        active = float(int(round_idx) >= spec.start_round)
        keep = 1.0 - below[0] * active
        # a dropped client sends nothing, so it cannot also corrupt; a NaN
        # client's rows are already garbage, so byzantine scaling is moot
        nan = below[1] * active * keep
        byz = below[2] * active * keep * (1.0 - nan)
        return keep, nan, byz

    return Faults(spec, M, round_masks)


# ---------------------------------------------------------------------------
# Rollback: last-known-good ring + retry budget
# ---------------------------------------------------------------------------

class RollbackError(RuntimeError):
    """The run cannot make progress: retry budget exhausted (or no good
    state to roll back to).  The message names the offending step."""


def _host_copy(state, into=None):
    """The state's tensors copied to the host (into ``into``'s tensors, a
    host copy of the same structure, when given); other leaves as they
    are."""
    # imported here: repro_torch.core imports the api, whose spec imports
    # this module
    from repro_torch.core.tree_util import tree_flatten
    leaves, treedef = tree_flatten(state)
    if into is None:
        out = [t.detach().to("cpu", copy=True) if torch.is_tensor(t) else t
               for t in leaves]
    else:
        out = tree_flatten(into)[0]
        for i, t in enumerate(leaves):
            if torch.is_tensor(t):
                out[i].copy_(t)
            else:
                out[i] = t
    return treedef.unflatten(out)


def _restore(live, snap):
    """Copy the snapshot's tensors into ``live``'s in place (on their
    device) and return ``live``'s structure with them and the snapshot's
    other leaves (a ``FlatState``'s host step)."""
    from repro_torch.core.tree_util import tree_flatten
    leaves, treedef = tree_flatten(live)
    saved, saved_def = tree_flatten(snap)
    if str(saved_def) != str(treedef):
        raise ValueError("the live state's structure differs from the "
                         "snapshot's")
    out = []
    for t, s in zip(leaves, saved):
        if torch.is_tensor(t) and torch.is_tensor(s):
            t.copy_(s)
            out.append(t)
        else:
            out.append(s)
    return treedef.unflatten(out)


def _reseed(gen: torch.Generator, retries: int) -> None:
    """Re-seed the restored batch stream for retry ``retries``: a word drawn
    from the restored stream (which fixes the seed and the step) folded with
    the retry count through ``repro_torch.random``, so a rerun of the same
    run re-seeds alike."""
    word = int(torch.randint(0, 1 << 31, (), generator=gen))  # analysis: ignore[L303] host draw
    hi, lo = (int(v) for v in jr.bits(jr.fold_in(jr.PRNGKey(word), retries),  # analysis: ignore[L304] retry re-seed
                                      (2,)))
    gen.manual_seed((hi << 31) ^ lo)


class RollbackGuard:
    """Host-side rollback driver for the train loop.

    At each evaluation the loop calls :meth:`observe` with the eval loss;
    the guard either snapshots (returning ``None``) or, on a non-finite
    loss or a spike beyond ``spike_factor`` × the last good loss, rolls
    back, returning ``(step, state, key)`` to resume from.  ``state`` is
    the live state passed in, its tensors overwritten in place with the
    snapshot's and its ``retry`` slot (when the fault engine gave it one)
    set to the new retry count; ``key`` is the batch stream (a
    ``torch.Generator``, or whatever the caller passed), restored and
    re-seeded (:func:`_reseed`).  Raises :class:`RollbackError` when the
    budget runs out.

    Snapshots are host copies (``ring`` of them at most: once the ring is
    full the oldest one's host tensors are reused), so the device never
    holds a second state."""

    def __init__(self, spec: RobustnessSpec):
        if spec.retry_budget < 0:
            raise ValueError(f"retry_budget={spec.retry_budget} must be >= 0")
        self.spec = spec
        self._good = collections.deque(maxlen=max(int(spec.ring), 1))
        self.retries = 0            # total rollbacks taken (monotone)
        self.rollback_steps: list = []   # steps at which we rolled back

    def is_healthy(self, loss: float) -> bool:
        if not math.isfinite(float(loss)):
            return False
        if not self._good:
            return True
        return float(loss) <= self.spec.spike_factor * self._good[-1][3]

    def observe(self, step: int, state, key, loss: float):
        """Snapshot a healthy (step, state, key, loss) and return ``None``,
        or roll back and return the ``(step, state, key)`` to resume from."""
        if self.is_healthy(loss):
            into = (self._good.popleft()[1]
                    if len(self._good) == self._good.maxlen else None)
            gen = (key.get_state().clone() if isinstance(key, torch.Generator)
                   else key)
            self._good.append((int(step), _host_copy(state, into), gen,
                               float(loss)))
            return None
        return self._rollback(step, state, key, loss)

    def _rollback(self, step: int, state, key, loss: float):
        round_no = self.rollback_steps  # for the error message below
        if not self._good:
            raise RollbackError(
                f"eval loss {loss} at step {step} is unhealthy and no "
                f"known-good state exists to roll back to (the run was bad "
                f"from the start) — fix the spec, or relax "
                f"RobustnessSpec.spike_factor")
        if self.retries >= self.spec.retry_budget:
            raise RollbackError(
                f"eval loss {loss} at step {step} after exhausting the "
                f"retry budget ({self.spec.retry_budget}; rollbacks at "
                f"steps {round_no}) — the fault process is overwhelming "
                f"the guards; raise retry_budget, enable/strengthen the "
                f"health screen, or lower the fault rate")
        self.retries += 1
        self.rollback_steps.append(int(step))
        good_step, snap, saved_key, _ = self._good[-1]
        state = _restore(state, snap)
        # fresh randomness for the retried rounds: the batch stream and the
        # fault draws (via the state's retry slot)
        if isinstance(key, torch.Generator):
            key.set_state(saved_key)
            _reseed(key, self.retries)
        else:
            key = saved_key
        if hasattr(state, "retry") and not isinstance(state.retry, tuple):
            state = state._replace(
                retry=torch.tensor(self.retries, dtype=torch.int32))
        return good_step, state, key
