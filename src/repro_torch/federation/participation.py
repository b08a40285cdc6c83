"""Participation: client sampling, availability traces, staleness
(counterpart of ``repro/federation/participation.py``).

Each round's client mask is a pure function of the round index, drawn from
``repro_torch.random``'s Threefry keys ``fold_in(PRNGKey(seed), round)``, so
a resumed run reproduces the same participation sequence.  Masks are ``[M]``
f32 tensors on the CPU: the round index is the engine's host step counter,
the draws are a few dozen words, and the engine copies a mask to the
buffers' device where it gates a launch or zeroes a gradient.

The mask is threaded through the flat substrate and the engine:

* ``flat.client_mean_masked(..., weights=)``: the mean is over participants
  only; non-participants pass through bit for bit;
* ``flat.storm_partial_step`` / ``momentum_sgd_step`` / ``sgd_step`` with
  ``mask=``: non-participants' tile tables get lr = 0 and decay (β) pinned
  to 1, and ``flat.mask_buffers`` zeroes their oracle contributions, so
  their rows are frozen bit for bit inside the same launch;
* ``sequences.make_engine(..., participation=)``: per-round mask and
  weights, and per-client staleness counters on ``FlatState.stale``.

Samplers (``ParticipationSpec.sampler``):

``full``
    every client, every round;
``uniform``
    ``clients_per_round`` clients without replacement: the first m of
    ``permutation(fold_in(key0, r), M)``;
``weighted``
    ``clients_per_round`` clients without replacement, with inclusion
    probability by ``client_weights`` (Gumbel top-k on their logarithms);
    the weights also weight the reduction;
``trace``
    client m is up in round r when its uniform draw from
    ``fold_in(key0, r)`` is below ``availability_rate``; the
    ``min_clients`` clients with the smallest draws are always up.  With
    ``trace_path`` a recorded availability log (a JSON [R, M] 0/1 matrix, a
    list of rows or ``{"masks": [...]}``) is replayed instead, cyclically.

``uniform`` and ``trace`` equal the reference's masks bit for bit (their
draws do).  ``weighted`` rests on ``gumbel``, within a few ulps of the
reference's, so its mask can differ only where two clients' scores lie
within that bound of each other at the m-th place.

Staleness: a client that returns after missing k rounds is weighted by α^k,
α the spec's ``stale_discount`` (1.0: no discounting).  The reference's
per-sequence override (``Sequence.staleness``) is not ported: no spec sets
it.
"""
from __future__ import annotations

import json
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch import random as jr

SAMPLERS = ("full", "uniform", "weighted", "trace")


class ParticipationSpec(NamedTuple):
    """Declarative participation scenario."""
    sampler: str = "full"
    clients_per_round: int = 0        # m for uniform/weighted (0 → all M)
    client_weights: tuple | None = None   # per-client data sizes (len M)
    seed: int = 0                     # availability seed (fold_in'd per round)
    availability_rate: float = 0.7    # trace: P(client up in a round)
    min_clients: int = 1              # trace: floor on participants
    stale_discount: float = 1.0       # α for staleness discounting
    trace_path: str | None = None     # trace: recorded availability log


class Participation(NamedTuple):
    """A compiled spec: ``mask_fn(round) -> [M]`` f32 CPU tensor and the
    static per-client reduction weights."""
    spec: ParticipationSpec
    num_clients: int
    mask_fn: Any
    base_weights: torch.Tensor        # [M] f32: data-size weights (or ones)

    def round_weights(self, round_idx: int):
        """(mask, weights) of a round: weights = mask · base, zero for
        non-participants (what the weighted reductions consume)."""
        mask = self.mask_fn(round_idx)
        return mask, mask * self.base_weights


def _load_trace(path: str, num_clients: int, min_clients: int):
    """Recorded availability log → [R, M] f32 replay table.  Each row needs
    one entry per client and at least ``min_clients`` participants."""
    with open(path) as fh:
        payload = json.load(fh)
    rows = payload["masks"] if isinstance(payload, dict) else payload
    arr = np.asarray(rows, np.float32)  # analysis: ignore[L303] host trace file
    if arr.ndim != 2 or arr.shape[1] != num_clients:
        raise ValueError(
            f"availability trace {path}: expected an [R, {num_clients}] 0/1 "
            f"matrix (one row per round, one entry per client), got shape "
            f"{arr.shape}")
    if not np.all((arr == 0) | (arr == 1)):
        raise ValueError(f"availability trace {path}: entries must be 0/1")
    if not np.all(arr.sum(axis=1) >= min_clients):
        worst = int(np.argmin(arr.sum(axis=1)))
        raise ValueError(
            f"availability trace {path}: round {worst} has "
            f"{int(arr[worst].sum())} participants, below "
            f"min_clients={min_clients}")
    return torch.from_numpy(arr)


def _resolve_m(spec: ParticipationSpec, num_clients: int) -> int:
    m = spec.clients_per_round or num_clients
    if not 1 <= m <= num_clients:
        raise ValueError(
            f"clients_per_round={spec.clients_per_round} out of range for "
            f"M={num_clients}")
    return m


def _one_hot(idx: torch.Tensor, m: int) -> torch.Tensor:
    mask = torch.zeros(m, dtype=torch.float32)
    mask[idx.long()] = 1.0
    return mask


def make_participation(spec: ParticipationSpec | None,
                       num_clients: int) -> Participation | None:
    """Compile ``spec`` for ``num_clients`` clients (None passes through:
    the engine then runs its path without participation)."""
    if spec is None:
        return None
    if spec.sampler not in SAMPLERS:
        raise ValueError(f"unknown sampler {spec.sampler!r}; "
                         f"choose from {SAMPLERS}")
    if spec.trace_path is not None and spec.sampler != "trace":
        raise ValueError(
            f"trace_path is a sampler='trace' knob (got {spec.sampler!r})")
    M = num_clients
    if spec.client_weights is not None:
        if len(spec.client_weights) != M:
            raise ValueError(f"client_weights has {len(spec.client_weights)} "
                             f"entries for M={M}")
        base_w = torch.tensor(spec.client_weights, dtype=torch.float32)
        if not bool(torch.all(base_w > 0)):
            raise ValueError("client_weights must be positive")
    elif spec.sampler == "weighted":
        raise ValueError("sampler='weighted' requires client_weights "
                         "(per-client data sizes)")
    else:
        base_w = torch.ones(M, dtype=torch.float32)
    key0 = jr.PRNGKey(spec.seed)

    if spec.sampler == "full":
        def mask_fn(round_idx):
            del round_idx
            return torch.ones(M, dtype=torch.float32)

    elif spec.sampler == "uniform":
        m = _resolve_m(spec, M)

        def mask_fn(round_idx):
            perm = jr.permutation(jr.fold_in(key0, int(round_idx)), M)
            return _one_hot(perm[:m], M)

    elif spec.sampler == "weighted":
        m = _resolve_m(spec, M)
        logw = torch.log(base_w)

        def mask_fn(round_idx):
            # Gumbel top-k == weighted sampling without replacement
            scores = logw + jr.gumbel(jr.fold_in(key0, int(round_idx)), (M,))
            return _one_hot(torch.topk(scores, m).indices, M)

    elif spec.sampler == "trace" and spec.trace_path is not None:
        if spec.clients_per_round:
            raise ValueError(
                "a recorded availability log drives participation directly — "
                "clients_per_round has no effect; unset it")
        if not 1 <= spec.min_clients <= M:
            raise ValueError(f"min_clients={spec.min_clients} out of range "
                             f"for M={M}")
        table = _load_trace(spec.trace_path, M, spec.min_clients)

        def mask_fn(round_idx):
            return table[int(round_idx) % table.shape[0]].clone()

    else:  # trace (synthetic availability process)
        if spec.clients_per_round:
            raise ValueError(
                "the trace sampler draws participation from the availability "
                "process (availability_rate / min_clients) — "
                "clients_per_round has no effect; unset it or use "
                "uniform/weighted")
        if not 1 <= spec.min_clients <= M:
            raise ValueError(f"min_clients={spec.min_clients} out of range "
                             f"for M={M}")
        floor = spec.min_clients
        rate = torch.tensor(spec.availability_rate, dtype=torch.float32)

        def mask_fn(round_idx):
            u = jr.uniform(jr.fold_in(key0, int(round_idx)), (M,))
            up = (u < rate).to(torch.float32)
            # the floor: the min_clients clients with the smallest draws
            return torch.maximum(up, _one_hot(torch.topk(-u, floor).indices,
                                              M))

    return Participation(spec, M, mask_fn, base_w)


def expected_comm_fraction(part: Participation | None,
                           num_rounds: int = 64) -> float:
    """Mean fraction of clients entering the reduction per round over the
    first ``num_rounds`` rounds of the actual trace (the comm-volume model's
    m/M factor).  The sum is of 0/1 values, so exact; like ``jnp.mean`` it
    is then multiplied by the f32 reciprocal of the count."""
    if part is None:
        return 1.0
    masks = torch.stack([part.mask_fn(r) for r in range(num_rounds)])
    inv = torch.tensor(1.0 / masks.numel(), dtype=torch.float32)
    return float(masks.sum() * inv)
