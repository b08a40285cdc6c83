"""Evaluation utilities for federated bilevel training runs (counterpart of
``repro/federation/evaluate.py``).

Per-client and pooled metrics over held-out streams:

* ``perplexity`` — exp(CE) of the LM on a client's validation stream;
* ``personalisation_gain`` — Eq. (5) diagnostics: loss of client m's
  *own* head vs the average head on m's data (positive gain = the private
  lower-level solutions y^(m) are doing real per-client work — the paper's
  motivation for the local-lower formulation).

The reference's ``vmap`` over clients is a loop over clients here, as the
trainers' oracles are (``federation/trainer.py``, ``_over_clients``).
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Any, Dict

import torch

if TYPE_CHECKING:                   # the package imports this module first
    from repro_torch.models.registry import Model


def _loss(model: Model, body, head, batch) -> torch.Tensor:
    with torch.no_grad():
        loss, _ = model.loss({"body": body, "head": head}, batch)
    return loss


def _ppl(loss: torch.Tensor) -> torch.Tensor:
    """exp(min(loss, 20)) in f32, as the reference computes it."""
    loss = loss.to(torch.float32)
    return torch.exp(torch.minimum(loss, torch.full_like(loss, 20.0)))


def client_loss(model: Model, body, head, batch) -> float:
    return float(_loss(model, body, head, batch))  # analysis: ignore[L303] reporting


def perplexity(model: Model, body, head, batch) -> float:
    loss = torch.tensor(client_loss(model, body, head, batch))
    return float(_ppl(loss))  # analysis: ignore[L303] reporting


def eval_federated(model: Model, state, batch_fn, gen: torch.Generator, *,
                   num_clients: int) -> Dict[str, Any]:
    """Evaluate a federated train state (any of the trainers' pytree
    states: ``state.x``/``state.y``, or FedAvg's ``state.params``) on the
    validation half of ``batch_fn(gen)``.

    Returns pooled and per-client val loss/perplexity, plus the
    personalisation gain when heads are private (local-lower states)."""
    from repro_torch.core.tree_util import client_slice, tree_map

    batch = batch_fn(gen)
    if hasattr(state, "params"):          # FedAvg
        bodies, heads = state.params["body"], state.params["head"]
    else:
        bodies, heads = state.x, state.y
    val = batch["val"]

    # per-client loss of each client's own head on its own stream
    losses = torch.stack([
        _loss(model, client_slice(bodies, m), client_slice(heads, m),
              client_slice(val, m)) for m in range(num_clients)])
    # average head (what Eq. (1) would deploy) evaluated on each client
    avg_head = tree_map(lambda v: torch.mean(v, dim=0), heads)
    losses_avg = torch.stack([
        _loss(model, client_slice(bodies, m), avg_head, client_slice(val, m))
        for m in range(num_clients)])
    gains = losses_avg - losses

    assert losses.shape == (num_clients,), losses.shape
    return {
        "val_loss_mean": float(torch.mean(losses)),  # analysis: ignore[L303] reporting
        "val_loss_per_client": [round(v, 4) for v in losses.tolist()],
        "perplexity_mean": float(torch.mean(_ppl(losses))),  # analysis: ignore[L303] reporting
        "personalisation_gain_mean": float(torch.mean(gains)),  # analysis: ignore[L303] reporting
    }
