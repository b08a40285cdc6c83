"""Fair Federated Learning as a bilevel problem (paper §5 conclusion; the
port of ``examples/fair_federated_learning.py``).

Two of eight clients come from a minority distribution; uniform federated
training under-serves them.  The upper level learns client weights λ that
minimise a smooth-max of client risks with FedBiO — the worst-served client
improves and the minority gets up-weighted.

    PYTHONPATH=src python -m repro_torch.examples.fair_federated_learning \\
        [--device cpu]

The settings and the checks are the reference example's; the device
defaults to ``cuda`` and the run stops without a card unless ``--device
cpu`` is given.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import random as jr
from repro_torch.api.build import resolve_device
from repro_torch.config import FederatedConfig
from repro_torch.core import make_algorithm
from repro_torch.core.problems import fair_federated_problem


def train(prob, lr_x, rounds=200):
    cfg = FederatedConfig(algorithm="fedbio", num_clients=prob.num_clients,
                          local_steps=4, lr_x=lr_x, lr_y=0.5, lr_u=0.3)
    alg = make_algorithm(prob, cfg)
    state = alg.init(jr.PRNGKey(1))
    key = jr.PRNGKey(2)
    for _ in range(rounds):
        key, sub = jr.split(key)
        state, _ = alg.round(state, sub)
    return alg.mean_x(state), torch.mean(state.y, dim=0)


def run(device=None, rounds: int = 200) -> dict:
    """Both trainings; returns the client validation losses under uniform
    and learned weights (``uniform``, ``bilevel``) and the learned weights
    (``weights``), as numpy arrays."""
    dev = resolve_device(device)
    prob = fair_federated_problem(jr.PRNGKey(0, device=dev), num_clients=8,
                                  hard_clients=2)
    lam_u, y_u = train(prob, lr_x=0.0, rounds=rounds)    # uniform (λ frozen)
    lam_f, y_f = train(prob, lr_x=2.0, rounds=rounds)    # learned fair weights
    lu = prob.client_val_losses(torch.zeros(8, device=dev), y_u)
    lf = prob.client_val_losses(lam_f, y_f)
    w = torch.softmax(lam_f, dim=-1)
    return {k: v.detach().cpu().numpy() for k, v in
            (("uniform", lu), ("bilevel", lf), ("weights", w))}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    out = run(args.device)
    lu, lf, w = out["uniform"], out["bilevel"], out["weights"]
    print("client val losses (clients 0-1 are the minority):")
    print("  uniform :", np.round(lu, 3), f" worst={lu.max():.3f}")
    print("  bilevel :", np.round(lf, 3), f" worst={lf.max():.3f}")
    print("learned weights:", np.round(w, 3))
    assert lf.max() < lu.max()
    assert w[:2].mean() > w[2:].mean()
    print("fairness achieved: worst client improved, minority up-weighted.")


if __name__ == "__main__":
    main()
