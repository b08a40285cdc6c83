"""Quickstart: solve a federated bilevel problem with FedBiOAcc in ~30 lines
(the port of ``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

The settings and the final check (||∇h(x)|| < 0.5 after 150 rounds) are
the reference example's; the device defaults to ``cuda`` and the run stops
without a card unless ``--device cpu`` is given.  The problem's arrays
live on the device, the init and round keys on the host, as in
``repro_torch.examples.data_cleaning``.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import random as jr
from repro_torch.api.build import resolve_device
from repro_torch.config import FederatedConfig
from repro_torch.core import make_algorithm, quadratic_problem


def run(device=None, rounds: int = 150, log=print) -> list:
    """Train and return the hypergradient norms ``[(round, norm), ...]``
    printed every 25 rounds, then the final one."""
    dev = resolve_device(device)
    # A heterogeneous stochastic quadratic bilevel problem over 8 clients
    # with a closed-form hyper-gradient so we can watch true convergence.
    prob = quadratic_problem(jr.PRNGKey(0, device=dev), num_clients=8,
                             dx=10, dy=10, noise=0.1, hetero=1.0)
    cfg = FederatedConfig(
        algorithm="fedbioacc",   # Algorithm 2 — STORM-accelerated FedBiO
        num_clients=8,
        local_steps=4,           # I local steps between communication rounds
        lr_x=0.03, lr_y=0.1, lr_u=0.1)
    alg = make_algorithm(prob, cfg)
    state = alg.init(jr.PRNGKey(1))
    key = jr.PRNGKey(2)

    def gnorm() -> float:
        return float(torch.linalg.norm(prob.exact_hypergrad(
            alg.mean_x(state))))

    log(f"algorithm={alg.name}  clients={cfg.num_clients}  "
        f"floats communicated per client per round={alg.comm_floats}")
    norms = []
    for r in range(1, rounds + 1):
        key, sub = jr.split(key)
        state, _ = alg.round(state, sub)
        if r % 25 == 0:
            norms.append((r, gnorm()))
            log(f"round {r:4d}   ||grad h(x)|| = {norms[-1][1]:.4f}")
    norms.append((rounds, gnorm()))
    return norms


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    final = run(args.device)[-1][1]
    assert final < 0.5, final
    print("converged — the hyper-gradient estimation problem (Eq. 4) was "
          "solved with local SGD, never materialising a Hessian.")


if __name__ == "__main__":
    main()
