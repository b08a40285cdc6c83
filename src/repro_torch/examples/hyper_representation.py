"""Federated Hyper-Representation learning (the paper's second experiment)
on the port, in both formulations:

* Eq. (1) global lower level  — one shared head trained federatedly
  (FedBiO / FedBiOAcc, Algorithms 1-2);
* Eq. (5) local lower level   — one *private* head per client, only the
  backbone is communicated (Algorithms 3-4, Neumann hyper-gradient).

    PYTHONPATH=src python -m repro_torch.examples.hyper_representation \\
        [--rounds 200] [--device cuda] [--fuse-storm]

The settings are those of ``examples/hyper_representation.py``; the device
defaults to ``cuda`` and the run stops without a card unless
``--device cpu`` is given.  The data set is drawn on the device; the keys
of the init, the rounds and the validation batch live on the host, as in
``repro_torch.examples.data_cleaning``.
"""
from __future__ import annotations

import argparse

from repro_torch import random as jr
from repro_torch.api.build import resolve_device
from repro_torch.config import FederatedConfig
from repro_torch.core import hyperrep_problem, make_algorithm
from repro_torch.core.fedbio import mean_over_clients
from repro_torch.core.tree_util import tree_map


def run(algo: str, rounds: int = 200, device=None, *,
        fuse_storm: bool = False, log=print):
    """Train and return the upper validation loss before and after."""
    dev = resolve_device(device)
    prob = hyperrep_problem(jr.PRNGKey(2, device=dev), num_clients=8,
                            hetero=0.5)
    cfg = FederatedConfig(algorithm=algo, num_clients=8, local_steps=4,
                          lr_x=0.1, lr_y=0.2, lr_u=0.2, neumann_q=10,
                          neumann_tau=0.15, fuse_storm=fuse_storm)
    alg = make_algorithm(prob, cfg)
    state = alg.init(jr.PRNGKey(0))
    key = jr.PRNGKey(3)
    batch = tree_map(lambda v: v[0], prob.sample_batches(jr.PRNGKey(9)))

    def val(state):
        return float(prob.f(alg.mean_x(state), mean_over_clients(state.y),
                            batch))

    v0 = val(state)
    for _ in range(rounds):
        key, sub = jr.split(key)
        state, _ = alg.round(state, sub)
    vT = val(state)
    log(f"{algo:18s} upper (val) loss {v0:.3f} -> {vT:.3f}   "
        f"floats/client/round={alg.comm_floats}")
    return v0, vT


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=200)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--fuse-storm", action="store_true",
                    help="run the rounds on the flat substrate's kernels")
    args = ap.parse_args(argv)
    kw = dict(rounds=args.rounds, device=args.device,
              fuse_storm=args.fuse_storm)
    print("Eq. (1) — federated lower level (shared head):")
    run("fedbio", **kw)
    run("fedbioacc", **kw)
    print("Eq. (5) — local lower level (private heads, only x communicated):")
    run("fedbio_local", **kw)
    run("fedbioacc_local", **kw)


if __name__ == "__main__":
    main()
