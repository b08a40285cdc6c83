"""Federated Data Cleaning (the paper's first experiment) on the port.

A shared training set has 40% of its labels corrupted.  The upper-level
variable is a per-sample weight vector; the lower level trains a classifier
on the weighted data; the upper objective is validation loss on per-client
clean shards.  FedBiO learns to drive the corrupted samples' weights down.

    PYTHONPATH=src python -m repro_torch.examples.data_cleaning \\
        [--algo fedbioacc] [--rounds 200] [--device cuda] [--fuse-storm]

The settings and the final check (detection AUC > 0.75) are those of
``examples/data_cleaning.py``; the device defaults to ``cuda`` and the run
stops without a card unless ``--device cpu`` is given.  The data set is
drawn on the device; the init and round keys live on the host, where a
round's key splits and index draws (a few hundred small operations) cost
half a round less than as kernel launches on the card
(``scripts/profile_torch_paper.py``).  The draws are the same either way.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import random as jr
from repro_torch.api.build import resolve_device
from repro_torch.config import FederatedConfig
from repro_torch.core import data_cleaning_problem, make_algorithm


def detection_auc(x: torch.Tensor, mask: torch.Tensor) -> float:
    """The share of (corrupted, clean) pairs whose corrupted sample has the
    strictly lower weight logit: the reference's pairwise mean, counted
    with a sort instead of an [n_bad, n_clean] table."""
    bad, clean = -x[mask], torch.sort(-x[~mask]).values
    below = torch.searchsorted(clean, bad, side="left")
    return float(below.double().sum()) / (bad.numel() * clean.numel())


def run(algo: str = "fedbioacc", rounds: int = 200, device=None, *,
        fuse_storm: bool = False, report_every: int = 50, log=print):
    """Train and return ``(state, auc)``."""
    dev = resolve_device(device)
    prob = data_cleaning_problem(jr.PRNGKey(1, device=dev), num_clients=8,
                                 n_train=256, corrupt_frac=0.4)
    mask = prob.data["corrupt_mask"]
    cfg = FederatedConfig(algorithm=algo, num_clients=8, local_steps=4,
                          lr_x=0.3, lr_y=0.3, lr_u=0.3, fuse_storm=fuse_storm)
    alg = make_algorithm(prob, cfg)
    state = alg.init(jr.PRNGKey(0))
    key = jr.PRNGKey(2)

    def report(r):
        x = alg.mean_x(state)
        w = torch.sigmoid(x)
        auc = detection_auc(x, mask)
        log(f"round {r:4d}  mean weight clean={float(w[~mask].mean()):.3f} "
            f"corrupt={float(w[mask].mean()):.3f}  detection AUC={auc:.3f}")
        return auc

    auc = report(0)
    for r in range(1, rounds + 1):
        key, sub = jr.split(key)
        state, _ = alg.round(state, sub)
        if r % report_every == 0 or r == rounds:
            auc = report(r)
    return state, auc


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--algo", default="fedbioacc",
                    choices=["fedbio", "fedbioacc", "fednest"])
    ap.add_argument("--rounds", type=int, default=200)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--fuse-storm", action="store_true",
                    help="run the rounds on the flat substrate's kernels")
    args = ap.parse_args(argv)
    _, auc = run(args.algo, args.rounds, args.device,
                 fuse_storm=args.fuse_storm)
    assert auc > 0.75, "cleaning failed to separate corrupted samples"
    print("corrupted samples identified — matches the paper's Figure 1 "
          "behaviour (weights of noisy samples driven down).")


if __name__ == "__main__":
    main()
