"""Algorithms 3 & 4 — federated bilevel optimization with *local* lower
level problems (Eq. 5); counterpart of ``repro/core/local_lower.py``.

    min_x (1/M) Σ_m f^(m)(x, y_x^(m)),   y_x^(m) = argmin_y g^(m)(x, y)

Each client keeps a private lower variable y^(m) (never communicated); the
local hyper-gradient Φ^(m) is estimated with the truncated Neumann series
(Eq. 6, Q terms).  Only the upper variable (Alg. 3) — plus its STORM
momentum (Alg. 4) — is averaged every I steps.

``fuse_oracles`` takes ω and Φ from one minibatch
(``hypergrad.fused_local_oracles``: 1 batch a step instead of 3);
``fuse_storm`` runs the round on the sequence-spec engine, where both are
dual-sequence specs with a PRIVATE y: the section-masked communication
averages the x (and, for Alg. 4, ν) tiles and never reads the private ones.
"""
from __future__ import annotations

from typing import Any, NamedTuple

from torch.func import vmap

from repro_torch import random as jr
from repro_torch.config import FederatedConfig
from repro_torch.core import hypergrad as hg
from repro_torch.core.fedbio import (Algorithm, _broadcast_clients,
                                     _make_engine, _run_engine, _sampler,
                                     _templates, mean_over_clients)
from repro_torch.core.fedbioacc import storm_momentum
from repro_torch.core.problems import Problem
from repro_torch.core.tree_util import (client_mean, tree_axpy, tree_map,
                                        tree_size)
from repro_torch.optim import sequences as seqs


class FedBiOLocalState(NamedTuple):
    x: Any
    y: Any
    t: int


class FedBiOAccLocalState(NamedTuple):
    x: Any
    y: Any
    omega: Any
    nu: Any
    t: int


def _make_local_oracles(problem: Problem, cfg: FederatedConfig):
    """(sample, voracles) for the local-lower oracle directions (ω, Φ): one
    shared minibatch with ``cfg.fuse_oracles``, else the paper's three
    independent batches (B_y, B_g, B_f)."""
    f, g = problem.f, problem.g
    if cfg.fuse_oracles:
        def oracles(x, y, b):
            return hg.fused_local_oracles(g, f, x, y, b,
                                          cfg.neumann_q, cfg.neumann_tau)
    else:
        def oracles(x, y, batches):
            by, bx_g, bx_f = batches
            omega = hg.grad_y(g, x, y, by)
            nu = hg.neumann_hypergrad(g, f, x, y, bx_g, bx_f,
                                      cfg.neumann_q, cfg.neumann_tau)
            return omega, nu

    return _sampler(problem, cfg.fuse_oracles, 3), vmap(oracles)


def _make_local_engine(problem: Problem, cfg: FederatedConfig, voracles,
                       algo: str):
    x1s, y1s = _templates(problem)

    def oracle(vt, batches):
        omega, nu = voracles(vt["x"], vt["y"], batches)
        return {"x": nu, "y": omega}

    return _make_engine(cfg, algo, {"x": x1s, "y": y1s}, oracle)


def make_fedbio_local(problem: Problem, cfg: FederatedConfig) -> Algorithm:
    M = problem.num_clients
    sample, voracles = _make_local_oracles(problem, cfg)

    def init(key):
        x1, y1 = problem.init_xy(key)
        return FedBiOLocalState(
            _broadcast_clients(x1, M), _broadcast_clients(y1, M), 0)

    engine = (_make_local_engine(problem, cfg, voracles, "fedbio_local")
              if cfg.fuse_storm else None)

    def round(state, key):
        keys = jr.split(key, cfg.local_steps)
        if cfg.fuse_storm:
            vt, _, t = _run_engine(engine, sample, keys,
                                   {"x": state.x, "y": state.y},
                                   step=state.t)
            return FedBiOLocalState(vt["x"], vt["y"], t), {"t": t}
        x, y = state.x, state.y
        for k in keys:
            omega, nu = voracles(x, y, sample(k))
            x, y = tree_axpy(-cfg.lr_x, nu, x), tree_axpy(-cfg.lr_y, omega, y)
        x = client_mean(x)                      # only x is communicated
        new = FedBiOLocalState(x, y, state.t + cfg.local_steps)
        return new, {"t": new.t}

    def mean_x(state):
        return mean_over_clients(state.x)

    x1, _ = _templates(problem)
    return Algorithm("fedbio_local", init, round, tree_size(x1), mean_x)


def make_fedbioacc_local(problem: Problem, cfg: FederatedConfig) -> Algorithm:
    M = problem.num_clients
    sample, voracles = _make_local_oracles(problem, cfg)

    def init(key):
        k1, k2 = jr.split(key)
        x1, y1 = problem.init_xy(k1)
        x = _broadcast_clients(x1, M)
        y = _broadcast_clients(y1, M)
        omega, nu = voracles(x, y, sample(k2))
        return FedBiOAccLocalState(x, y, omega, nu, 0)

    engine = (_make_local_engine(problem, cfg, voracles, "fedbioacc_local")
              if cfg.fuse_storm else None)

    def local_step(carry, k, is_comm: bool):
        x, y, omega, nu, t = carry
        a = seqs.alpha_schedule(cfg, t)
        x_new = tree_map(lambda v, m: v - cfg.lr_x * a * m, x, nu)
        y_new = tree_map(lambda v, m: v - cfg.lr_y * a * m, y, omega)
        if is_comm:
            x_new = client_mean(x_new)
        batches = sample(k)
        o_new, n_new = voracles(x_new, y_new, batches)
        o_old, n_old = voracles(x, y, batches)
        a2 = a * a
        omega = storm_momentum(o_new, omega, o_old, cfg.c_omega, a2)
        nu = storm_momentum(n_new, nu, n_old, cfg.c_nu, a2)
        if is_comm:
            nu = client_mean(nu)                # ν averaged too
        return (x_new, y_new, omega, nu, t + 1)

    def round(state, key):
        I = cfg.local_steps
        keys = jr.split(key, I)
        if cfg.fuse_storm:
            vt, mt, t = _run_engine(engine, sample, keys,
                                    {"x": state.x, "y": state.y},
                                    {"nu": state.nu, "omega": state.omega},
                                    step=state.t)
            return (FedBiOAccLocalState(vt["x"], vt["y"], mt["omega"],
                                        mt["nu"], t), {"t": t})
        carry = tuple(state)
        for i, k in enumerate(keys):
            carry = local_step(carry, k, i == I - 1)
        new = FedBiOAccLocalState(*carry)
        return new, {"t": new.t}

    def mean_x(state):
        return mean_over_clients(state.x)

    x1, _ = _templates(problem)
    return Algorithm("fedbioacc_local", init, round, 2 * tree_size(x1),
                     mean_x)
