"""Baseline algorithms the paper compares against (Table 1); counterpart of
``repro/core/baselines.py``.

* :func:`make_fednest` — FedNest-style: every round solves the inner
  problem and the hyper-gradient quadratic with per-step averaging.
* :func:`make_commfedbio` — CommFedBiO-style: hyper-gradient evaluated and
  communicated every iteration, with top-k compression.
* :func:`make_stocbio` — StocBiO (non-federated reference): clients average
  after every step (centralized minibatch SGD with an M-fold batch).
* :func:`make_mrbo` — MRBO (non-federated momentum-based reference).

All share the :class:`repro_torch.core.fedbio.Algorithm` interface.  They
run on pytrees; none reaches a kernel.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch.func import vmap

from repro_torch import random as jr
from repro_torch.config import FederatedConfig
from repro_torch.core import hypergrad as hg
from repro_torch.core.fedbio import (Algorithm, FedBiOState,
                                     _broadcast_clients, _templates,
                                     mean_over_clients)
from repro_torch.core.fedbioacc import storm_momentum
from repro_torch.core.problems import Problem
from repro_torch.core.tree_util import (client_mean, tree_add, tree_map,
                                        tree_size, tree_sub, tree_zeros_like)
from repro_torch.optim.sequences import alpha_schedule


def _sgd(v, d, lr: float):
    """``v − lr·d`` leaf by leaf."""
    return tree_map(lambda a, b: a - lr * b, v, d)


def _vmapped(problem: Problem, cfg: FederatedConfig):
    """The per-client ω = ∇_y g and Neumann Φ oracles, over the clients."""
    f, g = problem.f, problem.g
    v_grad_y = vmap(lambda x, y, b: hg.grad_y(g, x, y, b))
    v_phi = vmap(lambda x, y, bg, bf: hg.neumann_hypergrad(
        g, f, x, y, bg, bf, cfg.neumann_q, cfg.neumann_tau))
    return v_grad_y, v_phi


# ---------------------------------------------------------------------------
# FedNest-style
# ---------------------------------------------------------------------------

def make_fednest(problem: Problem, cfg: FederatedConfig, *, inner_steps=None,
                 u_steps=None) -> Algorithm:
    """Each round: N_y averaged y-steps, N_u averaged u-steps, 1 averaged
    x-step; every sub-step is a communication (~(N_y + N_u + 1)× the
    communication of FedBiO for the same oracle calls)."""
    M = problem.num_clients
    f, g = problem.f, problem.g
    N_y = inner_steps or cfg.local_steps
    N_u = u_steps or cfg.local_steps
    v_grad_y, _ = _vmapped(problem, cfg)
    v_ustep = vmap(lambda x, y, u, bg, bf: hg.u_step(g, f, x, y, u, bg, bf,
                                                     cfg.lr_u))
    v_nu = vmap(lambda x, y, u, bg, bf: hg.nu_direction(g, f, x, y, u, bg, bf))

    def init(key):
        x1, y1 = problem.init_xy(key)
        return FedBiOState(
            _broadcast_clients(x1, M), _broadcast_clients(y1, M),
            _broadcast_clients(tree_zeros_like(y1), M), 0)

    def round(state, key):
        x, y, u = state.x, state.y, state.u
        k_y, k_u, k_x = jr.split(key, 3)
        for k in jr.split(k_y, N_y):
            omega = v_grad_y(x, y, problem.sample_batches(k))
            y = client_mean(_sgd(y, omega, cfg.lr_y))     # per-step averaging
        for k in jr.split(k_u, N_u):
            k1, k2 = jr.split(k)
            u = client_mean(v_ustep(x, y, u, problem.sample_batches(k1),
                                    problem.sample_batches(k2)))
        k1, k2 = jr.split(k_x)
        nu = client_mean(v_nu(x, y, u, problem.sample_batches(k1),
                              problem.sample_batches(k2)))
        x = _sgd(x, nu, cfg.lr_x)
        new = FedBiOState(x, y, u, state.t + 1)
        return new, {"t": new.t}

    x1, y1 = _templates(problem)
    comm = N_y * tree_size(y1) + N_u * tree_size(y1) + tree_size(x1)
    return Algorithm("fednest", init, round, comm,
                     lambda s: mean_over_clients(s.x))


# ---------------------------------------------------------------------------
# CommFedBiO-style (per-step compressed hyper-gradient communication)
# ---------------------------------------------------------------------------

def _topk_compress(tree, ratio: float):
    """Keep the top-``ratio`` fraction of entries (by magnitude) of each
    leaf, over the whole leaf (the client axis included): every entry whose
    magnitude reaches the k-th largest.  The threshold is a value, so the
    order in which ``torch.topk`` and ``lax.top_k`` break ties does not
    matter."""
    def comp(v):
        flat = v.reshape(-1)
        k = max(1, int(flat.numel() * ratio))
        thresh = torch.topk(flat.abs(), k).values[-1]
        return torch.where(flat.abs() >= thresh, flat, 0.0).reshape(v.shape)
    return tree_map(comp, tree)


class CommFedBiOState(NamedTuple):
    x: Any
    y: Any
    e: Any            # error-feedback memory for the compressor
    t: int


def make_commfedbio(problem: Problem, cfg: FederatedConfig) -> Algorithm:
    M = problem.num_clients
    v_grad_y, v_phi = _vmapped(problem, cfg)

    def init(key):
        x1, y1 = problem.init_xy(key)
        return CommFedBiOState(_broadcast_clients(x1, M),
                               _broadcast_clients(y1, M),
                               _broadcast_clients(tree_zeros_like(x1), M), 0)

    def round(state, key):
        # one round is I iterations, as FedBiO's, but every one communicates
        x, y, e = state.x, state.y, state.e
        for k in jr.split(key, cfg.local_steps):
            k1, k2, k3 = jr.split(k, 3)
            omega = v_grad_y(x, y, problem.sample_batches(k1))
            y = client_mean(_sgd(y, omega, cfg.lr_y))
            phi = v_phi(x, y, problem.sample_batches(k2),
                        problem.sample_batches(k3))
            # top-k compression with error feedback (EF-SGD style)
            target = tree_add(phi, e)
            comp = _topk_compress(target, cfg.compress_ratio)  # the upload
            e = tree_sub(target, comp)
            x = _sgd(x, client_mean(comp), cfg.lr_x)
        new = CommFedBiOState(x, y, e, state.t + cfg.local_steps)
        return new, {"t": new.t}

    x1, y1 = _templates(problem)
    comm = cfg.local_steps * (tree_size(y1)
                              + int(tree_size(x1) * cfg.compress_ratio) * 2)
    return Algorithm("commfedbio", init, round, comm,
                     lambda s: mean_over_clients(s.x))


# ---------------------------------------------------------------------------
# Non-federated references (pooled data): StocBiO, MRBO
# ---------------------------------------------------------------------------

class StocBiOState(NamedTuple):
    x: Any
    y: Any
    t: int


class MRBOState(NamedTuple):
    x: Any
    y: Any
    nu: Any
    omega: Any
    t: int


def make_stocbio(problem: Problem, cfg: FederatedConfig, *,
                 inner_steps=4) -> Algorithm:
    M = problem.num_clients
    v_grad_y, v_phi = _vmapped(problem, cfg)

    def init(key):
        x1, y1 = problem.init_xy(key)
        return StocBiOState(_broadcast_clients(x1, M),
                            _broadcast_clients(y1, M), 0)

    def round(state, key):
        x, y = state.x, state.y
        k_in, k1, k2 = jr.split(key, 3)
        for k in jr.split(k_in, inner_steps):
            omega = v_grad_y(x, y, problem.sample_batches(k))
            y = client_mean(_sgd(y, omega, cfg.lr_y))
        phi = client_mean(v_phi(x, y, problem.sample_batches(k1),
                                problem.sample_batches(k2)))
        x = _sgd(x, phi, cfg.lr_x)
        new = StocBiOState(x, y, state.t + 1)
        return new, {"t": new.t}

    x1, y1 = _templates(problem)
    comm = inner_steps * tree_size(y1) + tree_size(x1)
    return Algorithm("stocbio", init, round, comm,
                     lambda s: mean_over_clients(s.x))


def make_mrbo(problem: Problem, cfg: FederatedConfig) -> Algorithm:
    """MRBO-style single-loop momentum bilevel method on the pooled problem
    (per-step averaging ≙ centralized), the Non-Fed accelerated row of
    Table 1."""
    M = problem.num_clients
    v_grad_y, v_phi = _vmapped(problem, cfg)

    def init(key):
        k1, k2 = jr.split(key)
        x1, y1 = problem.init_xy(k1)
        x = _broadcast_clients(x1, M)
        y = _broadcast_clients(y1, M)
        ks = jr.split(k2, 3)
        omega = v_grad_y(x, y, problem.sample_batches(ks[0]))
        nu = v_phi(x, y, problem.sample_batches(ks[1]),
                   problem.sample_batches(ks[2]))
        return MRBOState(x, y, client_mean(nu), client_mean(omega), 0)

    def round(state, key):
        x, y, nu, omega, t = state
        a = alpha_schedule(cfg, t)
        x_new = client_mean(tree_map(lambda v, m: v - cfg.lr_x * a * m, x, nu))
        y_new = client_mean(tree_map(lambda v, m: v - cfg.lr_y * a * m, y,
                                     omega))
        ks = jr.split(key, 3)
        by = problem.sample_batches(ks[0])
        bg, bf = problem.sample_batches(ks[1]), problem.sample_batches(ks[2])
        a2 = a * a
        omega = storm_momentum(v_grad_y(x_new, y_new, by), omega,
                               v_grad_y(x, y, by), cfg.c_omega, a2)
        nu = storm_momentum(v_phi(x_new, y_new, bg, bf), nu,
                            v_phi(x, y, bg, bf), cfg.c_nu, a2)
        new = MRBOState(x_new, y_new, client_mean(nu), client_mean(omega),
                        t + 1)
        return new, {"t": t + 1}

    x1, y1 = _templates(problem)
    comm = 2 * (tree_size(x1) + tree_size(y1))
    return Algorithm("mrbo", init, round, comm,
                     lambda s: mean_over_clients(s.x))
