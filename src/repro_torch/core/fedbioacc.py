"""FedBiOAcc — Algorithm 2: STORM variance reduction on all three
sequences; counterpart of ``repro/core/fedbioacc.py``.

Per step t (learning-rate schedule α_t = δ/(u0 + t)^{1/3}):

    ŷ_{t+1} = y_t − γ α_t ω_t,   x̂_{t+1} = x_t − η α_t ν_t,
    û_{t+1} = u_t − τ α_t q_t                                   (line 4)
    [every I steps: average x, y, u]                            (lines 5–9)
    ω_{t+1} = ∇_y g(z_{t+1}; B) + (1 − c_ω α_t²)(ω_t − ∇_y g(z_t; B))
    ν_{t+1} = μ(z_{t+1}, u_{t+1}; B) + (1 − c_ν α_t²)(ν_t − μ(z_t, u_t; B))
    q_{t+1} = p(z_{t+1}, u_{t+1}; B) + (1 − c_u α_t²)(q_t − p(z_t, u_t; B))
    [every I steps: average ω, ν, q]                            (lines 13–17)

where μ = ∇_x f − ∇_xy g·u and p = ∇²_yy g·u − ∇_y f.  The same fresh
minibatch is evaluated at the old and new iterate — the STORM correction.

``fuse_oracles`` takes the three directions from one minibatch
(``hypergrad.fused_oracles``); ``fuse_storm`` runs the round on the
sequence-spec engine, FedBiOAcc's three STORM sequences, so each local step
is one ``storm3_step`` launch and one add.  The communication step is the
host's step counter, as ``lax.cond(is_comm, …)`` is the reference's.
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
from repro_torch.core.problems import Problem
from repro_torch.core.tree_util import (client_mean, tree_map, tree_size,
                                        tree_zeros_like)
from repro_torch.optim import sequences as seqs


class FedBiOAccState(NamedTuple):
    x: Any
    y: Any
    u: Any
    omega: Any   # momentum for y
    nu: Any      # momentum for x
    q: Any       # momentum for u
    t: int


def storm_momentum(new, mom, old, c: float, a2):
    """``new + (1 − c·α²)(mom − old)`` leaf by leaf."""
    return tree_map(lambda gn, mo, go: gn + (1.0 - c * a2) * (mo - go),
                    new, mom, old)


def make_fedbioacc(problem: Problem, cfg: FederatedConfig) -> Algorithm:
    M = problem.num_clients
    f, g = problem.f, problem.g
    sample = _sampler(problem, cfg.fuse_oracles, 5)

    if cfg.fuse_oracles:
        def oracles(x, y, u, batch):
            return hg.fused_oracles(g, f, x, y, u, batch)
    else:
        def oracles(x, y, u, batches):
            by, bf1, bg1, bf2, bg2 = batches
            return (hg.grad_y(g, x, y, by),
                    hg.nu_direction(g, f, x, y, u, bg1, bf1),
                    hg.u_residual(g, f, x, y, u, bg2, bf2))

    voracles = vmap(oracles)

    def init(key):
        k1, k2 = jr.split(key)
        x1, y1 = problem.init_xy(k1)
        x = _broadcast_clients(x1, M)
        y = _broadcast_clients(y1, M)
        u = _broadcast_clients(tree_zeros_like(y1), M)
        omega, nu, q = voracles(x, y, u, sample(k2))
        return FedBiOAccState(x, y, u, omega, nu, q, 0)

    def local_step(carry, k, is_comm: bool):
        x, y, u, omega, nu, q, t = carry
        a = seqs.alpha_schedule(cfg, t)
        # --- variable update (line 4) ---
        x_new = tree_map(lambda v, m: v - cfg.lr_x * a * m, x, nu)
        y_new = tree_map(lambda v, m: v - cfg.lr_y * a * m, y, omega)
        u_new = tree_map(lambda v, m: v - cfg.lr_u * a * m, u, q)
        # --- communication of variables (lines 5-9) ---
        if is_comm:
            x_new, y_new, u_new = (client_mean(x_new), client_mean(y_new),
                                   client_mean(u_new))
        # --- STORM momentum with shared minibatch (lines 10-12) ---
        batches = sample(k)
        o_new, m_new, p_new = voracles(x_new, y_new, u_new, batches)
        o_old, m_old, p_old = voracles(x, y, u, batches)
        a2 = a * a
        omega = storm_momentum(o_new, omega, o_old, cfg.c_omega, a2)
        nu = storm_momentum(m_new, nu, m_old, cfg.c_nu, a2)
        q = storm_momentum(p_new, q, p_old, cfg.c_u, a2)
        # --- communication of momenta (lines 13-17) ---
        if is_comm:
            omega, nu, q = client_mean(omega), client_mean(nu), client_mean(q)
        return (x_new, y_new, u_new, omega, nu, q, t + 1)

    # the flat-buffer variant of the same step: FedBiOAcc's sequence spec
    # (three STORM sequences, flat averaging) compiled by the engine
    x1s, y1s = _templates(problem)
    if cfg.fuse_storm:
        def oracle(vt, batches):
            omega, mu, p = voracles(vt["x"], vt["y"], vt["u"], batches)
            return {"x": mu, "y": omega, "u": p}

        engine = _make_engine(cfg, "fedbioacc",
                              {"x": x1s, "y": y1s, "u": y1s}, oracle)

    def round(state: FedBiOAccState, key):
        I = cfg.local_steps
        keys = jr.split(key, I)
        if not cfg.fuse_storm:
            carry = tuple(state)
            for i, k in enumerate(keys):
                carry = local_step(carry, k, i == I - 1)   # comm on the last
            new = FedBiOAccState(*carry)
            return new, {"t": new.t}
        vt, mt, t = _run_engine(
            engine, sample, keys, {"x": state.x, "y": state.y, "u": state.u},
            {"nu": state.nu, "omega": state.omega, "q": state.q},
            step=state.t)
        new = FedBiOAccState(vt["x"], vt["y"], vt["u"], mt["omega"],
                             mt["nu"], mt["q"], t)
        return new, {"t": new.t}

    def mean_x(state):
        return mean_over_clients(state.x)

    # x + y + u + three momenta per client per round
    comm = 2 * (tree_size(x1s) + 2 * tree_size(y1s))
    return Algorithm("fedbioacc", init, round, comm, mean_x)
