"""FedBiO — Algorithm 1 (global lower level, Eq. 1); counterpart of
``repro/core/fedbio.py``.

Three entangled federated problems are advanced by alternating local steps:

    ω_t = ∇_y g(x_t, y_t; B_y)                       lower problem
    ν_t = ∇_x f(x_t, y_t; B_f1) − ∇_xy g(...; B_g1)·u_t   upper problem
    u_{t+1} = τ∇_y f(...; B_f2) + (I − τ∇²_yy g(...; B_g2)) u_t   Eq. (4)

Every I steps the client states (x, y, u) are averaged: the paper's
communication round.

The reference's ``lax.scan`` over the local steps is a Python loop here,
and the step counter ``t`` is a host int.  The oracles run over the client
axis under ``torch.func.vmap``, as the reference's ``jax.vmap``: the
problems are small and pure, so one batched call beats a loop of M calls.

Switches (``FederatedConfig``):

* ``fuse_oracles`` — the three oracle directions from the two shared
  linearizations of ``hypergrad.fused_oracles`` on ONE minibatch (1 batch a
  step instead of 5); the u-update is then ``u − τ·p``.
* ``fuse_storm`` — the loop runs on the flat-buffer substrate through the
  sequence-spec engine: FedBiO is the momentum-less triple-sequence spec, so
  each local step is one ``sgd3_step`` launch over (x, y, u).  On the card
  the engine's oracle is replayed from a CUDA graph (``_graphed``).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch.func import vmap

from repro_torch import random as jr
from repro_torch.config import FederatedConfig
from repro_torch.core import hypergrad as hg
from repro_torch.core.problems import Problem
from repro_torch.core.tree_util import (client_mean, tree_axpy, tree_flatten,
                                        tree_map, tree_size, tree_zeros_like)
from repro_torch.optim import sequences as seqs


class FedBiOState(NamedTuple):
    x: Any       # [M, ...] upper variable
    y: Any       # [M, ...] lower variable
    u: Any       # [M, ...] Eq. (4) auxiliary variable
    t: int


class Algorithm(NamedTuple):
    name: str
    init: Any
    round: Any           # (state, key) -> (state, metrics)
    comm_floats: int     # floats communicated per client per round
    mean_x: Any          # state -> averaged upper variable


def _broadcast_clients(tree, m):
    return tree_map(lambda v: v[None].expand((m,) + tuple(v.shape))
                    .contiguous(), tree)


def _templates(problem: Problem):
    """(x, y) of one client: the shapes and dtypes the reference takes from
    ``eval_shape(problem.init_xy, PRNGKey(0))``."""
    return problem.init_xy(jr.PRNGKey(0))


def _sampler(problem: Problem, fuse_oracles: bool, n_batches: int):
    """``sample(key)``: one batch, or ``n_batches`` independent ones from
    ``split(key, n_batches)`` (the paper's separate minibatches)."""
    if fuse_oracles:
        return problem.sample_batches
    return lambda k: tuple(problem.sample_batches(kk)
                           for kk in jr.split(k, n_batches))


def mean_over_clients(tree):
    return tree_map(lambda v: torch.mean(v, dim=0), tree)


_CAPTURE_STREAMS: dict = {}


def _capture_stream(dev: torch.device):
    """The one side stream of ``dev`` that every oracle is warmed up and
    captured on: cuBLAS keeps a workspace (~64 MB on an H100) for each
    stream it has run on, for the life of the process."""
    if dev not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[dev] = torch.cuda.Stream(dev)
    return _CAPTURE_STREAMS[dev]


def _graphed(oracle):
    """``oracle(views, batch)`` replayed from one CUDA graph on the card.

    A problem-level oracle is hundreds to thousands of small operators (the
    vmapped forward-over-reverse derivatives), whose host dispatch is most
    of a round, and the engine calls it with the same shapes every local
    step.  So its first call on the card warms it up on a side stream and
    captures it there; every call copies its inputs into the captured ones,
    replays, and returns clones of the outputs (the next replay overwrites
    them).  A call with other shapes captures anew.  On the CPU the oracle
    runs as it is.  The engine's kernels stay outside the graph, launched
    (and counted) by their wrappers."""
    cap = {}

    def call(views, batch):
        leaves, treedef = tree_flatten((views, batch))
        if leaves[0].device.type != "cuda":
            return oracle(views, batch)
        sig = (treedef, [(t.shape, t.dtype, t.device) for t in leaves])
        if cap.get("sig") != sig:
            cap.clear()
            static = [t.clone() for t in leaves]
            args = treedef.unflatten(static)
            side = _capture_stream(leaves[0].device)
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                oracle(*args)                                # warm-up
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=side):
                out = oracle(*args)
            cap.update(sig=sig, static=static, graph=graph, out=out)
        for s, t in zip(cap["static"], leaves):
            s.copy_(t)
        cap["graph"].replay()
        return tree_map(torch.clone, cap["out"])

    return call


def _make_engine(cfg: FederatedConfig, algo: str, templates: dict, oracle):
    """``algo``'s engine on the flat substrate, its oracle graphed on the
    card.  ``without_hierarchy``: the reference loops always use the paper's
    flat averaging, so ``fuse_storm`` changes how a round runs and nothing
    else."""
    return seqs.make_engine(cfg, seqs.SPECS[algo].without_hierarchy(),
                            templates, _graphed(oracle),
                            block=cfg.fuse_storm_block)


def _run_engine(engine, sample, keys, var_trees, mom_trees=None, step=0):
    """The round on the flat substrate: flatten once, one engine step per
    key, pytree views at the end.  Returns (vars, moms or None, step)."""
    st = engine.init_state(var_trees, mom_trees, step=step)
    for k in keys:
        st = engine.step(st, sample(k))
    vt, mt = engine.views(st)
    return vt, mt, st.step


def make_fedbio(problem: Problem, cfg: FederatedConfig) -> Algorithm:
    M = problem.num_clients
    f, g = problem.f, problem.g
    sample = _sampler(problem, cfg.fuse_oracles, 5)

    def init(key):
        x1, y1 = problem.init_xy(key)
        u1 = tree_zeros_like(y1)
        return FedBiOState(
            x=_broadcast_clients(x1, M), y=_broadcast_clients(y1, M),
            u=_broadcast_clients(u1, M), t=0)

    if cfg.fuse_oracles:
        def directions(x, y, u, batch):
            return hg.fused_oracles(g, f, x, y, u, batch)   # ω, μ, p
    else:
        def directions(x, y, u, batches):
            by, bf1, bg1, bf2, bg2 = batches
            return (hg.grad_y(g, x, y, by),
                    hg.nu_direction(g, f, x, y, u, bg1, bf1),
                    hg.u_residual(g, f, x, y, u, bg2, bf2))

    vdirections = vmap(directions)
    x1s, y1s = _templates(problem)

    if cfg.fuse_storm:
        def oracle(vt, batches):
            omega, mu, p = vdirections(vt["x"], vt["y"], vt["u"], batches)
            return {"x": mu, "y": omega, "u": p}

        engine = _make_engine(cfg, "fedbio", {"x": x1s, "y": y1s, "u": y1s},
                              oracle)

    def round(state: FedBiOState, key):
        keys = jr.split(key, cfg.local_steps)
        if cfg.fuse_storm:
            vt, _, t = _run_engine(engine, sample, keys,
                                   {"x": state.x, "y": state.y, "u": state.u},
                                   step=state.t)
            new = FedBiOState(vt["x"], vt["y"], vt["u"], t)
            return new, {"t": new.t}
        x, y, u = state.x, state.y, state.u
        for k in keys:
            omega, mu, p = vdirections(x, y, u, sample(k))
            # the u-update is hg.u_step's, on the residual p
            x, y, u = (tree_axpy(-cfg.lr_x, mu, x),
                       tree_axpy(-cfg.lr_y, omega, y),
                       tree_axpy(-cfg.lr_u, p, u))
        # communication: average all three federated sequences
        x, y, u = client_mean(x), client_mean(y), client_mean(u)
        new = FedBiOState(x, y, u, state.t + cfg.local_steps)
        return new, {"t": new.t}

    def mean_x(state):
        return mean_over_clients(state.x)

    comm = tree_size(x1s) + 2 * tree_size(y1s)   # x + y + u per client a round
    return Algorithm("fedbio", init, round, comm, mean_x)
