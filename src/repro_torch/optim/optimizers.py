"""Minimal optimizer library — pytree-generic (counterpart of
``repro/optim/optimizers.py``).

Each optimizer is ``(init_fn, update_fn)``:
    opt_state = init_fn(params)
    params, opt_state = update_fn(params, grads, opt_state, lr)
"""
from __future__ import annotations

import torch

from repro_torch.core.tree_util import tree_map, tree_zeros_like


def sgd():
    def init(params):
        return ()

    def update(params, grads, state, lr):
        new = tree_map(lambda p, g: p - (lr * g).to(p.dtype), params, grads)
        return new, state

    return init, update


def momentum(beta: float = 0.9, nesterov: bool = False):
    def init(params):
        return tree_zeros_like(params)

    def update(params, grads, m, lr):
        m = tree_map(lambda mm, g: beta * mm + g.to(mm.dtype), m, grads)
        step = (tree_map(lambda mm, g: beta * mm + g.to(mm.dtype), m, grads)
                if nesterov else m)
        new = tree_map(lambda p, s: p - (lr * s).to(p.dtype), params, step)
        return new, m

    return init, update


def adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    def init(params):
        return {"m": tree_zeros_like(params), "v": tree_zeros_like(params),
                "t": torch.zeros((), dtype=torch.int32)}

    def update(params, grads, state, lr):
        t = state["t"] + 1
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.to(m_.dtype),
                     state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * torch.square(g).to(
            v_.dtype), state["v"], grads)
        tf = t.to(torch.float32)
        bc1 = 1 - b1 ** tf
        bc2 = 1 - b2 ** tf
        new = tree_map(
            lambda p, m_, v_: p - (lr * (m_ / bc1) /
                                   (torch.sqrt(v_ / bc2) + eps)).to(p.dtype),
            params, m, v)
        return new, {"m": m, "v": v, "t": t}

    return init, update
