"""Hyper-gradient oracles (counterpart of ``repro/core/hypergrad.py``).

Second-order quantities are matrix-free Hessian- and Jacobian-vector
products.  As in the reference they come from forward-over-reverse
differentiation: ``torch.func.jvp`` of ``torch.func.grad``.  Every backward
formula the Mamba-2 model needs (embedding gather, ``cumsum``, ``where`` with
``-inf``, the SSD einsums) has forward-mode support in PyTorch, so no
reverse-over-reverse substitute is used.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.func import grad, jvp

from repro_torch.core.tree_util import (tree_axpy, tree_map, tree_scale,
                                        tree_sub, tree_zeros_like)


def grad_x(f: Callable, x, y, batch):
    return grad(f, argnums=0)(x, y, batch)


def grad_y(f: Callable, x, y, batch):
    return grad(f, argnums=1)(x, y, batch)


def hvp_yy(g: Callable, x, y, batch, u):
    """∇²_yy g(x, y; batch) · u, forward over reverse."""
    return jvp(lambda yy: grad(g, argnums=1)(x, yy, batch), (y,), (u,))[1]


def _neumann_ihvp(g: Callable, x, y, batch_g, v0, q_terms: int, tau: float):
    """The truncated series [τ Σ_{k=0}^{Q} (I − τ∇²_yy g)^k] v0: Q HVPs on
    the one minibatch, in the reference's order of operations."""
    v = v0
    acc = v0
    for _ in range(q_terms):
        v = tree_axpy(-tau, hvp_yy(g, x, y, batch_g, v), v)   # v ← (I − τH) v
        acc = tree_map(torch.add, acc, v)
    return tree_scale(tau, acc)


def fused_g_oracles(g: Callable, x, y, batch, u):
    """(∇_y g, ∇²_xy g·u, ∇²_yy g·u) from one forward-over-reverse
    linearization of ∇_{(x,y)} g with tangent (0, u)."""
    def grads(xx, yy):
        return grad(g, argnums=(0, 1))(xx, yy, batch)

    (_, gy), (txy, tyy) = jvp(grads, (x, y), (tree_zeros_like(x), u))
    return gy, txy, tyy


def fused_oracles(g: Callable, f: Callable, x, y, u, batch):
    """The three FedBiO oracle directions on one minibatch:

        ω = ∇_y g
        μ = ∇_x f − ∇²_xy g·u
        p = ∇²_yy g·u − ∇_y f
    """
    omega, txy, tyy = fused_g_oracles(g, x, y, batch, u)
    fx, fy = grad(f, argnums=(0, 1))(x, y, batch)
    return omega, tree_sub(fx, txy), tree_sub(tyy, fy)



def fused_local_oracles(g: Callable, f: Callable, x, y, batch,
                        q_terms: int, tau: float):
    """The two local-lower oracle directions on one minibatch:

        ω = ∇_y g
        Φ = ∇_x f − ∇²_xy g · [τ Σ_{k=0}^{Q} (I − τ∇²_yy g)^k] ∇_y f

    One ∇_{(x,y)} f gives ∇_x f and the series seed ∇_y f; one
    forward-over-reverse linearization of ∇_{(x,y)} g with tangent
    (0, ihvp) gives ω and the ∇²_xy g contraction."""
    fx, fy = grad(f, argnums=(0, 1))(x, y, batch)
    ihvp = _neumann_ihvp(g, x, y, batch, fy, q_terms, tau)

    def grads(xx, yy):
        return grad(g, argnums=(0, 1))(xx, yy, batch)

    (_, omega), (txy, _) = jvp(grads, (x, y), (tree_zeros_like(x), ihvp))
    return omega, tree_sub(fx, txy)
