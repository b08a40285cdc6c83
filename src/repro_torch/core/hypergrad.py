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

from torch.func import grad, jvp

from repro_torch.core.tree_util import tree_sub, tree_zeros_like


def grad_x(f: Callable, x, y, batch):
    return grad(f, argnums=0)(x, y, batch)


def grad_y(f: Callable, x, y, batch):
    return grad(f, argnums=1)(x, y, batch)


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

