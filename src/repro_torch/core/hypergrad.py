"""Hyper-gradient oracles (counterpart of ``repro/core/hypergrad.py``).

Second-order quantities are matrix-free Hessian- and Jacobian-vector
products.  As in the reference, the Hessian-vector products and the fused
oracles come from forward-over-reverse differentiation (``torch.func.jvp``
of ``torch.func.grad``), and the unfused ``jvp_xy`` from reverse over
reverse (the gradient in x of ⟨∇_y g, u⟩).  Every backward formula the
Mamba-2 model needs (embedding gather, ``cumsum``, ``where`` with ``-inf``,
the SSD einsums) has forward-mode support in PyTorch.

The unfused functions (``grad_y``, ``nu_direction``, ``u_residual``,
``u_step``, ``neumann_hypergrad``) take one batch per derivative, as the
paper's independent minibatches; the fused ones share one batch.

Forward-mode AD gives a dual tensor's tangent the primal's storage layout:
a primal that is a slice of a larger storage (a leaf of the flat buffers'
pytree view) gets a tangent storage as large as that whole storage, one
per leaf.  The primals and tangents that enter ``jvp`` are therefore given
storages of their own first (:func:`_own_storage`), a copy of the leaf and
no more.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.func import grad, jvp

from repro_torch.core.tree_util import (tree_axpy, tree_map, tree_scale,
                                        tree_sub, tree_vdot, tree_zeros_like)


def grad_x(f: Callable, x, y, batch):
    return grad(f, argnums=0)(x, y, batch)


def grad_y(f: Callable, x, y, batch):
    return grad(f, argnums=1)(x, y, batch)


def _own_storage(tree):
    """``tree`` with every leaf that is a slice of a larger storage copied
    into a storage of its own (the others as they are; a leaf batched by
    ``vmap``, as the problem-level rounds batch their clients, exposes no
    storage and is left as it is)."""
    def own(t):
        try:
            nbytes = t.untyped_storage().nbytes()
        except NotImplementedError:
            return t
        whole = nbytes == t.numel() * t.element_size() and t.is_contiguous()
        return t if whole else t.clone()
    return tree_map(own, tree)


def hvp_yy(g: Callable, x, y, batch, u):
    """∇²_yy g(x, y; batch) · u, forward over reverse."""
    return jvp(lambda yy: grad(g, argnums=1)(x, yy, batch),
               (_own_storage(y),), (_own_storage(u),))[1]


def jvp_xy(g: Callable, x, y, batch, u):
    """∇²_xy g(x, y; batch) · u  =  ∇_x ⟨∇_y g(x, y; batch), u⟩."""
    return grad(lambda xx: tree_vdot(grad(g, argnums=1)(xx, y, batch), u))(x)


def u_step(g: Callable, f: Callable, x, y, u, batch_g, batch_f, tau: float):
    """One local step on the quadratic problem Eq. (4):
    ``u ← u − τ (∇²_yy g · u − ∇_y f)``."""
    return tree_axpy(-tau, u_residual(g, f, x, y, u, batch_g, batch_f), u)


def u_residual(g: Callable, f: Callable, x, y, u, batch_g, batch_f):
    """p = ∇²_yy g · u − ∇_y f (the q-momentum target in FedBiOAcc)."""
    return tree_sub(hvp_yy(g, x, y, batch_g, u), grad_y(f, x, y, batch_f))


def nu_direction(g: Callable, f: Callable, x, y, u, batch_g, batch_f):
    """ν = ∇_x f(x,y;B_f) − ∇²_xy g(x,y;B_g) · u  (Alg. 1 line 6)."""
    return tree_sub(grad_x(f, x, y, batch_f), jvp_xy(g, x, y, batch_g, u))


def _neumann_ihvp(g: Callable, x, y, batch_g, v0, q_terms: int, tau: float):
    """The truncated series [τ Σ_{k=0}^{Q} (I − τ∇²_yy g)^k] v0: Q HVPs on
    the one minibatch, in the reference's order of operations."""
    v = v0
    acc = v0
    for _ in range(q_terms):
        v = tree_axpy(-tau, hvp_yy(g, x, y, batch_g, v), v)   # v ← (I − τH) v
        acc = tree_map(torch.add, acc, v)
    return tree_scale(tau, acc)


def neumann_hypergrad(g: Callable, f: Callable, x, y, batch_g, batch_f,
                      q_terms: int, tau: float):
    """Eq. (6): Φ = ∇_x f − ∇_xy g · [τ Σ_{k=0}^{Q} (I − τ∇²_yy g)^k] ∇_y f."""
    ihvp = _neumann_ihvp(g, x, y, batch_g, grad_y(f, x, y, batch_f),
                         q_terms, tau)
    return tree_sub(grad_x(f, x, y, batch_f), jvp_xy(g, x, y, batch_g, ihvp))


def exact_hypergrad_quadratic(problem, x, y):
    """For tests: the closed-form Φ(x, y_x) of a problem that has one."""
    return problem.exact_hypergrad(x, y)


def fused_g_oracles(g: Callable, x, y, batch, u):
    """(∇_y g, ∇²_xy g·u, ∇²_yy g·u) from one forward-over-reverse
    linearization of ∇_{(x,y)} g with tangent (0, u)."""
    def grads(xx, yy):
        return grad(g, argnums=(0, 1))(xx, yy, batch)

    x = _own_storage(x)
    (_, gy), (txy, tyy) = jvp(grads, (x, _own_storage(y)),
                              (tree_zeros_like(x), _own_storage(u)))
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
    x, y = _own_storage(x), _own_storage(y)
    fx, fy = grad(f, argnums=(0, 1))(x, y, batch)
    ihvp = _neumann_ihvp(g, x, y, batch, fy, q_terms, tau)

    def grads(xx, yy):
        return grad(g, argnums=(0, 1))(xx, yy, batch)

    (_, omega), (txy, _) = jvp(grads, (x, y), (tree_zeros_like(x), ihvp))
    return omega, tree_sub(fx, txy)
