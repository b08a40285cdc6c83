"""Bilevel problem backed by a model (counterpart of
``repro/core/model_problem.py``).

Hyper-representation: the upper variable x is the model body, the lower
variable y the output head.  The lower objective is the L2-regularised
training CE (strongly convex in y), the upper objective the CE on a held-out
validation stream, per client.

With ``n_micro > 1`` each client's batch is split into ``n_micro``
microbatches whose losses are summed and averaged, each microbatch's
loss rematerialised (the reference's ``lax.scan`` over a
``jax.checkpoint`` body); ``remat`` rematerialises each unit of the
model's layer stack besides (``models.stack.rematerialize``).
"""
from __future__ import annotations

import torch

from repro_torch.core.tree_util import tree_leaves, tree_map
from repro_torch.models.registry import Model
from repro_torch.models.stack import rematerialize


def check_model_options(use_flash: bool = False,
                        use_lru_kernel: bool = False) -> None:
    """Refuse training through the model kernels."""
    if use_flash or use_lru_kernel:
        raise NotImplementedError(
            "use_flash / use_lru_kernel: the kernels run forward only (the "
            "reference cannot differentiate through them either); training "
            "through them waits for ROADMAP queue 1, item 'Training through "
            "the model kernels'")


def _microbatch_mean(loss_one, params, batch, n_micro: int):
    """The mean over ``n_micro`` microbatches of ``loss_one(params,
    microbatch)`` (f32), each rematerialised: ``batch``'s leading axis is
    split into ``n_micro`` pieces, the losses summed from an f32 zero in
    order and multiplied by ``f32(1/n_micro)`` (XLA's form of the
    reference's division by the constant).  One microbatch is
    ``loss_one(params, batch)`` itself."""
    if n_micro <= 1:
        return loss_one(params, batch)
    split = tree_map(lambda v: v.reshape(
        (n_micro, v.shape[0] // n_micro) + tuple(v.shape[1:])), batch)
    dev = tree_leaves(batch)[0].device
    total = torch.zeros((), dtype=torch.float32, device=dev)
    for i in range(n_micro):
        mb = tree_map(lambda v: v[i], split)
        total = total + rematerialize(loss_one, params, mb)
    return total * torch.tensor(1.0 / n_micro, dtype=torch.float32,
                                device=dev)


class _SumSquares(torch.autograd.Function):
    """``sum(v.float() ** 2)`` with the derivatives autograd would give it,
    op for op (``(g · (2 · v.float())).to(v.dtype)`` back, ``sum(2 ·
    v.float() · t.float())`` forward), saving only ``v``: autograd would
    keep ``v.float()`` and, under the oracles' forward-over-reverse, its
    tangent, two f32 copies of the head for the whole linearization."""

    @staticmethod
    def forward(v):
        return torch.sum(v.to(torch.float32) ** 2)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0])
        ctx.save_for_forward(inputs[0])

    @staticmethod
    def backward(ctx, g):
        (v,) = ctx.saved_tensors
        return (g * (2 * v.to(torch.float32))).to(v.dtype)

    @staticmethod
    def jvp(ctx, t):
        (v,) = ctx.saved_tensors
        return torch.sum((2 * v.to(torch.float32)) * t.to(torch.float32))


def make_model_bilevel(model: Model, *, lower_l2: float = 1e-2,
                       n_micro: int = 1, remat: bool = True,
                       use_flash: bool = False, use_lru_kernel: bool = False):
    """Returns (f, g): per-client stochastic upper/lower objectives over
    ``batch = {"train": model_batch, "val": model_batch}``."""
    check_model_options(use_flash, use_lru_kernel)

    def _loss(p, mb):
        return model.loss(p, mb, remat=remat)[0].to(torch.float32)

    def g(x, y, batch):
        base = _microbatch_mean(_loss, {"body": x, "head": y},
                                batch["train"], n_micro)
        reg = 0.5 * lower_l2 * sum(_SumSquares.apply(v)
                                   for v in tree_leaves(y))
        return base + reg

    def f(x, y, batch):
        return _microbatch_mean(_loss, {"body": x, "head": y}, batch["val"],
                                n_micro)

    return f, g
