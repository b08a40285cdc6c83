"""Bilevel problem backed by a model (counterpart of
``repro/core/model_problem.py``).

Hyper-representation: the upper variable x is the model body, the lower
variable y the output head.  The lower objective is the L2-regularised
training CE (strongly convex in y), the upper objective the CE on a held-out
validation stream, per client.

Only one microbatch per step is ported, without rematerialisation: the
reference's ``remat`` only saves memory (``jax.checkpoint``), and
``torch.utils.checkpoint`` does not compose with ``torch.func``.
"""
from __future__ import annotations

import torch

from repro_torch.core.tree_util import tree_leaves
from repro_torch.models.registry import Model


def check_model_options(n_micro: int = 1, remat: bool = False,
                        use_flash: bool = False,
                        use_lru_kernel: bool = False) -> None:
    """Refuse the model-execution options the port does not run yet."""
    if n_micro != 1 or remat:
        raise NotImplementedError(
            "microbatching (n_micro > 1) and remat are not ported; the port "
            "runs one microbatch per step without rematerialisation")
    if use_flash or use_lru_kernel:
        raise NotImplementedError(
            "use_flash / use_lru_kernel: the kernels run forward only (the "
            "reference cannot differentiate through them either); training "
            "through them waits for ROADMAP queue 1, item 'Training through "
            "the model kernels'")


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
                       n_micro: int = 1, remat: bool = False,
                       use_flash: bool = False, use_lru_kernel: bool = False):
    """Returns (f, g): per-client stochastic upper/lower objectives over
    ``batch = {"train": model_batch, "val": model_batch}``."""
    check_model_options(n_micro, remat, use_flash, use_lru_kernel)

    def _loss(x, y, mb):
        return model.loss({"body": x, "head": y}, mb)[0].to(torch.float32)

    def g(x, y, batch):
        reg = 0.5 * lower_l2 * sum(_SumSquares.apply(v)
                                   for v in tree_leaves(y))
        return _loss(x, y, batch["train"]) + reg

    def f(x, y, batch):
        return _loss(x, y, batch["val"])

    return f, g
