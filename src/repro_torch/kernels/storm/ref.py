"""Plain PyTorch versions of the storm-family kernels.

Each repeats its kernel's arithmetic with ordinary tensor ops: the per-tile
(lr, decay|β) tables are expanded to one value per element with
``repeat_interleave``, then the update runs in f32 with one rounding per
operation (no fused multiply-add), and the results are cast back to the
inputs' dtypes.  The kernel wrappers in ``kernel.py`` use these for tensors
on the CPU; the tests and ``chip_smoke.py`` hold the CUDA kernels to them.
"""
from __future__ import annotations

import torch


def _expand(table: torch.Tensor, block: int) -> torch.Tensor:
    return torch.repeat_interleave(table.to(torch.float32), block)


def storm3_step_ref(p, m, g_old, lrs, decays, block: int):
    """Half step: ``p − lr·m`` and the partial momentum ``decay·(m − g_old)``
    (the correction add happens after communication)."""
    lr, decay = _expand(lrs, block), _expand(decays, block)
    m32 = m.to(torch.float32)
    p_new = (p.to(torch.float32) - lr * m32).to(p.dtype)
    m_part = (decay * (m32 - g_old.to(torch.float32))).to(m.dtype)
    return p_new, m_part


def storm3_update_ref(p, m, g_new, g_old, lrs, decays, block: int):
    """Full update: ``p − lr·m`` and ``g_new + decay·(m − g_old)``."""
    lr, decay = _expand(lrs, block), _expand(decays, block)
    m32 = m.to(torch.float32)
    p_new = (p.to(torch.float32) - lr * m32).to(p.dtype)
    m_new = (g_new.to(torch.float32)
             + decay * (m32 - g_old.to(torch.float32))).to(m.dtype)
    return p_new, m_new


def sgd3_step_ref(p, g, lrs, block: int):
    """Plain SGD: ``p − lr·g``."""
    lr = _expand(lrs, block)
    return (p.to(torch.float32) - lr * g.to(torch.float32)).to(p.dtype)


def momsgd3_step_ref(p, m, g, lrs, betas, block: int):
    """Heavy ball: ``m' = β·m + g``, then ``p' = p − lr·m'`` (the updated
    momentum moves the variable, as FedAvg does)."""
    lr, beta = _expand(lrs, block), _expand(betas, block)
    m_new = beta * m.to(torch.float32) + g.to(torch.float32)
    p_new = (p.to(torch.float32) - lr * m_new).to(p.dtype)
    return p_new, m_new.to(m.dtype)
