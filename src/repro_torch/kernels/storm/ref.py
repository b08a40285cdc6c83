"""Plain PyTorch versions of the storm-family kernels.

Each repeats its kernel's arithmetic with ordinary tensor ops: the per-tile
(lr, decay|β) tables are expanded to one value per element with
``repeat_interleave``, then the update runs in f32 with one rounding per
operation (no fused multiply-add), and the results are cast back to the
inputs' dtypes.  The kernel wrappers in ``kernel.py`` use these for tensors
on the CPU; the tests and ``chip_smoke.py`` hold the CUDA kernels to them
(the int8 pack/unpack pair at the end serves ``quantpack.py`` the same way).
"""
from __future__ import annotations

import torch


def _expand(table: torch.Tensor, block: int) -> torch.Tensor:
    return torch.repeat_interleave(table.to(torch.float32), block)


def storm_update_ref(p, m, g_new, g_old, lr, decay):
    """Single-sequence update with one ``(lr, decay)`` pair, op by op as
    ``repro/kernels/storm/ref.py:storm_update_ref``: ``p' = p − lr·m`` in
    ``p``'s dtype and ``m' = g_new + decay·(m − g_old)`` in ``m``'s, in f32.
    Python floats ``lr`` and ``decay`` are rounded to f32 once."""
    lr, decay = (torch.as_tensor(x, dtype=torch.float32, device=p.device)
                 for x in (lr, decay))
    m32 = m.to(torch.float32)
    p_new = (p.to(torch.float32) - lr * m32).to(p.dtype)
    m_new = (g_new.to(torch.float32)
             + decay * (m32 - g_old.to(torch.float32))).to(m.dtype)
    return p_new, m_new


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


def _inv127() -> torch.Tensor:
    return torch.tensor(1.0, dtype=torch.float32) / torch.tensor(
        127.0, dtype=torch.float32)


def quantpack_ref(x, block: int):
    """Per-tile symmetric int8 quantization of a flat f32 [N] buffer, with
    the reference's compiled arithmetic: ``scale = max|x| · f32(1/127)`` (XLA
    rewrites the division by the constant 127 into that product),
    ``q = clamp(rint(x / safe), −127, 127)`` with a true division and
    half-to-even rounding, where ``safe`` is 1 for a zero tile (whose scale
    stays 0).  Non-finite inputs as in the reference: the max propagates a
    NaN (scale NaN, then ``safe`` 1), a NaN quotient quantizes to 0 (made
    explicit here: a float → int8 cast of NaN is not defined to give 0, on
    the card least of all).  Returns ``(q int8 [N], scales f32 [N //
    block])``."""
    t = x.to(torch.float32).reshape(-1, block)
    amax = t.abs().amax(dim=-1)
    scale = amax * _inv127().to(x.device)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    r = torch.round(t / safe[:, None]).clamp_(-127.0, 127.0)
    q = torch.where(r.isnan(), torch.zeros_like(r), r).to(torch.int8)
    return q.reshape(x.shape), scale


def quantunpack_ref(q, scales, block: int):
    """``q · scale[t]`` over a flat int8 [N] buffer: one rounded f32 product
    per element."""
    t = q.to(torch.float32).reshape(-1, block)
    return (t * scales[:, None]).reshape(q.shape)
