"""Plain PyTorch version of the RG-LRU scan kernel.

The sequential recurrence, one rounded product and one rounded sum per
step, as ``csrc/lru_scan.cu`` computes it: the two agree bit for bit.
(The reference's own oracle, ``repro/kernels/lru/ref.py``, is an associative
scan; the two agree to f32 rounding.)  ``kernels/lru/ops.py`` uses this for
tensors on the CPU; the tests and ``chip_smoke.py`` hold the kernel to it.
"""
from __future__ import annotations

import torch


def lru_scan_ref(a, b, h0=None):
    """``h_t = a_t·h_{t−1} + b_t`` along axis 1; a, b: [B, S, C] f32, h0:
    [B, C] (zeros when None).  Returns h: [B, S, C] f32."""
    a, b = a.to(torch.float32), b.to(torch.float32)
    h = (torch.zeros_like(a[:, 0]) if h0 is None
         else h0.to(torch.float32).clone())
    out = torch.empty_like(a)
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out[:, t] = h
    return out
