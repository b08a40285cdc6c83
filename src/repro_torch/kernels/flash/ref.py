"""Plain PyTorch version of the flash-attention kernel: dense masked
attention in f32 (as ``repro/kernels/flash/ref.py``), on the model's
``[B, S, H, D]`` layout with query head ``h`` reading kv head
``h // (H / Hkv)``.  ``kernels/flash/ops.py`` uses this for tensors on the
CPU; the tests and ``chip_smoke.py`` hold the kernel to it.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def band_mask(S: int, *, causal: bool, window: int, device=None):
    """[S, S] bool: query q may attend to key k."""
    q_pos = torch.arange(S, device=device)[:, None]
    k_pos = torch.arange(S, device=device)[None, :]
    ok = torch.ones((S, S), dtype=torch.bool, device=device)
    if causal:
        ok &= k_pos <= q_pos
    if window and window > 0:
        ok &= k_pos > q_pos - window
    return ok


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0, scale: float = None):
    """q: [B, S, H, D]; k, v: [B, S, Hkv, D].  Returns [B, S, H, D] in
    q's dtype."""
    B, S, H, D = q.shape
    hkv = k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    qg = q.to(torch.float32).reshape(B, S, hkv, H // hkv, D)
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg, k.to(torch.float32)) * scale
    if softcap and softcap > 0.0:
        s = torch.tanh(s / softcap) * softcap
    ok = band_mask(S, causal=causal, window=window, device=q.device)
    s = torch.where(ok, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrqk,bkgd->bqgrd", p, v.to(torch.float32))
    return out.reshape(B, S, H, D).to(q.dtype)
