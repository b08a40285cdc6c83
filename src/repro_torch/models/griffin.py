"""RG-LRU recurrent block (counterpart of ``repro/models/griffin.py``;
RecurrentGemma / Griffin, arXiv:2402.19427).

The block is: RMSNorm → two linear branches (recurrent + gate); the recurrent
branch passes through a short causal conv, then the RG-LRU gated linear
recurrence; output = W_out(lru_out · GeLU(gate_branch)).

RG-LRU recurrence (per channel):
    r_t = sigmoid(x_t W_a + b_a)           # recurrence gate
    i_t = sigmoid(x_t W_x + b_x)           # input gate
    log a_t = −c · softplus(Λ) · r_t       # c = 8
    h_t = a_t · h_{t−1} + sqrt(1 − a_t²) · (i_t · x_t)

Prefill runs the scan over time either as a log-depth doubling scan in
plain PyTorch (the reference's ``lax.associative_scan``) or through the
RG-LRU scan kernel (``kernels/lru``); decode is a single update carrying
``h``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.config import ModelConfig
from repro_torch.models.layers import (dense_init, device_of, gelu, normal,
                                       rmsnorm, rmsnorm_init, softplus)

_C = 8.0   # Griffin's fixed recurrence sharpness constant


def init_rec(gen, cfg: ModelConfig, dtype):
    d = cfg.d_model
    w = cfg.resolved_lru_width
    dev = device_of(gen)
    return {
        "ln": rmsnorm_init(d, dtype, dev),
        "in_x": dense_init(gen, (d, w), dtype),
        "in_gate": dense_init(gen, (d, w), dtype),
        "conv_w": (normal(gen, (cfg.conv_width, w)) * 0.1).to(dtype),
        "conv_b": torch.zeros((w,), dtype=dtype, device=dev),
        "wa": dense_init(gen, (w, w), dtype),
        "ba": torch.zeros((w,), dtype=dtype, device=dev),
        "wx": dense_init(gen, (w, w), dtype),
        "bx": torch.zeros((w,), dtype=dtype, device=dev),
        # Λ so that a = exp(−c·softplus(Λ)) spans (0.9, 0.999)
        "Lambda": torch.linspace(-2.0, 1.0, w, dtype=torch.float32,
                                 device=dev),
        "out": dense_init(gen, (w, d), dtype, scale=1.0 / math.sqrt(w)),
    }


def _causal_conv(x, w, b):
    W, L = w.shape[0], x.shape[1]
    pad = torch.nn.functional.pad(x, (0, 0, W - 1, 0))
    out = torch.zeros_like(x)
    for i in range(W):
        out = out + pad[:, i:i + L, :] * w[i]
    return out + b


def rg_lru_gates(params, x):
    """Per-step ``(a, beta)`` for ``h_t = a_t h_{t−1} + beta_t``, f32."""
    f32 = torch.float32
    r = torch.sigmoid((x @ params["wa"]).to(f32) + params["ba"].to(f32))
    i = torch.sigmoid((x @ params["wx"]).to(f32) + params["bx"].to(f32))
    log_a = -_C * softplus(params["Lambda"]) * r                 # [B,S,W]
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-6)) \
        * (i * x.to(f32))
    return a, beta


def linear_scan(a, b, h0=None, use_kernel: bool = False):
    """``h_t = a_t·h_{t−1} + b_t`` along axis 1.  a, b: [B, S, W] f32.

    ``use_kernel`` goes through ``kernels/lru/ops.lru_scan`` (the CUDA
    kernel on the card, its sequential plain version on the CPU).  Without
    it, a log-depth doubling scan over the pairs ``(a, b)`` with the
    reference's combine ``(a1, b1), (a2, b2) → (a1·a2, a2·b1 + b2)``: after
    the round of distance ``d`` each position holds the composition of the
    ``2d`` steps ending at it.  ``lax.associative_scan`` composes in
    another tree order, so the two agree to f32 rounding, not bit for bit.
    """
    if use_kernel:
        from repro_torch.kernels.lru import ops as lru_ops
        return lru_ops.lru_scan(a, b, h0)
    if h0 is not None:
        b = b.clone()
        b[:, 0, :] += a[:, 0, :] * h0
    S = a.shape[1]
    d = 1
    while d < S:
        a_prev, b_prev = a[:, :-d], b[:, :-d]
        a_cur, b_cur = a[:, d:], b[:, d:]
        b = torch.cat([b[:, :d], a_cur * b_prev + b_cur], dim=1)
        a = torch.cat([a[:, :d], a_prev * a_cur], dim=1)
        d *= 2
    return b


def apply_rec(params, x, cfg: ModelConfig, cache=None, use_kernel: bool = False):
    """Griffin recurrent block.  ``cache = {h: [B, W] f32, conv: [B, Wc−1,
    W]}`` for decode.  Returns ``(out, new_cache)``."""
    B, S, _ = x.shape
    Wc = params["conv_w"].shape[0]
    h_in = rmsnorm(params["ln"], x, cfg.norm_eps)
    xr = h_in @ params["in_x"]
    gate = h_in @ params["in_gate"]

    if cache is None:
        xr_pre = xr                                              # pre-conv
        xr = _causal_conv(xr, params["conv_w"], params["conv_b"])
        a, beta = rg_lru_gates(params, xr)
        h = linear_scan(a, beta, use_kernel=use_kernel)          # [B,S,W] f32
        h_last = h[:, -1, :]
        conv_tail = xr_pre[:, max(S - (Wc - 1), 0):, :]
        if S < Wc - 1:
            conv_tail = torch.nn.functional.pad(conv_tail,
                                                (0, 0, Wc - 1 - S, 0))
        new_cache = {"h": h_last, "conv": conv_tail.to(x.dtype)}
    else:
        conv_buf = torch.cat([cache["conv"], xr.to(x.dtype)], dim=1)
        xr = torch.einsum("bwc,wc->bc", conv_buf, params["conv_w"]) \
            + params["conv_b"]
        xr = xr[:, None, :]
        a, beta = rg_lru_gates(params, xr)
        h_new = a[:, 0] * cache["h"] + beta[:, 0]
        h = h_new[:, None, :]
        new_cache = {"h": h_new, "conv": conv_buf[:, 1:, :]}

    out = (h.to(x.dtype) * gelu(gate)) @ params["out"]
    return out, new_cache


def init_rec_cache(cfg: ModelConfig, batch: int, dtype, device=None):
    w = cfg.resolved_lru_width
    return {
        "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, w), dtype=dtype,
                            device=device),
    }
