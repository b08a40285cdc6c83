"""Shared building blocks (counterpart of ``repro/models/layers.py``; the
subset the Mamba-2 and RecurrentGemma paths need: no MoE).

Params are nested dicts of tensors with the reference's keys.  Initialisers
draw from an explicit ``torch.Generator``; with ``gen=None`` they return
empty tensors on the ``meta`` device (shapes and dtypes only — the flat
layout's templates).  Compute dtype follows the input; normalisation and
softmax statistics are f32.  The reference's sharding hints are no-ops on
one card and are dropped.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.config import ModelConfig


def normal(gen: Optional[torch.Generator], shape) -> torch.Tensor:
    """Standard normal f32 draws on the generator's device (meta without
    one)."""
    if gen is None:
        return torch.empty(shape, dtype=torch.float32, device="meta")
    return torch.randn(shape, generator=gen, device=gen.device)


def device_of(gen: Optional[torch.Generator]):
    return "meta" if gen is None else gen.device


def dense_init(gen, shape, dtype, scale: Optional[float] = None):
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    return (normal(gen, shape) * scale).to(dtype)


def embed_init(gen, shape, dtype):
    return (normal(gen, shape) * 0.02).to(dtype)


def rmsnorm_init(d, dtype, device):
    return {"scale": torch.zeros((d,), dtype=dtype, device=device)}


def rmsnorm(params, x, eps: float = 1e-6):
    dtype = x.dtype
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + params["scale"].to(torch.float32))).to(dtype)


def silu(x):
    """``jax.nn.silu``: x · sigmoid(x)."""
    return x * torch.sigmoid(x)


def softplus(x):
    """``jax.nn.softplus``: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)


def gelu(x):
    """``jax.nn.gelu(x, approximate=True)``:
    x · ½(1 + tanh(√(2/π)·(x + 0.044715·x³)))."""
    cdf = 0.5 * (1.0 + torch.tanh(_SQRT_2_OVER_PI * (x + 0.044715 * (x * x * x))))
    return x * cdf


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------

def rope(x, positions, theta: float):
    """x: [..., S, H, D]; positions: [..., S] (broadcastable)."""
    half = x.shape[-1] // 2
    freq = torch.arange(half, dtype=torch.float32, device=x.device)
    inv = 1.0 / (theta ** (freq / half))
    ang = positions.to(torch.float32)[..., None] * inv         # [..., S, half]
    ang = ang[..., None, :]                                    # [..., S, 1, half]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention (GQA, optional sliding window / softcap / bidirectional)
# ---------------------------------------------------------------------------

def attn_init(gen, cfg: ModelConfig, dtype):
    d, hq, hkv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                      cfg.resolved_head_dim)
    return {
        "wq": dense_init(gen, (d, hq * hd), dtype),
        "wk": dense_init(gen, (d, hkv * hd), dtype),
        "wv": dense_init(gen, (d, hkv * hd), dtype),
        "wo": dense_init(gen, (hq * hd, d), dtype,
                         scale=1.0 / math.sqrt(hq * hd)),
    }


def _softcap(x, cap: float):
    if cap and cap > 0.0:
        return torch.tanh(x / cap) * cap
    return x


def _mask_bias(q_pos, k_pos, *, causal: bool, window: int):
    """Additive mask bias [..., Sq, Sk] in f32: 0 where allowed, −1e30
    elsewhere."""
    diff = q_pos[..., :, None] - k_pos[..., None, :]
    ok = torch.ones(diff.shape, dtype=torch.bool, device=diff.device)
    if causal:
        ok &= diff >= 0
    if window and window > 0:
        ok &= diff < window
    return torch.where(ok, 0.0, -1e30).to(torch.float32)


def attention(params, x, cfg: ModelConfig, *, window: int, positions,
              kv_cache=None, cache_index=None, use_flash: bool = False):
    """Self attention.

    Prefill: ``kv_cache is None`` → the full sequence; returns
    ``(out, (k, v))``.  Decode: ``kv_cache = (k, v)`` ring buffers
    ``[B, S_cache, Hkv, D]`` and ``cache_index`` a scalar or a ``[B]``
    vector of positions → a single-token query; returns ``(out, (k, v))``
    with the buffers updated (new tensors: the inputs are not written).
    """
    B, S, _ = x.shape
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    rep = hq // hkv

    q = (x @ params["wq"]).reshape(B, S, hq, hd)
    k = (x @ params["wk"]).reshape(B, S, hkv, hd)
    v = (x @ params["wv"]).reshape(B, S, hkv, hd)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    scale = 1.0 / math.sqrt(hd)

    if kv_cache is None:
        if use_flash:
            from repro_torch.kernels.flash import ops as flash_ops
            out = flash_ops.flash_attention(
                q, k, v, causal=cfg.causal, window=window,
                softcap=cfg.attn_softcap, scale=scale)
        else:
            # grouped GQA einsum: never materialises the rep-expanded kv
            qg = q.reshape(B, S, hkv, rep, hd)
            logits = torch.einsum("bqgrd,bkgd->bgrqk", qg, k) \
                .to(torch.float32) * scale
            logits = _softcap(logits, cfg.attn_softcap)
            bias = _mask_bias(positions, positions, causal=cfg.causal,
                              window=window)
            logits = logits + bias[:, None, None, :, :]
            probs = torch.softmax(logits, dim=-1).to(x.dtype)
            out = torch.einsum("bgrqk,bkgd->bqgrd", probs, v) \
                .reshape(B, S, hq, hd)
        out = out.reshape(B, S, hq * hd) @ params["wo"]
        return out, (k, v)

    # ----- decode: single token, update the ring buffers -----
    ck, cv = kv_cache                       # [B, S_cache, hkv, hd]
    S_cache = ck.shape[1]
    pos_b = torch.as_tensor(cache_index, device=x.device).expand(B)
    slot = pos_b % S_cache                  # floor-mod: the ring slot
    barange = torch.arange(B, device=x.device)
    ck = ck.index_put((barange, slot), k[:, 0])
    cv = cv.index_put((barange, slot), v[:, 0])
    qg = q.reshape(B, S, hkv, rep, hd)
    logits = torch.einsum("bqgrd,bkgd->bgrqk", qg, ck).to(torch.float32) * scale
    logits = _softcap(logits, cfg.attn_softcap)
    # true position held in each ring slot: the newest token sits at `slot`
    slots = torch.arange(S_cache, device=x.device)
    k_pos = pos_b[:, None] - ((slot[:, None] - slots[None, :]) % S_cache)
    valid = (k_pos >= 0) & (k_pos <= pos_b[:, None])
    if window and window > 0:
        valid &= k_pos > (pos_b[:, None] - window)
    bias = torch.where(valid, 0.0, -1e30).to(torch.float32)   # [B, S_cache]
    logits = logits + bias[:, None, None, None, :]
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    out = torch.einsum("bgrqk,bkgd->bqgrd", probs, cv).reshape(B, S, hq, hd)
    out = out.reshape(B, S, hq * hd) @ params["wo"]
    return out, (ck, cv)


# ---------------------------------------------------------------------------
# gated MLP
# ---------------------------------------------------------------------------

def mlp_init(gen, d_model, d_ff, dtype):
    return {
        "wi": dense_init(gen, (d_model, d_ff), dtype),
        "wg": dense_init(gen, (d_model, d_ff), dtype),
        "wo": dense_init(gen, (d_ff, d_model), dtype,
                         scale=1.0 / math.sqrt(d_ff)),
    }


def mlp(params, x, activation: str = "silu"):
    """Gated MLP: ``wo(act(x wg) · x wi)`` with ``act`` silu or tanh-gelu
    (the reference's ungated form serves only the audio family, not
    ported)."""
    g = x @ params["wg"]
    h = (gelu(g) if activation == "gelu" else silu(g)) * (x @ params["wi"])
    return h @ params["wo"]


def embedding_init(gen, cfg: ModelConfig, dtype):
    return {"table": embed_init(gen, (cfg.vocab_size, cfg.d_model), dtype)}


def embed(params, tokens):
    return params["table"][tokens]


def head_init(gen, cfg: ModelConfig, dtype):
    return {"w": dense_init(gen, (cfg.d_model, cfg.vocab_size), dtype)}
