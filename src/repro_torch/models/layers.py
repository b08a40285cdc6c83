"""Shared building blocks (counterpart of ``repro/models/layers.py``).

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

def mlp_init(gen, d_model, d_ff, dtype, gated: bool = True):
    p = {"wi": dense_init(gen, (d_model, d_ff), dtype)}
    if gated:
        p["wg"] = dense_init(gen, (d_model, d_ff), dtype)
    p["wo"] = dense_init(gen, (d_ff, d_model), dtype,
                         scale=1.0 / math.sqrt(d_ff))
    return p


def mlp(params, x, activation: str = "silu"):
    """Gated MLP ``wo(act(x wg) · x wi)`` with ``act`` silu or tanh-gelu;
    without ``wg`` (the audio encoder's) ``wo(gelu(x wi))``."""
    h = x @ params["wi"]
    if "wg" in params:
        g = x @ params["wg"]
        h = (gelu(g) if activation == "gelu" else silu(g)) * h
    else:
        h = gelu(h)
    return h @ params["wo"]


# ---------------------------------------------------------------------------
# mixture of experts
# ---------------------------------------------------------------------------

def moe_init(gen, cfg: ModelConfig, dtype):
    d, dff, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {
        "router": dense_init(gen, (d, E), dtype, scale=0.02),
        "wi": dense_init(gen, (E, d, dff), dtype),
        "wg": dense_init(gen, (E, d, dff), dtype),
        "wo": dense_init(gen, (E, dff, d), dtype, scale=1.0 / math.sqrt(dff)),
    }


MOE_DENSE_TOKEN_LIMIT = 8192   # below this token count use the exact dense path


def moe_mlp(params, x, cfg: ModelConfig, capacity_factor: float = 1.25):
    """Top-k routed expert MLP; returns ``(out, aux)``, ``aux`` the Switch
    load-balancing loss.  The router's softmax, top-k and normalisation run
    in f32.  Two paths, chosen by the token count T as the reference
    chooses:

    * **dense combine** (T <= ``MOE_DENSE_TOKEN_LIMIT``): every expert on
      every token, weighted by the normalised top-k probabilities; exact;
    * **capacity dispatch**: each (token, slot) takes its place in its
      expert's buffer ``[E, C, d]``, ``C = int(T·k // E · 1.25) or 1``, by
      its running count in token order (found by a stable sort; a cumsum
      down the ``[T·k, E]`` one-hot, as the reference takes it, runs
      serially down each of its E columns on a GPU); entries past ``C``
      are dropped.
      An (expert, place) pair holds at most one kept row, so the buffer is
      an indexed write of the kept rows (the reference adds every entry,
      the dropped ones weighted 0, into place 0 of expert 0: the same
      buffer)."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    T = B * S
    logits = (x @ params["router"]).to(torch.float32)             # [B,S,E]
    probs = torch.softmax(logits, dim=-1)
    top_w, top_idx = torch.topk(probs, k, dim=-1)                 # [B,S,k]
    top_w = top_w / torch.sum(top_w, dim=-1, keepdim=True)

    # Switch-style load-balance aux loss
    me = torch.mean(probs, dim=(0, 1))                            # [E]
    onehot = torch.nn.functional.one_hot(top_idx, E).to(torch.float32)
    ce = torch.mean(torch.sum(onehot, dim=-2), dim=(0, 1)) / k
    aux = E * torch.sum(me * ce)

    if T <= MOE_DENSE_TOKEN_LIMIT:
        combine = torch.sum(onehot.to(x.dtype) * top_w[..., None].to(x.dtype),
                            dim=-2)                               # [B,S,E]
        h = torch.einsum("bsd,edf->bsef", x, params["wi"])
        g = torch.einsum("bsd,edf->bsef", x, params["wg"])
        y = torch.einsum("bsef,efd->bsed", silu(g) * h, params["wo"])
        return torch.einsum("bsed,bse->bsd", y, combine), aux

    # ---- capacity dispatch ----
    C = int(T * k // E * capacity_factor) or 1
    xf = x.reshape(T, d)
    e_idx = top_idx.reshape(T * k)                                # expert per slot
    w = top_w.reshape(T, k).to(x.dtype)
    # place of each (token, slot) within its expert: its running count in
    # token order (the reference's cumsum over the [T*k, E] one-hot), from
    # a stable sort that groups the entries by expert in that order
    order = torch.sort(e_idx, stable=True).indices
    counts = torch.bincount(e_idx, minlength=E)
    starts = torch.cumsum(counts, dim=0) - counts
    pos = torch.empty_like(e_idx)
    pos[order] = torch.arange(T * k, device=x.device) - starts[e_idx[order]]
    keep = pos < C
    buf = torch.zeros((E, C, d), dtype=x.dtype, device=x.device)
    kept = torch.nonzero(keep)[:, 0]
    buf[e_idx[kept], pos[kept]] = xf[kept // k]
    h = torch.einsum("ecd,edf->ecf", buf, params["wi"])
    g = torch.einsum("ecd,edf->ecf", buf, params["wg"])
    y = torch.einsum("ecf,efd->ecd", silu(g) * h, params["wo"])
    e_c, pos_c = torch.where(keep, e_idx, 0), torch.where(keep, pos, 0)
    gathered = y[e_c, pos_c].reshape(T, k, d)
    out = torch.sum(gathered * (w * keep.reshape(T, k).to(x.dtype))[..., None],
                    dim=1)
    return out.reshape(B, S, d), aux


def embedding_init(gen, cfg: ModelConfig, dtype):
    return {"table": embed_init(gen, (cfg.vocab_size, cfg.d_model), dtype)}


def embed(params, tokens):
    return params["table"][tokens]


def head_init(gen, cfg: ModelConfig, dtype):
    return {"w": dense_init(gen, (cfg.d_model, cfg.vocab_size), dtype)}
