"""Mamba-2 (SSD) mixer block, chunked formulation (counterpart of
``repro/models/ssm.py``).

Within a chunk of length Q the output is a masked quadratic form; across
chunks a linear recurrence carries the per-chunk states.  The reference's
cross-chunk ``lax.scan`` is a Python loop over chunks here; the einsums are
the reference's.

Decode keeps the O(1) recurrent state ``h: [B, H, P, N]`` and the last
``conv_width - 1`` conv inputs ``conv: [B, W-1, C]``; a prefill returns
both, a decode step (S = 1) advances them.
"""
from __future__ import annotations

import math

import torch

from repro_torch.config import ModelConfig
from repro_torch.models.layers import (dense_init, device_of, normal, rmsnorm,
                                       rmsnorm_init, silu, softplus)


def _dims(cfg: ModelConfig):
    d_inner = cfg.ssm_heads * cfg.ssm_head_dim
    N = cfg.ssm_state
    conv_dim = d_inner + 2 * N           # x, B, C share the conv (ngroups=1)
    return d_inner, N, conv_dim


def init_ssm(gen, cfg: ModelConfig, dtype):
    d = cfg.d_model
    d_inner, N, conv_dim = _dims(cfg)
    H = cfg.ssm_heads
    dev = device_of(gen)
    proj_out = 2 * d_inner + 2 * N + H   # z, x, B, C, dt
    f32 = torch.float32
    return {
        "ln": rmsnorm_init(d, dtype, dev),
        "in_proj": dense_init(gen, (d, proj_out), dtype),
        "conv_w": (normal(gen, (cfg.conv_width, conv_dim)) * 0.1).to(dtype),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, dtype=f32, device=dev)),
        "D": torch.ones((H,), dtype=f32, device=dev),
        "dt_bias": torch.zeros((H,), dtype=f32, device=dev),
        "out_ln": rmsnorm_init(d_inner, dtype, dev),
        "out_proj": dense_init(gen, (d_inner, d), dtype,
                               scale=1.0 / math.sqrt(d_inner)),
    }


def _split_proj(cfg, proj):
    d_inner, N, _ = _dims(cfg)
    H = cfg.ssm_heads
    return torch.split(proj, [d_inner, d_inner, N, N, H], dim=-1)


def _causal_conv(xBC, w, b):
    """Depthwise causal conv over time. xBC: [B, L, C]; w: [W, C]."""
    W, L = w.shape[0], xBC.shape[1]
    pad = torch.nn.functional.pad(xBC, (0, 0, W - 1, 0))
    out = torch.zeros_like(xBC)
    for i in range(W):
        out = out + pad[:, i:i + L, :] * w[i]
    return silu(out + b)


def _segsum(a):
    """a: [..., Q] -> lower-triangular pairwise segment sums [..., Q, Q]."""
    Q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    d = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=a.device))
    return torch.where(mask, d, -torch.inf)


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int):
    """SSD forward.

    x:  [B, L, H, P]   dt: [B, L, H]   A: [H] (negative)
    Bm: [B, L, N]      Cm: [B, L, N]
    Returns (y [B, L, H, P], h_final [B, H, P, N]).
    """
    Bsz, L, H, P = x.shape
    N = Bm.shape[-1]
    Q = chunk
    Lp = ((L + Q - 1) // Q) * Q
    if Lp != L:
        # zero-pad: dt == 0 -> unit decay, zero input
        pad = Lp - L
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        Bm = torch.nn.functional.pad(Bm, (0, 0, 0, pad))
        Cm = torch.nn.functional.pad(Cm, (0, 0, 0, pad))
    L_orig, L = L, Lp
    C = L // Q
    xdt = x * dt[..., None]
    a = (dt * A).to(torch.float32)                            # log decay per step

    xc = xdt.reshape(Bsz, C, Q, H, P)
    ac = a.reshape(Bsz, C, Q, H).permute(0, 3, 1, 2)          # [B,H,C,Q]
    Bc = Bm.reshape(Bsz, C, Q, N)
    Cc = Cm.reshape(Bsz, C, Q, N)

    A_cumsum = torch.cumsum(ac, dim=-1)                       # [B,H,C,Q]
    # 1) intra-chunk (quadratic) term
    Lmat = torch.exp(_segsum(ac))                             # [B,H,C,Q,Q]
    Y_diag = torch.einsum("bcln,bcsn,bhcls,bcshp->bclhp",
                          Cc, Bc, Lmat.to(x.dtype), xc)
    # 2) per-chunk final states
    decay_states = torch.exp(A_cumsum[..., -1:] - A_cumsum)   # [B,H,C,Q]
    states = torch.einsum("bcln,bhcl,bclhp->bchpn",
                          Bc, decay_states.to(x.dtype), xc)   # [B,C,H,P,N]
    # 3) inter-chunk recurrence (the reference's lax.scan)
    chunk_decay = torch.exp(A_cumsum[..., -1])                # [B,H,C]
    h = torch.zeros((Bsz, H, P, N), dtype=x.dtype, device=x.device)
    prev = []
    for c in range(C):
        prev.append(h)
        h = h * chunk_decay[:, :, c][..., None, None].to(x.dtype) + states[:, c]
    prev_states = torch.stack(prev, dim=1)                    # [B,C,H,P,N]
    # 4) inter-chunk output contribution
    state_decay = torch.exp(A_cumsum)                         # [B,H,C,Q]
    Y_off = torch.einsum("bcln,bchpn,bhcl->bclhp",
                         Cc, prev_states, state_decay.to(x.dtype))
    y = (Y_diag + Y_off).reshape(Bsz, L, H, P)[:, :L_orig]
    return y, h


def apply_ssm(params, x, cfg: ModelConfig, cache=None):
    """Mamba-2 block.  Without ``cache`` over a whole sequence (training /
    prefill); with one, a single decode step (S == 1).  Returns
    ``(out, new_cache)``."""
    B, S, _ = x.shape
    d_inner, N, _ = _dims(cfg)
    H, P = cfg.ssm_heads, cfg.ssm_head_dim

    h_in = rmsnorm(params["ln"], x, cfg.norm_eps)
    proj = h_in @ params["in_proj"]
    z, xs, Bm, Cm, dt = _split_proj(cfg, proj)
    xBC = torch.cat([xs, Bm, Cm], dim=-1)

    A = -torch.exp(params["A_log"])                           # [H], negative
    Wc = params["conv_w"].shape[0]

    if cache is None:
        conv_out = _causal_conv(xBC, params["conv_w"], params["conv_b"])
        xs, Bm, Cm = torch.split(conv_out, [d_inner, N, N], dim=-1)
        dtv = softplus(dt.to(torch.float32) + params["dt_bias"])
        xh = xs.reshape(B, S, H, P)
        y, h = ssd_chunked(xh, dtv.to(x.dtype), A.to(x.dtype), Bm, Cm,
                           min(cfg.ssm_chunk, S))
        # the last W-1 conv inputs, left-padded with zeros when S < W-1
        tail = xBC[:, S - (Wc - 1):, :] if S >= Wc - 1 else \
            torch.nn.functional.pad(xBC, (0, 0, Wc - 1 - S, 0))
        new_cache = {"h": h, "conv": tail}
    else:
        conv_buf = torch.cat([cache["conv"], xBC], dim=1)    # [B, Wc, C]
        conv_out = torch.einsum("bwc,wc->bc", conv_buf, params["conv_w"])
        conv_out = silu(conv_out + params["conv_b"])[:, None, :]
        xs, Bm, Cm = torch.split(conv_out, [d_inner, N, N], dim=-1)
        dtv = softplus(dt.to(torch.float32) + params["dt_bias"])[:, 0]  # [B,H]
        xh = xs.reshape(B, S, H, P)
        dec = torch.exp(dtv * A).to(x.dtype)                  # [B,H]
        h = cache["h"] * dec[..., None, None]
        h = h + torch.einsum("bh,bn,bhp->bhpn", dtv.to(x.dtype), Bm[:, 0],
                             xh[:, 0])
        y = torch.einsum("bn,bhpn->bhp", Cm[:, 0], h).reshape(B, 1, H, P)
        new_cache = {"h": h, "conv": conv_buf[:, 1:, :]}

    y = y + params["D"].to(x.dtype)[None, None, :, None] * xh
    y = y.reshape(B, S, d_inner)
    y = rmsnorm(params["out_ln"], y * silu(z), cfg.norm_eps)
    return y @ params["out_proj"], new_cache


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype, device=None):
    _, N, conv_dim = _dims(cfg)
    return {
        "h": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim, N),
                         dtype=dtype, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, conv_dim),
                            dtype=dtype, device=device),
    }
