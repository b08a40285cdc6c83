"""Shared building blocks (counterpart of ``repro/models/layers.py``; the
subset the Mamba-2 path needs).

Params are nested dicts of tensors with the reference's keys.  Initialisers
draw from an explicit ``torch.Generator``; with ``gen=None`` they return
empty tensors on the ``meta`` device (shapes and dtypes only — the flat
layout's templates).  Compute dtype follows the input; normalisation
statistics are f32.
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


def embedding_init(gen, cfg: ModelConfig, dtype):
    return {"table": embed_init(gen, (cfg.vocab_size, cfg.d_model), dtype)}


def embed(params, tokens):
    return params["table"][tokens]


def head_init(gen, cfg: ModelConfig, dtype):
    return {"w": dense_init(gen, (cfg.d_model, cfg.vocab_size), dtype)}
