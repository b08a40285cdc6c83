"""Synthetic federated streams (counterpart of ``repro/data/synthetic.py``'s
``make_fed_batch_fn``), and ``make_model_batch``, a concrete batch of an
input shape.

* tokens: each client samples from its own unigram distribution over
  vocabulary buckets, drawn from a Dirichlet(``hetero_alpha``) prior (lower
  concentration → more heterogeneous clients); labels are the tokens rolled
  by one;
* audio frames: ``0.5·N(0, 1)`` plus a fixed per-client shift
  ``0.3·N(0, 1)`` over ``frontend_dim``, in bf16, with labels drawn
  uniformly from ``[0, vocab)``;
* tokens and labels are int32, the reference's dtype;
* VLM patches: ``0.5·N(0, 1)`` ``[per_client, num_patches, frontend_dim]``
  in bf16, beside the token stream.

The structure is the reference's; the draws come from ``torch.Generator``s
and so differ from ``jax.random``'s — parity tests hand the reference's
batches to the port.  ``make_model_batch`` draws its tokens from
``repro_torch.random`` and equals the reference's bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch import random as jr
from repro_torch.config import InputShape, ModelConfig


def make_fed_batch_fn(cfg: ModelConfig, *, num_clients: int, per_client: int,
                      seq_len: int, hetero_alpha: float = 0.5, seed: int = 0,
                      device="cpu"):
    """Returns ``batch_fn(gen) -> {"train": batch, "val": batch}`` with a
    leading client axis M on every leaf, drawn from the CPU generator
    ``gen`` and placed on ``device``."""
    base = torch.Generator().manual_seed(seed)
    buckets = min(cfg.vocab_size, 1024)
    g = torch._standard_gamma(torch.full((num_clients, buckets), hetero_alpha),
                              generator=base)
    probs = g / torch.sum(g, dim=1, keepdim=True)
    bucket_size = max(cfg.vocab_size // buckets, 1)
    n = per_client * seq_len
    if cfg.family == "audio":
        shift = 0.3 * torch.randn((num_clients, 1, 1, cfg.frontend_dim),
                                  generator=base)

    def _tokens(gen):
        b = torch.multinomial(probs + 1e-9, n, replacement=True, generator=gen)
        off = torch.randint(0, bucket_size, (num_clients, n), generator=gen)
        toks = torch.clamp(b * bucket_size + off, max=cfg.vocab_size - 1)
        return toks.reshape(num_clients, per_client, seq_len).to(torch.int32)

    def _normal(gen, *shape):
        return 0.5 * torch.randn((num_clients, per_client) + shape,
                                 generator=gen)

    def one_stream(gen):
        if cfg.family == "audio":
            frames = _normal(gen, seq_len, cfg.frontend_dim) + shift
            labels = torch.randint(0, cfg.vocab_size,
                                   (num_clients, per_client, seq_len),
                                   generator=gen).to(torch.int32)
            return {"frames": frames.to(torch.bfloat16).to(device),
                    "labels": labels.to(device)}
        toks = _tokens(gen)
        labels = torch.cat([toks[..., 1:], toks[..., :1]], dim=-1)
        batch = {"tokens": toks.to(device), "labels": labels.to(device)}
        if cfg.family == "vlm":
            batch["patches"] = _normal(
                gen, cfg.num_patches, cfg.frontend_dim).to(
                    torch.bfloat16).to(device)
        return batch

    def batch_fn(gen: torch.Generator):
        return {"train": one_stream(gen), "val": one_stream(gen)}

    return batch_fn


def make_model_batch(cfg: ModelConfig, shape: InputShape, *,
                     num_clients: int = 0, dtype=torch.bfloat16,
                     device="cpu") -> dict:
    """A concrete batch of ``shape`` (the shapes of
    ``launch.dryrun.input_specs``): ``[num_clients, B // num_clients, S]``
    leaves with a client axis, ``[B, S]`` without.  Tokens and labels are
    one draw of ``randint(PRNGKey(0))`` over the vocabulary; frames and
    patches are zeros of ``dtype``."""
    B, S = shape.global_batch, shape.seq_len
    lead = (num_clients, B // num_clients) if num_clients else (B,)
    if cfg.family == "audio":
        return {"frames": torch.zeros(lead + (S, cfg.frontend_dim),
                                      dtype=dtype, device=device),
                "labels": torch.zeros(lead + (S,), dtype=torch.int32,
                                      device=device)}
    toks = jr.randint(jr.PRNGKey(0), lead + (S,), 0, cfg.vocab_size)
    batch = {"tokens": toks.to(device), "labels": toks.clone().to(device)}
    if cfg.family == "vlm":
        batch["patches"] = torch.zeros(
            lead + (cfg.num_patches, cfg.frontend_dim), dtype=dtype,
            device=device)
    return batch
