"""Synthetic federated token streams (counterpart of
``repro/data/synthetic.py``, token streams only).

Each client samples tokens from its own unigram distribution over vocabulary
buckets, drawn from a Dirichlet(``hetero_alpha``) prior (lower concentration
→ more heterogeneous clients); labels are the tokens rolled by one.  The
structure is the reference's; the draws come from ``torch.Generator``s and so
differ from ``jax.random``'s — parity tests hand the reference's batches to
the port.
"""
from __future__ import annotations

import torch

from repro_torch.config import ModelConfig


def make_fed_batch_fn(cfg: ModelConfig, *, num_clients: int, per_client: int,
                      seq_len: int, hetero_alpha: float = 0.5, seed: int = 0,
                      device="cpu"):
    """Returns ``batch_fn(gen) -> {"train": batch, "val": batch}`` with a
    leading client axis M on every leaf, drawn from the CPU generator
    ``gen`` and placed on ``device``."""
    if cfg.family in ("audio", "vlm"):
        raise NotImplementedError(
            f"{cfg.family} streams are not ported yet (ROADMAP queue 1, item "
            f"'Other model families and serving')")
    base = torch.Generator().manual_seed(seed)
    buckets = min(cfg.vocab_size, 1024)
    g = torch._standard_gamma(torch.full((num_clients, buckets), hetero_alpha),
                              generator=base)
    probs = g / torch.sum(g, dim=1, keepdim=True)
    bucket_size = max(cfg.vocab_size // buckets, 1)
    n = per_client * seq_len

    def _tokens(gen):
        b = torch.multinomial(probs + 1e-9, n, replacement=True, generator=gen)
        off = torch.randint(0, bucket_size, (num_clients, n), generator=gen)
        toks = torch.clamp(b * bucket_size + off, max=cfg.vocab_size - 1)
        return toks.reshape(num_clients, per_client, seq_len)

    def one_stream(gen):
        toks = _tokens(gen)
        labels = torch.cat([toks[..., 1:], toks[..., :1]], dim=-1)
        return {"tokens": toks.to(device), "labels": labels.to(device)}

    def batch_fn(gen: torch.Generator):
        return {"train": one_stream(gen), "val": one_stream(gen)}

    return batch_fn
