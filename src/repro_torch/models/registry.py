"""Top-level model API (counterpart of ``repro/models/registry.py``).

``build_model(cfg, dtype)`` returns a :class:`Model` of plain functions over
nested-dict params ``{"body": ..., "head": ...}``:

* ``init(gen)``              -> params drawn from a ``torch.Generator``, on
  its device; ``init(None)`` -> the same tree as empty ``meta`` tensors;
* ``forward(params, batch)`` -> logits ``[B, S, V]`` in f32;
* ``loss(params, batch)``    -> (masked CE, aux dict).

The body/head split is the bilevel split: the upper variable x is the body,
the lower variable y is the output head.  Prefill and decode are not ported.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.core.tree_util import tree_map
from repro_torch.models import stack as stk
from repro_torch.models.layers import (embed, embedding_init, head_init,
                                       rmsnorm, rmsnorm_init, device_of)


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable
    forward: Callable
    loss: Callable


def build_model(cfg: ModelConfig, dtype=torch.bfloat16) -> Model:
    if cfg.family != "ssm":
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported yet (ROADMAP queue 1, "
            f"item 'Other model families and serving')")

    def init(gen):
        body: Dict[str, Any] = {
            "stages": stk.init_stack(gen, cfg, dtype),
            "final_ln": rmsnorm_init(cfg.d_model, dtype, device_of(gen)),
            "embed": embedding_init(gen, cfg, dtype),
        }
        return {"body": body, "head": head_init(gen, cfg, dtype)}

    def forward(params, batch):
        body, head = params["body"], params["head"]
        x = embed(body["embed"], batch["tokens"])
        x = stk.apply_stack(body["stages"], x, cfg)
        x = rmsnorm(body["final_ln"], x, cfg.norm_eps)
        return (x @ head["w"]).to(torch.float32)

    def loss(params, batch):
        """Masked CE: positions with ``labels < 0`` are ignored."""
        logits = forward(params, batch)
        labels = batch["labels"]
        mask = (labels >= 0).to(torch.float32)
        safe = torch.clamp(labels, min=0).long()
        logp = torch.log_softmax(logits, dim=-1)
        ll = torch.take_along_dim(logp, safe[..., None], dim=-1)[..., 0]
        ce = -torch.sum(ll * mask) / torch.clamp(torch.sum(mask), min=1.0)
        return ce, {"ce": ce}

    return Model(cfg=cfg, init=init, forward=forward, loss=loss)


def _to_torch(a, device) -> torch.Tensor:
    a = np.array(a)          # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        # numpy's bfloat16 (ml_dtypes) is not a dtype torch.from_numpy takes:
        # carry the bits as int16 and reinterpret them
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree, device) -> Any:
    """Carry a parameter tree of numpy arrays (nested dicts/lists, e.g. the
    JAX package's params after ``np.asarray``) into tensors on ``device``,
    bit for bit."""
    return tree_map(lambda a: _to_torch(a, device), tree)
