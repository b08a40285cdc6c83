"""Top-level model API (counterpart of ``repro/models/registry.py``).

``build_model(cfg, dtype)`` returns a :class:`Model` of plain functions over
nested-dict params ``{"body": ..., "head": ...}``:

* ``init(gen)``              -> params drawn from a ``torch.Generator``, on
  its device; ``init(None)`` -> the same tree as empty ``meta`` tensors;
* ``forward(params, batch)`` -> (logits ``[B, S, V]`` in f32, the MoE
  auxiliary loss);
* ``loss(params, batch)``    -> (masked CE + ``aux_weight`` · aux,
  ``{"ce", "moe_aux"}``);
* ``prefill(params, batch, cache_len)`` -> (last logits ``[B, V]``, caches);
* ``decode_step(params, caches, tokens, pos)`` -> (logits ``[B, V]``,
  caches);
* ``init_cache(batch, cache_len, device)`` -> zeroed caches.

``forward``, ``loss`` and ``prefill`` take the reference's ``use_flash`` and
``use_lru_kernel`` switches: the attention layers' prefill then runs the
flash-attention kernel and the recurrent layers' scan the RG-LRU kernel.
All six families of the reference are ported.  The two front ends are the
reference's stubs: the ``audio`` encoder projects precomputed frames
(``batch["frames"] [B, S, frontend_dim]``, no token embedding, no decode
step); the ``vlm`` projects precomputed patches (``batch["patches"]
[B, P, frontend_dim]``) and places them before the tokens, and ``forward``
drops the patch positions from its logits (the label offset P).

The body/head split is the bilevel split: the upper variable x is the body,
the lower variable y is the output head.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.core.tree_util import tree_map
from repro_torch.models import stack as stk
from repro_torch.models.layers import (_softcap, dense_init, device_of,
                                       embed, embedding_init, head_init,
                                       rmsnorm, rmsnorm_init)

FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable
    forward: Callable
    loss: Callable
    prefill: Callable
    decode_step: Callable
    init_cache: Callable


def _project(x, w):
    """``x @ w`` in the promoted dtype (jnp's matmul promotes a bf16 and an
    f32 operand to f32; torch's refuses the pair)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


def _embed_inputs(body, batch: Dict[str, Any], cfg: ModelConfig):
    """Returns ``(x [B, S_total, d], positions [B, S_total],
    label_offset)``."""
    if cfg.family == "audio":
        x = _project(batch["frames"], body["frontend_proj"])
        offset = 0
    elif cfg.family == "vlm":
        tok = embed(body["embed"], batch["tokens"])
        patches = _project(batch["patches"], body["patch_proj"])
        x = torch.cat([patches.to(tok.dtype), tok], dim=1)
        offset = patches.shape[1]
    else:
        x = embed(body["embed"], batch["tokens"])
        offset = 0
    if cfg.scale_embed:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    return x, positions, offset


def build_model(cfg: ModelConfig, dtype=torch.bfloat16) -> Model:
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown model family {cfg.family!r}; the "
                         f"families are {FAMILIES}")

    def init(gen):
        body: Dict[str, Any] = {
            "stages": stk.init_stack(gen, cfg, dtype),
            "final_ln": rmsnorm_init(cfg.d_model, dtype, device_of(gen)),
        }
        if cfg.family == "audio":
            body["frontend_proj"] = dense_init(
                gen, (cfg.frontend_dim, cfg.d_model), dtype)
        else:
            body["embed"] = embedding_init(gen, cfg, dtype)
            if cfg.family == "vlm":
                body["patch_proj"] = dense_init(
                    gen, (cfg.frontend_dim, cfg.d_model), dtype)
        return {"body": body, "head": head_init(gen, cfg, dtype)}

    def _run(params, x, positions, *, caches=None, cache_index=None,
             remat=False, use_flash=False, use_lru_kernel=False):
        body, head = params["body"], params["head"]
        x, new_caches, aux = stk.apply_stack(
            body["stages"], x, cfg, positions=positions, caches=caches,
            cache_index=cache_index, remat=remat, use_flash=use_flash,
            use_lru_kernel=use_lru_kernel)
        x = rmsnorm(body["final_ln"], x, cfg.norm_eps)
        logits = _softcap((x @ head["w"]).to(torch.float32),
                          cfg.logit_softcap)
        return logits, new_caches, aux

    def forward(params, batch, *, remat=False, use_flash=False,
                use_lru_kernel=False):
        """Logits and the MoE auxiliary loss; ``remat`` rematerialises
        each unit of the layer stack (``stack.apply_stack``)."""
        x, positions, offset = _embed_inputs(params["body"], batch, cfg)
        logits, _, aux = _run(params, x, positions, remat=remat,
                              use_flash=use_flash,
                              use_lru_kernel=use_lru_kernel)
        return logits[:, offset:, :], aux

    def loss(params, batch, *, remat=False, use_flash=False,
             use_lru_kernel=False, aux_weight: float = 0.01):
        """Masked CE plus ``aux_weight`` times the MoE auxiliary loss:
        positions with ``labels < 0`` are ignored."""
        logits, aux = forward(params, batch, remat=remat, use_flash=use_flash,
                              use_lru_kernel=use_lru_kernel)
        labels = batch["labels"]
        mask = (labels >= 0).to(torch.float32)
        safe = torch.clamp(labels, min=0).long()
        logp = torch.log_softmax(logits, dim=-1)
        ll = torch.take_along_dim(logp, safe[..., None], dim=-1)[..., 0]
        ce = -torch.sum(ll * mask) / torch.clamp(torch.sum(mask), min=1.0)
        return ce + aux_weight * aux, {"ce": ce, "moe_aux": aux}

    def init_cache(batch_size: int, cache_len: int, device=None):
        return stk.init_cache(cfg, batch_size, cache_len, dtype, device)

    def prefill(params, batch, cache_len: int, *, use_flash=False,
                use_lru_kernel=False):
        """Run the prompt; return its last logits and the decode caches:
        each attention layer's full-sequence k/v become ring buffers of
        ``min(window, cache_len)`` slots (the reference's pad and roll).
        A VLM's prompt holds its patches first: ``cache_len`` counts them
        and decoding continues at ``num_patches + S``."""
        x, positions, _ = _embed_inputs(params["body"], batch, cfg)
        B, S = positions.shape
        logits, seq_caches, _ = _run(params, x, positions, use_flash=use_flash,
                                     use_lru_kernel=use_lru_kernel)
        caches = init_cache(B, cache_len, x.device)
        new = []
        for (unit, reps), zero_stage, seq_stage in zip(
                stk.stages_for(cfg), caches, seq_caches):
            stage_out = {}
            for i, kind in enumerate(unit):
                name = f"{i}_{kind}"
                if kind in ("rec", "ssm"):
                    stage_out[name] = seq_stage[name]
                    continue
                zk, _ = zero_stage[name]
                sk, sv = seq_stage[name]          # [reps, B, S, hkv, hd]
                L = zk.shape[2]
                Lt = min(S, L)
                tail_k, tail_v = sk[:, :, S - Lt:], sv[:, :, S - Lt:]
                pad = L - Lt
                if pad:
                    tail_k = torch.nn.functional.pad(tail_k,
                                                     (0, 0, 0, 0, 0, pad))
                    tail_v = torch.nn.functional.pad(tail_v,
                                                     (0, 0, 0, 0, 0, pad))
                shift = (S - Lt) % L
                stage_out[name] = (torch.roll(tail_k, shift, dims=2),
                                   torch.roll(tail_v, shift, dims=2))
            new.append(stage_out)
        return logits[:, -1, :], new

    def decode_step(params, caches, tokens, pos):
        """tokens: [B, 1]; pos: a scalar or a [B] vector of 0-based next
        positions (continuous batching).  Runs neither kernel: the
        recurrence takes one step and attention reads the ring buffers."""
        if cfg.family == "audio":
            raise ValueError("encoder-only model has no decode step")
        x = embed(params["body"]["embed"], tokens)
        if cfg.scale_embed:
            x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
        B = x.shape[0]
        pos = torch.as_tensor(pos, device=x.device)
        positions = (pos.reshape(1, 1).expand(B, 1) if pos.dim() == 0
                     else pos[:, None])
        logits, new_caches, _ = _run(params, x, positions, caches=caches,
                                     cache_index=pos)
        return logits[:, 0, :], new_caches

    return Model(cfg=cfg, init=init, forward=forward, loss=loss,
                 prefill=prefill, decode_step=decode_step,
                 init_cache=init_cache)


def _to_torch(a, device) -> torch.Tensor:
    a = np.array(a)  # analysis: ignore[L303] host array; a writable, contiguous copy
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
