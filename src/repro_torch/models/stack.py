"""Generic layer stack (counterpart of ``repro/models/stack.py``).

A model is a list of stages; each stage repeats a unit of layer kinds
``reps`` times, its parameters stacked on a leading ``[reps, ...]`` axis
exactly as the reference lays them out.  The reference's ``lax.scan`` over
the stack is a Python loop over layers here.

Layer kinds:
    local  sliding-window GQA attention + FFN (dense MLP or MoE)
    attn   full-context GQA attention + FFN
    rec    Griffin RG-LRU recurrent block + FFN
    ssm    Mamba-2 SSD block (self-contained, no FFN)

``stages_for`` keeps the reference's units, ``("rec", "rec", "attn")`` for
the hybrid family among them, although ``ModelConfig.layer_kinds`` names the
hybrid's attention layers ``"local"``: the unit never matches, so
RecurrentGemma-9B's 38 layers fall into 25 stages of alternating runs
(``rec`` ×2, ``local`` ×1, …, ``rec`` ×2), as in the reference; its params
and caches follow that layout.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.core.tree_util import tree_flatten, tree_map, tree_stack
from repro_torch.models import griffin, ssm
from repro_torch.models.layers import (attention, attn_init, device_of, mlp,
                                       mlp_init, moe_init, moe_mlp, rmsnorm,
                                       rmsnorm_init)

Stage = Tuple[Tuple[str, ...], int]


def stages_for(cfg: ModelConfig) -> List[Stage]:
    kinds = list(cfg.layer_kinds())
    if cfg.family == "hybrid":
        unit: Tuple[str, ...] = ("rec", "rec", "attn")
    elif cfg.attention_pattern == "local_global":
        unit = ("local", "attn")
    else:
        unit = (kinds[0],)
    stages: List[Stage] = []
    i, u = 0, len(unit)
    full = 0
    while i + u <= len(kinds) and tuple(kinds[i:i + u]) == unit:
        full += 1
        i += u
    if full:
        stages.append((unit, full))
    # remainder: consecutive same-kind runs
    while i < len(kinds):
        j = i
        while j < len(kinds) and kinds[j] == kinds[i]:
            j += 1
        stages.append(((kinds[i],), j - i))
        i = j
    return stages


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_layer(gen, kind: str, cfg: ModelConfig, dtype):
    if kind == "ssm":
        return {"ssm": ssm.init_ssm(gen, cfg, dtype)}
    dev = device_of(gen)
    p: Dict[str, Any] = {}
    if kind == "rec":
        p["mix"] = griffin.init_rec(gen, cfg, dtype)
    else:
        p["ln1"] = rmsnorm_init(cfg.d_model, dtype, dev)
        p["mix"] = attn_init(gen, cfg, dtype)
    p["ln2"] = rmsnorm_init(cfg.d_model, dtype, dev)
    p["ffn"] = (moe_init(gen, cfg, dtype) if cfg.num_experts else
                mlp_init(gen, cfg.d_model, cfg.d_ff, dtype,
                         gated=cfg.family != "audio"))
    return p


def _init_unit(gen, unit: Tuple[str, ...], cfg: ModelConfig, dtype):
    return {f"{i}_{kind}": _init_layer(gen, kind, cfg, dtype)
            for i, kind in enumerate(unit)}


def init_stack(gen, cfg: ModelConfig, dtype):
    return [tree_stack([_init_unit(gen, unit, cfg, dtype) for _ in range(reps)])
            for unit, reps in stages_for(cfg)]


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def _layer_cache(kind: str, cfg: ModelConfig, batch: int, cache_len: int,
                 dtype, device):
    if kind == "ssm":
        return ssm.init_ssm_cache(cfg, batch, dtype, device)
    if kind == "rec":
        return griffin.init_rec_cache(cfg, batch, dtype, device)
    length = cache_len
    if kind == "local" and cfg.window_size:
        length = min(cfg.window_size, cache_len)
    shape = (batch, length, cfg.num_kv_heads, cfg.resolved_head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype,
               device=None):
    caches = []
    for unit, reps in stages_for(cfg):
        unit_cache = {f"{i}_{kind}": _layer_cache(kind, cfg, batch, cache_len,
                                                  dtype, device)
                      for i, kind in enumerate(unit)}
        caches.append(tree_map(
            lambda x: x[None].expand((reps,) + tuple(x.shape)).clone(),
            unit_cache))
    return caches


# ---------------------------------------------------------------------------
# apply
# ---------------------------------------------------------------------------

def _apply_layer(kind, p, x, cfg, positions, cache, cache_index, use_flash,
                 use_lru_kernel):
    """Returns ``(x, new_cache, aux)``, ``aux`` the MoE layer's auxiliary
    loss (``None`` for a layer without experts)."""
    aux = None
    if kind == "ssm":
        out, nc = ssm.apply_ssm(p["ssm"], x, cfg, cache)
        return x + out, nc, aux
    if kind == "rec":
        out, nc = griffin.apply_rec(p["mix"], x, cfg, cache,
                                    use_kernel=use_lru_kernel)
    else:
        window = cfg.window_size if kind == "local" else 0
        h = rmsnorm(p["ln1"], x, cfg.norm_eps)
        out, nc = attention(p["mix"], h, cfg, window=window,
                            positions=positions, kv_cache=cache,
                            cache_index=cache_index, use_flash=use_flash)
    x = x + out
    h = rmsnorm(p["ln2"], x, cfg.norm_eps)
    if cfg.num_experts:
        out, aux = moe_mlp(p["ffn"], h, cfg)
    else:
        gelu = cfg.family == "audio" or cfg.logit_softcap
        act = "gelu" if gelu else "silu"
        out = mlp(p["ffn"], h, activation=act)
    return x + out, nc, aux


def _unstack(stage, reps: int) -> list:
    """A stage's ``[reps, ...]`` parameters as ``reps`` per-layer trees, by
    one ``unbind`` a leaf: its gradient is one stack of the layers'
    gradients, where indexing each layer out (``v[r]``) would make each
    layer's gradient a zero-filled copy of the whole stage (memory that
    grows with the square of the depth under the oracles' derivatives)."""
    leaves, treedef = tree_flatten(stage)
    parts = [leaf.unbind(0) for leaf in leaves]
    return [treedef.unflatten([p[r] for p in parts]) for r in range(reps)]


def apply_stack(params, x, cfg: ModelConfig, *, positions=None, caches=None,
                cache_index=None, use_flash: bool = False,
                use_lru_kernel: bool = False):
    """Run all stages.  Returns ``(x, new_caches, aux)``: per stage a dict of
    each unit layer's new cache stacked over ``reps``, and the MoE layers'
    auxiliary losses summed (0 without MoE layers), in the reference's
    order: per stage, over its reps, each rep's unit summed first."""
    new_caches = []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for si, ((unit, reps), stage) in enumerate(zip(stages_for(cfg), params)):
        per_rep, auxs = [], []
        for r, layer in enumerate(_unstack(stage, reps)):
            ncs, unit_aux = {}, 0.0
            for i, kind in enumerate(unit):
                name = f"{i}_{kind}"
                lcache = None if caches is None else \
                    tree_map(lambda v: v[r], caches[si][name])
                x, ncs[name], layer_aux = _apply_layer(
                    kind, layer[name], x, cfg, positions, lcache, cache_index,
                    use_flash, use_lru_kernel)
                if layer_aux is not None:
                    unit_aux = unit_aux + layer_aux
            per_rep.append(ncs)
            auxs.append(unit_aux)
        new_caches.append({name: tree_stack([c[name] for c in per_rep])
                           for name in per_rep[0]})
        if cfg.num_experts:
            aux = aux + torch.sum(torch.stack(auxs))
    return x, new_caches, aux
