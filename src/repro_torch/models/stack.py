"""Layer stack, ssm family (counterpart of ``repro/models/stack.py``).

A model is a list of stages; each stage repeats a unit of layer kinds
``reps`` times, its parameters stacked on a leading ``[reps, ...]`` axis
exactly as the reference lays them out.  The reference's ``lax.scan`` over
the stack is a Python loop over layers here.
"""
from __future__ import annotations

from typing import List, Tuple

from repro_torch.config import ModelConfig
from repro_torch.core.tree_util import tree_map, tree_stack
from repro_torch.models import ssm

Stage = Tuple[Tuple[str, ...], int]


def stages_for(cfg: ModelConfig) -> List[Stage]:
    kinds = list(cfg.layer_kinds())
    unit = (kinds[0],)
    stages: List[Stage] = []
    i, u = 0, len(unit)
    full = 0
    while i + u <= len(kinds) and tuple(kinds[i:i + u]) == unit:
        full += 1
        i += u
    if full:
        stages.append((unit, full))
    while i < len(kinds):
        j = i
        while j < len(kinds) and kinds[j] == kinds[i]:
            j += 1
        stages.append(((kinds[i],), j - i))
        i = j
    return stages


def _init_unit(gen, unit: Tuple[str, ...], cfg: ModelConfig, dtype):
    out = {}
    for i, kind in enumerate(unit):
        if kind != "ssm":
            raise NotImplementedError(f"layer kind {kind!r} is not ported yet")
        out[f"{i}_{kind}"] = {"ssm": ssm.init_ssm(gen, cfg, dtype)}
    return out


def init_stack(gen, cfg: ModelConfig, dtype):
    return [tree_stack([_init_unit(gen, unit, cfg, dtype) for _ in range(reps)])
            for unit, reps in stages_for(cfg)]


def apply_stack(params, x, cfg: ModelConfig):
    for (unit, reps), stage in zip(stages_for(cfg), params):
        for r in range(reps):
            layer = tree_map(lambda v: v[r], stage)
            for i, kind in enumerate(unit):
                x = x + ssm.apply_ssm(layer[f"{i}_{kind}"]["ssm"], x, cfg)
    return x
