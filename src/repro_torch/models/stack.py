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

import contextlib
from typing import Any, Dict, List, Tuple

import torch
from torch._subclasses.fake_tensor import is_fake
from torch._C._functorch import TransformType
from torch._functorch.pyfunctorch import retrieve_all_functorch_interpreters

from repro_torch.config import ModelConfig
from repro_torch.core.hypergrad import _own_storage
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


def _recorded() -> bool:
    """Whether a backward run now must be recorded.  Under ``torch.func``
    a transform records the backward at its own level, as if its gradient
    were to be differentiated there again, which no transform does: only
    a reverse-mode level below reads that record (a gradient of a
    gradient), and only when the current level passes grad mode on (it
    was entered with grad mode on).  Forward-mode levels do not read grad
    mode.  Without ``torch.func``, grad mode already says whether the
    backward is recorded (``create_graph``)."""
    grads = sorted((i for i in retrieve_all_functorch_interpreters()
                    if i.key() == TransformType.Grad), key=lambda i: i.level())
    if not grads:
        return torch.is_grad_enabled()
    return len(grads) > 1 and grads[-1].prev_grad_mode()


class _Remat(torch.autograd.Function):
    """``fn(*args)`` that keeps only its inputs (the leaves of ``args``)
    and recomputes ``fn`` from them for its derivatives: the backward takes
    the gradient of ⟨``fn``, the output cotangents⟩, the forward
    derivative pushes the input tangents through ``torch.func.jvp`` of
    ``fn`` (``torch.utils.checkpoint``'s saved-tensor hooks do not compose
    with ``torch.func``).  The recomputation repeats ``fn``'s operations,
    so the gradient and its forward derivative equal the plain ones bit
    for bit; a second reverse derivative may round otherwise (it takes a
    weight's cotangents from the output and from the recomputation as two
    products where the plain graph takes one of their sum).  The backward's
    recomputation is recorded only where a derivative of it will be taken
    (:func:`_recorded`), so that its activations are freed unit by unit."""

    @staticmethod
    def forward(fn, treedef, *leaves):
        return fn(*treedef.unflatten(leaves))

    @staticmethod
    def setup_context(ctx, inputs, output):
        fn, treedef, *leaves = inputs
        ctx.fn, ctx.treedef = fn, treedef
        ctx.tuple_out = isinstance(output, tuple)
        outs = output if ctx.tuple_out else (output,)
        ctx.mark_non_differentiable(
            *[o for o in outs if not o.is_floating_point()])
        ctx.save_for_backward(*leaves)
        ctx.save_for_forward(*leaves)

    @staticmethod
    def _of(ctx, leaves, idx):
        """``fn`` as a function of the leaves at ``idx``, the others
        fixed at ``leaves``."""
        def f(*picked):
            full = list(leaves)
            for i, v in zip(idx, picked):
                full[i] = v
            return ctx.fn(*ctx.treedef.unflatten(full))
        return f

    @staticmethod
    def backward(ctx, *cotangents):
        leaves = ctx.saved_tensors
        idx = [i for i, t in enumerate(leaves)
               if ctx.needs_input_grad[2 + i] and t.is_floating_point()]
        f = _Remat._of(ctx, leaves, idx)

        def pulled(*picked):
            # ⟨fn, cotangents⟩: its gradient is the vjp exactly (the
            # cotangent times one), taken inside one transform, so that a
            # Function nested in ``fn`` runs its backward while its level
            # is live (a vjp's pull runs after the level is gone)
            outs = f(*picked)
            outs = outs if ctx.tuple_out else (outs,)
            return sum(torch.sum(o * c) for o, c in zip(outs, cotangents))

        with contextlib.nullcontext() if _recorded() else torch.no_grad():
            grads = torch.func.grad(pulled, argnums=tuple(range(len(idx))))(
                *[leaves[i] for i in idx])
        out = [None] * len(leaves)
        for i, g in zip(idx, grads):
            out[i] = g
        return (None, None, *out)

    @staticmethod
    def jvp(ctx, _fn_tangent, _treedef_tangent, *tangents):
        # a primal that is a slice of a larger storage (a layer unbound
        # from its stage) would give its tangent that whole storage.  A
        # fake primal (a dry run's) is copied whatever its storage: forward
        # AD then refuses the views ``fn`` takes of a saved fake.
        leaves = ctx.saved_tensors
        idx = [i for i, t in enumerate(tangents) if t is not None]
        primals = [leaves[i] for i in idx]
        primals = (_own_storage(primals) if not any(map(is_fake, primals))
                   else [t.clone() for t in primals])
        _, out = torch.func.jvp(
            _Remat._of(ctx, leaves, idx), tuple(primals),
            tuple(_own_storage([tangents[i] for i in idx])))
        return out


def rematerialize(fn, *args):
    """``fn(*args)`` rematerialised (the reference's ``jax.checkpoint``):
    ``args`` are pytrees of tensors, ``fn`` returns a tensor or a tuple of
    tensors; only the leaves of ``args`` are kept for the derivatives, and
    ``fn`` must read no other tensor that is being differentiated."""
    leaves, treedef = tree_flatten(list(args))
    return _Remat.apply(fn, treedef, *leaves)


def _apply_unit(unit, layer, x, cfg, positions, caches, cache_index,
                use_flash, use_lru_kernel):
    """One rep of a stage's unit: its layers in order.  Returns ``(x,
    {layer name: new cache}, the unit's MoE auxiliary loss)`` (0.0 without
    MoE layers)."""
    ncs, unit_aux = {}, 0.0
    for i, kind in enumerate(unit):
        name = f"{i}_{kind}"
        lcache = None if caches is None else caches[name]
        x, ncs[name], layer_aux = _apply_layer(
            kind, layer[name], x, cfg, positions, lcache, cache_index,
            use_flash, use_lru_kernel)
        if layer_aux is not None:
            unit_aux = unit_aux + layer_aux
    return x, ncs, unit_aux


def apply_stack(params, x, cfg: ModelConfig, *, positions=None, caches=None,
                cache_index=None, remat: bool = False,
                use_flash: bool = False, use_lru_kernel: bool = False):
    """Run all stages.  Returns ``(x, new_caches, aux)``: per stage a dict of
    each unit layer's new cache stacked over ``reps``, and the MoE layers'
    auxiliary losses summed (0 without MoE layers), in the reference's
    order: per stage, over its reps, each rep's unit summed first.

    ``remat`` rematerialises each rep of a unit (:func:`rematerialize`),
    where the reference puts ``jax.checkpoint`` around its scan body; it
    runs without caches (training) and returns None for each stage's new
    caches."""
    if remat and caches is not None:
        raise ValueError("remat runs without caches (training only)")
    new_caches = []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for si, ((unit, reps), stage) in enumerate(zip(stages_for(cfg), params)):
        per_rep, auxs = [], []
        for r, layer in enumerate(_unstack(stage, reps)):
            if remat:
                def body(h, p, unit=unit):
                    h, _, unit_aux = _apply_unit(
                        unit, p, h, cfg, positions, None, None, use_flash,
                        use_lru_kernel)
                    return (h, unit_aux) if cfg.num_experts else h
                out = rematerialize(body, x, layer)
                x, unit_aux = out if cfg.num_experts else (out, 0.0)
            else:
                lcaches = None if caches is None else \
                    tree_map(lambda v: v[r], caches[si])
                x, ncs, unit_aux = _apply_unit(
                    unit, layer, x, cfg, positions, lcaches, cache_index,
                    use_flash, use_lru_kernel)
                per_rep.append(ncs)
            auxs.append(unit_aux)
        new_caches.append(None if remat else
                          {name: tree_stack([c[name] for c in per_rep])
                           for name in per_rep[0]})
        if cfg.num_experts:
            aux = aux + torch.sum(torch.stack(auxs))
    return x, new_caches, aux
