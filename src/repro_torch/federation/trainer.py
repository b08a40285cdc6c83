"""Model-scale federated train steps (counterpart of
``repro/federation/trainer.py``; FedBiOAcc on the flat substrate).

Every federated tensor carries a leading client axis M.  The reference
vmaps the oracle over clients; here the oracle is a Python loop over M whose
per-client results are stacked.  The step is the sequence-spec engine of
``repro_torch.optim.sequences``: the old-iterate oracle, one fused
``storm3_step`` kernel launch per dtype buffer, the section-masked client
mean, the new-iterate oracle and the correction add.

Only ``fuse_storm=True`` with ``fuse_oracles=True`` is ported; the unfused
tree path and the other four algorithms wait (ROADMAP queue 1).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.api.registry import register
from repro_torch.config import FederatedConfig
from repro_torch.core import hypergrad as hg
from repro_torch.core.model_problem import make_model_bilevel
from repro_torch.core.tree_util import (client_slice, tree_map, tree_stack,
                                        tree_zeros_like)
from repro_torch.models.registry import Model
from repro_torch.optim import sequences as seqs
from repro_torch.optim.sequences import FlatState


class FedBiOAccTrainState(NamedTuple):
    x: Any
    y: Any
    u: Any
    omega: Any           # y-momentum
    nu: Any              # x-momentum
    q: Any               # u-momentum
    step: int


def _bcast(tree, m: int):
    return tree_map(lambda v: v[None].expand((m,) + tuple(v.shape)), tree)


def _global_lower_setup(model: Model, cfg: FederatedConfig, f, g,
                        fuse_oracles: bool):
    """(voracle, templates, init_trees): the three global-lower oracle
    directions (μ, ω, u-residual p) keyed by section and looped over the
    clients, the x|y|u templates, and the broadcast client init."""
    if not fuse_oracles:
        raise NotImplementedError(
            "the unfused oracles (fuse_oracles=false) are not ported yet "
            "(ROADMAP queue 1, item 'Hypergradient oracles')")
    M = cfg.num_clients

    def oracle(v, batch):
        x, y, u = v["x"], v["y"], v["u"]
        omega, mu, p = hg.fused_oracles(g, f, x, y, u, batch)
        return {"x": mu, "y": omega, "u": p}

    def voracle(v, batch):
        outs = [oracle(client_slice(v, m), client_slice(batch, m))
                for m in range(M)]
        return {s: tree_stack([o[s] for o in outs]) for s in ("x", "y", "u")}

    tmpl = model.init(None)
    templates = {"x": tmpl["body"], "y": tmpl["head"], "u": tmpl["head"]}

    def init_trees(gen):
        p = model.init(gen)
        return {"x": _bcast(p["body"], M), "y": _bcast(p["head"], M),
                "u": _bcast(tree_zeros_like(p["head"]), M)}

    return voracle, templates, init_trees


def _make_flat_pair(cfg: FederatedConfig, aspec, templates, voracle,
                    init_trees, storm_block, to_state):
    """The fuse_storm=True (init, train_step) pair over the engine."""
    engine = seqs.make_engine(cfg, aspec, templates, voracle,
                              block=storm_block)

    def init(gen: torch.Generator) -> FlatState:
        return engine.init_state(init_trees(gen))

    def train_step(state: FlatState, batch):
        new = engine.step(state, batch)
        return new, {"step": new.step}

    def views(state: FlatState):
        vt, mt = engine.views(state)
        return to_state(vt, mt, state.step)

    for fn in (init, train_step):
        fn.spec = engine.spec
        fn.views = views
    return init, train_step


@register("fedbioacc",
          hparams={"c_nu": 1.0, "c_omega": 1.0, "c_u": 1.0,
                   "alpha_delta": 1.0, "alpha_u0": 8.0},
          cfg_fields=("c_nu", "c_omega", "c_u", "alpha_delta", "alpha_u0"),
          sections=("x", "y", "u"))
def make_fedbioacc_train_step(model: Model, cfg: FederatedConfig, *,
                              n_micro: int = 1, remat: bool = False,
                              use_flash: bool = False,
                              use_lru_kernel: bool = False,
                              fuse_storm: bool = False,
                              fuse_oracles: bool = False,
                              storm_block: int | None = None):
    """FedBiOAcc (Alg. 2) train step on the flat substrate; returns
    ``(init(gen) -> FlatState, train_step(state, batch) -> (state,
    metrics))``.  ``train_step.views(state)`` gives the pytree state."""
    if not fuse_storm:
        raise NotImplementedError(
            "the unfused tree-map FedBiOAcc path (fuse_storm=false) is not "
            "ported yet (ROADMAP queue 1, item 'Model-scale FedBiOAcc, spec "
            "API and train CLI')")
    f, g = make_model_bilevel(model, lower_l2=cfg.lower_l2, n_micro=n_micro,
                              remat=remat, use_flash=use_flash,
                              use_lru_kernel=use_lru_kernel)
    voracle, templates, init_trees = _global_lower_setup(model, cfg, f, g,
                                                         fuse_oracles)

    def to_state(vt, mt, step):
        return FedBiOAccTrainState(vt["x"], vt["y"], vt["u"], mt["omega"],
                                   mt["nu"], mt["q"], step)

    return _make_flat_pair(cfg, seqs.SPECS["fedbioacc"], templates, voracle,
                           init_trees, storm_block, to_state)
