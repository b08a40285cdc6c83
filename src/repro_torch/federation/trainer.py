"""Model-scale federated train steps (counterpart of
``repro/federation/trainer.py``) on the flat substrate: FedBiO (Alg. 1),
FedBiOAcc (Alg. 2), FedBiO-Local (Alg. 3) and the FedAvg baseline.

Every federated tensor carries a leading client axis M.  The reference
vmaps the oracle over clients; here the oracle is a Python loop over M whose
per-client results are stacked.  The step is the sequence-spec engine of
``repro_torch.optim.sequences``: FedBiOAcc runs its storm kind (one fused
``storm3_step`` launch per dtype buffer between two oracle evaluations),
FedBiO and FedBiO-Local its sgd kind through ``sgd3_step``, FedAvg through
``momsgd3_step``; each step ends in the section-masked client mean.

Every factory takes ``compression=`` (a ``CompressionSpec``): the engine's
reductions then move quantized and/or top-k sends with per-client error
feedback.  Only ``fuse_storm=True`` with ``fuse_oracles=True`` is ported;
the unfused tree path and FedBiOAcc-Local wait (ROADMAP queue 1).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch.func import grad

from repro_torch.api.registry import register
from repro_torch.config import FederatedConfig
from repro_torch.core import hypergrad as hg
from repro_torch.core.model_problem import (check_model_options,
                                            make_model_bilevel)
from repro_torch.core.tree_util import (client_slice, tree_map, tree_stack,
                                        tree_zeros_like)
from repro_torch.models.registry import Model
from repro_torch.optim import sequences as seqs
from repro_torch.optim.sequences import FlatState


class FedBiOTrainState(NamedTuple):
    x: Any               # [M, ...] body
    y: Any               # [M, ...] head (lower variable)
    u: Any               # [M, ...] Eq. (4) auxiliary (zeros on FedBiO-Local)
    step: int


class FedBiOAccTrainState(NamedTuple):
    x: Any
    y: Any
    u: Any
    omega: Any           # y-momentum
    nu: Any              # x-momentum
    q: Any               # u-momentum
    step: int


class FedAvgTrainState(NamedTuple):
    params: Any
    mom: Any
    step: int


def _bcast(tree, m: int):
    return tree_map(lambda v: v[None].expand((m,) + tuple(v.shape)), tree)


def _require_fused_oracles(fuse_oracles: bool) -> None:
    if not fuse_oracles:
        raise NotImplementedError(
            "the unfused oracles (fuse_oracles=false) are not ported yet "
            "(ROADMAP queue 1, item 'Hypergradient oracles')")


def _over_clients(oracle, m: int):
    """The per-client ``oracle(v, batch) -> {section: tree}`` looped over the
    leading client axis of ``v`` and ``batch``, results stacked."""
    def voracle(v, batch):
        outs = [oracle(client_slice(v, i), client_slice(batch, i))
                for i in range(m)]
        return {s: tree_stack([o[s] for o in outs]) for s in outs[0]}

    return voracle


def _private_heads_init(model: Model, gen: torch.Generator, m: int):
    """The body and M per-client heads for the local-lower algorithms, all
    drawn one after another from ``gen`` (the private lower variables are
    never synchronised, so they must not start equal)."""
    p = model.init(gen)
    heads = tree_stack([model.init(gen)["head"] for _ in range(m)])
    return p, heads


def _global_lower_setup(model: Model, cfg: FederatedConfig, f, g,
                        fuse_oracles: bool):
    """(voracle, templates, init_trees) shared by FedBiO and FedBiOAcc: the
    three global-lower oracle directions (μ, ω, u-residual p) keyed by
    section and looped over the clients, the x|y|u templates, and the
    broadcast client init."""
    _require_fused_oracles(fuse_oracles)
    M = cfg.num_clients

    def oracle(v, batch):
        x, y, u = v["x"], v["y"], v["u"]
        omega, mu, p = hg.fused_oracles(g, f, x, y, u, batch)
        return {"x": mu, "y": omega, "u": p}

    tmpl = model.init(None)
    templates = {"x": tmpl["body"], "y": tmpl["head"], "u": tmpl["head"]}

    def init_trees(gen):
        p = model.init(gen)
        return {"x": _bcast(p["body"], M), "y": _bcast(p["head"], M),
                "u": _bcast(tree_zeros_like(p["head"]), M)}

    return _over_clients(oracle, M), templates, init_trees


def _local_lower_setup(model: Model, cfg: FederatedConfig, f, g,
                       fuse_oracles: bool):
    """(voracle, templates, init_trees) of the local-lower algorithms: the
    (Φ, ω) oracle pair keyed by section and looped over the clients, the
    x|y templates, and the broadcast-body / private-heads client init."""
    _require_fused_oracles(fuse_oracles)
    M = cfg.num_clients

    def oracle(v, batch):
        omega, nu = hg.fused_local_oracles(g, f, v["x"], v["y"], batch,
                                           cfg.neumann_q, cfg.neumann_tau)
        return {"x": nu, "y": omega}

    tmpl = model.init(None)
    templates = {"x": tmpl["body"], "y": tmpl["head"]}

    def init_trees(gen):
        p, heads = _private_heads_init(model, gen, M)
        return {"x": _bcast(p["body"], M), "y": heads}

    return _over_clients(oracle, M), templates, init_trees


def _require_fused_storm(fuse_storm: bool) -> None:
    if not fuse_storm:
        raise NotImplementedError(
            "the unfused tree-map path (fuse_storm=false) is not ported yet "
            "(ROADMAP queue 1, item 'Model-scale FedBiOAcc, spec API and "
            "train CLI')")


def _make_flat_pair(cfg: FederatedConfig, aspec, templates, voracle,
                    init_trees, storm_block, to_state, compression=None):
    """The fuse_storm=True (init, train_step) pair over the engine;
    ``to_state(vars, moms or None, step)`` builds the pytree state."""
    engine = seqs.make_engine(cfg, aspec, templates, voracle,
                              block=storm_block, compression=compression)

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
                              storm_block: int | None = None,
                              compression=None):
    """FedBiOAcc (Alg. 2) train step on the flat substrate; returns
    ``(init(gen) -> FlatState, train_step(state, batch) -> (state,
    metrics))``.  ``train_step.views(state)`` gives the pytree state."""
    _require_fused_storm(fuse_storm)
    f, g = make_model_bilevel(model, lower_l2=cfg.lower_l2, n_micro=n_micro,
                              remat=remat, use_flash=use_flash,
                              use_lru_kernel=use_lru_kernel)
    voracle, templates, init_trees = _global_lower_setup(model, cfg, f, g,
                                                         fuse_oracles)

    def to_state(vt, mt, step):
        return FedBiOAccTrainState(vt["x"], vt["y"], vt["u"], mt["omega"],
                                   mt["nu"], mt["q"], step)

    return _make_flat_pair(cfg, seqs.SPECS["fedbioacc"], templates, voracle,
                           init_trees, storm_block, to_state, compression)


@register("fedbio", sections=("x", "y", "u"))
def make_fedbio_train_step(model: Model, cfg: FederatedConfig, *,
                           n_micro: int = 1, remat: bool = False,
                           use_flash: bool = False,
                           use_lru_kernel: bool = False,
                           fuse_storm: bool = False,
                           fuse_oracles: bool = False,
                           storm_block: int | None = None,
                           compression=None):
    """FedBiO (Alg. 1) train step: alternating SGD on (x, y, u) with the
    global lower problem, one fused ``sgd3_step`` launch per dtype buffer."""
    _require_fused_storm(fuse_storm)
    f, g = make_model_bilevel(model, lower_l2=cfg.lower_l2, n_micro=n_micro,
                              remat=remat, use_flash=use_flash,
                              use_lru_kernel=use_lru_kernel)
    voracle, templates, init_trees = _global_lower_setup(model, cfg, f, g,
                                                         fuse_oracles)

    def to_state(vt, mt, step):
        return FedBiOTrainState(vt["x"], vt["y"], vt["u"], step)

    return _make_flat_pair(cfg, seqs.SPECS["fedbio"], templates, voracle,
                           init_trees, storm_block, to_state, compression)


@register("fedbio_local", sections=("x", "y"))
def make_fedbio_local_train_step(model: Model, cfg: FederatedConfig, *,
                                 n_micro: int = 1, remat: bool = False,
                                 use_flash: bool = False,
                                 use_lru_kernel: bool = False,
                                 fuse_storm: bool = False,
                                 fuse_oracles: bool = False,
                                 storm_block: int | None = None,
                                 compression=None):
    """FedBiO-Local (Alg. 3) train step: each client keeps its own head y
    (the PRIVATE section, never reduced), the hyper-gradient comes from the
    truncated Neumann series (Eq. 6, Q = ``cfg.neumann_q`` HVPs), and only
    the body x is averaged."""
    _require_fused_storm(fuse_storm)
    f, g = make_model_bilevel(model, lower_l2=cfg.lower_l2, n_micro=n_micro,
                              remat=remat, use_flash=use_flash,
                              use_lru_kernel=use_lru_kernel)
    voracle, templates, init_trees = _local_lower_setup(model, cfg, f, g,
                                                        fuse_oracles)

    def to_state(vt, mt, step):
        # the state's u slot is unused here: zeros, as the reference has it
        return FedBiOTrainState(vt["x"], vt["y"], tree_zeros_like(vt["y"]),
                                step)

    return _make_flat_pair(cfg, seqs.SPECS["fedbio_local"], templates,
                           voracle, init_trees, storm_block, to_state,
                           compression)


@register("fedavg", hparams={"momentum": 0.9}, sections=("params",))
def make_fedavg_train_step(model: Model, cfg: FederatedConfig, *,
                           n_micro: int = 1, remat: bool = False,
                           momentum: float = 0.9, use_flash: bool = False,
                           use_lru_kernel: bool = False,
                           fuse_storm: bool = False,
                           fuse_oracles: bool = False,   # one oracle: no-op
                           storm_block: int | None = None,
                           compression=None):
    """FedAvg baseline: local heavy-ball SGD on the whole params tree (the
    CE on ``batch["train"]``) with periodic averaging, one fused
    ``momsgd3_step`` launch per dtype buffer."""
    _require_fused_storm(fuse_storm)
    check_model_options(n_micro, remat, use_flash, use_lru_kernel)
    M = cfg.num_clients

    def loss_fn(params, batch):
        return model.loss(params, batch)[0].to(torch.float32)

    def oracle(v, batch):
        return {"params": grad(loss_fn)(v["params"], batch["train"])}

    def init_trees(gen):
        return {"params": _bcast(model.init(gen), M)}

    def to_state(vt, mt, step):
        return FedAvgTrainState(vt["params"], mt["mom"], step)

    aspec = seqs.SPECS["fedavg"]._replace(beta=momentum)
    return _make_flat_pair(cfg, aspec, {"params": model.init(None)},
                           _over_clients(oracle, M), init_trees, storm_block,
                           to_state, compression)
