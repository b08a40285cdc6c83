"""Model-scale federated train steps (counterpart of
``repro/federation/trainer.py``) on the flat substrate: FedBiO (Alg. 1),
FedBiOAcc (Alg. 2), FedBiO-Local (Alg. 3), FedBiOAcc-Local (Alg. 4) and the
FedAvg baseline.

Every federated tensor carries a leading client axis M.  The reference
vmaps the oracle over clients; here the oracle is a Python loop over M whose
per-client results are stacked.  The step is the sequence-spec engine of
``repro_torch.optim.sequences``: FedBiOAcc runs its storm kind (one fused
``storm3_step`` launch per dtype buffer between two oracle evaluations), as
does FedBiOAcc-Local with its PRIVATE heads and their momenta; FedBiO and
FedBiO-Local its sgd kind through ``sgd3_step``, FedAvg through
``momsgd3_step``; each step ends in the section-masked client mean.

Every factory takes ``compression=`` (a ``CompressionSpec``): the engine's
reductions then move quantized and/or top-k sends with per-client error
feedback.  Every factory takes ``participation=`` (a
``federation.participation.ParticipationSpec``): each round samples its
clients, the fused launches freeze the others bit for bit, and the means
average the participants only; the compiled sampler is recorded on
``init.participation`` / ``train_step.participation``.  Every client's
oracle is still computed, as the reference's ``vmap`` computes it, and
``flat.mask_buffers`` zeroes the non-participants' rows.  Every factory
takes ``stragglers=`` (a ``federation.stragglers.StragglerSpec``): each
round then closes at a deadline, the sampler is over-provisioned by the
spec's ``over_provision``, the means average the arrivals only, and the
late-arrival policy decides whether a straggler's rows are frozen; the
compiled spec is recorded on ``init.stragglers`` /
``train_step.stragglers``, and each step's metrics carry the round's
decision.  Every factory takes ``faults=`` / ``robustness=`` (a
``federation.faults.FaultSpec`` / ``RobustnessSpec``): each round injects
the spec's dropout, NaN and byzantine sends, and the means health-screen
and aggregate them robustly; the compiled faults and the robustness spec
are recorded on ``train_step.faults`` / ``train_step.robustness``, and
each step's metrics carry the round's fault masks and health verdicts
(under ``decision``, with the straggler decision).  Every factory takes
``telemetry=`` (a ``telemetry.TelemetrySpec``): each step's metrics then
also carry the in-band metric groups it resolves to
(``train_step.telemetry_groups``), under the reference's keys.

``fuse_oracles`` picks the fused oracles (one shared linearization) or the
separate ones (``grad_y``, ``nu_direction``, ``u_residual``;
``neumann_hypergrad`` for the local-lower pair), on the
step's one batch either way, as the reference's trainer does.  Only
``fuse_storm=True`` is ported; the unfused tree path waits (ROADMAP queue
1).
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
from repro_torch.federation.faults import make_faults
from repro_torch.federation.participation import make_participation
from repro_torch.federation.stragglers import make_stragglers, over_provision
from repro_torch.models.registry import Model
from repro_torch.optim import sequences as seqs
from repro_torch.optim.sequences import FlatState


# ``stale``, ``deadline`` and ``retry`` on every state: the per-client
# staleness counters [M] int32 of a participation or straggler engine
# (``FlatState.stale``), the straggler engine's round deadline
# (``FlatState.deadline``) and the fault engine's rollback retry counter
# (``FlatState.retry``), each () without one.

class FedBiOTrainState(NamedTuple):
    x: Any               # [M, ...] body
    y: Any               # [M, ...] head (lower variable)
    u: Any               # [M, ...] Eq. (4) auxiliary (zeros on FedBiO-Local)
    step: int
    stale: Any = ()
    deadline: Any = ()
    retry: Any = ()


class FedBiOAccTrainState(NamedTuple):
    x: Any
    y: Any
    u: Any
    omega: Any           # y-momentum
    nu: Any              # x-momentum
    q: Any               # u-momentum
    step: int
    stale: Any = ()
    deadline: Any = ()
    retry: Any = ()


class FedBiOAccLocalTrainState(NamedTuple):
    x: Any
    y: Any               # private per-client heads
    omega: Any           # y-momentum (private)
    nu: Any              # x-momentum (averaged with x)
    step: int
    stale: Any = ()
    deadline: Any = ()
    retry: Any = ()


class FedAvgTrainState(NamedTuple):
    params: Any
    mom: Any
    step: int
    stale: Any = ()
    deadline: Any = ()
    retry: Any = ()


def _bcast(tree, m: int):
    return tree_map(lambda v: v[None].expand((m,) + tuple(v.shape)), tree)


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
    M = cfg.num_clients

    def oracle(v, batch):
        x, y, u = v["x"], v["y"], v["u"]
        if fuse_oracles:
            omega, mu, p = hg.fused_oracles(g, f, x, y, u, batch)
        else:
            omega = hg.grad_y(g, x, y, batch)
            mu = hg.nu_direction(g, f, x, y, u, batch, batch)
            p = hg.u_residual(g, f, x, y, u, batch, batch)
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
    M = cfg.num_clients

    def oracle(v, batch):
        x, y = v["x"], v["y"]
        if fuse_oracles:
            omega, nu = hg.fused_local_oracles(g, f, x, y, batch,
                                               cfg.neumann_q, cfg.neumann_tau)
        else:
            omega = hg.grad_y(g, x, y, batch)
            nu = hg.neumann_hypergrad(g, f, x, y, batch, batch,
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


def _straggler_setup(cfg: FederatedConfig, stragglers, participation):
    """Compile the straggler spec and over-provision the sampler: with
    ``over_provision = b`` a counted sampler requests ``min(M, m + b)``
    clients, so the deadline can drop stragglers and still make quorum.
    Returns ``(compiled or None, participation')``."""
    if stragglers is None:
        return None, participation
    return (make_stragglers(stragglers, cfg.num_clients),
            over_provision(stragglers, participation, cfg.num_clients))


def _fault_setup(cfg: FederatedConfig, faults, robustness, fuse_storm: bool):
    """Compile the fault spec (``federation.faults.make_faults``) and pass
    the robustness policy through.  Fault injection and the robust
    reductions live on the fused sequence-spec engine only, as in the
    reference."""
    if faults is None and robustness is None:
        return None, None
    if not fuse_storm:
        raise ValueError(
            "faults=/robustness= require fuse_storm=True — fault injection "
            "and the robust reductions are features of the fused "
            "sequence-spec engine")
    return make_faults(faults, cfg.num_clients), robustness


def _telemetry_setup(telemetry, fuse_storm: bool):
    """Pass the telemetry spec through to the engine.  The in-band metrics
    read the fused engine's flat buffers, so explicit metric groups on the
    unfused path are refused, as the reference refuses them; a
    metrics-free spec (``metrics=()``) is an events-only stream on either
    path and costs the step nothing."""
    if telemetry is None:
        return None
    metrics = getattr(telemetry, "metrics", None)
    if not fuse_storm:
        if metrics:
            raise ValueError(
                "in-band telemetry metrics require fuse_storm=True — they "
                "are a side output of the fused sequence-spec engine; use "
                "metrics=() for an events-only stream")
        return None     # events-only: nothing for the engine to compute
    return telemetry


def _make_flat_pair(cfg: FederatedConfig, aspec, templates, voracle,
                    init_trees, storm_block, to_state, compression=None,
                    participation=None, stragglers=None, faults=None,
                    robustness=None, telemetry=None):
    """The fuse_storm=True (init, train_step) pair over the engine;
    ``to_state(vars, moms or None, step)`` builds the pytree state.  Each
    step's metrics carry ``step`` and what the engine writes
    (``seqs.Engine``): with stragglers or faults the round's decision
    under ``decision``; with telemetry the in-band metric groups of
    ``train_step.telemetry_groups``."""
    strag, participation = _straggler_setup(cfg, stragglers, participation)
    part = make_participation(participation, cfg.num_clients)
    engine = seqs.make_engine(cfg, aspec, templates, voracle,
                              block=storm_block, compression=compression,
                              participation=part, stragglers=strag,
                              faults=faults, robustness=robustness,
                              telemetry=telemetry)

    def init(gen: torch.Generator) -> FlatState:
        return engine.init_state(init_trees(gen))

    def train_step(state: FlatState, batch):
        metrics = {}
        new = engine.step(state, batch, metrics)
        metrics["step"] = new.step
        return new, metrics

    def views(state: FlatState):
        vt, mt = engine.views(state)
        return to_state(vt, mt, state.step)._replace(
            stale=state.stale, deadline=state.deadline, retry=state.retry)

    for fn in (init, train_step):
        fn.spec = engine.spec
        fn.aspec = engine.aspec
        fn.views = views
        fn.participation = part
        fn.stragglers = strag
        fn.faults = faults
        fn.robustness = robustness
        fn.telemetry = telemetry
        fn.telemetry_groups = engine.step.telemetry_groups
    return init, train_step


def _aspec(name: str, comm_every: dict | None):
    """The algorithm's sequence spec with per-section communication
    cadences applied (the factories' ``comm_every={section: k}`` knob)."""
    aspec = seqs.SPECS[name]
    return seqs.with_comm_every(aspec, comm_every) if comm_every else aspec


@register("fedbioacc", seqs.SPECS["fedbioacc"],
          hparams={"c_nu": 1.0, "c_omega": 1.0, "c_u": 1.0,
                   "alpha_delta": 1.0, "alpha_u0": 8.0},
          cfg_fields=("c_nu", "c_omega", "c_u", "alpha_delta", "alpha_u0"))
def make_fedbioacc_train_step(model: Model, cfg: FederatedConfig, *,
                              n_micro: int = 1, remat: bool = False,
                              use_flash: bool = False,
                              use_lru_kernel: bool = False,
                              fuse_storm: bool = False,
                              fuse_oracles: bool = False,
                              storm_block: int | None = None,
                              compression=None, participation=None,
                              stragglers=None, faults=None, robustness=None,
                              telemetry=None,
                              comm_every: dict | None = None):
    """FedBiOAcc (Alg. 2) train step on the flat substrate; returns
    ``(init(gen) -> FlatState, train_step(state, batch) -> (state,
    metrics))``.  ``train_step.views(state)`` gives the pytree state."""
    fault, robust = _fault_setup(cfg, faults, robustness, fuse_storm)
    tel = _telemetry_setup(telemetry, fuse_storm)
    _require_fused_storm(fuse_storm)
    f, g = make_model_bilevel(model, lower_l2=cfg.lower_l2, n_micro=n_micro,
                              remat=remat, use_flash=use_flash,
                              use_lru_kernel=use_lru_kernel)
    voracle, templates, init_trees = _global_lower_setup(model, cfg, f, g,
                                                         fuse_oracles)

    def to_state(vt, mt, step):
        return FedBiOAccTrainState(vt["x"], vt["y"], vt["u"], mt["omega"],
                                   mt["nu"], mt["q"], step)

    return _make_flat_pair(cfg, _aspec("fedbioacc", comm_every), templates,
                           voracle, init_trees, storm_block, to_state,
                           compression, participation, stragglers, fault,
                           robust, tel)


@register("fedbio", seqs.SPECS["fedbio"])
def make_fedbio_train_step(model: Model, cfg: FederatedConfig, *,
                           n_micro: int = 1, remat: bool = False,
                           use_flash: bool = False,
                           use_lru_kernel: bool = False,
                           fuse_storm: bool = False,
                           fuse_oracles: bool = False,
                           storm_block: int | None = None,
                           compression=None, participation=None,
                           stragglers=None, faults=None, robustness=None,
                           telemetry=None,
                           comm_every: dict | None = None):
    """FedBiO (Alg. 1) train step: alternating SGD on (x, y, u) with the
    global lower problem, one fused ``sgd3_step`` launch per dtype buffer."""
    fault, robust = _fault_setup(cfg, faults, robustness, fuse_storm)
    tel = _telemetry_setup(telemetry, fuse_storm)
    _require_fused_storm(fuse_storm)
    f, g = make_model_bilevel(model, lower_l2=cfg.lower_l2, n_micro=n_micro,
                              remat=remat, use_flash=use_flash,
                              use_lru_kernel=use_lru_kernel)
    voracle, templates, init_trees = _global_lower_setup(model, cfg, f, g,
                                                         fuse_oracles)

    def to_state(vt, mt, step):
        return FedBiOTrainState(vt["x"], vt["y"], vt["u"], step)

    return _make_flat_pair(cfg, _aspec("fedbio", comm_every), templates,
                           voracle, init_trees, storm_block, to_state,
                           compression, participation, stragglers, fault,
                           robust, tel)


@register("fedbio_local", seqs.SPECS["fedbio_local"])
def make_fedbio_local_train_step(model: Model, cfg: FederatedConfig, *,
                                 n_micro: int = 1, remat: bool = False,
                                 use_flash: bool = False,
                                 use_lru_kernel: bool = False,
                                 fuse_storm: bool = False,
                                 fuse_oracles: bool = False,
                                 storm_block: int | None = None,
                                 compression=None, participation=None,
                                 stragglers=None, faults=None,
                                 robustness=None, telemetry=None,
                                 comm_every: dict | None = None):
    """FedBiO-Local (Alg. 3) train step: each client keeps its own head y
    (the PRIVATE section, never reduced), the hyper-gradient comes from the
    truncated Neumann series (Eq. 6, Q = ``cfg.neumann_q`` HVPs), and only
    the body x is averaged."""
    fault, robust = _fault_setup(cfg, faults, robustness, fuse_storm)
    tel = _telemetry_setup(telemetry, fuse_storm)
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

    return _make_flat_pair(cfg, _aspec("fedbio_local", comm_every), templates,
                           voracle, init_trees, storm_block, to_state,
                           compression, participation, stragglers,
                           fault, robust, tel)


@register("fedbioacc_local", seqs.SPECS["fedbioacc_local"],
          hparams={"c_nu": 1.0, "c_omega": 1.0, "alpha_delta": 1.0,
                   "alpha_u0": 8.0},
          cfg_fields=("c_nu", "c_omega", "alpha_delta", "alpha_u0"))
def make_fedbioacc_local_train_step(model: Model, cfg: FederatedConfig, *,
                                    n_micro: int = 1, remat: bool = False,
                                    use_flash: bool = False,
                                    use_lru_kernel: bool = False,
                                    fuse_storm: bool = False,
                                    fuse_oracles: bool = False,
                                    storm_block: int | None = None,
                                    compression=None, participation=None,
                                    stragglers=None, faults=None,
                                    robustness=None, telemetry=None,
                                 comm_every: dict | None = None):
    """FedBiOAcc-Local (Alg. 4) train step: STORM momenta on (y, Φ) with
    private lower problems.  The heads y and their momenta ω are the
    PRIVATE section, never reduced; the body x and its momentum ν are
    averaged; one fused ``storm3_step`` launch per dtype buffer between the
    two evaluations of the (Φ, ω) oracle pair."""
    fault, robust = _fault_setup(cfg, faults, robustness, fuse_storm)
    tel = _telemetry_setup(telemetry, fuse_storm)
    _require_fused_storm(fuse_storm)
    f, g = make_model_bilevel(model, lower_l2=cfg.lower_l2, n_micro=n_micro,
                              remat=remat, use_flash=use_flash,
                              use_lru_kernel=use_lru_kernel)
    voracle, templates, init_trees = _local_lower_setup(model, cfg, f, g,
                                                        fuse_oracles)

    def to_state(vt, mt, step):
        return FedBiOAccLocalTrainState(vt["x"], vt["y"], mt["omega"],
                                        mt["nu"], step)

    return _make_flat_pair(cfg, _aspec("fedbioacc_local", comm_every),
                           templates, voracle, init_trees, storm_block,
                           to_state, compression, participation, stragglers,
                           fault, robust, tel)


@register("fedavg", seqs.SPECS["fedavg"], hparams={"momentum": 0.9})
def make_fedavg_train_step(model: Model, cfg: FederatedConfig, *,
                           n_micro: int = 1, remat: bool = False,
                           momentum: float = 0.9, use_flash: bool = False,
                           use_lru_kernel: bool = False,
                           fuse_storm: bool = False,
                           fuse_oracles: bool = False,   # one oracle: no-op
                           storm_block: int | None = None,
                           compression=None, participation=None,
                           stragglers=None, faults=None, robustness=None,
                           telemetry=None,
                           comm_every: dict | None = None):
    """FedAvg baseline: local heavy-ball SGD on the whole params tree (the
    CE on ``batch["train"]``) with periodic averaging, one fused
    ``momsgd3_step`` launch per dtype buffer."""
    fault, robust = _fault_setup(cfg, faults, robustness, fuse_storm)
    tel = _telemetry_setup(telemetry, fuse_storm)
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

    aspec = _aspec("fedavg", comm_every)._replace(beta=momentum)
    return _make_flat_pair(cfg, aspec, {"params": model.init(None)},
                           _over_clients(oracle, M), init_trees, storm_block,
                           to_state, compression, participation, stragglers,
                           fault, robust, tel)
