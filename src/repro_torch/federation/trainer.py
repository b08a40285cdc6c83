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

Every factory takes ``mesh=`` (a ``repro_torch.launch.mesh.Mesh`` of
``torch.distributed`` ranks with ``data`` and ``model`` axes, or a prebuilt
``flat.ShardCtx``, the way to reach ``use_scatter``) and ``overlap=``, on
the fused path only: each rank keeps its block of the flat [M, N] buffers
(its clients' rows over ``data``, one column chunk over ``model``), the
fused launches run on the blocks and the means all-reduce partial sums
over the data axis; ``overlap=True`` runs the new-iterate oracle while the
variable reduction is in flight (``repro_torch.optim.sequences``).  The
step then takes the rank's clients' rows of the batch, and
``train_step.views`` a whole state (``sharding.rules.gather_state``).

``fuse_oracles`` picks the fused oracles (one shared linearization) or the
separate ones (``grad_y``, ``nu_direction``, ``u_residual``;
``neumann_hypergrad`` for the local-lower pair), on the
step's one batch either way, as the reference's trainer does.

``fuse_storm=False`` (the default, as in the reference) runs the unfused
tree path: the state is a pytree train state (``FedBiOTrainState`` …
``FedAvgTrainState``), each step tree maps over its leaves in the
reference's order of operations, non-participants are frozen with a
``torch.where`` select, and each sequence communicates through
``sequences.comm_tree`` under its policy (cadences, the hierarchical
schedule, participation weights, staleness discounting).  Faults,
robustness, compression, stragglers and in-band telemetry metrics are
features of the fused engine and are refused there, as the reference
refuses them.  ``n_micro`` splits each client's batch into microbatches
and ``remat`` rematerialises the model's units, on both paths
(``core.model_problem``).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch.func import grad

from repro_torch.api.registry import register
from repro_torch.config import FederatedConfig
from repro_torch.core import hypergrad as hg
from repro_torch.core.model_problem import (_microbatch_mean,
                                            check_model_options,
                                            make_model_bilevel)
from repro_torch.core.tree_util import (client_slice, tree_leaves, tree_map,
                                        tree_stack, tree_zeros_like)
from repro_torch.federation.faults import make_faults
from repro_torch.federation.participation import make_participation
from repro_torch.federation.stragglers import make_stragglers, over_provision
from repro_torch.models.registry import Model
from repro_torch.optim import flat
from repro_torch.optim import sequences as seqs
from repro_torch.optim.sequences import FlatState


# ``stale``, ``deadline`` and ``retry`` on every state: the per-client
# staleness counters [M] int32 of a participation or straggler engine
# (``FlatState.stale``), the straggler engine's round deadline
# (``FlatState.deadline``) and the fault engine's rollback retry counter
# (``FlatState.retry``), each () without one.  The unfused tree path
# carries its own ``stale`` counters (an [M] int32 CPU tensor) only when
# staleness discounting can bite, as the reference's do, and never a
# deadline or a retry counter (empty tuples: no leaves).

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


def _materialize(tree):
    """``tree`` with every leaf in a storage of its own (a broadcast client
    axis becomes M rows), so that a checkpoint can be loaded into it."""
    return tree_map(lambda v: v.contiguous(), tree)


def _f32_zeros_like(tree):
    """The STORM momenta: f32 zeros shaped as ``tree``.  The reference
    starts them in the parameters' dtype and its first step promotes them
    to f32 (a bf16 array times the f32 α schedule), with the same values;
    starting in f32 keeps the state's dtypes the same at every step."""
    return tree_map(lambda v: torch.zeros_like(v, dtype=torch.float32),
                    tree)


def _scalar(v: float, like: torch.Tensor) -> torch.Tensor:
    """A Python float as the reference's weak-typed scalar meets ``like``:
    cast to ``like``'s dtype (a 0-d CPU tensor)."""
    return torch.tensor(v, dtype=like.dtype)


def _sgd(v, g, lr: float):
    """``v − lr·g`` leaf by leaf, ``g`` cast to ``v``'s dtype."""
    return tree_map(lambda a, b: a - _scalar(lr, a) * b.to(a.dtype), v, g)


def _storm_partial(coef, mom, g_old):
    """The partial STORM momentum ``(1 − c·α²)·(m − g_old)``, in f32 (the
    reference promotes the difference by the f32 coefficient)."""
    return tree_map(lambda m, o: coef * (m - o).to(torch.float32), mom,
                    g_old)


def _storm_vars(lr_a, v, mom):
    """``v − (lr·α·m)`` with the product in f32, cast to ``v``'s dtype."""
    return tree_map(
        lambda a, m: a - (lr_a * m.to(torch.float32)).to(a.dtype), v, mom)


def _comm_seqs(cfg, step: int, aspec, trees: dict, weights=None):
    """Communicate trees keyed by section name under their sequences'
    policies and cadences (a momentum goes under its sequence's section,
    ν under "x"); ``weights``: the round's participation weights [M], one
    tensor or a dict by section (staleness-discounted)."""
    by_sec = {q.section: q for q in aspec.sequences}
    w_of = (weights.get if isinstance(weights, dict)
            else lambda name: weights)
    return {name: seqs.comm_tree(cfg, step, t, by_sec[name].comm,
                                 weights=w_of(name),
                                 comm_every=by_sec[name].comm_every)
            for name, t in trees.items()}


def _freeze(mask, new, old):
    """Participation freeze of the tree path: a non-participant's rows keep
    their entering values bit for bit (``torch.where`` selects them; an
    all-ones mask selects ``new`` everywhere)."""
    if mask is None:
        return new

    def one(n, o):
        col = mask.to(n.device).reshape((-1,) + (1,) * (n.dim() - 1))
        return torch.where(col > 0, n, o)

    return tree_map(one, new, old)


def _participation_setup(cfg: FederatedConfig, aspec, participation):
    """The tree path's participation: ``(part, round_ctx, init_stale,
    next_stale)``.  ``round_ctx(step, stale)`` gives the round's ``(mask,
    weights)``: one [M] tensor, or with staleness discounting a dict by
    section of the α^staleness-aged weights (one array per distinct α:
    every sequence takes the spec's ``stale_discount``).  The counters
    (an [M] int32 CPU tensor) exist only when discounting can bite, ``()``
    otherwise, and advance at communication steps as the engine's do."""
    part = make_participation(participation, cfg.num_clients)
    alpha = 1.0 if part is None else float(part.spec.stale_discount)
    discounted = alpha != 1.0

    def round_ctx(step: int, stale=()):
        if part is None:
            return None, None
        mask, w = part.round_weights(step // cfg.local_steps)
        if not discounted:
            return mask, w
        aged = seqs.staleness_weights(w, stale, alpha)
        return mask, {q.section: aged for q in aspec.sequences}

    def init_stale():
        return (torch.zeros(cfg.num_clients, dtype=torch.int32)
                if discounted else ())

    def next_stale(step: int, mask, stale):
        if not discounted:
            return stale
        return seqs.advance_stale(cfg, step, mask, stale)

    return part, round_ctx, init_stale, next_stale


def _tree_pair(init, train_step, part):
    """The unfused (init, train_step) pair: its compiled sampler, and no
    in-band metric groups (the train CLI reads both)."""
    for fn in (init, train_step):
        fn.participation = part
        fn.telemetry_groups = ()
    return init, train_step


def _over_clients(oracle):
    """The per-client ``oracle(v, batch) -> {section: tree}`` looped over the
    leading client axis of ``v`` and ``batch`` (all clients, or a mesh
    rank's), results stacked."""
    def voracle(v, batch):
        m = tree_leaves(v)[0].shape[0]
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

    return _over_clients(oracle), templates, init_trees


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

    return _over_clients(oracle), templates, init_trees


def _straggler_setup(cfg: FederatedConfig, stragglers, participation):
    """Compile the straggler spec and over-provision the sampler: with
    ``over_provision = b`` a counted sampler requests ``min(M, m + b)``
    clients, so the deadline can drop stragglers and still make quorum.
    Returns ``(compiled or None, participation')``."""
    if stragglers is None:
        return None, participation
    return (make_stragglers(stragglers, cfg.num_clients),
            over_provision(stragglers, participation, cfg.num_clients))


def _compress_setup(compression, fuse_storm: bool):
    """Pass the compression spec through to the engine; the compressed
    reductions live on the fused engine only, as in the reference."""
    if compression is not None and not fuse_storm:
        raise ValueError(
            "compression= requires fuse_storm=True — the compressed "
            "reductions are a feature of the fused sequence-spec engine")
    return compression


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


def _shard_setup(mesh, overlap: bool, fuse_storm: bool):
    """Compile the mesh knob into a :class:`flat.ShardCtx` (None without a
    mesh); ``mesh`` may also be a prebuilt ``ShardCtx``.  The sharded
    substrate and the overlap schedule live on the fused engine only, as
    in the reference, which also takes ``overlap`` without a mesh."""
    if (mesh is not None or overlap) and not fuse_storm:
        raise ValueError(
            "mesh=/overlap= require fuse_storm=True — the sharded flat "
            "substrate and the comm/compute overlap schedule are features "
            "of the fused sequence-spec engine")
    if mesh is None:
        return None
    if isinstance(mesh, flat.ShardCtx):
        return mesh
    return flat.make_shard_ctx(mesh)


def _make_flat_pair(cfg: FederatedConfig, aspec, templates, voracle,
                    init_trees, storm_block, to_state, compression=None,
                    participation=None, stragglers=None, faults=None,
                    robustness=None, telemetry=None, shard=None,
                    overlap: bool = False):
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
                              telemetry=telemetry, shard=shard,
                              overlap=overlap)

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
        fn.shard = shard
        fn.compression = compression
        fn.comm_fn = engine.comm_fn
    return init, train_step


def _aspec(name: str, comm_every: dict | None):
    """The algorithm's sequence spec with per-section communication
    cadences applied (the factories' ``comm_every={section: k}`` knob)."""
    aspec = seqs.SPECS[name]
    return seqs.with_comm_every(aspec, comm_every) if comm_every else aspec


def _engine_features(cfg: FederatedConfig, fuse_storm: bool, stragglers,
                     faults, robustness, compression, telemetry):
    """``(faults, robustness, compression, telemetry)`` for the engine;
    on the unfused path each fused-engine feature is refused with the
    reference's message (deadline-driven rounds included)."""
    if stragglers is not None and not fuse_storm:
        raise ValueError(
            "stragglers= requires fuse_storm=True — deadline-driven "
            "elastic rounds are a feature of the fused sequence-spec "
            "engine")
    fault, robust = _fault_setup(cfg, faults, robustness, fuse_storm)
    return (fault, robust, _compress_setup(compression, fuse_storm),
            _telemetry_setup(telemetry, fuse_storm))


def _f32(v) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


def _storm_coef(c: float, a: torch.Tensor) -> torch.Tensor:
    """``1 − c·α²`` in f32, the reference's operation order."""
    return 1.0 - _f32(c) * a * a


@register("fedbioacc", seqs.SPECS["fedbioacc"],
          hparams={"c_nu": 1.0, "c_omega": 1.0, "c_u": 1.0,
                   "alpha_delta": 1.0, "alpha_u0": 8.0},
          cfg_fields=("c_nu", "c_omega", "c_u", "alpha_delta", "alpha_u0"))
def make_fedbioacc_train_step(model: Model, cfg: FederatedConfig, *,
                              n_micro: int = 1, remat: bool = True,
                              use_flash: bool = False,
                              use_lru_kernel: bool = False,
                              fuse_storm: bool = False,
                              fuse_oracles: bool = False,
                              storm_block: int | None = None,
                              compression=None, participation=None,
                              stragglers=None, faults=None, robustness=None,
                              telemetry=None,
                              comm_every: dict | None = None,
                              mesh=None, overlap: bool = False):
    """FedBiOAcc (Alg. 2) train step; returns ``(init(gen) -> state,
    train_step(state, batch) -> (state, metrics))``.  Fused: the state is
    a ``FlatState`` and ``train_step.views(state)`` its pytree view;
    unfused: a ``FedBiOAccTrainState``."""
    fault, robust, comp, tel = _engine_features(
        cfg, fuse_storm, stragglers, faults, robustness, compression,
        telemetry)
    shard = _shard_setup(mesh, overlap, fuse_storm)
    f, g = make_model_bilevel(model, lower_l2=cfg.lower_l2, n_micro=n_micro,
                              remat=remat, use_flash=use_flash,
                              use_lru_kernel=use_lru_kernel)
    aspec = _aspec("fedbioacc", comm_every)
    voracle, templates, init_trees = _global_lower_setup(model, cfg, f, g,
                                                         fuse_oracles)
    if fuse_storm:
        def to_state(vt, mt, step):
            return FedBiOAccTrainState(vt["x"], vt["y"], vt["u"],
                                       mt["omega"], mt["nu"], mt["q"], step)

        return _make_flat_pair(cfg, aspec, templates, voracle, init_trees,
                               storm_block, to_state, comp, participation,
                               stragglers, fault, robust, tel, shard,
                               overlap)
    part, round_ctx, init_stale, next_stale = _participation_setup(
        cfg, aspec, participation)

    def init(gen: torch.Generator) -> FedBiOAccTrainState:
        tr = _materialize(init_trees(gen))
        return FedBiOAccTrainState(
            tr["x"], tr["y"], tr["u"], _f32_zeros_like(tr["y"]),
            _f32_zeros_like(tr["x"]), _f32_zeros_like(tr["u"]), 0,
            init_stale())

    def train_step(state: FedBiOAccTrainState, batch):
        t = state.step
        mask, w = round_ctx(t, state.stale)
        a = seqs.alpha_schedule(cfg, t)
        # 1) the old-iterate oracle first
        gd = voracle({"x": state.x, "y": state.y, "u": state.u}, batch)
        # 2) partial momenta: m ← (1 − c·α²)·(m − g_old)
        omega = _storm_partial(_storm_coef(cfg.c_omega, a), state.omega,
                               gd["y"])
        nu = _storm_partial(_storm_coef(cfg.c_nu, a), state.nu, gd["x"])
        q = _storm_partial(_storm_coef(cfg.c_u, a), state.q, gd["u"])
        del gd
        # 3) the variables with the entering momenta; non-participants
        #    frozen before communication
        x = _freeze(mask, _storm_vars(_f32(cfg.lr_x) * a, state.x,
                                      state.nu), state.x)
        y = _freeze(mask, _storm_vars(_f32(cfg.lr_y) * a, state.y,
                                      state.omega), state.y)
        u = _freeze(mask, _storm_vars(_f32(cfg.lr_u) * a, state.u,
                                      state.q), state.u)
        cd = _comm_seqs(cfg, t, aspec, {"x": x, "y": y, "u": u}, weights=w)
        x, y, u = cd["x"], cd["y"], cd["u"]
        # 4) the new-iterate oracle on the same batch: the correction
        gd2 = voracle({"x": x, "y": y, "u": u}, batch)
        omega = _freeze(mask, tree_map(torch.add, omega, gd2["y"]),
                        state.omega)
        nu = _freeze(mask, tree_map(torch.add, nu, gd2["x"]), state.nu)
        q = _freeze(mask, tree_map(torch.add, q, gd2["u"]), state.q)
        md = _comm_seqs(cfg, t, aspec, {"x": nu, "y": omega, "u": q},
                        weights=w)
        new = FedBiOAccTrainState(x, y, u, md["y"], md["x"], md["u"], t + 1,
                                  next_stale(t, mask, state.stale))
        return new, {"step": new.step}

    return _tree_pair(init, train_step, part)


@register("fedbio", seqs.SPECS["fedbio"])
def make_fedbio_train_step(model: Model, cfg: FederatedConfig, *,
                           n_micro: int = 1, remat: bool = True,
                           use_flash: bool = False,
                           use_lru_kernel: bool = False,
                           fuse_storm: bool = False,
                           fuse_oracles: bool = False,
                           storm_block: int | None = None,
                           compression=None, participation=None,
                           stragglers=None, faults=None, robustness=None,
                           telemetry=None,
                           comm_every: dict | None = None,
                           mesh=None, overlap: bool = False):
    """FedBiO (Alg. 1) train step: alternating SGD on (x, y, u) with the
    global lower problem; fused, one ``sgd3_step`` launch per dtype
    buffer."""
    fault, robust, comp, tel = _engine_features(
        cfg, fuse_storm, stragglers, faults, robustness, compression,
        telemetry)
    shard = _shard_setup(mesh, overlap, fuse_storm)
    f, g = make_model_bilevel(model, lower_l2=cfg.lower_l2, n_micro=n_micro,
                              remat=remat, use_flash=use_flash,
                              use_lru_kernel=use_lru_kernel)
    aspec = _aspec("fedbio", comm_every)
    voracle, templates, init_trees = _global_lower_setup(model, cfg, f, g,
                                                         fuse_oracles)
    if fuse_storm:
        def to_state(vt, mt, step):
            return FedBiOTrainState(vt["x"], vt["y"], vt["u"], step)

        return _make_flat_pair(cfg, aspec, templates, voracle, init_trees,
                               storm_block, to_state, comp, participation,
                               stragglers, fault, robust, tel, shard,
                               overlap)
    part, round_ctx, init_stale, next_stale = _participation_setup(
        cfg, aspec, participation)

    def init(gen: torch.Generator) -> FedBiOTrainState:
        tr = _materialize(init_trees(gen))
        return FedBiOTrainState(tr["x"], tr["y"], tr["u"], 0, init_stale())

    def train_step(state: FedBiOTrainState, batch):
        mask, w = round_ctx(state.step, state.stale)
        gd = voracle({"x": state.x, "y": state.y, "u": state.u}, batch)
        x = _freeze(mask, _sgd(state.x, gd["x"], cfg.lr_x), state.x)
        y = _freeze(mask, _sgd(state.y, gd["y"], cfg.lr_y), state.y)
        u = _freeze(mask, _sgd(state.u, gd["u"], cfg.lr_u), state.u)
        cd = _comm_seqs(cfg, state.step, aspec, {"x": x, "y": y, "u": u},
                        weights=w)
        new = FedBiOTrainState(cd["x"], cd["y"], cd["u"], state.step + 1,
                               next_stale(state.step, mask, state.stale))
        return new, {"step": new.step}

    return _tree_pair(init, train_step, part)


@register("fedbio_local", seqs.SPECS["fedbio_local"])
def make_fedbio_local_train_step(model: Model, cfg: FederatedConfig, *,
                                 n_micro: int = 1, remat: bool = True,
                                 use_flash: bool = False,
                                 use_lru_kernel: bool = False,
                                 fuse_storm: bool = False,
                                 fuse_oracles: bool = False,
                                 storm_block: int | None = None,
                                 compression=None, participation=None,
                                 stragglers=None, faults=None,
                                 robustness=None, telemetry=None,
                                 comm_every: dict | None = None,
                                 mesh=None, overlap: bool = False):
    """FedBiO-Local (Alg. 3) train step: each client keeps its own head y
    (the PRIVATE section, never reduced), the hyper-gradient comes from the
    truncated Neumann series (Eq. 6, Q = ``cfg.neumann_q`` HVPs), and only
    the body x is averaged."""
    fault, robust, comp, tel = _engine_features(
        cfg, fuse_storm, stragglers, faults, robustness, compression,
        telemetry)
    shard = _shard_setup(mesh, overlap, fuse_storm)
    f, g = make_model_bilevel(model, lower_l2=cfg.lower_l2, n_micro=n_micro,
                              remat=remat, use_flash=use_flash,
                              use_lru_kernel=use_lru_kernel)
    aspec = _aspec("fedbio_local", comm_every)
    voracle, templates, init_trees = _local_lower_setup(model, cfg, f, g,
                                                        fuse_oracles)
    if fuse_storm:
        def to_state(vt, mt, step):
            # the state's u slot is unused here: zeros, as the reference
            # has it
            return FedBiOTrainState(vt["x"], vt["y"],
                                    tree_zeros_like(vt["y"]), step)

        return _make_flat_pair(cfg, aspec, templates, voracle, init_trees,
                               storm_block, to_state, comp, participation,
                               stragglers, fault, robust, tel, shard,
                               overlap)
    part, round_ctx, init_stale, next_stale = _participation_setup(
        cfg, aspec, participation)

    def init(gen: torch.Generator) -> FedBiOTrainState:
        tr = _materialize(init_trees(gen))
        return FedBiOTrainState(tr["x"], tr["y"], tree_zeros_like(tr["y"]),
                                0, init_stale())

    def train_step(state: FedBiOTrainState, batch):
        mask, w = round_ctx(state.step, state.stale)
        gd = voracle({"x": state.x, "y": state.y}, batch)
        x = _freeze(mask, _sgd(state.x, gd["x"], cfg.lr_x), state.x)
        y = _freeze(mask, _sgd(state.y, gd["y"], cfg.lr_y), state.y)
        cd = _comm_seqs(cfg, state.step, aspec, {"x": x, "y": y}, weights=w)
        new = FedBiOTrainState(cd["x"], cd["y"], state.u, state.step + 1,
                               next_stale(state.step, mask, state.stale))
        return new, {"step": new.step}

    return _tree_pair(init, train_step, part)


@register("fedbioacc_local", seqs.SPECS["fedbioacc_local"],
          hparams={"c_nu": 1.0, "c_omega": 1.0, "alpha_delta": 1.0,
                   "alpha_u0": 8.0},
          cfg_fields=("c_nu", "c_omega", "alpha_delta", "alpha_u0"))
def make_fedbioacc_local_train_step(model: Model, cfg: FederatedConfig, *,
                                    n_micro: int = 1, remat: bool = True,
                                    use_flash: bool = False,
                                    use_lru_kernel: bool = False,
                                    fuse_storm: bool = False,
                                    fuse_oracles: bool = False,
                                    storm_block: int | None = None,
                                    compression=None, participation=None,
                                    stragglers=None, faults=None,
                                    robustness=None, telemetry=None,
                                    comm_every: dict | None = None,
                                    mesh=None, overlap: bool = False):
    """FedBiOAcc-Local (Alg. 4) train step: STORM momenta on (y, Φ) with
    private lower problems.  The heads y and their momenta ω are the
    PRIVATE section, never reduced; the body x and its momentum ν are
    averaged; fused, one ``storm3_step`` launch per dtype buffer between
    the two evaluations of the (Φ, ω) oracle pair."""
    fault, robust, comp, tel = _engine_features(
        cfg, fuse_storm, stragglers, faults, robustness, compression,
        telemetry)
    shard = _shard_setup(mesh, overlap, fuse_storm)
    f, g = make_model_bilevel(model, lower_l2=cfg.lower_l2, n_micro=n_micro,
                              remat=remat, use_flash=use_flash,
                              use_lru_kernel=use_lru_kernel)
    aspec = _aspec("fedbioacc_local", comm_every)
    voracle, templates, init_trees = _local_lower_setup(model, cfg, f, g,
                                                        fuse_oracles)
    if fuse_storm:
        def to_state(vt, mt, step):
            return FedBiOAccLocalTrainState(vt["x"], vt["y"], mt["omega"],
                                            mt["nu"], step)

        return _make_flat_pair(cfg, aspec, templates, voracle, init_trees,
                               storm_block, to_state, comp, participation,
                               stragglers, fault, robust, tel, shard,
                               overlap)
    part, round_ctx, init_stale, next_stale = _participation_setup(
        cfg, aspec, participation)

    def init(gen: torch.Generator) -> FedBiOAccLocalTrainState:
        tr = _materialize(init_trees(gen))
        return FedBiOAccLocalTrainState(
            tr["x"], tr["y"], _f32_zeros_like(tr["y"]),
            _f32_zeros_like(tr["x"]), 0, init_stale())

    def train_step(state: FedBiOAccLocalTrainState, batch):
        t = state.step
        mask, w = round_ctx(t, state.stale)
        a = seqs.alpha_schedule(cfg, t)
        gd = voracle({"x": state.x, "y": state.y}, batch)
        omega = _storm_partial(_storm_coef(cfg.c_omega, a), state.omega,
                               gd["y"])
        nu = _storm_partial(_storm_coef(cfg.c_nu, a), state.nu, gd["x"])
        del gd
        x = _freeze(mask, _storm_vars(_f32(cfg.lr_x) * a, state.x,
                                      state.nu), state.x)
        y = _freeze(mask, _storm_vars(_f32(cfg.lr_y) * a, state.y,
                                      state.omega), state.y)
        # x averaged, y private
        cd = _comm_seqs(cfg, t, aspec, {"x": x, "y": y}, weights=w)
        x, y = cd["x"], cd["y"]
        gd2 = voracle({"x": x, "y": y}, batch)
        omega = _freeze(mask, tree_map(torch.add, omega, gd2["y"]),
                        state.omega)
        nu = _freeze(mask, tree_map(torch.add, nu, gd2["x"]), state.nu)
        # ν averaged too (Alg. 4 line 14)
        md = _comm_seqs(cfg, t, aspec, {"x": nu, "y": omega}, weights=w)
        new = FedBiOAccLocalTrainState(x, y, md["y"], md["x"], t + 1,
                                       next_stale(t, mask, state.stale))
        return new, {"step": new.step}

    return _tree_pair(init, train_step, part)


@register("fedavg", seqs.SPECS["fedavg"], hparams={"momentum": 0.9})
def make_fedavg_train_step(model: Model, cfg: FederatedConfig, *,
                           n_micro: int = 1, remat: bool = True,
                           momentum: float = 0.9, use_flash: bool = False,
                           use_lru_kernel: bool = False,
                           fuse_storm: bool = False,
                           fuse_oracles: bool = False,   # one oracle: no-op
                           storm_block: int | None = None,
                           compression=None, participation=None,
                           stragglers=None, faults=None, robustness=None,
                           telemetry=None,
                           comm_every: dict | None = None,
                           mesh=None, overlap: bool = False):
    """FedAvg baseline: local heavy-ball SGD on the whole params tree (the
    CE on ``batch["train"]``, averaged over ``n_micro`` microbatches) with
    periodic averaging; fused, one ``momsgd3_step`` launch per dtype
    buffer."""
    fault, robust, comp, tel = _engine_features(
        cfg, fuse_storm, stragglers, faults, robustness, compression,
        telemetry)
    shard = _shard_setup(mesh, overlap, fuse_storm)
    check_model_options(use_flash, use_lru_kernel)
    M = cfg.num_clients

    def one(params, mb):
        return model.loss(params, mb, remat=remat)[0].to(torch.float32)

    def loss_fn(params, batch):
        return _microbatch_mean(one, params, batch, n_micro)

    def oracle(v, batch):
        return {"params": grad(loss_fn)(v["params"], batch["train"])}

    def init_trees(gen):
        return {"params": _bcast(model.init(gen), M)}

    voracle = _over_clients(oracle)
    aspec = _aspec("fedavg", comm_every)._replace(beta=momentum)
    if fuse_storm:
        def to_state(vt, mt, step):
            return FedAvgTrainState(vt["params"], mt["mom"], step)

        return _make_flat_pair(cfg, aspec, {"params": model.init(None)},
                               voracle, init_trees, storm_block, to_state,
                               comp, participation, stragglers, fault,
                               robust, tel, shard, overlap)
    part, round_ctx, init_stale, next_stale = _participation_setup(
        cfg, aspec, participation)

    def init(gen: torch.Generator) -> FedAvgTrainState:
        params = _materialize(init_trees(gen))["params"]
        return FedAvgTrainState(params, tree_zeros_like(params), 0,
                                init_stale())

    def train_step(state: FedAvgTrainState, batch):
        mask, w = round_ctx(state.step, state.stale)
        grads = voracle({"params": state.params}, batch)["params"]
        mom = tree_map(lambda m, gr: _scalar(momentum, m) * m + gr.to(m.dtype),
                       state.mom, grads)
        params = tree_map(
            lambda p, m: p - (_scalar(cfg.lr_x, m) * m).to(p.dtype),
            state.params, mom)
        mom = _freeze(mask, mom, state.mom)
        params = _freeze(mask, params, state.params)
        params = _comm_seqs(cfg, state.step, aspec, {"params": params},
                            weights=w)["params"]
        mom = _comm_seqs(cfg, state.step, aspec, {"params": mom},
                         weights=w)["params"]
        new = FedAvgTrainState(params, mom, state.step + 1,
                               next_stale(state.step, mask, state.stale))
        return new, {"step": new.step}

    return _tree_pair(init, train_step, part)
