"""``build(experiment, device=...) -> Run`` — the port's one entrypoint
(counterpart of ``repro/api/build.py``).

The returned :class:`Run` exposes ``init(gen) -> state``,
``step(state, batch) -> (state, metrics)``, ``views(state)`` (the pytree
train state), ``eval_fn(state) -> float`` (client 0's validation loss on a
fixed batch), ``batch_fn(gen)`` (the synthetic federated stream) and
``participation`` (the spec's ``ParticipationSpec`` as the reference
resolves it, None for the full sampler; with stragglers the step samples
with that spec over-provisioned by ``stragglers.over_provision``, which
``step.participation.spec`` holds).

A spec with ``execution.mesh`` builds inside a ``torch.distributed`` world
of ``data · model`` ranks that is already set up (the train CLI starts one
itself): every rank builds the same run, keeps its block of the state
(``sharding.rules``), and ``place_batch`` keeps its clients' rows of the
batch stream, which every rank draws the same.  ``eval_fn`` then gathers
client 0's rows on rank 0 and every rank gets the loss; ``views`` reads a
whole state (``sharding.rules.gather_state``).  ``execution.overlap`` runs
the overlap schedule with or without a mesh.

The device defaults to ``cuda``; without a card, building raises unless the
caller asks for ``device="cpu"``.  A spec that sets a feature the port does
not run yet is refused with ``NotImplementedError`` naming the feature and
its ROADMAP item — never run with the feature dropped.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.api.spec import Experiment
from repro_torch.federation.participation import ParticipationSpec

EVAL_SEED = 123        # the fixed evaluation batch's generator seed


class Run(NamedTuple):
    spec: Experiment
    init: Any
    step: Any
    views: Any
    eval_fn: Any
    batch_fn: Any
    model: Any
    model_cfg: Any
    fed: Any
    participation: Optional[ParticipationSpec]
    device: torch.device
    place_batch: Any = None
    shard: Any = None

    @property
    def steps(self) -> int:
        return self.spec.schedule.steps


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller names another device; raises when a CUDA
    device is asked for and none is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "(or --device cpu) to run on the CPU")
    return dev


def _resolve_participation(exp: Experiment) -> ParticipationSpec | None:
    """The ParticipationSpec the factories consume: ``None`` for the full
    sampler (the engine's path without participation), and a weighted
    sampler without weights of its own inherits ``problem.client_sizes``."""
    p = exp.participation
    if p.sampler == "full":
        return None
    if (p.sampler == "weighted" and p.client_weights is None
            and exp.problem.client_sizes is not None):
        p = p._replace(client_weights=exp.problem.client_sizes)
    return p


def unported_features(exp: Experiment) -> list:
    """What ``exp`` asks for that the port does not run yet, each with the
    ROADMAP item that ports it."""
    from repro_torch.api import registry

    ex = exp.execution
    algos = "queue 1, 'Remaining algorithms'"
    kernel_training = "queue 1, 'Training through the model kernels'"
    no_grad = ("the reference's train step cannot differentiate through its "
               "Pallas {} kernel: pallas_call has no reverse-mode rule and "
               "the kernel no custom_vjp")
    checks = [
        (exp.algorithm.name not in registry.names(),
         f"algorithm {exp.algorithm.name!r}", algos),
        (ex.use_flash, "execution.use_flash (" + no_grad.format("flash") +
         ")", kernel_training),
        (ex.use_lru_kernel, "execution.use_lru_kernel (" +
         no_grad.format("LRU-scan") + ")", kernel_training),
    ]
    return [f"{what} (ROADMAP {where})" for hit, what, where in checks if hit]


def _resolve_mesh(exp: Experiment):
    """What the factories' ``mesh=`` receives: the
    :class:`~repro_torch.launch.mesh.Mesh` of ``execution.mesh`` over the
    process group that is set up (None off-mesh), or a ``ShardCtx`` on it
    when ``scatter_comm`` asks for the reduce-scatter lowering."""
    ex = exp.execution
    if ex.mesh is None:
        return None
    from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
    if ex.mesh == "production":
        mesh = make_production_mesh()
    else:
        mesh = make_debug_mesh(*ex.mesh)
    if ex.scatter_comm:
        from repro_torch.optim.flat import make_shard_ctx
        return make_shard_ctx(mesh, use_scatter=True)
    return mesh


def federated_config(exp: Experiment):
    """The :class:`~repro_torch.config.FederatedConfig` an Experiment
    denotes."""
    from repro_torch.api import registry
    from repro_torch.config import FederatedConfig

    entry = registry.get(exp.algorithm.name)
    cfg_over, _ = entry.split_params(exp.algorithm.params_dict)
    sch = exp.schedule
    return FederatedConfig(
        algorithm=exp.algorithm.name, num_clients=exp.problem.num_clients,
        local_steps=sch.local_steps, lr_x=sch.lr_x, lr_y=sch.lr_y,
        lr_u=sch.lr_u, hierarchy_period=sch.hierarchy_period,
        hierarchy_groups=sch.hierarchy_groups, neumann_q=sch.neumann_q,
        neumann_tau=sch.neumann_tau, lower_l2=sch.lower_l2, seed=sch.seed,
        **cfg_over)


def checked(experiment: Experiment) -> Experiment:
    """The validated, normalized spec; raises ``SpecError`` for an invalid
    one and ``NotImplementedError`` naming what the port does not run
    yet (:func:`unported_features`)."""
    exp = experiment.validate().normalize()
    missing = unported_features(exp)
    if missing:
        raise NotImplementedError(
            "this experiment sets features the PyTorch port does not run "
            "yet: " + "; ".join(missing))
    return exp


def build(experiment: Experiment, *, device=None) -> Run:
    """Compile an Experiment into a :class:`Run` on ``device``."""
    from repro_torch.api import registry
    from repro_torch.configs import get_config
    from repro_torch.core.tree_util import client_slice, tree_map
    from repro_torch.data.synthetic import make_fed_batch_fn
    from repro_torch.models.registry import build_model

    exp = checked(experiment)
    dev = resolve_device(device)
    prob, ex = exp.problem, exp.execution

    model_cfg = get_config(prob.arch)
    if prob.reduced:
        model_cfg = model_cfg.reduced()
    if prob.param_dtype == "auto":
        dtype = torch.float32 if prob.reduced else torch.bfloat16
    else:
        dtype = getattr(torch, prob.param_dtype)
    model = build_model(model_cfg, dtype=dtype)

    fed = federated_config(exp)
    participation = _resolve_participation(exp)
    mesh = _resolve_mesh(exp)
    entry = registry.get(exp.algorithm.name)
    _, factory_kw = entry.split_params(exp.algorithm.params_dict)
    init, step = entry.factory(
        model, fed, n_micro=ex.n_micro, remat=ex.remat,
        use_flash=ex.use_flash, use_lru_kernel=ex.use_lru_kernel,
        fuse_oracles=ex.fuse_oracles, fuse_storm=ex.fuse_storm,
        storm_block=ex.storm_block, compression=exp.compression,
        participation=participation, stragglers=exp.stragglers,
        faults=exp.faults, robustness=exp.robustness,
        telemetry=exp.telemetry, mesh=mesh, overlap=ex.overlap,
        comm_every=exp.schedule.comm_every_dict or None, **factory_kw)
    shard = getattr(step, "shard", None)

    batch_fn = make_fed_batch_fn(model_cfg, num_clients=prob.num_clients,
                                 per_client=prob.per_client,
                                 seq_len=prob.seq_len, seed=prob.data_seed,
                                 device=dev)
    eval_batch = client_slice(
        batch_fn(torch.Generator().manual_seed(EVAL_SEED))["val"], 0)

    # the fused engine's pytree view; an unfused state is its own
    views = getattr(step, "views", lambda s: s)

    def loss_of(p) -> float:
        with torch.no_grad():
            return float(model.loss(client_slice(p, 0), eval_batch)[0])

    def eval_fn(state) -> float:
        s = views(state)
        return loss_of(s.params if hasattr(s, "params")
                       else {"body": s.x, "head": s.y})

    place_batch = lambda b: b        # noqa: E731
    if shard is not None:
        eval_fn = _sharded_eval(step, shard, loss_of, dev)

        def place_batch(b):
            return tree_map(lambda v: v[shard.rows(v.shape[0])], b)

    return Run(spec=exp, init=init, step=step, views=views,
               eval_fn=eval_fn, batch_fn=batch_fn, model=model,
               model_cfg=model_cfg, fed=fed, participation=participation,
               device=dev, place_batch=place_batch, shard=shard)


def _sharded_eval(step, shard, loss_of, dev):
    """``eval_fn`` on a mesh: client 0's whole rows are gathered on rank 0
    (its data row's ranks send their chunks), rank 0 computes the loss and
    every rank receives it.  A collective: every rank calls it."""
    import torch.distributed as dist

    from repro_torch.optim.flat import unflatten_tree
    from repro_torch.sharding.rules import gather_client

    def eval_fn(state) -> float:
        rows = gather_client(step.spec, state.vars, shard, 0)
        loss = torch.full((1,), float("nan"), dtype=torch.float64)
        if rows is not None:
            vt = unflatten_tree(step.spec, rows)
            loss[0] = loss_of(vt["params"] if "params" in vt
                              else {"body": vt["x"], "head": vt["y"]})
        dist.broadcast(loss, src=0)
        return float(loss[0])

    return eval_fn
