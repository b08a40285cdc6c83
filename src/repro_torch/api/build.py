"""``build(experiment, device=...) -> Run`` — the port's one entrypoint
(counterpart of ``repro/api/build.py``).

The returned :class:`Run` exposes ``init(gen) -> state``,
``step(state, batch) -> (state, metrics)``, ``views(state)`` (the pytree
train state), ``eval_fn(state) -> float`` (client 0's validation loss on a
fixed batch) and ``batch_fn(gen)`` (the synthetic federated stream).

The device defaults to ``cuda``; without a card, building raises unless the
caller asks for ``device="cpu"``.  A spec that sets a feature the port does
not run yet is refused with ``NotImplementedError`` naming the feature and
its ROADMAP item — never run with the feature dropped.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.api.spec import Experiment

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
    device: torch.device

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


def unported_features(exp: Experiment) -> list:
    """What ``exp`` asks for that the port does not run yet, each with the
    ROADMAP item that ports it."""
    from repro_torch.api import registry

    ex, sch = exp.execution, exp.schedule
    algos, part = "queue 1, 'Remaining algorithms'", \
        "queue 1, 'Participation, staleness and cadence'"
    guards, shard = "queue 1, 'Faults, robustness and checkpoint " \
        "hardening'", "queue 1, 'Sharded substrate'"
    model_scale = "queue 1, 'Model-scale FedBiOAcc, spec API and train CLI'"
    checks = [
        (exp.algorithm.name not in registry.names(),
         f"algorithm {exp.algorithm.name!r}", algos),
        (exp.participation.sampler != "full",
         f"participation sampling (sampler={exp.participation.sampler!r})",
         part),
        (exp.faults is not None, "faults", guards),
        (exp.robustness is not None, "robustness", guards),
        (exp.telemetry is not None, "telemetry", "queue 1, 'Telemetry'"),
        (exp.stragglers is not None, "stragglers", "queue 1, 'Stragglers'"),
        (ex.mesh is not None, "execution.mesh", shard),
        (ex.overlap, "execution.overlap", shard),
        (ex.scatter_comm, "execution.scatter_comm", shard),
        (sch.hierarchy_period > 0, "schedule.hierarchy_period > 0", part),
        (bool(sch.comm_every), "schedule.comm_every", part),
        (ex.use_flash, "execution.use_flash", "queue 2, kernel 8"),
        (ex.use_lru_kernel, "execution.use_lru_kernel", "queue 2, kernel 9"),
        (not ex.fuse_storm, "execution.fuse_storm=false (the unfused tree "
         "path)", model_scale),
        (not ex.fuse_oracles, "execution.fuse_oracles=false",
         "queue 1, 'Hypergradient oracles'"),
        (ex.n_micro != 1 or ex.remat, "execution.n_micro > 1 / remat",
         model_scale),
    ]
    return [f"{what} (ROADMAP {where})" for hit, what, where in checks if hit]


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


def build(experiment: Experiment, *, device=None) -> Run:
    """Compile an Experiment into a :class:`Run` on ``device``."""
    from repro_torch.api import registry
    from repro_torch.configs import get_config
    from repro_torch.core.tree_util import client_slice
    from repro_torch.data.synthetic import make_fed_batch_fn
    from repro_torch.models.registry import build_model

    exp = experiment.validate().normalize()
    missing = unported_features(exp)
    if missing:
        raise NotImplementedError(
            "this experiment sets features the PyTorch port does not run "
            "yet: " + "; ".join(missing))
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
    entry = registry.get(exp.algorithm.name)
    _, factory_kw = entry.split_params(exp.algorithm.params_dict)
    init, step = entry.factory(
        model, fed, n_micro=ex.n_micro, remat=ex.remat,
        use_flash=ex.use_flash, use_lru_kernel=ex.use_lru_kernel,
        fuse_oracles=ex.fuse_oracles, fuse_storm=ex.fuse_storm,
        storm_block=ex.storm_block, compression=exp.compression,
        **factory_kw)

    batch_fn = make_fed_batch_fn(model_cfg, num_clients=prob.num_clients,
                                 per_client=prob.per_client,
                                 seq_len=prob.seq_len, seed=prob.data_seed,
                                 device=dev)
    eval_batch = client_slice(
        batch_fn(torch.Generator().manual_seed(EVAL_SEED))["val"], 0)

    def eval_fn(state) -> float:
        s = step.views(state)
        p = s.params if hasattr(s, "params") else {"body": s.x, "head": s.y}
        p0 = client_slice(p, 0)
        with torch.no_grad():
            return float(model.loss(p0, eval_batch)[0])

    return Run(spec=exp, init=init, step=step, views=step.views,
               eval_fn=eval_fn, batch_fn=batch_fn, model=model,
               model_cfg=model_cfg, fed=fed, device=dev)
