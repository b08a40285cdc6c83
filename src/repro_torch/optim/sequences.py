"""Sequence-spec engine (counterpart of ``repro/optim/sequences.py``).

An algorithm is a tuple of named optimizer sequences — (variable section,
momentum, lr key, STORM-constant key, communication policy) — compiled onto
the flat substrate of ``repro_torch.optim.flat``.  Two kinds of step:

* ``storm``: old-iterate oracle → fused ``storm3_step`` launch per dtype
  buffer → section-masked client mean of the variables → new-iterate oracle
  → correction add → client mean of the momenta (FedBiOAcc);
* ``sgd``: one oracle → fused ``momsgd3_step`` launch per dtype buffer and
  the client mean of the momenta (heavy ball, FedAvg), or a fused
  ``sgd3_step`` launch when the spec carries no momentum (FedBiO,
  FedBiO-Local) → client mean of the variables.

The same policies drive the trainers' unfused tree paths through
:func:`comm_tree`, so that both paths see the same communication events.

Ported so far: both kinds with the three policies (AVERAGED, PRIVATE, and
HIERARCHICAL: with ``cfg.hierarchy_period = k > 0`` only every k-th round
takes the full mean and the others the pod-local mean of
``cfg.hierarchy_groups`` contiguous client groups, while AVERAGED sections
keep the full mean; ``k = 0`` is the paper's flat averaging), per-sequence
cadences (``Sequence.comm_every = k``: the section enters a reduction only
every k-th round, :func:`with_comm_every`), compressed communication
(``compression=``: quantized and/or top-k sends, per-client error feedback
on ``FlatState.ef``, also weighted by participation, by arrivals or by
pod), partial participation
(``participation=``: the round's client mask gates the fused launches and
zeroes non-participants' oracle contributions, the reductions average
participants only, and per-client staleness counters on ``FlatState.stale``
age returning clients' weights by α^k) and stragglers (``stragglers=``:
each round's arrival set, decided on the host against the deadline on
``FlatState.deadline``, narrows the mean to the arrivals and, under the
``drop`` and ``cancel`` policies, the launch mask too) and faults
(``faults=``: each round's ``(keep, nan, byz)`` masks, drawn on the host
from the round and the retry count on ``FlatState.retry``; ``keep``
narrows the launch mask and the weights, and the corruption and
``robustness=``'s guarded reductions act inside both means) and telemetry
(``telemetry=``: the resolved metric groups are computed beside each step
from its flat buffers, into the step's metrics dict); no per-sequence
staleness discount.  The step's phases (oracles, fused update,
reductions, metric passes) carry ``telemetry.annotate`` ranges for a
profiler trace.

Mesh sharding and the overlap schedule (``shard=``, ``overlap=``): with a
:class:`flat.ShardCtx` the spec is built with ``shards =`` the mesh's
model-axis size, and each rank of the ``[data, model]`` mesh keeps its
block of every buffer (its M/d clients' rows, one model chunk;
``repro_torch.sharding.rules``).  The fused launches run on the blocks and
the reductions all-reduce partial sums over the data axis
(:func:`flat.client_mean_masked` with ``shard=``).  The oracle needs whole
parameter rows, so each rank all-gathers its clients' rows over the model
axis, runs the oracle for its clients, flattens the result and keeps its
chunk: the k ranks of a data row compute the same oracle.
``overlap=True`` issues the variable reduction of a communication step
without waiting, runs the new-iterate oracle on the local iterate from
before the reduction (the reference's documented deviation at
communication steps; every other step is unchanged), then waits and
consumes the reduction; without a mesh the same schedule runs with a
synchronous reduction.  The round's masks, weights, arrivals, deadline and
fault masks are decided on the host from the step counter (and the
deadline and retry count every rank holds), so every rank decides the
same round; the guarded means gather the screen's verdicts of every
client, and the in-band metric passes complete their partial sums over
the mesh (``flat.section_norms`` … ``flat.health_screen`` with
``shard=``), so every rank holds the whole metric.

The step counter lives on the host (``FlatState.step`` is a Python int), so
whether a step communicates is decided without reading the device; so do
the participation masks, weights and staleness counters, and the
stragglers' arrival masks and deadline, which are copied to the buffers'
device where a launch or a reduction uses them.  The
STORM schedule α_t and the per-section (lr, decay) scalars are f32 tensors
on the CPU, computed with the JAX package's f32 operation order, so the
per-tile tables agree with the reference's; the sgd kind's lrs and β are
the plain config values as f32.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.distributed as dist

from repro_torch.core.tree_util import (client_mean, client_mean_grouped,
                                        client_mean_grouped_weighted,
                                        client_mean_weighted, tree_map)
from repro_torch.federation.stragglers import arrival_histogram
from repro_torch.optim import flat
from repro_torch.telemetry.spec import resolve_metric_groups
from repro_torch.telemetry.trace import annotate

AVERAGED = "averaged"
HIERARCHICAL = "hierarchical"
PRIVATE = "private"


class Sequence(NamedTuple):
    """One named optimizer sequence: a variable section and its momentum."""
    section: str
    momentum: str
    lr: str                   # FederatedConfig field holding the lr
    decay: str | None = None  # FederatedConfig field of the STORM constant
    comm: str = HIERARCHICAL  # AVERAGED | HIERARCHICAL | PRIVATE
    comm_every: int = 1       # reduce only every k-th comm round (cadence)


class AlgoSpec(NamedTuple):
    """Declarative algorithm description the engine compiles."""
    name: str
    kind: str                 # "storm" (two-oracle STORM) | "sgd" (heavy ball)
    sequences: tuple
    beta: float = 0.0         # heavy-ball momentum ("sgd" kind; 0 = plain SGD)
    carry_momentum: bool = False  # keep momentum state even at beta == 0

    @property
    def sections(self):
        return tuple(s.section for s in self.sequences)

    @property
    def policies(self):
        return tuple(s.comm for s in self.sequences)

    @property
    def has_momentum(self) -> bool:
        return self.kind == "storm" or self.beta != 0.0 or self.carry_momentum

    def without_hierarchy(self) -> "AlgoSpec":
        """HIERARCHICAL → AVERAGED: the paper's flat averaging whatever
        ``cfg.hierarchy_period`` says (the problem-level algorithms use it,
        so that ``fuse_storm`` changes how they run and nothing else)."""
        return self._replace(sequences=tuple(
            q._replace(comm=AVERAGED) if q.comm == HIERARCHICAL else q
            for q in self.sequences))


# FedAvg's β is a factory knob, not a cfg field: its maker replaces it.
SPECS = {
    "fedbio": AlgoSpec("fedbio", "sgd", (
        Sequence("x", "nu", "lr_x"),
        Sequence("y", "omega", "lr_y"),
        Sequence("u", "q", "lr_u"),
    )),
    "fedbioacc": AlgoSpec("fedbioacc", "storm", (
        Sequence("x", "nu", "lr_x", "c_nu"),
        Sequence("y", "omega", "lr_y", "c_omega"),
        Sequence("u", "q", "lr_u", "c_u"),
    )),
    "fedbio_local": AlgoSpec("fedbio_local", "sgd", (
        Sequence("x", "nu", "lr_x"),
        Sequence("y", "omega", "lr_y", comm=PRIVATE),
    )),
    "fedbioacc_local": AlgoSpec("fedbioacc_local", "storm", (
        Sequence("x", "nu", "lr_x", "c_nu"),
        Sequence("y", "omega", "lr_y", "c_omega", comm=PRIVATE),
    )),
    "fedavg": AlgoSpec("fedavg", "sgd", (
        Sequence("params", "mom", "lr_x"),
    ), beta=0.9, carry_momentum=True),
}


def with_comm_every(aspec: AlgoSpec, cadences: dict) -> AlgoSpec:
    """Override per-sequence communication cadences by section name (the
    ``Experiment.schedule.comm_every`` knob): ``{"u": 2}`` makes the u
    sequence enter a reduction only every 2nd communication round."""
    unknown = set(cadences) - set(aspec.sections)
    if unknown:
        raise ValueError(f"comm_every names unknown sections "
                         f"{sorted(unknown)} (spec {aspec.name!r} has "
                         f"{aspec.sections})")
    if any(int(k) < 1 for k in cadences.values()):
        raise ValueError(f"comm_every cadences must be >= 1: {cadences}")
    return aspec._replace(sequences=tuple(
        q._replace(comm_every=int(cadences[q.section]))
        if q.section in cadences else q
        for q in aspec.sequences))


def _f32(v) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


def alpha_schedule(cfg, t: int) -> torch.Tensor:
    """α_t = δ/(u0 + t)^{1/3} as a 0-d f32 CPU tensor, computed as the
    reference's compiled step computes it: every operand f32, and the
    division by the power taken as ``δ · (u0 + t)^(−1/3)`` (XLA's algebraic
    simplifier rewrites it so; the two differ in the last bit)."""
    return _f32(cfg.alpha_delta) * (_f32(cfg.alpha_u0) + _f32(t)) ** _f32(-1.0 / 3.0)


def _round_preds(cfg, step: int):
    is_comm = (step + 1) % cfg.local_steps == 0
    round_idx = (step + 1) // cfg.local_steps
    is_global = round_idx % max(cfg.hierarchy_period, 1) == 0
    return is_comm, is_global


def staleness_weights(w, stale, alpha: float):
    """α^staleness-aged participation weights [M] (``w`` itself at α = 1).
    α^k is taken in f64 from the f32 α and rounded once; the reference's
    f32 ``pow`` agrees exactly for α a power of two and may differ by an
    ulp otherwise."""
    if alpha == 1.0:
        return w
    return w * (_f32(alpha).double() ** stale.to(torch.float64)).to(
        torch.float32)


def advance_stale(cfg, step: int, mask, stale):
    """Advance per-client staleness counters at communication steps:
    participants reset to 0, absentees age by 1."""
    if (step + 1) % cfg.local_steps != 0:
        return stale
    return torch.where(mask > 0, 0, stale + 1).to(torch.int32)


def comm_tree(cfg, step: int, tree, policy: str, *, weights=None,
              comm_every: int = 1):
    """Apply one sequence's communication policy to a pytree with a
    leading client axis (the unfused train steps), decided on the host
    from the step: ``PRIVATE`` passes the tree through; otherwise only a
    communication step reduces (and with ``comm_every = k`` only every k-th
    round), with the full client mean, or at a pod-local round of the
    hierarchical schedule (HIERARCHICAL, ``cfg.hierarchy_period > 0``) the
    grouped mean of ``cfg.hierarchy_groups`` pods.  ``weights``: the
    round's participation weights [M] (zero: a non-participant, whose rows
    pass through bit for bit); the weighted means then."""
    if policy == PRIVATE:
        return tree
    is_comm, is_global = _round_preds(cfg, step)
    round_idx = (step + 1) // cfg.local_steps
    if not is_comm or round_idx % comm_every:
        return tree
    if policy == AVERAGED or cfg.hierarchy_period <= 0 or is_global:
        return (client_mean(tree) if weights is None
                else client_mean_weighted(tree, weights))
    return (client_mean_grouped(tree, cfg.hierarchy_groups)
            if weights is None else
            client_mean_grouped_weighted(tree, cfg.hierarchy_groups, weights))


def comm_buffers(spec: flat.FlatSpec, cfg, step: int, bufs, policies, *,
                 weights=None, comm_every=None, corrupt=None, robust=None,
                 verdicts=None, compress=None, ef=(), shard=None,
                 pending=None):
    """Apply the per-section policies to flat [M, N] buffers at a
    communication step: one masked reduction per communicated run, private
    sections untouched.  Other steps return ``bufs`` as they are.

    ``weights``: participation weights, one [M] tensor (or None) or one
    per section: the means are over participants only.
    ``comm_every``: per-section cadences: a section reduces only at the
    rounds its cadence divides; the sections of one cadence share one
    reduction.  At a pod-local round (``cfg.hierarchy_period > 0`` and the
    round not a multiple of it) HIERARCHICAL sections take the grouped mean
    of ``cfg.hierarchy_groups`` pods and AVERAGED sections the full mean.
    ``corrupt`` / ``robust`` / ``verdicts``: the round's fault transform,
    the :class:`flat.RobustCfg` and a list for the health verdicts, as
    :func:`flat.client_mean_masked` takes them (not with the hierarchical
    schedule).
    ``compress`` / ``ef``: a :class:`flat.CompressCfg` and the current
    error-feedback buffers; with ``compress`` set the call returns
    ``(bufs, ef)``, and a section that does not reduce leaves both as they
    are.
    ``shard`` / ``pending``: a :class:`flat.ShardCtx` (``bufs`` are then a
    rank's blocks) and the list of reductions issued without waiting, as
    :func:`flat.client_mean_masked` takes them."""
    n = len(policies)
    ce = tuple(comm_every) if comm_every is not None else (1,) * n
    if len(ce) != n or any(c < 1 for c in ce):
        raise ValueError(f"comm_every {ce} for {n} sections")
    w_of_sec = (tuple(weights) if isinstance(weights, (tuple, list))
                else (weights,) * n)
    is_comm, is_global = _round_preds(cfg, step)
    round_idx = (step + 1) // cfg.local_steps
    for c in sorted(set(ce)):
        live = [i for i in range(n) if ce[i] == c and policies[i] != PRIVATE]
        if not is_comm or not live or round_idx % c:
            continue
        hier = cfg.hierarchy_period > 0 and any(
            policies[i] == HIERARCHICAL for i in live)
        if hier and (corrupt is not None or robust is not None):
            raise ValueError(
                "corrupt/robust do not compose with the hierarchical grouped "
                "mean (hierarchy_period > 0)")
        local = hier and not is_global
        # pod-local rounds: HIERARCHICAL sections take the grouped mean
        # while AVERAGED sections still take the full mean
        modes = tuple("none" if i not in live else
                      "group" if local and policies[i] == HIERARCHICAL
                      else "mean" for i in range(n))
        out = flat.client_mean_masked(
            spec, bufs, modes, num_groups=cfg.hierarchy_groups,
            weights=tuple(w_of_sec[i] if i in live else None
                          for i in range(n)),
            corrupt=corrupt, robust=robust, verdicts=verdicts,
            compress=compress, ef=ef, shard=shard, pending=pending)
        bufs, ef = (out, ef) if compress is None else out
    return bufs if compress is None else (bufs, ef)


class FlatState(NamedTuple):
    """Train state on the flat substrate: per-dtype [M, N] variable and f32
    momentum buffers (``()`` when the spec carries no momentum), the
    host-side step counter, the per-client error-feedback buffers of top-k
    compressed communication (a ``(vars_ef, mom_ef)`` pair of f32 buffer
    tuples shaped like ``vars``/``mom``, or ``()`` when compression is off
    or carries no feedback), the per-client staleness counters (rounds
    missed since the last participation or arrival: an [M] int32 CPU tensor
    when participation or stragglers are attached, ``()`` otherwise), and
    the adaptive round deadline of the straggler engine (a 0-d f32 CPU
    tensor, moved once a round by the EMA; ``()`` without stragglers), and
    the rollback retry counter of the fault engine (a 0-d int32 CPU tensor,
    folded into the fault draws and set by ``RollbackGuard``; ``()``
    without faults).  ``retry`` comes last so that positional
    constructions and ``checkpoint/io.py``'s field mapping keep their
    order."""
    vars: Any
    mom: Any
    step: int
    ef: Any = ()
    stale: Any = ()
    deadline: Any = ()
    retry: Any = ()


class Engine(NamedTuple):
    """A compiled sequence spec: ``init_state(var_trees, mom_trees=None,
    step=0, ef=None, stale=None, deadline=None, retry=None)``,
    ``step(state, batch, metrics=None) -> state`` and ``views(state) ->
    (var_dict, mom_dict)`` (``mom_dict`` None without momentum).  On a mesh
    (``shard``, a :class:`flat.ShardCtx`) ``init_state`` takes the trees of
    every client and keeps the rank's blocks, ``step`` takes the rank's
    clients' rows of the batch, and ``views`` reads a whole state
    (``sharding.rules.gather_state``).

    ``comm_fn(state) -> state`` is the communication-only subprogram of
    ``step``: the round context and the policy reductions (variables, then
    momenta) on copies of the state's buffers, with no oracle and no fused
    launch.  Training never calls it; ``repro_torch.analysis`` records its
    collectives alone (the wire audit).

    Given a ``metrics`` dict, ``step`` writes into it.  Its round's
    decision goes under ``metrics["decision"]`` (a dict, present only
    with stragglers or faults): with stragglers ``arrivals`` ([M] f32 host
    mask), ``deadline`` (effective), ``deadline_next``, ``extensions`` and
    ``quorum``; with faults ``faults`` (the ``(keep, nan, byz)`` host
    masks) and, with the health screen, ``health``: the verdict [M] (1 =
    healthy participant) of each guarded reduction of the step, in order,
    and ``screened``: the participants that any of them screened out
    (both empty at a step that does not communicate).  With telemetry,
    the in-band metrics of ``step.telemetry_groups`` go in at the top
    level under the reference's keys and shapes (``upd_norm/<sec>``,
    ``drift/<sec>``, ``screened`` [M], ``deadline``, ``arrivals``, ...; see
    :func:`make_engine`), 0-d or 1-d f32 tensors that the host reads only
    where it logs them."""
    aspec: AlgoSpec
    spec: flat.FlatSpec
    init_state: Any
    step: Any
    views: Any
    shard: Any = None
    comm_fn: Any = None


def _compress_cfg(cfg, aspec: AlgoSpec, compression):
    """Check a ``CompressionSpec`` against the spec and lower it to the
    substrate's :class:`flat.CompressCfg` (the reference's checks)."""
    quant = compression.quant
    if quant not in (None, "bf16", "int8"):
        raise ValueError(f"unknown compression quant {quant!r} "
                         f"(None | 'bf16' | 'int8')")
    frac = float(compression.topk_frac)
    if not 0.0 <= frac < 1.0:
        raise ValueError(f"compression topk_frac={frac} must be in [0, 1)")
    if quant is None and frac == 0.0:
        raise ValueError(
            "compression enabled but no compressor selected — set quant "
            "('bf16' | 'int8') and/or topk_frac > 0")
    comm_secs = tuple(q.section for q in aspec.sequences if q.comm != PRIVATE)
    csecs = (tuple(compression.sections) if compression.sections
             else comm_secs)
    unknown = set(csecs) - set(aspec.sections)
    if unknown:
        raise ValueError(
            f"compression.sections names unknown sections {sorted(unknown)} "
            f"(spec {aspec.name!r} has {aspec.sections})")
    private = [s for s in csecs if s not in comm_secs]
    if private:
        raise ValueError(
            f"compression.sections names private sections {private} — "
            f"private state is never communicated, so it cannot be "
            f"compressed")
    if frac > 0 and cfg.hierarchy_period > 0:
        raise ValueError(
            "top-k compression (topk_frac > 0) does not compose with the "
            "hierarchical grouped mean (cfg.hierarchy_period > 0) — error "
            "feedback against two different means is ill-defined; use "
            "quant-only compression or set hierarchy_period=0")
    return flat.CompressCfg(quant=quant, topk_frac=frac,
                            error_feedback=bool(compression.error_feedback),
                            sections=csecs)


def _robust_cfg(robustness):
    """Lower a ``RobustnessSpec`` to the substrate's :class:`flat.RobustCfg`
    (the reference's check)."""
    rcfg = flat.RobustCfg(
        aggregator=robustness.aggregator, screen=robustness.screen,
        z_thresh=robustness.z_thresh, clip_factor=robustness.clip_factor,
        trim_frac=robustness.trim_frac)
    if rcfg.aggregator not in ("mean", "clip", "trim"):
        raise ValueError(f"unknown robust aggregator "
                         f"{rcfg.aggregator!r} (mean|clip|trim)")
    return rcfg


def make_engine(cfg, aspec: AlgoSpec, templates: dict, oracle, *,
                block: int | None = None, compression=None,
                participation=None, stragglers=None, faults=None,
                robustness=None, telemetry=None, shard=None,
                overlap: bool = False) -> Engine:
    """Compile ``aspec`` into the fused flat-substrate step.

    ``templates``: section → leaf template tree without the client axis
    (meta tensors will do).  ``oracle(views, batch) -> {section: grad tree}``
    takes and returns [M, ...] trees.  Its outputs are the momentum targets
    of the storm kind, evaluated at the old and the new iterate with the
    same batch, and the gradients of the sgd kind.

    ``compression``: a ``CompressionSpec`` (or None): every communicated
    reduction of the sections it names moves compressed sends, and with
    top-k error feedback the state carries ``ef``.  It composes with
    participation and stragglers (the weighted compressed mean: a client
    that does not send keeps its row and its EF row) and, quantization
    only, with the hierarchical grouped mean.

    The sequences' cadences (``Sequence.comm_every``) and
    ``cfg.hierarchy_period``/``cfg.hierarchy_groups`` decide which
    sections reduce at a round and how (:func:`comm_buffers`); the
    staleness counters advance at every communication step whatever the
    cadence.

    ``participation``: a compiled
    :class:`~repro_torch.federation.participation.Participation` (or None):
    every step takes the round's client mask from the step counter, zeroes
    non-participants' oracle contributions (:func:`flat.mask_buffers`),
    gates the fused launches with it, averages participants only (weighted
    by α^staleness, α the spec's ``stale_discount``) and advances the
    staleness counters on ``FlatState.stale`` at communication steps.

    ``stragglers``: a compiled
    :class:`~repro_torch.federation.stragglers.Stragglers` (or None): each
    round decides its arrival set from the step counter, the sampled mask
    and ``FlatState.deadline``; the weights become the arrivals (times the
    participation weights), the launch mask the arrivals (``drop``,
    ``cancel``) or the sampled set (``carry``), and the staleness counters
    age every client that did not arrive (``cancel``: that was not
    sampled).  The deadline moves once a round, at the communication
    step.  Each step writes its round's decision into the ``metrics`` dict
    it is given (see :class:`Engine`).

    ``faults``: a compiled :class:`~repro_torch.federation.faults.Faults`
    (or None): each round draws ``(keep, nan, byz)`` from its index and
    ``FlatState.retry``; ``keep`` multiplies into the launch mask, the
    weights and the staleness mask after the participation and straggler
    steps (a dropped client is frozen like a non-participant), and
    ``(nan, byz, byzantine_scale)`` corrupts what the clients send into
    both means.  ``robustness``: a ``RobustnessSpec`` (or None): both means
    health-screen the senders and reduce with its aggregator."""
    if aspec.kind not in ("storm", "sgd"):
        raise ValueError(f"unknown engine kind {aspec.kind!r}")
    rcfg = None if robustness is None else _robust_cfg(robustness)
    if (faults is not None or rcfg is not None) and cfg.hierarchy_period > 0:
        raise ValueError(
            "faults=/robustness= do not compose with the hierarchical "
            "grouped mean (cfg.hierarchy_period > 0) — the robust "
            "reductions and the fault model are global; set "
            "hierarchy_period=0")
    if stragglers is not None and cfg.hierarchy_period > 0:
        raise ValueError(
            "stragglers= does not compose with the hierarchical grouped "
            "mean (cfg.hierarchy_period > 0) — the deadline/quorum "
            "decision is global; set hierarchy_period=0")
    if compression is not None and (faults is not None or rcfg is not None):
        raise ValueError(
            "compression= does not compose with faults=/robustness= — the "
            "guarded reductions consume raw client rows; drop one layer")
    ccfg = (None if compression is None
            else _compress_cfg(cfg, aspec, compression))
    tel_groups = ()
    if telemetry is not None:
        tel_groups = resolve_metric_groups(
            getattr(telemetry, "metrics", None),
            compressed=ccfg is not None,
            guarded=faults is not None or rcfg is not None,
            sampled=participation is not None,
            straggled=stragglers is not None)
        if "stragglers" in tel_groups and stragglers is None:
            raise ValueError(
                "telemetry metrics group 'stragglers' needs stragglers= — "
                "there is no deadline or arrival set to report")
        if "compression" in tel_groups and ccfg is None:
            raise ValueError(
                "telemetry metrics group 'compression' needs compression= "
                "— there is no EF residual or quantization error to report")
        if "health" in tel_groups and (participation is None
                                       and faults is None and rcfg is None):
            raise ValueError(
                "telemetry metrics group 'health' needs participation "
                "sampling, faults= or robustness= — there is nothing to "
                "screen")
    has_ef = ccfg is not None and ccfg.has_ef
    sections = aspec.sections
    has_mom = aspec.has_momentum
    spec = flat.make_spec({s: templates[s] for s in sections},
                          sections=sections,
                          block=block if block else flat.BLOCK,
                          shards=shard.model_size if shard else 1)
    policies = aspec.policies
    cadence = tuple(q.comm_every for q in aspec.sequences)
    part, strag = participation, stragglers
    # staleness counters exist for either kind of absence: a round the
    # sampler left a client out of, or a deadline it missed
    need_stale = part is not None or strag is not None
    late = None if strag is None else strag.spec.late_policy
    alpha = 1.0 if part is None else float(part.spec.stale_discount)

    chunk = None if shard is None else shard.model_index

    def _flatten(trees, dtype=None):
        """[M_rank, ...] trees → the rank's blocks (whole buffers off a
        mesh)."""
        return flat.flatten_tree(spec, trees, batch_dims=1, dtype=dtype,
                                 chunk=chunk)

    def _flatten_grads(gdict):
        return _flatten({s: gdict[s] for s in sections}, torch.float32)

    def _whole_rows(bufs):
        """The rank's clients' whole rows: its blocks all-gathered over the
        model axis (the blocks themselves off a mesh)."""
        if shard is None:
            return bufs
        k, out = shard.model_size, []
        for b in bufs:
            parts = torch.empty((k * b.shape[0], b.shape[1]), dtype=b.dtype,
                                device=b.device)
            dist.all_gather_into_tensor(parts, b.contiguous(),
                                        group=shard.model_group)
            out.append(parts.view(k, b.shape[0], b.shape[1])
                       .permute(1, 0, 2).reshape(b.shape[0], -1))
        return tuple(out)

    def _oracle(bufs, batch, mask):
        """The flattened oracle directions at iterate ``bufs`` (the rank's
        blocks), non-participants' rows zeroed."""
        views = flat.unflatten_tree(spec, _whole_rows(bufs))
        return flat.mask_buffers(_flatten_grads(oracle(views, batch)),
                                 _local(mask))

    def _local(v):
        return v if shard is None else shard.local_rows(v)

    def _rows(tree):
        """The rank's clients of an [M, ...] tree (the tree off a mesh)."""
        if shard is None:
            return tree
        return tree_map(lambda v: v[shard.rows(v.shape[0])], tree)

    def _round_ctx(state: FlatState, decision):
        """(launch mask, comm weights, corrupt transform, staleness mask,
        straggler info) of the round ``state.step`` belongs to, all on the
        host, in the reference's order: the sampled mask, the arrival
        decision, the launch mask by policy, the weights times the
        arrivals, the fault masks, then the α^staleness discount.  Masks
        and weights None with neither participation, stragglers nor
        faults; the straggler info ``(arrivals, eff, ext, next_deadline,
        sampled)`` None without stragglers.  The straggler decision and
        the fault masks also go into ``decision`` (a dict, or None)."""
        r = state.step // cfg.local_steps
        if part is None:
            mask, w = None, None
        else:
            mask, w = part.round_weights(r)
        stale_mask, s_info = mask, None
        if strag is not None:
            sampled = (torch.ones(strag.num_clients, dtype=torch.float32)
                       if mask is None else mask)
            arrivals, eff, ext, next_dl = strag.round_decision(
                r, sampled, state.deadline)
            s_info = (arrivals, eff, ext, next_dl, sampled)
            if decision is not None:
                decision.update(arrivals=arrivals, deadline=float(eff),
                                deadline_next=float(next_dl),
                                extensions=int(ext),
                                quorum=int(strag.quorum_count(sampled)))
            # "carry" keeps stragglers computing; "drop" and "cancel"
            # freeze them like non-participants
            mask = sampled if late == "carry" else arrivals
            # the mean always averages the arrivals only
            w = arrivals if w is None else w * arrivals
            # "cancel" treats a straggler as served: it does not age
            stale_mask = sampled if late == "cancel" else arrivals
        corrupt = None
        if faults is not None:
            keep, nan, byz = faults.round_masks(r, int(state.retry))
            if decision is not None:
                decision["faults"] = (keep, nan, byz)
            # a dropped client behaves exactly like a non-participant:
            # frozen bit for bit in the launches, averaged around in comm
            mask = keep if mask is None else mask * keep
            w = keep if w is None else w * keep
            stale_mask = keep if stale_mask is None else stale_mask * keep
            corrupt = (nan, byz, faults.spec.byzantine_scale)
        if w is not None:
            w = staleness_weights(w, state.stale, alpha)
        return mask, w, corrupt, stale_mask, s_info

    def _next_stale(state: FlatState, stale_mask):
        if not need_stale:
            return state.stale
        return advance_stale(cfg, state.step, stale_mask, state.stale)

    def _next_deadline(state: FlatState, s_info):
        """The deadline moves once a round, at the communication step, so
        every local step of a round sees the same arrival set."""
        if s_info is None or (state.step + 1) % cfg.local_steps != 0:
            return state.deadline
        return s_info[3]

    def comm(step: int, bufs, ef, weights, corrupt=None, verdicts=None,
             pending=None):
        """Communicate ``bufs``; returns ``(bufs, ef)``."""
        if ccfg is None:
            return comm_buffers(spec, cfg, step, bufs, policies,
                                weights=weights, comm_every=cadence,
                                corrupt=corrupt, robust=rcfg,
                                verdicts=verdicts, shard=shard,
                                pending=pending), ef
        return comm_buffers(spec, cfg, step, bufs, policies, weights=weights,
                            comm_every=cadence, compress=ccfg, ef=ef,
                            shard=shard, pending=pending)

    def init_state(var_trees, mom_trees=None, step: int = 0, ef=None,
                   stale=None, deadline=None, retry=None):
        vars_b = _flatten(_rows({s: var_trees[s] for s in sections}))
        if not has_mom:
            mom_b = ()
        elif mom_trees is None:
            # momenta live in f32 buffers whatever the variable dtype
            mom_b = tuple(torch.zeros(b.shape, dtype=torch.float32,
                                      device=b.device) for b in vars_b)
        else:
            mom_b = _flatten(_rows({q.section: mom_trees[q.momentum]
                                    for q in aspec.sequences}),
                             torch.float32)
        if not has_ef:
            ef_b = ()
        elif ef is None:
            # one f32 zero buffer per communicated buffer: the mass top-k
            # drops accumulates here between rounds
            ef_b = tuple(tuple(torch.zeros(b.shape, dtype=torch.float32,
                                           device=b.device) for b in bufs)
                         for bufs in (vars_b, mom_b))
        else:
            ef_b = ef
        return FlatState(vars_b, mom_b, int(step), ef_b,
                         *_host_state(stale, deadline, retry))

    def _host_state(stale, deadline, retry):
        """The host fields (staleness counters, deadline, retry counter),
        on the CPU whatever the buffers' device."""
        if not need_stale:
            stale_b = ()
        elif stale is None:
            stale_b = torch.zeros((part or strag).num_clients,
                                  dtype=torch.int32)
        else:
            stale_b = torch.as_tensor(stale, dtype=torch.int32).cpu()
        if strag is None:
            dl_b = ()
        else:
            dl_b = _f32(float(strag.spec.deadline if deadline is None
                              else deadline))
        retry_b = () if faults is None else torch.tensor(
            0 if retry is None else int(retry), dtype=torch.int32)
        return stale_b, dl_b, retry_b

    def _decision(metrics):
        """The step's decision record ``metrics["decision"]`` (None without
        a metrics dict, or when there is nothing to decide)."""
        if metrics is None or (strag is None and faults is None):
            return None
        return metrics.setdefault("decision", {})

    def _verdicts(decision):
        """The list the guarded reductions of a step append their health
        verdicts to (``decision["health"]``), or None."""
        if decision is None or rcfg is None or not rcfg.screen:
            return None
        return decision.setdefault("health", [])

    def _screened(decision, wts) -> None:
        """``decision["screened"]``: the senders (``wts > 0``) that a
        guarded reduction of the step screened out."""
        verdicts = None if decision is None else decision.get("health")
        if verdicts is None:
            return
        failed = [i for i in range(len(verdicts[0]))
                  if any(v[i] == 0 for v in verdicts)] if verdicts else []
        decision["screened"] = [i for i in failed
                                if wts is None or wts[i] > 0]

    def _tel_local(metrics, mask, corrupt, local_vars) -> dict:
        """The metric groups that read the round's LOCAL (pre-reduction)
        iterates: drift, the quantization round trip, the health screen.
        Run before the first reduction writes them over."""
        if not tel_groups or metrics is None:
            return {}
        m = {}
        with annotate("telemetry/local"):
            if "drift" in tel_groups:
                m.update(flat.section_drift(spec, local_vars, mask=mask,
                                            shard=shard))
            if "compression" in tel_groups and ccfg.quant is not None:
                m["quant_err"] = flat.quant_roundtrip_err(
                    local_vars, spec.groups[0].block, ccfg.quant, shard)
            if "health" in tel_groups and rcfg is not None:
                m["screened"] = flat.health_screen(spec, local_vars, mask,
                                                   corrupt, rcfg, shard)
        return m

    def _tel_metrics(metrics, state: FlatState, new: FlatState, mask,
                     corrupt, s_info, local: dict) -> None:
        """Write the step's in-band metrics into ``metrics`` in the
        reference's order; ``local`` holds what :func:`_tel_local` read
        before the reductions."""
        if not tel_groups or metrics is None:
            return
        m = metrics
        with annotate("telemetry"):
            if "norms" in tel_groups:
                m.update(flat.section_norms(spec, new.vars, mask=mask,
                                            prefix="upd_norm",
                                            minus=state.vars, shard=shard))
                if new.mom:
                    m.update(flat.section_norms(spec, new.mom, mask=mask,
                                                prefix="mom_norm",
                                                shard=shard))
            m.update({k: v for k, v in local.items()
                      if k.startswith("drift/")})
            if "compression" in tel_groups:
                if new.ef:
                    m.update(flat.section_norms(spec, new.ef[0],
                                                prefix="ef_norm",
                                                shard=shard))
                if "quant_err" in local:
                    m["quant_err"] = local["quant_err"]
            if "health" in tel_groups:
                if mask is not None:
                    m["participants"] = (mask > 0).to(torch.float32).sum()
                if need_stale:
                    m["stale_hist"] = torch.bincount(
                        torch.clamp(new.stale, 0, 7).to(torch.int64),
                        minlength=8).to(torch.float32)
                if corrupt is not None:
                    nan, byz, _ = corrupt
                    m["injected_nan"] = nan.to(torch.float32).sum()
                    m["injected_byz"] = byz.to(torch.float32).sum()
                if "screened" in local:
                    m["screened"] = local["screened"]
            if "stragglers" in tel_groups and s_info is not None:
                arrivals, eff, ext, next_dl, sampled = s_info
                rt = strag.round_times(state.step // cfg.local_steps)
                m["deadline"] = eff
                m["deadline_next"] = next_dl
                m["arrivals"] = (arrivals > 0).to(torch.float32).sum()
                m["quorum"] = strag.quorum_count(sampled).to(torch.float32)
                m["extensions"] = torch.as_tensor(ext).to(torch.float32)
                m["arrival_hist"] = arrival_histogram(rt, eff, sampled)

    def _storm_step(state: FlatState, batch, metrics=None) -> FlatState:
        t = state.step
        decision = _decision(metrics)
        mask, wts, corrupt, stale_mask, s_info = _round_ctx(state, decision)
        verdicts = _verdicts(decision)
        a = alpha_schedule(cfg, t)
        lrs = tuple(_f32(getattr(cfg, q.lr)) * a for q in aspec.sequences)
        decays = tuple(_f32(1.0) - _f32(getattr(cfg, q.decay)) * a * a
                       for q in aspec.sequences)
        # 1) old-iterate oracle on pytree views of the entering iterate;
        #    non-participants' contributions are zeroed
        with annotate("oracle/old"):
            g_old = _oracle(state.vars, batch, mask)
        # 2) variable step + partial momentum: one gated launch per buffer
        with annotate("update"):
            vars_b, mom_b = flat.storm_partial_step(
                spec, state.vars, state.mom, g_old, lrs, decays, mask=mask,
                shard=shard)
        del g_old
        local = _tel_local(metrics, mask, corrupt, vars_b)
        efv, efm = state.ef if state.ef else ((), ())
        if overlap and (t + 1) % cfg.local_steps == 0:
            # 3+4) overlap: issue the variable reduction into a copy, run
            #    the new-iterate oracle on the local iterate from before
            #    it, then wait for the reduction
            pending = [] if shard is not None else None
            with annotate("comm/vars"):
                vars_c, efv = comm(t, tuple(b.clone() for b in vars_b), efv,
                                   wts, corrupt, verdicts, pending)
            with annotate("oracle/new"):
                g_new = _oracle(vars_b, batch, mask)
            with annotate("comm/vars/wait"):
                for finish in pending or ():
                    finish()
            del vars_b
        else:
            # 3) communicate the variables (in place: vars_b is overwritten)
            with annotate("comm/vars"):
                vars_c, efv = comm(t, vars_b, efv, wts, corrupt, verdicts)
            # 4) new-iterate oracle, same batch; the STORM correction is
            #    one add
            with annotate("oracle/new"):
                g_new = _oracle(vars_c, batch, mask)
        mom_b = flat.buffers_add(mom_b, g_new)
        del g_new
        with annotate("comm/mom"):
            mom_b, efm = comm(t, mom_b, efm, wts, corrupt, verdicts)
        _screened(decision, wts)
        new = FlatState(vars_c, mom_b, t + 1,
                        (efv, efm) if state.ef else (),
                        _next_stale(state, stale_mask),
                        _next_deadline(state, s_info), state.retry)
        _tel_metrics(metrics, state, new, mask, corrupt, s_info, local)
        return new

    def _sgd_step(state: FlatState, batch, metrics=None) -> FlatState:
        t = state.step
        decision = _decision(metrics)
        mask, wts, corrupt, stale_mask, s_info = _round_ctx(state, decision)
        verdicts = _verdicts(decision)
        lrs = tuple(_f32(getattr(cfg, q.lr)) for q in aspec.sequences)
        with annotate("oracle"):
            g = _oracle(state.vars, batch, mask)
        efv, efm = state.ef if state.ef else ((), ())
        if has_mom:
            betas = (_f32(aspec.beta),) * len(aspec.sequences)
            with annotate("update"):
                vars_b, mom_b = flat.momentum_sgd_step(
                    spec, state.vars, state.mom, g, lrs, betas, mask=mask,
                    shard=shard)
            local = _tel_local(metrics, mask, corrupt, vars_b)
            with annotate("comm/mom"):
                mom_b, efm = comm(t, mom_b, efm, wts, corrupt, verdicts)
        else:
            # no momentum: the plain-SGD launch reads and writes no momentum
            with annotate("update"):
                vars_b = flat.sgd_step(spec, state.vars, g, lrs, mask=mask,
                                       shard=shard)
            local = _tel_local(metrics, mask, corrupt, vars_b)
            mom_b = ()
        del g
        with annotate("comm/vars"):
            vars_b, efv = comm(t, vars_b, efv, wts, corrupt, verdicts)
        _screened(decision, wts)
        new = FlatState(vars_b, mom_b, t + 1,
                        (efv, efm) if state.ef else (),
                        _next_stale(state, stale_mask),
                        _next_deadline(state, s_info), state.retry)
        _tel_metrics(metrics, state, new, mask, corrupt, s_info, local)
        return new

    step = _storm_step if aspec.kind == "storm" else _sgd_step
    # what the step computes in-band (() = none): the trainer and the
    # train CLI branch on this, not on telemetry's presence
    step.telemetry_groups = tel_groups

    def views(state: FlatState):
        """Pytree views of a whole state (on a mesh, gather it first)."""
        vt = flat.unflatten_tree(spec, state.vars)
        if not state.mom:
            return vt, None
        mt = flat.unflatten_tree(spec, state.mom)
        return vt, {q.momentum: mt[q.section] for q in aspec.sequences}

    def comm_fn(state: FlatState) -> FlatState:
        """The communication-only subprogram of one step: the reductions
        of ``_storm_step``/``_sgd_step`` (the variables, then the momenta
        when the spec carries them) under the same ``_round_ctx``, on
        copies of the state's buffers."""
        t = state.step
        _, wts, corrupt, _, _ = _round_ctx(state, None)
        efv, efm = state.ef if state.ef else ((), ())
        vars_c, efv = comm(t, tuple(b.clone() for b in state.vars), efv,
                           wts, corrupt)
        mom_c = state.mom
        if has_mom:
            mom_c, efm = comm(t, tuple(b.clone() for b in state.mom), efm,
                              wts, corrupt)
        return state._replace(vars=vars_c, mom=mom_c,
                              ef=(efv, efm) if state.ef else ())

    return Engine(aspec, spec, init_state, step, views, shard, comm_fn)
