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

Ported so far: both kinds with the AVERAGED / PRIVATE policies and
HIERARCHICAL with ``hierarchy_period = 0`` (the paper's flat averaging), and
compressed communication (``compression=``: quantized and/or top-k sends,
per-client error feedback on ``FlatState.ef``); no participation, faults,
telemetry, stragglers, sharding or per-sequence cadences.

The step counter lives on the host (``FlatState.step`` is a Python int), so
whether a step communicates is decided without reading the device.  The
STORM schedule α_t and the per-section (lr, decay) scalars are f32 tensors
on the CPU, computed with the JAX package's f32 operation order, so the
per-tile tables agree with the reference's; the sgd kind's lrs and β are
the plain config values as f32.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.optim import flat

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
    "fedavg": AlgoSpec("fedavg", "sgd", (
        Sequence("params", "mom", "lr_x"),
    ), beta=0.9, carry_momentum=True),
}


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


def comm_buffers(spec: flat.FlatSpec, cfg, step: int, bufs, policies, *,
                 compress=None, ef=()):
    """Apply the per-section policies to flat [M, N] buffers at a
    communication step: one masked reduction per communicated run, private
    sections untouched.  Other steps return ``bufs`` as they are.

    ``compress`` / ``ef``: a :class:`flat.CompressCfg` and the current
    error-feedback buffers; with ``compress`` set the call returns
    ``(bufs, ef)``, and a step that does not communicate leaves both as
    they are."""
    if cfg.hierarchy_period > 0 and HIERARCHICAL in policies:
        raise NotImplementedError(
            "the hierarchical schedule (hierarchy_period > 0) is not ported "
            "yet (ROADMAP queue 1, item 'Participation, staleness and "
            "cadence')")
    is_comm, _ = _round_preds(cfg, step)
    modes = tuple("none" if p == PRIVATE else "mean" for p in policies)
    if not is_comm or all(m == "none" for m in modes):
        return bufs if compress is None else (bufs, ef)
    return flat.client_mean_masked(spec, bufs, modes, compress=compress,
                                   ef=ef)


class FlatState(NamedTuple):
    """Train state on the flat substrate: per-dtype [M, N] variable and f32
    momentum buffers (``()`` when the spec carries no momentum), the
    host-side step counter, and the per-client error-feedback buffers of
    top-k compressed communication: a ``(vars_ef, mom_ef)`` pair of f32
    buffer tuples shaped like ``vars``/``mom``, or ``()`` when compression
    is off or carries no feedback."""
    vars: Any
    mom: Any
    step: int
    ef: Any = ()


class Engine(NamedTuple):
    """A compiled sequence spec: ``init_state(var_trees, mom_trees=None,
    step=0, ef=None)``, ``step(state, batch) -> state`` and ``views(state) ->
    (var_dict, mom_dict)``, ``mom_dict`` None without momentum."""
    aspec: AlgoSpec
    spec: flat.FlatSpec
    init_state: Any
    step: Any
    views: Any


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


def make_engine(cfg, aspec: AlgoSpec, templates: dict, oracle, *,
                block: int | None = None, compression=None) -> Engine:
    """Compile ``aspec`` into the fused flat-substrate step.

    ``templates``: section → leaf template tree without the client axis
    (meta tensors will do).  ``oracle(views, batch) -> {section: grad tree}``
    takes and returns [M, ...] trees.  Its outputs are the momentum targets
    of the storm kind, evaluated at the old and the new iterate with the
    same batch, and the gradients of the sgd kind.

    ``compression``: a ``CompressionSpec`` (or None): every communicated
    reduction of the sections it names moves compressed sends, and with
    top-k error feedback the state carries ``ef``."""
    if aspec.kind not in ("storm", "sgd"):
        raise ValueError(f"unknown engine kind {aspec.kind!r}")
    ccfg = (None if compression is None
            else _compress_cfg(cfg, aspec, compression))
    has_ef = ccfg is not None and ccfg.has_ef
    sections = aspec.sections
    has_mom = aspec.has_momentum
    spec = flat.make_spec({s: templates[s] for s in sections},
                          sections=sections,
                          block=block if block else flat.BLOCK)
    policies = aspec.policies

    def _flatten_grads(gdict):
        return flat.flatten_tree(spec, {s: gdict[s] for s in sections},
                                 batch_dims=1, dtype=torch.float32)

    def comm(step: int, bufs, ef):
        """Communicate ``bufs``; returns ``(bufs, ef)``."""
        if ccfg is None:
            return comm_buffers(spec, cfg, step, bufs, policies), ef
        return comm_buffers(spec, cfg, step, bufs, policies, compress=ccfg,
                            ef=ef)

    def init_state(var_trees, mom_trees=None, step: int = 0, ef=None):
        vars_b = flat.flatten_tree(spec, {s: var_trees[s] for s in sections},
                                   batch_dims=1)
        if not has_mom:
            mom_b = ()
        elif mom_trees is None:
            # momenta live in f32 buffers whatever the variable dtype
            mom_b = tuple(torch.zeros(b.shape, dtype=torch.float32,
                                      device=b.device) for b in vars_b)
        else:
            mom_b = flat.flatten_tree(
                spec, {q.section: mom_trees[q.momentum]
                       for q in aspec.sequences},
                batch_dims=1, dtype=torch.float32)
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
        return FlatState(vars_b, mom_b, int(step), ef_b)

    def _storm_step(state: FlatState, batch) -> FlatState:
        t = state.step
        a = alpha_schedule(cfg, t)
        lrs = tuple(_f32(getattr(cfg, q.lr)) * a for q in aspec.sequences)
        decays = tuple(_f32(1.0) - _f32(getattr(cfg, q.decay)) * a * a
                       for q in aspec.sequences)
        # 1) old-iterate oracle on pytree views of the entering iterate
        g_old = _flatten_grads(oracle(flat.unflatten_tree(spec, state.vars),
                                      batch))
        # 2) variable step + partial momentum: one launch per dtype buffer
        vars_b, mom_b = flat.storm_partial_step(spec, state.vars, state.mom,
                                                g_old, lrs, decays)
        del g_old
        efv, efm = state.ef if state.ef else ((), ())
        # 3) communicate the variables
        vars_c, efv = comm(t, vars_b, efv)
        # 4) new-iterate oracle, same batch; the STORM correction is one add
        g_new = _flatten_grads(oracle(flat.unflatten_tree(spec, vars_c),
                                      batch))
        mom_b = flat.buffers_add(mom_b, g_new)
        del g_new
        mom_b, efm = comm(t, mom_b, efm)
        return FlatState(vars_c, mom_b, t + 1,
                         (efv, efm) if state.ef else ())

    def _sgd_step(state: FlatState, batch) -> FlatState:
        t = state.step
        lrs = tuple(_f32(getattr(cfg, q.lr)) for q in aspec.sequences)
        g = _flatten_grads(oracle(flat.unflatten_tree(spec, state.vars),
                                  batch))
        efv, efm = state.ef if state.ef else ((), ())
        if has_mom:
            betas = (_f32(aspec.beta),) * len(aspec.sequences)
            vars_b, mom_b = flat.momentum_sgd_step(spec, state.vars,
                                                   state.mom, g, lrs, betas)
            mom_b, efm = comm(t, mom_b, efm)
        else:
            # no momentum: the plain-SGD launch reads and writes no momentum
            vars_b = flat.sgd_step(spec, state.vars, g, lrs)
            mom_b = ()
        del g
        vars_b, efv = comm(t, vars_b, efv)
        return FlatState(vars_b, mom_b, t + 1,
                         (efv, efm) if state.ef else ())

    step = _storm_step if aspec.kind == "storm" else _sgd_step

    def views(state: FlatState):
        vt = flat.unflatten_tree(spec, state.vars)
        if not state.mom:
            return vt, None
        mt = flat.unflatten_tree(spec, state.mom)
        return vt, {q.momentum: mt[q.section] for q in aspec.sequences}

    return Engine(aspec, spec, init_state, step, views)
