"""The declarative :class:`Experiment` spec (counterpart of
``repro/api/spec.py``): the same frozen dataclass tree and the same JSON
schema, version 1, so every committed ``experiments/*.json`` loads unchanged.

The optional layers (faults, robustness, compression, telemetry, stragglers)
and the participation scenario are parsed into the port's own copies of the
reference's declarative tuples — same fields, same defaults, each its
module's own (``FaultSpec``, ``RobustnessSpec``, ``CompressionSpec``,
``ParticipationSpec``, ``StragglerSpec``, ``TelemetrySpec``, the last
re-exported here as the reference's ``repro/api/spec.py`` does) — so a
spec that sets an unported feature can be recognised and refused by
:func:`repro_torch.api.build` until it is ported.
:meth:`Experiment.validate` makes every check of the reference's, in its
order, for ported and unported layers alike, so a spec the reference
refuses never reaches the feature refusals of build.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field, fields
from typing import Any, NamedTuple, Optional, Tuple

from repro_torch.federation.compression import QUANTS, CompressionSpec
from repro_torch.federation.faults import (AGGREGATORS, FaultSpec,
                                           RobustnessSpec)
from repro_torch.federation.participation import SAMPLERS, ParticipationSpec
from repro_torch.federation.stragglers import LATE_POLICIES, StragglerSpec
from repro_torch.telemetry.spec import METRIC_GROUPS, TelemetrySpec

SPEC_VERSION = 1

PARAM_DTYPES = ("auto", "float32", "bfloat16")


class KnownAlgorithm(NamedTuple):
    hparams: Tuple[str, ...]
    sections: Tuple[str, ...]
    private: Tuple[str, ...] = ()     # sections that never enter a reduction


# The reference's name lists, copied (the port imports nothing of it):
# its registered model-scale trainers with their hyperparameters and
# sections (repro/api/registry.py, filled by repro/federation/trainer.py),
# the PRIVATE sections of its SPECS (repro/optim/sequences.py), its
# architectures (repro/configs ARCHS), samplers, robust aggregators and
# late-arrival policies (the telemetry metric groups are telemetry/spec.py's).
# What the port runs of them is decided by build, not here.  ALGORITHMS is
# the port's one table of these names: api/registry.py takes each ported
# trainer's sections from it and refuses one whose hyperparameters,
# sequence sections or PRIVATE sections disagree.
ALGORITHMS = {
    "fedavg": KnownAlgorithm(("momentum",), ("params",)),
    "fedbio": KnownAlgorithm((), ("x", "y", "u")),
    "fedbio_local": KnownAlgorithm((), ("x", "y"), ("y",)),
    "fedbioacc": KnownAlgorithm(
        ("alpha_delta", "alpha_u0", "c_nu", "c_omega", "c_u"),
        ("x", "y", "u")),
    "fedbioacc_local": KnownAlgorithm(
        ("alpha_delta", "alpha_u0", "c_nu", "c_omega"), ("x", "y"), ("y",)),
}
ARCH_NAMES = ("recurrentgemma-9b", "gemma2-2b", "mamba2-130m", "llama3-405b",
              "olmoe-1b-7b", "granite-3-8b", "hubert-xlarge",
              "granite-moe-1b-a400m", "internvl2-76b", "granite-8b")


class SpecError(ValueError):
    """An Experiment that cannot be built — the message names the field."""


def _err(fieldname: str, msg: str):
    raise SpecError(f"Experiment.{fieldname}: {msg}")


_LAYERS = {"faults": FaultSpec, "robustness": RobustnessSpec,
           "compression": CompressionSpec, "telemetry": TelemetrySpec,
           "stragglers": StragglerSpec}


@dataclass(frozen=True)
class AlgorithmSpec:
    """Algorithm name plus its own hyperparams (a sorted tuple of pairs, so
    the spec stays hashable; construct with a dict)."""
    name: str = "fedbioacc"
    params: Tuple[Tuple[str, float], ...] = ()

    def __post_init__(self):
        items = (self.params.items() if isinstance(self.params, dict)
                 else (tuple(p) for p in self.params))
        object.__setattr__(self, "params", tuple(sorted(items)))

    @property
    def params_dict(self) -> dict:
        return dict(self.params)


@dataclass(frozen=True)
class ProblemSpec:
    arch: str = "mamba2-130m"
    reduced: bool = True
    num_clients: int = 4
    per_client: int = 2
    seq_len: int = 128
    client_sizes: Optional[Tuple[float, ...]] = None
    param_dtype: str = "auto"      # auto: float32 if reduced else bfloat16
    data_seed: int = 0

    def __post_init__(self):
        if self.client_sizes is not None:
            object.__setattr__(self, "client_sizes",
                               tuple(float(v) for v in self.client_sizes))


@dataclass(frozen=True)
class ExecutionSpec:
    fuse_storm: bool = False
    fuse_oracles: bool = False
    storm_block: Optional[int] = None
    mesh: Any = None               # (data, model) sizes | "production" | None
    overlap: bool = False
    scatter_comm: bool = False
    n_micro: int = 1
    remat: bool = False
    use_flash: bool = False
    use_lru_kernel: bool = False

    def __post_init__(self):
        if isinstance(self.mesh, (list, tuple)):
            object.__setattr__(self, "mesh", tuple(int(v) for v in self.mesh))


@dataclass(frozen=True)
class ScheduleSpec:
    steps: int = 100
    local_steps: int = 4
    lr_x: float = 0.02
    lr_y: float = 0.05
    lr_u: float = 0.05
    hierarchy_period: int = 0
    hierarchy_groups: int = 2
    neumann_q: int = 8
    neumann_tau: float = 0.5
    lower_l2: float = 1e-2
    comm_every: Tuple[Tuple[str, int], ...] = ()
    seed: int = 0

    def __post_init__(self):
        items = (self.comm_every.items() if isinstance(self.comm_every, dict)
                 else (tuple(p) for p in self.comm_every))
        object.__setattr__(self, "comm_every", tuple(sorted(items)))

    @property
    def comm_every_dict(self) -> dict:
        return dict(self.comm_every)


@dataclass(frozen=True)
class Experiment:
    """One declarative, serializable federated bilevel run."""
    algorithm: AlgorithmSpec = field(default_factory=AlgorithmSpec)
    problem: ProblemSpec = field(default_factory=ProblemSpec)
    participation: ParticipationSpec = ParticipationSpec()
    execution: ExecutionSpec = field(default_factory=ExecutionSpec)
    schedule: ScheduleSpec = field(default_factory=ScheduleSpec)
    faults: Optional[FaultSpec] = None
    robustness: Optional[RobustnessSpec] = None
    compression: Optional[CompressionSpec] = None
    telemetry: Optional[TelemetrySpec] = None
    stragglers: Optional[StragglerSpec] = None
    version: int = SPEC_VERSION

    def normalize(self) -> "Experiment":
        """The reference's sampler promotions: a recorded ``trace_path`` or a
        nonzero ``clients_per_round`` on the ``full`` sampler select the
        trace resp. uniform sampler."""
        p = self.participation
        if p.trace_path is not None and p.sampler == "full":
            return self.edit(**{"participation.sampler": "trace"})
        if p.sampler == "full" and p.clients_per_round:
            return self.edit(**{"participation.sampler": "uniform"})
        return self

    def validate(self) -> "Experiment":
        """The reference's ``Experiment.validate``, check for check and in
        its order, against the port's copies of the reference's name lists
        (``ALGORITHMS``, ``ARCH_NAMES``, ``SAMPLERS``, ...): a spec the
        reference refuses raises :class:`SpecError` naming the same field.
        What the reference accepts and the port does not run yet passes here
        and is refused by :func:`repro_torch.api.build`."""
        if self.version != SPEC_VERSION:
            _err("version", f"unsupported spec version {self.version!r} "
                 f"(this build reads version {SPEC_VERSION})")
        name = self.algorithm.name
        if name not in ALGORITHMS:
            _err("algorithm.name",
                 f"unknown algorithm {name!r}; registered: "
                 f"{sorted(ALGORITHMS)}")
        algo = ALGORITHMS[name]
        unknown = set(self.algorithm.params_dict) - set(algo.hparams)
        if unknown:
            _err("algorithm.params",
                 f"{sorted(unknown)} are not hyperparams of {name!r} (it "
                 f"takes {sorted(algo.hparams)})")

        prob = self.problem
        if prob.arch not in ARCH_NAMES:
            _err("problem.arch", f"unknown arch {prob.arch!r}; choose from "
                 f"{sorted(ARCH_NAMES)}")
        if prob.num_clients < 1:
            _err("problem.num_clients", "need at least one client")
        if prob.param_dtype not in PARAM_DTYPES:
            _err("problem.param_dtype",
                 f"{prob.param_dtype!r} not in {PARAM_DTYPES}")
        cs = prob.client_sizes
        if cs is not None and len(cs) != prob.num_clients:
            _err("problem.client_sizes",
                 f"{len(cs)} sizes for num_clients={prob.num_clients}")

        self._validate_participation()
        self._validate_execution()
        sch = self.schedule
        if sch.steps < 1 or sch.local_steps < 1:
            _err("schedule", "steps and local_steps must be >= 1")
        for sec, k in sch.comm_every:
            if sec not in algo.sections:
                _err("schedule.comm_every",
                     f"{sec!r} is not a section of {name!r} (sections: "
                     f"{algo.sections})")
            if int(k) < 1:
                _err("schedule.comm_every", f"cadence for {sec!r} must be "
                     f">= 1, got {k}")
        self._validate_guards()
        if self.compression is not None:
            self._validate_compression()
        if self.telemetry is not None:
            self._validate_telemetry()
        if self.stragglers is not None:
            self._validate_stragglers()
        return self

    def _validate_participation(self) -> None:
        p = self.normalize().participation
        m = self.problem.num_clients
        if p.sampler not in SAMPLERS:
            _err("participation.sampler",
                 f"unknown sampler {p.sampler!r}; choose from {SAMPLERS}")
        if (p.sampler == "weighted" and p.client_weights is None
                and self.problem.client_sizes is None):
            _err("participation",
                 "sampler='weighted' needs client_weights (or "
                 "problem.client_sizes to inherit from)")
        if p.clients_per_round > m:
            _err("participation.clients_per_round",
                 f"{p.clients_per_round} > num_clients={m}")
        if p.trace_path is not None and p.sampler != "trace":
            _err("participation.trace_path",
                 f"a recorded availability log is a sampler='trace' knob — "
                 f"it conflicts with sampler={p.sampler!r} (drop one)")
        if p.sampler == "trace" and p.clients_per_round:
            _err("participation.clients_per_round",
                 "the trace sampler draws participation from the "
                 "availability process/log — clients_per_round has no "
                 "effect; unset it or use uniform/weighted")

    def _validate_execution(self) -> None:
        ex = self.execution
        if (ex.mesh is not None or ex.overlap) and not ex.fuse_storm:
            _err("execution",
                 "mesh/overlap need fuse_storm=true — the sharded substrate "
                 "and the overlap schedule are fused-engine features")
        if ex.overlap and ex.mesh is None:
            _err("execution.overlap",
                 "overlap needs a mesh: the schedule exists to hide the "
                 "data-axis collective behind the new-iterate oracle")
        if ex.scatter_comm and ex.mesh is None:
            _err("execution.scatter_comm", "scatter_comm needs a mesh")
        if ex.mesh is not None and not (
                ex.mesh == "production"
                or (isinstance(ex.mesh, tuple) and len(ex.mesh) == 2
                    and all(int(v) >= 1 for v in ex.mesh))):
            _err("execution.mesh",
                 f"{ex.mesh!r} is neither [data, model] sizes nor "
                 f"'production'")
        if isinstance(ex.mesh, tuple) \
                and self.problem.num_clients % ex.mesh[0]:
            _err("execution.mesh",
                 f"num_clients={self.problem.num_clients} not divisible by "
                 f"the mesh data axis ({ex.mesh[0]})")

    def _validate_guards(self) -> None:
        """The faults and robustness blocks."""
        fl, rb = self.faults, self.robustness
        if fl is not None or rb is not None:
            which = "faults" if fl is not None else "robustness"
            if not self.execution.fuse_storm:
                _err(which, "needs execution.fuse_storm=true — fault "
                     "injection and the robust reductions are features of "
                     "the fused sequence-spec engine")
            if self.schedule.hierarchy_period > 0:
                _err(which, "does not compose with the hierarchical grouped "
                     "mean (schedule.hierarchy_period > 0) — the robust "
                     "reductions and the fault model are global")
        if fl is not None:
            for rate in ("dropout_rate", "nan_rate", "byzantine_rate"):
                r = getattr(fl, rate)
                if not 0.0 <= float(r) <= 1.0:
                    _err(f"faults.{rate}", f"{r} is not in [0, 1]")
            if fl.start_round < 0:
                _err("faults.start_round", f"{fl.start_round} must be >= 0")
        if rb is not None:
            if rb.aggregator not in AGGREGATORS:
                _err("robustness.aggregator",
                     f"unknown aggregator {rb.aggregator!r}; choose from "
                     f"{AGGREGATORS}")
            if not 0.0 <= float(rb.trim_frac) < 0.5:
                _err("robustness.trim_frac",
                     f"{rb.trim_frac} is not in [0, 0.5) — trimming both "
                     f"ends must leave at least one row")
            if float(rb.clip_factor) <= 0:
                _err("robustness.clip_factor",
                     f"{rb.clip_factor} must be > 0")
            if float(rb.spike_factor) <= 1.0:
                _err("robustness.spike_factor",
                     f"{rb.spike_factor} must be > 1 (a loss equal to the "
                     f"last good one is healthy)")
            if rb.retry_budget < 0 or rb.ring < 1:
                _err("robustness",
                     "retry_budget must be >= 0 and ring >= 1")

    def _validate_compression(self) -> None:
        cp, sch = self.compression, self.schedule
        if not self.execution.fuse_storm:
            _err("compression",
                 "needs execution.fuse_storm=true — the compressed "
                 "reductions are a feature of the fused sequence-spec engine")
        if self.faults is not None or self.robustness is not None:
            _err("compression",
                 "does not compose with faults/robustness — the robust "
                 "aggregators and health screens are calibrated on exact "
                 "sends (drop one layer)")
        if cp.quant not in QUANTS:
            _err("compression.quant",
                 f"unknown quant {cp.quant!r}; choose from {QUANTS}")
        frac = float(cp.topk_frac)
        if not 0.0 <= frac < 1.0:
            _err("compression.topk_frac",
                 f"{cp.topk_frac} is not in [0, 1) — 1.0 means 'keep "
                 f"everything'; unset topk_frac instead")
        if cp.quant is None and not frac > 0.0:
            _err("compression",
                 "no compressor selected — set quant ('bf16'|'int8') and/or "
                 "topk_frac > 0, or drop the compression block")
        if frac > 0.0 and sch.hierarchy_period > 0:
            _err("compression.topk_frac",
                 "top-k sparsification does not compose with the "
                 "hierarchical grouped mean (schedule.hierarchy_period > 0) "
                 "— error feedback against two different means is "
                 "ill-defined; use quant-only compression or a flat schedule")
        if cp.sections is None:
            return
        if len(cp.sections) == 0:
            _err("compression.sections",
                 "[] compresses nothing — use null for every communicated "
                 "section, or drop the block")
        name, algo = self.algorithm.name, ALGORITHMS[self.algorithm.name]
        unknown = [s for s in cp.sections if s not in algo.sections]
        if unknown:
            _err("compression.sections",
                 f"{unknown} are not sections of {name!r} (sections: "
                 f"{algo.sections})")
        bad = [s for s in cp.sections if s in algo.private]
        if bad:
            _err("compression.sections",
                 f"{bad} are PRIVATE sections of {name!r} — private state "
                 f"never enters a reduction, so it cannot be compressed")

    def _validate_telemetry(self) -> None:
        tl = self.telemetry
        if tl.sink is not None and not isinstance(tl.sink, str):
            _err("telemetry.sink",
                 f"{tl.sink!r} is not a path (string) or null")
        if tl.metrics is None:
            return
        unknown = [g for g in tl.metrics if g not in METRIC_GROUPS]
        if unknown:
            _err("telemetry.metrics",
                 f"unknown metric groups {unknown}; choose from "
                 f"{METRIC_GROUPS}")
        if tl.metrics and not self.execution.fuse_storm:
            _err("telemetry.metrics",
                 "in-band metrics need execution.fuse_storm=true — they are "
                 "a side output of the fused sequence-spec engine; use "
                 "metrics=[] for an events-only stream")
        if "compression" in tl.metrics and self.compression is None:
            _err("telemetry.metrics",
                 "the 'compression' group needs a compression block — there "
                 "is no EF residual or quantization error to report")
        if "health" in tl.metrics and (
                self.faults is None and self.robustness is None
                and self.normalize().participation.sampler == "full"):
            _err("telemetry.metrics",
                 "the 'health' group needs faults, robustness or a non-full "
                 "participation sampler — there is nothing to screen")
        if "stragglers" in tl.metrics and self.stragglers is None:
            _err("telemetry.metrics",
                 "the 'stragglers' group needs a stragglers block — there is "
                 "no deadline or arrival set to report")

    def _validate_stragglers(self) -> None:
        sg = self.stragglers
        if not self.execution.fuse_storm:
            _err("stragglers",
                 "needs execution.fuse_storm=true — deadline-driven elastic "
                 "rounds are a feature of the fused sequence-spec engine")
        if self.schedule.hierarchy_period > 0:
            _err("stragglers",
                 "does not compose with the hierarchical grouped mean "
                 "(schedule.hierarchy_period > 0) — the deadline/quorum "
                 "decision is global; set hierarchy_period=0")
        if sg.late_policy not in LATE_POLICIES:
            _err("stragglers.late_policy",
                 f"unknown policy {sg.late_policy!r}; choose from "
                 f"{LATE_POLICIES}")
        if not float(sg.base_time) > 0.0:
            _err("stragglers.base_time", f"{sg.base_time} must be > 0")
        if float(sg.tail) < 0.0:
            _err("stragglers.tail", f"{sg.tail} must be >= 0")
        if not float(sg.deadline) > 0.0:
            _err("stragglers.deadline", f"{sg.deadline} must be > 0 "
                 f"(simulated seconds)")
        if int(sg.over_provision) < 0:
            _err("stragglers.over_provision",
                 f"{sg.over_provision} must be >= 0")
        if int(sg.over_provision) > 0 and (
                self.normalize().participation.sampler
                not in ("uniform", "weighted")):
            _err("stragglers.over_provision",
                 "needs a counted (uniform/weighted) m-of-M sampler to "
                 "request extra clients — the full/trace samplers do not "
                 "take a count; set over_provision=0 or switch samplers")
        if not 0.0 < float(sg.quorum) <= 1.0:
            _err("stragglers.quorum",
                 f"{sg.quorum} must be in (0, 1] — a fraction of the round's "
                 f"sampled clients")
        if float(sg.backoff) < 1.0:
            _err("stragglers.backoff", f"{sg.backoff} must be >= 1")
        if int(sg.max_extensions) < 0:
            _err("stragglers.max_extensions",
                 f"{sg.max_extensions} must be >= 0")
        if not 0.0 < float(sg.target_percentile) <= 1.0:
            _err("stragglers.target_percentile",
                 f"{sg.target_percentile} must be in (0, 1]")
        if not 0.0 <= float(sg.adapt_rate) <= 1.0:
            _err("stragglers.adapt_rate",
                 f"{sg.adapt_rate} must be in [0, 1]")
        if int(sg.start_round) < 0:
            _err("stragglers.start_round",
                 f"{sg.start_round} must be >= 0")

    # -- JSON ---------------------------------------------------------------

    def to_json(self, *, indent: int | None = 1) -> str:
        """The spec as the reference writes it: ``version`` first, then the
        groups in field order; the NamedTuple layers as objects, tuples as
        lists, ``algorithm.params`` and ``schedule.comm_every`` as
        objects."""
        d = dataclasses.asdict(self)
        d["algorithm"]["params"] = self.algorithm.params_dict
        # dataclasses.asdict rebuilds NamedTuples, which json writes as
        # lists: write them as objects
        d["participation"] = self.participation._asdict()
        for key in _LAYERS:
            layer = getattr(self, key)
            d[key] = None if layer is None else layer._asdict()
            for k in ("sections", "metrics"):
                if layer is not None and getattr(layer, k, None) is not None:
                    d[key][k] = list(getattr(layer, k))
        d["schedule"]["comm_every"] = self.schedule.comm_every_dict
        d = {"version": d.pop("version"), **d}
        return json.dumps(d, indent=indent, sort_keys=False)

    def save(self, path: str) -> None:
        with open(path, "w") as fh:
            fh.write(self.to_json())
            fh.write("\n")

    @classmethod
    def from_json(cls, text: str) -> "Experiment":
        try:
            d = json.loads(text)
        except json.JSONDecodeError as e:
            raise SpecError(f"Experiment JSON does not parse: {e}") from e
        if not isinstance(d, dict):
            raise SpecError("Experiment JSON must be an object")
        version = d.pop("version", SPEC_VERSION)
        if version != SPEC_VERSION:
            raise SpecError(f"Experiment.version: unsupported spec version "
                            f"{version!r} (this build reads {SPEC_VERSION})")
        parts: dict = {}
        groups = {"algorithm": AlgorithmSpec, "problem": ProblemSpec,
                  "execution": ExecutionSpec, "schedule": ScheduleSpec}
        for key, klass in groups.items():
            sub = d.pop(key, {})
            if not isinstance(sub, dict):
                raise SpecError(f"Experiment.{key}: expected an object")
            _check_keys(key, sub, {f.name for f in fields(klass)})
            parts[key] = klass(**sub)
        sub = d.pop("participation", {})
        _check_keys("participation", sub, set(ParticipationSpec._fields))
        if sub.get("client_weights") is not None:
            sub["client_weights"] = tuple(sub["client_weights"])
        parts["participation"] = ParticipationSpec(**sub)
        for key, klass in _LAYERS.items():
            sub = d.pop(key, None)
            if sub is None:
                parts[key] = None
                continue
            if not isinstance(sub, dict):
                raise SpecError(f"Experiment.{key}: expected an object or "
                                f"null")
            _check_keys(key, sub, set(klass._fields))
            for k in ("sections", "metrics"):
                if sub.get(k) is not None:
                    sub[k] = tuple(sub[k])
            parts[key] = klass(**sub)
        if d:
            raise SpecError(f"Experiment: unknown top-level keys {sorted(d)}")
        return cls(version=version, **parts)

    @classmethod
    def load(cls, path: str) -> "Experiment":
        with open(path) as fh:
            return cls.from_json(fh.read())

    # -- sweeps -------------------------------------------------------------

    def edit(self, **changes: Any) -> "Experiment":
        """A new Experiment with dotted-path fields replaced:
        ``exp.edit(**{"problem.reduced": False, "schedule.steps": 4})``."""
        out = self
        for path, value in changes.items():
            head, _, rest = path.partition(".")
            if not hasattr(out, head):
                _err(head, f"no such field (editing {path!r})")
            if not rest:
                out = dataclasses.replace(out, **{head: value})
                continue
            sub = getattr(out, head)
            if sub is None and head in _LAYERS:
                sub = _LAYERS[head]()
            if isinstance(sub, tuple) and hasattr(sub, "_fields"):
                if rest not in sub._fields:
                    _err(path, "no such field")
                if isinstance(value, list):
                    value = tuple(value)
                sub = sub._replace(**{rest: value})
            else:
                if rest not in {f.name for f in fields(sub)}:
                    _err(path, "no such field")
                sub = dataclasses.replace(sub, **{rest: value})
            out = dataclasses.replace(out, **{head: sub})
        return out


def _check_keys(key: str, sub: dict, known: set) -> None:
    unknown = set(sub) - known
    if unknown:
        raise SpecError(f"Experiment.{key}: unknown keys {sorted(unknown)} "
                        f"(knows {sorted(known)})")
