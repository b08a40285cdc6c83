"""The declarative :class:`Experiment` spec (counterpart of
``repro/api/spec.py``): the same frozen dataclass tree and the same JSON
schema, version 1, so every committed ``experiments/*.json`` loads unchanged.

The optional layers (faults, robustness, compression, telemetry, stragglers)
and the participation scenario are parsed into the port's own copies of the
reference's declarative tuples — same fields, same defaults — so a spec that
sets one can be recognised and refused by :func:`repro_torch.api.build`
until the layer is ported.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field, fields
from typing import Any, NamedTuple, Optional, Tuple

SPEC_VERSION = 1

PARAM_DTYPES = ("auto", "float32", "bfloat16")


class SpecError(ValueError):
    """An Experiment that cannot be built — the message names the field."""


def _err(fieldname: str, msg: str):
    raise SpecError(f"Experiment.{fieldname}: {msg}")


class ParticipationSpec(NamedTuple):
    sampler: str = "full"
    clients_per_round: int = 0
    client_weights: tuple | None = None
    seed: int = 0
    availability_rate: float = 0.7
    min_clients: int = 1
    stale_discount: float = 1.0
    trace_path: str | None = None


class FaultSpec(NamedTuple):
    dropout_rate: float = 0.0
    nan_rate: float = 0.0
    byzantine_rate: float = 0.0
    byzantine_scale: float = 10.0
    seed: int = 0
    start_round: int = 0


class RobustnessSpec(NamedTuple):
    aggregator: str = "mean"
    screen: bool = True
    z_thresh: float = 3.0
    clip_factor: float = 2.0
    trim_frac: float = 0.2
    spike_factor: float = 10.0
    retry_budget: int = 3
    ring: int = 2


class CompressionSpec(NamedTuple):
    quant: Optional[str] = None
    topk_frac: float = 0.0
    error_feedback: bool = True
    sections: Optional[Tuple[str, ...]] = None


class TelemetrySpec(NamedTuple):
    sink: Optional[str] = None
    metrics: Optional[Tuple[str, ...]] = None
    trace: bool = True


class StragglerSpec(NamedTuple):
    base_time: float = 1.0
    tail: float = 1.0
    deadline: float = 2.0
    over_provision: int = 2
    quorum: float = 0.5
    late_policy: str = "drop"
    backoff: float = 1.5
    max_extensions: int = 2
    target_percentile: float = 0.9
    adapt_rate: float = 0.2
    seed: int = 0
    start_round: int = 0


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
        """Schema-level checks (the algorithm and the layers are checked
        against what is ported by :func:`repro_torch.api.build`)."""
        if self.version != SPEC_VERSION:
            _err("version", f"unsupported spec version {self.version!r} "
                 f"(this build reads version {SPEC_VERSION})")
        if self.problem.num_clients < 1:
            _err("problem.num_clients", "need at least one client")
        if self.problem.param_dtype not in PARAM_DTYPES:
            _err("problem.param_dtype",
                 f"{self.problem.param_dtype!r} not in {PARAM_DTYPES}")
        if self.schedule.steps < 1 or self.schedule.local_steps < 1:
            _err("schedule", "steps and local_steps must be >= 1")
        return self

    # -- JSON ---------------------------------------------------------------

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
