"""Algorithm registry — the table :func:`repro_torch.api.build` dispatches on
(counterpart of ``repro/api/registry.py``, model-scale trainers only).

Trainer factories self-register at import with :func:`register`, declaring
their sequence spec and their algorithm-specific hyperparams (defaults, and
which of them are :class:`~repro_torch.config.FederatedConfig` fields).
The names themselves — hyperparameters, sections, PRIVATE sections — have
one table, :data:`repro_torch.api.spec.ALGORITHMS`, which validation reads;
registration takes the sections from it and refuses a trainer that
disagrees with it.
Ported so far: FedBiO, FedBiOAcc, FedBiO-Local and FedAvg; FedBiOAcc-Local
waits.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, field
from typing import Callable, Dict, Mapping, Tuple

from repro_torch.api.spec import ALGORITHMS
from repro_torch.optim.sequences import PRIVATE, AlgoSpec


@dataclass(frozen=True)
class AlgorithmEntry:
    name: str
    factory: Callable
    hparams: Mapping[str, float] = field(default_factory=dict)
    cfg_fields: Tuple[str, ...] = ()
    sections: Tuple[str, ...] = ()

    def split_params(self, params: Mapping[str, float]):
        """(cfg_overrides, factory_kwargs) with the defaults filled in."""
        merged = {**dict(self.hparams), **dict(params)}
        cfg = {k: v for k, v in merged.items() if k in self.cfg_fields}
        kw = {k: v for k, v in merged.items() if k not in self.cfg_fields}
        return cfg, kw


_TRAINERS: Dict[str, AlgorithmEntry] = {}


def register(name: str, sequences: AlgoSpec, *,
             hparams: Mapping[str, float] | None = None,
             cfg_fields: Tuple[str, ...] = ()):
    """Decorator: register a ``make_*_train_step`` factory under ``name``,
    running the sequence spec ``sequences``.  Its hyperparameter names,
    sections and PRIVATE sections must be those of ``ALGORITHMS[name]``."""
    known = ALGORITHMS[name]
    hparams = dict(hparams or {})
    private = tuple(q.section for q in sequences.sequences
                    if q.comm == PRIVATE)
    if (set(hparams) != set(known.hparams)
            or sequences.sections != known.sections
            or private != known.private):
        raise ValueError(
            f"trainer {name!r} (hparams {sorted(hparams)}, sections "
            f"{sequences.sections}, private {private}) disagrees with "
            f"spec.ALGORITHMS[{name!r}] {known}")

    def deco(factory):
        _TRAINERS[name] = AlgorithmEntry(
            name=name, factory=factory, hparams=hparams,
            cfg_fields=tuple(cfg_fields), sections=known.sections)
        return factory
    return deco


def _ensure_registered() -> None:
    if not _TRAINERS:
        importlib.import_module("repro_torch.federation.trainer")


def names() -> Tuple[str, ...]:
    """The ported algorithms, sorted."""
    _ensure_registered()
    return tuple(sorted(_TRAINERS))


def get(name: str) -> AlgorithmEntry:
    _ensure_registered()
    if name not in _TRAINERS:
        raise NotImplementedError(
            f"algorithm {name!r} is not ported yet (ported: "
            f"{list(names())}); see ROADMAP queue 1, item 'Remaining "
            f"algorithms'")
    return _TRAINERS[name]
