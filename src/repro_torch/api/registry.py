"""Algorithm registry — the table :func:`repro_torch.api.build` dispatches on
(counterpart of ``repro/api/registry.py``, model-scale trainers only).

Trainer factories self-register at import with :func:`register`, declaring
their algorithm-specific hyperparams (defaults, and which of them are
:class:`~repro_torch.config.FederatedConfig` fields) and their section names.
Ported so far: FedBiO, FedBiOAcc, FedBiO-Local and FedAvg; FedBiOAcc-Local
waits.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, field
from typing import Callable, Dict, Mapping, Tuple


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


def register(name: str, *, hparams: Mapping[str, float] | None = None,
             cfg_fields: Tuple[str, ...] = (),
             sections: Tuple[str, ...] = ()):
    """Decorator: register a ``make_*_train_step`` factory under ``name``."""
    def deco(factory):
        _TRAINERS[name] = AlgorithmEntry(
            name=name, factory=factory, hparams=dict(hparams or {}),
            cfg_fields=tuple(cfg_fields), sections=tuple(sections))
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
