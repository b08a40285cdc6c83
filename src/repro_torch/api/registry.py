"""Algorithm registry — the table :func:`repro_torch.api.build` dispatches on
(counterpart of ``repro/api/registry.py``, model-scale trainers only).

Trainer factories self-register at import with :func:`register`, declaring
their sequence spec and their algorithm-specific hyperparams (defaults, and
which of them are :class:`~repro_torch.config.FederatedConfig` fields).
The names themselves — hyperparameters, sections, PRIVATE sections — have
one table, :data:`repro_torch.api.spec.ALGORITHMS`, which validation reads;
registration takes the sections from it and refuses a trainer that
disagrees with it.
Ported: FedBiO, FedBiOAcc, FedBiO-Local, FedBiOAcc-Local and FedAvg.

:func:`make_algorithm` is the problem-level factory: the paper's
Algorithms 1-4 and the Table-1 baselines on a ``core.problems.Problem``.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, field
from typing import Callable, Dict, Mapping, Tuple

from repro_torch.api.spec import ALGORITHMS


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


def register(name: str, sequences, *,
             hparams: Mapping[str, float] | None = None,
             cfg_fields: Tuple[str, ...] = ()):
    """Decorator: register a ``make_*_train_step`` factory under ``name``,
    running the sequence spec ``sequences`` (an ``optim.sequences.AlgoSpec``).
    Its hyperparameter names, sections and PRIVATE sections must be those of
    ``ALGORITHMS[name]``."""
    from repro_torch.optim.sequences import PRIVATE
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


# ---------------------------------------------------------------------------
# Problem-level algorithms (the paper's Algorithms 1-4 and Table-1 baselines)
# ---------------------------------------------------------------------------

def _core_factories() -> Dict[str, Callable]:
    from repro_torch.core.baselines import (make_commfedbio, make_fednest,
                                            make_mrbo, make_stocbio)
    from repro_torch.core.fedbio import make_fedbio
    from repro_torch.core.fedbioacc import make_fedbioacc
    from repro_torch.core.local_lower import (make_fedbio_local,
                                              make_fedbioacc_local)
    return {
        "fedbio": make_fedbio,
        "fedbioacc": make_fedbioacc,
        "fedbio_local": make_fedbio_local,
        "fedbioacc_local": make_fedbioacc_local,
        "fednest": make_fednest,
        "commfedbio": make_commfedbio,
        "stocbio": make_stocbio,
        "mrbo": make_mrbo,
    }


def make_algorithm(problem, cfg):
    """Problem-level algorithm factory (``cfg.algorithm`` names it): the
    loops of Algorithms 1-4 and the Table-1 baselines on a
    :class:`repro_torch.core.problems.Problem`."""
    factories = _core_factories()
    if cfg.algorithm not in factories:
        raise KeyError(f"unknown algorithm {cfg.algorithm!r}; "
                       f"choose from {sorted(factories)}")
    return factories[cfg.algorithm](problem, cfg)
