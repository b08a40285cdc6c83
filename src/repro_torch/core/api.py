"""Import alias: ``make_algorithm(problem, cfg)``, the problem-level factory,
lives in :mod:`repro_torch.api.registry` beside the model-scale trainers'
registry (counterpart of ``repro/core/api.py``)."""
from __future__ import annotations

from repro_torch.api.registry import make_algorithm  # noqa: F401
from repro_torch.core.fedbio import Algorithm  # noqa: F401
