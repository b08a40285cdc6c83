"""``repro_torch.api`` — the declarative :class:`Experiment` spec and the
:func:`build` entrypoint of the PyTorch port."""
from repro_torch.api.build import Run, build  # noqa: F401
from repro_torch.api.spec import Experiment, SpecError  # noqa: F401
from repro_torch.federation.faults import (FaultSpec,  # noqa: F401
                                           RobustnessSpec, RollbackError,
                                           RollbackGuard, make_faults)
