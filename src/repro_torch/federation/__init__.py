"""``repro_torch.federation`` — the federated layers of the port: the
trainers, participation, stragglers, compression and the fault engine."""
from repro_torch.federation.faults import (AGGREGATORS, Faults,  # noqa: F401
                                           FaultSpec, RobustnessSpec,
                                           RollbackError, RollbackGuard,
                                           make_faults)
