"""``repro_torch.federation`` — the federated layers of the port: the
trainers, participation, stragglers, compression, the fault engine and
the evaluation utilities."""
from repro_torch.federation.faults import (AGGREGATORS, Faults,  # noqa: F401
                                           FaultSpec, RobustnessSpec,
                                           RollbackError, RollbackGuard,
                                           make_faults)
from repro_torch.federation.evaluate import eval_federated, perplexity  # noqa: F401,E501
