# The paper's primary contribution: FedBiO / FedBiOAcc (Algorithms 1-4) and
# the baselines from Table 1, plus the bilevel-problem and hyper-gradient
# substrate they run on.
from repro_torch.core.api import make_algorithm  # noqa: F401
from repro_torch.core.problems import (data_cleaning_problem,  # noqa: F401
                                       hyperrep_problem, quadratic_problem)
