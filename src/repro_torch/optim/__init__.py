"""``repro_torch.optim`` — the optimizer substrate: the minimal pytree
optimizers (``optimizers``), the flat-buffer substrate (``flat``) and the
sequence-spec engine (``sequences``)."""
from repro_torch.optim.optimizers import adam, momentum, sgd  # noqa: F401
