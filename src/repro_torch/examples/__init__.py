"""The paper's two experiments on the port (counterparts of
``examples/data_cleaning.py`` and ``examples/hyper_representation.py``):
``python -m repro_torch.examples.data_cleaning`` and
``python -m repro_torch.examples.hyper_representation``."""
