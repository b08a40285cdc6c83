from repro_torch.kernels.storm.ops import storm_update  # noqa: F401
