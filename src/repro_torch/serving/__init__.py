from repro_torch.serving.engine import ServeEngine  # noqa: F401
