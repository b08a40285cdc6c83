"""PyTorch/CUDA port of the federated bilevel system in ``repro``.

The package mirrors the module paths of ``repro`` and never imports it or
JAX.  Its hand-written Hopper kernels live under ``repro_torch.kernels``.
"""
