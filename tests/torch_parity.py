"""Numpy bridge shared by the ``test_torch_*`` parity tests: data crosses
between the JAX reference and the PyTorch port as numpy arrays, and bit
comparisons use uint8 views."""
import numpy as np
import torch

from repro_torch.models.registry import params_from_numpy


def bits(a) -> np.ndarray:
    """Raw bytes of a torch tensor or an array (JAX or numpy)."""
    if isinstance(a, torch.Tensor):
        t = a.detach().cpu().reshape(-1)
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy().view(np.uint8)
    return np.asarray(a).reshape(-1).view(np.uint8)


def f32(a) -> np.ndarray:
    """A torch tensor or an array as float32 numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().to(torch.float32).numpy()
    return np.asarray(a, dtype=np.float32)


def to_torch(tree, device="cpu"):
    """A tree of JAX/numpy arrays as tensors, bit for bit."""
    import jax
    return params_from_numpy(jax.tree.map(np.asarray, tree), device)


def contraction_tol(out, product) -> np.ndarray:
    """Elementwise: one rounding of ``product`` plus one unit in the last
    place of ``out`` in its own dtype."""
    ulp_res = np.spacing(np.abs(f32(out)))
    if isinstance(out, torch.Tensor) and out.dtype == torch.bfloat16:
        ulp_res = ulp_res * 2.0 ** 16          # 8 mantissa bits, not 24
    return np.spacing(np.abs(f32(product))) + ulp_res


def assert_contraction_close(out, fused, product, carried=0.0):
    """``out`` (each op rounded) and ``fused`` (a multiply-add contracted
    into one FMA, as XLA's CPU backend does under ``jit``) differ by at most
    one rounding of ``product`` plus one unit in the last place of the
    result in its own dtype, elementwise.  ``carried`` adds what an input
    that already differs between the two brings along."""
    tol = contraction_tol(out, product) + carried
    diff = np.abs(f32(out) - f32(fused))
    assert np.all(diff <= tol), float(np.max(diff - tol))
