"""Per-tile int8 pack/unpack for compressed communication: the wrappers
around ``kernels/csrc/quantpack.cu``.

* :func:`quantpack_flat`   replaces ``repro/kernels/storm/quantpack.py``
  ``quantpack_flat``: per ``block``-sized tile ``scale = max|x|·(1/127)``
  and ``q = clamp(rint(x / scale), −127, 127)`` (``scale`` 1 for a zero
  tile when dividing);
* :func:`quantunpack_flat` replaces ``quantunpack_flat``: ``q · scale[t]``,
  one rounded f32 product per element.

Dispatch is by device and nothing else: tensors on the CPU go to the plain
PyTorch versions in ``ref.py``; tensors on a CUDA device launch the kernel on
the current stream, or raise if the kernel cannot take them.

``LAUNCHES`` counts kernel launches on the card, ``CALLS`` counts calls of
each wrapper on any device; :func:`reset_counts` zeroes both.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.storm import ref

_NAMES = ("quantpack", "quantunpack")
LAUNCHES = dict.fromkeys(_NAMES, 0)
CALLS = dict.fromkeys(_NAMES, 0)

_VP, _I64 = ctypes.c_void_p, ctypes.c_int64


def reset_counts() -> None:
    for d in (LAUNCHES, CALLS):
        for k in d:
            d[k] = 0


def _lib():
    from repro_torch.kernels.build import load
    lib = load("quantpack")
    lib.quantpack.argtypes = [_VP, _VP, _VP, _I64, _I64, _VP]
    lib.quantunpack.argtypes = [_VP, _VP, _VP, _I64, _I64, _VP]
    lib.quantpack.restype = lib.quantunpack.restype = ctypes.c_int
    return lib


def _check(name, tensors, n: int, block: int) -> bool:
    """Validate shapes; returns True for the card, False for the CPU."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on several devices {devices}")
    if any(t.dim() != 1 for t in tensors):
        raise ValueError(f"{name}: buffers and scales must be flat [N] / [T]")
    if block <= 0 or n % block:
        raise ValueError(f"{name}: N={n} is not a multiple of block={block}")
    dev = tensors[0].device
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: tensors must be contiguous")
    return True


def _run(name, dev, *args) -> None:
    fn = getattr(_lib(), name)
    with torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")
    LAUNCHES[name] += 1


def quantpack_flat(x, *, block: int):
    """Pack a flat f32 [N] buffer into ``(q int8 [N], scales f32
    [N // block])``."""
    CALLS["quantpack"] += 1
    if x.dtype != torch.float32:
        raise TypeError(f"quantpack: x must be float32, got {x.dtype}")
    n = x.numel()
    if not _check("quantpack", (x,), n, block):
        return ref.quantpack_ref(x, block)
    q = torch.empty(n, dtype=torch.int8, device=x.device)
    scales = torch.empty(n // block, dtype=torch.float32, device=x.device)
    _run("quantpack", x.device, x.data_ptr(), q.data_ptr(), scales.data_ptr(),
         n, block)
    return q, scales


def quantunpack_flat(q, scales, *, block: int):
    """Dequantize ``(q int8 [N], scales f32 [N // block])`` to f32 [N]."""
    CALLS["quantunpack"] += 1
    if q.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError(f"quantunpack: needs int8 q and float32 scales, got "
                        f"{q.dtype} and {scales.dtype}")
    n = q.numel()
    on_card = _check("quantunpack", (q, scales), n, block)
    if scales.numel() != n // block:
        raise ValueError(f"quantunpack: scales need N/block={n // block} "
                         f"entries, got {scales.numel()}")
    if not on_card:
        return ref.quantunpack_ref(q, scales, block)
    out = torch.empty(n, dtype=torch.float32, device=q.device)
    _run("quantunpack", q.device, q.data_ptr(), scales.data_ptr(),
         out.data_ptr(), n, block)
    return out
