"""Triple-sequence storm-family kernels for Hopper: the wrappers around
``kernels/csrc/storm3.cu``.

* :func:`storm3_step`   replaces ``repro/kernels/storm/kernel.py``
  ``storm3_step_flat``: ``p' = p − lr[t]·m``, ``m' = decay[t]·(m − g_old)``.
* :func:`storm3_update` replaces ``storm3_update_flat``:
  ``p' = p − lr[t]·m``, ``m' = g_new + decay[t]·(m − g_old)``.
* :func:`sgd3_step`     replaces ``sgd3_step_flat``: ``p' = p − lr[t]·g``.
* :func:`momsgd3_step`  replaces ``momsgd3_step_flat``:
  ``m' = β[t]·m + g``, ``p' = p − lr[t]·m'``.
* :func:`storm_update_flat` replaces ``storm_update_flat``: ``p' = p − lr·m``,
  ``m' = g_new + decay·(m − g_old)`` with one scalar ``(lr, decay)``, over
  buffers of any length (the pytree entry point is ``ops.storm_update``).

``t = i // block`` indexes the per-tile (lr, decay|β) tables of the flat
layout (``block`` = :data:`BLOCK` unless the spec says otherwise).

Dispatch is by device and nothing else: tensors on the CPU go to the plain
PyTorch versions in ``ref.py``; tensors on a CUDA device launch the kernel on
the current stream, or raise if the kernel cannot take them.  There is no
fallback from the card to the plain version.

``LAUNCHES`` counts kernel launches on the card, ``CALLS`` counts calls of
each wrapper on any device; :func:`reset_counts` zeroes both.  Fake CUDA
tensors get fake outputs and launch nothing (``kernels/abstract.py``);
:func:`work` is each kernel's work per launch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import abstract
from repro_torch.kernels.storm import ref

BLOCK = 64 * 1024      # the flat layout's tile; the JAX package's default

_NAMES = ("storm3_step", "storm3_update", "sgd3_step", "momsgd3_step",
          "storm_update")
LAUNCHES = dict.fromkeys(_NAMES, 0)
CALLS = dict.fromkeys(_NAMES, 0)

_VP, _I64, _INT, _F32 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                         ctypes.c_float)
_DTYPES = (torch.float32, torch.bfloat16)
# kernel → (f32 input streams, tables, outputs, operations per element)
_SHAPES = {"storm3_step": (2, 2, 2, 4), "storm3_update": (3, 2, 2, 5),
           "sgd3_step": (1, 1, 1, 2), "momsgd3_step": (2, 2, 2, 4)}


def work(name: str, n: int, p_dtype, *, block: int = BLOCK,
         m_dtype=torch.float32) -> abstract.Work:
    """The work of one launch of ``name`` over ``n`` elements of a
    ``p_dtype`` buffer: p, the f32 streams and the per-tile tables read,
    p' (and the f32 m') written.  ``storm_update`` takes scalar (lr,
    decay) and its momentum, gradients and m' in ``m_dtype``."""
    p_size = p_dtype.itemsize
    if name == "storm_update":
        m_size = m_dtype.itemsize
        return abstract.Work(2 * n * p_size + 4 * n * m_size, 5 * n)
    n_in, n_tables, n_out, ops = _SHAPES[name]
    moved = (n * p_size + n_in * 4 * n + n_tables * 4 * (n // block)
             + n * p_size + (n_out - 1) * 4 * n)
    return abstract.Work(moved, ops * n)


def reset_counts() -> None:
    for d in (LAUNCHES, CALLS):
        for k in d:
            d[k] = 0


def _lib():
    from repro_torch.kernels.build import load
    lib = load("storm3")
    # pointers: p, the f32 streams, the tables, then the outputs
    for name, n_ptrs in (("storm3_step", 7), ("storm3_update", 8),
                         ("sgd3_step", 4), ("momsgd3_step", 7)):
        fn = getattr(lib, name)
        fn.argtypes = [_INT] + [_VP] * n_ptrs + [_I64, _I64, _VP]
        fn.restype = ctypes.c_int
    lib.storm_update.argtypes = [_INT, _INT] + [_VP] * 4 + [_F32, _F32, _VP,
                                                            _VP, _I64, _VP]
    lib.storm_update.restype = ctypes.c_int
    return lib


def _check(name, p, streams, tables, block: int) -> bool:
    """Validate shapes; returns True for the card, False for the CPU."""
    tensors = (p, *streams, *tables)
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on several devices {devices}")
    n = p.numel()
    if any(t.dim() != 1 for t in tensors):
        raise ValueError(f"{name}: buffers and tables must be flat [N] / [T]")
    if block <= 0 or n % block:
        raise ValueError(f"{name}: N={n} is not a multiple of block={block}")
    if any(s.numel() != n for s in streams):
        raise ValueError(f"{name}: buffers differ in length")
    if any(t.numel() != n // block for t in tables):
        raise ValueError(f"{name}: tables need N/block={n // block} entries, "
                         f"got {[t.numel() for t in tables]}")
    dev = p.device
    if abstract.device_type(p) == "cpu":
        return False
    if abstract.device_type(p) != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    if p.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: p must be float32 or bfloat16, got {p.dtype}")
    if any(t.dtype != torch.float32 for t in (*streams, *tables)):
        raise TypeError(f"{name}: momenta, gradients and tables must be "
                        f"float32")
    if not all(t.is_contiguous() or abstract.host_stand_in(t)
               for t in tensors):
        raise ValueError(f"{name}: tensors must be contiguous")
    return True


def _launch(name, p, streams, tables, block: int, n_out: int):
    """Launch ``name`` on the current stream; returns ``p'`` alone
    (``n_out`` 1) or ``(p', m')`` (``n_out`` 2, ``m'`` f32).  Fake tensors
    get fake outputs and the launch's work is recorded instead."""
    outs = [torch.empty_like(p)]
    if n_out == 2:
        outs.append(torch.empty_like(streams[0]))
    if abstract.is_fake(p, *streams, *tables):
        abstract.record(name, work(name, p.numel(), p.dtype, block=block))
        return outs[0] if n_out == 1 else tuple(outs)
    fn = getattr(_lib(), name)
    stream = torch.cuda.current_stream(p.device).cuda_stream
    with torch.cuda.device(p.device):
        err = fn(int(p.dtype == torch.bfloat16),  # analysis: ignore[L303] dtype flag
                 *[t.data_ptr() for t in (p, *streams, *tables, *outs)],
                 p.numel(), block, stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")
    LAUNCHES[name] += 1
    return outs[0] if n_out == 1 else tuple(outs)


def storm3_step(p, m, g_old, lrs, decays, *, block: int = BLOCK):
    """Half step over flat buffers: (p − lr·m, decay·(m − g_old))."""
    CALLS["storm3_step"] += 1
    if not _check("storm3_step", p, (m, g_old), (lrs, decays), block):
        return ref.storm3_step_ref(p, m, g_old, lrs, decays, block)
    return _launch("storm3_step", p, (m, g_old), (lrs, decays), block, 2)


def storm3_update(p, m, g_new, g_old, lrs, decays, *, block: int = BLOCK):
    """Full update over flat buffers: (p − lr·m, g_new + decay·(m − g_old))."""
    CALLS["storm3_update"] += 1
    if not _check("storm3_update", p, (m, g_new, g_old), (lrs, decays), block):
        return ref.storm3_update_ref(p, m, g_new, g_old, lrs, decays, block)
    return _launch("storm3_update", p, (m, g_new, g_old), (lrs, decays),
                   block, 2)


def sgd3_step(p, g, lrs, *, block: int = BLOCK):
    """Plain SGD step over flat buffers: ``p − lr·g`` (``p'`` alone)."""
    CALLS["sgd3_step"] += 1
    if not _check("sgd3_step", p, (g,), (lrs,), block):
        return ref.sgd3_step_ref(p, g, lrs, block)
    return _launch("sgd3_step", p, (g,), (lrs,), block, 1)


def momsgd3_step(p, m, g, lrs, betas, *, block: int = BLOCK):
    """Heavy-ball step over flat buffers: ``m' = β·m + g`` and
    ``p' = p − lr·m'``; returns ``(p', m')``."""
    CALLS["momsgd3_step"] += 1
    if not _check("momsgd3_step", p, (m, g), (lrs, betas), block):
        return ref.momsgd3_step_ref(p, m, g, lrs, betas, block)
    return _launch("momsgd3_step", p, (m, g), (lrs, betas), block, 2)


def storm_update_flat(p, m, g_new, g_old, lr, decay):
    """Single-sequence update over flat ``[N]`` buffers of any length:
    ``(p − lr·m, g_new + decay·(m − g_old))``.  ``p`` is float32 or bfloat16;
    ``m``, ``g_new`` and ``g_old`` share one dtype (float32 or bfloat16),
    which ``m'`` takes.  Python floats ``lr`` and ``decay`` are rounded to
    f32 once, as the reference's ``jnp.asarray(lr, float32)``."""
    name = "storm_update"
    CALLS[name] += 1
    tensors = (p, m, g_new, g_old)
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on several devices {devices}")
    if any(t.dim() != 1 for t in tensors) or \
            any(t.numel() != p.numel() for t in tensors):
        raise ValueError(f"{name}: needs flat [N] buffers of one length, got "
                         f"{[tuple(t.shape) for t in tensors]}")
    if p.dtype not in _DTYPES or m.dtype not in _DTYPES:
        raise TypeError(f"{name}: p and m must be float32 or bfloat16, got "
                        f"{p.dtype}, {m.dtype}")
    if g_new.dtype != m.dtype or g_old.dtype != m.dtype:
        raise TypeError(f"{name}: g_new and g_old must have m's dtype "
                        f"{m.dtype}, got {g_new.dtype}, {g_old.dtype}")
    dev = p.device
    if abstract.device_type(p) == "cpu":
        return ref.storm_update_ref(p, m, g_new, g_old, lr, decay)
    if abstract.device_type(p) != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: tensors must be contiguous")
    p_out, m_out = torch.empty_like(p), torch.empty_like(m)
    if p.numel() == 0:
        return p_out, m_out
    if abstract.is_fake(*tensors):
        abstract.record(name, work(name, p.numel(), p.dtype,
                                   m_dtype=m.dtype))
        return p_out, m_out
    lr32, decay32 = (float(torch.tensor(float(x), dtype=torch.float32))  # analysis: ignore[L303] host scalar
                     for x in (lr, decay))
    with torch.cuda.device(dev):
        err = _lib().storm_update(
            int(p.dtype == torch.bfloat16), int(m.dtype == torch.bfloat16),  # analysis: ignore[L303] dtype flags
            *(t.data_ptr() for t in tensors), lr32, decay32,
            p_out.data_ptr(), m_out.data_ptr(), p.numel(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")
    LAUNCHES[name] += 1
    return p_out, m_out
