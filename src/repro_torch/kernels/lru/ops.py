"""The RG-LRU scan ``h_t = a_t ⊙ h_{t−1} + b_t``: the wrapper around
``kernels/csrc/lru_scan.cu``, which replaces ``repro/kernels/lru/kernel.py``
``lru_scan_padded`` (with the padding of ``repro/kernels/lru/ops.py``).

Dispatch is by device and nothing else: tensors on the CPU go to the plain
PyTorch version in ``ref.py``; tensors on a CUDA device launch the kernel on
the current stream, or raise if the kernel cannot take them.

Two kernels: ``lru_scan_tma`` (a TMA ring of [64 time steps × 64
channels] tiles) where TMA can read the tensors (``C % 4 == 0``, a and b
16-byte aligned), else ``lru_scan_lanes``; :func:`scan_variant` picks.
``LAUNCHES`` counts kernel launches on the card, ``VARIANTS`` each kernel's,
``CALLS`` calls on any device; :func:`reset_counts` zeroes all three.
Fake CUDA tensors get a fake output and launch nothing
(``kernels/abstract.py``): the fake rule names the kernel tensors aligned to
16 bytes get.  :func:`work` is the kernel's work per launch.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import abstract
from repro_torch.kernels.lru.ref import lru_scan_ref

LAUNCHES = {"lru_scan": 0}
CALLS = {"lru_scan": 0}
VARIANTS = {"lru_scan_tma": 0, "lru_scan_lanes": 0}
# lru_scan_tma's tile: time steps by channels (lru_scan.cu kTT, kCB)
TIME_TILE, CHANNEL_BLOCK = 64, 64

_VP, _I64 = ctypes.c_void_p, ctypes.c_int64


def reset_counts() -> None:
    for d in (LAUNCHES, CALLS, VARIANTS):
        for k in d:
            d[k] = 0


@functools.cache
def _lib():
    from repro_torch.kernels.build import load
    lib = load("lru_scan")
    for fn in (lib.lru_scan_tma, lib.lru_scan_lanes):
        fn.argtypes = [_VP, _VP, _VP, _VP, _I64, _I64, _I64, _VP]
        fn.restype = ctypes.c_int
    return lib


def scan_variant(B: int, S: int, C: int, a_ptr: int, b_ptr: int) -> str:
    """The kernel that scans [B, S, C] tensors at addresses ``a_ptr`` and
    ``b_ptr``: TMA needs 16-byte global strides and addresses."""
    if C % 4 == 0 and a_ptr % 16 == 0 and b_ptr % 16 == 0 and \
            B <= 65535 and S < 2 ** 31 and C < 2 ** 31:
        return "lru_scan_tma"
    return "lru_scan_lanes"


def work(B: int, S: int, C: int, *, h0: bool = False) -> abstract.Work:
    """The work of one launch over f32 [B, S, C]: a and b (and h0) read,
    h written; one multiply and one add per element."""
    n = B * S * C
    return abstract.Work(4 * (3 * n + (B * C if h0 else 0)), 2 * n)


def lru_scan(a, b, h0=None):
    """``h_t = a_t·h_{t−1} + b_t`` along axis 1.  a, b: [B, S, C] f32;
    h0: [B, C] f32 or None (zeros).  Returns h: [B, S, C] f32."""
    CALLS["lru_scan"] += 1
    tensors = (a, b) if h0 is None else (a, b, h0)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"lru_scan: a, b and h0 must be float32, got "
                        f"{[t.dtype for t in tensors]}")
    if a.dim() != 3 or b.shape != a.shape:
        raise ValueError(f"lru_scan: a and b must be [B, S, C] of one shape, "
                         f"got {tuple(a.shape)} and {tuple(b.shape)}")
    B, S, C = a.shape
    if h0 is not None and tuple(h0.shape) != (B, C):
        raise ValueError(f"lru_scan: h0 must be [{B}, {C}], got "
                         f"{tuple(h0.shape)}")
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"lru_scan: tensors on several devices {devices}")
    dev = a.device
    if abstract.device_type(a) == "cpu":
        return lru_scan_ref(a, b, h0)
    if abstract.device_type(a) != "cuda":
        raise ValueError(f"lru_scan: no kernel for device {dev}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("lru_scan: tensors must be contiguous")
    out = torch.empty_like(a)
    if abstract.is_fake(*tensors):
        abstract.record(scan_variant(B, S, C, 0, 0),
                        work(B, S, C, h0=h0 is not None))
        return out
    variant = scan_variant(B, S, C, a.data_ptr(), b.data_ptr())
    with torch.cuda.device(dev):
        err = getattr(_lib(), variant)(
            a.data_ptr(), b.data_ptr(), None if h0 is None else h0.data_ptr(),
            out.data_ptr(), B, S, C, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{variant}: kernel launch failed with CUDA error "
                           f"{err}")
    LAUNCHES["lru_scan"] += 1
    VARIANTS[variant] += 1
    return out
