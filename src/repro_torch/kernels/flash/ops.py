"""Causal / sliding-window GQA flash attention: the wrapper around
``kernels/csrc/flash_attn.cu``, which replaces
``repro/kernels/flash/kernel.py`` ``flash_attention_bh`` (with the layout
work of ``repro/kernels/flash/ops.py``).

The reference repeats k and v to every query head and pads S to its tile;
the kernel reads kv head ``h // (H / Hkv)`` by index and masks keys at or
past the true length ``S`` itself, so neither copy is made.  (The
reference's padded path masks with the padded length instead: see ROADMAP
queue 3.)

Dispatch is by device and nothing else: tensors on the CPU go to the plain
PyTorch version in ``ref.py``; tensors on a CUDA device launch a kernel on
the current stream (bf16: ``flash_fwd_tc``, on the tensor cores; f32:
``flash_fwd``), or raise if the kernels cannot take them.

``LAUNCHES`` counts kernel launches on the card, ``CALLS`` counts calls on
any device; :func:`reset_counts` zeroes both.  Fake CUDA tensors get a fake
output and launch nothing (``kernels/abstract.py``); :func:`work` is the
kernel's work per launch.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import abstract
from repro_torch.kernels.flash.ref import flash_attention_ref

LAUNCHES = {"flash_attention": 0}      # both kernels count here
CALLS = {"flash_attention": 0}
HEAD_DIMS = (16, 32, 64, 80, 128, 256)   # the kernels' instantiations
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_VP, _I64, _INT, _F32 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                         ctypes.c_float)


def reset_counts() -> None:
    LAUNCHES["flash_attention"] = CALLS["flash_attention"] = 0


def _lib():
    from repro_torch.kernels.build import load
    lib = load("flash_attn")
    lib.flash_attn.argtypes = [_VP, _VP, _VP, _VP, _I64, _I64, _I64, _I64,
                               _I64, _INT, _INT, _I64, _F32, _F32, _VP]
    lib.flash_attn.restype = ctypes.c_int
    return lib


def band_pairs(S: int, *, causal: bool, window: int) -> int:
    """The (query, key) pairs of ``ref.band_mask(S, ...)``, counted in
    closed form."""
    w = window if window and window > 0 else 0
    if causal:
        if not w:
            return S * (S + 1) // 2
        m = min(S, w)
        return m * (m + 1) // 2 + (S - m) * w
    if not w:
        return S * S
    # query q sees keys k > q − w: all S while q < w − 1, then S − j
    full = min(S, w - 1)
    rest = S - full
    return full * S + rest * S - rest * (rest - 1) // 2


def work(B: int, S: int, H: int, hkv: int, D: int, dtype, *, causal: bool,
         window: int) -> abstract.Work:
    """The work of one launch: q, k, v read and the output written; per
    (query, key) pair in the band, D multiply-adds for q.k and D for p.v.
    The bf16 kernel runs one q.k product and three p.v products (the exact
    bf16 split of the f32 p) at the bf16 tensor-core rate; the f32 kernel
    the two on the CUDA cores."""
    size = dtype.itemsize
    moved = size * (2 * B * S * H * D + 2 * B * S * hkv * D)
    half = 2 * D * band_pairs(S, causal=causal, window=window) * B * H
    if dtype == torch.bfloat16:
        return abstract.Work(moved, 4 * half, "bf16_tc")
    return abstract.Work(moved, 2 * half)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, scale: float = None):
    """q: [B, S, H, D]; k, v: [B, S, Hkv, D] with H a multiple of Hkv, all
    float32 or all bfloat16.  Returns the attention output [B, S, H, D] in
    the input dtype."""
    CALLS["flash_attention"] += 1
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k, v must all be float32 or "
                        f"all bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: needs q [B, S, H, D] and k, v "
                         f"[B, S, Hkv, D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, D = q.shape
    hkv = k.shape[2]
    if (k.shape[0], k.shape[1], k.shape[3]) != (B, S, D) or H % hkv:
        raise ValueError(f"flash_attention: k, v {tuple(k.shape)} do not "
                         f"match q {tuple(q.shape)} (H a multiple of Hkv)")
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    devices = {t.device for t in (q, k, v)}
    if len(devices) != 1:
        raise ValueError(f"flash_attention: tensors on several devices "
                         f"{devices}")
    dev = q.device
    if abstract.device_type(q) == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap, scale=scale)
    if abstract.device_type(q) != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {dev}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} is not one the "
                         f"kernel is built for {HEAD_DIMS}")
    if abstract.is_fake(q, k, v):
        if not all(t.is_contiguous() for t in (q, k, v)):
            raise ValueError("flash_attention: q, k, v must be contiguous")
        abstract.record("flash_attention", work(
            B, S, H, hkv, D, q.dtype, causal=causal, window=window))
        return torch.empty_like(q)
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in (q, k, v)):
        raise ValueError("flash_attention: q, k, v must be contiguous and "
                         "16-byte aligned")
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        err = _lib().flash_attn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S,
            H, hkv, D, _DTYPES[q.dtype], int(bool(causal)),
            int(window or 0), float(softcap or 0.0), float(scale),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention: kernel launch failed with CUDA "
                           f"error {err}")
    LAUNCHES["flash_attention"] += 1
    return out
