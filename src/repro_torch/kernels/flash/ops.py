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
any device; :func:`reset_counts` zeroes both.
"""
from __future__ import annotations

import ctypes
import math

import torch

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
    if dev.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap, scale=scale)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {dev}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} is not one the "
                         f"kernel is built for {HEAD_DIMS}")
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
