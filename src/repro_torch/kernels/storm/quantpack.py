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

The pack has two kernels: ``pack_cluster`` reads each tile once, shared
over a thread-block cluster of :func:`cluster_size` CTAs; the two-pass
``pack_tiles`` takes the tiles it cannot (too large, a part that is not a
multiple of 4 elements, unaligned pointers).  ``LAUNCHES`` counts kernel
launches on the card per wrapper, ``VARIANTS`` per pack kernel, ``CALLS``
calls of each wrapper on any device; :func:`reset_counts` zeroes all three.
Fake CUDA tensors get fake outputs and launch nothing
(``kernels/abstract.py``): the pack's fake rule names the kernel a buffer
aligned to 16 bytes gets.  :func:`work` is each kernel's work per launch.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import abstract
from repro_torch.kernels.storm import ref

_NAMES = ("quantpack", "quantunpack")
LAUNCHES = dict.fromkeys(_NAMES, 0)
CALLS = dict.fromkeys(_NAMES, 0)
VARIANTS = {"quantpack_cluster": 0, "quantpack_tiles": 0}
# The cluster kernel's layout, owned here: quantpack.cu checks that the
# cluster size it is given is portable and that a part fits shared memory.
MAX_PART, MAX_CLUSTER = 8192, 8      # elements a CTA holds; CTAs a cluster
PART_MULTIPLE = 4                    # a part's bulk copy: 16-byte multiples

_VP, _I64 = ctypes.c_void_p, ctypes.c_int64


def reset_counts() -> None:
    for d in (LAUNCHES, CALLS, VARIANTS):
        for k in d:
            d[k] = 0


@functools.cache
def _lib():
    from repro_torch.kernels.build import load
    lib = load("quantpack")
    lib.quantpack_cluster.argtypes = [_VP, _VP, _VP, _I64, _I64, _I64, _VP]
    lib.quantpack_tiles.argtypes = [_VP, _VP, _VP, _I64, _I64, _VP]
    lib.quantunpack.argtypes = [_VP, _VP, _VP, _I64, _I64, _VP]
    for fn in (lib.quantpack_cluster, lib.quantpack_tiles, lib.quantunpack):
        fn.restype = ctypes.c_int
    return lib


def cluster_size(block: int) -> int:
    """CTAs of the cluster that ``pack_cluster`` shares a tile of ``block``
    elements over: the smallest of 1, 2, 4, 8 that leaves each CTA at most
    ``MAX_PART`` elements, a multiple of ``PART_MULTIPLE``; 0 when none
    does and the tile goes to the two-pass kernel."""
    cl = 1
    while cl <= MAX_CLUSTER:
        if block % cl == 0 and block // cl <= MAX_PART and \
                (block // cl) % PART_MULTIPLE == 0:
            return cl
        cl *= 2
    return 0


def pack_variant(block: int, x_ptr: int, q_ptr: int) -> str:
    """The pack kernel that takes a tile of ``block`` elements from ``x``
    at address ``x_ptr`` into ``q`` at ``q_ptr``."""
    if cluster_size(block) and x_ptr % 16 == 0 and q_ptr % 4 == 0:
        return "quantpack_cluster"
    return "quantpack_tiles"


def work(name: str, n: int, block: int) -> abstract.Work:
    """The work of one launch over ``n`` elements in tiles of ``block``:
    the pack reads the f32 x and writes int8 q and the f32 scales (six
    operations an element: the absmax, the scale, the division, the
    rounding and the two clamps); the unpack reads q and the scales and
    writes one f32 product an element."""
    tiles = n // block
    if name == "quantpack":
        return abstract.Work(4 * n + n + 4 * tiles, 6 * n)
    return abstract.Work(n + 4 * tiles + 4 * n, n)


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
    if abstract.device_type(tensors[0]) == "cpu":
        return False
    if abstract.device_type(tensors[0]) != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: tensors must be contiguous")
    return True


def _run(name, fn_name, dev, *args) -> None:
    fn = getattr(_lib(), fn_name)
    with torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn_name}: kernel launch failed with CUDA error "
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
    if abstract.is_fake(x):
        abstract.record(pack_variant(block, 0, 0),
                        work("quantpack", n, block))
        return q, scales
    ptrs = (x.data_ptr(), q.data_ptr(), scales.data_ptr())
    variant = pack_variant(block, ptrs[0], ptrs[1])
    if variant == "quantpack_cluster":
        _run("quantpack", variant, x.device, *ptrs, n, block,
             cluster_size(block))
    else:
        _run("quantpack", variant, x.device, *ptrs, n, block)
    VARIANTS[variant] += 1
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
    if abstract.is_fake(q, scales):
        abstract.record("quantunpack", work("quantunpack", n, block))
        return out
    _run("quantunpack", "quantunpack", q.device, q.data_ptr(), scales.data_ptr(),
         out.data_ptr(), n, block)
    return out
