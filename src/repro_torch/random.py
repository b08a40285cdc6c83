"""JAX's default pseudo-random generator, Threefry-2x32, on PyTorch tensors.

The counterpart of the ``jax.random`` functions the JAX package draws from,
with the semantics of jax 0.9.0 under ``jax_threefry_partitionable=True``
(its default): the same key gives the same bits.

* A key is an int64 tensor of shape ``[2]`` holding two uint32 words;
  :func:`split` returns ``[num, 2]``.  Every word is kept in ``[0, 2^32)``
  by masking, since ``torch.uint32`` lacks shifts and bitwise operations on
  some builds.
* Draws happen on the key's device: a key on the card draws on the card.
* :func:`bits`, :func:`uniform`, :func:`randint`, :func:`bernoulli` and
  :func:`permutation` equal ``jax.random``'s bit for bit.  ``uniform``
  scales as the compiled reference does, with one rounding of
  ``floats·(maxval − minval) + minval`` (XLA contracts it into a fused
  multiply-add): the product of two f32 values is exact in f64, so the sum
  is taken there and rounded to f32.  That rounds twice only where the f64
  sum falls exactly half-way between two f32 values, which needs
  ``maxval − minval`` and ``minval`` many binades apart.
* :func:`normal` goes through :func:`erf_inv`, the f32 polynomial XLA
  lowers ``lax.erf_inv`` to, and :func:`gumbel` through ``log``; the
  reference evaluates ``log1p``, ``sqrt`` and ``log`` with XLA's own
  approximations, so these two agree within a few f32 ulps
  (``tests/test_torch_random.py`` states the bound).
"""
from __future__ import annotations

import math

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# the f32 constants of XLA's erf_inv: w < 5, then w >= 5, highest degree first
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)
_ERFINV = tuple((float(np.float32(a)), float(np.float32(b)))
                for a, b in zip(_ERFINV_SMALL, _ERFINV_LARGE))


def _mask(x):
    return x & MASK


def threefry_2x32(k1, k2, x0, x1, wrap=_mask):
    """The 20-round Threefry-2x32 hash of the counter pairs ``(x0, x1)``
    under the key ``(k1, k2)``, all broadcast together.  ``wrap`` reduces a
    sum or a left shift modulo 2^32: a mask for int64 tensors holding
    uint32 words, nothing for numpy uint32 arrays, which wrap by
    themselves."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = wrap(x0 + ks[0])
    x1 = wrap(x1 + ks[1])
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = wrap(x0 + x1)
            x1 = (wrap(x1 << r) | (x1 >> (32 - r))) ^ x0
        x0 = wrap(x0 + ks[(i + 1) % 3])
        x1 = wrap(x1 + ks[(i + 2) % 3] + (i + 1))
    return x0, x1


def _shape(shape) -> tuple:
    return (int(shape),) if isinstance(shape, int) else tuple(shape)


def _hash(k1, k2, hi, lo):
    """``threefry_2x32`` over int64 tensors on one device.  On the CPU the
    hash runs on numpy uint32 arrays, where its ~100 small operations cost
    a fifth of what they cost as tensor operations; elsewhere on the
    tensors themselves."""
    if hi.device.type != "cpu":
        return threefry_2x32(k1, k2, hi, lo)
    with np.errstate(over="ignore"):
        out = threefry_2x32(*(t.numpy().astype(np.uint32)
                              for t in (k1, k2, hi, lo)), wrap=lambda x: x)
    return tuple(torch.from_numpy(np.asarray(o, dtype=np.int64)) for o in out)


def _hash_iota(key: torch.Tensor, shape: tuple):
    """The hash of the 64-bit counters 0 .. prod(shape) − 1 laid out in
    ``shape`` (``iota_2x32_shape``: high and low words)."""
    idx = torch.arange(math.prod(shape), dtype=torch.int64,
                       device=key.device).reshape(shape)
    return _hash(key[0], key[1], idx >> 32, idx & MASK)


def _bits_many(keys: torch.Tensor, shapes) -> tuple:
    """``bits(keys[i], shapes[i])`` for every i, flattened and concatenated,
    from one pass of the hash with each counter under its own key; and the
    sizes."""
    sizes = [math.prod(_shape(s)) for s in shapes]
    dev = keys.device
    idx = torch.cat([torch.arange(n, dtype=torch.int64, device=dev)
                     for n in sizes])
    words = keys.repeat_interleave(torch.tensor(sizes, device=dev), dim=0)
    b1, b2 = _hash(words[:, 0], words[:, 1], idx >> 32, idx & MASK)
    return b1 ^ b2, sizes


def PRNGKey(seed: int, *, device=None) -> torch.Tensor:
    """The key of an integer seed, ``[0, seed mod 2^32]`` as the reference
    builds it with 64-bit integers off."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64,
                        device=device)


def split(key: torch.Tensor, num=2) -> torch.Tensor:
    """``num`` new keys (an int or a shape) as ``[*shape, 2]``."""
    b1, b2 = _hash_iota(key, _shape(num))
    return torch.stack([b1, b2], dim=-1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """The key of ``key`` and the uint32 ``data``."""
    words = torch.tensor([0, int(data) & MASK], dtype=torch.int64,
                         device=key.device)
    return torch.stack(_hash(key[0], key[1], words[0], words[1]))


def bits(key: torch.Tensor, shape=()) -> torch.Tensor:
    """Uniform uint32 words (int64 tensor) of ``shape``."""
    b1, b2 = _hash_iota(key, _shape(shape))
    return b1 ^ b2


def _check_float(name: str, dtype) -> None:
    if dtype != torch.float32:
        raise TypeError(f"{name}: only float32 is ported, got {dtype}")


def uniform(key, shape=(), dtype=torch.float32, minval=0.0,
            maxval=1.0) -> torch.Tensor:
    """Uniform floats in ``[minval, maxval)`` (scalar bounds)."""
    _check_float("uniform", dtype)
    return _uniform_bits(bits(key, _shape(shape)), minval, maxval)


def _uniform_bits(words: torch.Tensor, minval, maxval) -> torch.Tensor:
    """23 random mantissa bits of each word as a float in [1, 2), less one,
    scaled by the f32 ``maxval − minval`` with one rounding."""
    lo, hi = np.float32(minval), np.float32(maxval)
    floats = ((words >> 9) | 0x3F800000).to(torch.int32).view(
        torch.float32) - 1.0
    return _fma32(floats, float(hi - lo), float(lo)).clamp_min(float(lo))


def _fma32(a: torch.Tensor, b, c) -> torch.Tensor:
    """``a·b + c`` for f32 values with one rounding to f32, as XLA
    contracts it: their product is exact in f64 (the module docstring says
    when the sum rounds twice)."""
    return (a.double() * b + c).float()


def _clip_int32(v: int) -> int:
    return min(max(int(v), -2 ** 31), 2 ** 31 - 1)


def randint(key, shape, minval: int, maxval: int,
            dtype=torch.int32) -> torch.Tensor:
    """Integers in ``[minval, maxval)`` from two 32-bit draws per value,
    reduced modulo the span with the reference's uint32 arithmetic."""
    if dtype != torch.int32:
        raise TypeError(f"randint: only int32 is ported, got {dtype}")
    shape = _shape(shape)
    words, sizes = _bits_many(split(key), (shape, shape))
    higher, lower = (w.reshape(shape) for w in words.split(sizes))
    out_of_range = int(maxval) > 2 ** 31 - 1
    lo, hi = _clip_int32(minval), _clip_int32(maxval)
    span = (hi - lo) & MASK
    if hi <= lo:
        span = 1
    elif out_of_range:
        span = (span + 1) & MASK
    mult = 2 ** 16 % span
    mult = (mult * mult & MASK) % span
    offset = ((higher % span) * mult + lower % span) & MASK
    return (lo + offset % span).to(dtype)


def bernoulli(key, p=0.5, shape=None) -> torch.Tensor:
    """Booleans, True with probability ``p``."""
    p = torch.as_tensor(p, dtype=torch.float32, device=key.device)
    shape = tuple(p.shape) if shape is None else _shape(shape)
    return uniform(key, shape, torch.float32) < p


def _shuffle(key, x: torch.Tensor, axis: int) -> torch.Tensor:
    """Stable sorts of ``x`` along ``axis`` by fresh 32-bit keys, repeated
    as often as the reference's static criterion says."""
    rounds = int(np.ceil(3 * np.log(max(1, x.numel()))
                         / np.log(np.iinfo(np.uint32).max)))
    for _ in range(rounds):
        key, sub = split(key)
        order = torch.sort(bits(sub, tuple(x.shape)), dim=axis,
                           stable=True).indices
        x = torch.gather(x, axis, order)
    return x


def permutation(key, x, axis: int = 0, independent: bool = False):
    """A shuffled ``arange(x)`` (int32) for an int ``x``, else ``x``
    shuffled along ``axis`` (each slice on its own if ``independent``)."""
    if isinstance(x, int):
        return _shuffle(key, torch.arange(x, dtype=torch.int32,
                                          device=key.device), 0)
    axis = axis % max(x.dim(), 1)
    if independent or x.dim() == 1:
        return _shuffle(key, x, axis)
    ind = _shuffle(key, torch.arange(x.shape[axis], dtype=torch.int32,
                                     device=key.device), 0)
    return torch.index_select(x, axis, ind)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 inverse error function: a degree-8 polynomial in
    ``w − 2.5`` (``w = −log1p(−x²) < 5``) or ``√w − 3``, its Horner steps
    contracted into multiply-adds as the compiled reference has them, times
    ``x``; ``±1`` give ``±inf``."""
    w = -torch.log1p(x * -x)
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0).double()
    p = torch.where(small, *_ERFINV[0])
    for a, b in _ERFINV[1:]:
        p = _fma32(p, w, torch.where(small, a, b).double())
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def normal(key, shape=(), dtype=torch.float32) -> torch.Tensor:
    """Standard normal floats: ``√2 · erf_inv(u)`` with ``u`` uniform in
    ``(nextafter(−1, 0), 1)``."""
    _check_float("normal", dtype)
    return _normal_bits(bits(key, _shape(shape)))


def normals(keys: torch.Tensor, shapes) -> list:
    """``[normal(k, s) for k, s in zip(keys, shapes)]`` (f32), drawn in one
    pass of the hash and of ``erf_inv``: the same values, fewer small
    operations."""
    words, sizes = _bits_many(keys, shapes)
    return [z.reshape(_shape(s))
            for z, s in zip(_normal_bits(words).split(sizes), shapes)]


def _normal_bits(words: torch.Tensor) -> torch.Tensor:
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    return float(np.float32(math.sqrt(2.0))) * erf_inv(
        _uniform_bits(words, lo, 1.0))


def gumbel(key, shape=(), dtype=torch.float32) -> torch.Tensor:
    """Standard Gumbel floats, ``−log(−log(u))`` with ``u`` uniform in
    ``[tiny, 1)`` (the reference's default, low-range mode)."""
    _check_float("gumbel", dtype)
    tiny = float(np.finfo(np.float32).tiny)
    return -torch.log(-torch.log(uniform(key, shape, dtype, tiny, 1.0)))
