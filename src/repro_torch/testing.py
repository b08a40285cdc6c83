"""Checks shared by the port's parity tests and ``chip_smoke.py``: where two
runs of the compressed reduction cannot be fed bit-identical inputs (the
port against the JAX package, or the card against the CPU), per-tile top-k
and int8 rounding are discontinuous, and these helpers find and bound the
entries that the two runs decided differently.  Imports neither JAX nor the
JAX package, so the card's machine can run it."""
import numpy as np
import torch

from repro_torch.kernels.storm.ref import quantpack_ref

INV127 = np.float32(1.0) / np.float32(127.0)


def topk_flips(acc_a, sent_a, acc_b, sent_b, block: int, frac: float):
    """The entries that one side's per-tile top-k kept and the other's
    dropped, as an [M, N] bool array, from each side's compressed input
    ``acc`` and top-k output ``sent`` ([M, N], kept ⇔ sent ≠ 0).

    Asserts first that every flip lies within ``2·D`` of its tile's
    threshold on side a, D being the largest |acc_a − acc_b| in the tile.
    Why 2·D: the threshold is the tile's k-th largest magnitude, an order
    statistic, so the two sides' thresholds differ by at most D, and so do
    the entry's magnitudes; an entry kept on one side (|acc| ≥ thr) and
    dropped on the other (|acc| < thr) is therefore within 2·D of either
    threshold.  A selection rule other than "the k largest" would put flips
    farther away."""
    shape = np.shape(acc_a)
    a, b, sa, sb = (np.asarray(v, np.float32).reshape(shape[0], -1, block)
                    for v in (acc_a, acc_b, sent_a, sent_b))
    flips = (sa != 0) != (sb != 0)
    k = max(1, int(np.ceil(frac * block)))
    mag = np.abs(a)
    thr = np.partition(mag, block - k, axis=-1)[..., block - k:block - k + 1]
    d = np.abs(a - b).max(axis=-1, keepdims=True)
    far = flips & (np.abs(mag - thr) > 2 * d)
    assert not far.any(), (int(far.sum()), int(flips.sum()))
    return flips.reshape(shape)


def int8_flips(sent_a, sent_b, block: int):
    """The entries whose int8 value differs between two sides' sends
    ([M, N] f32, what entered the quantizer), as an [M, N] bool array.

    Rounding to the nearest integer is discontinuous too: ``q = rint(u)``
    with ``u = x / scale`` differs between the sides only where the two
    ``u`` lie on either side of a half-way point.  Asserts that every such
    entry differs by one step and lies within ``|u_a − u_b|`` of a half-way
    point (entries that top-k kept on one side alone are excluded here;
    :func:`topk_flips` rules on them)."""
    shape = np.shape(sent_a)
    qs, us = [], []
    for sent in (sent_a, sent_b):
        x = torch.from_numpy(np.array(sent, np.float32)).reshape(-1)
        q, s = quantpack_ref(x, block)
        safe = torch.where(s > 0, s, torch.ones_like(s))
        qs.append(q.numpy().reshape(shape).astype(np.int32))
        us.append((x.reshape(-1, block) / safe[:, None]).numpy()
                  .reshape(shape).astype(np.float64))
    both = (np.asarray(sent_a) != 0) & (np.asarray(sent_b) != 0)
    flips = (qs[0] != qs[1]) & both
    half = np.floor(us[0]) + 0.5
    far = flips & ((np.abs(qs[0] - qs[1]) != 1)
                   | (np.abs(us[0] - half) > np.abs(us[0] - us[1])))
    assert not far.any(), (int(far.sum()), int(flips.sum()))
    return flips


def halfway_tiles(rng, tiles: int, block: int) -> np.ndarray:
    """Flat f32 tiles for the int8 quantizer whose entries sit at
    ``(k + ½)·scale`` and one ulp either side of it, with the tile's max
    placed first so the scale (``max · f32(1/127)``) is known in advance."""
    out = []
    for _ in range(tiles):
        amax = np.float32(rng.lognormal(0.0, 3.0))
        scale = amax * INV127
        k = rng.integers(-127, 127, block).astype(np.float32)
        t = ((k + np.float32(0.5)) * scale).astype(np.float32)
        step = rng.integers(-1, 2, block)
        t = np.where(step > 0, np.nextafter(t, np.float32(np.inf)),
                     np.where(step < 0, np.nextafter(t, np.float32(-np.inf)),
                              t)).astype(np.float32)
        t[0] = amax
        out.append(t)
    return np.concatenate(out)
