"""Checks shared by the port's parity tests and ``chip_smoke.py``: where two
runs of the compressed reduction cannot be fed bit-identical inputs (the
port against the JAX package, or the card against the CPU), per-tile top-k
and int8 rounding are discontinuous, and these helpers find and bound the
entries that the two runs decided differently (so does CommFedBiO's
whole-leaf top-k).  For the bf16 attention,
a limit in bf16 ulps that the exact kernel meets and a kernel that rounds
p to bf16 or skips a key tile does not, and plain versions of those two
faults to show it.  For serving, a request's isolated greedy decoding and
the top-2 margin of a greedy choice, against which a continuous-batching
engine's tokens are held.  For the static verifier, a run whose step
smuggles one extra collective in, which its collective audit must flag.
Imports neither JAX nor the JAX package, so the card's machine can run
it."""
import math

import numpy as np
import torch

from repro_torch.core.tree_util import tree_map
from repro_torch.kernels.flash.ref import NEG_INF, band_mask
from repro_torch.kernels.storm.ref import quantpack_ref

INV127 = np.float32(1.0) / np.float32(127.0)
# two bf16 outputs rounded from f32 values that agree to f32 rounding differ
# by at most one ulp of the larger binade, two of the smaller; the floor
# stands for f32 rounding where cancellation leaves an output near zero
BF16_ULPS, BF16_FLOOR = 2.0, 1e-6


def bf16_ulps(got, want, floor: float = BF16_FLOOR) -> float:
    """The largest ``|got - want| / (ulp(want) + floor)``, ulp being the
    spacing of bf16 values in the binade of ``want`` (0 at zero)."""
    w = want.float()
    _, e = torch.frexp(w)
    ulp = torch.where(w == 0, torch.zeros_like(w),
                      torch.ldexp(torch.ones_like(w), e - 8))
    return float(((got.float() - w).abs() / (ulp + floor)).max())


def flash_attention_fault(q, k, v, fault: str, *, causal: bool = True,
                          window: int = 0, softcap: float = 0.0,
                          scale: float = None):
    """The plain attention (``kernels/flash/ref.py``) with one fault of a
    flash kernel: ``"p0"`` multiplies v by bf16(p) alone, the unnormalised
    p without its split's p1 and p2 (the sum l stays the f32 one);
    ``"tile"`` leaves out the 64 keys from S // 2, one key tile in the
    middle of the band."""
    B, S, H, D = q.shape
    hkv = k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    qg = q.to(torch.float32).reshape(B, S, hkv, H // hkv, D)
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg, k.to(torch.float32)) * scale
    if softcap and softcap > 0.0:
        s = torch.tanh(s / softcap) * softcap
    ok = band_mask(S, causal=causal, window=window, device=q.device)
    if fault == "tile":
        ok[:, S // 2:S // 2 + 64] = False
    elif fault != "p0":
        raise ValueError(f"unknown fault {fault!r}")
    s = torch.where(ok, s, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    if fault == "p0":
        p = p.to(torch.bfloat16).to(torch.float32)
    out = torch.einsum("bgrqk,bkgd->bqgrd", p / l, v.to(torch.float32))
    return out.reshape(B, S, H, D).to(q.dtype)


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


def leaf_topk_flips(acc_a, kept_a, acc_b, kept_b, ratio: float):
    """The entries that one side's whole-leaf top-k (CommFedBiO's
    compressor: the ``int(size · ratio)`` largest magnitudes of the leaf)
    kept and the other's dropped, as a bool array shaped like the leaf,
    from each side's compressor input ``acc`` and keep mask ``kept``.

    Asserts first that every such entry lies within ``2·D`` of side a's
    threshold, D the largest |acc_a − acc_b| in the leaf: the threshold is
    the k-th largest magnitude, so it moves by at most D between the
    sides, and so does the entry's magnitude (:func:`topk_flips` rules
    the same way per tile)."""
    a, b = (np.asarray(v, np.float32) for v in (acc_a, acc_b))
    flips = np.asarray(kept_a, bool) != np.asarray(kept_b, bool)
    mag = np.abs(a)
    thr = np.sort(mag.reshape(-1))[-max(1, int(mag.size * ratio))]
    far = flips & (np.abs(mag - thr) > 2 * float(np.abs(a - b).max()))
    assert not far.any(), (int(far.sum()), int(flips.sum()))
    return flips


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


def isolated_greedy(model, params, prompt, max_new: int, cache_len: int,
                    rows: int = 1):
    """A request decoded alone, greedy, as ``ServeEngine`` decodes it in a
    slot (a prefill at batch 1 with the kernels' switches set, then a
    decode step a token): returns its ``max_new`` tokens and the ``[V]``
    logits each was chosen from.  With ``rows`` > 1 the prefill's caches
    are copied into that many rows and each step decodes them all, reading
    row 0: every operator then runs at the batch size of an engine with
    ``rows`` slots."""
    with torch.no_grad():
        prompt = prompt.to(torch.int64)
        last, caches = model.prefill(params, {"tokens": prompt[None, :]},
                                     cache_len=cache_len, use_flash=True,
                                     use_lru_kernel=True)
        if rows > 1:
            caches = tree_map(lambda c: torch.cat([c] * rows, dim=1), caches)
        logits = [last[0]]
        tok = torch.argmax(last[0])
        chosen = [tok]
        for pos in range(prompt.shape[0], prompt.shape[0] + max_new - 1):
            lg, caches = model.decode_step(
                params, caches, tok.reshape(1, 1).expand(rows, 1), pos)
            logits.append(lg[0])
            tok = torch.argmax(lg[0])
            chosen.append(tok)
    return torch.stack(chosen).tolist(), logits


def top2_margin(logits) -> float:
    """The largest logit less the second largest."""
    top = torch.topk(logits.float(), 2).values
    return float(top[0] - top[1])


def seeded_all_reduce(run, elems: int):
    """``run`` whose step first all-reduces ``elems`` f32 zeros over the
    data group of its mesh: a collective the comm plan does not hold, which
    ``repro_torch.analysis.collectives.audit_step_collectives`` must flag
    (W101, or W102 when ``elems`` is a private run's length)."""
    import torch.distributed as dist

    def bad_step(state, batch):
        dist.all_reduce(torch.zeros(elems, device=run.device),
                        group=run.shard.data_group)
        return run.step(state, batch)

    bad_step.__dict__.update(run.step.__dict__)
    return run._replace(step=bad_step)
