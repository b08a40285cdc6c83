"""The arithmetic of the bf16 tensor-core flash kernel (``flash_fwd_tc`` in
``src/repro_torch/kernels/csrc/flash_attn.cu``), written out in plain
PyTorch on the CPU, against the JAX package's dense attention
(``repro.kernels.flash.ref``), and the bf16 ulp limit that holds the kernel
to its plain version on the card (``repro_torch.testing.bf16_ulps``).

The kernel splits each f32 probability into three bf16 terms,
p = p0 + p1 + p2, and adds p·v as three bf16 products with f32
accumulation: it claims the reference's f32 p·v, not SDPA's bf16 one.
Checked here: the split is exact, bit for bit, over the probabilities'
range; the written-out kernel (64-key tiles, the online softmax, the split)
lies within ``BF16_ULPS`` of the reference; with p0 alone, or with a key
tile skipped, it lies far outside that limit and yet within the absolute
2e-2 of the reference's kernel tests, which is why the card holds the
kernel in ulps as well.  Inputs are drawn by numpy from a seed."""
import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels.flash.ref import flash_attention_ref as jflash_ref  # noqa: E402
from repro_torch.kernels.flash.ref import NEG_INF, band_mask  # noqa: E402
from repro_torch.testing import (BF16_ULPS, bf16_ulps,  # noqa: E402
                                 flash_attention_fault)

torch.set_num_threads(1)

# (S, H, Hkv, D, causal, window, softcap): the card tests' shapes, GQA and
# MQA, ragged S, windows and soft caps
CASES = [
    (100, 8, 2, 64, True, 0, 0.0),
    (100, 16, 1, 256, False, 64, 50.0),
    (1000, 8, 2, 128, True, 64, 0.0),
    (1000, 16, 1, 64, False, 0, 50.0),
    (77, 2, 2, 256, False, 20, 0.0),
    (130, 2, 1, 16, True, 32, 0.0),
    # hubert-xlarge's head dim 80, not causal, S ragged against the tiles
    (200, 4, 4, 80, False, 0, 0.0),
]


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def _split(p):
    p0 = _bf16(p)
    p1 = _bf16(p - p0)
    return p0, p1, _bf16(p - p0 - p1)


def _kernel_arithmetic(q, k, v, *, causal, window, softcap, terms=3):
    """flash_fwd_tc's function step by step: per 64-key tile the f32
    scores of the bf16 q and k, the -1e30 mask, m' = max(m, rowmax),
    p = exp(s - m'), alpha = exp(m - m'), l' = l alpha + rowsum(p) over the
    f32 p, acc' = acc alpha + p0 v + p1 v + p2 v (the first ``terms`` of
    the split), and acc / max(l, 1e-30) rounded to bf16."""
    B, S, H, D = q.shape
    hkv = k.shape[2]
    qg = q.float().reshape(B, S, hkv, H // hkv, D)
    ok = band_mask(S, causal=causal, window=window)
    m = torch.full((B, hkv, H // hkv, S, 1), NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros(B, hkv, H // hkv, S, D)
    for t in range(0, S, 64):
        s = torch.einsum("bqgrd,bkgd->bgrqk", qg,
                         k[:, t:t + 64].float()) / math.sqrt(D)
        if softcap:
            s = torch.tanh(s / softcap) * softcap
        s = torch.where(ok[:, t:t + 64], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha
        for pi in _split(p)[:terms]:
            acc = acc + torch.einsum("bgrqk,bkgd->bgrqd", pi,
                                     v[:, t:t + 64].float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, D).bfloat16()


def _inputs(case, seed):
    S, H, hkv, D = case[:4]
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, S, h, D))
                                .astype(np.float32)).bfloat16()
               for h in (H, hkv, hkv))
    kw = dict(causal=case[4], window=case[5], softcap=case[6])
    return q, k, v, kw


def _reference(q, k, v, kw):
    """The JAX package's dense attention on [B*H, S, D], each query head
    beside its kv head, back in [B, S, H, D]."""
    B, S, H, D = q.shape
    rep = H // k.shape[2]

    def heads(x):
        x = x.repeat_interleave(rep, dim=2) if x.shape[2] != H else x
        return jnp.asarray(x.float().permute(0, 2, 1, 3)
                           .reshape(B * H, S, D).numpy()).astype(jnp.bfloat16)

    out = jflash_ref(heads(q), heads(k), heads(v), **kw)
    out = np.array(out.astype(jnp.float32)).reshape(B, H, S, D)
    return torch.from_numpy(out).permute(0, 2, 1, 3).bfloat16()


def test_split_of_p_is_exact():
    """p0 + p1 + p2 == p bit for bit, each term a bf16 value, for every
    probability exp(-x) with x in [0, 70] (down to 4e-31, where p2 still
    lies above f32's smallest normal)."""
    rng = np.random.default_rng(0)
    x = np.concatenate([np.linspace(0.0, 70.0, 100_001),
                        rng.uniform(0.0, 70.0, 100_000)]).astype(np.float32)
    p = torch.exp(-torch.from_numpy(x))
    p0, p1, p2 = _split(p)
    assert torch.equal((p0 + p1) + p2, p)
    for t in (p0, p1, p2):
        assert torch.equal(_bf16(t), t)


@pytest.mark.parametrize("want", [1.0, 0.5, 3.0, -2.0, 1e-3, 7e4])
def test_bf16_ulps_counts_bf16_steps(want):
    """One step to the next bf16 value away from zero reads one ulp, two
    read two, and a value equal to ``want`` reads zero; the floor only
    lowers a reading."""
    w = torch.tensor([want]).bfloat16()
    bits = w.view(torch.int16)
    one, two = ((bits + n).view(torch.bfloat16) for n in (1, 2))
    assert bf16_ulps(w, w) == 0.0
    assert bf16_ulps(one, w, floor=0.0) == 1.0
    assert bf16_ulps(two, w, floor=0.0) == 2.0
    assert bf16_ulps(one, w) <= 1.0


def test_bf16_ulps_floor_at_zero():
    """At zero the reading is the difference over the floor."""
    assert bf16_ulps(torch.tensor([3e-6]), torch.tensor([0.0])) == \
        pytest.approx(3.0)


@pytest.mark.parametrize("case", CASES)
def test_kernel_arithmetic_within_ulps_of_reference(case):
    """The exact split computes the reference's f32 p·v: the written-out
    kernel lies within ``BF16_ULPS`` of the JAX package's dense attention
    (two bf16 roundings of f32 values that agree to f32 rounding)."""
    q, k, v, kw = _inputs(case, sum(case[:4]))
    want = _reference(q, k, v, kw)
    assert bf16_ulps(_kernel_arithmetic(q, k, v, **kw), want) <= BF16_ULPS


@pytest.mark.parametrize("case", CASES)
def test_faults_break_ulps_within_abs_limit(case):
    """The kernel with p0 alone (p rounded to bf16, as SDPA multiplies) lies
    within the absolute 2e-2 of the reference yet far outside
    ``BF16_ULPS``; so do the plain versions of the faults that the card
    holds beside the kernel (``flash_attention_fault``: p0 alone, a key
    tile skipped), the last also outside 2e-2."""
    q, k, v, kw = _inputs(case, sum(case[:4]))
    want = _reference(q, k, v, kw)
    p0 = _kernel_arithmetic(q, k, v, terms=1, **kw)
    assert float((p0.float() - want.float()).abs().max()) <= 2e-2
    assert bf16_ulps(p0, want) > 10 * BF16_ULPS
    for fault in ("p0", "tile"):
        got = flash_attention_fault(q, k, v, fault, **kw)
        assert bf16_ulps(got, want) > 10 * BF16_ULPS, fault
    assert float((got.float() - want.float()).abs().max()) > 2e-2
