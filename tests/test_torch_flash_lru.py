"""The port's flash-attention and RG-LRU scan wrappers on the CPU (their
plain versions) against the JAX package's Pallas kernels run in interpret
mode, on the reference's own test cases (``tests/test_kernels.py``:
``FLASH_CASES``, ``LRU_SHAPES``), with inputs drawn by numpy.

Tolerances are the reference's own kernel tests': attention f32 2e-5,
bf16 2e-2 (atol and rtol); the scan atol 2e-6, rtol 2e-5 (the kernel and the
reference compose the recurrence in other orders).  The port's plain scan
is also held bit for bit to a numpy float32 loop of one product and one sum
per step, the arithmetic of the CUDA kernel.

Also pinned here: the reference's padded flash path is wrong for
non-causal inputs whose length is not a multiple of its tile (ROADMAP
queue 3), and the reference cannot differentiate through either Pallas
kernel (why training specs that turn them on stay refused)."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels.flash.ops import flash_attention as jflash  # noqa: E402
from repro.kernels.flash.ref import flash_attention_ref as jflash_ref  # noqa: E402
from repro.kernels.lru.ops import lru_scan as jlru  # noqa: E402
from repro_torch.kernels.flash import ops as flash_ops  # noqa: E402
from repro_torch.kernels.lru import ops as lru_ops  # noqa: E402
from torch_parity import f32  # noqa: E402

torch.set_num_threads(1)

# the reference's cases: (B, S, H, D, causal, window, softcap) and [B, S, C]
FLASH_CASES = [
    (2, 256, 4, 64, True, 0, 0.0),
    (1, 256, 2, 32, True, 64, 0.0),
    (2, 128, 2, 64, False, 0, 0.0),
    (1, 384, 2, 64, True, 128, 50.0),
    (1, 130, 1, 16, True, 32, 0.0),      # padding path
]
LRU_SHAPES = [(2, 256, 64), (1, 100, 33), (3, 128, 512), (1, 8, 1)]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _lru_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.7, 0.999, shape).astype(np.float32)
    b = (0.1 * rng.standard_normal(shape)).astype(np.float32)
    h0 = rng.standard_normal((shape[0], shape[2])).astype(np.float32)
    return a, b, h0


@pytest.mark.parametrize("shape", LRU_SHAPES)
@pytest.mark.parametrize("with_h0", [True, False])
def test_lru_scan_matches_reference_kernel(shape, with_h0):
    a, b, h0 = _lru_inputs(shape, sum(shape))
    h0 = h0 if with_h0 else None
    want = np.asarray(jlru(jnp.asarray(a), jnp.asarray(b),
                           None if h0 is None else jnp.asarray(h0)))
    lru_ops.reset_counts()
    got = lru_ops.lru_scan(torch.from_numpy(a), torch.from_numpy(b),
                           None if h0 is None else torch.from_numpy(h0))
    assert lru_ops.CALLS["lru_scan"] == 1 and lru_ops.LAUNCHES["lru_scan"] == 0
    np.testing.assert_allclose(f32(got), want, atol=2e-6, rtol=2e-5)
    # the plain version is the kernel's arithmetic: a mul and an add a step
    h = np.zeros(shape[::2], np.float32) if h0 is None else h0.copy()
    loop = np.empty_like(a)
    for t in range(shape[1]):
        h = a[:, t] * h + b[:, t]
        loop[:, t] = h
    np.testing.assert_array_equal(f32(got).view(np.uint32), loop.view(np.uint32))


def _flash_inputs(B, S, H, D, hkv, dtype, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, hkv, D)).astype(np.float32)
            for _ in range(2))
    tq, tk, tv = (torch.from_numpy(x).to(getattr(torch, dtype))
                  for x in (q, k, v))
    # the reference sees the same (rounded) values, kv repeated to H heads
    jq, jk, jv = (jnp.asarray(f32(x), getattr(jnp, dtype))
                  for x in (tq, tk, tv))
    rep = H // hkv
    return (tq, tk, tv), (jq, jnp.repeat(jk, rep, axis=2),
                          jnp.repeat(jv, rep, axis=2))


@pytest.mark.parametrize("case", FLASH_CASES + [
    # GQA: fewer kv heads than query heads (the kernel maps them by index)
    (2, 96, 4, 32, True, 40, 0.0, 2),
    (1, 70, 8, 16, True, 0, 30.0, 1),
    (1, 64, 4, 64, False, 0, 0.0, 2),
    # head dim 80 (hubert-xlarge), not causal; S a multiple of the
    # reference's tile, whose padded path masks at the padded length (the
    # ragged S is held to the dense oracle in test_torch_flash_tc.py)
    (1, 256, 4, 80, False, 0, 0.0, 4),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_reference_kernel(case, dtype):
    B, S, H, D, causal, window, cap = case[:7]
    hkv = case[7] if len(case) > 7 else H
    (tq, tk, tv), (jq, jk, jv) = _flash_inputs(B, S, H, D, hkv, dtype,
                                               S + H + D)
    want = jflash(jq, jk, jv, causal=causal, window=window, softcap=cap)
    flash_ops.reset_counts()
    got = flash_ops.flash_attention(tq, tk, tv, causal=causal, window=window,
                                    softcap=cap)
    assert flash_ops.CALLS["flash_attention"] == 1
    assert flash_ops.LAUNCHES["flash_attention"] == 0
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(f32(got), f32(want), atol=TOL[dtype],
                               rtol=TOL[dtype])


def test_reference_flash_padding_fault_is_not_copied():
    """At S = 130, non-causal, the reference pads k/v to its 128-row tile
    and then masks with the padded length (``flash/ops.py:23-34``,
    ``kernel.py:64``): the zero keys take part in the softmax, and its
    kernel differs from its own dense oracle.  The port masks at the true
    length and matches the oracle."""
    B, S, H, D = 1, 130, 1, 16
    (tq, tk, tv), (jq, jk, jv) = _flash_inputs(B, S, H, D, H, "float32", 7)
    kernel = np.asarray(jflash(jq, jk, jv, causal=False))

    def to_bh(x):
        return jnp.transpose(x, (0, 2, 1, 3)).reshape(B * H, S, D)

    oracle = np.asarray(jflash_ref(to_bh(jq), to_bh(jk), to_bh(jv),
                                   causal=False))
    oracle = oracle.reshape(B, H, S, D).transpose(0, 2, 1, 3)
    assert np.abs(kernel - oracle).max() > 0.05
    got = flash_ops.flash_attention(tq, tk, tv, causal=False)
    np.testing.assert_allclose(f32(got), oracle, atol=2e-5, rtol=2e-5)
    # causal, the same length: the padded keys are masked by causality
    causal = np.asarray(jflash(jq, jk, jv, causal=True))
    np.testing.assert_allclose(
        f32(flash_ops.flash_attention(tq, tk, tv, causal=True)), causal,
        atol=2e-5, rtol=2e-5)


def test_reference_cannot_differentiate_through_its_kernels():
    """``pallas_call`` has no reverse-mode rule and neither kernel has a
    ``custom_vjp``: ``jax.grad`` fails, so the reference's train step with
    ``use_flash`` / ``use_lru_kernel`` cannot run."""
    a = jnp.full((1, 8, 4), 0.9)
    with pytest.raises(AssertionError):
        jax.grad(lambda b: jlru(a, b).sum())(jnp.ones((1, 8, 4)))
    with pytest.raises(AssertionError):
        jax.grad(lambda q: jflash(q, q, q).sum())(jnp.ones((1, 16, 1, 16)))


def test_wrappers_check_their_inputs():
    x = torch.zeros(1, 4, 2, 16)
    with pytest.raises(TypeError, match="float32"):
        lru_ops.lru_scan(torch.zeros(1, 4, 2, dtype=torch.float64),
                         torch.zeros(1, 4, 2, dtype=torch.float64))
    with pytest.raises(ValueError, match="h0"):
        lru_ops.lru_scan(torch.zeros(1, 4, 2), torch.zeros(1, 4, 2),
                         torch.zeros(1, 3))
    with pytest.raises(TypeError, match="bfloat16"):
        flash_ops.flash_attention(x, x.to(torch.bfloat16), x)
    with pytest.raises(ValueError, match="multiple of Hkv"):
        flash_ops.flash_attention(torch.zeros(1, 4, 3, 16), x, x)
    # no plain fallback for a device other than the CPU
    meta = torch.zeros(1, 4, 2, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        lru_ops.lru_scan(meta, meta)
    with pytest.raises(ValueError, match="no kernel for device"):
        flash_ops.flash_attention(x.to("meta"), x.to("meta"), x.to("meta"))
