"""The port's STORM kernels against the JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions, over two
clients' client-major buffers with a small tile, for f32 and bf16 variables:

* bit for bit against the JAX ``ref.py`` functions run op by op;
* against ``storm3_step_flat`` / ``storm3_update_flat`` run in interpret
  mode (as tests/test_kernels.py runs them), within one rounding of the
  product plus one ulp of the result: under ``jit`` XLA's CPU backend
  contracts ``p − lr·m`` (and ``g_new + decay·(m − g_old)``) into one fused
  multiply-add, which rounds once where the reference's op-by-op arithmetic
  and the port round twice.  (One ulp of the result alone is not a bound:
  where ``p ≈ lr·m`` cancels, the product's rounding is many ulps of the
  small result.)  The partial momentum ``decay·(m − g_old)`` has nothing to
  contract and is held bit for bit.

The CUDA kernels are held against the plain versions on the card in
tests/test_torch_cuda.py."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels.storm import kernel as jk  # noqa: E402
from repro.kernels.storm import ref as jref  # noqa: E402
from repro_torch.kernels.storm import kernel as tk  # noqa: E402
from repro_torch.kernels.storm import ref as tref  # noqa: E402
from torch_parity import assert_contraction_close, bits  # noqa: E402

torch.set_num_threads(1)

M, TILES, BLOCK = 2, 3, 256          # two clients' [M·N] buffers, 6 tiles


def _inputs(seed: int, p_dtype: str):
    rng = np.random.default_rng(seed)
    n = M * TILES * BLOCK
    p, m, gn, go = (rng.standard_normal(n).astype(np.float32) for _ in range(4))
    lrs = rng.uniform(0.0, 0.2, M * TILES).astype(np.float32)
    decays = rng.uniform(0.5, 1.0, M * TILES).astype(np.float32)
    jp = jnp.asarray(p).astype(p_dtype)
    tp = torch.from_numpy(p).to(getattr(torch, p_dtype))
    jax_in = (jp, *(jnp.asarray(a) for a in (m, gn, go, lrs, decays)))
    torch_in = (tp, *(torch.from_numpy(a) for a in (m, gn, go, lrs, decays)))
    return jax_in, torch_in


def _assert_bits(torch_outs, jax_outs):
    for t, j in zip(torch_outs, jax_outs):
        np.testing.assert_array_equal(bits(t), bits(j))


@pytest.mark.parametrize("p_dtype", ["float32", "bfloat16"])
def test_storm3_step_vs_ref_and_pallas(p_dtype):
    (jp, jm, _, jgo, jl, jd), (tp, tm, _, tgo, tl, td) = _inputs(0, p_dtype)
    out = tk.storm3_step(tp, tm, tgo, tl, td, block=BLOCK)
    assert out[0].dtype == tp.dtype and out[1].dtype == torch.float32
    _assert_bits(out, jref.storm3_step_ref(jp, jm, jgo, jl, jd, BLOCK))
    _assert_bits(out, tref.storm3_step_ref(tp, tm, tgo, tl, td, BLOCK))
    pallas = jk.storm3_step_flat(jp, jm, jgo, jl, jd, block=BLOCK,
                                 interpret=True)
    lr = torch.repeat_interleave(tl, BLOCK)
    assert_contraction_close(out[0], pallas[0], lr * tm)
    np.testing.assert_array_equal(bits(out[1]), bits(pallas[1]))


@pytest.mark.parametrize("p_dtype", ["float32", "bfloat16"])
def test_storm3_update_vs_ref_and_pallas(p_dtype):
    (jp, jm, jgn, jgo, jl, jd), (tp, tm, tgn, tgo, tl, td) = _inputs(1, p_dtype)
    out = tk.storm3_update(tp, tm, tgn, tgo, tl, td, block=BLOCK)
    _assert_bits(out, jref.storm3_update_ref(jp, jm, jgn, jgo, jl, jd, BLOCK))
    _assert_bits(out, tref.storm3_update_ref(tp, tm, tgn, tgo, tl, td, BLOCK))
    pallas = jk.storm3_update_flat(jp, jm, jgn, jgo, jl, jd, block=BLOCK,
                                   interpret=True)
    lr, dc = (torch.repeat_interleave(t, BLOCK) for t in (tl, td))
    assert_contraction_close(out[0], pallas[0], lr * tm)
    assert_contraction_close(out[1], pallas[1], dc * (tm - tgo))


def test_wrappers_count_calls_and_reject_bad_shapes():
    _, (tp, tm, tgn, tgo, tl, td) = _inputs(2, "float32")
    tk.reset_counts()
    tk.storm3_step(tp, tm, tgo, tl, td, block=BLOCK)
    tk.storm3_update(tp, tm, tgn, tgo, tl, td, block=BLOCK)
    # CPU tensors take the plain versions: calls count, launches do not
    assert (tk.CALLS["storm3_step"], tk.CALLS["storm3_update"]) == (1, 1)
    assert (tk.LAUNCHES["storm3_step"], tk.LAUNCHES["storm3_update"]) == (0, 0)
    with pytest.raises(ValueError, match="multiple of block"):
        tk.storm3_step(tp[:-1], tm[:-1], tgo[:-1], tl, td, block=BLOCK)
    with pytest.raises(ValueError, match="tables need"):
        tk.storm3_step(tp, tm, tgo, tl[:-1], td[:-1], block=BLOCK)
