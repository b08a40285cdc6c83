"""The port's CUDA kernels against their plain PyTorch versions, on the card.

This file imports nothing of JAX, so it also runs where only the port is
installed: ``PYTHONPATH=src python -m pytest --noconftest -q -m cuda
tests/test_torch_cuda.py``.  Without a CUDA device every test skips."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.storm import kernel as tk
from repro_torch.kernels.storm import ref as tref
from torch_parity import bits

torch.set_num_threads(1)

M, TILES, BLOCK = 2, 3, 256


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda")


def _inputs(seed: int, p_dtype, device):
    g = torch.Generator().manual_seed(seed)
    n = M * TILES * BLOCK
    p, m, gn, go = (torch.randn(n, generator=g) for _ in range(4))
    lrs = torch.rand(M * TILES, generator=g) * 0.2
    decays = 0.5 + 0.5 * torch.rand(M * TILES, generator=g)
    return tuple(t.to(device) for t in (p.to(p_dtype), m, gn, go, lrs, decays))


def _assert_bits(outs, refs):
    for t, r in zip(outs, refs):
        np.testing.assert_array_equal(bits(t), bits(r))


@pytest.mark.cuda
@pytest.mark.parametrize("p_dtype", ["float32", "bfloat16"])
def test_cuda_kernels_bitwise_vs_plain(p_dtype, card):
    """The CUDA kernels equal their plain versions bit for bit on the card,
    including a length that is not a multiple of 4 (the scalar tail)."""
    tp, tm, tgn, tgo, tl, td = _inputs(3, getattr(torch, p_dtype), card)
    tk.reset_counts()
    step = tk.storm3_step(tp, tm, tgo, tl, td, block=BLOCK)
    upd = tk.storm3_update(tp, tm, tgn, tgo, tl, td, block=BLOCK)
    torch.cuda.synchronize()
    assert tk.LAUNCHES == {"storm3_step": 1, "storm3_update": 1}
    _assert_bits(step, tref.storm3_step_ref(tp, tm, tgo, tl, td, BLOCK))
    _assert_bits(upd, tref.storm3_update_ref(tp, tm, tgn, tgo, tl, td, BLOCK))
    odd = 2 * 6 + 1          # 3 tiles of 13: the vector path is not taken
    sl = [t[:3 * odd] for t in (tp, tm, tgn, tgo)]
    out = tk.storm3_update(*sl, tl[:3], td[:3], block=odd)
    _assert_bits(out, tref.storm3_update_ref(*sl, tl[:3], td[:3], odd))


@pytest.mark.cuda
def test_cuda_wrapper_raises_instead_of_falling_back(card):
    tp, tm, _, tgo, tl, td = _inputs(4, torch.float32, card)
    with pytest.raises(TypeError, match="float32"):
        tk.storm3_step(tp, tm.double(), tgo, tl, td, block=BLOCK)
    with pytest.raises(ValueError, match="several devices"):
        tk.storm3_step(tp, tm, tgo.cpu(), tl, td, block=BLOCK)
