"""The port's CUDA kernels against their plain PyTorch versions, on the card.

This file imports nothing of JAX, so it also runs where only the port is
installed: ``PYTHONPATH=src python -m pytest --noconftest -q -m cuda
tests/test_torch_cuda.py``.  Without a CUDA device every test skips."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.storm import kernel as tk
from repro_torch.kernels.storm import quantpack as tqp
from repro_torch.kernels.storm import ref as tref
from repro_torch.testing import halfway_tiles
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
    assert (tk.LAUNCHES["storm3_step"], tk.LAUNCHES["storm3_update"]) == (1, 1)
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


@pytest.mark.cuda
@pytest.mark.parametrize("p_dtype", ["float32", "bfloat16"])
def test_cuda_sgd_kernels_bitwise_vs_plain(p_dtype, card):
    """``sgd3_step`` and ``momsgd3_step`` equal their plain versions bit for
    bit on the card, including a length that takes the scalar tail."""
    tp, tm, tg, _, tl, tb = _inputs(5, getattr(torch, p_dtype), card)
    tk.reset_counts()
    sgd = tk.sgd3_step(tp, tg, tl, block=BLOCK)
    mom = tk.momsgd3_step(tp, tm, tg, tl, tb, block=BLOCK)
    torch.cuda.synchronize()
    assert (tk.LAUNCHES["sgd3_step"], tk.LAUNCHES["momsgd3_step"]) == (1, 1)
    _assert_bits((sgd,), (tref.sgd3_step_ref(tp, tg, tl, BLOCK),))
    _assert_bits(mom, tref.momsgd3_step_ref(tp, tm, tg, tl, tb, BLOCK))
    odd = 2 * 6 + 1          # 3 tiles of 13: the vector path is not taken
    p, m, g = (t[:3 * odd] for t in (tp, tm, tg))
    _assert_bits((tk.sgd3_step(p, g, tl[:3], block=odd),),
                 (tref.sgd3_step_ref(p, g, tl[:3], odd),))
    _assert_bits(tk.momsgd3_step(p, m, g, tl[:3], tb[:3], block=odd),
                 tref.momsgd3_step_ref(p, m, g, tl[:3], tb[:3], odd))
    # a start one element in: unaligned, so the scalar loop runs although
    # block % 4 == 0
    p, m, g = (t[1:1 + 3 * 12] for t in (tp, tm, tg))
    _assert_bits(tk.momsgd3_step(p, m, g, tl[:3], tb[:3], block=12),
                 tref.momsgd3_step_ref(p, m, g, tl[:3], tb[:3], 12))


@pytest.mark.cuda
def test_cuda_sgd_wrappers_raise_instead_of_falling_back(card):
    tp, tm, tg, _, tl, tb = _inputs(6, torch.float32, card)
    with pytest.raises(TypeError, match="float32"):
        tk.sgd3_step(tp, tg.double(), tl, block=BLOCK)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tk.momsgd3_step(tp.half(), tm, tg, tl, tb, block=BLOCK)
    with pytest.raises(ValueError, match="several devices"):
        tk.momsgd3_step(tp, tm, tg, tl, tb.cpu(), block=BLOCK)
    with pytest.raises(ValueError, match="several devices"):
        tk.sgd3_step(tp.cpu(), tg, tl, block=BLOCK)


def _quant_buffer(seed: int, block: int, tiles: int) -> torch.Tensor:
    """Lognormal tiles, half-way tiles and an all-zero tile last."""
    rng = np.random.default_rng(seed)
    logn = (rng.lognormal(0.0, 2.0, tiles * block)
            * rng.choice([-1.0, 1.0], tiles * block)).astype(np.float32)
    return torch.from_numpy(np.concatenate(
        [logn, halfway_tiles(rng, 2, block), np.zeros(block, np.float32)]))


def _assert_quant_roundtrip(x, block: int):
    """Pack and unpack on the card against the plain versions, bit for bit;
    the unpack also against the one library call that computes it."""
    q, s = tqp.quantpack_flat(x, block=block)
    want_q, want_s = tref.quantpack_ref(x, block)
    _assert_bits((q, s), (want_q, want_s))
    out = tqp.quantunpack_flat(q, s, block=block)
    _assert_bits((out,), (tref.quantunpack_ref(q, s, block),))
    _assert_bits((out,), (torch.mul(q.view(-1, block), s.view(-1, 1))
                          .reshape(-1),))
    return q, s


@pytest.mark.cuda
@pytest.mark.parametrize("block", [1024, 64 * 1024])
def test_cuda_quant_kernels_bitwise_vs_plain(block, card):
    """``quantpack``/``quantunpack`` equal their plain versions bit for bit
    on the card: lognormal tiles, values one ulp either side of the
    rounding half-way points, and a zero tile (scale 0, q 0)."""
    x = _quant_buffer(7, block, 3).to(card)
    tqp.reset_counts()
    q, s = _assert_quant_roundtrip(x, block)
    torch.cuda.synchronize()
    assert tqp.LAUNCHES == {"quantpack": 1, "quantunpack": 1}
    assert float(s[-1]) == 0.0 and not torch.any(q[-block:])
    # one tile alone
    _assert_quant_roundtrip(x[:block].clone(), block)


@pytest.mark.cuda
def test_cuda_quant_kernels_scalar_paths(card):
    """Lengths and starts that bar the vector paths: a tile of 13 and a
    buffer that starts one element in."""
    x = _quant_buffer(8, 1024, 1).to(card)
    _assert_quant_roundtrip(x[:3 * 13].clone(), 13)
    _assert_quant_roundtrip(x[1:1 + 2 * 1024], 1024)


@pytest.mark.cuda
def test_cuda_quant_wrappers_raise_instead_of_falling_back(card):
    x = _quant_buffer(9, 1024, 1).to(card)
    q, s = tqp.quantpack_flat(x, block=1024)
    with pytest.raises(TypeError, match="int8"):
        tqp.quantunpack_flat(s, s, block=1024)
    with pytest.raises(TypeError, match="int8"):
        tqp.quantunpack_flat(q, q, block=1024)
    with pytest.raises(TypeError, match="float32"):
        tqp.quantpack_flat(q, block=1024)
    with pytest.raises(ValueError, match="contiguous"):
        tqp.quantpack_flat(x.reshape(-1, 2)[:, 0], block=1024)
    with pytest.raises(ValueError, match="multiple of block"):
        tqp.quantpack_flat(x[:-1], block=1024)
    with pytest.raises(ValueError, match="several devices"):
        tqp.quantunpack_flat(q, s.cpu(), block=1024)
