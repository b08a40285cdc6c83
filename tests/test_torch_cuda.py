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
from repro_torch.testing import (BF16_ULPS, bf16_ulps, flash_attention_fault,
                                 halfway_tiles)
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
@pytest.mark.parametrize("p_dtype,m_dtype", [("float32", "float32"),
                                             ("bfloat16", "float32"),
                                             ("float32", "bfloat16"),
                                             ("bfloat16", "bfloat16")])
def test_cuda_storm_update_bitwise_vs_plain(p_dtype, m_dtype, card):
    """``storm_update`` equals its plain version bit for bit for the four
    dtype pairs at a ragged length, also from a start that breaks 16-byte
    alignment (the scalar path); the pytree entry point launches once per
    dtype group."""
    from repro_torch.kernels.storm import storm_update
    g = torch.Generator(device=card).manual_seed(12)
    n = 70001
    p = torch.randn(n, generator=g, device=card).to(getattr(torch, p_dtype))
    m, gn, go = (torch.randn(n, generator=g, device=card)
                 .to(getattr(torch, m_dtype)) for _ in range(3))
    tk.reset_counts()
    for sl in (slice(None), slice(1, None)):
        args = (p[sl], m[sl], gn[sl], go[sl])
        _assert_bits(tk.storm_update_flat(*args, 0.05, 0.9),
                     tref.storm_update_ref(*args, 0.05, 0.9))
    tree = {"a": p[:1000].view(10, 100), "b": p[1000:1007]}
    mom = {"a": m[:1000].view(10, 100), "b": m[1000:1007]}
    grads = {"a": gn[:1000].float().view(10, 100), "b": gn[1000:1007].float()}
    pn, mn = storm_update(tree, mom, grads, grads, 0.05, 0.9)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["storm_update"] == 3
    for k in tree:
        _assert_bits((pn[k], mn[k]), tref.storm_update_ref(
            tree[k], mom[k], grads[k].to(m.dtype), grads[k].to(m.dtype),
            0.05, 0.9))


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
@pytest.mark.parametrize("block", [1024, 64 * 1024, 3 * 16384, 128 * 1024,
                                   256 * 1024])
def test_cuda_quant_kernels_bitwise_vs_plain(block, card):
    """``quantpack``/``quantunpack`` equal their plain versions bit for bit
    on the card: lognormal tiles, values one ulp either side of the
    rounding half-way points, and a zero tile (scale 0, q 0).  The blocks
    take the cluster kernel with clusters of 1 and 8 (the path's tile; and
    parts of 6,144), and the two-pass kernel (tiles of 512 KB and 1 MB)."""
    x = _quant_buffer(7, block, 3).to(card)
    tqp.reset_counts()
    q, s = _assert_quant_roundtrip(x, block)
    torch.cuda.synchronize()
    assert tqp.LAUNCHES == {"quantpack": 1, "quantunpack": 1}
    variant = "quantpack_cluster" if tqp.cluster_size(block) \
        else "quantpack_tiles"
    assert tqp.VARIANTS[variant] == 1
    assert float(s[-1]) == 0.0 and not torch.any(q[-block:])
    # one tile alone
    _assert_quant_roundtrip(x[:block].clone(), block)


@pytest.mark.cuda
@pytest.mark.parametrize("block,start", [(1024, 0), (64 * 1024, 0),
                                         (128 * 1024, 0), (256 * 1024, 0),
                                         (1024, 1), (13, 0)])
def test_cuda_quant_kernels_non_finite_tiles(block, start, card):
    """Tiles holding a NaN, +Inf and -Inf and a clean tile, through each
    pack kernel (a start one element in is unaligned: the two-pass kernel):
    q and scales bit for bit the plain version's (scales NaN, Inf, Inf,
    finite; q 0 at the non-finite elements), and every value of the three
    bad tiles unpacks to NaN, as the reference's do."""
    g = torch.Generator(device=card).manual_seed(14)
    buf = torch.randn(start + 4 * block, generator=g, device=card)
    x = buf[start:]
    bad = torch.tensor([3, block + 5, 2 * block + 7], device=card)
    x[bad] = torch.tensor([float("nan"), float("inf"), float("-inf")],
                          device=card)
    tqp.reset_counts()
    q, s = tqp.quantpack_flat(x, block=block)
    _assert_bits((q, s), tref.quantpack_ref(x, block))
    assert tqp.VARIANTS["quantpack_cluster" if start == 0 and
                        tqp.cluster_size(block) else "quantpack_tiles"] == 1
    assert torch.isnan(s[0]) and bool((s[1:3] == float("inf")).all())
    assert bool(torch.isfinite(s[3])) and not torch.any(q[bad])
    out = tqp.quantunpack_flat(q, s, block=block)
    _assert_bits((out,), (tref.quantunpack_ref(q, s, block),))
    assert bool(torch.isnan(out[:3 * block]).all())
    assert bool(torch.isfinite(out[3 * block:]).all())


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


@pytest.mark.cuda
def test_cuda_lru_scan_bitwise_vs_plain(card):
    """Both RG-LRU scan kernels equal the sequential plain version bit for
    bit, with and without h0: the TMA kernel at S not a multiple of its
    64-step tile and C not a multiple of its 64-channel block, B from 1 to
    3, and the serving shape [2, 4096, 4096]; the lanes kernel where C % 4
    != 0 (and a length shorter than its unrolled chunk)."""
    from repro_torch.kernels.lru import ops as lru_ops
    from repro_torch.kernels.lru.ref import lru_scan_ref
    g = torch.Generator(device=card).manual_seed(10)
    lru_ops.reset_counts()
    shapes = {"lru_scan_tma": [(1, 1000, 100), (2, 64, 64), (3, 129, 132),
                               (2, 4096, 4096)],
              "lru_scan_lanes": [(3, 1001, 77), (1, 5, 1)]}
    for variant, cases in shapes.items():
        for B, S, C in cases:
            assert lru_ops.scan_variant(B, S, C, 0, 0) == variant
            a = 0.7 + 0.299 * torch.rand(B, S, C, generator=g, device=card)
            b = 0.1 * torch.randn(B, S, C, generator=g, device=card)
            h0 = torch.randn(B, C, generator=g, device=card)
            for h in (h0, None):
                _assert_bits((lru_ops.lru_scan(a, b, h),),
                             (lru_scan_ref(a, b, h),))
    torch.cuda.synchronize()
    assert lru_ops.VARIANTS == {k: 2 * len(v) for k, v in shapes.items()}
    assert lru_ops.LAUNCHES["lru_scan"] == 12
    wide = torch.zeros(2, 8, 6, device=card)
    with pytest.raises(ValueError, match="contiguous"):
        lru_ops.lru_scan(wide[:, :, ::2], wide[:, :, ::2])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 2e-2)])
def test_cuda_flash_attention_vs_plain(dtype, tol, card):
    """The flash-attention kernel against its dense plain version within the
    reference's kernel-test tolerance (in bf16 also within ``BF16_ULPS``
    bf16 ulps, see ``repro_torch.testing``): ragged lengths, GQA, windows,
    soft caps, causal and not, each head dim the kernel is built for."""
    from repro_torch.kernels.flash import ops as flash_ops
    from repro_torch.kernels.flash.ref import flash_attention_ref
    g = torch.Generator(device=card).manual_seed(11)
    cases = [(2, 100, 4, 64, 1, True, 64, 0.0),
             (1, 130, 2, 16, 1, True, 32, 0.0),
             (1, 200, 4, 32, 2, False, 0, 30.0),
             (2, 257, 8, 128, 2, True, 0, 50.0),
             (1, 77, 2, 256, 2, False, 20, 0.0),
             (2, 100, 4, 80, 2, True, 0, 0.0),
             (1, 1000, 4, 80, 4, False, 0, 0.0)]
    flash_ops.reset_counts()
    for B, S, H, D, hkv, causal, window, cap in cases:
        q = torch.randn(B, S, H, D, generator=g, device=card).to(getattr(torch, dtype))
        k, v = (torch.randn(B, S, hkv, D, generator=g, device=card)
                .to(q.dtype) for _ in range(2))
        kw = dict(causal=causal, window=window, softcap=cap)
        got = flash_ops.flash_attention(q, k, v, **kw)
        want = flash_attention_ref(q, k, v, **kw)
        assert got.dtype == q.dtype
        err = float((got.float() - want.float()).abs().max())
        assert err <= tol, ((B, S, H, D, hkv), err)
        if q.dtype == torch.bfloat16:
            assert bf16_ulps(got, want) <= BF16_ULPS, (B, S, H, D, hkv)
    torch.cuda.synchronize()
    assert flash_ops.LAUNCHES["flash_attention"] == len(cases)
    with pytest.raises(ValueError, match="head dim"):
        x = torch.zeros(1, 8, 1, 48, device=card)
        flash_ops.flash_attention(x, x, x)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 80, 128, 256])
@pytest.mark.parametrize("S", [100, 1000])
def test_cuda_flash_attention_bf16_tensor_cores_vs_plain(D, S, card):
    """The bf16 tensor-core kernel against the dense plain version within
    the reference's bf16 kernel-test tolerance (2e-2) and within
    ``BF16_ULPS`` bf16 ulps, which the plain version with p rounded to bf16
    before p.v (the kernel without p1 and p2) breaks in every case: GQA 8:2
    and MQA 16:1, window 0 and 64, soft cap 0 and 50, causal and not, at a
    ragged S (TMA's zero fill past S and the kernel's k < S mask)."""
    from repro_torch.kernels.flash import ops as flash_ops
    from repro_torch.kernels.flash.ref import flash_attention_ref
    g = torch.Generator(device=card).manual_seed(13)
    flash_ops.reset_counts()
    calls = 0
    for H, hkv in ((8, 2), (16, 1)):
        q = torch.randn(1, S, H, D, generator=g, device=card).bfloat16()
        k, v = (torch.randn(1, S, hkv, D, generator=g, device=card)
                .bfloat16() for _ in range(2))
        for causal in (True, False):
            for window in (0, 64):
                for cap in (0.0, 50.0):
                    kw = dict(causal=causal, window=window, softcap=cap)
                    got = flash_ops.flash_attention(q, k, v, **kw)
                    want = flash_attention_ref(q, k, v, **kw)
                    calls += 1
                    assert got.dtype == torch.bfloat16
                    err = float((got.float() - want.float()).abs().max())
                    assert err <= 2e-2, ((H, hkv), kw, err)
                    assert bf16_ulps(got, want) <= BF16_ULPS, ((H, hkv), kw)
                    p0 = flash_attention_fault(q, k, v, "p0", **kw)
                    assert bf16_ulps(p0, want) > BF16_ULPS, ((H, hkv), kw)
    torch.cuda.synchronize()
    assert flash_ops.LAUNCHES["flash_attention"] == calls


@pytest.mark.cuda
def test_cuda_flash_attention_bf16_raises_for_unbuilt_head_dim(card):
    """A bf16 call whose head dim the kernels are not built for raises; it
    does not fall back to the plain version."""
    from repro_torch.kernels.flash import ops as flash_ops
    flash_ops.reset_counts()
    x = torch.zeros(1, 8, 2, 48, device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        flash_ops.flash_attention(x, x, x)
    assert flash_ops.LAUNCHES["flash_attention"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("algo,kernel,width", [
    ("fedbioacc_local", "storm3_step", 64), ("fedbio", "sgd3_step", 3 * 64)])
def test_cuda_paper_algorithms_fused_match_tree_loop(algo, kernel, width,
                                                     card, monkeypatch):
    """Two rounds of FedBiOAcc-Local and FedBiO on the quadratic, keys and
    draws on the card: the flat substrate (one launch a local step) within
    rtol 1e-5 / atol 1e-5 of the tree loop; every reduction covers the
    communicated tiles alone (x's 64 for FedBiOAcc-Local, its variables
    and its momenta at each of the two communications; x|y|u for FedBiO),
    so the PRIVATE y stays per client."""
    from repro_torch import random as jr
    from repro_torch.config import FederatedConfig
    from repro_torch.core import make_algorithm, quadratic_problem
    from repro_torch.core.tree_util import tree_leaves
    from repro_torch.optim import flat

    prob = quadratic_problem(jr.PRNGKey(4, device=card), num_clients=8,
                             dx=10, dy=10, noise=0.3)

    def run(fuse: bool):
        cfg = FederatedConfig(algorithm=algo, num_clients=8, local_steps=4,
                              lr_x=0.03, lr_y=0.1, neumann_q=4,
                              neumann_tau=0.2, fuse_storm=fuse,
                              fuse_storm_block=64)
        alg = make_algorithm(prob, cfg)
        state = alg.init(jr.PRNGKey(1, device=card))
        key = jr.PRNGKey(2, device=card)
        for _ in range(2):
            key, sub = jr.split(key)
            state, _ = alg.round(state, sub)
        return state

    tree = run(False)
    reduced, mean = [], flat._bcast_mean

    def recording(seg, w=None):
        reduced.append(seg.shape[-1])
        return mean(seg, w)

    monkeypatch.setattr(flat, "_bcast_mean", recording)
    tk.reset_counts()
    fused = run(True)
    torch.cuda.synchronize()
    assert tk.LAUNCHES[kernel] == 8
    assert sum(tk.LAUNCHES.values()) == 8
    assert reduced == [width] * (4 if algo == "fedbioacc_local" else 2)
    for name in tree._fields[:-1]:
        for a, b in zip(tree_leaves(getattr(tree, name)),
                        tree_leaves(getattr(fused, name))):
            assert a.device.type == "cuda"
            torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-5)
    if algo == "fedbioacc_local":
        assert not torch.equal(fused.y[0], fused.y[1])
        assert torch.equal(fused.x[0], fused.x[1])


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["fedbioacc_local", "fedbio"])
def test_cuda_graphed_oracle_replays_the_eager_one(algo, card, monkeypatch):
    """Three fused rounds on the hyper-representation problem with the
    engine's oracle replayed from its CUDA graph equal, bit for bit, three
    with the oracle run eagerly; a second algorithm's capture leaves the
    allocated memory where the first left it (one capture stream, so no
    new cuBLAS workspace a capture)."""
    import gc

    from repro_torch import random as jr
    from repro_torch.config import FederatedConfig
    from repro_torch.core import fedbio, hyperrep_problem, make_algorithm
    from repro_torch.core.tree_util import tree_leaves

    prob = hyperrep_problem(jr.PRNGKey(2, device=card))

    def run():
        cfg = FederatedConfig(algorithm=algo, num_clients=8, local_steps=4,
                              neumann_q=10, neumann_tau=0.15,
                              fuse_storm=True)
        alg = make_algorithm(prob, cfg)
        state = alg.init(jr.PRNGKey(0))
        key = jr.PRNGKey(3)
        for _ in range(3):
            key, sub = jr.split(key)
            state, _ = alg.round(state, sub)
        torch.cuda.synchronize()
        return [t.cpu() for name in state._fields[:-1]
                for t in tree_leaves(getattr(state, name))]

    graphed = run()
    gc.collect()
    after_one = torch.cuda.memory_allocated(card)
    again = run()
    gc.collect()
    assert torch.cuda.memory_allocated(card) == after_one
    monkeypatch.setattr(fedbio, "_graphed", lambda oracle: oracle)
    eager = run()
    for g, a, e in zip(graphed, again, eager):
        _assert_bits((g, a), (e, e))


@pytest.mark.cuda
def test_cuda_straggler_round_freezes_non_arrivals(card):
    """One FedBiOAcc round of a toy engine on the card with stragglers
    under ``drop`` (seed 0: client 3 misses the 1.0 deadline): the gated
    ``storm3_step`` leaves client 3's variable and momentum rows at their
    entering bits on both steps, once per step, and the round ages only
    client 3; the same round on the CPU agrees within 1e-6."""
    from repro_torch.config import FederatedConfig
    from repro_torch.core.tree_util import tree_map
    from repro_torch.federation.stragglers import (StragglerSpec,
                                                   make_stragglers)
    from repro_torch.optim import sequences as seqs

    sizes = {"x": (300,), "y": (100,), "u": (100,)}
    spec = StragglerSpec(deadline=1.0, quorum=0.25, max_extensions=0,
                         adapt_rate=0.0, over_provision=0)
    g = torch.Generator().manual_seed(0)
    init = {s: torch.randn((4,) + n, generator=g) for s, n in sizes.items()}
    cfg = FederatedConfig(num_clients=4, local_steps=2, lr_x=0.05,
                          lr_y=0.1, lr_u=0.1)
    aspec = seqs.SPECS["fedbioacc"].without_hierarchy()

    def oracle(v, b):
        return {s: tree_map(lambda a: 0.1 * a + b, v[s]) for s in v}

    def run(dev):
        eng = seqs.make_engine(
            cfg, aspec, {s: torch.empty(n, device="meta")
                         for s, n in sizes.items()}, oracle, block=256,
            stragglers=make_stragglers(spec, 4))
        state = eng.init_state({s: v.to(dev) for s, v in init.items()})
        tk.reset_counts()
        for b in (0.3, 0.4):
            before, metrics = state, {}
            state = eng.step(state, torch.tensor(b, device=dev), metrics)
            assert metrics["decision"]["arrivals"].tolist() == \
                [1.0, 1.0, 1.0, 0.0]
            for b0, b1 in zip(before.vars + before.mom,
                              state.vars + state.mom):
                np.testing.assert_array_equal(bits(b1[3]), bits(b0[3]))
        assert state.stale.tolist() == [0, 0, 0, 1]
        return state

    on_card = run(card)
    assert tk.LAUNCHES["storm3_step"] == 2
    assert sum(tk.LAUNCHES.values()) == 2
    on_cpu = run(torch.device("cpu"))
    for a, b in zip(on_card.vars + on_card.mom, on_cpu.vars + on_cpu.mom):
        assert a.device.type == "cuda"
        assert float((a.cpu() - b).norm()) <= 1e-6 * float(b.norm())


@pytest.mark.cuda
def test_cuda_checkpoint_roundtrip_in_place(card, tmp_path):
    """A reduced fused straggler state saved on the card and loaded back
    into a fresh run's state: every leaf bit for bit, copied in place into
    the target's tensors, on the target's device and in its dtype (the
    buffers on the card, the staleness counters and the deadline on the
    host, as the engine keeps them)."""
    from pathlib import Path

    from repro_torch.api import Experiment, build
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.core.tree_util import tree_leaves

    spec = Path(__file__).resolve().parents[1] / "experiments" / \
        "fedbioacc_straggler.json"
    run = build(Experiment.load(str(spec)), device=card)
    state = run.init(torch.Generator(device=card).manual_seed(0))
    data = torch.Generator().manual_seed(0)
    for _ in range(3):
        state, _ = run.step(state, run.batch_fn(data))
    save_checkpoint(str(tmp_path / "ck"), state, {"step": state.step},
                    experiment=run.spec)
    like = run.init(torch.Generator(device=card).manual_seed(1))
    got = load_checkpoint(str(tmp_path / "ck"), like)
    assert got.step == state.step == 3
    tensors = [[t for t in tree_leaves(s) if torch.is_tensor(t)]
               for s in (state, got, like)]
    assert len(tensors[0]) == 4
    for a, b, c in zip(*tensors):
        assert b is c and b.device == a.device and b.dtype == a.dtype
        np.testing.assert_array_equal(bits(a), bits(b))
    assert got.vars[0].device.type == "cuda"
    assert got.deadline.device.type == "cpu"


@pytest.mark.cuda
@pytest.mark.parametrize("aggregator", ["mean", "clip", "trim"])
def test_cuda_guarded_reduction_matches_cpu(aggregator, card):
    """The guarded reduction on the card, at a reduced size with chunks
    (8 clients, one NaN and two ×25 senders, one left out): the verdicts
    equal the CPU's and every entry lies within 1e-4 of the CPU's
    output's norm."""
    from repro_torch.optim import flat
    g = torch.Generator().manual_seed(5)
    x = torch.randn(8, 3 * flat._CHUNK // 2 + 37, generator=g)
    x[6] *= 4.0
    w = torch.tensor([1.0, 1, 1, 1, 1, 0, 1, 1])
    nan = torch.tensor([0.0, 1, 0, 0, 0, 0, 0, 0])
    byz = torch.tensor([0.0, 0, 0, 1, 0, 0, 0, 1])
    rob = flat.RobustCfg(aggregator, screen=True, z_thresh=1.5)
    outs, verdicts = [], []
    for dev in ("cpu", card):
        seg, v = x.clone().to(dev), []
        flat._robust_mean_into(seg, w, (nan, byz, 25.0), rob, v)
        outs.append(seg.cpu())
        verdicts.append([t.tolist() for t in v])
    assert verdicts[0] == verdicts[1]
    assert 0.0 in verdicts[0][0]                 # the NaN sender screened
    cpu, gpu = outs
    assert bool(torch.isfinite(gpu).all())
    assert float((gpu - cpu).norm()) <= 1e-4 * float(cpu.norm())
    np.testing.assert_array_equal(bits(gpu[5]), bits(x[5]))   # left out


@pytest.mark.cuda
def test_cuda_rollback_restores_in_place(card):
    """A guard rollback copies its host snapshot back into the live
    state's tensors on the card: the same data pointers, the snapshot's
    bits, ``retry`` set."""
    from repro_torch.federation.faults import RobustnessSpec, RollbackGuard
    from repro_torch.optim.sequences import FlatState

    def state(seed):
        g = torch.Generator(device=card).manual_seed(seed)
        return FlatState(
            (torch.randn(4, 1000, generator=g, device=card)
             .to(torch.bfloat16),), (torch.randn(4, 1000, generator=g,
                                                 device=card),), 2,
            retry=torch.tensor(0, dtype=torch.int32))

    guard = RollbackGuard(RobustnessSpec(ring=2))
    good = state(0)
    want = [b.cpu() for b in good.vars + good.mom]
    data = torch.Generator().manual_seed(1)
    assert guard.observe(2, good, data, 1.0) is None
    live = state(1)
    ptrs = [b.data_ptr() for b in live.vars + live.mom]
    step, back, _ = guard.observe(4, live, data, float("nan"))
    torch.cuda.synchronize()
    assert step == 2 and back.step == 2 and int(back.retry) == 1
    got = back.vars + back.mom
    assert [b.data_ptr() for b in got] == ptrs
    assert all(b.device.type == "cuda" for b in got)
    for b, w in zip(got, want):
        np.testing.assert_array_equal(bits(b), bits(w))


@pytest.mark.cuda
@pytest.mark.parametrize("S", [517, 1031])
def test_cuda_flash_attention_ragged_gqa_4_to_1(S, card):
    """granite-8b's prefill shape at ragged prompt lengths (not multiples
    of the kernels' query or key tiles): GQA 32:8, D 128, causal, batch 1,
    in bf16 (the tensor-core kernel: 2e-2 and ``BF16_ULPS``, which the p0
    fault breaks) and f32 (2e-5)."""
    from repro_torch.kernels.flash import ops as flash_ops
    from repro_torch.kernels.flash.ref import flash_attention_ref
    g = torch.Generator(device=card).manual_seed(S)
    q = torch.randn(1, S, 32, 128, generator=g, device=card)
    k, v = (torch.randn(1, S, 8, 128, generator=g, device=card)
            for _ in range(2))
    flash_ops.reset_counts()
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 2e-5)):
        args = tuple(t.to(dtype) for t in (q, k, v))
        got = flash_ops.flash_attention(*args, causal=True)
        want = flash_attention_ref(*args, causal=True)
        assert float((got.float() - want.float()).abs().max()) <= tol
        if dtype == torch.bfloat16:
            assert bf16_ulps(got, want) <= BF16_ULPS
            assert bf16_ulps(flash_attention_fault(*args, "p0", causal=True),
                             want) > BF16_ULPS
    torch.cuda.synchronize()
    assert flash_ops.LAUNCHES["flash_attention"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["granite-8b", "recurrentgemma-9b"])
def test_cuda_serve_engine_launches_and_tokens(arch, card):
    """A reduced ``ServeEngine`` on the card (f32, 5 requests through 2
    slots): each prefill launches the attention kernel once per attention
    layer (the scan once per recurrent one) and nothing else, and every
    request gets its isolated greedy decode's tokens, each choice's top-2
    margin asserted first."""
    from repro_torch.configs import get_config
    from repro_torch.core.tree_util import tree_map
    from repro_torch.kernels.flash import ops as flash_ops
    from repro_torch.kernels.lru import ops as lru_ops
    from repro_torch.models.registry import build_model
    from repro_torch.serving import ServeEngine
    from repro_torch.testing import isolated_greedy, top2_margin
    cfg = get_config(arch).reduced()
    model = build_model(cfg, dtype=torch.float32)
    params = tree_map(lambda t: t.to(card),
                      model.init(torch.Generator().manual_seed(0)))
    g = torch.Generator().manual_seed(1)
    prompts = [torch.randint(0, cfg.vocab_size, (8 + 3 * i,), generator=g)
               for i in range(5)]
    budgets = [6, 4, 8, 5, 7]
    want = []
    for p, n in zip(prompts, budgets):
        tokens, logits = isolated_greedy(model, params, p.to(card), n, 64)
        for lg in logits:
            assert top2_margin(lg) > 1e-4 * float(lg.abs().max())
        want.append(tokens)
    flash_ops.reset_counts()
    lru_ops.reset_counts()
    engine = ServeEngine(model, params, max_slots=2, cache_len=64)
    rids = [engine.submit(p, n) for p, n in zip(prompts, budgets)]
    results = engine.run_to_completion()
    torch.cuda.synchronize()
    kinds = cfg.layer_kinds()
    assert flash_ops.LAUNCHES["flash_attention"] == \
        5 * sum(k in ("local", "attn") for k in kinds)
    assert lru_ops.LAUNCHES["lru_scan"] == 5 * kinds.count("rec")
    assert [results[r] for r in rids] == want


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["gemma2-2b", "granite-moe-1b-a400m",
                                  "recurrentgemma-9b", "hubert-xlarge",
                                  "internvl2-76b"])
def test_cuda_family_train_step_matches_cpu(arch, card):
    """One reduced FedBiOAcc step (``experiments/fedbioacc.json``, the arch
    edited) on the card against the same step on the CPU, from one initial
    state on one batch: every buffer within 1e-4 of its norm (the two
    devices reduce in other orders), ``storm3_step`` once per buffer."""
    from pathlib import Path

    from repro_torch.api import Experiment, build
    root = Path(__file__).resolve().parents[1]
    exp = Experiment.load(str(root / "experiments" / "fedbioacc.json")).edit(
        **{"problem.arch": arch, "schedule.steps": 1})
    cpu_run, card_run = build(exp, device="cpu"), build(exp, device=card)
    state = cpu_run.init(torch.Generator().manual_seed(0))
    card_state = state._replace(vars=tuple(b.to(card) for b in state.vars),
                                mom=tuple(b.to(card) for b in state.mom))
    batch = cpu_run.batch_fn(torch.Generator().manual_seed(1))
    state, _ = cpu_run.step(state, batch)
    tk.reset_counts()
    card_state, _ = card_run.step(card_state, {
        k: {kk: v.to(card) for kk, v in b.items()} for k, b in batch.items()})
    torch.cuda.synchronize()
    assert tk.LAUNCHES["storm3_step"] == len(card_run.init.spec.groups)
    for got, want in zip(card_state.vars + card_state.mom,
                         state.vars + state.mom):
        want = want.float()
        assert float((got.cpu().float() - want).norm()) <= \
            1e-4 * float(want.norm())
