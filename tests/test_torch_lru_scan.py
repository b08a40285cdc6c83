"""The walk of ``lru_scan.cu``'s TMA kernel, written out in PyTorch, against
the plain sequential scan, bit for bit; and the wrapper's choice of kernel.

The kernel reads [``TIME_TILE`` × ``CHANNEL_BLOCK``] tiles whose rows past S
and channels past C arrive as zeros, carries h from tile to tile, and never
stores a row past S or a channel past C.  Written out here on the CPU at
ragged shapes, that walk must equal ``lru_scan_ref`` bit for bit: the
zero-filled tail must not reach a stored value."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.lru import ops as lru_ops
from repro_torch.kernels.lru.ref import lru_scan_ref
from torch_parity import bits

torch.set_num_threads(1)


def _tile_walk(a, b, h0=None):
    """The TMA kernel's walk: one (batch, channel block) at a time, time
    tiles with a carried h, from zero-padded tiles; only rows < S and
    channels < C are stored."""
    B, S, C = a.shape
    tt, cb = lru_ops.TIME_TILE, lru_ops.CHANNEL_BLOCK
    pad_s, pad_c = -S % tt, -C % cb
    ap, bp = (torch.nn.functional.pad(t, (0, pad_c, 0, pad_s))
              for t in (a, b))
    out = torch.full_like(a, float("nan"))
    for bi in range(B):
        for c0 in range(0, C + pad_c, cb):
            h = torch.zeros(cb) if h0 is None else \
                torch.nn.functional.pad(h0[bi], (0, pad_c))[c0:c0 + cb]
            keep = min(cb, C - c0)
            for t0 in range(0, S + pad_s, tt):
                a_tile, b_tile = ap[bi, t0:t0 + tt, c0:c0 + cb], \
                    bp[bi, t0:t0 + tt, c0:c0 + cb]
                for r in range(min(tt, S - t0)):
                    h = a_tile[r] * h + b_tile[r]
                    out[bi, t0 + r, c0:c0 + keep] = h[:keep]
    return out


@pytest.mark.parametrize("B,S,C", [(1, 200, 100), (3, 65, 64), (2, 64, 132),
                                   (1, 7, 4)])
@pytest.mark.parametrize("with_h0", [False, True])
def test_tile_walk_equals_the_plain_scan_bitwise(B, S, C, with_h0):
    rng = np.random.default_rng(B * S * C)
    a = torch.from_numpy((0.7 + 0.299 * rng.random((B, S, C)))
                         .astype(np.float32))
    b = torch.from_numpy((0.1 * rng.standard_normal((B, S, C)))
                         .astype(np.float32))
    h0 = torch.from_numpy(rng.standard_normal((B, C)).astype(np.float32)) \
        if with_h0 else None
    want = lru_scan_ref(a, b, h0)
    np.testing.assert_array_equal(bits(_tile_walk(a, b, h0)), bits(want))
    np.testing.assert_array_equal(bits(lru_ops.lru_scan(a, b, h0)),
                                  bits(want))


@pytest.mark.parametrize("shape,ptrs,variant", [
    ((2, 4096, 4096), (256, 512), "lru_scan_tma"),      # the serving shape
    ((2, 1001, 100), (256, 512), "lru_scan_tma"),
    ((3, 1001, 77), (256, 512), "lru_scan_lanes"),      # C % 4 != 0
    ((2, 64, 64), (260, 512), "lru_scan_lanes"),        # a not 16-byte aligned
])
def test_scan_kernel_choice(shape, ptrs, variant):
    assert lru_ops.scan_variant(*shape, *ptrs) == variant
