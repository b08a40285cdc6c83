"""The port's per-tile int8 pack/unpack (``quantpack_flat`` /
``quantunpack_flat``) against the JAX package's.

On the CPU the wrappers run their plain PyTorch versions, which must equal,
bit for bit, both the reference's jitted jnp lowerings
(``quantpack_flat_jnp`` / ``quantunpack_flat_jnp``) and its Pallas kernels
in interpret mode, at tiles of 128 and 1,024 elements.  Under ``jit`` XLA
computes the scale ``max|x| / 127`` as ``max|x| · f32(1/127)``; the data
are chosen so that this differs from the division in some tiles, so the
scale check bites.  Values one ulp either side of the rounding half-way
points check the true division and the half-to-even rounding of ``q``; an
all-zero tile checks the guarded divisor (scale 0, q 0)."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels.storm import quantpack as jqp  # noqa: E402
from repro_torch.kernels.storm import quantpack as tqp  # noqa: E402
from repro_torch.kernels.storm import ref as tref  # noqa: E402
from repro_torch.testing import INV127, halfway_tiles  # noqa: E402
from torch_parity import bits  # noqa: E402

torch.set_num_threads(1)


def _lognormal(rng, tiles: int, block: int) -> np.ndarray:
    return (rng.lognormal(0.0, 2.0, tiles * block)
            * rng.choice([-1.0, 1.0], tiles * block)).astype(np.float32)


def _buffer(seed: int, block: int, tiles: int = 24) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.concatenate([_lognormal(rng, tiles, block),
                           halfway_tiles(rng, 6, block),
                           np.zeros(block, np.float32)])


def _check_pack(x: np.ndarray, block: int, jq, js):
    tq, ts = tqp.quantpack_flat(torch.from_numpy(x), block=block)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(bits(tq), bits(jq))
    np.testing.assert_array_equal(bits(ts), bits(js))
    return tq, ts


@pytest.mark.parametrize("block", [128, 1024])
def test_pack_unpack_equal_jitted_reference_bitwise(block):
    x = _buffer(block, block, tiles=256)
    t = x.reshape(-1, block)
    amax = np.abs(t).max(axis=1)
    # the scale check bites: the product and the quotient differ somewhere
    assert np.any(amax * INV127 != amax / np.float32(127.0))
    jq, js = jqp.quantpack_flat_jnp(jnp.asarray(x), block=block)
    tq, ts = _check_pack(x, block, jq, js)
    np.testing.assert_array_equal(bits(ts), bits(amax * INV127))
    # ... and the division of q bites: a reciprocal product rounds otherwise
    safe = np.where(amax > 0, amax * INV127, np.float32(1.0))[:, None]
    assert np.any(np.rint(t / safe) != np.rint(t * (np.float32(1.0) / safe)))
    # the zero tile: scale 0, q 0
    assert float(ts[-1]) == 0.0 and not torch.any(tq[-block:])
    assert int(tq.abs().max()) == 127
    jd = jqp.quantunpack_flat_jnp(jq, js, block=block)
    td = tqp.quantunpack_flat(tq, ts, block=block)
    assert td.dtype == torch.float32
    np.testing.assert_array_equal(bits(td), bits(jd))


@pytest.mark.parametrize("block", [128, 1024])
def test_pack_unpack_equal_interpreted_pallas_bitwise(block):
    """The reference's Pallas kernels in interpret mode (their grid unrolls
    at trace time, so fewer tiles)."""
    rng = np.random.default_rng(block + 1)
    x = np.concatenate([_lognormal(rng, 4, block), halfway_tiles(rng, 2, block),
                        np.zeros(block, np.float32)])
    jq, js = jqp.quantpack_flat(jnp.asarray(x), block=block, interpret=True)
    tq, ts = _check_pack(x, block, jq, js)
    jd = jqp.quantunpack_flat(jq, js, block=block, interpret=True)
    np.testing.assert_array_equal(
        bits(tqp.quantunpack_flat(tq, ts, block=block)), bits(jd))


def test_unpack_equals_the_library_product():
    """The unpack is what one PyTorch call computes, an int8 [T, block]
    times the f32 [T, 1] scales (promoted to f32, one rounding): the call
    ``chip_smoke.py`` times as the library's."""
    x = _buffer(3, 128)
    tq, ts = tqp.quantpack_flat(torch.from_numpy(x), block=128)
    lib = torch.mul(tq.view(-1, 128), ts.view(-1, 1)).reshape(-1)
    assert lib.dtype == torch.float32
    np.testing.assert_array_equal(
        bits(tqp.quantunpack_flat(tq, ts, block=128)), bits(lib))


def test_wrappers_count_calls_and_reject_bad_inputs():
    x = torch.from_numpy(_buffer(4, 128))
    tqp.reset_counts()
    q, s = tqp.quantpack_flat(x, block=128)
    tqp.quantunpack_flat(q, s, block=128)
    assert tqp.CALLS == {"quantpack": 1, "quantunpack": 1}
    assert not any(tqp.LAUNCHES.values())     # CPU tensors: plain versions
    np.testing.assert_array_equal(bits(q), bits(tref.quantpack_ref(x, 128)[0]))
    with pytest.raises(ValueError, match="multiple of block"):
        tqp.quantpack_flat(x[:-1], block=128)
    with pytest.raises(TypeError, match="float32"):
        tqp.quantpack_flat(x.double(), block=128)
    with pytest.raises(TypeError, match="int8"):
        tqp.quantunpack_flat(s, s, block=128)
    with pytest.raises(ValueError, match="scales need"):
        tqp.quantunpack_flat(q, s[:-1], block=128)
    with pytest.raises(ValueError, match="flat"):
        tqp.quantpack_flat(x.reshape(2, -1), block=128)
