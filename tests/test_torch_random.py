"""``repro_torch.random`` against ``jax.random`` (Threefry-2x32, the
partitionable layout that is jax 0.9.0's default).

Keys, ``split``, ``fold_in``, raw bits, ``uniform``, ``randint``,
``bernoulli`` and ``permutation`` must equal the reference bit for bit,
over several seeds and shapes, the reference jitted as its loops draw.
``normal`` and ``gumbel`` pass XLA's own ``log1p``/``log`` approximations,
which the port does not reproduce: over 2·10^5 draws per seed, ``normal``
stays within ``NORMAL_ULPS`` f32 ulps of the reference (and differs at all
in fewer than ``NORMAL_DIFFER`` of the draws, which holds only with XLA's
erf_inv polynomial and its multiply-adds), and ``gumbel`` within
``GUMBEL_ULPS`` ulps of ``max(|v|, 1)``: near its zero, −log(−log u) is a
difference of two values near 1, so its error is one of absolute size."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro_torch import random as jr  # noqa: E402
from torch_parity import bits  # noqa: E402

torch.set_num_threads(1)

SEEDS = (0, 1, 42, 2 ** 31 + 5, 2 ** 32 - 1)
SHAPES = ((), (7,), (3, 5), (2, 3, 4), (1001,))
NORMAL_ULPS, NORMAL_DIFFER = 4, 0.02
GUMBEL_ULPS = 4
DRAWS = 200_000


def _words(a) -> np.ndarray:
    return np.asarray(a).astype(np.int64)


def _same_bits(a, t: torch.Tensor):
    assert np.shape(a) == tuple(t.shape)
    np.testing.assert_array_equal(bits(a), bits(t))


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_split_and_fold_in_bitwise(seed):
    jk, tk = jax.random.PRNGKey(seed), jr.PRNGKey(seed)
    np.testing.assert_array_equal(_words(jk), tk.numpy())
    for num in (2, 5, (2, 3)):
        np.testing.assert_array_equal(_words(jax.random.split(jk, num)),
                                      jr.split(tk, num).numpy())
    for data in (0, 7, 2 ** 32 - 1):
        np.testing.assert_array_equal(_words(jax.random.fold_in(jk, data)),
                                      jr.fold_in(tk, data).numpy())
    # a chain of splits, as the algorithms walk one key across rounds
    for _ in range(3):
        jk, _ = jax.random.split(jk)
        tk, _ = jr.split(tk)
    np.testing.assert_array_equal(_words(jk), tk.numpy())
    np.testing.assert_array_equal(
        _words(jax.random.split(jk, 4)),
        jr.split(torch.from_numpy(_words(jk)), 4).numpy())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_bits_uniform_randint_bernoulli_bitwise(seed, shape):
    jk, tk = jax.random.PRNGKey(seed), jr.PRNGKey(seed)
    draw = jax.jit(lambda k: (
        jax.random.bits(k, shape),
        [jax.random.uniform(k, shape, minval=lo, maxval=hi)
         for lo, hi in ((0.0, 1.0), (0.3, 1.7), (-2.5, 10.0), (1.0, 5.0))],
        [jax.random.randint(k, shape, lo, hi)
         for lo, hi in ((0, 10), (0, 256), (-5, 5), (3, 100_000),
                        (0, 2 ** 31 - 1), (7, 7))],
        [jax.random.bernoulli(k, p, shape) for p in (0.3, 0.5)]))
    jbits, juni, jint, jber = draw(jk)
    np.testing.assert_array_equal(_words(jbits), jr.bits(tk, shape).numpy())
    for a, (lo, hi) in zip(juni, ((0.0, 1.0), (0.3, 1.7), (-2.5, 10.0),
                                  (1.0, 5.0))):
        _same_bits(a, jr.uniform(tk, shape, minval=lo, maxval=hi))
    for a, (lo, hi) in zip(jint, ((0, 10), (0, 256), (-5, 5), (3, 100_000),
                                  (0, 2 ** 31 - 1), (7, 7))):
        t = jr.randint(tk, shape, lo, hi)
        assert t.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(a), t.numpy())
    for a, p in zip(jber, (0.3, 0.5)):
        np.testing.assert_array_equal(np.asarray(a),
                                      jr.bernoulli(tk, p, shape).numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_permutation_bitwise(seed):
    jk, tk = jax.random.PRNGKey(seed), jr.PRNGKey(seed)
    # 2000 > 1625 elements take two rounds of sorts
    for n in (1, 5, 100, 2000):
        a = jax.jit(lambda k, n=n: jax.random.permutation(k, n))(jk)
        t = jr.permutation(tk, n)
        assert t.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(a), t.numpy())
    x = np.arange(24, dtype=np.float32).reshape(4, 6)
    for axis in (0, 1):
        for independent in (False, True):
            a = jax.random.permutation(jk, jnp.asarray(x), axis=axis,
                                       independent=independent)
            t = jr.permutation(tk, torch.from_numpy(x), axis=axis,
                               independent=independent)
            np.testing.assert_array_equal(np.asarray(a), t.numpy())


def test_tensor_hash_and_batched_draws_equal_the_cpu_path():
    """The hash as int64 tensor operations (what runs on a card) equals the
    numpy uint32 one the CPU runs, and ``normals`` draws what ``normal``
    draws key by key."""
    rng = np.random.default_rng(0)
    words = [torch.from_numpy(rng.integers(0, 2 ** 32, n, dtype=np.int64))
             for n in (1, 1, 1000, 1000)]
    k1, k2, hi, lo = words
    got = jr.threefry_2x32(k1[0], k2[0], hi, lo)
    want = jr._hash(k1[0], k2[0], hi, lo)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    keys = jr.split(jr.PRNGKey(5), 3)
    shapes = [(8, 10), (3,), ()]
    for key, shape, z in zip(keys, shapes, jr.normals(keys, shapes)):
        assert tuple(z.shape) == shape
        np.testing.assert_array_equal(bits(z), bits(jr.normal(key, shape)))


def _ulps(a, b, floor: float = 0.0) -> np.ndarray:
    a, b = (np.asarray(v, np.float64) for v in (a, b))
    scale = np.maximum(np.maximum(np.abs(a), np.abs(b)), floor)
    return np.abs(a - b) / np.spacing(scale.astype(np.float32))


@pytest.mark.parametrize("seed", (0, 1, 7))
def test_normal_and_gumbel_within_stated_ulps(seed):
    jk, tk = jax.random.PRNGKey(seed), jr.PRNGKey(seed)
    jn, jg = jax.jit(lambda k: (jax.random.normal(k, (DRAWS,)),
                                jax.random.gumbel(k, (DRAWS,))))(jk)
    tn, tg = jr.normal(tk, (DRAWS,)), jr.gumbel(tk, (DRAWS,))
    assert tn.dtype == tg.dtype == torch.float32
    un = _ulps(jn, tn.numpy())
    assert un.max() <= NORMAL_ULPS, un.max()
    assert (un > 0).mean() < NORMAL_DIFFER, (un > 0).mean()
    ug = _ulps(jg, tg.numpy(), floor=1.0)
    assert ug.max() <= GUMBEL_ULPS, ug.max()
    # shapes and the tree helper draw as the reference does
    for shape in SHAPES[:4]:
        assert _ulps(jax.random.normal(jk, shape),
                     jr.normal(tk, shape).numpy()).max() <= NORMAL_ULPS


def test_erf_inv_edges_and_draws_on_the_keys_device():
    x = torch.tensor([-1.0, 1.0, 0.0, 0.5, -0.999999])
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x.numpy())))
    got = jr.erf_inv(x).numpy()
    assert np.isneginf(got[0]) and np.isposinf(got[1]) and got[2] == 0.0
    assert _ulps(want[3:], got[3:]).max() <= NORMAL_ULPS
    meta = jr.PRNGKey(3, device="meta")
    assert jr.split(meta, 3).device.type == "meta"
    with pytest.raises(TypeError):
        jr.uniform(jr.PRNGKey(0), (3,), torch.float64)
