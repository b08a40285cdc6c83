"""``tests/test_invariants.py::test_client_mean_idempotent_and_preserving``
restated on the port's ``client_mean``, and its falsifying example pinned
on both packages.

The reference's test holds the sum of the averaged rows to the sum of the
rows with ``rtol=1e-5``, relative to a sum that can cancel to near zero:
for m = 4, d = 8 and seed 365198457 the two f32 sums are −0.014398336 and
−0.014398575, 2.4e-7 apart, 1.66e-5 of the sum but 1e-8 of Σ|x|.  The
mean is not at fault: two f32 sums of the same 32 values in other orders
differ by up to a few roundings of Σ|x|.  The claim is restated with that
bound, ``CONSERVE_ULPS · m·d · 2^-24 · Σ|x|``.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core.tree_util import client_mean as jclient_mean  # noqa: E402
from repro_torch.core.tree_util import client_mean  # noqa: E402

torch.set_num_threads(1)

CONSERVE_ULPS = 4
PINNED = (4, 8, 365198457)


def _rows(m, d, seed):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (m, d)))


def _bound(x: np.ndarray) -> float:
    return CONSERVE_ULPS * x.size * 2.0 ** -24 * float(np.abs(x).sum())


@pytest.mark.parametrize("m", [2, 4, 8])
@pytest.mark.parametrize("d", [1, 8, 16])
def test_client_mean_idempotent_and_preserving(m, d):
    """client_mean is an idempotent projection that preserves the total sum
    within ``_bound``, on every (m, d) of the reference's strategy and five
    seeds each, the pinned one among them."""
    for seed in (0, 1, 2, 3, PINNED[2]):
        x = torch.from_numpy(_rows(m, d, seed).copy())
        once = client_mean({"w": x})["w"]
        twice = client_mean({"w": once})["w"]
        np.testing.assert_allclose(once.numpy(), twice.numpy(), atol=1e-6)
        assert abs(float(once.sum()) - float(x.sum())) <= _bound(x.numpy())
        assert float(once.std(dim=0, unbiased=False).max()) < 1e-6


def test_pinned_example_fails_only_the_relative_rtol():
    """The falsifying example on both packages: the sum is preserved within
    ``_bound`` and not within the reference's ``rtol=1e-5`` of the sum."""
    m, d, seed = PINNED
    x = _rows(m, d, seed)
    ref_once = np.asarray(jclient_mean({"w": jnp.asarray(x)})["w"])
    ref = (float(jnp.sum(jnp.asarray(ref_once))), float(jnp.sum(x)))
    port_once = client_mean({"w": torch.from_numpy(x.copy())})["w"]
    port = (float(port_once.sum()), float(torch.from_numpy(x.copy()).sum()))
    for once_sum, x_sum in (ref, port):
        assert abs(once_sum - x_sum) <= _bound(x)
    # the reference's own sums: 2.4e-7 apart, over 1e-5 of their size
    assert abs(ref[0] - ref[1]) > 1e-5 * abs(ref[1])
    assert abs(ref[0] - ref[1]) == pytest.approx(2.384185791015625e-07)
    # the averaged rows themselves agree between the packages
    np.testing.assert_allclose(port_once.numpy(), ref_once, rtol=0,
                               atol=1e-7)
