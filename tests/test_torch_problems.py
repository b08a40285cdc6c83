"""The bilevel problems and the hyper-gradient functions of the port
(``repro_torch.core.problems``, ``core.hypergrad``, ``core.tree_util``)
against the JAX package's.

Problems are built from the reference's arrays (the quadratic's SPD
matrices come from a QR that LAPACK and PyTorch need not round alike);
the port's own draws are held to what they must reproduce: the data sets'
labels equal the reference's for the seeds used here, and a port-built
quadratic meets its own closed forms.  Values are held at ``RTOL``/``ATOL``
(f32 arithmetic in a different order); the closed forms, which solve
linear systems, at ``SOLVE_RTOL``."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import hypergrad as jhg  # noqa: E402
from repro.core import problems as jp  # noqa: E402
from repro.core.tree_util import tree_randn_like as j_randn  # noqa: E402
from repro_torch import random as jr  # noqa: E402
from repro_torch.core import hypergrad as hg  # noqa: E402
from repro_torch.core import problems as tp  # noqa: E402
from repro_torch.core.tree_util import (client_mean, tree_leaves,  # noqa: E402
                                        tree_map, tree_randn_like,
                                        tree_size, tree_sqnorm)
from torch_parity import to_torch  # noqa: E402

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
SOLVE_RTOL = 1e-4


def _close(want, got, rtol=RTOL, atol=ATOL):
    for w, g in zip(jax.tree.leaves(want), tree_leaves(got)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=rtol, atol=atol)


def _labels(data, *keys):
    """The reference's data with integer labels as int64 tensors."""
    out = to_torch(dict(data))
    for k in keys:
        out[k] = out[k].long()
    return out


def _client(batch, m):
    return jax.tree.map(lambda v: v[m], batch)


@pytest.fixture(scope="module")
def quad():
    jprob = jp.quadratic_problem(jax.random.PRNGKey(3), num_clients=4, dx=6,
                                 dy=5, noise=0.2)
    b = jprob.sample_batches(jax.random.PRNGKey(0))
    arrays = to_torch({k: b[k] for k in ("Ag", "B", "c", "D", "x0", "y0")})
    return jprob, tp.quadratic_from_arrays(arrays, noise=0.2)


@pytest.fixture(scope="module")
def cleaning():
    jprob = jp.data_cleaning_problem(jax.random.PRNGKey(1), num_clients=4,
                                     n_train=64, n_val=16)
    return jprob, tp.data_cleaning_from_data(
        _labels(jprob.data, "ytr", "yval"))


def _points(jprob, tprob, seed):
    """(x, y, u) of one client from the reference's draws, in both."""
    x, y = jprob.init_xy(jax.random.PRNGKey(seed))
    x = jax.tree.map(lambda v: v + 0.1, x)
    u = j_randn(jax.random.PRNGKey(seed + 1), y, 0.5)
    return (x, y, u), tuple(to_torch(v) for v in (x, y, u))


@pytest.mark.parametrize("which", ["quad", "cleaning"])
def test_hypergradient_functions_match(which, request):
    jprob, tprob = request.getfixturevalue(which)
    jb = [_client(jprob.sample_batches(jax.random.PRNGKey(k)), 1)
          for k in (10, 11)]
    tb = [to_torch(b) for b in jb]
    (jx, jy, ju), (x, y, u) = _points(jprob, tprob, 5)
    jf, jg, f, g = jprob.f, jprob.g, tprob.f, tprob.g
    _close(jf(jx, jy, jb[0]), f(x, y, tb[0]))
    _close(jg(jx, jy, jb[0]), g(x, y, tb[0]))
    pairs = [
        (jhg.grad_x(jf, jx, jy, jb[0]), hg.grad_x(f, x, y, tb[0])),
        (jhg.grad_y(jg, jx, jy, jb[0]), hg.grad_y(g, x, y, tb[0])),
        (jhg.hvp_yy(jg, jx, jy, jb[0], ju), hg.hvp_yy(g, x, y, tb[0], u)),
        (jhg.jvp_xy(jg, jx, jy, jb[0], ju), hg.jvp_xy(g, x, y, tb[0], u)),
        (jhg.u_residual(jg, jf, jx, jy, ju, *jb),
         hg.u_residual(g, f, x, y, u, *tb)),
        (jhg.u_step(jg, jf, jx, jy, ju, *jb, 0.3),
         hg.u_step(g, f, x, y, u, *tb, 0.3)),
        (jhg.nu_direction(jg, jf, jx, jy, ju, *jb),
         hg.nu_direction(g, f, x, y, u, *tb)),
        (jhg.neumann_hypergrad(jg, jf, jx, jy, *jb, 6, 0.2),
         hg.neumann_hypergrad(g, f, x, y, *tb, 6, 0.2)),
        (jhg.fused_oracles(jg, jf, jx, jy, ju, jb[0]),
         hg.fused_oracles(g, f, x, y, u, tb[0])),
        (jhg.fused_local_oracles(jg, jf, jx, jy, jb[0], 6, 0.2),
         hg.fused_local_oracles(g, f, x, y, tb[0], 6, 0.2)),
    ]
    for want, got in pairs:
        _close(want, got)


def test_quadratic_closed_forms_match(quad):
    jprob, tprob = quad
    for seed in (0, 1):
        jx = jax.random.normal(jax.random.PRNGKey(seed), (6,))
        x = to_torch(jx)
        for name in ("exact_lower_sol", "exact_hypergrad",
                     "exact_hypergrad_local"):
            _close(getattr(jprob, name)(jx), getattr(tprob, name)(x),
                   rtol=SOLVE_RTOL, atol=ATOL)
    # a reference fault the port keeps: exact_hypergrad_quadratic passes
    # (x, y) to the quadratic's one-argument exact_hypergrad
    with pytest.raises(TypeError):
        jhg.exact_hypergrad_quadratic(jprob, jx, None)
    with pytest.raises(TypeError):
        hg.exact_hypergrad_quadratic(tprob, x, None)


def test_port_built_quadratic_meets_its_closed_forms():
    """The port's own draws (QR in PyTorch): close to the reference's
    matrices, SPD in [mu, L], and y_x and ∇h(x) are what autodiff of the
    noise-free averaged objectives says."""
    kw = dict(num_clients=4, dx=6, dy=5, noise=0.0)
    tprob = tp.quadratic_problem(jr.PRNGKey(3), **kw)
    jprob = jp.quadratic_problem(jax.random.PRNGKey(3), **kw)
    tb = tprob.sample_batches(jr.PRNGKey(0))
    jb = jprob.sample_batches(jax.random.PRNGKey(0))
    for k in ("Ag", "B", "c", "D", "x0", "y0"):
        np.testing.assert_allclose(tb[k].numpy(), np.asarray(jb[k]),
                                   rtol=SOLVE_RTOL, atol=1e-5)
    ev = torch.linalg.eigvalsh(tb["Ag"])
    assert float(ev.min()) >= 1.0 - 1e-4 and float(ev.max()) <= 5.0 + 1e-4

    def mean(fn, x, y):
        return sum(fn(x, y, tree_map(lambda v: v[m], tb))
                   for m in range(4)) / 4

    x = jr.normal(jr.PRNGKey(9), (6,))
    yx = tprob.exact_lower_sol(x)
    gy = torch.func.grad(lambda y: mean(tprob.g, x, y))(yx)
    assert float(gy.abs().max()) < 1e-4
    total = torch.func.grad(
        lambda xx: mean(tprob.f, xx, tprob.exact_lower_sol(xx)))(x)
    np.testing.assert_allclose(tprob.exact_hypergrad(x).numpy(),
                               total.numpy(), rtol=SOLVE_RTOL, atol=1e-5)

    def local(xx):
        return sum(tprob.f(xx, -torch.linalg.solve(
            tb["Ag"][m], tb["B"][m].T @ xx + tb["c"][m]),
            tree_map(lambda v: v[m], tb)) for m in range(4)) / 4
    np.testing.assert_allclose(tprob.exact_hypergrad_local(x).numpy(),
                               torch.func.grad(local)(x).numpy(),
                               rtol=SOLVE_RTOL, atol=1e-5)


@pytest.mark.parametrize("seed", [1, 3])
def test_cleaning_data_and_objectives_match(seed):
    kw = dict(num_clients=8, n_train=256, n_val=64)
    jdata = jp.make_cleaning_data(jax.random.PRNGKey(seed), **kw)
    own = tp.make_cleaning_data(jr.PRNGKey(seed), **kw)
    for k in ("ytr", "yval", "corrupt_mask"):
        np.testing.assert_array_equal(own[k].numpy(), np.asarray(jdata[k]))
    for k in ("xtr", "xval", "w_true"):
        np.testing.assert_allclose(own[k].numpy(), np.asarray(jdata[k]),
                                   rtol=1e-5, atol=1e-5)
    jprob = jp.data_cleaning_problem(jax.random.PRNGKey(seed), **kw)
    tprob = tp.data_cleaning_from_data(_labels(jprob.data, "ytr", "yval"))
    _objectives_match(jprob, tprob, seed)


@pytest.mark.parametrize("seed", [2, 4])
def test_hyperrep_data_and_objectives_match(seed):
    jdata = jp.make_hyperrep_data(jax.random.PRNGKey(seed))
    own = tp.make_hyperrep_data(jr.PRNGKey(seed))
    np.testing.assert_array_equal(own["y"].numpy(), np.asarray(jdata["y"]))
    np.testing.assert_allclose(own["x"].numpy(), np.asarray(jdata["x"]),
                               rtol=1e-5, atol=1e-5)
    jprob = jp.hyperrep_problem(jax.random.PRNGKey(seed))
    tprob = tp.hyperrep_from_data(_labels(jprob.data, "y"))
    _objectives_match(jprob, tprob, seed)


def test_fairness_data_objectives_and_val_losses_match():
    jdata = jp.make_fairness_data(jax.random.PRNGKey(0))
    own = tp.make_fairness_data(jr.PRNGKey(0))
    for k in ("y", "hard_mask"):
        np.testing.assert_array_equal(own[k].numpy(), np.asarray(jdata[k]))
    jprob = jp.fair_federated_problem(jax.random.PRNGKey(0))
    tprob = tp.fair_federated_from_data(_labels(jprob.data, "y"))
    _objectives_match(jprob, tprob, 0)
    lam = jax.random.normal(jax.random.PRNGKey(5), (8,))
    y = 0.1 * jax.random.normal(jax.random.PRNGKey(6), (16, 4))
    _close(jprob.client_val_losses(lam, y),
           tprob.client_val_losses(to_torch(lam), to_torch(y)))


def _objectives_match(jprob, tprob, seed):
    """f, g and their gradients at the reference's init, over every
    client's batch of one draw; the draw itself equal."""
    jb = jprob.sample_batches(jax.random.PRNGKey(seed + 20))
    tb = tprob.sample_batches(jr.PRNGKey(seed + 20))
    for k in jb:
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
    jx, jy = jprob.init_xy(jax.random.PRNGKey(seed))
    x, y = tprob.init_xy(jr.PRNGKey(seed))
    _close((jx, jy), (x, y))
    x, y = to_torch(jx), to_torch(jy)
    for m in range(jprob.num_clients):
        jbm, tbm = _client(jb, m), tree_map(lambda v: v[m], tb)
        for jfn, tfn in ((jprob.f, tprob.f), (jprob.g, tprob.g)):
            _close(jfn(jx, jy, jbm), tfn(x, y, tbm))
            _close(jax.grad(jfn, argnums=(0, 1))(jx, jy, jbm),
                   torch.func.grad(tfn, argnums=(0, 1))(x, y, tbm))


def test_tree_helpers_match():
    tree = {"w": jnp.ones((3, 4)), "b": jnp.zeros((5,)), "c": [jnp.ones(2)]}
    want = j_randn(jax.random.PRNGKey(7), tree, 0.3)
    got = tree_randn_like(jr.PRNGKey(7), to_torch(tree), 0.3)
    _close(want, got, rtol=1e-6, atol=1e-7)
    assert tree_size(got) == 19
    stacked = jax.tree.map(lambda v: jnp.stack([v, 2 * v, 4 * v]), want)
    from repro.core.tree_util import client_mean as j_mean
    from repro.core.tree_util import tree_sqnorm as j_sq
    _close(j_mean(stacked), client_mean(to_torch(stacked)))
    _close(j_sq(want), tree_sqnorm(got))
