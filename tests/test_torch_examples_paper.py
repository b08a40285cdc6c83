"""The port's ``examples/quickstart.py`` and
``examples/fair_federated_learning.py`` (``repro_torch.examples``) once
on the CPU, against the reference examples' figures on the same settings.

The problems and keys come from ``repro_torch.random``, whose Threefry
draws are the reference's bit for bit; its normals agree within a few
ulps (the reference's ``erf_inv`` polynomial), so the quadratic's and the
fairness data's arrays, and with them every later figure, differ by f32
rounding alone.  What that leaves after the examples' 150 and 2 × 200
rounds: the hypergradient norms within rtol 1e-4 and the fairness
figures (the client losses under uniform and learned weights, the learned
weights) within rtol 1e-4; each example's own checks pass.  The reference
figures come from its examples' loops, run here unrounded (the scripts
print 3–4 decimals)."""
import importlib.util
import os

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro_torch.examples import fair_federated_learning as fair  # noqa: E402
from repro_torch.examples import quickstart  # noqa: E402

torch.set_num_threads(1)

RTOL = 1e-4
_ROOT = os.path.join(os.path.dirname(__file__), "..")


def _reference_example(name: str):
    """The reference's ``examples/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", os.path.join(_ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reference_quickstart() -> list:
    """``examples/quickstart.py``'s loop: its norms every 25 rounds."""
    from repro.config import FederatedConfig
    from repro.core import make_algorithm, quadratic_problem
    prob = quadratic_problem(jax.random.PRNGKey(0), num_clients=8, dx=10,
                             dy=10, noise=0.1, hetero=1.0)
    cfg = FederatedConfig(algorithm="fedbioacc", num_clients=8,
                          local_steps=4, lr_x=0.03, lr_y=0.1, lr_u=0.1)
    alg = make_algorithm(prob, cfg)
    state = alg.init(jax.random.PRNGKey(1))
    round_fn = jax.jit(alg.round)
    key = jax.random.PRNGKey(2)
    norms = []
    for r in range(1, 151):
        key, sub = jax.random.split(key)
        state, _ = round_fn(state, sub)
        if r % 25 == 0:
            norms.append((r, float(jnp.linalg.norm(
                prob.exact_hypergrad(alg.mean_x(state))))))
    return norms


def test_quickstart_matches_the_reference_example():
    norms = quickstart.run("cpu", log=lambda *a: None)
    want = _reference_quickstart()
    assert [r for r, _ in norms[:-1]] == [r for r, _ in want]
    np.testing.assert_allclose([v for _, v in norms[:-1]],
                               [v for _, v in want], rtol=RTOL)
    assert norms[-1][1] < 0.5                  # the example's own check


def test_fair_federated_learning_matches_the_reference_example():
    ref = _reference_example("fair_federated_learning")
    from repro.core.problems import fair_federated_problem
    prob = fair_federated_problem(jax.random.PRNGKey(0), num_clients=8,
                                  hard_clients=2)
    lam_u, y_u = ref.train(prob, lr_x=0.0)
    lam_f, y_f = ref.train(prob, lr_x=2.0)
    want = {"uniform": prob.client_val_losses(jnp.zeros(8), y_u),
            "bilevel": prob.client_val_losses(lam_f, y_f),
            "weights": jax.nn.softmax(lam_f)}
    got = fair.run("cpu")
    for k, v in want.items():
        np.testing.assert_allclose(got[k], np.asarray(v), rtol=RTOL,
                                   err_msg=k)
    # the example's own checks: the worst client improves, the minority
    # (clients 0-1) is up-weighted
    assert got["bilevel"].max() < got["uniform"].max()
    assert got["weights"][:2].mean() > got["weights"][2:].mean()
