"""The port's federated evaluation (``repro_torch.federation.evaluate``) and
pytree optimizers (``repro_torch.optim.optimizers``) against the
reference's.

* ``tests/test_evaluate.py`` restated: perplexity and the Eq. (5)
  personalisation gain on FedBiO-Local's tree path (3 clients, reduced
  Mamba-2, 16 steps; the reference test's initial state and batches handed
  across through numpy, since its claims hold for its draws), and
  ``perplexity`` = exp(loss) on granite-8b; FedAvg's state (``params``) on
  the port's own stream.
* ``eval_federated`` held to the reference's on the same tree states,
  handed across through numpy: FedBiOAcc-Local's initial state (private
  heads) on the reduced Mamba-2 and the reference's validation batch; each
  figure within rtol 1e-5 (the forward's f32 sums run in other orders).
* ``tests/test_substrate.py:42-43`` restated (``sgd``, ``momentum``,
  ``adam`` minimise a quadratic), and each optimizer's updates over 5
  steps of a seeded tree against the reference's, within rtol 1e-6 (Adam's
  bias corrections take f32 powers, which XLA and torch may round an ulp
  apart)."""
import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro_torch import optim  # noqa: E402
from repro_torch.config import FederatedConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.tree_util import tree_map, tree_sqnorm  # noqa: E402
from repro_torch.data.synthetic import make_fed_batch_fn  # noqa: E402
from repro_torch.federation import trainer  # noqa: E402
from repro_torch.federation.evaluate import (eval_federated,  # noqa: E402
                                             perplexity)
from repro_torch.models.registry import build_model  # noqa: E402
from torch_parity import f32, to_torch  # noqa: E402

torch.set_num_threads(1)

EVAL_RTOL = 1e-5
OPT_RTOL = 1e-6


def test_eval_federated_and_personalisation():
    """The reference test's run, its initial state and 16 batches handed
    across (its key 0): the claims hold for its draws, and hold on the
    port alike (the claims depend on the draws: the reference's own run at
    keys 1 and 2 ends with gains of -0.0376 and -0.0854)."""
    from repro.configs import ARCHS
    from repro.data import make_fed_batch_fn as ref_batch_fn
    from repro.federation.trainer import \
        make_fedbio_local_train_step as ref_maker
    from repro.models import build_model as ref_build_model

    jcfg = ARCHS["mamba2-130m"].reduced()
    M = 3
    fed = FederatedConfig(num_clients=M, local_steps=2, lr_x=0.02, lr_y=0.3,
                          neumann_q=3, neumann_tau=0.3)
    rng = jax.random.PRNGKey(0)
    jinit, _ = ref_maker(ref_build_model(jcfg, dtype=jnp.float32), fed,
                         n_micro=1, remat=False)
    jbf = ref_batch_fn(jcfg, num_clients=M, per_client=2, seq_len=32,
                       hetero_alpha=0.1)
    model = build_model(get_config("mamba2-130m").reduced(),
                        dtype=torch.float32)
    init, step = trainer.make_fedbio_local_train_step(model, fed, n_micro=1,
                                                      remat=False)
    state = trainer.FedBiOTrainState(
        **{f: int(v) if f == "step" else to_torch(v)
           for f, v in jinit(rng)._asdict().items()})
    val = to_torch(jbf(jax.random.PRNGKey(9)))
    out0 = eval_federated(model, state, lambda gen: val, torch.Generator(),
                          num_clients=M)
    assert out0["perplexity_mean"] > 1.0
    assert len(out0["val_loss_per_client"]) == M

    key = rng
    for _ in range(16):
        key, sub = jax.random.split(key)
        state, _ = step(state, to_torch(jbf(sub)))
    out = eval_federated(model, state, lambda gen: val, torch.Generator(),
                         num_clients=M)
    assert out["val_loss_mean"] < out0["val_loss_mean"]
    # trained private heads should not be worse than the averaged head
    assert out["personalisation_gain_mean"] > -1e-3, out


def test_eval_federated_runs_on_the_ports_stream():
    cfg = get_config("mamba2-130m").reduced()
    model = build_model(cfg, dtype=torch.float32)
    fed = FederatedConfig(num_clients=3, local_steps=2)
    init, _ = trainer.make_fedavg_train_step(model, fed, n_micro=1,
                                             remat=False)
    bf = make_fed_batch_fn(cfg, num_clients=3, per_client=2, seq_len=32)
    out = eval_federated(model, init(torch.Generator().manual_seed(0)), bf,
                         torch.Generator().manual_seed(9), num_clients=3)
    assert np.isfinite(out["val_loss_mean"]) and out["perplexity_mean"] > 1
    # FedAvg's heads are averaged: the gain is zero up to rounding
    assert abs(out["personalisation_gain_mean"]) < 1e-5


def test_perplexity_matches_loss():
    cfg = get_config("granite-8b").reduced()
    model = build_model(cfg, dtype=torch.float32)
    p = model.init(torch.Generator().manual_seed(0))
    bf = make_fed_batch_fn(cfg, num_clients=1, per_client=2, seq_len=16)
    b = tree_map(lambda v: v[0], bf(torch.Generator().manual_seed(0))["val"])
    loss, _ = model.loss(p, b)
    ppl = perplexity(model, p["body"], p["head"], b)
    assert abs(ppl - float(torch.exp(loss))) < 1e-2 * ppl


def test_eval_federated_matches_the_reference_on_its_state():
    from repro.configs import ARCHS
    from repro.data import make_fed_batch_fn as ref_batch_fn
    from repro.federation import evaluate as ref_eval
    from repro.federation.trainer import (
        make_fedbioacc_local_train_step as ref_maker)
    from repro.models import build_model as ref_build_model

    M = 4
    jcfg = ARCHS["mamba2-130m"].reduced()
    jmodel = ref_build_model(jcfg, dtype=jnp.float32)
    fed = FederatedConfig(num_clients=M, local_steps=2, lr_x=0.02, lr_y=0.3,
                          neumann_q=2, neumann_tau=0.3)
    jinit, _ = ref_maker(jmodel, fed, n_micro=1, remat=False)
    jstate = jinit(jax.random.PRNGKey(0))
    jbf = ref_batch_fn(jcfg, num_clients=M, per_client=2, seq_len=32,
                       hetero_alpha=0.1)
    key = jax.random.PRNGKey(9)
    want = ref_eval.eval_federated(jmodel, jstate, jbf, key, num_clients=M)
    # heads are private: the reference's clients' heads differ
    assert float(jnp.std(jax.tree.leaves(jstate.y)[0], axis=0).max()) > 0

    model = build_model(get_config("mamba2-130m").reduced(),
                        dtype=torch.float32)
    state = trainer.FedBiOAccLocalTrainState(
        **{f: int(v) if f == "step" else to_torch(v)
           for f, v in jstate._asdict().items()})
    batch = to_torch(jbf(key))
    got = eval_federated(model, state, lambda gen: batch,
                         torch.Generator(), num_clients=M)
    for k in ("val_loss_mean", "perplexity_mean"):
        np.testing.assert_allclose(got[k], want[k], rtol=EVAL_RTOL,
                                   err_msg=k)
    # rounded to 4 decimals on both sides: one step of that rounding
    np.testing.assert_allclose(got["val_loss_per_client"],
                               want["val_loss_per_client"], atol=1.5e-4)
    # a difference of two losses: held to the losses' rounding
    assert abs(got["personalisation_gain_mean"]
               - want["personalisation_gain_mean"]) <= \
        2 * EVAL_RTOL * want["val_loss_mean"]


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["sgd", "momentum", "adam"])
def test_optimizers_minimize_quadratic(name):
    opt_init, opt_update = getattr(optim, name)()
    params = {"x": torch.tensor([3.0, -2.0])}
    state = opt_init(params)
    for _ in range(200):
        grads = tree_map(lambda v: 2 * v, params)
        params, state = opt_update(params, grads, state, 0.05)
    assert float(tree_sqnorm(params)) < 1e-3


@pytest.mark.parametrize("name,kw", [
    ("sgd", {}), ("momentum", {}), ("momentum", {"nesterov": True}),
    ("adam", {})])
def test_optimizer_updates_match_the_reference(name, kw):
    from repro import optim as ref_optim
    rng = np.random.default_rng(3)
    tree = {"a": rng.standard_normal((4, 5)).astype(np.float32),
            "b": {"c": rng.standard_normal(7).astype(np.float32)}}
    grads = [{"a": rng.standard_normal((4, 5)).astype(np.float32),
              "b": {"c": rng.standard_normal(7).astype(np.float32)}}
             for _ in range(5)]
    j_init, j_update = getattr(ref_optim, name)(**kw)
    t_init, t_update = getattr(optim, name)(**kw)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = tree_map(torch.from_numpy, tree)
    js, ts = j_init(jp), t_init(tp)
    for g in grads:
        jp, js = j_update(jp, jax.tree.map(jnp.asarray, g), js, 0.05)
        tp, ts = t_update(tp, tree_map(torch.from_numpy, g), ts, 0.05)
        for jl, tl in zip(jax.tree.leaves(jp), jax.tree.leaves(
                tree_map(f32, tp))):
            np.testing.assert_allclose(tl, np.asarray(jl), rtol=OPT_RTOL,
                                       atol=1e-7)
