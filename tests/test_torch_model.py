"""The port's Mamba-2 model and hypergradient oracles against the JAX
package's, on mamba2-130m ``reduced()`` in f32 with the reference's own
initial parameters carried across by ``params_from_numpy``.  The sequence
(40 tokens, chunk 32) is padded to two SSD chunks, so the chunk padding and
the inter-chunk recurrence are both exercised.

Tolerances: logits and loss rtol 1e-5 (with atol 1e-5 of the largest logit
for entries near zero); the oracles rtol 1e-4, atol 1e-6 — the einsum
contraction order and the reductions differ between XLA and PyTorch."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import hypergrad as jhg  # noqa: E402
from repro.core.model_problem import make_model_bilevel as jbilevel  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import hypergrad as hg  # noqa: E402
from repro_torch.core.model_problem import make_model_bilevel  # noqa: E402
from repro_torch.core.tree_util import tree_leaves  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from torch_parity import f32, to_torch  # noqa: E402

torch.set_num_threads(1)

B, S = 2, 40


@pytest.fixture(scope="module")
def models():
    jm = jbuild(jget_config("mamba2-130m").reduced(), dtype=jnp.float32)
    tm = build_model(get_config("mamba2-130m").reduced(), dtype=torch.float32)
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, tm, jp, to_torch(jp)


def _batch(seed: int, vocab: int):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, vocab, (B, S)).astype(np.int32)
    lab = np.roll(tok, -1, axis=-1)
    lab[:, -3:] = -1                       # masked positions
    return ({"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)},
            {"tokens": torch.from_numpy(tok).long(),
             "labels": torch.from_numpy(lab).long()})


def test_init_tree_matches_reference_structure(models):
    jm, tm, jp, _ = models
    jl = jax.tree.leaves(jp)
    tl = tree_leaves(tm.init(torch.Generator().manual_seed(0)))
    assert [(a.shape, str(a.dtype)) for a in jl] == \
           [(tuple(b.shape), str(b.dtype).replace("torch.", "")) for b in tl]


def test_logits_and_loss_match_reference(models):
    jm, tm, jp, tp = models
    jb, tb = _batch(0, tm.cfg.vocab_size)
    jl, _ = jm.forward(jp, jb)
    tl, _ = tm.forward(tp, tb)
    jl = np.asarray(jl)
    np.testing.assert_allclose(f32(tl), jl, rtol=1e-5,
                               atol=1e-5 * np.abs(jl).max())
    np.testing.assert_allclose(float(tm.loss(tp, tb)[0]),
                               float(jm.loss(jp, jb)[0]), rtol=1e-5)


def test_fused_oracles_match_reference(models):
    jm, tm, jp, tp = models
    (jtr, ttr), (jva, tva) = _batch(1, tm.cfg.vocab_size), _batch(2, tm.cfg.vocab_size)
    jbatch, tbatch = {"train": jtr, "val": jva}, {"train": ttr, "val": tva}
    rng = np.random.default_rng(3)
    u = jax.tree.map(lambda a: jnp.asarray(
        0.1 * rng.standard_normal(a.shape).astype(np.float32)), jp["head"])
    jf, jg = jbilevel(jm, lower_l2=1e-2, remat=False)
    tf, tg = make_model_bilevel(tm, lower_l2=1e-2)
    jout = jax.jit(lambda x, y, uu, b: jhg.fused_oracles(jg, jf, x, y, uu, b))(
        jp["body"], jp["head"], u, jbatch)
    tout = hg.fused_oracles(tg, tf, tp["body"], tp["head"], to_torch(u), tbatch)
    # the plain gradients: ∇_y g is ω; ∇_x f against the reference's
    jfx = jhg.grad_x(jf, jp["body"], jp["head"], jbatch)
    tfx = hg.grad_x(tf, tp["body"], tp["head"], tbatch)
    tgy = hg.grad_y(tg, tp["body"], tp["head"], tbatch)
    for a, b in zip(jax.tree.leaves(jfx), tree_leaves(tfx)):
        np.testing.assert_allclose(f32(b), np.asarray(a), rtol=1e-4, atol=1e-6)
    for a, b in zip(tree_leaves(tout[0]), tree_leaves(tgy)):
        np.testing.assert_allclose(f32(b), f32(a), rtol=1e-5, atol=1e-7)
    for name, ja, ta in zip(("omega", "mu", "p"), jout, tout):
        jl, tl = jax.tree.leaves(ja), tree_leaves(ta)
        assert len(jl) == len(tl), name
        for a, b in zip(jl, tl):
            np.testing.assert_allclose(f32(b), np.asarray(a), rtol=1e-4,
                                       atol=1e-6, err_msg=name)


def test_fused_local_oracles_match_reference(models):
    """ω and the Neumann hyper-gradient Φ (Q = 2 HVPs, τ 0.5, as the
    committed specs set them), within the tolerances of the global-lower
    oracles above."""
    jm, tm, jp, tp = models
    (jtr, ttr), (jva, tva) = _batch(4, tm.cfg.vocab_size), _batch(5, tm.cfg.vocab_size)
    jbatch, tbatch = {"train": jtr, "val": jva}, {"train": ttr, "val": tva}
    jf, jg = jbilevel(jm, lower_l2=1e-2, remat=False)
    tf, tg = make_model_bilevel(tm, lower_l2=1e-2)
    jout = jax.jit(lambda x, y, b: jhg.fused_local_oracles(jg, jf, x, y, b,
                                                           2, 0.5))(
        jp["body"], jp["head"], jbatch)
    tout = hg.fused_local_oracles(tg, tf, tp["body"], tp["head"], tbatch,
                                  2, 0.5)
    # the series alone: one HVP against the reference's
    rng = np.random.default_rng(6)
    v = jax.tree.map(lambda a: jnp.asarray(
        0.1 * rng.standard_normal(a.shape).astype(np.float32)), jp["head"])
    jh = jhg.hvp_yy(jg, jp["body"], jp["head"], jbatch, v)
    th = hg.hvp_yy(tg, tp["body"], tp["head"], tbatch, to_torch(v))
    for a, b in zip(jax.tree.leaves(jh), tree_leaves(th)):
        np.testing.assert_allclose(f32(b), np.asarray(a), rtol=1e-4, atol=1e-6)
    for name, ja, ta in zip(("omega", "phi"), jout, tout):
        jl, tl = jax.tree.leaves(ja), tree_leaves(ta)
        assert len(jl) == len(tl), name
        for a, b in zip(jl, tl):
            np.testing.assert_allclose(f32(b), np.asarray(a), rtol=1e-4,
                                       atol=1e-6, err_msg=name)
