"""Rematerialisation and microbatching (``execution.remat``,
``execution.n_micro``) on both paths.

``models.stack.rematerialize`` is an ``autograd.Function`` that keeps its
inputs only and recomputes its function for each derivative (``grad``,
``jvp`` of ``grad``, ``grad`` of ``grad``).  The recomputation repeats the
same operations, so remat on and off agree bit for bit under ``grad`` and
under the fused oracles' forward over reverse, for a toy unit and for a
dense, a MoE and an ssm unit.  Under reverse over reverse (the unfused
oracles' ``jvp_xy``) the second gradient can take a weight's cotangents
from the unit's output and from its recomputation as two products, where
without remat one product takes their sum: there the two agree within a
bound (1e-12 of each leaf's largest magnitude for the f64 toy, 2^-20 in
f32 for the model units; the reduced dense and MoE units measured bit for
bit, the ssm unit within 3 f32 ulps of the largest).

Remat frees what it recomputes under ``torch.func``: a subprocess's peak
under the oracles' ``jvp`` of ``grad`` through 12 units stays below 0.7
of the plain peak (the backward's recomputation goes unrecorded where no
transform below differentiates it, ``models.stack._recorded``).

``core.model_problem._microbatch_mean`` is held to the reference's (the
losses, ``g``'s gradient and the fused oracles at ``n_micro`` 2 with
remat); ``fedbioacc.json`` with ``n_micro`` 2 and remat builds and steps
on both paths, the fused step bit for bit its remat-free one.
(``tests/test_torch_oracle_memory.py`` runs the oracles through remat,
the factories' default, on the flat buffers' views.)"""
import dataclasses
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from torch.func import grad, jvp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import hypergrad as jhg  # noqa: E402
from repro.core.model_problem import make_model_bilevel as jbilevel  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro_torch.api import Experiment, build  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import hypergrad as hg  # noqa: E402
from repro_torch.core import model_problem as mp  # noqa: E402
from repro_torch.core.tree_util import tree_leaves, tree_map  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.models.stack import rematerialize  # noqa: E402
from torch_parity import bits, f32, to_torch  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert (bits(x) == bits(y)).all()


def _unit(h, p):
    """A toy unit with a tuple output: its activation and an aux loss."""
    z = torch.tanh(h @ p["w1"]) * p["s"]
    return torch.tanh(z @ p["w2"]) + h, torch.sum(z * z)


def _loss(unit):
    def loss(p, q, h):
        for layer in (p, q):
            h, aux = unit(h, layer)
        return torch.sum(torch.sin(h)) + 0.1 * aux
    return loss


def test_remat_function_matches_plain_unit_under_transforms():
    """The Function under ``grad`` and ``jvp`` of ``grad`` against the
    plain unit, f64, bit for bit, and under ``grad`` of ``grad`` within
    1e-12 of each leaf's largest magnitude; nested (a remat'd body of
    remat'd units, as ``n_micro`` > 1 with remat nests them) too."""
    gen = torch.Generator().manual_seed(0)

    def layer():
        # keys in sorted order, as the tree utilities rebuild dicts
        return {"s": torch.randn(5, generator=gen, dtype=torch.float64),
                "w1": torch.randn(6, 5, generator=gen, dtype=torch.float64),
                "w2": torch.randn(5, 6, generator=gen, dtype=torch.float64)}

    p, q = layer(), layer()
    h = torch.randn(3, 6, generator=gen, dtype=torch.float64)
    t = tree_map(lambda v: torch.randn(v.shape, generator=gen,
                                       dtype=v.dtype), q)
    plain = _loss(_unit)
    remat = _loss(lambda hh, pp: rematerialize(_unit, hh, pp))

    def nested(pp, qq, hh):
        return rematerialize(remat, pp, qq, hh)

    out = {}
    for name, fn in (("plain", plain), ("remat", remat), ("nested", nested)):
        g = grad(fn, argnums=(0, 1))(p, q, h)
        fwd = jvp(lambda a, b: grad(fn, argnums=(0, 1))(a, b, h), (p, q),
                  (tree_map(torch.zeros_like, p), t))
        rr = grad(lambda a: sum(torch.sum(x * y) for x, y in zip(
            tree_leaves(grad(fn, argnums=1)(a, q, h)), tree_leaves(t))))(p)
        out[name] = (fn(p, q, h), g, fwd, rr)
    for name in ("remat", "nested"):
        _equal(out["plain"][:3], out[name][:3])
        for a, b in zip(tree_leaves(out["plain"][3]),
                        tree_leaves(out[name][3])):
            assert float((a - b).abs().max()) <= 1e-12 * float(
                a.abs().max())


@pytest.mark.parametrize("arch,kind", [("granite-8b", "dense"),
                                       ("granite-moe-1b-a400m", "moe"),
                                       ("mamba2-130m", "ssm")])
def test_remat_units_bit_for_bit(arch, kind):
    """``model.loss`` of a reduced model with remat on and off: the
    gradient and the fused oracles' forward over reverse bit for bit; the
    unfused ``jvp_xy`` (reverse over reverse) bit for bit for the dense
    and MoE units, within 2^-20 of each leaf's largest magnitude for the
    ssm unit, where at most two of its leaves differ (see the module
    docstring)."""
    cfg = get_config(arch).reduced()
    model = build_model(cfg, dtype=torch.float32)
    p = model.init(torch.Generator().manual_seed(0))
    tok = torch.randint(0, cfg.vocab_size, (2, 16),
                        generator=torch.Generator().manual_seed(1))
    b = {"tokens": tok, "labels": torch.roll(tok, -1, -1)}
    x, y = p["body"], p["head"]
    u = tree_map(lambda v: 0.01 * torch.ones_like(v), y)
    out = {}
    for remat in (False, True):
        def g(xx, yy, batch, remat=remat):
            return model.loss({"body": xx, "head": yy}, batch,
                              remat=remat)[0]
        out[remat] = (grad(g, argnums=(0, 1))(x, y, b),
                      hg.fused_g_oracles(g, x, y, b, u),
                      hg.jvp_xy(g, x, y, b, u))
    _equal(out[False][:2], out[True][:2])
    if kind != "ssm":
        _equal(out[False][2], out[True][2])
        return
    differ = 0
    for a, c in zip(tree_leaves(out[False][2]), tree_leaves(out[True][2])):
        assert float((a - c).abs().max()) <= 2.0 ** -20 * float(
            a.abs().max())
        differ += int(not (bits(a) == bits(c)).all())
    assert differ <= 2


@pytest.fixture(scope="module")
def models():
    jm = jbuild(jget_config("mamba2-130m").reduced(), dtype=jnp.float32)
    tm = build_model(get_config("mamba2-130m").reduced(), dtype=torch.float32)
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, tm, jp, to_torch(jp)


def _batch(seed: int, vocab: int, n: int = 4, s: int = 24):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, vocab, (n, s)).astype(np.int32)
    lab = np.roll(tok, -1, axis=-1)
    lab[:, -3:] = -1
    return ({"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)},
            {"tokens": torch.from_numpy(tok).long(),
             "labels": torch.from_numpy(lab).long()})


def test_microbatch_mean_matches_reference(models):
    """``n_micro`` 2 with remat: f, g, ∇_y g and the three fused oracle
    directions against the reference's (its ``_microbatch_mean``: a scan
    of a checkpointed body), within the tolerances of
    ``tests/test_torch_model.py``."""
    jm, tm, jp, tp = models
    (jtr, ttr), (jva, tva) = (_batch(1, tm.cfg.vocab_size),
                              _batch(2, tm.cfg.vocab_size))
    jbatch, tbatch = {"train": jtr, "val": jva}, {"train": ttr, "val": tva}
    rng = np.random.default_rng(3)
    u = jax.tree.map(lambda a: jnp.asarray(
        0.1 * rng.standard_normal(a.shape).astype(np.float32)), jp["head"])
    jf, jg = jbilevel(jm, lower_l2=1e-2, n_micro=2, remat=True)
    tf, tg = mp.make_model_bilevel(tm, lower_l2=1e-2, n_micro=2, remat=True)
    for jfn, tfn in ((jf, tf), (jg, tg)):
        np.testing.assert_allclose(
            float(tfn(tp["body"], tp["head"], tbatch)),
            float(jax.jit(jfn)(jp["body"], jp["head"], jbatch)), rtol=1e-5)
    jout = jax.jit(lambda x, y, uu, bb: jhg.fused_oracles(
        jg, jf, x, y, uu, bb))(jp["body"], jp["head"], u, jbatch)
    tout = hg.fused_oracles(tg, tf, tp["body"], tp["head"], to_torch(u),
                            tbatch)
    for name, ja, ta in zip(("omega", "mu", "p"), jout, tout):
        jl, tl = jax.tree.leaves(ja), tree_leaves(ta)
        assert len(jl) == len(tl), name
        for a, b in zip(jl, tl):
            np.testing.assert_allclose(f32(b), np.asarray(a), rtol=1e-4,
                                       atol=1e-6, err_msg=name)


def test_microbatch_mean_is_the_plain_mean(models):
    """The microbatches' losses summed from an f32 zero in order and
    multiplied by f32(1/n): the value and its gradient bit for bit those
    of the plain expression (no remat), for n 2 and 4."""
    _, tm, _, tp = models
    _, tb = _batch(4, tm.cfg.vocab_size)

    def one(p, mb):
        return tm.loss(p, mb)[0].to(torch.float32)

    for n in (2, 4):
        def plain(p, n=n):
            total = torch.zeros((), dtype=torch.float32)
            for i in range(n):
                k = tb["tokens"].shape[0] // n
                total = total + one(p, {kk: v[i * k:(i + 1) * k]
                                        for kk, v in tb.items()})
            return total * torch.tensor(1.0 / n, dtype=torch.float32)

        def micro(p, n=n):
            return mp._microbatch_mean(one, p, tb, n)

        _equal((plain(tp), grad(plain)(tp)), (micro(tp), grad(micro)(tp)))


@pytest.mark.parametrize("fuse", [True, False])
def test_n_micro_and_remat_build_and_step(fuse):
    """``fedbioacc.json`` with ``n_micro`` 2, remat and 2 sequences a
    client builds and steps on both paths; the fused step's buffers bit
    for bit those of the same step without remat, the unfused step's
    state within rtol 1e-4 / atol 1e-5 of the fused one's view."""
    exp = Experiment.load(str(ROOT / "experiments" / "fedbioacc.json")).edit(
        **{"execution.n_micro": 2, "execution.remat": True,
           "problem.per_client": 2, "schedule.steps": 1})
    finals = {}
    for name, edits in (("remat", {"execution.fuse_storm": fuse}),
                        ("plain", {"execution.fuse_storm": True,
                                   "execution.remat": False})):
        run = build(exp.edit(**edits), device="cpu")
        state = run.init(torch.Generator().manual_seed(0))
        state, metrics = run.step(state, run.batch_fn(
            torch.Generator().manual_seed(1)))
        assert metrics["step"] == 1 and np.isfinite(run.eval_fn(state))
        finals[name] = (state, run.views(state))
    if fuse:
        _equal(finals["remat"][0].vars + finals["remat"][0].mom,
               finals["plain"][0].vars + finals["plain"][0].mom)
        return
    got, want = finals["remat"][1], finals["plain"][1]
    for n in ("x", "y", "u", "omega", "nu", "q"):
        for a, b in zip(tree_leaves(getattr(got, n)),
                        tree_leaves(getattr(want, n))):
            np.testing.assert_allclose(a.numpy(), b.float().numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=n)


_PEAK_PROBE = """
import sys, torch
torch.set_num_threads(1)
def hwm():
    # this process's own high-water mark (getrusage's maximum also holds
    # what the process had before exec: the forked test worker's)
    with open("/proc/self/status") as fh:
        return next(int(ln.split()[1]) for ln in fh
                    if ln.startswith("VmHWM"))
from repro_torch.models.stack import rematerialize
remat = sys.argv[1] == "1"
def unit(h, w):
    return h + torch.tanh(torch.tanh(h[:, :, None] * w[None]).sum(-1))
def loss(ws, h):
    for w in ws:
        h = rematerialize(unit, h, w) if remat else unit(h, w)
    return h.sum()
ws = [0.01 * torch.randn(64, 64) for _ in range(12)]
h = torch.randn(128, 64)
before = hwm()
torch.func.jvp(lambda a: torch.func.grad(loss)(a, h), (ws,),
               ([torch.ones_like(w) for w in ws],))
print(hwm() - before)
"""


def test_remat_frees_activations_under_forward_over_reverse():
    """The oracles' ``jvp`` of ``grad`` through 12 units, each with a 2 MB
    transient, in a fresh process: remat's peak (growth of the resident
    set's high-water mark) below 0.7 of the plain one's (measured
    0.44-0.49; ~1.0 when the backward's recomputation stays recorded at
    its level)."""
    import os
    import subprocess
    import sys
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    peak = [int(subprocess.run(
        [sys.executable, "-c", _PEAK_PROBE, flag], capture_output=True,
        text=True, check=True, env=env, timeout=300).stdout.split()[-1])
        for flag in ("0", "1")]
    assert peak[1] < 0.7 * peak[0], peak


def test_remat_refuses_caches():
    cfg = dataclasses.replace(get_config("granite-8b").reduced(),
                              num_layers=1)
    model = build_model(cfg, dtype=torch.float32)
    p = model.init(torch.Generator().manual_seed(0))
    from repro_torch.models import stack
    with pytest.raises(ValueError, match="without caches"):
        stack.apply_stack(p["body"]["stages"], torch.zeros(1, 2, cfg.d_model),
                          cfg, caches=model.init_cache(1, 4), remat=True)
