"""The port's plain-SGD and heavy-ball kernels (``sgd3_step``,
``momsgd3_step``) and their flat-substrate launches against the JAX
package's.

On the CPU the wrappers run their plain PyTorch versions, over two clients'
client-major buffers with a 256-element tile, for f32 and bf16 variables:

* bit for bit against the JAX ``ref.py`` functions run op by op;
* against ``sgd3_step_flat`` / ``momsgd3_step_flat`` run in interpret mode,
  where XLA's CPU backend contracts each multiply-add under ``jit`` into one
  FMA.  For ``sgd3``'s ``p' = p − lr·g`` and ``momsgd3``'s
  ``m' = β·m + g`` the bound is one rounding of the product plus one ulp of
  the result (``torch_parity.contraction_tol``).  ``momsgd3``'s
  ``p' = p − lr·m'`` is computed from ``m'``, which already differs by up
  to that bound δ_m; so its bound is one rounding of ``lr·m'`` plus one ulp
  of ``p'`` plus ``|lr|·δ_m``, elementwise.

``flat.sgd_step`` / ``flat.momentum_sgd_step`` are held to the reference's
(which run its jitted jnp lowerings off the TPU) within the same bounds."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels.storm import kernel as jk  # noqa: E402
from repro.kernels.storm import ref as jref  # noqa: E402
from repro.optim import flat as jflat  # noqa: E402
from repro_torch.kernels.storm import kernel as tk  # noqa: E402
from repro_torch.kernels.storm import ref as tref  # noqa: E402
from repro_torch.optim import flat as tflat  # noqa: E402
from torch_parity import (assert_contraction_close, bits,  # noqa: E402
                          contraction_tol, to_torch)

torch.set_num_threads(1)

M, TILES, BLOCK = 2, 3, 256          # two clients' [M·N] buffers, 6 tiles


def _inputs(seed: int, p_dtype: str):
    """(jax, torch) tuples of (p, m, g, lrs, betas) from one numpy draw."""
    rng = np.random.default_rng(seed)
    n = M * TILES * BLOCK
    p, m, g = (rng.standard_normal(n).astype(np.float32) for _ in range(3))
    lrs = rng.uniform(0.0, 0.2, M * TILES).astype(np.float32)
    betas = rng.uniform(0.5, 1.0, M * TILES).astype(np.float32)
    jp = jnp.asarray(p).astype(p_dtype)
    tp = torch.from_numpy(p).to(getattr(torch, p_dtype))
    jax_in = (jp, *(jnp.asarray(a) for a in (m, g, lrs, betas)))
    torch_in = (tp, *(torch.from_numpy(a) for a in (m, g, lrs, betas)))
    return jax_in, torch_in


def _per_elem(table, block=BLOCK):
    return torch.repeat_interleave(table, block)


def assert_momsgd_close(out, fused, p_in, m_in, g_in, lr, beta):
    """``(p', m')`` of the op-by-op version against the contracted one,
    within the bounds the module docstring derives."""
    m_new = beta * m_in + g_in
    assert_contraction_close(out[1], fused[1], beta * m_in)
    carried = np.abs(lr.numpy()) * contraction_tol(out[1], beta * m_in)
    assert_contraction_close(out[0], fused[0], lr * m_new, carried)
    assert out[0].dtype == p_in.dtype and out[1].dtype == torch.float32


@pytest.mark.parametrize("p_dtype", ["float32", "bfloat16"])
def test_sgd3_step_vs_ref_and_pallas(p_dtype):
    (jp, _, jg, jl, _), (tp, _, tg, tl, _) = _inputs(0, p_dtype)
    out = tk.sgd3_step(tp, tg, tl, block=BLOCK)
    assert isinstance(out, torch.Tensor) and out.dtype == tp.dtype
    np.testing.assert_array_equal(bits(out),
                                  bits(jref.sgd3_step_ref(jp, jg, jl, BLOCK)))
    np.testing.assert_array_equal(bits(out),
                                  bits(tref.sgd3_step_ref(tp, tg, tl, BLOCK)))
    pallas = jk.sgd3_step_flat(jp, jg, jl, block=BLOCK, interpret=True)
    assert_contraction_close(out, pallas, _per_elem(tl) * tg)


@pytest.mark.parametrize("p_dtype", ["float32", "bfloat16"])
def test_momsgd3_step_vs_ref_and_pallas(p_dtype):
    (jp, jm, jg, jl, jb), (tp, tm, tg, tl, tb) = _inputs(1, p_dtype)
    out = tk.momsgd3_step(tp, tm, tg, tl, tb, block=BLOCK)
    for o, r in zip(out, jref.momsgd3_step_ref(jp, jm, jg, jl, jb, BLOCK)):
        np.testing.assert_array_equal(bits(o), bits(r))
    for o, r in zip(out, tref.momsgd3_step_ref(tp, tm, tg, tl, tb, BLOCK)):
        np.testing.assert_array_equal(bits(o), bits(r))
    pallas = jk.momsgd3_step_flat(jp, jm, jg, jl, jb, block=BLOCK,
                                  interpret=True)
    assert_momsgd_close(out, pallas, tp, tm, tg, _per_elem(tl),
                        _per_elem(tb))


def test_wrappers_count_calls_and_reject_bad_shapes():
    _, (tp, tm, tg, tl, tb) = _inputs(2, "float32")
    tk.reset_counts()
    tk.sgd3_step(tp, tg, tl, block=BLOCK)
    tk.momsgd3_step(tp, tm, tg, tl, tb, block=BLOCK)
    tk.momsgd3_step(tp, tm, tg, tl, tb, block=BLOCK)
    # CPU tensors take the plain versions: calls count, launches do not
    assert (tk.CALLS["sgd3_step"], tk.CALLS["momsgd3_step"]) == (1, 2)
    assert tk.CALLS["storm3_step"] == tk.CALLS["storm3_update"] == 0
    assert not any(tk.LAUNCHES.values())
    with pytest.raises(ValueError, match="multiple of block"):
        tk.sgd3_step(tp[:-1], tg[:-1], tl, block=BLOCK)
    with pytest.raises(ValueError, match="differ in length"):
        tk.momsgd3_step(tp, tm[:-BLOCK], tg, tl, tb, block=BLOCK)
    with pytest.raises(ValueError, match="tables need"):
        tk.momsgd3_step(tp, tm, tg, tl, tb[:-1], block=BLOCK)
    with pytest.raises(ValueError, match="flat"):
        tk.sgd3_step(tp.reshape(M, -1), tg.reshape(M, -1), tl, block=BLOCK)


# ---------------------------------------------------------------------------
# the flat substrate's launches
# ---------------------------------------------------------------------------

SECTIONS, FBLOCK, FM = ("x", "y", "u"), 16, 3


def _flat_case(seed: int):
    """A mixed bf16/f32 x|y|u tree with [FM, ...] leaves in both layouts,
    and f32 momentum / gradient buffers of its shape."""
    rng = np.random.default_rng(seed)
    n = lambda *s, dt="float32": jnp.asarray(  # noqa: E731
        rng.standard_normal((FM,) + s).astype(np.float32)).astype(dt)
    tree = {"x": {"w": n(5, 7, dt="bfloat16"), "b": n(3)},
            "y": {"w": n(6, dt="bfloat16")},
            "u": {"w": n(6, dt="bfloat16"), "s": n(9)}}
    tmpl = jax.tree.map(lambda a: a[0], tree)
    jspec = jflat.make_spec(tmpl, sections=SECTIONS, block=FBLOCK)
    tspec = tflat.make_spec(to_torch(tmpl), sections=SECTIONS, block=FBLOCK)
    jv = jflat.flatten_tree(jspec, tree, batch_dims=1)
    jm, jg = (tuple(jnp.asarray(rng.standard_normal(b.shape)
                                .astype(np.float32)) for b in jv)
              for _ in range(2))
    tv, tm, tg = (tuple(to_torch(list(b))) for b in (jv, jm, jg))
    return jspec, tspec, (jv, jm, jg), (tv, tm, tg)


def _tables(values):
    return ([jnp.float32(v) for v in values],
            [torch.tensor(v, dtype=torch.float32) for v in values])


def _per_section(table, grp):
    """The per-element value of a section table over one client row."""
    return torch.stack(table)[grp.section_ids].repeat_interleave(FBLOCK)


def test_flat_sgd_step_matches_reference():
    jspec, tspec, (jv, _, jg), (tv, _, tg) = _flat_case(3)
    jl, tl = _tables((0.1, 0.2, 0.3))
    tk.reset_counts()
    out = tflat.sgd_step(tspec, tv, tg, tl)
    assert tk.CALLS["sgd3_step"] == len(tspec.groups) == 2
    ref = jflat.sgd_step(jspec, jv, jg, jl)
    for g, grp in enumerate(tspec.groups):
        assert out[g].shape == tv[g].shape and out[g].dtype == tv[g].dtype
        assert_contraction_close(out[g], ref[g],
                                 _per_section(tl, grp) * tg[g])


def test_flat_momentum_sgd_step_matches_reference():
    jspec, tspec, (jv, jm, jg), (tv, tm, tg) = _flat_case(4)
    jl, tl = _tables((0.1, 0.2, 0.3))
    jb, tb = _tables((0.9, 0.8, 0.7))
    tk.reset_counts()
    out_v, out_m = tflat.momentum_sgd_step(tspec, tv, tm, tg, tl, tb)
    assert tk.CALLS["momsgd3_step"] == len(tspec.groups) == 2
    ref_v, ref_m = jflat.momentum_sgd_step(jspec, jv, jm, jg, jl, jb)
    for g, grp in enumerate(tspec.groups):
        assert_momsgd_close((out_v[g], out_m[g]), (ref_v[g], ref_m[g]),
                            tv[g], tm[g], tg[g], _per_section(tl, grp),
                            _per_section(tb, grp))
