"""The port's flat substrate against the JAX package's
(``repro/optim/flat.py``): the same mixed bf16/f32 x|y|u tree gives the same
layout and bit-identical buffers, unflattening round-trips, the fused
launches with their per-tile tables agree (within one rounding of the
multiply-add that XLA contracts on the CPU), and the section-masked client
mean agrees bit for bit."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.optim import flat as jflat  # noqa: E402
from repro_torch.core.tree_util import tree_leaves  # noqa: E402
from repro_torch.optim import flat as tflat  # noqa: E402
from torch_parity import assert_contraction_close, bits, to_torch  # noqa: E402

torch.set_num_threads(1)

SECTIONS, BLOCK, M = ("x", "y", "u"), 16, 3


def _tree(seed: int):
    """[M, ...] leaves; dict keys deliberately out of sorted order, so a
    flatten that kept insertion order would misplace them."""
    rng = np.random.default_rng(seed)
    n = lambda *s, dt="float32": jnp.asarray(  # noqa: E731
        rng.standard_normal((M,) + s).astype(np.float32)).astype(dt)
    return {"x": {"w": n(5, 7, dt="bfloat16"), "b": n(3),
                  "stages": [{"z": n(4, dt="bfloat16"), "a": n(2, 2)}]},
            "y": {"w": n(6, dt="bfloat16")},
            "u": {"w": n(6, dt="bfloat16"), "s": n(9)}}


def _specs(tree):
    tmpl = jax.tree.map(lambda a: a[0], tree)
    jspec = jflat.make_spec(tmpl, sections=SECTIONS, block=BLOCK)
    tspec = tflat.make_spec(to_torch(tmpl), sections=SECTIONS, block=BLOCK)
    return jspec, tspec


def test_layout_and_buffers_match_reference_bitwise():
    tree = _tree(0)
    jspec, tspec = _specs(tree)
    assert len(jspec.groups) == len(tspec.groups) == 2
    for jg, tg in zip(jspec.groups, tspec.groups):
        assert str(jg.dtype) == str(tg.dtype).replace("torch.", "")
        assert jg.padded == tg.padded and jg.extents == tg.extents
        assert [tuple(lf) for lf in jg.leaves] == [tuple(lf) for lf in tg.leaves]
        np.testing.assert_array_equal(np.asarray(jg.section_ids),
                                      tg.section_ids.numpy())
    jbufs = jflat.flatten_tree(jspec, tree, batch_dims=1)
    tbufs = tflat.flatten_tree(tspec, to_torch(tree), batch_dims=1)
    for jb, tb in zip(jbufs, tbufs):
        assert tuple(jb.shape) == tuple(tb.shape)
        np.testing.assert_array_equal(bits(tb), bits(jb))
    # f32 override (momenta / gradients): same layout, widened values
    jb32 = jflat.flatten_tree(jspec, tree, batch_dims=1, dtype=jnp.float32)
    tb32 = tflat.flatten_tree(tspec, to_torch(tree), batch_dims=1,
                              dtype=torch.float32)
    for jb, tb in zip(jb32, tb32):
        np.testing.assert_array_equal(bits(tb), bits(jb))


def test_roundtrip_is_exact_and_padding_zero():
    tree = to_torch(_tree(1))
    _, tspec = _specs(_tree(1))
    bufs = tflat.flatten_tree(tspec, tree, batch_dims=1)
    back = tflat.unflatten_tree(tspec, bufs)
    for a, b in zip(tree_leaves(tree), tree_leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(bits(a), bits(b))
    zeros = tflat.zeros_buffers(tspec, batch_shape=(M,))
    assert [(z.shape, z.dtype) for z in zeros] == \
           [(b.shape, b.dtype) for b in bufs]
    for grp, buf in zip(tspec.groups, bufs):
        live = torch.zeros(grp.padded, dtype=torch.bool)
        for lf in grp.leaves:
            live[lf.offset:lf.offset + lf.size] = True
        assert torch.all(buf[:, ~live] == 0)


@pytest.mark.parametrize("modes", [("mean", "mean", "mean"),
                                   ("mean", "none", "mean"),
                                   ("none", "none", "none")])
def test_client_mean_masked_matches_reference_bitwise(modes):
    tree = _tree(2)
    jspec, tspec = _specs(tree)
    jbufs = jflat.flatten_tree(jspec, tree, batch_dims=1)
    tbufs = tflat.flatten_tree(tspec, to_torch(tree), batch_dims=1)
    jout = jflat.client_mean_masked(jspec, jbufs, modes)
    tout = tflat.client_mean_masked(tspec, tbufs, modes)
    for jb, tb in zip(jout, tout):
        np.testing.assert_array_equal(bits(tb), bits(jb))


def test_fused_launches_match_reference():
    tree = _tree(3)
    jspec, tspec = _specs(tree)
    rng = np.random.default_rng(4)
    jv = jflat.flatten_tree(jspec, tree, batch_dims=1)
    jm, jgn, jgo = (tuple(jnp.asarray(rng.standard_normal(b.shape)
                                      .astype(np.float32)) for b in jv)
                    for _ in range(3))
    lrs, decays = (0.1, 0.2, 0.3), (0.9, 0.8, 0.7)
    jl, jd = ([jnp.float32(v) for v in t] for t in (lrs, decays))
    tl, td = ([torch.tensor(v, dtype=torch.float32) for v in t]
              for t in (lrs, decays))
    tv, tm, tgn, tgo = (tuple(to_torch(list(b))) for b in (jv, jm, jgn, jgo))

    def per_elem(table, grp):      # the per-element value of a section table
        return torch.stack(table)[grp.section_ids].repeat_interleave(BLOCK)

    jstep = jflat.storm_partial_step(jspec, jv, jm, jgo, jl, jd)
    tstep = tflat.storm_partial_step(tspec, tv, tm, tgo, tl, td)
    jfull = jflat.storm_full_update(jspec, jv, jm, jgn, jgo, jl, jd)
    tfull = tflat.storm_full_update(tspec, tv, tm, tgn, tgo, tl, td)
    for g, grp in enumerate(tspec.groups):
        lr, dc = per_elem(tl, grp), per_elem(td, grp)
        for t_out, j_out in ((tstep, jstep), (tfull, jfull)):
            assert_contraction_close(t_out[0][g], j_out[0][g], lr * tm[g])
        np.testing.assert_array_equal(bits(tstep[1][g]), bits(jstep[1][g]))
        assert_contraction_close(tfull[1][g], jfull[1][g],
                                 dc * (tm[g] - tgo[g]))
