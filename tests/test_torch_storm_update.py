"""The port's pytree ``storm_update`` against the JAX package's.

On the CPU the port's ``kernels.storm.storm_update`` runs the plain version
of ``storm_update_flat`` once per (param dtype, momentum dtype) group.  It is
held:

* bit for bit against ``repro.kernels.storm.ref.storm_update_ref`` run op by
  op, leaf by leaf, on gradients already cast to the momentum's dtype (the
  reference's wrapper casts them so before its kernel);
* against the reference's ``storm_update`` (the Pallas kernel in interpret
  mode under ``jit``, as tests/test_kernels.py runs it) within
  ``torch_parity.assert_contraction_close``: XLA's CPU backend contracts
  ``p − lr·m`` and ``g_new + decay·(m − g_old)`` into fused multiply-adds,
  which round once where the op-by-op arithmetic rounds twice, so the two
  differ by at most one rounding of the product plus one unit in the last
  place of the result in its own dtype (as tests/test_torch_storm.py states
  for the ``storm3_*`` kernels).

The CUDA kernel is held against the plain version on the card in
tests/test_torch_cuda.py."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels.storm import storm_update as jstorm_update  # noqa: E402
from repro.kernels.storm.ref import storm_update_ref as jref  # noqa: E402
from repro_torch.kernels.storm import kernel as tk  # noqa: E402
from repro_torch.kernels.storm import ref as tref  # noqa: E402
from repro_torch.kernels.storm import storm_update  # noqa: E402
from torch_parity import assert_contraction_close, bits  # noqa: E402

torch.set_num_threads(1)

LR, DECAY = 0.05, 0.9


def _leaf(rng, shape, dtype: str):
    """One leaf as (jax array, torch tensor) with the same bits."""
    a = rng.standard_normal(shape).astype(np.float32)
    return (jnp.asarray(a).astype(dtype),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def _trees(seed: int, spec: dict, grad_dtype: str = "float32"):
    """``spec``: leaf path → (shape, p dtype, m dtype); paths with a "/" are
    nested one level.  Returns the four trees (params, mom, g_new, g_old)
    for JAX and for torch."""
    rng = np.random.default_rng(seed)
    jax_trees, torch_trees = ([{}, {}, {}, {}] for _ in range(2))
    for path, (shape, p_dtype, m_dtype) in spec.items():
        for k, dtype in enumerate((p_dtype, m_dtype, grad_dtype, grad_dtype)):
            j, t = _leaf(rng, shape, dtype)
            *outer, last = path.split("/")
            jd, td = jax_trees[k], torch_trees[k]
            for o in outer:
                jd, td = jd.setdefault(o, {}), td.setdefault(o, {})
            jd[last], td[last] = j, t
    return jax_trees, torch_trees


def _leaves(tree, path: str):
    for part in path.split("/"):
        tree = tree[part]
    return tree


def _check(spec: dict, seed: int, lr=LR, decay=DECAY, grad_dtype="float32"):
    """The port against the op-by-op reference (bits) and the reference's
    Pallas wrapper (contraction bound), leaf by leaf."""
    (jp, jm, jgn, jgo), (tp, tm, tgn, tgo) = _trees(seed, spec, grad_dtype)
    pn, mn = storm_update(tp, tm, tgn, tgo, lr, decay)
    jpn, jmn = jstorm_update(jp, jm, jgn, jgo, lr, decay)
    assert sorted(pn) == sorted(tp) and sorted(mn) == sorted(tm)
    for path, (shape, p_dtype, m_dtype) in spec.items():
        p, m, gn, go = (_leaves(t, path) for t in (tp, tm, tgn, tgo))
        got_p, got_m = _leaves(pn, path), _leaves(mn, path)
        assert tuple(got_p.shape) == tuple(got_m.shape) == tuple(shape)
        assert got_p.dtype == p.dtype and got_m.dtype == m.dtype
        ja, jb, jc, jd = (_leaves(t, path) for t in (jp, jm, jgn, jgo))
        want = jref(ja, jb, jc.astype(m_dtype), jd.astype(m_dtype), lr, decay)
        np.testing.assert_array_equal(bits(got_p), bits(want[0]))
        np.testing.assert_array_equal(bits(got_m), bits(want[1]))
        go32 = go.to(m.dtype).float()
        assert_contraction_close(got_p, _leaves(jpn, path),
                                 torch.tensor(np.float32(lr)) * m.float())
        assert_contraction_close(got_m, _leaves(jmn, path),
                                 torch.tensor(np.float32(decay))
                                 * (m.float() - go32))
    return pn, mn


@pytest.mark.parametrize("n", [1, 4000, 70000])
@pytest.mark.parametrize("p_dtype", ["float32", "bfloat16"])
def test_single_leaf_sizes(n, p_dtype):
    """One leaf whose length is no multiple of the reference's 65,536 tile
    (the reference pads it; the port does not)."""
    _check({"x": ((n,), p_dtype, "float32")}, seed=n)


def test_nested_dict_several_leaves():
    """A nested dict: leaves in sorted-key order, shapes and structure
    kept."""
    spec = {"b/w": ((33, 7), "float32", "float32"),
            "a": ((5,), "float32", "float32"),
            "b/a": ((3, 5, 7), "float32", "float32"),
            "c/z": ((64,), "float32", "float32")}
    pn, _ = _check(spec, seed=1)
    assert list(pn) == ["a", "b", "c"] and sorted(pn["b"]) == ["a", "w"]


def test_mixed_dtype_pairs_in_first_seen_order():
    """Three dtype pairs interleaved in leaf order: each group is
    concatenated in leaf order and updated by one call, in the order each
    pair is first seen (bf16/f32, f32/f32, bf16/bf16)."""
    spec = {"a": ((100,), "bfloat16", "float32"),
            "b": ((7, 3), "float32", "float32"),
            "c": ((4001,), "bfloat16", "bfloat16"),
            "d": ((50,), "bfloat16", "float32"),
            "e": ((9,), "float32", "float32")}
    tk.reset_counts()
    seen = []
    real = tk.storm_update_flat

    def record(p, m, g_new, g_old, lr, decay):
        seen.append((p.dtype, m.dtype, p.numel()))
        return real(p, m, g_new, g_old, lr, decay)

    import repro_torch.kernels.storm.ops as ops
    ops.storm_update_flat = record
    try:
        _check(spec, seed=2, grad_dtype="float32")
    finally:
        ops.storm_update_flat = real
    assert seen == [(torch.bfloat16, torch.float32, 150),
                    (torch.float32, torch.float32, 30),
                    (torch.bfloat16, torch.bfloat16, 4001)]


@pytest.mark.parametrize("lr,decay", [(LR, 0.0), (LR, 1.0), (0.0, DECAY)])
def test_decay_and_lr_edges(lr, decay):
    """decay 0: m' = g_new; lr 0: p' = p (exactly, in both dtypes)."""
    spec = {"x": ((4000,), "bfloat16", "float32"),
            "y": ((1,), "float32", "bfloat16")}
    _, (tp, tm, tgn, _) = _trees(3, spec)
    pn, mn = _check(spec, seed=3, lr=lr, decay=decay)
    for k in spec:
        if decay == 0.0:
            np.testing.assert_array_equal(bits(mn[k]),
                                          bits(tgn[k].to(tm[k].dtype)))
        if lr == 0.0:
            np.testing.assert_array_equal(bits(pn[k]), bits(tp[k]))


def test_gradients_rounded_to_bf16_momentum():
    """With bf16 momentum the f32 gradients are rounded to bf16 before the
    update (as the reference casts them), which differs from using them in
    f32."""
    spec = {"x": ((4000,), "float32", "bfloat16")}
    _, (tp, tm, tgn, tgo) = _trees(4, spec)
    _, mn = _check(spec, seed=4)
    # the plain version widens its inputs itself, so f32 gradients go in
    # unrounded
    _, unrounded = tref.storm_update_ref(tp["x"], tm["x"], tgn["x"],
                                         tgo["x"], LR, DECAY)
    assert np.any(bits(mn["x"]) != bits(unrounded))


@pytest.mark.parametrize("p_dtype,m_dtype", [("float32", "float32"),
                                             ("bfloat16", "float32"),
                                             ("float32", "bfloat16"),
                                             ("bfloat16", "bfloat16")])
def test_flat_any_length_vs_ref(p_dtype, m_dtype):
    """``storm_update_flat`` at a ragged length against both plain versions
    bit for bit, for the four dtype pairs."""
    rng = np.random.default_rng(5)
    n = 70001
    (jp, tp), (jm, tm), (jgn, tgn), (jgo, tgo) = (
        _leaf(rng, (n,), d) for d in (p_dtype, m_dtype, m_dtype, m_dtype))
    out = tk.storm_update_flat(tp, tm, tgn, tgo, LR, DECAY)
    assert out[0].dtype == tp.dtype and out[1].dtype == tm.dtype
    for got, want in zip(out, jref(jp, jm, jgn, jgo, LR, DECAY)):
        np.testing.assert_array_equal(bits(got), bits(want))
    for got, want in zip(out, tref.storm_update_ref(tp, tm, tgn, tgo, LR,
                                                    DECAY)):
        np.testing.assert_array_equal(bits(got), bits(want))


def test_counts_calls_and_no_launch_on_cpu():
    """One call per dtype group; CPU tensors never launch."""
    spec = {"a": ((10,), "bfloat16", "float32"),
            "b": ((10,), "float32", "float32"),
            "c": ((10,), "bfloat16", "float32")}
    _, (tp, tm, tgn, tgo) = _trees(6, spec)
    tk.reset_counts()
    storm_update(tp, tm, tgn, tgo, LR, DECAY)
    assert tk.CALLS["storm_update"] == 2
    assert tk.LAUNCHES["storm_update"] == 0


def test_mismatched_trees_raise():
    spec = {"a": ((10,), "float32", "float32"),
            "b": ((4,), "float32", "float32")}
    _, (tp, tm, tgn, tgo) = _trees(7, spec)
    with pytest.raises(ValueError, match="dict keys"):
        storm_update(tp, {"a": tm["a"]}, tgn, tgo, LR, DECAY)
    with pytest.raises(ValueError, match="shape"):
        storm_update(tp, {**tm, "b": tm["b"][:3]}, tgn, tgo, LR, DECAY)
    with pytest.raises(ValueError, match="sequence length"):
        storm_update([tp["a"]], [tm["a"], tm["b"]], [tgn["a"]], [tgo["a"]],
                     LR, DECAY)
    with pytest.raises(TypeError, match="m's dtype"):
        tk.storm_update_flat(tp["a"], tm["a"], tgn["a"].double(), tgo["a"],
                             LR, DECAY)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tk.storm_update_flat(tp["a"].half(), tm["a"], tgn["a"], tgo["a"],
                             LR, DECAY)
    with pytest.raises(ValueError, match="one length"):
        tk.storm_update_flat(tp["a"], tm["a"][:9], tgn["a"], tgo["a"],
                             LR, DECAY)
