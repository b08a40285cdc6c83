"""The participation-weighted and the grouped compressed means of the port
against the JAX package's (``repro.optim.flat._compressed_mean`` with
``w``, ``_compressed_mean_grouped``), on the CPU, from rows drawn with
numpy from a seed.

The reference runs as the TPU runs it: its int8 round trip goes through
its Pallas ``quantpack_flat`` / ``quantunpack_flat`` kernels in interpret
mode (the ``tpu_reference`` fixture, as in ``test_torch_compress.py``).
Everything is held bit for bit (tolerance 0):

* the weighted compressed mean (int8 + top-k 10 % with error feedback, the
  straggler spec's compression; int8 alone; bf16 + top-k without
  feedback) under arrival weights, staleness-aged weights and an empty
  round: buffers and error feedback equal the reference's, and a client of
  weight 0 keeps its row and its EF row;
* the grouped (pod-local) compressed mean, int8 and bf16, unweighted,
  weighted and with a pod that has no participant (it keeps its rows),
  beside an exactly averaged section and a private one;
* per-section weight tuples, as a cadence passes them (None for a section
  that does not reduce);
* the refusals: top-k with a grouped run, and client counts that do not
  split into the groups."""
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels.storm import quantpack as jqp  # noqa: E402
from repro.optim import flat as jflat  # noqa: E402
from repro_torch.optim import flat as tflat  # noqa: E402
from torch_parity import bits, to_torch  # noqa: E402

torch.set_num_threads(1)

SECTIONS, BLOCK = ("x", "y", "u"), 128
# (quant, topk_frac, error_feedback)
WEIGHTED = [("int8", 0.1, True), ("int8", 0.0, True), ("bf16", 0.1, False)]
# weights of the 8 clients: round 0's arrivals of the straggler spec's
# shape (6 sampled, 4 arrived), ages discounted by α = 0.5, nobody
WEIGHTS = {"arrivals": [1, 1, 1, 0, 0, 0, 0, 1],
           "aged": [1.0, 0.25, 0.0, 0.5, 1.0, 0.0, 0.125, 1.0],
           "nobody": [0.0] * 8}
# 4 clients in 2 pods: every client, 3 of 4, pod 1 empty
GROUPED = {"all": None, "three_of_four": [1.0, 0.0, 1.0, 1.0],
           "empty_pod": [1.0, 1.0, 0.0, 0.0]}


@pytest.fixture
def tpu_reference(monkeypatch):
    """Route the reference substrate's int8 round trip through its Pallas
    kernels (interpret mode), as on a TPU, instead of their jnp lowerings."""
    monkeypatch.setattr(jflat, "quantpack_flat_jnp", functools.partial(
        jqp.quantpack_flat, interpret=True))
    monkeypatch.setattr(jflat, "quantunpack_flat_jnp", functools.partial(
        jqp.quantunpack_flat, interpret=True))


def _case(m: int, seed: int):
    """Specs, [m, N] buffers (bf16 and f32) of an x | y | u tree whose
    sections span several 128-element tiles, and f32 EF buffers."""
    rng = np.random.default_rng(seed)

    def n(*s, dt="float32"):
        v = rng.standard_normal((m,) + s) * rng.lognormal(0.0, 1.0, (m,) + s)
        return jnp.asarray(v.astype(np.float32)).astype(dt)

    tree = {"x": {"w": n(3, 100, dt="bfloat16"), "b": n(150)},
            "y": {"w": n(200, dt="bfloat16")},
            "u": {"w": n(90, dt="bfloat16"), "s": n(300)}}
    tmpl = jax.tree.map(lambda a: a[0], tree)
    jspec = jflat.make_spec(tmpl, sections=SECTIONS, block=BLOCK)
    tspec = tflat.make_spec(to_torch(tmpl), sections=SECTIONS, block=BLOCK)
    jbufs = jflat.flatten_tree(jspec, tree, batch_dims=1)
    jef = tuple(jnp.asarray((0.3 * rng.standard_normal(b.shape))
                            .astype(np.float32)) for b in jbufs)
    return jspec, tspec, jbufs, jef


def _both(jspec, tspec, jbufs, jef, modes, ccfg_kw, jw, tw, groups=2):
    """The reference's jitted masked reduction and the port's on the same
    rows: ((buffers, ef), (buffers, ef), the port's input EF)."""
    jcfg = jflat.CompressCfg(**ccfg_kw)
    tcfg = tflat.CompressCfg(**ccfg_kw)
    ef_in = jef if jcfg.has_ef else ()
    jout = jax.jit(lambda b, e, w: jflat.client_mean_masked(
        jspec, b, modes, num_groups=groups, weights=w, compress=jcfg,
        ef=e))(jbufs, ef_in, jw)
    tef = tuple(to_torch(list(ef_in)))
    tout = tflat.client_mean_masked(
        tspec, tuple(to_torch(list(jbufs))), modes, num_groups=groups,
        weights=tw, compress=tcfg, ef=tef)
    return jout, tout, tef


def _assert_bitwise(jout, tout):
    (jb, je), (tb, te) = jout, tout
    assert len(tb) == len(jb) and len(te) == len(je)
    for j, t in zip(jb + je, tb + te):
        np.testing.assert_array_equal(bits(t), bits(j))


@pytest.mark.parametrize("case", sorted(WEIGHTS))
@pytest.mark.parametrize("quant,topk,ef", WEIGHTED)
def test_weighted_compressed_mean_matches_reference_bitwise(
        quant, topk, ef, case, tpu_reference):
    jspec, tspec, jbufs, jef = _case(8, seed=3)
    w = np.asarray(WEIGHTS[case], np.float32)
    kw = dict(quant=quant, topk_frac=topk, error_feedback=ef)
    jout, tout, tef = _both(jspec, tspec, jbufs, jef, ("mean",) * 3, kw,
                            jnp.asarray(w), torch.from_numpy(w))
    _assert_bitwise(jout, tout)
    (tb, te), tin = tout, tuple(to_torch(list(jbufs)))
    out = [i for i in range(8) if w[i] == 0]
    ins = [i for i in range(8) if w[i] > 0]
    for g in range(len(tb)):
        for i in out:       # sent nothing: row and EF row stay
            np.testing.assert_array_equal(bits(tb[g][i]), bits(tin[g][i]))
            if te:
                np.testing.assert_array_equal(bits(te[g][i]),
                                              bits(tef[g][i]))
        for i in ins[1:]:   # the participants share one mean
            assert torch.equal(tb[g][i], tb[g][ins[0]])
        if te and ins:      # the caller's EF buffers stay as they were
            assert not torch.equal(te[g], tef[g])


@pytest.mark.parametrize("case", sorted(GROUPED))
@pytest.mark.parametrize("quant", ["int8", "bf16"])
def test_grouped_compressed_mean_matches_reference_bitwise(quant, case,
                                                           tpu_reference):
    """x takes the grouped int8/bf16 mean (a pod-local round), y stays
    private, u takes the exact full mean (an AVERAGED section)."""
    jspec, tspec, jbufs, jef = _case(4, seed=5)
    w = GROUPED[case]
    jw = None if w is None else jnp.asarray(w, jnp.float32)
    tw = None if w is None else torch.tensor(w)
    modes = ("group", "none", "mean")
    kw = dict(quant=quant, sections=("x",))
    jout, tout, _ = _both(jspec, tspec, jbufs, jef, modes, kw, jw, tw)
    _assert_bitwise(jout, tout)
    assert jout[1] == () and tout[1] == ()
    tb, tin = tout[0], tuple(to_torch(list(jbufs)))
    for g, grp in enumerate(tspec.groups):
        for s, a, b in grp.extents:
            rows = [r[a:b] for r in tb[g]]
            if SECTIONS[s] == "y":
                assert torch.equal(tb[g][:, a:b], tin[g][:, a:b])
                continue
            if SECTIONS[s] != "x":
                continue
            for pod in ((0, 1), (2, 3)):
                ins = [i for i in pod if w is None or w[i] > 0]
                for i in pod:
                    if i not in ins:     # no send: the row stays
                        assert torch.equal(rows[i], tin[g][i, a:b])
                if len(ins) == 2:
                    assert torch.equal(rows[ins[0]], rows[ins[1]])
            if w is None:               # two pods, two means
                assert not torch.equal(rows[0], rows[2])


def test_per_section_weight_tuples_match_reference_bitwise(tpu_reference):
    """A cadence's call: x and u reduce with the round's weights (one
    tensor, so their runs merge), y is skipped (None, mode "none");
    then x and u with two different weight tensors."""
    jspec, tspec, jbufs, jef = _case(8, seed=9)
    w = np.asarray(WEIGHTS["arrivals"], np.float32)
    a = np.asarray(WEIGHTS["aged"], np.float32)
    kw = dict(quant="int8", topk_frac=0.1)
    jw, tw = jnp.asarray(w), torch.from_numpy(w)
    jout, tout, _ = _both(jspec, tspec, jbufs, jef, ("mean", "none", "mean"),
                          kw, (jw, None, jw), (tw, None, tw))
    _assert_bitwise(jout, tout)
    jout, tout, _ = _both(jspec, tspec, jbufs, jef, ("mean", "none", "mean"),
                          kw, (jw, None, jnp.asarray(a)),
                          (tw, None, torch.from_numpy(a)))
    _assert_bitwise(jout, tout)
    runs = tflat._section_runs(tspec.groups[1], ("mean", "none", "mean"),
                               (True,) * 3, (tw, None, tw))
    assert [r[0] for r in runs] == ["mean", "none", "mean"]


def test_grouped_refusals():
    _, tspec, jbufs, _ = _case(4, seed=1)
    tb = tuple(to_torch(list(jbufs)))
    with pytest.raises(ValueError, match="top-k compression does not "
                       "compose with grouped"):
        tflat.client_mean_masked(tspec, tb, ("group", "none", "mean"),
                                 compress=tflat.CompressCfg(
                                     quant="int8", topk_frac=0.1),
                                 ef=tuple(torch.zeros_like(
                                     b, dtype=torch.float32) for b in tb))
    with pytest.raises(ValueError, match="4 clients do not split into 3"):
        tflat.client_mean_masked(tspec, tb, ("group", "none", "mean"),
                                 num_groups=3)
    with pytest.raises(ValueError, match="4 clients do not split into 3"):
        tflat.client_mean_masked(tspec, tb, ("group", "none", "mean"),
                                 num_groups=3,
                                 compress=tflat.CompressCfg(quant="int8"))
    with pytest.raises(ValueError, match="2 weights for 3 sections"):
        tflat.client_mean_masked(tspec, tb, ("mean",) * 3,
                                 weights=(None, None))
