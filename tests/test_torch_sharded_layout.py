"""The shard-major flat layout of the port against the JAX package's, in
one process on the CPU (the layout half of the reference's
``tests/test_sharded_substrate.py``, before its multi-device part).

* For shards 1, 2 and 4: the port's ``padded``, ``section_ids`` and
  ``extents`` are the reference's; the invariants the reference asserts
  hold (sections padded to ``block · shards``, one chunk's pattern tiled,
  extents tiling the chunk); the port's buffers are the reference's bit
  for bit, and flatten / unflatten round-trip bit for bit; ``chunk=j``
  packs exactly chunk j, and ``local_blocks`` takes a rank's block.
* The layout is a storage permutation: on a shards=2 spec the masked
  reduction, the fused launch and the telemetry norms give the shards=1
  results (restating the reference's invariance test), and the comm plan
  counts chunk extents × shards as the reference's does.
* The overlap schedule without a mesh: the port's FedBiOAcc engine with
  ``overlap=True`` against the reference's, three steps of the reduced
  Mamba-2 from the reference's initial state on its batches, every buffer
  within 1e-4 of its norm (``ENGINE_TOL`` of the unsharded engine parity
  tests), and different from the sequential schedule after the
  communication step."""
from types import SimpleNamespace

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.optim import flat as jflat  # noqa: E402
from repro.telemetry.comm import comm_plan as jcomm_plan  # noqa: E402
from repro_torch.core.tree_util import tree_leaves  # noqa: E402
from repro_torch.optim import flat as tflat  # noqa: E402
from repro_torch.optim import sequences as tseqs  # noqa: E402
from repro_torch.telemetry.comm import comm_plan  # noqa: E402
from torch_parity import bits, f32, to_torch  # noqa: E402

torch.set_num_threads(1)

ENGINE_TOL = 1e-4
SPEC = "experiments/fedbioacc_sharded_overlap.json"


def _mixed_tree():
    return {
        "x": {"w": jnp.arange(24.0).reshape(4, 6),
              "b": (jnp.arange(7, dtype=jnp.bfloat16), jnp.float32(3.5))},
        "y": {"h": jnp.arange(5.0) * 2.0,
              "hb": jnp.full((3,), 2, jnp.bfloat16)},
        "u": {"h": jnp.ones((5,)), "hb": jnp.ones((3,), jnp.bfloat16)},
    }


def _client_stack(tree, m):
    return jax.tree.map(
        lambda v: jnp.stack([jnp.asarray(v) + i for i in range(m)]), tree)


def _specs(shards: int, block: int = 8):
    tree = _mixed_tree()
    secs = ("x", "y", "u")
    return (tree, jflat.make_spec(tree, sections=secs, block=block,
                                  shards=shards),
            tflat.make_spec(to_torch(tree), sections=secs, block=block,
                            shards=shards))


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_sharded_spec_matches_reference_and_round_trips(shards):
    tree, js, ts = _specs(shards)
    assert ts.shards == js.shards == shards
    assert len(ts.groups) == len(js.groups)
    for jg, tg in zip(js.groups, ts.groups):
        assert tg.padded == jg.padded and tg.block == jg.block
        assert tg.extents == tuple(tuple(int(v) for v in e)
                                   for e in jg.extents)
        np.testing.assert_array_equal(tg.section_ids.numpy(),
                                      np.asarray(jg.section_ids))
        # the reference's invariants
        assert tg.padded % (tg.block * shards) == 0
        chunk = tg.padded // shards
        pattern = tg.section_ids[:chunk // tg.block]
        assert torch.equal(tg.section_ids, pattern.repeat(shards))
        assert tg.extents[0][1] == 0 and tg.extents[-1][2] == chunk
        for (_, _, stop), (_, start, _) in zip(tg.extents, tg.extents[1:]):
            assert stop == start
    # buffers bit for bit the reference's, also with a client axis
    for m in (None, 3):
        jt = tree if m is None else _client_stack(tree, m)
        bd = 0 if m is None else 1
        jb = jflat.flatten_tree(js, jt, batch_dims=bd)
        tb = tflat.flatten_tree(ts, to_torch(jt), batch_dims=bd)
        for a, b in zip(jb, tb):
            assert tuple(b.shape) == a.shape
            np.testing.assert_array_equal(bits(b), bits(a))
        back = tree_leaves(tflat.unflatten_tree(ts, tb))
        for a, b in zip(jax.tree.leaves(jt), back):
            assert b.dtype == to_torch(a).dtype
            np.testing.assert_array_equal(bits(b.contiguous()), bits(a))
        # chunk=j packs chunk j; local_blocks takes a rank's block
        for j in range(shards):
            cb = tflat.flatten_tree(ts, to_torch(jt), batch_dims=bd, chunk=j)
            for g, whole, part in zip(ts.groups, tb, cb):
                w = g.padded // shards
                assert torch.equal(part, whole[..., j * w:(j + 1) * w])
    mesh = SimpleNamespace(shape={"data": 3, "model": shards},
                           coords={"data": 1, "model": shards - 1})
    ctx = tflat.make_shard_ctx(mesh)
    tb = tflat.flatten_tree(ts, to_torch(_client_stack(tree, 6)),
                            batch_dims=1)
    for g, whole, block in zip(ts.groups, tb,
                               tflat.local_blocks(ts, tb, ctx)):
        w = g.padded // shards
        assert torch.equal(block, whole[2:4, (shards - 1) * w:])
    with pytest.raises(ValueError, match="axis"):
        tflat.make_shard_ctx(mesh, model_axis="nope")


def test_sharded_layout_comm_launch_and_norms_invariance():
    """The interleaved shards=2 layout gives the shards=1 results (after
    unflattening) for the masked reduction, the fused launch and the
    per-section norms: it is a storage permutation."""
    tree = to_torch(_client_stack(_mixed_tree(), 8))
    secs = ("x", "y", "u")
    tmpl = to_torch(_mixed_tree())
    s1 = tflat.make_spec(tmpl, sections=secs, block=8)
    s2 = tflat.make_spec(tmpl, sections=secs, block=8, shards=2)
    b1 = tflat.flatten_tree(s1, tree, batch_dims=1)
    b2 = tflat.flatten_tree(s2, tree, batch_dims=1)
    w = torch.tensor([1, 0, 1, 1, 0, 1, 1, 1], dtype=torch.float32)

    def same(t1, t2):
        for a, b in zip(tree_leaves(tflat.unflatten_tree(s1, t1)),
                        tree_leaves(tflat.unflatten_tree(s2, t2))):
            np.testing.assert_array_equal(f32(a), f32(b))

    for modes in (("mean", "none", "group"), ("group", "mean", "none")):
        same(tflat.client_mean_masked(s1, tuple(b.clone() for b in b1),
                                      modes, weights=w),
             tflat.client_mean_masked(s2, tuple(b.clone() for b in b2),
                                      modes, weights=w))
    lrs = tuple(torch.tensor(v) for v in (0.05, 0.1, 0.2))
    decays = tuple(torch.tensor(v) for v in (0.99, 0.98, 0.97))
    mom1 = tuple(torch.ones(b.shape) for b in b1)
    mom2 = tuple(torch.ones(b.shape) for b in b2)
    g1 = tuple(0.5 * torch.ones(b.shape) for b in b1)
    g2 = tuple(0.5 * torch.ones(b.shape) for b in b2)
    v1, mp1 = tflat.storm_partial_step(s1, b1, mom1, g1, lrs, decays,
                                       mask=w)
    v2, mp2 = tflat.storm_partial_step(s2, b2, mom2, g2, lrs, decays,
                                       mask=w)
    same(v1, v2)
    same(mp1, mp2)
    n1 = tflat.section_norms(s1, b1, mask=w)
    n2 = tflat.section_norms(s2, b2, mask=w)
    assert n1.keys() == n2.keys()
    for k in n1:
        assert torch.equal(n1[k], n2[k]), k


@pytest.mark.parametrize("shards", [1, 2])
def test_comm_plan_counts_chunk_extents_times_shards(shards):
    from repro.federation.compression import CompressionSpec as JComp
    from repro.optim import sequences as jseqs
    from repro_torch.federation.compression import CompressionSpec
    tree, js, ts = _specs(shards, block=4)
    for name in ("fedbioacc", "fedbioacc_local"):
        for jc, tc in ((None, None),
                       (JComp(quant="int8"), CompressionSpec(quant="int8"))):
            want = jcomm_plan(js, jseqs.SPECS[name], jc)
            got = comm_plan(ts, tseqs.SPECS[name], tc)
            assert tuple(got) == tuple(want)
            assert got.sections[0][1] == sum(
                (b - a) * shards for g in ts.groups
                for s, a, b in g.extents if s == 0)


@pytest.fixture(scope="module")
def overlap_runs():
    """The reference's and the port's FedBiOAcc engines with
    ``overlap=True`` and no mesh (and the port's sequential one), three
    steps from the reference's initial state on its batches."""
    from repro.api import Experiment as JExperiment
    from repro.api import build as jbuild
    from repro.federation import trainer as jtr
    from repro_torch.api import Experiment, build
    from repro_torch.federation import trainer as ttr

    edit = {"execution.mesh": None, "execution.overlap": False}
    jrun = jbuild(JExperiment.load(SPEC).edit(**edit))
    run = build(Experiment.load(SPEC).edit(**edit), device="cpu")
    kw = dict(n_micro=1, remat=False, fuse_storm=True, fuse_oracles=True)
    jinit, jstep = jtr.make_fedbioacc_train_step(jrun.model, jrun.fed,
                                                 overlap=True, **kw)
    steps = {ov: ttr.make_fedbioacc_train_step(run.model, run.fed,
                                               overlap=ov, **kw)[1]
             for ov in (True, False)}
    key = jax.random.PRNGKey(0)
    jstate = jinit(key)
    start = tseqs.FlatState(tuple(to_torch(list(jstate.vars))),
                            tuple(to_torch(list(jstate.mom))), 0)
    states = dict.fromkeys(steps, start)
    jfn = jax.jit(jstep)
    jstates, tstates = [], {ov: [] for ov in steps}
    for _ in range(3):
        key, sub = jax.random.split(key)
        batch = jrun.batch_fn(sub)
        jstate, _ = jfn(jstate, batch)
        jstates.append(jstate)
        for ov, step in steps.items():
            states[ov], _ = step(states[ov], to_torch(batch))
            tstates[ov].append(states[ov])
    return jstates, tstates


def test_overlap_without_a_mesh_matches_reference(overlap_runs):
    jstates, tstates = overlap_runs
    for t, (js, ts, seq) in enumerate(zip(jstates, tstates[True],
                                          tstates[False])):
        assert ts.step == int(js.step) == t + 1
        for j, g in zip(js.vars + js.mom, ts.vars + ts.mom):
            j = np.asarray(j, np.float32)
            assert np.linalg.norm(f32(g) - j) <= \
                ENGINE_TOL * np.linalg.norm(j), t
        # the schedules coincide until the first communication step (step
        # index 1 with 2 local steps), then the overlap's correction was
        # taken at the local iterate
        same = all(torch.equal(a, b) for a, b in zip(ts.mom, seq.mom))
        assert same == (t == 0), t


def test_flat_state_specs_place_buffers_over_both_axes():
    """``sharding.rules.flat_state_specs``: every [M, N] buffer of a state
    (variables, momenta, error feedback) over ``(data, model)``, the host
    state whole on every rank."""
    from repro_torch.sharding.rules import flat_state_specs
    bufs = (torch.zeros(4, 16), torch.zeros(4, 8, dtype=torch.bfloat16))
    state = tseqs.FlatState(bufs, bufs, 3, (bufs, bufs),
                            torch.zeros(4, dtype=torch.int32),
                            torch.tensor(1.5), torch.tensor(0))
    specs = flat_state_specs(state, data_axis="d", model_axis="m")
    assert specs.vars == specs.mom == (("d", "m"), ("d", "m"))
    assert specs.ef == ((("d", "m"),) * 2,) * 2
    assert specs.step == specs.stale == specs.deadline == specs.retry == ()
