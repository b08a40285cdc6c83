"""The sharded flat substrate of the port on a ``[4, 2]`` mesh of gloo
ranks against the JAX package's on an 8-device mesh, on the CPU.

One group of 8 spawned ranks (``tests/torch_mesh.py``) runs every case of
``client_mean_masked(shard=…)`` on its blocks of the same numpy-drawn
buffers (M = 4, one client a rank, and M = 8, two) and gathers the results
on rank 0; one JAX subprocess with 8 forced host devices runs the
reference's sharded means on the same inputs, as its own
``tests/test_sharded_substrate.py`` ``_SCRIPT`` does.  Each case is a test
of its own:

* the plain means (``("mean", "none", "group")`` and ``("mean", "none",
  "mean")``, unweighted and participation-weighted, one all-reduce or the
  reduce-scatter + all-gather): within the reference's own tolerance,
  rtol 1e-5 and atol 1e-6, and the private section bit for bit the input;
* the bf16 and int8 wires (quantization only, int8 with top-k 25 % and
  error feedback, a grouped int8 mean): the entries outside that
  tolerance are rounding flips, each bounded by one rounding step of the
  sends and of the wire (bf16: two units in the last place of the
  summands; int8: one quantum of every send and one of the shared wire
  scale), and few;
* the guarded means (``mean``, ``clip``, ``trim`` with the health screen)
  over a NaN row and a ×25 byzantine row: within rtol 1e-5 / atol 1e-6,
  and the screen's verdicts those of the port's unsharded reduction;
* the guard rails raise in the reference's words (``shards``,
  ``divisible``, ``axis``)."""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

import torch_mesh as tm  # noqa: E402
from repro_torch.optim import flat  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
CASES = tm.substrate_cases()

_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path.insert(0, {tests!r})
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.optim import flat
    import torch_mesh as tm

    assert len(jax.devices()) == 8, jax.devices()
    mesh = Mesh(np.asarray(jax.devices()).reshape(4, 2), ("data", "model"))
    tmpl = {{k: jnp.zeros(s) for k, s in tm.TREE.items()}}
    spec = flat.make_spec(tmpl, sections=("x", "y", "u"), block=tm.BLOCK,
                          shards=2)
    res = {{}}
    for name, (m, modes, weighted, scatter, comp, agg) in \\
            tm.substrate_cases().items():
        ctx = flat.make_shard_ctx(mesh, use_scatter=scatter)
        tree = {{k: jnp.asarray(v) for k, v in tm.substrate_inputs(m).items()}}
        bufs = flat.flatten_tree(spec, tree, batch_dims=1)
        w = jnp.asarray(tm.substrate_weights(m)) if weighted else None
        kw = {{}}
        if comp is not None:
            kw["compress"] = flat.CompressCfg(quant=comp[0],
                                              topk_frac=comp[1])
            if comp[1] > 0:
                kw["ef"] = tuple(jnp.zeros_like(b) for b in bufs)
        if agg is not None:
            nan, byz = tm.substrate_masks(m)
            kw["corrupt"] = (jnp.asarray(nan), jnp.asarray(byz),
                             tm.BYZ_SCALE)
            kw["robust"] = flat.RobustCfg(aggregator=agg)
        out = jax.jit(lambda b: flat.client_mean_masked(
            spec, b, modes, weights=w, shard=ctx, **kw))(bufs)
        out_b, ef = (out, ()) if comp is None else out
        for k, v in flat.unflatten_tree(spec, out_b).items():
            res[name + "/" + k] = np.asarray(v)
        if ef:
            for k, v in flat.unflatten_tree(spec, ef).items():
                res[name + "/ef/" + k] = np.asarray(v)
    np.savez({out!r}, **res)
    print("REFERENCE_OK")
""")


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    """(the port's results, the reference's, the guard rails' messages):
    the JAX subprocess and the gloo ranks run side by side."""
    tmp = str(tmp_path_factory.mktemp("sharded_substrate"))
    ref_out, port_out = (os.path.join(tmp, n) for n in ("ref.npz",
                                                        "port.npz"))
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.Popen(
        [sys.executable, "-c", _SCRIPT.format(tests=os.path.dirname(
            os.path.abspath(__file__)), out=ref_out)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        tm.run_ranks(tm.substrate_ranks, tmp, port_out, timeout=300)
        so, se = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0 and "REFERENCE_OK" in so, se[-3000:]
    with open(port_out + ".json") as fh:
        msgs = json.load(fh)
    return dict(np.load(port_out)), dict(np.load(ref_out)), msgs


def _unsharded_port(name):
    """The port's unsharded reduction of the same case (its verdicts)."""
    m, modes, weighted, _, comp, agg = CASES[name]
    tmpl = {k: torch.zeros(s) for k, s in tm.TREE.items()}
    spec = flat.make_spec(tmpl, sections=("x", "y", "u"), block=tm.BLOCK)
    tree = {k: torch.from_numpy(v) for k, v in tm.substrate_inputs(m).items()}
    bufs = flat.flatten_tree(spec, tree, batch_dims=1)
    nan, byz = tm.substrate_masks(m)
    verdicts = []
    flat.client_mean_masked(
        spec, bufs, modes, weights=torch.from_numpy(tm.substrate_weights(m)),
        corrupt=(torch.from_numpy(nan), torch.from_numpy(byz), tm.BYZ_SCALE),
        robust=flat.RobustCfg(aggregator=agg), verdicts=verdicts)
    return verdicts


def _sends(name):
    """Per section, the f32 summands each client puts into the wire sum
    (its send times its weight column, zero for a non-participant), [M, n]
    each, and the divisor of the mean."""
    m, modes, weighted, _, comp, _ = CASES[name]
    x = tm.substrate_inputs(m)
    w = tm.substrate_weights(m) if weighted else np.ones(m, np.float32)
    groups = 2 if modes[2] == "group" else 1
    denom = m // groups
    out = {}
    for k in ("x", "u"):
        col = np.zeros(m, np.float32)
        for g in range(groups):
            sl = slice(g * denom, (g + 1) * denom)
            col[sl] = w[sl] * (denom / w[sl].sum())
        out[k] = x[k] * col[:, None]
    return out, denom


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_mean_matches_reference(outputs, name):
    port, ref, _ = outputs
    m, modes, weighted, _, comp, agg = CASES[name]
    inputs = tm.substrate_inputs(m)
    # the private section never entered a collective: bit for bit the input
    np.testing.assert_array_equal(port[f"{name}/y"].view(np.uint8),
                                  inputs["y"].view(np.uint8))
    np.testing.assert_array_equal(ref[f"{name}/y"].view(np.uint8),
                                  inputs["y"].view(np.uint8))
    for k in ("x", "u"):
        got, want = port[f"{name}/{k}"], ref[f"{name}/{k}"]
        assert got.shape == want.shape and np.all(np.isfinite(got))
        if comp is None:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                       err_msg=f"{name}/{k}")
            continue
        summands, denom = _sends(name)
        mag = np.abs(summands[k])
        out = np.abs(got - want) > 1e-5 * np.abs(want) + 1e-6
        if comp[0] == "bf16":
            # the two all-reduces round their bf16 additions differently
            # (gloo rounds each addition to bf16, in rank order): within
            # four bf16 units in the last place of the summands' sum
            step = 4 * 2.0 ** -8 * mag.sum(axis=0) / denom
        else:
            # int8: rounding flips of the sends and of the wire, each at
            # most one quantum of every send and of the shared wire scale
            # (Σ amax / (127 − d/2)), and few
            tile = mag.max(axis=1).sum() / denom
            step = tile / 127.0 + tile / (127.0 - 2.0)
            assert out.mean() <= 0.05, (name, k, int(out.sum()))
        assert np.all(np.abs(got - want)[out]
                      <= np.broadcast_to(step, got.shape)[out] + 1e-6), \
            (name, k, float(np.max(np.abs(got - want))))
    if comp is not None and comp[1] > 0:
        for k in ("x", "u"):
            got, want = port[f"{name}/ef/{k}"], ref[f"{name}/ef/{k}"]
            w = tm.substrate_weights(m)
            # non-participants sent nothing: their EF rows stay zero
            np.testing.assert_array_equal(got[w == 0], 0 * got[w == 0])
            np.testing.assert_array_equal(want[w == 0], 0 * want[w == 0])
            # the residual (row + EF) − send: equal but where a send's
            # rounding flipped, by at most one quantum of that send
            quantum = np.abs(inputs[k]).max(axis=1, keepdims=True) / 127.0
            assert np.all(np.abs(got - want) <= quantum + 1e-6), (name, k)
    if agg is not None:
        verdicts = port[f"{name}/verdicts"]
        want = np.stack([v.numpy() for v in _unsharded_port(name)])
        np.testing.assert_array_equal(verdicts, want)
        assert verdicts[:, tm.NAN_CLIENT].max() == 0     # NaN row screened


def test_guard_rails_raise_in_the_reference_words(outputs):
    _, _, msgs = outputs
    for key, msg in msgs.items():
        assert msg is not None and key in msg, (key, msg)
