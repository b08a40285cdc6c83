"""The port's mesh runs held to the JAX package's engine with ``shard=`` on
8 forced host devices: the straggler, faulty and telemetry specs edited to
``execution.mesh [4, 2]`` (``tests/torch_mesh.py`` ``guard_cases``).  A
group of 8 gloo ranks runs the three through ``api.build`` on the port's
mesh (``tm.guard_ranks``); once the ranks are gone, one JAX subprocess
(``_REF``) runs the reference's from the port's initial state and batches
(beside the ranks, the XLA device threads and the ranks starved each
other).

Rank 0's records against the reference's, at ``test_torch_sharded_engine``'s
tolerances: the fields within atol 2e-5 and rtol 2e-4 (the faulty spec's
fields within 1e-4 of their norm, its last momenta to 4× the reference's
measured response, ROADMAP queue 3 item 15), the in-band metrics within
rtol 1e-5 (the drift also within the rounding slack of its mean row, from
the port's unsharded run of the spec).  The reference ran all three on a
mesh without a fault, so no new reference fault is recorded."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

import torch_mesh as tm  # noqa: E402
from test_torch_sharded_engine import (ROOT, _check_fields,  # noqa: E402
                                       _check_metrics, _guard, _unsharded)

torch.set_num_threads(1)

VARIANTS = ("straggler", "faulty", "telemetry")

_REF = textwrap.dedent("""
    import os, sys
    # 8 host devices, each a thread; under the test run's load a thread can
    # wait longer than XLA's 40-s default for a collective's rendezvous,
    # after which XLA ends the process
    os.environ["XLA_FLAGS"] = (
        "--xla_force_host_platform_device_count=8 "
        "--xla_cpu_collective_call_terminate_timeout_seconds=900 "
        "--xla_cpu_collective_timeout_seconds=900")
    sys.path.insert(0, {tests!r})
    import numpy as np
    import jax, jax.numpy as jnp
    from repro.api import Experiment, build
    from repro.optim import flat
    import torch_mesh as tm

    assert len(jax.devices()) == 8, jax.devices()
    inp = dict(np.load({inputs!r}))
    res = {{}}
    for name in {variants!r}:
        spec, edits, steps = tm.guard_cases()[name]
        exp = Experiment.load(os.path.join({root!r}, tm.GUARD_SPECS[spec]))
        run = build(exp.edit(**{{"schedule.steps": steps,
                                "execution.mesh": tm.MESH, **edits}}))
        st = run.init(jax.random.PRNGKey(0))

        def put(bufs, key, dtype=None):
            trees = flat.unflatten_tree(run.step.spec, bufs)
            new = {{}}
            for sec, tree in trees.items():
                leaves, td = jax.tree.flatten(tree)
                got = [inp[f"{{name}}/{{key}}/{{sec}}/{{i}}"]
                       for i in range(len(leaves))]
                assert [l.shape for l in leaves] == [g.shape for g in got]
                new[sec] = jax.tree.unflatten(td, [jnp.asarray(g)
                                                   for g in got])
            return flat.flatten_tree(run.step.spec, new, batch_dims=1,
                                     dtype=dtype)

        st = st._replace(vars=put(st.vars, "vars"),
                         mom=put(st.mom, "mom", jnp.float32))
        st = jax.device_put(st, run.shardings(st))
        btd = jax.tree.structure(run.batch_fn(jax.random.PRNGKey(0)))
        step = jax.jit(run.step)
        for t in range(1, steps + 1):
            b = run.place_batch(jax.tree.unflatten(btd, [
                jnp.asarray(inp[f"{{name}}/batch{{t}}/{{i}}"])
                for i in range(btd.num_leaves)]))
            if t == steps:
                # each buffer's response to a 1e-7 change of the variables
                a, _ = step(st, b)
                c, _ = step(st._replace(vars=tuple(
                    v * (1 + 1e-7) for v in st.vars)), b)
                res[name + "/spread"] = np.array([
                    float(np.linalg.norm(np.asarray(x, np.float32)
                                         - np.asarray(y, np.float32))
                          / np.linalg.norm(np.asarray(x, np.float32)))
                    for x, y in zip(a.vars + a.mom, c.vars + c.mom)])
            st, met = step(st, b)
            for k, v in met.items():
                if k != "step":
                    res[f"{{name}}/m{{t}}/{{k}}"] = np.asarray(v)
            if t >= steps - 1:
                view = run.views(st)
                for f in tm.FIELDS["fedbioacc"]:
                    for i, leaf in enumerate(jax.tree.leaves(
                            getattr(view, f))):
                        res[f"{{name}}/s{{t}}/{{f}}/{{i}}"] = np.asarray(leaf)
    np.savez({out!r}, **res)
    print("REFERENCE_OK")
""")


def _reference_inputs(path: str) -> None:
    """The port's initial state (each section's leaves) and batches of the
    three specs as edited, written for the JAX subprocess."""
    from repro_torch.api import build
    from repro_torch.core.tree_util import tree_leaves
    from repro_torch.optim import flat
    arrays = {}
    for name in VARIANTS:
        run = build(tm.guard_experiment(ROOT, name), device="cpu")
        seed = run.spec.schedule.seed
        state = run.init(torch.Generator().manual_seed(seed))
        for key, bufs in (("vars", state.vars), ("mom", state.mom)):
            for sec, tree in flat.unflatten_tree(run.step.spec,
                                                 bufs).items():
                for i, leaf in enumerate(tree_leaves(tree)):
                    arrays[f"{name}/{key}/{sec}/{i}"] = leaf.numpy()
        gen = torch.Generator().manual_seed(seed)
        for t in range(1, run.steps + 1):
            for i, leaf in enumerate(tree_leaves(run.batch_fn(gen))):
                arrays[f"{name}/batch{t}/{i}"] = leaf.numpy()
    np.savez(path, **arrays)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(what the JAX subprocess wrote, rank 0's records of the three on the
    mesh, the drift's rounding slack of each step of the variants with
    in-band metrics: :func:`test_torch_sharded_engine._unsharded`)."""
    tmp = str(tmp_path_factory.mktemp("sharded_reference"))
    inputs, ref_out, mesh_out = (os.path.join(tmp, n) for n in (
        "inputs.npz", "ref.npz", "mesh.npz"))
    _reference_inputs(inputs)
    slack = {}

    def unsharded_slack():
        # the port's unsharded runs of the specs with telemetry, while the
        # ranks run: only their drift slack is used
        with pytest.MonkeyPatch.context() as mp:
            for name in VARIANTS:
                if tm.guard_experiment(ROOT, name).telemetry is not None:
                    slack[name] = _unsharded(name, mp)[2]
                    mp.undo()

    tm.run_ranks(tm.guard_ranks, tmp, mesh_out, ROOT, VARIANTS, timeout=600,
                 during=unsharded_slack)
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["JAX_PLATFORMS"] = "cpu"
    script = _REF.format(tests=os.path.dirname(os.path.abspath(__file__)),
                         inputs=inputs, variants=VARIANTS, root=ROOT,
                         out=ref_out)
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0 and "REFERENCE_OK" in proc.stdout, \
        proc.stderr[-3000:]
    return dict(np.load(ref_out)), dict(np.load(mesh_out)), slack


@pytest.mark.parametrize("name,field", [(n, f) for n in VARIANTS
                                        for f in tm.FIELDS["fedbioacc"]])
def test_reference_mesh_matches_the_port(runs, name, field):
    """The reference's mesh run against the port's mesh run of the same
    spec from the same initial state and batches, one field a case, at the
    last two steps."""
    ref, mesh, _ = runs
    want = _guard(ref, name)
    # the reference's response of its momentum buffer ([vars, mom])
    _check_fields(_guard(mesh, name), want, name, float(want["spread"][-1]),
                  fields=(field,))


def test_reference_mesh_metrics_match_the_port(runs):
    """The telemetry spec's in-band metrics of every step (the others
    have none: no key on either side)."""
    ref, mesh, slack = runs
    for name in VARIANTS:
        _check_metrics(_guard(mesh, name), _guard(ref, name), name,
                       slack.get(name, ()))
