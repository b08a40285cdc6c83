"""The unfused tree path (``fuse_storm=false``, the reference's default) of
the five algorithms, against the JAX package's and on the reference's own
tests of that path (reduced Mamba-2, f32).

Against the reference: each algorithm's committed spec edited to the tree
path with 4 clients in 2 pods (``hierarchy_period`` 2: round 1 pod-local,
round 2 global), the ``uniform`` sampler taking 2 a round with staleness
discount 0.5, and for FedBiO and FedBiOAcc u at a cadence of 2; two
steps (``local_steps`` 1, two rounds) from the reference's initial state
on its batches, one reference jit per algorithm.  Each variable field
must agree within 1e-5 of its norm and each momentum field within 1e-4
(the oracles' reductions run in other orders; measured at most 7.5e-7
and 4.6e-6), the staleness counters bit for bit.  The same states go
through each package's checkpoints, read by the other leaf for leaf, and
the train CLI without ``--fuse-storm`` stops after step 2 and resumes bit
for bit.

Restated on the port: clients drift then sync and the losses descend
(``tests/test_federation_trainer.py``), the pod-local then global sync
and the flat schedule (``test_hierarchical.py``), private heads and
momenta (``test_local_lower_trainer.py``), fused against unfused under
2-of-4 participation at rtol 1e-4 / atol 1e-5, unfused staleness against
fused, undiscounted states without counters (``test_participation.py``)
and a built run bit for bit its factory's (``test_api_spec.py``)."""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro_torch.api import Experiment, build  # noqa: E402
from repro_torch.api.build import federated_config  # noqa: E402
from repro_torch.checkpoint import load_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.config import FederatedConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.tree_util import client_slice, tree_leaves  # noqa: E402
from repro_torch.data.synthetic import make_fed_batch_fn  # noqa: E402
from repro_torch.federation import trainer as tr  # noqa: E402
from repro_torch.federation.participation import ParticipationSpec  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from torch_parity import bits, field_errors, paired_steps  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
ALGOS = {"fedbio": ("x", "y", "u"),
         "fedbioacc": ("x", "y", "u", "omega", "nu", "q"),
         "fedbio_local": ("x", "y"),
         "fedbioacc_local": ("x", "y", "omega", "nu"),
         "fedavg": ("params", "mom")}
MOMENTA = {"omega", "nu", "q", "mom"}
PARITY_EDITS = {"execution.fuse_storm": False, "problem.num_clients": 4,
                "problem.seq_len": 16, "schedule.local_steps": 1,
                "schedule.steps": 2, "schedule.hierarchy_period": 2,
                "schedule.hierarchy_groups": 2,
                "participation.sampler": "uniform",
                "participation.clients_per_round": 2,
                "participation.seed": 11,
                "participation.stale_discount": 0.5}


def _parity_edits(algo):
    if algo in ("fedbio", "fedbioacc"):
        return {**PARITY_EDITS, "schedule.comm_every": {"u": 2}}
    return PARITY_EDITS


@pytest.fixture(scope="module")
def paired():
    """``paired(algo)``: the two steps of each package, run once."""
    done = {}

    def get(algo):
        if algo not in done:
            done[algo] = paired_steps(ROOT / "experiments" / f"{algo}.json",
                                      _parity_edits(algo), 2)
        return done[algo]
    return get


@pytest.mark.parametrize("algo", sorted(ALGOS))
def test_unfused_step_matches_reference(paired, algo):
    jrun, run, jstate, state, calls = paired(algo)
    assert type(state).__name__ == type(jstate).__name__
    assert state.step == int(jstate.step) == 2 and calls == 0
    # a client absent from a round returns with an aged weight
    np.testing.assert_array_equal(state.stale.numpy(),
                                  np.asarray(jstate.stale))
    assert int(state.stale.max()) > 0
    errs = field_errors(state, jstate, ALGOS[algo])
    for name, err in errs.items():
        assert err <= (1e-4 if name in MOMENTA else 1e-5), errs


def _leaves_equal(port_leaves, ref_leaves):
    assert len(port_leaves) == len(ref_leaves)
    for a, b in zip(port_leaves, ref_leaves):
        np.testing.assert_array_equal(bits(torch.as_tensor(a)), bits(b))


def test_unfused_checkpoints_read_both_ways(paired, tmp_path):
    """FedBiOAcc-Local's state after two steps (with staleness counters)
    saved by each package and loaded by the other, leaf for leaf; the
    manifests alike (structure, paths, dtypes, shapes), the step an int32
    scalar."""
    from repro.checkpoint import load_checkpoint as jload
    from repro.checkpoint import save_checkpoint as jsave

    jrun, run, jstate, state, _ = paired("fedbioacc_local")
    save_checkpoint(str(tmp_path / "port"), state, {"step": state.step})
    jsave(str(tmp_path / "ref"), jstate, {"step": int(jstate.step)})
    manifests = [json.loads((tmp_path / d / "manifest.json").read_text())
                 for d in ("port", "ref")]
    assert manifests[0]["treedef"] == manifests[1]["treedef"]
    assert manifests[0]["leaves"] == manifests[1]["leaves"]
    assert {"path": ".step", "dtype": "int32", "shape": []} in \
        manifests[0]["leaves"]
    back = jload(str(tmp_path / "port"),
                 jax.eval_shape(jrun.init, jax.random.PRNGKey(0)))
    _leaves_equal(tree_leaves(state._replace(step=torch.tensor(
        2, dtype=torch.int32))), jax.tree.leaves(back))
    mine = load_checkpoint(str(tmp_path / "ref"),
                           run.init(torch.Generator().manual_seed(0)))
    assert type(mine) is tr.FedBiOAccLocalTrainState and mine.step == 2
    assert mine.deadline == () and mine.retry == ()
    _leaves_equal(tree_leaves(mine._replace(step=torch.tensor(
        2, dtype=torch.int32))), jax.tree.leaves(jstate))


def test_cli_unfused_crash_and_resume(tmp_path, monkeypatch):
    """``--reduced --algo fedbioacc --steps 4 --clients 4 --per-client 2
    --seq 32`` without ``--fuse-storm`` (the tree path): a run that hard
    exits after its step-2 checkpoint (``--crash-at-step 2``) and its
    ``--resume`` end as the uninterrupted run: every logged line, every
    array of the final checkpoint; the lines carry no decision fields."""
    flags = ["--arch", "mamba2-130m", "--reduced", "--algo", "fedbioacc",
             "--steps", "4", "--clients", "4", "--per-client", "2",
             "--seq", "32", "--device", "cpu", "--log-every", "1",
             "--ckpt-every", "2"]

    def crash(code):
        raise SystemExit(code)

    strip = lambda hs: [{k: v for k, v in h.items()  # noqa: E731
                         if k != "wall_s"} for h in hs]
    full = strip(train_cli.main(flags + ["--ckpt-dir",
                                         str(tmp_path / "whole")]))
    monkeypatch.setattr(train_cli.os, "_exit", crash)
    with pytest.raises(SystemExit) as err:
        train_cli.main(flags + ["--ckpt-dir", str(tmp_path / "crashed"),
                                "--crash-at-step", "2"])
    assert err.value.code == 17
    resumed = strip(train_cli.main(
        ["--resume", str(tmp_path / "crashed"), "--device", "cpu",
         "--ckpt-dir", str(tmp_path / "crashed"), "--log-every", "1",
         "--ckpt-every", "2"]))
    assert resumed == full[2:] and len(full) == 4
    assert all(set(h) == {"step", "val_loss"} for h in full)
    assert all(np.isfinite(h["val_loss"]) for h in full)
    arrays = []
    for d in ("whole", "crashed"):
        with np.load(tmp_path / d / "arrays-00000004.npz") as data:
            arrays.append([data[f"a{i}"] for i in range(len(data.files))])
    _leaves_equal(*arrays)
    meta = json.loads((tmp_path / "whole" / "manifest.json").read_text())
    assert "FedBiOAccTrainState" in meta["treedef"]


# ---------------------------------------------------------------------------
# the reference's tests of the tree path, restated on the port
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mamba():
    """Reduced Mamba-2 at one layer, d_model 128, vocab 256 (the
    restated tests' time)."""
    cfg = get_config("mamba2-130m").reduced(num_layers=1, d_model=128,
                                            vocab_size=256)
    return cfg, build_model(cfg, dtype=torch.float32)


def _fed(m, local_steps, **kw):
    return FederatedConfig(num_clients=m, local_steps=local_steps,
                           lr_x=0.05, lr_y=0.05, lr_u=0.05, **kw)


def _run(maker, model, fed, batch_fn, steps, **kw):
    init, step = maker(model, fed, **{"n_micro": 1, "remat": False, **kw})
    state = init(torch.Generator().manual_seed(0))
    data = torch.Generator().manual_seed(1)
    states = []
    for _ in range(steps):
        state, _ = step(state, batch_fn(data))
        states.append(state)
    return init, step, states


def _spread(tree):
    return max(float(v.float().std(dim=0, unbiased=False).max())
               for v in tree_leaves(tree))


def _pair_spread(tree, a, b):
    return max(float((v[a].float() - v[b].float()).abs().max())
               for v in tree_leaves(tree))


@pytest.mark.parametrize("maker", [tr.make_fedbio_train_step,
                                   tr.make_fedbioacc_train_step])
def test_clients_drift_then_sync(mamba, maker):
    """Between rounds the clients' states diverge; at step % I == 0 they
    are averaged exactly."""
    cfg, model = mamba
    bf = make_fed_batch_fn(cfg, num_clients=4, per_client=1, seq_len=16)
    init, _, states = _run(maker, model, _fed(4, 3), bf, 3)
    assert _spread(init(torch.Generator().manual_seed(0)).x) == 0.0
    spreads = [_spread(s.x) for s in states]
    if maker is tr.make_fedbio_train_step:
        assert spreads[0] > 0.0
    assert spreads[1] > 0.0 and spreads[2] == 0.0, spreads


@pytest.mark.parametrize("algo", ["fedbioacc", "fedavg"])
def test_losses_descend(algo):
    """Six steps at lr 0.2 on reduced Mamba-2 at its two layers: the
    reference test's 0.05 (written for reduced granite-8b) leaves
    FedBiOAcc's loss rising over 12 steps there in both packages, and at
    one layer it rises at 0.1-0.3 too."""
    cfg = get_config("mamba2-130m").reduced()
    model = build_model(cfg, dtype=torch.float32)
    bf = make_fed_batch_fn(cfg, num_clients=2, per_client=2, seq_len=32)
    maker = getattr(tr, f"make_{algo}_train_step")
    fed = dataclasses.replace(_fed(2, 3), lr_x=0.2, lr_y=0.2, lr_u=0.2)
    init, _, states = _run(maker, model, fed, bf, 6)
    b = client_slice(bf(torch.Generator().manual_seed(99))["val"], 0)

    def val(s):
        p = (s.params if algo == "fedavg"
             else {"body": s.x, "head": s.y})
        with torch.no_grad():
            return float(model.loss(client_slice(p, 0), b)[0])

    l0, lT = val(init(torch.Generator().manual_seed(0))), val(states[-1])
    assert lT < l0 and np.isfinite(lT), (l0, lT)


def test_microbatching_matches_full_batch(mamba):
    """n_micro 2 with remat against n_micro 1 without, one FedBiO step."""
    cfg, model = mamba
    bf = make_fed_batch_fn(cfg, num_clients=4, per_client=2, seq_len=16)
    xs = [_run(tr.make_fedbio_train_step, model, _fed(4, 3), bf, 1,
               **kw)[2][0].x
          for kw in ({}, {"n_micro": 2, "remat": True})]
    for a, b in zip(tree_leaves(xs[0]), tree_leaves(xs[1])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=5e-5,
                                   rtol=5e-4)


def test_pod_local_then_global_sync(mamba):
    cfg, model = mamba
    fed = _fed(4, 1, hierarchy_period=3, hierarchy_groups=2)
    bf = make_fed_batch_fn(cfg, num_clients=4, per_client=1, seq_len=16,
                           hetero_alpha=0.1)
    _, _, states = _run(tr.make_fedbio_train_step, model, fed, bf, 3)
    # rounds 1 and 2 pod-local: clients 0, 1 agree, the pods differ
    for s in states[:2]:
        assert _pair_spread(s.x, 0, 1) == 0.0
        assert _pair_spread(s.x, 0, 2) > 1e-6
    # round 3 global: everyone agrees
    assert _pair_spread(states[2].x, 0, 2) == 0.0
    assert _pair_spread(states[2].x, 1, 3) == 0.0


def test_flat_schedule_unchanged(mamba):
    """hierarchy_period 0 and 1 (one pod) are the paper's flat averaging,
    bit for bit."""
    cfg, model = mamba
    bf = make_fed_batch_fn(cfg, num_clients=2, per_client=1, seq_len=16)
    out = [_run(tr.make_fedbio_train_step, model, fed, bf, 2)[2][-1]
           for fed in (_fed(2, 2), _fed(2, 2, hierarchy_period=1,
                                        hierarchy_groups=1))]
    for a, b in zip(tree_leaves(out[0]), tree_leaves(out[1])):
        assert (bits(a) == bits(b)).all()


@pytest.mark.parametrize("algo", ["fedbio_local", "fedbioacc_local"])
def test_private_heads_and_momenta(mamba, algo):
    """The local-lower algorithms: at the round the body (and ν) is
    averaged, the heads (and ω) stay personalised."""
    cfg, model = mamba
    fed = dataclasses.replace(_fed(3, 2), lr_x=0.02, neumann_q=3,
                              neumann_tau=0.3)
    bf = make_fed_batch_fn(cfg, num_clients=3, per_client=2, seq_len=16)
    init, _, states = _run(getattr(tr, f"make_{algo}_train_step"), model,
                           fed, bf, 2)
    assert _spread(init(torch.Generator().manual_seed(0)).y) > 0.0
    s = states[1]
    assert _spread(s.x) == 0.0 and _spread(s.y) > 1e-4
    if algo == "fedbioacc_local":
        assert _spread(s.nu) == 0.0 and _spread(s.omega) > 0.0
    assert all(torch.isfinite(v).all() for v in tree_leaves(s.x))


def test_local_lower_loss_descends(mamba):
    """FedBiO-Local, 2 clients, lr_x 0.02 and lr_y 0.3 as the reference's
    test; four steps (its 20 cost the time of the whole file)."""
    cfg, model = mamba
    fed = dataclasses.replace(_fed(2, 2), lr_x=0.02, lr_y=0.3, neumann_q=4,
                              neumann_tau=0.3)
    bf = make_fed_batch_fn(cfg, num_clients=2, per_client=2, seq_len=32)
    init, _, states = _run(tr.make_fedbio_local_train_step, model, fed, bf,
                           4)
    b = client_slice(bf(torch.Generator().manual_seed(7))["val"], 0)

    def val(s):
        with torch.no_grad():
            return float(model.loss({"body": client_slice(s.x, 0),
                                     "head": client_slice(s.y, 0)}, b)[0])
    l0, lT = val(init(torch.Generator().manual_seed(0))), val(states[-1])
    assert lT < l0 and np.isfinite(lT), (l0, lT)


@pytest.fixture(scope="module")
def participation_setup(mamba):
    cfg, model = mamba
    fed = dataclasses.replace(_fed(4, 1), neumann_q=2, neumann_tau=0.3)
    bf = make_fed_batch_fn(cfg, num_clients=4, per_client=1, seq_len=16)
    return model, fed, bf


def _views(step, state):
    return step.views(state) if hasattr(step, "views") else state


@pytest.mark.parametrize("algo", sorted(ALGOS))
def test_fused_matches_unfused_under_partial_participation(
        participation_setup, algo):
    """uniform(m = 2 of 4), two rounds of one step: the fused engine and
    the tree path (where-freezes and weighted per-leaf means) agree."""
    model, fed, bf = participation_setup
    maker = getattr(tr, f"make_{algo}_train_step")
    pspec = ParticipationSpec("uniform", 2, seed=11)
    out = []
    for kw in ({}, {"fuse_storm": True, "storm_block": 256}):
        _, step, states = _run(maker, model, fed, bf, 2,
                               participation=pspec, **kw)
        out.append(_views(step, states[-1]))
    for n in ALGOS[algo]:
        for a, b in zip(tree_leaves(getattr(out[0], n)),
                        tree_leaves(getattr(out[1], n))):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=f"{algo}.{n}")


@pytest.mark.parametrize("local_steps", [1, 2])
@pytest.mark.parametrize("algo", ["fedbioacc", "fedbioacc_local"])
def test_unfused_staleness_matches_fused(participation_setup, algo,
                                         local_steps):
    """stale_discount 0.3 on the tree path, two rounds: its counters equal
    the fused engine's bit for bit and its discounted trajectory the
    engine's."""
    model, fed, bf = participation_setup
    fed = dataclasses.replace(fed, local_steps=local_steps)
    maker = getattr(tr, f"make_{algo}_train_step")
    pspec = ParticipationSpec("uniform", 2, seed=11, stale_discount=0.3)
    finals = []
    for kw in ({}, {"fuse_storm": True, "storm_block": 256}):
        _, step, states = _run(maker, model, fed, bf, 2 * local_steps,
                               participation=pspec, **kw)
        finals.append((states[-1], _views(step, states[-1])))
    (st_u, v_u), (st_f, v_f) = finals
    assert torch.equal(st_u.stale, st_f.stale) and int(st_u.stale.max()) > 0
    for n in ALGOS[algo]:
        for a, b in zip(tree_leaves(getattr(v_u, n)),
                        tree_leaves(getattr(v_f, n))):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=f"{algo}.{n}")


def test_undiscounted_unfused_states_carry_no_counters(participation_setup):
    model, fed, _ = participation_setup
    init, step = tr.make_fedbioacc_train_step(
        model, fed, participation=ParticipationSpec("uniform", 2))
    assert init(torch.Generator().manual_seed(0)).stale == ()
    assert step.participation.spec.clients_per_round == 2


@pytest.mark.parametrize("algo", sorted(ALGOS))
def test_built_run_bit_identical_to_factory(algo):
    """``build(Experiment.from_json(exp.to_json()))`` on the tree path
    reproduces the direct factory call bit for bit (under 2-of-4 uniform
    participation for the STORM algorithms)."""
    exp = Experiment().edit(**{
        "algorithm.name": algo, "problem.arch": "mamba2-130m",
        "problem.reduced": True, "problem.num_clients": 4,
        "problem.per_client": 1, "problem.seq_len": 16, "schedule.steps": 2,
              "schedule.local_steps": 2, "schedule.lr_x": 0.05,
              "schedule.lr_y": 0.05, "schedule.lr_u": 0.05,
              "schedule.neumann_q": 2, "schedule.neumann_tau": 0.3})
    part = None
    if algo in ("fedbioacc", "fedbioacc_local"):
        part = ParticipationSpec("uniform", 2, seed=7)
        exp = exp.edit(**{"participation.sampler": "uniform",
                          "participation.clients_per_round": 2,
                          "participation.seed": 7})
    assert not exp.execution.fuse_storm
    run = build(Experiment.from_json(exp.to_json()), device="cpu")
    maker = getattr(tr, f"make_{algo}_train_step")
    runs = [(run.init, run.step),
            maker(run.model, federated_config(exp), n_micro=1, remat=False,
                  participation=part)]
    finals = []
    for init, step in runs:
        state = init(torch.Generator().manual_seed(0))
        data = torch.Generator().manual_seed(1)
        for _ in range(2):
            state, _ = step(state, run.batch_fn(data))
        finals.append(run.views(state))
    for n in ALGOS[algo]:
        for a, b in zip(tree_leaves(getattr(finals[0], n)),
                        tree_leaves(getattr(finals[1], n))):
            assert (bits(a) == bits(b)).all(), f"{algo}.{n}"
