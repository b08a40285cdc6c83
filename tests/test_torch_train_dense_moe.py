"""Training the dense and MoE families against the JAX package: FedBiOAcc
as ``experiments/fedbioacc.json`` runs it (2 clients, seq 32, fused STORM
and fused forward-over-reverse oracles) with the arch edited to gemma2-2b
(alternating local and global attention, both soft caps) and to
granite-moe-1b-a400m (top-k routing, the dense combine, the auxiliary term
in f and g), and FedBiOAcc-Local (``experiments/fedbioacc_local.json``: 4
clients, 2 a round; ``fused_local_oracles``) on the MoE, each reduced, two
steps (one communication round) from the reference's initial state on the
reference's batches (``torch_parity.paired_steps``).

Per section of the flat layout, the variables within ``TOL_VARS`` and the
momenta within ``TOL_MOM`` of the reference's norm (the oracles' reductions
run in other orders; the variables move by lr times a momentum, so they
agree more closely than the 1e-4 the momenta are held to).  Before any
MoE result is compared, every routing the two steps take (each client, at
each entering iterate and each communicated one, on its train and
validation batch) is asserted to have a top-k + 1 gap above
``ROUTE_GAP``."""
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro_torch.core.tree_util import client_slice  # noqa: E402
from torch_parity import (bits, paired_steps, route_probs,  # noqa: E402
                          routes_gap, section_errors)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SPECS = {"fedbioacc": ROOT / "experiments" / "fedbioacc.json",
         "fedbioacc_local": ROOT / "experiments" / "fedbioacc_local.json"}
CASES = [("fedbioacc", "gemma2-2b"), ("fedbioacc", "granite-moe-1b-a400m"),
         ("fedbioacc_local", "granite-moe-1b-a400m")]
STEPS = 2
TOL_VARS, TOL_MOM = 1e-5, 1e-4
ROUTE_GAP = 2e-6


def _gaps(gaps: list):
    """``on_state`` for ``paired_steps``: the smallest routing gap of each
    client's forward at ``state`` on its train and validation batch."""
    def on_state(run, state, batch):
        cfg = run.model_cfg
        if not cfg.num_experts:
            return
        s = run.views(state)
        for m in range(run.fed.num_clients):
            p = client_slice({"body": s.x, "head": s.y}, m)
            for split in ("train", "val"):
                for probs in route_probs(run.model, p,
                                         client_slice(batch[split], m)):
                    gaps.append(routes_gap(probs, cfg.experts_per_token))
    return on_state


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def pair(request):
    algo, arch = request.param
    gaps = []
    out = paired_steps(SPECS[algo], {"problem.arch": arch}, STEPS,
                       _gaps(gaps))
    return (algo, arch, gaps) + out


def test_steps_match_reference(pair):
    algo, arch, gaps, jrun, run, jstate, state, _ = pair
    if run.model_cfg.num_experts:
        # 2 steps x 2 iterates + the last, per client, train and val
        assert len(gaps) == 3 * run.fed.num_clients * 2 * \
            run.model_cfg.num_layers
        assert min(gaps) > ROUTE_GAP, min(gaps)
    assert state.step == int(jstate.step) == STEPS
    spec = run.init.spec
    assert [g.padded for g in spec.groups] == \
        [g.padded for g in jrun.step.spec.groups]
    for what, got, want, tol in (("vars", state.vars, jstate.vars, TOL_VARS),
                                 ("mom", state.mom, jstate.mom, TOL_MOM)):
        errs = section_errors(spec, got, want)
        assert sorted(errs) == sorted(spec.sections)
        for sec, err in errs.items():
            assert err <= tol, (algo, arch, what, sec, err)


def test_update_kernel_once_per_buffer_a_step(pair):
    _, _, _, _, run, _, _, calls = pair
    assert calls == STEPS * len(run.init.spec.groups)


def test_round_synchronises_the_shared_sections(pair):
    """After the round: the communicated sections bit-identical across the
    clients that took part (all of them under the full sampler), FedBiOAcc-
    Local's private heads not; the staleness counters the reference's."""
    algo, _, _, _, run, jstate, state, _ = pair
    spec = run.init.spec
    if run.init.participation is None:
        ins = list(range(run.fed.num_clients))
        private = set()
    else:
        mask = run.init.participation.mask_fn(0)
        ins = [m for m in range(len(mask)) if mask[m] > 0]
        private = {"y"}
        np.testing.assert_array_equal(state.stale.numpy(),
                                      np.asarray(jstate.stale))
    for buf, grp in zip(state.vars, spec.groups):
        for s, a, b in grp.extents:
            rows = [bits(buf[m, a:b]) for m in ins]
            same = all(np.array_equal(rows[0], r) for r in rows[1:])
            assert same == (spec.sections[s] not in private), \
                (algo, spec.sections[s])


def test_validation_loss_is_finite(pair):
    _, _, _, _, run, _, state, _ = pair
    assert np.isfinite(run.eval_fn(state))
