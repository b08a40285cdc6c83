"""Training the hybrid family and the two front ends against the JAX
package: FedBiOAcc as ``experiments/fedbioacc.json`` runs it (2 clients,
seq 32, fused STORM and fused forward-over-reverse oracles) with the arch
edited to recurrentgemma-9b (the RG-LRU's doubling scan, which agrees with
``lax.associative_scan`` to f32 rounding, and the causal conv),
hubert-xlarge (the audio encoder: projected frames, non-causal attention,
the ungated MLP) and internvl2-76b (the VLM: projected patches before the
tokens, the label offset), each reduced, two steps (one communication
round) from the reference's initial state on the reference's batches
(``torch_parity.paired_steps``; the frames and patches cross in bf16).

Per section of the flat layout, the variables within ``TOL_VARS`` and the
momenta within ``TOL_MOM`` of the reference's norm, as in
``tests/test_torch_train_dense_moe.py``."""
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from torch_parity import bits, paired_steps, section_errors  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SPEC = ROOT / "experiments" / "fedbioacc.json"
ARCHS = ["recurrentgemma-9b", "hubert-xlarge", "internvl2-76b"]
STEPS = 2
TOL_VARS, TOL_MOM = 1e-5, 1e-4


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return (request.param,) + paired_steps(
        SPEC, {"problem.arch": request.param}, STEPS)


def test_steps_match_reference(pair):
    arch, jrun, run, jstate, state, _ = pair
    assert state.step == int(jstate.step) == STEPS
    spec = run.init.spec
    assert [g.padded for g in spec.groups] == \
        [g.padded for g in jrun.step.spec.groups]
    for what, got, want, tol in (("vars", state.vars, jstate.vars, TOL_VARS),
                                 ("mom", state.mom, jstate.mom, TOL_MOM)):
        errs = section_errors(spec, got, want)
        assert sorted(errs) == ["u", "x", "y"]
        for sec, err in errs.items():
            assert err <= tol, (arch, what, sec, err)


def test_batches_carry_the_front_ends(pair):
    """The reference's streams as the port receives them: frames or
    patches in bf16 beside the labels."""
    arch, jrun, run, *_ = pair
    batch = jrun.batch_fn(jax.random.PRNGKey(0))["train"]
    want = {"hubert-xlarge": ["frames", "labels"],
            "internvl2-76b": ["labels", "patches", "tokens"],
            "recurrentgemma-9b": ["labels", "tokens"]}[arch]
    assert sorted(batch) == want
    for k in ("frames", "patches"):
        if k in batch:
            assert str(batch[k].dtype) == "bfloat16"
    assert run.model_cfg.family == {"hubert-xlarge": "audio",
                                    "internvl2-76b": "vlm",
                                    "recurrentgemma-9b": "hybrid"}[arch]


def test_update_kernel_once_per_buffer_a_step(pair):
    _, _, run, _, _, calls = pair
    assert calls == STEPS * len(run.init.spec.groups)


def test_round_synchronises_the_clients(pair):
    _, _, run, _, state, _ = pair
    for buf in state.vars:
        np.testing.assert_array_equal(bits(buf[0]), bits(buf[1]))


def test_validation_loss_is_finite(pair):
    _, _, run, _, state, _ = pair
    assert np.isfinite(run.eval_fn(state))
