"""The port's continuous-batching ``ServeEngine`` against the JAX package's
and against its own isolated decoding, in f32 at reduced sizes on the
reference's parameters (``params_from_numpy``), and the serve CLI and both
serving examples on the CPU.

The reference's claim (``tests/test_serving_engine.py``): interleaved
decoding through a fixed pool of slots gives every request exactly the
tokens it gets decoded alone, with slot reuse (5 requests, 2 slots) and
with EOS freeing a slot.  Here each request is first decoded alone on the
port, and every greedy choice's top-2 logit margin is asserted to exceed
``MARGIN`` of the largest logit (far above the port's difference from the
reference, 1e-5 of it: ``tests/test_torch_families.py``) before the tokens
of the port's engine, of its isolated decoding and of the reference's
engine are asserted equal."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from repro.serving import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.examples import serve_batched  # noqa: E402
from repro_torch.examples import serve_continuous_batching  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.serving import ServeEngine  # noqa: E402
from repro_torch.testing import isolated_greedy, top2_margin  # noqa: E402
from torch_parity import to_torch  # noqa: E402

torch.set_num_threads(1)

ENGINE_ARCHS = ["granite-8b", "mamba2-130m", "olmoe-1b-7b",
                "recurrentgemma-9b"]
MARGIN = 1e-4
CACHE_LEN = 64


def _models(arch):
    jm = jbuild(JARCHS[arch].reduced(), dtype=jnp.float32)
    tm = build_model(get_config(arch).reduced(), dtype=torch.float32)
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, tm, jp, to_torch(jp)


def _isolated_checked(tm, tp, prompt, max_new, cache_len):
    """The port's isolated greedy decode, every choice's margin asserted."""
    tokens, logits = isolated_greedy(tm, tp, torch.from_numpy(prompt),
                                     max_new, cache_len)
    for i, lg in enumerate(logits):
        assert top2_margin(lg) > MARGIN * float(lg.abs().max()), i
    return tokens


@pytest.mark.parametrize("arch", ENGINE_ARCHS)
def test_engine_matches_reference_and_isolated_decode(arch):
    """5 requests of 8, 11, ..., 20 tokens through 2 slots (slot reuse),
    budgets 6, 4, 8, 5, 7."""
    jm, tm, jp, tp = _models(arch)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tm.cfg.vocab_size, (8 + 3 * i,))
               for i in range(5)]
    budgets = [6, 4, 8, 5, 7]
    want = [_isolated_checked(tm, tp, p, n, CACHE_LEN)
            for p, n in zip(prompts, budgets)]
    engine = ServeEngine(tm, tp, max_slots=2, cache_len=CACHE_LEN)
    rids = [engine.submit(p, n) for p, n in zip(prompts, budgets)]
    assert len(engine.active) == 2 and len(engine.waiting) == 3
    results = engine.run_to_completion()
    assert not engine.active and not engine.waiting
    jengine = JServeEngine(jm, jp, max_slots=2, cache_len=CACHE_LEN)
    jrids = [jengine.submit(jnp.asarray(p, jnp.int32), n)
             for p, n in zip(prompts, budgets)]
    jresults = jengine.run_to_completion()
    assert rids == jrids and set(results) == set(jresults) == set(rids)
    for rid, w in zip(rids, want):
        assert results[rid] == w == jresults[rid], (arch, rid)


def test_isolated_decode_at_pool_width():
    """``isolated_greedy`` with ``rows`` copies of the request decodes the
    same tokens from logits within rounding of those at batch 1."""
    _, tm, _, tp = _models("olmoe-1b-7b")
    p = torch.from_numpy(np.random.default_rng(3).integers(
        0, tm.cfg.vocab_size, (13,)))
    t1, l1 = isolated_greedy(tm, tp, p, 6, 32)
    t3, l3 = isolated_greedy(tm, tp, p, 6, 32, rows=3)
    assert t1 == t3
    for a, b in zip(l1, l3):
        assert float((a - b).abs().max()) <= 1e-5 * float(a.abs().max())


def test_engine_eos_frees_slot():
    """One slot: the first request stops at its EOS (the greedy second
    token), then the second runs in the freed slot; as the reference's
    engine does on the same params."""
    jm, tm, jp, tp = _models("granite-8b")
    p = np.random.default_rng(1).integers(0, tm.cfg.vocab_size, (8,))
    iso = _isolated_checked(tm, tp, p, 3, 32)
    for Engine, prompt in ((ServeEngine, p),
                           (JServeEngine, jnp.asarray(p, jnp.int32))):
        engine = Engine(tm if Engine is ServeEngine else jm,
                        tp if Engine is ServeEngine else jp,
                        max_slots=1, cache_len=32)
        rid1 = engine.submit(prompt, max_new=10, eos=iso[1])
        rid2 = engine.submit(prompt, max_new=3)
        results = engine.run_to_completion()
        assert results[rid1] == iso[:2]
        assert results[rid2] == iso[:3]


def test_engine_keeps_one_device_and_reads_the_host_once_a_step(monkeypatch):
    """The pool, positions and tokens live on the parameters' device; a
    step reads its greedy tokens to the host once (``tolist``), never per
    slot."""
    _, tm, _, tp = _models("granite-8b")
    engine = ServeEngine(tm, tp, max_slots=3, cache_len=CACHE_LEN)
    assert engine.device == torch.device("cpu")
    assert engine.pos.device == engine.tok.device == engine.device
    rng = np.random.default_rng(2)
    for n in (5, 6, 7):
        engine.submit(rng.integers(0, tm.cfg.vocab_size, (9,)), n)
    reads = []
    orig = torch.Tensor.tolist

    def counted(t):
        reads.append(tuple(t.shape))
        return orig(t)

    monkeypatch.setattr(torch.Tensor, "tolist", counted)
    monkeypatch.setattr(torch.Tensor, "item", lambda t: pytest.fail("item"))
    engine.step()
    assert reads == [(3,)]
    assert engine.pos.tolist() == [10, 10, 10]


@pytest.mark.parametrize("arch", ["gemma2-2b", "olmoe-1b-7b", "mamba2-130m"])
def test_serve_cli_runs_on_cpu(arch, capsys):
    out = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "20", "--gen", "4"])
    assert tuple(out["tokens"].shape) == (2, 4)
    assert out["logits"].shape == (2, 512)
    assert bool(torch.isfinite(out["logits"]).all())
    assert f"arch={arch} device=cpu prefill 2x20" in capsys.readouterr().out


@pytest.mark.parametrize("arch,msg", [
    ("hubert-xlarge", "encoder-only architecture has no decode step"),
    ("internvl2-76b", "the vlm front end.*Other model families and "
                      "serving")])
def test_serve_cli_refuses_audio_and_vlm(arch, msg):
    """The audio encoder is refused by the reference's words; the VLM,
    refused until its front end was ported, now serves (its patches before
    the prompt)."""
    argv = ["--arch", arch, "--reduced", "--device", "cpu"]
    if arch == "internvl2-76b":
        out = serve.main(argv + ["--batch", "2", "--prompt-len", "10",
                                 "--gen", "3"])
        assert tuple(out["tokens"].shape) == (2, 3)
        assert bool(torch.isfinite(out["logits"]).all())
        return
    with pytest.raises(SystemExit, match=msg):
        serve.main(argv)


def test_serving_examples_run_on_cpu(capsys):
    out = serve_batched.main(["--device", "cpu"])
    assert tuple(out["tokens"].shape) == (4, 24)
    results = serve_continuous_batching.main(["--device", "cpu"])
    assert {rid: len(t) for rid, t in results.items()} == \
        dict(enumerate(serve_continuous_batching.BUDGETS))
    assert "served 6 requests / 34 tokens through 2 slots" in \
        capsys.readouterr().out
