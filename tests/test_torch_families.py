"""The port's decoder families against the JAX package's, in f32 at reduced
sizes, the reference's own initial parameters carried across by
``params_from_numpy`` and the inputs drawn by numpy:

* the eight ported configs field for field, their stage layouts and the
  full models' parameter trees (the reference's ``test_assigned_configs``);
* per decoder arch (the dense gemma2-2b, granite-8b, granite-3-8b and
  llama3-405b, the MoE olmoe-1b-7b and granite-moe-1b-a400m, the ssm
  mamba2-130m and the hybrid recurrentgemma-9b): ``forward``, ``loss`` with
  ``moe_aux``, ``prefill`` logits and caches and 8 teacher-forced
  ``decode_step``s at a scalar and at a per-request ``pos``; decode equals
  the forward at the same position (``test_decode_consistency``); no
  future token reaches an earlier logit (``test_causality``);
* ``moe_mlp`` on the dense combine and on the capacity dispatch, beyond
  ``MOE_DENSE_TOKEN_LIMIT`` tokens and, with the limit lowered in both
  modules, with tokens dropped;
* the Mamba-2 block's decode cache from prompts shorter than the conv
  window;
* the two front ends build (their parity is ``test_torch_frontends.py``'s;
  the audio encoder's decode step stays refused, by the reference's
  words), and the dense and MoE families train through ``build`` and the
  train CLI's ``--arch`` (their parity with the reference's steps is
  ``test_torch_train_dense_moe.py``'s).

Tolerances: rtol 1e-5 with atol 1e-5 of the largest reference value
(matmul and reduction orders differ between XLA and PyTorch), as in
``tests/test_torch_griffin.py``.  Top-k routing: ``torch.topk`` and
``lax.top_k`` may order equal probabilities differently, so every MoE case
first asserts that consecutive probabilities among each token's top k + 1
differ by more than ``ROUTE_GAP`` (where the layer is called alone, also
that the two routers' probabilities differ by less than a quarter of it,
and that both packages chose the same experts in the same order), and only
then compares outputs."""
import dataclasses
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import stack as jstack  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from repro_torch.api import Experiment, build  # noqa: E402
from repro_torch.config import ModelConfig  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.core.tree_util import tree_leaves  # noqa: E402
from repro_torch.data.synthetic import make_fed_batch_fn  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import layers, ssm, stack  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from torch_parity import f32, route_probs, routes_gap, to_torch  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]

FRONT_ENDS = {"hubert-xlarge": "audio", "internvl2-76b": "vlm"}
DECODERS = ["gemma2-2b", "granite-3-8b", "granite-8b",
            "granite-moe-1b-a400m", "llama3-405b", "mamba2-130m",
            "olmoe-1b-7b", "recurrentgemma-9b"]
# full models' parameter counts (the reference's trees)
PARAMS = {"gemma2-2b": 3_204_046_080, "granite-3-8b": 8_372_187_136,
          "granite-8b": 8_254_689_280, "granite-moe-1b-a400m": 1_384_963_072,
          "llama3-405b": 405_853_388_800, "olmoe-1b-7b": 6_919_096_320}
ROUTE_GAP = 2e-6


def _close(got, want, err_msg=""):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(f32(got), want, rtol=1e-5,
                               atol=1e-5 * max(np.abs(want).max(), 1e-30),
                               err_msg=err_msg)


def _trees_close(got, want):
    jl, tl = jax.tree.leaves(want), tree_leaves(got)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert tuple(a.shape) == tuple(b.shape)
        _close(b, a)


def _routes_clear(probs, k):
    """Every token's top k + 1 router probabilities (the reference's) apart
    by more than ``ROUTE_GAP``: no two orderings of ties can differ."""
    assert routes_gap(probs, k) > ROUTE_GAP


# ---------------------------------------------------------------------------
# configs and layouts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", DECODERS)
def test_config_matches_reference_field_for_field(arch):
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(JARCHS[arch])
    assert dataclasses.asdict(get_config(arch).reduced()) == \
        dataclasses.asdict(JARCHS[arch].reduced())


def test_ported_archs_are_the_references_decoders():
    """The catalog is the reference's ten: these eight decoders and the
    two front ends."""
    assert sorted(a for a in ARCHS if a not in FRONT_ENDS) == DECODERS
    assert set(ARCHS) == set(JARCHS)
    assert {a: JARCHS[a].family for a in FRONT_ENDS} == FRONT_ENDS
    assert {ARCHS[a].family for a in DECODERS} == {"dense", "moe", "ssm",
                                                   "hybrid"}


@pytest.mark.parametrize("arch", DECODERS)
def test_stages_match_reference(arch):
    for cfg, jcfg in ((get_config(arch), JARCHS[arch]),
                      (get_config(arch).reduced(), JARCHS[arch].reduced())):
        assert stack.stages_for(cfg) == jstack.stages_for(jcfg)
    if arch == "gemma2-2b":
        assert stack.stages_for(get_config(arch)) == [(("local", "attn"), 13)]
    elif ARCHS[arch].family in ("dense", "moe"):
        assert stack.stages_for(get_config(arch)) == \
            [(("attn",), ARCHS[arch].num_layers)]


@pytest.mark.parametrize("arch", sorted(PARAMS))
def test_full_param_tree_matches_reference(arch):
    """The full model's tree, shapes and dtypes (meta tensors: nothing is
    allocated), against the reference's ``jax.eval_shape``."""
    jshape = jax.eval_shape(jbuild(JARCHS[arch]).init, jax.random.PRNGKey(0))
    tree = build_model(get_config(arch)).init(None)
    jl, tl = jax.tree.leaves(jshape), tree_leaves(tree)
    assert [(tuple(a.shape), str(a.dtype)) for a in jl] == \
        [(tuple(b.shape), str(b.dtype).replace("torch.", "")) for b in tl]
    assert sum(b.numel() for b in tl) == PARAMS[arch]


# ---------------------------------------------------------------------------
# whole models at reduced size
# ---------------------------------------------------------------------------

_MODELS = {}
PROMPT, GEN = 70, 8


def _models(arch):
    """The reference's reduced model (its forward and loss, prefill and
    decode jitted; the Pallas switches off: the port's switches take their
    plain versions on the CPU), the port's, and one set of parameters."""
    if arch not in _MODELS:
        jcfg, cfg = JARCHS[arch].reduced(), get_config(arch).reduced()
        jm = jbuild(jcfg, dtype=jnp.float32)
        tm = build_model(cfg, dtype=torch.float32)
        jp = jm.init(jax.random.PRNGKey(0))
        jfns = {"forward": jax.jit(lambda p, b: (jm.forward(p, b),
                                                 jm.loss(p, b))),
                "prefill": jax.jit(lambda p, t: jm.prefill(
                    p, {"tokens": t}, cache_len=PROMPT + GEN)),
                "decode": jax.jit(jm.decode_step)}
        _MODELS[arch] = (jfns, tm, jp, to_torch(jp))
    return _MODELS[arch]


def _tokens(seed, vocab, shape):
    return np.random.default_rng(seed).integers(0, vocab, shape)


def _route_probs(tp, tm, tok):
    """Each MoE layer's router probabilities in the port's forward of
    ``tok`` (the reference's agree with them to f32 rounding: its scanned
    stack keeps its own out of reach)."""
    return route_probs(tm, tp, {"tokens": torch.from_numpy(tok)})


@pytest.mark.parametrize("arch", DECODERS)
def test_forward_and_loss_match_reference(arch):
    jfns, tm, jp, tp = _models(arch)
    tok = _tokens(1, tm.cfg.vocab_size, (2, 40))
    labels = tok.copy()
    labels[:, :5] = -1
    if tm.cfg.num_experts:
        for probs in _route_probs(tp, tm, tok):
            _routes_clear(probs, tm.cfg.experts_per_token)
    jb = {"tokens": jnp.asarray(tok, jnp.int32),
          "labels": jnp.asarray(labels, jnp.int32)}
    tb = {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(labels)}
    (jl, jaux), (jloss, jparts) = jfns["forward"](jp, jb)
    tl, taux = tm.forward(tp, tb)
    _close(tl, jl)
    tloss, tparts = tm.loss(tp, tb)
    assert sorted(tparts) == sorted(jparts) == ["ce", "moe_aux"]
    for got, want in ((taux, jaux), (tparts["moe_aux"], jparts["moe_aux"]),
                      (tparts["ce"], jparts["ce"]), (tloss, jloss)):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5,
                                   atol=1e-7)
    assert (float(taux) > 0) == bool(tm.cfg.num_experts)


@pytest.mark.parametrize("per_request", [False, True])
@pytest.mark.parametrize("arch", DECODERS)
def test_prefill_and_decode_match_reference(arch, per_request):
    """Prompt 70 (past the reduced window of 64 and ragged against every
    tile), cache 78, then 8 teacher-forced decode steps; ``pos`` a scalar
    or a ``[B]`` vector (each request at its own position: the second one
    step behind, fed its prompt's last token again)."""
    jfns, tm, jp, tp = _models(arch)
    B, S, gen = 2, PROMPT, GEN
    tok = _tokens(2, tm.cfg.vocab_size, (B, S + gen))
    if tm.cfg.num_experts:
        for probs in _route_probs(tp, tm, tok):
            _routes_clear(probs, tm.cfg.experts_per_token)
    jl, jc = jfns["prefill"](jp, jnp.asarray(tok[:, :S], jnp.int32))
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(tok[:, :S])},
                        cache_len=S + gen, use_flash=True,
                        use_lru_kernel=True)
    _close(tl, jl, "prefill logits")
    _trees_close(tc, jc)
    lag = np.array([0, 1]) if per_request else np.array([0, 0])
    for i in range(gen):
        pos = S + i - lag
        step = tok[np.arange(B), pos][:, None]
        jpos = jnp.asarray(pos, jnp.int32) if per_request else jnp.int32(S + i)
        tpos = torch.from_numpy(pos) if per_request else S + i
        jl, jc = jfns["decode"](jp, jc, jnp.asarray(step, jnp.int32), jpos)
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(step), tpos)
        _close(tl, jl, f"decode step {i}")
    _trees_close(tc, jc)


@pytest.mark.parametrize("arch", DECODERS)
def test_decode_matches_forward(arch):
    """The reference's decode-consistency claim on the port: prefill 32,
    decode the 33rd token, equal to the forward's logits there."""
    _, tm, _, tp = _models(arch)
    tok = torch.from_numpy(_tokens(3, tm.cfg.vocab_size, (2, 33)))
    with torch.no_grad():
        full, _ = tm.forward(tp, {"tokens": tok})
        _, caches = tm.prefill(tp, {"tokens": tok[:, :-1]}, cache_len=37)
        logits, _ = tm.decode_step(tp, caches, tok[:, -1:], 32)
    assert float((logits - full[:, -1]).abs().max()) < 2e-4


@pytest.mark.parametrize("arch", DECODERS)
def test_future_tokens_do_not_leak(arch):
    """The reference's causality claim on the port: changing the tokens
    from position t on leaves every logit before t unchanged."""
    _, tm, _, tp = _models(arch)
    rng = np.random.default_rng(4)
    tok = torch.from_numpy(rng.integers(0, tm.cfg.vocab_size, (1, 32)))
    with torch.no_grad():
        l1, _ = tm.forward(tp, {"tokens": tok})
        for t in (4, 17, 28):
            tok2 = tok.clone()
            tok2[0, t:] = torch.from_numpy(
                rng.integers(0, tm.cfg.vocab_size, (32 - t,)))
            l2, _ = tm.forward(tp, {"tokens": tok2})
            np.testing.assert_allclose(f32(l1[:, :t]), f32(l2[:, :t]),
                                       atol=1e-5)
            assert float((l1[:, t:] - l2[:, t:]).abs().max()) > 1e-4


def test_ring_buffer_wraps():
    """The reference's ring-buffer claim on the port: gemma2-2b's local
    layers (window 64) wrap while decoding 70 → 80, and every step keeps
    the windowed forward's logits."""
    _, tm, _, tp = _models("gemma2-2b")
    tok = torch.from_numpy(_tokens(5, tm.cfg.vocab_size, (1, 80)))
    with torch.no_grad():
        full, _ = tm.forward(tp, {"tokens": tok})
        _, caches = tm.prefill(tp, {"tokens": tok[:, :70]}, cache_len=80)
        for i in range(70, 80):
            logits, caches = tm.decode_step(tp, caches, tok[:, i:i + 1], i)
            assert float((logits - full[:, i]).abs().max()) < 2e-4, i


# ---------------------------------------------------------------------------
# moe_mlp on both paths
# ---------------------------------------------------------------------------

def _moe_case(seed, B, S, router_bias=0.0):
    jcfg = JARCHS["olmoe-1b-7b"].reduced()
    jp = jlayers.moe_init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    x = np.random.default_rng(seed).standard_normal(
        (B, S, jcfg.d_model)).astype(np.float32)
    if router_bias:
        # inputs offset by 0.5 and expert 0's router column raised: every
        # token prefers expert 0, whose buffer overflows
        jp["router"] = jp["router"].at[:, 0].add(router_bias)
        x = x + np.float32(0.5)
    return jcfg, get_config("olmoe-1b-7b").reduced(), jp, x


def _moe_checked(jcfg, cfg, jp, x):
    """Both packages' ``moe_mlp`` on the same params and input, after the
    routing gap and the chosen experts are asserted equal; returns the
    reference's routing."""
    xj = jnp.asarray(x)
    probs = jax.nn.softmax((xj @ jp["router"]).astype(jnp.float32), axis=-1)
    _routes_clear(probs, cfg.experts_per_token)
    _, jidx = jax.lax.top_k(probs, cfg.experts_per_token)
    tp, xt = to_torch(jp), torch.from_numpy(x)
    tprobs = torch.softmax((xt @ tp["router"]).float(), dim=-1)
    assert np.abs(f32(tprobs) - np.asarray(probs)).max() < ROUTE_GAP / 4
    _, tidx = torch.topk(tprobs, cfg.experts_per_token, dim=-1)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    jout, jaux = jlayers.moe_mlp(jp, xj, jcfg)
    tout, taux = layers.moe_mlp(tp, xt, cfg)
    _close(tout, jout)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    return np.asarray(jidx)


def test_moe_dense_combine_matches_reference():
    jcfg, cfg, jp, x = _moe_case(10, 2, 33)
    _moe_checked(jcfg, cfg, jp, x)


def test_moe_capacity_dispatch_beyond_the_limit():
    """B 2, S 4,200: T = 8,400 > ``MOE_DENSE_TOKEN_LIMIT`` takes the
    capacity dispatch in both packages (C = 5,250 a expert)."""
    assert layers.MOE_DENSE_TOKEN_LIMIT == jlayers.MOE_DENSE_TOKEN_LIMIT \
        == 8192
    jcfg, cfg, jp, x = _moe_case(11, 2, 4200)
    _moe_checked(jcfg, cfg, jp, x)


@pytest.mark.parametrize("B,S,bias", [(2, 48, 0.0), (1, 97, 0.01),
                                      (3, 5, 0.02)])
def test_moe_capacity_dispatch_drops_as_reference(B, S, bias, monkeypatch):
    """The limit lowered to 0 in both modules (``monkeypatch``; no file is
    edited): small batches take the capacity dispatch, and a router skewed
    towards expert 0 overflows its buffer, so entries are dropped in token
    order; the dropped ones add nothing in either package."""
    monkeypatch.setattr(layers, "MOE_DENSE_TOKEN_LIMIT", 0)
    monkeypatch.setattr(jlayers, "MOE_DENSE_TOKEN_LIMIT", 0)
    jcfg, cfg, jp, x = _moe_case(12 + S, B, S, bias)
    idx = _moe_checked(jcfg, cfg, jp, x)
    T, k, E = B * S, cfg.experts_per_token, cfg.num_experts
    C = int(T * k // E * 1.25) or 1
    dropped = int(np.maximum(np.bincount(idx.reshape(-1), minlength=E) - C,
                             0).sum())
    assert (dropped > 0) == (bias > 0), dropped


# ---------------------------------------------------------------------------
# the Mamba-2 decode cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [1, 2, 3, 40])
def test_ssm_cache_from_short_prompts(S):
    """Prefill S tokens (S < conv width − 1 = 3 left-pads the conv tail),
    then 4 decode steps: outputs and caches as the reference's."""
    jcfg, cfg = JARCHS["mamba2-130m"].reduced(), \
        get_config("mamba2-130m").reduced()
    jp = jssm.init_ssm(jax.random.PRNGKey(S), jcfg, jnp.float32)
    tp = to_torch(jp)
    x = np.random.default_rng(S).standard_normal(
        (2, S + 4, cfg.d_model)).astype(np.float32)
    japply = jax.jit(jssm.apply_ssm, static_argnums=(2,))
    jout, jc = japply(jp, jnp.asarray(x[:, :S]), jcfg)
    tout, tc = ssm.apply_ssm(tp, torch.from_numpy(x[:, :S]), cfg)
    _close(tout, jout)
    _trees_close(tc, jc)
    for t in range(S, S + 4):
        jout, jc = japply(jp, jnp.asarray(x[:, t:t + 1]), jcfg, jc)
        tout, tc = ssm.apply_ssm(tp, torch.from_numpy(x[:, t:t + 1]), cfg,
                                 cache=tc)
        _close(tout, jout, f"decode at {t}")
        _trees_close(tc, jc)
    zero = ssm.init_ssm_cache(cfg, 3, torch.bfloat16)
    jzero = jssm.init_ssm_cache(jcfg, 3, jnp.bfloat16)
    assert [(tuple(a.shape), a.dtype) for a in tree_leaves(zero)] == \
        [(tuple(b.shape), torch.bfloat16) for b in jax.tree.leaves(jzero)]


def test_ssm_model_serves_a_two_token_prompt():
    _, tm, jp, tp = _models("mamba2-130m")
    jm = jbuild(JARCHS["mamba2-130m"].reduced(), dtype=jnp.float32)
    tok = _tokens(6, tm.cfg.vocab_size, (2, 5))
    jl, jc = jax.jit(lambda p, t: jm.prefill(p, {"tokens": t}, cache_len=5))(
        jp, jnp.asarray(tok[:, :2], jnp.int32))
    jdecode = jax.jit(jm.decode_step)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(tok[:, :2])},
                        cache_len=5)
    _close(tl, jl)
    for i in (2, 3, 4):
        jl, jc = jdecode(jp, jc, jnp.asarray(tok[:, i:i + 1], jnp.int32),
                         jnp.int32(i))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tok[:, i:i + 1]), i)
        _close(tl, jl, f"decode at {i}")
    _trees_close(tc, jc)


# ---------------------------------------------------------------------------
# the front ends and the families' training, which were refused until this
# slice (the names are kept)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(FRONT_ENDS))
def test_audio_and_vlm_are_refused_by_name(arch):
    """The audio and VLM front ends, refused until they were ported, now
    build: ``get_config`` gives the reference's config, a reduced model
    runs its forward.  What stays refused is by name: the audio encoder's
    decode step, in the reference's words."""
    cfg = get_config(arch)
    assert cfg.family == FRONT_ENDS[arch] == JARCHS[arch].family
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    assert dataclasses.asdict(cfg) == {k: v for k, v in dataclasses.asdict(
        JARCHS[arch]).items() if k in fields}
    model = build_model(cfg.reduced(), dtype=torch.float32)
    params = model.init(torch.Generator().manual_seed(0))
    batch = make_fed_batch_fn(cfg.reduced(), num_clients=1, per_client=2,
                              seq_len=9)(torch.Generator().manual_seed(0))
    with torch.no_grad():
        logits, _ = model.forward(params, {k: v[0] for k, v in
                                           batch["train"].items()})
    assert tuple(logits.shape) == (2, 9, cfg.reduced().vocab_size)
    assert bool(torch.isfinite(logits).all())
    if cfg.family == "audio":
        with pytest.raises(ValueError,
                           match="encoder-only model has no decode step"):
            model.decode_step(params, None, torch.zeros(2, 1, dtype=torch.long),
                              0)


@pytest.mark.parametrize("arch", ["gemma2-2b", "olmoe-1b-7b", "granite-8b"])
def test_training_other_families_is_refused(arch):
    """The dense and MoE families, whose training was refused until it was
    held to the reference, now train: ``build`` takes them (their model
    kernels stay refused for training) and the train CLI's ``--arch``
    override runs a reduced step to a finite validation loss."""
    spec = str(ROOT / "experiments" / "fedbioacc.json")
    exp = Experiment.load(spec).edit(**{"problem.arch": arch})
    run = build(exp, device="cpu")
    assert run.model_cfg.family == ARCHS[arch].family
    with pytest.raises(NotImplementedError,
                       match="Training through the model kernels"):
        build(exp.edit(**{"execution.use_flash": True}), device="cpu")
    history = train.main(["--experiment", spec, "--arch", arch, "--steps",
                          "1", "--device", "cpu"])
    assert [h["step"] for h in history] == [1]
    assert np.isfinite(history[0]["val_loss"])
