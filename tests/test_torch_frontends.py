"""The audio and VLM front ends against the JAX package, in f32 at reduced
sizes, the reference's own initial parameters carried across by
``params_from_numpy`` and the inputs drawn by numpy
(``torch_parity.model_batch``):

* hubert-xlarge and internvl2-76b field for field, their full parameter
  trees (the reference's ``jax.eval_shape``) and their counts;
* ``forward`` (the VLM's patch positions dropped: the label offset),
  ``loss`` and ``prefill`` of both, and the VLM's ``decode_step`` (patches
  first, so decoding continues at ``num_patches + S``) at a scalar and a
  per-request ``pos``; the encoder at hubert's own head dim 80, not causal;
* the audio encoder has no decode step, with the reference's words, in the
  model and in ``launch/serve.py``; the VLM serves through it;
* the two synthetic streams: shapes, dtypes, labels in range and the audio
  clients' fixed shift.

Tolerances: rtol 1e-5 with atol 1e-5 of the largest reference value
(matmul and reduction orders differ between XLA and PyTorch), as in
``tests/test_torch_families.py``."""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.core.tree_util import tree_leaves  # noqa: E402
from repro_torch.data.synthetic import make_fed_batch_fn  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.registry import FAMILIES, build_model  # noqa: E402
from torch_parity import f32, model_batch, to_torch  # noqa: E402

torch.set_num_threads(1)

FRONT_ENDS = ["hubert-xlarge", "internvl2-76b"]
# full models' parameter counts (the reference's trees): body, head
PARAMS = {"hubert-xlarge": (944_497_920, 645_120),
          "internvl2-76b": (69_529_247_744, 1_050_673_152)}
S, GEN = 70, 8


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


_MODELS = {}


def _models(arch, head_dim=None):
    """The reference's reduced model (jitted forward + loss, prefill,
    decode), the port's, and one set of parameters; ``head_dim`` widens the
    reduced model to that head dim (4 heads)."""
    key = (arch, head_dim)
    if key not in _MODELS:
        jcfg, cfg = JARCHS[arch].reduced(), get_config(arch).reduced()
        if head_dim:
            wide = dict(d_model=4 * head_dim, head_dim=head_dim)
            jcfg = dataclasses.replace(jcfg, **wide)
            cfg = dataclasses.replace(cfg, **wide)
        jm = jbuild(jcfg, dtype=jnp.float32)
        tm = build_model(cfg, dtype=torch.float32)
        jp = jm.init(jax.random.PRNGKey(0))
        off = cfg.num_patches if cfg.family == "vlm" else 0
        jfns = {"forward": jax.jit(lambda p, b: (jm.forward(p, b),
                                                 jm.loss(p, b))),
                "prefill": jax.jit(lambda p, b: jm.prefill(
                    p, b, cache_len=off + S + GEN))}
        if cfg.family != "audio":
            jfns["decode"] = jax.jit(jm.decode_step)
        _MODELS[key] = (jfns, tm, jp, to_torch(jp))
    return _MODELS[key]


# ---------------------------------------------------------------------------
# configs and trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FRONT_ENDS)
def test_config_matches_reference_field_for_field(arch):
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(JARCHS[arch])
    assert dataclasses.asdict(get_config(arch).reduced()) == \
        dataclasses.asdict(JARCHS[arch].reduced())


def test_catalog_is_the_references():
    """All ten archs resolve, in the reference's six families."""
    assert sorted(ARCHS) == sorted(JARCHS)
    assert {c.family for c in ARCHS.values()} == set(FAMILIES)
    assert get_config("hubert-xlarge").resolved_head_dim == 80
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("no-such-arch")


@pytest.mark.parametrize("arch", FRONT_ENDS)
def test_full_param_tree_matches_reference(arch):
    """Shapes and dtypes leaf for leaf (meta tensors: nothing allocated)
    against the reference's ``jax.eval_shape``: the audio encoder's
    ``frontend_proj`` and ungated MLP, the VLM's ``embed`` and
    ``patch_proj``."""
    jshape = jax.eval_shape(jbuild(JARCHS[arch]).init, jax.random.PRNGKey(0))
    tree = build_model(get_config(arch)).init(None)
    jl, tl = jax.tree.leaves(jshape), tree_leaves(tree)
    assert [(tuple(a.shape), str(a.dtype)) for a in jl] == \
        [(tuple(b.shape), str(b.dtype).replace("torch.", "")) for b in tl]
    assert sorted(tree["body"]) == sorted(jshape["body"])
    body, head = PARAMS[arch]
    assert sum(b.numel() for b in tree_leaves(tree["body"])) == body
    assert sum(b.numel() for b in tree_leaves(tree["head"])) == head


# ---------------------------------------------------------------------------
# forward, loss, prefill, decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,head_dim", [("hubert-xlarge", None),
                                           ("hubert-xlarge", 80),
                                           ("internvl2-76b", None)])
def test_forward_and_loss_match_reference(arch, head_dim):
    """Logits ``[B, S, V]`` (the VLM's patch positions dropped), the masked
    CE and the loss; the port with ``use_flash`` (its plain version on the
    CPU), at head dim 80 too."""
    jfns, tm, jp, tp = _models(arch, head_dim)
    jb, tb = model_batch(tm.cfg, 2, 40, 1)
    (jl, jaux), (jloss, jparts) = jfns["forward"](jp, jb)
    tl, taux = tm.forward(tp, tb, use_flash=True)
    assert tuple(tl.shape) == (2, 40, tm.cfg.vocab_size) == tuple(jl.shape)
    _close(tl, jl)
    tloss, tparts = tm.loss(tp, tb)
    for got, want in ((taux, jaux), (tparts["ce"], jparts["ce"]),
                      (tloss, jloss)):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5,
                                   atol=1e-7)


@pytest.mark.parametrize("arch", FRONT_ENDS)
def test_prefill_matches_reference(arch):
    """Prompt 70 (ragged against every tile; a VLM's 8 patches before it):
    the last logits and every layer's decode caches."""
    jfns, tm, jp, tp = _models(arch)
    jb, tb = model_batch(tm.cfg, 2, S, 2, labels=False)
    off = tm.cfg.num_patches if tm.cfg.family == "vlm" else 0
    jl, jc = jfns["prefill"](jp, jb)
    tl, tc = tm.prefill(tp, tb, cache_len=off + S + GEN, use_flash=True)
    _close(tl, jl, "prefill logits")
    _trees_close(tc, jc)


@pytest.mark.parametrize("per_request", [False, True])
def test_vlm_decode_matches_reference(per_request):
    """8 teacher-forced decode steps after the prefill of 8 patches and 70
    tokens, at ``pos`` = patches + 70 + i (a scalar, or a ``[B]`` vector
    with the second request one step behind)."""
    jfns, tm, jp, tp = _models("internvl2-76b")
    B, P = 2, tm.cfg.num_patches
    jb, tb = model_batch(tm.cfg, B, S, 3, labels=False)
    tok = np.random.default_rng(4).integers(0, tm.cfg.vocab_size,
                                            (B, S + GEN))
    tok[:, :S] = np.asarray(jb["tokens"])
    jl, jc = jfns["prefill"](jp, jb)
    tl, tc = tm.prefill(tp, tb, cache_len=P + S + GEN, use_flash=True)
    lag = np.array([0, 1]) if per_request else np.array([0, 0])
    for i in range(GEN):
        pos = S + i - lag
        step = tok[np.arange(B), pos][:, None]
        jpos = (jnp.asarray(P + pos, jnp.int32) if per_request
                else jnp.int32(P + S + i))
        tpos = torch.from_numpy(P + pos) if per_request else P + S + i
        jl, jc = jfns["decode"](jp, jc, jnp.asarray(step, jnp.int32), jpos)
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(step), tpos)
        _close(tl, jl, f"decode step {i}")
    _trees_close(tc, jc)


def test_vlm_decode_matches_forward():
    """Prefill 8 patches + 32 tokens, decode the 33rd at position 40: the
    forward's logits at that token."""
    _, tm, _, tp = _models("internvl2-76b")
    _, tb = model_batch(tm.cfg, 2, 33, 5, labels=False)
    P = tm.cfg.num_patches
    with torch.no_grad():
        full, _ = tm.forward(tp, tb)
        _, caches = tm.prefill(tp, {"tokens": tb["tokens"][:, :-1],
                                    "patches": tb["patches"]},
                               cache_len=P + 37)
        logits, _ = tm.decode_step(tp, caches, tb["tokens"][:, -1:], P + 32)
    assert float((logits - full[:, -1]).abs().max()) < 2e-4


def test_encoder_sees_the_whole_clip():
    """Not causal: changing the last frame moves the first position's
    logits."""
    _, tm, _, tp = _models("hubert-xlarge")
    _, tb = model_batch(tm.cfg, 1, 32, 6, labels=False)
    with torch.no_grad():
        l1, _ = tm.forward(tp, tb)
        frames = tb["frames"].clone()
        frames[:, -1] += 1.0
        l2, _ = tm.forward(tp, {"frames": frames})
    assert float((l1[:, 0] - l2[:, 0]).abs().max()) > 1e-4


def test_audio_has_no_decode_step():
    """The reference's words, in the model and in the serving CLI."""
    jm = jbuild(JARCHS["hubert-xlarge"].reduced(), dtype=jnp.float32)
    _, tm, jp, tp = _models("hubert-xlarge")
    tok = np.zeros((1, 1), np.int32)
    with pytest.raises(ValueError, match="encoder-only model has no decode "
                                         "step") as jerr:
        jm.decode_step(jp, None, jnp.asarray(tok), 0)
    with pytest.raises(ValueError) as err:
        tm.decode_step(tp, None, torch.from_numpy(tok), 0)
    assert str(err.value) == str(jerr.value)
    with pytest.raises(SystemExit, match="encoder-only architecture has no "
                                         "decode step"):
        serve.main(["--arch", "hubert-xlarge", "--reduced", "--device",
                    "cpu"])


def test_serve_cli_runs_the_vlm_on_cpu(capsys):
    out = serve.main(["--arch", "internvl2-76b", "--reduced", "--device",
                      "cpu", "--batch", "2", "--prompt-len", "12", "--gen",
                      "5"])
    assert tuple(out["tokens"].shape) == (2, 5)
    assert bool(torch.isfinite(out["logits"]).all())
    assert "arch=internvl2-76b" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the synthetic streams
# ---------------------------------------------------------------------------

def test_audio_stream_shapes_and_client_shift():
    """Frames ``[M, per_client, S, frontend_dim]`` bf16, labels in
    ``[0, vocab)``; each client's frames are ``0.5·N(0, 1)`` about a shift
    of its own (``0.3·N(0, 1)`` over the frame dims), the same in every
    batch: the mean of a client's frames estimates its shift to
    ``0.5 / sqrt(n)``."""
    cfg = get_config("hubert-xlarge").reduced()
    M, per, seq = 3, 2, 256
    fn = make_fed_batch_fn(cfg, num_clients=M, per_client=per, seq_len=seq,
                           seed=4)
    a, b = (fn(torch.Generator().manual_seed(i)) for i in (0, 1))
    assert sorted(a) == ["train", "val"]
    for batch in (a["train"], a["val"], b["train"]):
        assert sorted(batch) == ["frames", "labels"]
        assert batch["frames"].dtype == torch.bfloat16
        assert tuple(batch["frames"].shape) == (M, per, seq,
                                                cfg.frontend_dim)
        assert tuple(batch["labels"].shape) == (M, per, seq)
        assert 0 <= int(batch["labels"].min()) and \
            int(batch["labels"].max()) < cfg.vocab_size
    n = per * seq
    means = [bt["frames"].float().mean(dim=(1, 2))
             for bt in (a["train"], a["val"], b["train"])]
    # the shift stays with its client from batch to batch ...
    for other in means[1:]:
        assert float((other - means[0]).abs().max()) < 6 * 0.5 / n ** 0.5 * 2
    # ... is 0.3 N(0, 1) over the frame dims, and differs between clients
    assert 0.25 < float(means[0].std()) < 0.35
    assert float((means[0][0] - means[0][1]).abs().mean()) > 0.2
    noise = a["train"]["frames"].float() - means[0][:, None, None, :]
    assert 0.45 < float(noise.std()) < 0.55


def test_vlm_stream_shapes():
    """Tokens and labels as the decoders' (labels the tokens rolled by
    one), and patches ``0.5·N(0, 1)`` ``[M, per_client, num_patches,
    frontend_dim]`` in bf16."""
    cfg = get_config("internvl2-76b").reduced()
    M, per, seq = 2, 3, 16
    fn = make_fed_batch_fn(cfg, num_clients=M, per_client=per, seq_len=seq,
                           seed=0)
    batch = fn(torch.Generator().manual_seed(0))["train"]
    assert sorted(batch) == ["labels", "patches", "tokens"]
    assert tuple(batch["tokens"].shape) == (M, per, seq)
    assert torch.equal(batch["labels"], torch.roll(batch["tokens"], -1, -1))
    p = batch["patches"]
    assert p.dtype == torch.bfloat16
    assert tuple(p.shape) == (M, per, cfg.num_patches, cfg.frontend_dim)
    assert abs(float(p.float().mean())) < 0.01
    assert 0.48 < float(p.float().std()) < 0.52
