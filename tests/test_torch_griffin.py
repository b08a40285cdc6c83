"""The port's RecurrentGemma path against the JAX package's, in f32 on
reduced sizes, with the reference's own initial parameters carried across
by ``params_from_numpy`` and inputs drawn by numpy:

* ``griffin.linear_scan`` (the doubling scan, and through the LRU wrapper)
  against the reference's ``lax.associative_scan``;
* ``griffin.apply_rec`` prefill (short and long prompts) and decode;
* ``layers.attention`` prefill (dense and flash) and ring-buffer decode
  past the wrap, with scalar and per-request positions;
* ``stack.stages_for`` of the full and the reduced config (25 and 2
  stages), the full model's parameter tree (10,444,984,320 parameters),
  and all 38 layers at reduced widths carried across and run;
* the whole reduced ``prefill`` plus decode, with the kernels' switches on
  and off; the serve command on the CPU.

Tolerances: the scan atol 2e-6, rtol 2e-5 (the reference's kernel test);
layers and logits rtol 1e-5 with atol 1e-5 of the largest reference value
(matmul and reduction orders differ between XLA and PyTorch; the same
bound as the Mamba-2 parity test)."""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.config import ModelConfig as JModelConfig  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import griffin as jgriffin  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import stack as jstack  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from repro_torch.config import ModelConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.tree_util import tree_leaves  # noqa: E402
from repro_torch.kernels.flash import ops as flash_ops  # noqa: E402
from repro_torch.kernels.lru import ops as lru_ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import griffin, layers, stack  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from torch_parity import f32, to_torch  # noqa: E402

torch.set_num_threads(1)

ARCH = "recurrentgemma-9b"


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


@pytest.mark.parametrize("shape", [(2, 100, 33), (1, 257, 64), (3, 1, 5)])
@pytest.mark.parametrize("with_h0", [True, False])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_linear_scan_matches_associative_scan(shape, with_h0, use_kernel):
    rng = np.random.default_rng(sum(shape))
    a = rng.uniform(0.7, 0.999, shape).astype(np.float32)
    b = (0.1 * rng.standard_normal(shape)).astype(np.float32)
    h0 = rng.standard_normal((shape[0], shape[2])).astype(np.float32) \
        if with_h0 else None
    want = jgriffin.linear_scan(jnp.asarray(a), jnp.asarray(b),
                                None if h0 is None else jnp.asarray(h0))
    lru_ops.reset_counts()
    got = griffin.linear_scan(torch.from_numpy(a), torch.from_numpy(b),
                              None if h0 is None else torch.from_numpy(h0),
                              use_kernel=use_kernel)
    assert lru_ops.CALLS["lru_scan"] == int(use_kernel)
    np.testing.assert_allclose(f32(got), np.asarray(want), atol=2e-6,
                               rtol=2e-5)


@pytest.fixture(scope="module")
def cfgs():
    return jget_config(ARCH).reduced(), get_config(ARCH).reduced()


@pytest.mark.parametrize("S", [37, 2])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_apply_rec_prefill_and_decode(cfgs, S, use_kernel):
    """Prefill (S = 2 < conv width − 1 pads the conv tail), then three
    decode steps from its cache."""
    jcfg, cfg = cfgs
    jp = jgriffin.init_rec(jax.random.PRNGKey(1), jcfg, jnp.float32)
    tp = to_torch(jp)
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S + 3, cfg.d_model)).astype(np.float32)
    jout, jc = jgriffin.apply_rec(jp, jnp.asarray(x[:, :S]), jcfg,
                                  use_kernel=use_kernel)
    tout, tc = griffin.apply_rec(tp, torch.from_numpy(x[:, :S]), cfg,
                                 use_kernel=use_kernel)
    _close(tout, jout)
    _trees_close(tc, jc)
    for t in range(S, S + 3):
        jout, jc = jgriffin.apply_rec(jp, jnp.asarray(x[:, t:t + 1]), jcfg,
                                      cache=jc)
        tout, tc = griffin.apply_rec(tp, torch.from_numpy(x[:, t:t + 1]), cfg,
                                     cache=tc)
        _close(tout, jout, f"decode step at {t}")
        _trees_close(tc, jc)


def _attn_cfgs(window):
    kw = dict(name="t", family="hybrid", num_layers=1, d_model=64,
              num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=128,
              head_dim=16, window_size=window, attn_softcap=20.0)
    return JModelConfig(**kw), ModelConfig(**kw)


@pytest.mark.parametrize("use_flash", [False, True])
def test_attention_prefill(use_flash):
    jcfg, cfg = _attn_cfgs(16)
    jp = jlayers.attn_init(jax.random.PRNGKey(2), jcfg, jnp.float32)
    tp = to_torch(jp)
    x = np.random.default_rng(3).standard_normal((2, 41, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(41)[None], (2, 41))
    jout, (jk, jv) = jlayers.attention(jp, jnp.asarray(x), jcfg, window=16,
                                       positions=jnp.asarray(pos),
                                       use_flash=use_flash)
    flash_ops.reset_counts()
    tout, (tk, tv) = layers.attention(tp, torch.from_numpy(x), cfg, window=16,
                                      positions=torch.from_numpy(pos.copy()),
                                      use_flash=use_flash)
    assert flash_ops.CALLS["flash_attention"] == int(use_flash)
    _close(tout, jout)
    _close(tk, jk)
    _close(tv, jv)


@pytest.mark.parametrize("per_request", [False, True])
def test_attention_ring_buffer_decode(per_request):
    """Decode into an 8-slot ring buffer with window 8 from position 0 to
    19: the slots wrap twice.  With ``per_request`` the two requests sit at
    different positions (a [B] ``cache_index``)."""
    jcfg, cfg = _attn_cfgs(8)
    jp = jlayers.attn_init(jax.random.PRNGKey(4), jcfg, jnp.float32)
    tp = to_torch(jp)
    rng = np.random.default_rng(5)
    jc = (jnp.zeros((2, 8, 2, 16)), jnp.zeros((2, 8, 2, 16)))
    tc = (torch.zeros(2, 8, 2, 16), torch.zeros(2, 8, 2, 16))
    offset = np.array([0, 5]) if per_request else np.array([0, 0])
    for t in range(20):
        x = rng.standard_normal((2, 1, 64)).astype(np.float32)
        pos = offset + t
        jidx = jnp.asarray(pos) if per_request else jnp.int32(t)
        tidx = torch.from_numpy(pos) if per_request else t
        jout, jc = jlayers.attention(jp, jnp.asarray(x), jcfg, window=8,
                                     positions=jnp.asarray(pos[:, None]),
                                     kv_cache=jc, cache_index=jidx)
        tout, tc = layers.attention(tp, torch.from_numpy(x), cfg, window=8,
                                    positions=torch.from_numpy(pos[:, None]),
                                    kv_cache=tc, cache_index=tidx)
        _close(tout, jout, f"step {t}")
        _close(tc[0], jc[0])
        _close(tc[1], jc[1])


def test_stages_match_reference():
    full, jfull = get_config(ARCH), jget_config(ARCH)
    assert stack.stages_for(full) == jstack.stages_for(jfull)
    assert len(stack.stages_for(full)) == 25
    assert stack.stages_for(full)[:2] == [(("rec",), 2), (("local",), 1)]
    assert stack.stages_for(full.reduced()) == \
        jstack.stages_for(jfull.reduced()) == [(("rec",), 2), (("local",), 1)]


def test_full_param_tree_matches_reference():
    """The full model's tree, shapes and dtypes (meta tensors: nothing is
    allocated), against the reference's ``jax.eval_shape``."""
    jshape = jax.eval_shape(jbuild(jget_config(ARCH)).init,
                            jax.random.PRNGKey(0))
    tree = build_model(get_config(ARCH)).init(None)
    jl, tl = jax.tree.leaves(jshape), tree_leaves(tree)
    assert [(tuple(a.shape), str(a.dtype)) for a in jl] == \
        [(tuple(b.shape), str(b.dtype).replace("torch.", "")) for b in tl]
    assert sum(b.numel() for b in tl) == 10_444_984_320


@pytest.fixture(scope="module")
def models(cfgs):
    jcfg, cfg = cfgs
    jm = jbuild(jcfg, dtype=jnp.float32)
    tm = build_model(cfg, dtype=torch.float32)
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, tm, jp, to_torch(jp)


@pytest.mark.parametrize("kernels", [False, True])
def test_prefill_and_decode_match_reference(models, kernels):
    """Prompt 100 (ragged against every tile; the window of 64 bites),
    cache 108, then 8 teacher-forced decode steps.  Greedy tokens agree
    wherever the reference's top-2 margin exceeds the tolerance."""
    jm, tm, jp, tp = models
    B, S, gen = 2, 100, 8
    tok = np.random.default_rng(6).integers(0, tm.cfg.vocab_size,
                                            (B, S + gen))
    flags = dict(use_flash=kernels, use_lru_kernel=kernels)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(tok[:, :S], jnp.int32)},
                        cache_len=S + gen, **flags)
    lru_ops.reset_counts()
    flash_ops.reset_counts()
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(tok[:, :S])},
                        cache_len=S + gen, **flags)
    # two rec layers and one local layer
    assert lru_ops.CALLS["lru_scan"] == 2 * kernels
    assert flash_ops.CALLS["flash_attention"] == kernels
    assert [tuple(b.shape) for b in tree_leaves(tc)] == \
        [tuple(a.shape) for a in jax.tree.leaves(jc)]
    steps = [(jl, tl)]
    for i in range(gen):
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(tok[:, S + i:S + i + 1],
                                                    jnp.int32),
                                jnp.int32(S + i))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tok[:, S + i:S + i + 1]),
                                S + i)
        steps.append((jl, tl))
    _trees_close(tc, jc)
    for i, (jl, tl) in enumerate(steps):
        jl = np.asarray(jl)
        _close(tl, jl, f"logits after step {i}")
        top2 = np.sort(jl, axis=-1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > 2e-5 * np.abs(jl).max()
        assert np.array_equal(f32(tl).argmax(-1)[clear], jl.argmax(-1)[clear])


def test_serve_cli_runs_on_cpu(capsys):
    out = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "20", "--gen", "4"])
    assert tuple(out["tokens"].shape) == (2, 4)
    assert out["logits"].shape == (2, 512)
    assert bool(torch.isfinite(out["logits"]).all())
    assert out["prefill_ms"] > 0 and out["decode_ms_per_step"] > 0
    assert "prefill 2x20" in capsys.readouterr().out


def test_ssm_decode_cache_is_refused_by_name():
    """The Mamba-2 decode cache is ported (its layout the reference's);
    the two front ends, refused by name until they were ported, resolve,
    and what is still refused by name is the audio encoder's decode step
    (the reference's words)."""
    m = build_model(get_config("mamba2-130m").reduced(), dtype=torch.float32)
    jm = jbuild(jget_config("mamba2-130m").reduced(), dtype=jnp.float32)
    assert [tuple(t.shape) for t in tree_leaves(m.init_cache(1, 8))] == \
        [tuple(a.shape) for a in jax.tree.leaves(jm.init_cache(1, 8))]
    for arch in ("hubert-xlarge", "internvl2-76b"):
        assert dataclasses.asdict(get_config(arch)) == \
            dataclasses.asdict(jget_config(arch))
    audio = build_model(get_config("hubert-xlarge").reduced())
    with pytest.raises(ValueError, match="encoder-only model has no decode "
                                         "step"):
        audio.decode_step(None, None, torch.zeros(1, 1, dtype=torch.long), 0)


def test_full_depth_tree_carries_across():
    """All 38 layers (25 stages) at reduced widths: ``params_from_numpy``
    carries the reference's stage tree unchanged, bit for bit, and a short
    prefill plus two decode steps agree."""
    import dataclasses
    jcfg = dataclasses.replace(jget_config(ARCH).reduced(), num_layers=38)
    cfg = dataclasses.replace(get_config(ARCH).reduced(), num_layers=38)
    assert len(stack.stages_for(cfg)) == 25
    jm, tm = jbuild(jcfg, dtype=jnp.float32), build_model(cfg, torch.float32)
    jp = jm.init(jax.random.PRNGKey(7))
    tp = to_torch(jp)
    for a, b in zip(jax.tree.leaves(jp), tree_leaves(tp)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    tok = np.random.default_rng(8).integers(0, cfg.vocab_size, (1, 14))
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(tok[:, :12], jnp.int32)},
                        cache_len=14)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(tok[:, :12])},
                        cache_len=14)
    _close(tl, jl)
    for i in (12, 13):
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(tok[:, i:i + 1], jnp.int32),
                                jnp.int32(i))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tok[:, i:i + 1]), i)
        _close(tl, jl, f"decode at {i}")
    _trees_close(tc, jc)
