"""Numpy bridge shared by the ``test_torch_*`` parity tests: data crosses
between the JAX reference and the PyTorch port as numpy arrays, and bit
comparisons use uint8 views."""
import numpy as np
import torch

from repro_torch.models.registry import params_from_numpy


def bits(a) -> np.ndarray:
    """Raw bytes of a torch tensor or an array (JAX or numpy)."""
    if isinstance(a, torch.Tensor):
        t = a.detach().cpu().reshape(-1)
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy().view(np.uint8)
    return np.asarray(a).reshape(-1).view(np.uint8)


def f32(a) -> np.ndarray:
    """A torch tensor or an array as float32 numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().to(torch.float32).numpy()
    return np.asarray(a, dtype=np.float32)


def to_torch(tree, device="cpu"):
    """A tree of JAX/numpy arrays as tensors, bit for bit."""
    import jax
    return params_from_numpy(jax.tree.map(np.asarray, tree), device)


def contraction_tol(out, product) -> np.ndarray:
    """Elementwise: one rounding of ``product`` plus one unit in the last
    place of ``out`` in its own dtype."""
    ulp_res = np.spacing(np.abs(f32(out)))
    if isinstance(out, torch.Tensor) and out.dtype == torch.bfloat16:
        ulp_res = ulp_res * 2.0 ** 16          # 8 mantissa bits, not 24
    return np.spacing(np.abs(f32(product))) + ulp_res


def assert_contraction_close(out, fused, product, carried=0.0):
    """``out`` (each op rounded) and ``fused`` (a multiply-add contracted
    into one FMA, as XLA's CPU backend does under ``jit``) differ by at most
    one rounding of ``product`` plus one unit in the last place of the
    result in its own dtype, elementwise.  ``carried`` adds what an input
    that already differs between the two brings along."""
    tol = contraction_tol(out, product) + carried
    diff = np.abs(f32(out) - f32(fused))
    assert np.all(diff <= tol), float(np.max(diff - tol))


def model_batch(cfg, B: int, S: int, seed: int, *, labels: bool = True):
    """One model batch for any family, drawn by numpy from ``seed``, as
    (the reference's arrays, the port's tensors): tokens (int32) or, for
    the audio encoder, frames ``[B, S, frontend_dim]``; a VLM also takes
    ``num_patches`` patches; frames and patches in bf16, as the streams
    hand them over.  Labels (the first 5 ignored, -1) unless ``labels`` is
    False."""
    import jax.numpy as jnp
    rng = np.random.default_rng(seed)
    batch = {}
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (B, S, cfg.frontend_dim)).astype(np.float32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(
            np.int32)
    if cfg.family == "vlm":
        batch["patches"] = 0.5 * rng.standard_normal(
            (B, cfg.num_patches, cfg.frontend_dim)).astype(np.float32)
    if labels:
        lab = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        lab[:, :5] = -1
        batch["labels"] = lab
    jb = {k: jnp.asarray(v, jnp.bfloat16 if v.dtype == np.float32
                         else jnp.int32) for k, v in batch.items()}
    return jb, to_torch(jb)


def route_probs(model, params, batch):
    """Each MoE layer's router probabilities in the port's forward of
    ``batch`` (no gradient), as f32 numpy arrays."""
    from repro_torch.models import stack
    probs = []
    orig = stack.moe_mlp

    def spy(p, x, cfg, **kw):
        probs.append(f32(torch.softmax((x @ p["router"]).float(), dim=-1)))
        return orig(p, x, cfg, **kw)

    stack.moe_mlp = spy
    try:
        with torch.no_grad():
            model.forward(params, batch)
    finally:
        stack.moe_mlp = orig
    return probs


def routes_gap(probs, k) -> float:
    """The smallest gap between consecutive probabilities among any
    token's top k + 1: above the two packages' difference, no two
    orderings of ties can differ."""
    top = -np.sort(-np.asarray(probs, np.float64), axis=-1)[..., :k + 1]
    return float(np.min(top[..., :-1] - top[..., 1:]))


def port_state(run, jstate):
    """The reference's train state as the port's, bit for bit: its
    ``FlatState`` as the port's engine state (with zero staleness counters
    where the port's engine keeps them), or an unfused pytree train state
    as the port's class of the same name (the step a host int)."""
    from repro_torch.federation import trainer
    from repro_torch.optim import sequences as seqs

    if not hasattr(jstate, "vars"):
        cls = getattr(trainer, type(jstate).__name__)
        return cls(**{f: int(v) if f == "step" else to_torch(v)
                      for f, v in jstate._asdict().items()})
    extra = {}
    if run.init.participation is not None:
        extra["stale"] = torch.zeros(run.fed.num_clients, dtype=torch.int32)
    return seqs.FlatState(tuple(to_torch(list(jstate.vars))),
                          tuple(to_torch(list(jstate.mom))), 0, **extra)


def paired_steps(spec_path, edits: dict, steps: int, on_state=None):
    """The JAX package's run of the spec at ``spec_path`` edited by
    ``edits`` and the port's, ``steps`` steps each from the reference's
    initial state (a ``FlatState``, or an unfused pytree train state) on
    the reference's batches (the port cannot draw the reference's Threefry
    heads or streams).  ``on_state(run, state, batch)`` sees the port's
    state before each step and after the last (with the last step's
    batch).  Returns ``(jrun, run, jstate, state, storm3_step calls of the
    port's steps)``."""
    import jax
    from repro.api import Experiment as JExperiment
    from repro.api import build as jbuild
    from repro_torch.api import Experiment, build
    from repro_torch.kernels.storm import kernel as tk

    jrun = jbuild(JExperiment.load(str(spec_path)).edit(**edits))
    run = build(Experiment.load(str(spec_path)).edit(**edits), device="cpu")
    key = jax.random.PRNGKey(jrun.spec.schedule.seed)
    jstate = jrun.init(key)
    state = port_state(run, jstate)
    jstep = jax.jit(jrun.step)
    calls = 0
    for _ in range(steps):
        key, sub = jax.random.split(key)
        batch = jrun.batch_fn(sub)
        tb = to_torch(batch)
        if on_state is not None:
            on_state(run, state, tb)
        jstate, _ = jstep(jstate, batch)
        tk.reset_counts()
        state, _ = run.step(state, tb)
        calls += tk.CALLS["storm3_step"]
    if on_state is not None:
        on_state(run, state, tb)
    return jrun, run, jstate, state, calls


def section_errors(spec, got, want) -> dict:
    """Per section of the flat layout: ``|got - want| / |want|`` over the
    columns the section holds in every dtype buffer."""
    num, den = {}, {}
    for grp, g, w in zip(spec.groups, got, want):
        g, w = f32(g).astype(np.float64), np.asarray(w, np.float64)
        for s, a, b in grp.extents:
            name = spec.sections[s]
            num[name] = num.get(name, 0.0) + float(
                np.sum((g[:, a:b] - w[:, a:b]) ** 2))
            den[name] = den.get(name, 0.0) + float(np.sum(w[:, a:b] ** 2))
    return {s: (num[s] / den[s]) ** 0.5 for s in num}


def field_errors(got, want, fields) -> dict:
    """Per field of two pytree train states (the port's, the
    reference's): ``|got - want| / |want|`` over the field's leaves."""
    import jax
    from repro_torch.core.tree_util import tree_leaves
    out = {}
    for name in fields:
        g = [f32(t).astype(np.float64)
             for t in tree_leaves(getattr(got, name))]
        w = [np.asarray(t, np.float64)
             for t in jax.tree.leaves(getattr(want, name))]
        assert len(g) == len(w), name
        num = sum(float(np.sum((a - b) ** 2)) for a, b in zip(g, w))
        den = sum(float(np.sum(b ** 2)) for b in w)
        out[name] = (num / den) ** 0.5
    return out
