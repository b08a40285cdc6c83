"""What keeps the model-scale oracles' memory in bounds, held to the
plain formulations it replaces, bit for bit:

* ``core/hypergrad._own_storage``: a jvp primal or tangent that is a slice
  of the flat buffers is copied first (forward-mode AD gives a tangent the
  primal's whole storage layout, so a leaf of the buffers' pytree view
  would get a tangent as large as the buffer);
* ``core/model_problem._SumSquares``: the lower objective's L2 term saves
  only the head, with autograd's derivatives op for op;
* ``models/stack._unstack``: one ``unbind`` a stage, whose gradient is one
  stack, against indexing each layer out;
* ``optim/flat.flatten_tree``: each leaf copied into its slice of one
  buffer, against converting the leaves and concatenating.

No JAX: the reference is the port's own plain formulation."""
import dataclasses

import pytest
import torch
from torch.func import grad, jvp

from repro_torch.configs import get_config
from repro_torch.core import hypergrad as hg
from repro_torch.core import model_problem as mp
from repro_torch.core.tree_util import client_slice, tree_leaves, tree_map
from repro_torch.models import stack
from repro_torch.models.registry import build_model
from repro_torch.optim import flat
from torch_parity import bits

torch.set_num_threads(1)


def _equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert (bits(x) == bits(y)).all()


def _model(arch="gemma2-2b", layers=3):
    cfg = dataclasses.replace(get_config(arch).reduced(), num_layers=layers)
    model = build_model(cfg, dtype=torch.float32)
    params = tree_map(lambda v: v,
                      model.init(torch.Generator().manual_seed(0)))
    tok = torch.randint(0, cfg.vocab_size, (1, 24),
                        generator=torch.Generator().manual_seed(1))
    b = {"tokens": tok, "labels": torch.roll(tok, -1, -1)}
    return model, params, {"train": b, "val": b}


def test_own_storage_copies_only_slices():
    buf = torch.arange(12.0)
    whole, part = torch.ones(3), buf[2:5]
    out = hg._own_storage({"a": whole, "b": part, "c": buf.view(3, 4)[:, 1]})
    assert out["a"] is whole
    assert out["b"] is not part and torch.equal(out["b"], part)
    assert out["b"].untyped_storage().nbytes() == 3 * 4
    assert out["c"].is_contiguous() and torch.equal(out["c"], buf[1::4])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sum_squares_derivatives_are_autograds(dtype):
    """∇, and ∇ linearized along u (the oracles' forward over reverse), of
    a loss plus ``0.5·λ·sum(y.float()²)``: the Function's equal plain
    autograd's bit for bit."""
    gen = torch.Generator().manual_seed(2)
    x, y, u = (torch.randn(s, generator=gen).to(dtype)
               for s in ((8, 16), (16, 32), (16, 32)))

    def objective(reg):
        return lambda xx, yy: torch.sum((xx @ yy).float().tanh()) + reg(yy)

    out = []
    for reg in (lambda v: 0.005 * torch.sum(v.to(torch.float32) ** 2),
                lambda v: 0.005 * mp._SumSquares.apply(v)):
        g = objective(reg)
        out.append(jvp(lambda xx, yy: grad(g, argnums=(0, 1))(xx, yy),
                       (x, y), (torch.zeros_like(x), u)))
    _equal(out[0], out[1])
    assert float(mp._SumSquares.apply(y)) == \
        float(torch.sum(y.to(torch.float32) ** 2))


def test_unstack_gradients_match_indexing(monkeypatch):
    """The loss's gradient through a 3-layer stage, one ``unbind`` a leaf
    against each layer indexed out of the stage."""
    model, params, batch = _model()

    def g(p):
        return model.loss(p, batch["train"])[0]

    got = grad(g)(params)
    monkeypatch.setattr(stack, "_unstack", lambda stage, reps: [
        tree_map(lambda v, r=r: v[r], stage) for r in range(reps)])
    _equal(got, grad(g)(params))


def test_oracles_on_flat_views_match_contiguous_params():
    """The fused oracles on one client's pytree view of the flat buffers
    (what the engine hands them) equal the same oracles on contiguous
    copies, bit for bit."""
    model, params, batch = _model("hubert-xlarge", 2)
    frames = torch.randn(1, 24, model.cfg.frontend_dim,
                         generator=torch.Generator().manual_seed(3))
    mb = {k: {"frames": frames, "labels": v["labels"]}
          for k, v in batch.items()}
    tree = {"x": params["body"], "y": params["head"],
            "u": tree_map(lambda t: 0.01 * torch.ones_like(t),
                          params["head"])}
    spec = flat.make_spec(tree, sections=("x", "y", "u"))
    bufs = flat.flatten_tree(spec, tree_map(
        lambda v: v[None].expand((2,) + v.shape), tree), batch_dims=1)
    views = client_slice(flat.unflatten_tree(spec, bufs), 1)
    f, g = mp.make_model_bilevel(model)
    got = hg.fused_oracles(g, f, views["x"], views["y"], views["u"], mb)
    own = tree_map(lambda t: t.clone(), views)
    want = hg.fused_oracles(g, f, own["x"], own["y"], own["u"], mb)
    _equal(got, want)
    assert all(t.untyped_storage().nbytes() > t.numel() * t.element_size()
               for t in tree_leaves(views))


def test_flatten_tree_matches_concatenation():
    """Leaves converted and copied into their slices, the gaps zero: the
    buffers the converted leaves and zero gaps concatenate to."""
    model, params, _ = _model()
    tree = {"x": params["body"], "y": params["head"]}
    spec = flat.make_spec(tree, sections=("x", "y"), block=256)
    batched = tree_map(lambda v: torch.stack([v, 2 * v]), tree)
    for dtype in (None, torch.bfloat16):
        got = flat.flatten_tree(spec, batched, batch_dims=1, dtype=dtype)
        leaves = spec.treedef.flatten_up_to(batched)
        for grp, buf in zip(spec.groups, got):
            out_dt = dtype or grp.dtype
            parts, cursor = [], 0
            for lf in grp.leaves:
                parts.append(torch.zeros(2, lf.offset - cursor, dtype=out_dt))
                parts.append(leaves[lf.index].to(out_dt).reshape(2, -1))
                cursor = lf.offset + lf.size
            parts.append(torch.zeros(2, grp.padded - cursor, dtype=out_dt))
            _equal(buf, torch.cat(parts, dim=-1))
