"""Bilevel problem definitions (counterpart of ``repro/core/problems.py``).

A :class:`Problem` bundles the per-client stochastic objectives:

* ``f(x, y, batch) -> scalar``   — upper objective f^(m)(x, y; ξ)
* ``g(x, y, batch) -> scalar``   — lower objective g^(m)(x, y; ξ) (μ-strongly
  convex in y by construction)
* ``sample_batches(key) -> batch``  — one independent oracle draw for **all M
  clients at once** (leading axis M); heterogeneity lives in the batch.

Four families, drawn from ``repro_torch.random`` keys as the reference draws
them from ``jax.random``: :func:`quadratic_problem` (closed-form
hyper-gradients), :func:`data_cleaning_problem` and
:func:`hyperrep_problem` (the paper's two experiments) and
:func:`fair_federated_problem`.

Every array of a problem lives on the device the caller names (``device``,
by default the key's); draws happen on the key's device and land there.
Each family is also built from given arrays (``quadratic_from_arrays``,
``data_cleaning_from_data``, ``hyperrep_from_data``,
``fair_federated_from_data``): its ``*_problem`` draws the arrays and calls
it, and a test can hand it the reference's arrays.  That matters for the
quadratic, whose SPD matrices come from a QR that LAPACK and PyTorch need
not round alike.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from repro_torch import random as jr
from repro_torch.core.tree_util import tree_leaves, tree_map


@dataclass(frozen=True)
class Problem:
    name: str
    num_clients: int
    init_xy: Callable[[Any], Any]          # key -> (x, y) single-client template
    f: Callable[[Any, Any, Any], Any]
    g: Callable[[Any, Any, Any], Any]
    sample_batches: Callable[[Any], Any]   # key -> per-client batch [M, ...]
    # optional closed-form helpers (synthetic quadratic only)
    exact_hypergrad: Optional[Callable] = None      # x -> Φ(x, y_x)
    exact_lower_sol: Optional[Callable] = None      # x -> y_x
    # per-client exact lower solutions (local-lower-level problems, Eq. 5)
    exact_hypergrad_local: Optional[Callable] = None

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def _device(key, device) -> torch.device:
    return torch.device(device) if device is not None else key.device


def _on(dev):
    """Move every leaf of a tree to ``dev``."""
    return lambda tree: tree_map(lambda t: t.to(dev), tree)


def _rows(a: torch.Tensor, m: torch.Tensor, idx: torch.Tensor):
    """``a[m][idx]``: rows ``idx`` of client ``m``'s shard, as one advanced
    index (a 0-d ``m`` would be read as a Python int, which ``vmap`` over
    the clients cannot do)."""
    return a[m.reshape(1), idx]


def _take(lp: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(lp, ys[:, None], axis=1)[:, 0]``."""
    return torch.gather(lp, 1, ys.long()[:, None])[:, 0]


# ---------------------------------------------------------------------------
# Synthetic heterogeneous quadratic bilevel problem
# ---------------------------------------------------------------------------

def _rand_spd(key, d, mu, L, M):
    """[M, d, d] SPD matrices with spectrum in [mu, L]."""
    mats = []
    for k in jr.split(key, M):
        k1, k2 = jr.split(k)
        q, _ = torch.linalg.qr(jr.normal(k1, (d, d)))
        ev = jr.uniform(k2, (d,), minval=mu, maxval=L)
        mats.append((q * ev) @ q.T)
    return torch.stack(mats)


def quadratic_problem(key, *, num_clients=8, dx=10, dy=10, mu=1.0, L=5.0,
                      hetero=1.0, noise=0.1, batch_size=8,
                      local_lower: bool = False, device=None) -> Problem:
    """Heterogeneous stochastic quadratic bilevel problem.

        g^m(x,y) = ½ yᵀA_g^m y + xᵀB^m y + c_mᵀy            (+ ⟨ξ, y⟩ noise)
        f^m(x,y) = ½‖y − y0_m‖² + ½ρ‖x − x0_m‖² + xᵀD^m y   (+ ⟨ξ, ·⟩ noise)

    Closed forms (global lower level):
        y_x   = −Ā⁻¹ (B̄ᵀ x + c̄)
        ∇h(x) = ∇_x f̄(x,y_x) − B̄ Ā⁻¹ ∇_y f̄(x, y_x)
    """
    M = num_clients
    ks = jr.split(key, 7)
    arrays = dict(
        Ag=_rand_spd(ks[0], dy, mu, L, M),
        B=jr.normal(ks[1], (M, dx, dy)) * (hetero * 0.3 + 0.3),
        c=jr.normal(ks[2], (M, dy)) * hetero,
        D=jr.normal(ks[3], (M, dx, dy)) * 0.1,
        x0=jr.normal(ks[4], (M, dx)) * hetero,
        y0=jr.normal(ks[5], (M, dy)) * hetero)
    return quadratic_from_arrays(_on(_device(key, device))(arrays),
                                 noise=noise, batch_size=batch_size)


def quadratic_from_arrays(arrays, *, noise=0.1, batch_size=8) -> Problem:
    """The quadratic of :func:`quadratic_problem` over given per-client
    arrays ``Ag`` [M, dy, dy], ``B``, ``D`` [M, dx, dy], ``c``, ``y0``
    [M, dy] and ``x0`` [M, dx], all on one device, where it lives."""
    Ag, B, c, D, x0, y0 = (arrays[k] for k in ("Ag", "B", "c", "D", "x0",
                                                "y0"))
    M, dx, dy = B.shape
    dev = B.device
    rho = 1.0
    sigma = noise / math.sqrt(batch_size)

    def init_xy(k):
        return _on(dev)(tuple(jr.normals(jr.split(k), [(dx,), (dy,)])))

    def g(x, y, batch):
        quad = 0.5 * y @ batch["Ag"] @ y + x @ batch["B"] @ y + batch["c"] @ y
        noise_term = batch["ng"] @ y
        return quad + noise_term

    def f(x, y, batch):
        val = (0.5 * torch.sum((y - batch["y0"]) ** 2)
               + 0.5 * rho * torch.sum((x - batch["x0"]) ** 2)
               + x @ batch["D"] @ y)
        return val + batch["nfx"] @ x + batch["nfy"] @ y

    def sample_batches(k):
        ng, nfx, nfy = jr.normals(jr.split(k, 3), [(M, dy), (M, dx), (M, dy)])
        return {
            "Ag": Ag, "B": B, "c": c, "D": D, "x0": x0, "y0": y0,
            **_on(dev)({"ng": sigma * ng, "nfx": sigma * nfx,
                        "nfy": sigma * nfy}),
        }

    # ---- closed forms ----
    Abar, Bbar, cbar, Dbar, x0bar, y0bar = (torch.mean(a, 0) for a in (
        Ag, B, c, D, x0, y0))

    def exact_lower_sol(x):
        return -torch.linalg.solve(Abar, Bbar.T @ x + cbar)

    def exact_hypergrad(x):
        yx = exact_lower_sol(x)
        gx = rho * (x - x0bar) + Dbar @ yx
        gy = (yx - y0bar) + Dbar.T @ x
        return gx - Bbar @ torch.linalg.solve(Abar, gy)

    def exact_hypergrad_local(x):
        """Eq. (5): h(x) = (1/M) Σ f^m(x, y_x^m), y_x^m = argmin g^m."""
        def one(Agm, Bm, cm, Dm, x0m, y0m):
            yx = -torch.linalg.solve(Agm, Bm.T @ x + cm)
            gx = rho * (x - x0m) + Dm @ yx
            gy = (yx - y0m) + Dm.T @ x
            return gx - Bm @ torch.linalg.solve(Agm, gy)
        return torch.mean(torch.func.vmap(one)(Ag, B, c, D, x0, y0), dim=0)

    return Problem(
        name="quadratic", num_clients=M, init_xy=init_xy, f=f, g=g,
        sample_batches=sample_batches, exact_hypergrad=exact_hypergrad,
        exact_lower_sol=exact_lower_sol,
        exact_hypergrad_local=exact_hypergrad_local)


def _index_batches(k, M, batch_size, n_train, val_start, n_val, dev):
    """The per-client draws of the three data-set problems: train indices
    in [0, n_train), validation indices in [val_start, val_start + n_val),
    and the client ids."""
    k1, k2 = jr.split(k)
    return _on(dev)({"tr_idx": jr.randint(k1, (M, batch_size), 0, n_train),
                     "val_idx": val_start + jr.randint(k2, (M, batch_size),
                                                       0, n_val),
                     "client": torch.arange(M)})


# ---------------------------------------------------------------------------
# Federated data cleaning (paper §5 experiment 1)
# ---------------------------------------------------------------------------

def make_cleaning_data(key, *, num_clients=8, n_train=256, n_val=64, dim=16,
                       classes=4, corrupt_frac=0.4, device=None):
    """Shared corrupted train set + per-client clean validation shards."""
    dev = _device(key, device)
    ks = jr.split(key, 6)
    w_true = jr.normal(ks[0], (dim, classes))
    xtr = jr.normal(ks[1], (n_train, dim))
    logits = xtr @ w_true
    ytr_clean = torch.argmax(
        logits + 0.5 * jr.normal(ks[2], tuple(logits.shape)), -1)
    n_bad = int(n_train * corrupt_frac)
    corrupt_mask = torch.arange(n_train, device=key.device) < n_bad
    y_rand = jr.randint(ks[3], (n_train,), 0, classes)
    ytr = torch.where(corrupt_mask, y_rand.long(), ytr_clean)
    # per-client val (heterogeneous shift)
    xval = jr.normal(ks[4], (num_clients, n_val, dim)) \
        + 0.3 * jr.normal(ks[5], (num_clients, 1, dim))
    yval = torch.argmax(torch.einsum("mnd,dc->mnc", xval, w_true), -1)
    return _on(dev)({"xtr": xtr, "ytr": ytr, "corrupt_mask": corrupt_mask,
                     "xval": xval, "yval": yval, "w_true": w_true})


def data_cleaning_problem(key, *, num_clients=8, n_train=256, n_val=64,
                          dim=16, classes=4, corrupt_frac=0.4, batch_size=32,
                          lower_l2=0.5, device=None) -> Problem:
    data = make_cleaning_data(key, num_clients=num_clients, n_train=n_train,
                              n_val=n_val, dim=dim, classes=classes,
                              corrupt_frac=corrupt_frac, device=device)
    return data_cleaning_from_data(data, batch_size=batch_size,
                                   lower_l2=lower_l2)


def data_cleaning_from_data(data, *, batch_size=32,
                            lower_l2=0.5) -> Problem:
    """The data-cleaning problem over :func:`make_cleaning_data`'s arrays."""
    M, n_val, dim = data["xval"].shape
    n_train = data["xtr"].shape[0]
    classes = data["w_true"].shape[1]
    dev = data["xtr"].device

    def init_xy(k):
        x = torch.zeros((n_train,), device=dev)           # weight logits
        y = 0.01 * jr.normal(k, (dim, classes))
        return x, y.to(dev)

    def _ce(w, xs, ys):
        return -_take(torch.log_softmax(xs @ w, dim=-1), ys)

    def g(x, y, batch):
        idx = batch["tr_idx"]
        per = _ce(y, data["xtr"][idx], data["ytr"][idx])
        w = torch.sigmoid(x[idx])
        return torch.mean(w * per) + 0.5 * lower_l2 * torch.sum(y ** 2)

    def f(x, y, batch):
        m = batch["client"]
        idx = batch["val_idx"]
        per = _ce(y, _rows(data["xval"], m, idx), _rows(data["yval"], m, idx))
        return torch.mean(per)

    def sample_batches(k):
        return _index_batches(k, M, batch_size, n_train, 0, n_val, dev)

    prob = Problem(name="data_cleaning", num_clients=M, init_xy=init_xy,
                   f=f, g=g, sample_batches=sample_batches)
    object.__setattr__(prob, "data", data)   # stash for evaluation scripts
    return prob


# ---------------------------------------------------------------------------
# Hyper-representation learning (paper §5 experiment 2)
# ---------------------------------------------------------------------------

def make_hyperrep_data(key, *, num_clients=8, n=256, dim=16, classes=4,
                       hetero=0.5, device=None):
    ks = jr.split(key, 4)
    w_shared = jr.normal(ks[0], (dim, dim))
    xs = jr.normal(ks[1], (num_clients, n, dim))
    w_cli = jr.normal(ks[2], (num_clients, dim, classes))
    w_common = jr.normal(ks[3], (dim, classes))
    w_task = w_common[None] + hetero * w_cli
    feats = torch.tanh(torch.einsum("mnd,de->mne", xs, w_shared))
    ys = torch.argmax(torch.einsum("mne,mec->mnc", feats, w_task), -1)
    return _on(_device(key, device))({"x": xs, "y": ys})


def hyperrep_problem(key, *, num_clients=8, n=256, dim=16, hidden=32,
                     classes=4, batch_size=32, lower_l2=0.1,
                     hetero=0.5, device=None) -> Problem:
    """Upper x = 2-layer MLP backbone; lower y = linear head."""
    data = make_hyperrep_data(key, num_clients=num_clients, n=n, dim=dim,
                              classes=classes, hetero=hetero, device=device)
    return hyperrep_from_data(data, hidden=hidden, classes=classes,
                              batch_size=batch_size, lower_l2=lower_l2)


def hyperrep_from_data(data, *, hidden=32, classes=4, batch_size=32,
                       lower_l2=0.1) -> Problem:
    """The hyper-representation problem over :func:`make_hyperrep_data`'s
    arrays."""
    M, n, dim = data["x"].shape
    dev = data["x"].device

    def init_xy(k):
        w1, w2, w = jr.normals(jr.split(k, 3), [(dim, hidden),
                                                (hidden, hidden),
                                                (hidden, classes)])
        x = {"w1": 0.3 * w1, "b1": torch.zeros((hidden,)),
             "w2": 0.3 * w2, "b2": torch.zeros((hidden,))}
        y = {"w": 0.1 * w, "b": torch.zeros((classes,))}
        return _on(dev)((x, y))

    def backbone(x, inp):
        h = torch.tanh(inp @ x["w1"] + x["b1"])
        return torch.tanh(h @ x["w2"] + x["b2"])

    def _loss(x, y, xs, ys):
        feats = backbone(x, xs)
        lp = torch.log_softmax(feats @ y["w"] + y["b"], dim=-1)
        return -torch.mean(_take(lp, ys))

    def g(x, y, batch):
        m, idx = batch["client"], batch["tr_idx"]
        base = _loss(x, y, _rows(data["x"], m, idx), _rows(data["y"], m, idx))
        reg = 0.5 * lower_l2 * sum(torch.sum(v ** 2) for v in tree_leaves(y))
        return base + reg

    def f(x, y, batch):
        m, idx = batch["client"], batch["val_idx"]
        return _loss(x, y, _rows(data["x"], m, idx), _rows(data["y"], m, idx))

    def sample_batches(k):
        half = n // 2
        return _index_batches(k, M, batch_size, half, half, half, dev)

    prob = Problem(name="hyperrep", num_clients=M, init_xy=init_xy, f=f, g=g,
                   sample_batches=sample_batches)
    object.__setattr__(prob, "data", data)
    return prob


# ---------------------------------------------------------------------------
# Fair Federated Learning (paper §5 conclusion: bilevel fairness formulation)
# ---------------------------------------------------------------------------

def make_fairness_data(key, *, num_clients=8, n=256, dim=16, classes=4,
                       hard_clients=2, shift=1.5, device=None):
    """Classification shards with a **minority distribution**: the first
    ``hard_clients`` clients draw labels from a rotated ground truth."""
    ks = jr.split(key, 4)
    w_true = jr.normal(ks[0], (dim, classes))
    w_minor = w_true + shift * jr.normal(ks[3], (dim, classes))
    xs = jr.normal(ks[1], (num_clients, n, dim))
    hard_mask = torch.arange(num_clients, device=key.device) < hard_clients
    w_per = torch.where(hard_mask[:, None, None], w_minor[None], w_true[None])
    logits = torch.einsum("mnd,mdc->mnc", xs, w_per)
    noise = 0.2 * jr.normal(ks[2], tuple(logits.shape))
    ys = torch.argmax(logits + noise, -1)
    return _on(_device(key, device))({"x": xs, "y": ys,
                                      "hard_mask": hard_mask})


def fair_federated_problem(key, *, num_clients=8, n=256, dim=16, classes=4,
                           batch_size=32, lower_l2=0.2, beta=2.0,
                           hard_clients=2, device=None) -> Problem:
    """Bilevel Fair FL:

        lower  g^m(λ, y) = M·softmax(λ)_m · L^train_m(y) + (μ/2)||y||²
        upper  f^m(λ, y) = exp(β · L^val_m(y)) / β

    The upper variable λ (client weight logits) learns to up-weight
    under-served clients; minimizing the smooth-max equalises client risk.
    """
    data = make_fairness_data(key, num_clients=num_clients, n=n, dim=dim,
                              classes=classes, hard_clients=hard_clients,
                              device=device)
    return fair_federated_from_data(data, classes=classes,
                                    batch_size=batch_size, lower_l2=lower_l2,
                                    beta=beta)


def fair_federated_from_data(data, *, classes=4, batch_size=32,
                             lower_l2=0.2, beta=2.0) -> Problem:
    """The fairness problem over :func:`make_fairness_data`'s arrays."""
    M, n, dim = data["x"].shape
    dev = data["x"].device
    half = n // 2

    def init_xy(k):
        lam = torch.zeros((M,), device=dev)
        y = 0.01 * jr.normal(k, (dim, classes))
        return lam, y.to(dev)

    def _ce(w, xs, ys):
        lp = torch.log_softmax(xs @ w, dim=-1)
        return -torch.mean(_take(lp, ys))

    def g(lam, y, batch):
        m, idx = batch["client"], batch["tr_idx"]
        loss = _ce(y, _rows(data["x"], m, idx), _rows(data["y"], m, idx))
        w = M * torch.softmax(lam, dim=-1)[m.reshape(1)][0]   # as _rows
        return w * loss + 0.5 * lower_l2 * torch.sum(y ** 2)

    def f(lam, y, batch):
        m, idx = batch["client"], batch["val_idx"]
        loss = _ce(y, _rows(data["x"], m, idx), _rows(data["y"], m, idx))
        capped = torch.minimum(loss, torch.full_like(loss, 10.0))
        return torch.exp(beta * capped) / beta

    def sample_batches(k):
        return _index_batches(k, M, batch_size, half, half, half, dev)

    prob = Problem(name="fair_fl", num_clients=M, init_xy=init_xy, f=f, g=g,
                   sample_batches=sample_batches)
    object.__setattr__(prob, "data", data)

    def client_val_losses(lam, y):
        return torch.stack([_ce(y, data["x"][m][half:], data["y"][m][half:])
                            for m in range(M)])

    object.__setattr__(prob, "client_val_losses", client_val_losses)
    return prob
