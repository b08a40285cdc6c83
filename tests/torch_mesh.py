"""Gloo rank groups for the sharded-substrate tests of the port: a helper to
start a ``[data, model]`` world of spawned processes, and the functions its
ranks run.  JAX-free, so that the spawned ranks import no JAX (they import
this module to find their target)."""
import json
import multiprocessing.connection
import os

import numpy as np
import torch
import torch.multiprocessing as mp

WORLD = 8
MESH = (4, 2)


def run_ranks(target, tmpdir: str, *args, world: int = WORLD,
              timeout: float = 600.0) -> None:
    """Run ``target(rank, world, store, *args)`` in ``world`` spawned
    processes over a ``FileStore`` under ``tmpdir``; joins them within
    ``timeout`` seconds (killing what is left) and raises unless every
    rank exited 0."""
    ctx = mp.get_context("spawn")
    store = os.path.join(tmpdir, "store")
    procs = [ctx.Process(target=target, args=(r, world, store, *args))
             for r in range(world)]
    for p in procs:
        p.start()
    pending = list(procs)
    try:
        while pending:
            ready = multiprocessing.connection.wait(
                [p.sentinel for p in pending], timeout)
            if not ready:
                raise TimeoutError(f"ranks still running after {timeout} s")
            pending = [p for p in pending if p.exitcode is None]
            if any(p.exitcode for p in procs if p.exitcode is not None):
                break
    finally:
        for p in procs:
            if p.exitcode is None:
                p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    assert codes == [0] * world, codes


def _join(rank: int, world: int, store: str):
    from repro_torch.launch.mesh import init_ranks, make_debug_mesh
    torch.set_num_threads(1)
    init_ranks(rank, world, store)
    return make_debug_mesh(*MESH)


def _leave():
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# substrate: client_mean_masked on every rank's blocks
# ---------------------------------------------------------------------------

def substrate_cases():
    """case name → (M, modes, weighted, use_scatter, compress, robust):
    the plain means at M = 4 and 8, psum and reduce-scatter, the bf16 and
    int8 wires, int8 with top-k and error feedback, a grouped int8 mean,
    and the guarded means over corrupted rows."""
    cases = {}
    for m in (4, 8):
        for modes in (("mean", "none", "group"), ("mean", "none", "mean")):
            for weighted in (False, True):
                for scatter in (False, True):
                    name = (f"m{m}-{modes[2]}-{'w' if weighted else 'u'}-"
                            f"{'scatter' if scatter else 'psum'}")
                    cases[name] = (m, modes, weighted, scatter, None, None)
        mm = ("mean", "none", "mean")
        cases[f"m{m}-bf16"] = (m, mm, True, False, ("bf16", 0.0), None)
        cases[f"m{m}-int8"] = (m, mm, True, False, ("int8", 0.0), None)
        cases[f"m{m}-int8-topk"] = (m, mm, True, False, ("int8", 0.25), None)
        cases[f"m{m}-int8-group"] = (m, ("mean", "none", "group"), True,
                                     False, ("int8", 0.0), None)
        for agg in ("mean", "clip", "trim"):
            cases[f"m{m}-robust-{agg}"] = (m, mm, True, False, None, agg)
    return cases


TREE = {"x": (70,), "y": (30,), "u": (26,)}
BLOCK = 8
NAN_CLIENT, BYZ_SCALE = 2, 25.0


def substrate_inputs(m: int, seed: int = 0) -> dict:
    """Per section an [M, n] f32 array, drawn by numpy from ``seed``."""
    rng = np.random.default_rng(seed + m)
    return {k: rng.standard_normal((m,) + shape).astype(np.float32)
            for k, shape in TREE.items()}


def substrate_weights(m: int) -> np.ndarray:
    w = np.ones(m, np.float32)
    w[1::4] = 0.0                   # a non-participant in every pod
    if m == 8:
        w[6] = 2.5
    return w


def substrate_masks(m: int):
    nan = np.zeros(m, np.float32)
    byz = np.zeros(m, np.float32)
    nan[NAN_CLIENT] = 1.0
    byz[m - 1] = 1.0
    return nan, byz


def substrate_ranks(rank: int, world: int, store: str, out: str) -> None:
    """Every case of :func:`substrate_cases` on this rank's blocks, the
    whole results gathered on rank 0 and written to ``out`` (npz), with the
    guard rails' messages beside it (``out + ".json"``)."""
    mesh = _join(rank, world, store)
    from repro_torch.optim import flat
    from repro_torch.optim.sequences import FlatState
    from repro_torch.sharding.rules import gather_state

    tmpl = {k: torch.zeros(s) for k, s in TREE.items()}
    spec = flat.make_spec(tmpl, sections=("x", "y", "u"), block=BLOCK,
                          shards=MESH[1])
    results = {}
    for name, (m, modes, weighted, scatter, comp, agg) in \
            substrate_cases().items():
        ctx = flat.make_shard_ctx(mesh, use_scatter=scatter)
        tree = {k: torch.from_numpy(v)
                for k, v in substrate_inputs(m).items()}
        bufs = flat.local_blocks(spec, flat.flatten_tree(spec, tree,
                                                         batch_dims=1), ctx)
        w = torch.from_numpy(substrate_weights(m)) if weighted else None
        kw = {}
        if comp is not None:
            kw["compress"] = flat.CompressCfg(quant=comp[0],
                                              topk_frac=comp[1])
            kw["ef"] = (tuple(torch.zeros_like(b) for b in bufs)
                        if comp[1] > 0 else None)
        if agg is not None:
            nan, byz = substrate_masks(m)
            kw["corrupt"] = (torch.from_numpy(nan), torch.from_numpy(byz),
                             BYZ_SCALE)
            kw["robust"] = flat.RobustCfg(aggregator=agg)
            kw["verdicts"] = []
        res = flat.client_mean_masked(spec, bufs, modes, weights=w,
                                      shard=ctx, **kw)
        out_b, ef = (res, ()) if comp is None else res
        whole = gather_state(spec, FlatState(out_b, (), 0,
                                             ef=(ef,) if ef else ()), ctx)
        if rank == 0:
            for k, v in flat.unflatten_tree(spec, whole.vars).items():
                results[f"{name}/{k}"] = v.numpy()
            if ef:
                for k, v in flat.unflatten_tree(spec, whole.ef[0]).items():
                    results[f"{name}/ef/{k}"] = v.numpy()
            if agg is not None:
                results[f"{name}/verdicts"] = np.stack(
                    [v.numpy() for v in kw["verdicts"]])
    # the guard rails, in the reference's words
    msgs = {}
    ctx = flat.make_shard_ctx(mesh)
    s1 = flat.make_spec(tmpl, sections=("x", "y", "u"), block=BLOCK)
    tree = {k: torch.from_numpy(v) for k, v in substrate_inputs(8).items()}
    b1 = flat.flatten_tree(s1, tree, batch_dims=1)
    for key, fn in (
            ("shards", lambda: flat.client_mean_masked(
                s1, tuple(b[:2] for b in b1), ("mean", "none", "mean"),
                shard=ctx)),
            ("divisible", lambda: flat.local_blocks(
                spec, tuple(b[:5] for b in flat.flatten_tree(
                    spec, tree, batch_dims=1)), ctx)),
            ("axis", lambda: flat.make_shard_ctx(mesh, model_axis="nope"))):
        try:
            fn()
            msgs[key] = None
        except ValueError as e:
            msgs[key] = str(e)
    if rank == 0:
        np.savez(out, **results)
        with open(out + ".json", "w") as fh:
            json.dump(msgs, fh)
    _leave()


# ---------------------------------------------------------------------------
# engine: the five algorithms sharded, and the committed spec
# ---------------------------------------------------------------------------

ALGOS = ("fedbio", "fedbioacc", "fedbio_local", "fedbioacc_local", "fedavg")
FIELDS = {"fedbio": ("x", "y", "u"),
          "fedbioacc": ("x", "y", "u", "omega", "nu", "q"),
          "fedbio_local": ("x", "y"),
          "fedbioacc_local": ("x", "y", "omega", "nu"),
          "fedavg": ("params", "mom")}
ENGINE_STEPS = 3


def engine_cases() -> dict:
    """case name → (algorithm, participation m or 0, overlap, compression
    or None): the five algorithms, then FedBiOAcc under m = M/2
    participation, overlap, and both (the reference's
    ``tests/test_sharded_substrate.py`` cases), and FedBiOAcc with int8 +
    top-k 10 % sends (``tests/test_compressed_comm.py``'s engine case)."""
    cases = {a: (a, 0, False, None) for a in ALGOS}
    cases["fedbioacc-participation"] = ("fedbioacc", 2, False, None)
    cases["fedbioacc-overlap"] = ("fedbioacc", 0, True, None)
    cases["fedbioacc-participation-overlap"] = ("fedbioacc", 2, True, None)
    cases["fedbioacc-int8"] = ("fedbioacc", 0, False, ("int8", 0.0))
    return cases


def engine_run(algo: str, m: int, overlap: bool, comp=None, mesh=None):
    """``ENGINE_STEPS`` steps of ``algo`` on the reduced Mamba-2 (4
    clients, 1 sequence of 16 tokens each, tiles of 256, 2 local steps),
    from seed 0 on the batches of seed 1; returns (train_step, state).  On
    a mesh every rank takes its clients' rows of each batch."""
    from repro_torch.config import FederatedConfig
    from repro_torch.configs import get_config
    from repro_torch.core.tree_util import tree_map
    from repro_torch.data.synthetic import make_fed_batch_fn
    from repro_torch.federation import trainer as tr
    from repro_torch.federation.compression import CompressionSpec
    from repro_torch.federation.participation import ParticipationSpec
    from repro_torch.models.registry import build_model

    cfg = get_config("mamba2-130m").reduced()
    model = build_model(cfg, dtype=torch.float32)
    fed = FederatedConfig(num_clients=4, local_steps=2, lr_x=0.05,
                          lr_y=0.05, lr_u=0.05, neumann_q=2,
                          neumann_tau=0.3)
    batch_fn = make_fed_batch_fn(cfg, num_clients=4, per_client=1,
                                 seq_len=16, device="cpu")
    kw = {}
    if m:
        kw["participation"] = ParticipationSpec(sampler="uniform",
                                                clients_per_round=m)
    if comp is not None:
        kw["compression"] = CompressionSpec(quant=comp[0],
                                            topk_frac=comp[1])
    maker = getattr(tr, f"make_{algo}_train_step")
    init, step = maker(model, fed, n_micro=1, remat=False, fuse_storm=True,
                       storm_block=256, mesh=mesh, overlap=overlap, **kw)
    state = init(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    for _ in range(ENGINE_STEPS):
        batch = batch_fn(gen)
        if step.shard is not None:
            rows = step.shard.rows
            batch = tree_map(lambda v: v[rows(v.shape[0])], batch)
        state, _ = step(state, batch)
    return step, state


def field_arrays(step, whole_state, fields) -> dict:
    """``{field/leaf-index: array}`` of a whole state's pytree view."""
    from repro_torch.core.tree_util import tree_leaves
    view = step.views(whole_state)
    return {f"{f}/{i}": leaf.detach().numpy().copy()
            for f in fields
            for i, leaf in enumerate(tree_leaves(getattr(view, f)))}


SPEC = "experiments/fedbioacc_sharded_overlap.json"


def engine_ranks(rank: int, world: int, store: str, out: str,
                 root: str) -> None:
    """Every case of :func:`engine_cases` on the ``[4, 2]`` mesh, then the
    committed sharded spec through ``api.build`` for its 4 steps (its
    ``eval_fn`` after each); rank 0 writes the whole final states' fields
    and the losses to ``out`` (npz)."""
    mesh = _join(rank, world, store)
    from repro_torch.api import Experiment, build
    from repro_torch.kernels.storm import kernel as tk
    from repro_torch.sharding.rules import gather_state

    results = {}
    for name, (algo, m, overlap, comp) in engine_cases().items():
        tk.reset_counts()
        step, state = engine_run(algo, m, overlap, comp, mesh=mesh)
        calls = dict(tk.CALLS)
        whole = gather_state(step.spec, state, step.shard)
        if rank == 0:
            for k, v in field_arrays(step, whole, FIELDS[algo]).items():
                results[f"{name}/{k}"] = v
            results[f"{name}/calls"] = np.array(
                [calls[k] for k in sorted(calls)])
    run = build(Experiment.load(os.path.join(root, SPEC)), device="cpu")
    state = run.init(torch.Generator().manual_seed(run.spec.schedule.seed))
    gen = torch.Generator().manual_seed(run.spec.schedule.seed)
    losses = []
    for _ in range(run.steps):
        state, _ = run.step(state, run.place_batch(run.batch_fn(gen)))
        losses.append(run.eval_fn(state))
    whole = gather_state(run.step.spec, state, run.shard)
    if rank == 0:
        results["spec/losses"] = np.array(losses)
        for i, b in enumerate(whole.vars + whole.mom):
            results[f"spec/buf{i}"] = b.numpy()
        np.savez(out, **results)
    _leave()
