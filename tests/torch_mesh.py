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
              timeout: float = 600.0, during=None) -> None:
    """Run ``target(rank, world, store, *args)`` in ``world`` spawned
    processes over a ``FileStore`` under ``tmpdir``; joins them within
    ``timeout`` seconds (killing what is left) and raises unless every
    rank exited 0.  ``during()`` runs in this process while they do."""
    ctx = mp.get_context("spawn")
    store = os.path.join(tmpdir, "store")
    procs = [ctx.Process(target=target, args=(r, world, store, *args))
             for r in range(world)]
    for p in procs:
        p.start()
    pending = list(procs)
    try:
        if during is not None:
            during()
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

# ---------------------------------------------------------------------------
# guards: stragglers, faults with the guarded means, in-band telemetry
# ---------------------------------------------------------------------------

GUARD_SPECS = {"straggler": "experiments/fedbioacc_straggler.json",
               "faulty": "experiments/fedbioacc_faulty.json",
               "telemetry": "experiments/fedbioacc_telemetry.json"}


def guard_cases() -> dict:
    """case name → (committed spec, its edits, steps): the three specs,
    and the other late policies (``carry``, ``cancel``), the other guards
    (``trim``, with every metric group the faulty spec allows, the health
    screen's among them, and a z-score threshold of 1 that screens the
    ×25 sends out too, so that its last momenta are well-conditioned; the
    unguarded mean over the byzantine sends, the NaN sends off so that the
    fields stay finite), and the other metric groups
    (``health`` under m = 2 of 4 participation; ``compression`` with int8
    sends, on the int8 engine case's tiles of 256).  The faulty and the
    straggler specs run 4 steps: the faults start at round 1, and round 1
    decides on the deadline round 0 carried; the rest 2 (one round)."""
    tel = ("norms", "drift")
    return {
        "straggler": ("straggler", {}, 4),
        "straggler-carry": ("straggler",
                            {"stragglers.late_policy": "carry"}, 2),
        "straggler-cancel": ("straggler",
                             {"stragglers.late_policy": "cancel"}, 2),
        "faulty": ("faulty", {}, 4),
        "faulty-trim": ("faulty", {"robustness.aggregator": "trim",
                                   "robustness.z_thresh": 1.0,
                                   "telemetry.metrics": None}, 4),
        "faulty-mean": ("faulty", {"robustness": None,
                                   "faults.nan_rate": 0.0}, 4),
        "telemetry": ("telemetry", {}, 2),
        "telemetry-health": ("telemetry", {
            "participation.sampler": "uniform",
            "participation.clients_per_round": 2,
            "telemetry.metrics": tel + ("health",)}, 2),
        "telemetry-int8": ("telemetry", {
            "compression.quant": "int8", "execution.storm_block": 256,
            "telemetry.metrics": tel + ("compression",)}, 2),
    }


def guard_experiment(root: str, name: str, mesh: bool = False):
    """The case's spec (on the ``[4, 2]`` mesh with ``mesh``)."""
    from repro_torch.api import Experiment
    spec, edits, steps = guard_cases()[name]
    exp = Experiment.load(os.path.join(root, GUARD_SPECS[spec])).edit(
        **{"schedule.steps": steps, **edits})
    return exp.edit(**{"execution.mesh": MESH}) if mesh else exp


def _decision_arrays(dec: dict) -> dict:
    out = {}
    for k in ("arrivals", "deadline", "deadline_next", "extensions",
              "quorum"):
        if k in dec:
            out[k] = np.asarray(torch.as_tensor(dec[k]).numpy())
    if "faults" in dec:
        for k, v in zip(("keep", "nan", "byz"), dec["faults"]):
            out[k] = v.numpy()
    if dec.get("health"):
        out["health"] = np.stack([v.numpy() for v in dec["health"]])
    if "screened" in dec:
        out["screened"] = np.asarray(dec["screened"], np.int64)
    return out


def guard_run(exp, *, spread: bool = False) -> dict:
    """Run ``exp`` through ``api.build`` on the CPU (inside the mesh's
    ranks when it has one) from the seeded init on the seeded batches, for
    its steps.  Returns what rank 0 holds, ``{key: array}``: at each step
    t (1-based) its in-band metrics ``m{t}/<key>`` and its decision record
    ``d{t}/<key>``; the eval losses ``loss``; the fields of the last two
    steps ``s{t}/<field>/<leaf>``; the last state's raw buffers ``buf<i>``
    and host fields; the wrapper calls ``calls`` (sorted by name).  With
    ``spread`` (off a mesh) also the last step's relative response of each
    buffer to a 1e-7 relative change of its entering variables
    (``spread``), which measures how ill-conditioned it is."""
    from repro_torch.api import build
    from repro_torch.kernels.storm import kernel as tk
    from repro_torch.sharding.rules import gather_state

    run = build(exp, device="cpu")
    seed = run.spec.schedule.seed
    state = run.init(torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed)
    rank0 = run.shard is None or run.shard.mesh.rank == 0
    out, losses = {}, []
    tk.reset_counts()
    for t in range(1, run.steps + 1):
        batch = run.place_batch(run.batch_fn(gen))
        if spread and t == run.steps:
            out["spread"] = _spread(run, state, batch)
        state, metrics = run.step(state, batch)
        for k, v in metrics.items():
            if k not in ("step", "decision"):
                out[f"m{t}/{k}"] = torch.as_tensor(v).detach().numpy()
        for k, v in _decision_arrays(metrics.get("decision", {})).items():
            out[f"d{t}/{k}"] = v
        losses.append(run.eval_fn(state))
        if t >= run.steps - 1:
            whole = (state if run.shard is None
                     else gather_state(run.step.spec, state, run.shard))
            if rank0:
                for k, v in field_arrays(run.step, whole,
                                         FIELDS["fedbioacc"]).items():
                    out[f"s{t}/{k}"] = v
                if t == run.steps:
                    for i, b in enumerate(whole.vars + whole.mom):
                        out[f"buf{i}"] = b.numpy().copy()
                    for k in ("stale", "deadline", "retry"):
                        v = getattr(whole, k)
                        if not isinstance(v, tuple):
                            out[k] = v.numpy().copy()
    out["loss"] = np.array(losses)
    out["calls"] = np.array([tk.CALLS[k] for k in sorted(tk.CALLS)])
    return out


def _spread(run, state, batch) -> np.ndarray:
    """Each buffer's relative change after one step from ``state`` when
    its variables are scaled by 1 + 1e-7, and then the eval loss's (off a
    mesh; ``state`` is left as it was)."""
    from repro_torch.kernels.storm import kernel as tk
    calls = dict(tk.CALLS)

    def once(vars_):
        s = state._replace(vars=tuple(v.clone() for v in vars_),
                           mom=tuple(m.clone() for m in state.mom))
        new, _ = run.step(s, batch)
        return ([b.to(torch.float64) for b in new.vars + new.mom],
                run.eval_fn(new))
    (a, la) = once(state.vars)
    (b, lb) = once(tuple(v * (1 + 1e-7) for v in state.vars))
    tk.CALLS.update(calls)          # these launches are not the run's
    return np.array([float(torch.linalg.vector_norm(x - y)
                           / torch.linalg.vector_norm(x))
                     for x, y in zip(a, b)] + [abs(la - lb) / abs(la)])


def rollback_spec(root: str):
    """The committed faulty spec cut to 4 clients (one a data rank) and 6
    steps, whose round 1 sends NaN at retry 0 (clients 1, 2; fault seed
    18) and none at retry 1, with the plain mean and no screen: the run
    rolls back once, to step 3, and runs on."""
    from repro_torch.api import Experiment
    return Experiment.load(os.path.join(root, GUARD_SPECS["faulty"])).edit(
        **{"problem.num_clients": 4, "schedule.steps": 6,
           "faults.nan_rate": 0.2, "faults.byzantine_rate": 0.0,
           "faults.seed": 18, "robustness.aggregator": "mean",
           "robustness.screen": False})


def cli_in_process(argv: list, mesh: bool = False) -> str:
    """The train CLI in this process on the CPU, logging every step
    (``--mesh 4,2`` inside the ranks with ``mesh``); returns what it
    printed (rank 0's)."""
    import contextlib
    import io

    from repro_torch.launch import train
    argv = [*argv, "--device", "cpu", "--log-every", "1"]
    if mesh:
        argv += ["--mesh", ",".join(map(str, MESH))]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train.main(argv)
    return buf.getvalue()


def rollback_cli(spec_path: str, ckpt: str, mesh: bool = False) -> str:
    """:func:`cli_in_process` on the rollback spec, checkpointing its last
    step."""
    return cli_in_process(["--experiment", spec_path, "--ckpt-dir", ckpt,
                           "--ckpt-every", "6"], mesh)


def faulty_cli(root: str, mesh: bool = False) -> str:
    """:func:`cli_in_process` on the committed faulty spec."""
    return cli_in_process(["--experiment", os.path.join(
        root, GUARD_SPECS["faulty"])], mesh)


def telemetry_cli(root: str, sink: str, mesh: bool = False) -> str:
    """:func:`cli_in_process` on the committed telemetry spec for 2 steps,
    its event stream at ``sink``."""
    return cli_in_process(["--experiment", os.path.join(
        root, GUARD_SPECS["telemetry"]), "--steps", "2", "--telemetry-sink",
        sink], mesh)


def guard_ranks(rank: int, world: int, store: str, out: str, root: str,
                names: tuple) -> None:
    """The cases ``names`` of :func:`guard_cases` on the ``[4, 2]`` mesh
    (:func:`guard_run`); rank 0 writes their records to ``out`` (npz,
    keyed ``<case>/<key>``)."""
    _join(rank, world, store)
    results = {}
    for name in names:
        rec = guard_run(guard_experiment(root, name, mesh=True))
        if rank == 0:
            results.update({f"{name}/{k}": v for k, v in rec.items()})
    if rank == 0:
        np.savez(out, **results)
    _leave()


def engine_ranks(rank: int, world: int, store: str, out: str,
                 root: str, rollback: str = "") -> None:
    """Every case of :func:`engine_cases` on the ``[4, 2]`` mesh, then the
    committed sharded spec through ``api.build`` for its 4 steps (its
    ``eval_fn`` after each), then every case of :func:`guard_cases`
    (:func:`guard_run`) and, given the rollback spec's path, the train CLI
    on it (:func:`rollback_cli`), on the telemetry spec, whose stream goes
    to ``telemetry_mesh.jsonl`` beside ``out`` (:func:`telemetry_cli`),
    and on the faulty spec (:func:`faulty_cli`); rank 0 writes the whole
    final states' fields, the losses, the guard cases' records and the
    rollback and faulty CLIs' output to ``out`` (npz)."""
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
    for name in guard_cases():
        rec = guard_run(guard_experiment(root, name, mesh=True))
        if rank == 0:
            results.update({f"{name}/{k}": v for k, v in rec.items()})
    if rollback:
        text = rollback_cli(rollback, os.path.join(os.path.dirname(out),
                                                   "rollback_mesh"),
                            mesh=True)
        telemetry_cli(root, os.path.join(os.path.dirname(out),
                                         "telemetry_mesh.jsonl"), mesh=True)
        faulty = faulty_cli(root, mesh=True)
        if rank == 0:
            results["rollback/out"] = np.array(text)
            results["faulty/out"] = np.array(faulty)
    if rank == 0:
        np.savez(out, **results)
    _leave()
