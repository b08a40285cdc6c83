"""The dry run (counterpart of ``repro/launch/dryrun.py``): size every
architecture × input shape, and every committed experiment spec, before it
runs — on fake tensors, with nothing allocated or launched on the device.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-2b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out dryrun.jsonl
    PYTHONPATH=src python -m repro_torch.launch.dryrun --experiment experiments/fedbioacc.json
    PYTHONPATH=src python -m repro_torch.launch.dryrun --fused-mesh 4,2 --arch mamba2-130m --shape train_4k

The reference lowers and compiles each program on 512 placeholder host
devices.  The port builds the same run, then traces its ``init`` and one
communication step (round 1's) under ``FakeTensorMode`` on the target
device (``--device``, ``cuda`` by default, with or without a card): every
tensor of the device is a fake that carries shape, dtype and device and no
storage, and the kernel wrappers answer fake CUDA tensors with fake outputs
and their work per launch (``kernels/abstract.py``).  Host decisions stay
on real host tensors: the Threefry keys, participation masks, straggler
arrivals and fault draws, and the state's host fields (step counter,
staleness counters, deadline, retry counter).  A spec on a mesh traces
rank 0 of a fake process group of the mesh's size
(``torch.testing._internal.distributed.fake_pg``), whose collectives move
nothing.

The record keeps the reference's keys where the meaning carries over:

* ``memory``: ``argument_size_in_bytes`` (the device state and batch),
  ``output_size_in_bytes`` (the device tensors the step returns),
  ``temp_size_in_bytes`` (the peak of live device bytes above the
  arguments, over every storage the trace creates), ``alias_size_in_bytes``
  (outputs that reuse an argument's storage); and ``host_fields``, the
  bytes of each leaf the port keeps on the host where the reference keeps
  it on the device (an int32 for the Python step counter);
* ``cost``: ``flops`` is ``FlopCounterMode``'s count of the traced ATen
  ops plus the kernels' operations; ``bytes accessed`` is the operand and
  result bytes of every traced ATen op that is not a view, plus the
  kernels' bytes.  It is the unfused sum over the ops as PyTorch issues
  them, not XLA's count after fusion, so it is larger;
* ``collectives``: ``hlo_stats.collective_bytes`` over the collectives
  the step issues;
* ``trace_ops`` (ATen ops on device tensors in the step) and ``trace_s``
  (seconds to build and trace) in place of ``hlo_bytes``, ``lower_s`` and
  ``compile_s``; ``kernels``: each kernel's fake calls in the step.

A deployment of several microbatches rematerialises each microbatch; the
layers' remat nested inside it cannot be traced on fake tensors (PyTorch's
forward-mode AD loses a functorch level), so it is traced with the layers'
remat off (``remat_layers`` in the record): its temporaries are then an
upper bound and its operations lack the layers' recomputation.

The port has no tensor-parallel tree path, so ``--arch``/``--shape``
traces each combo at its global shapes on one fake device; the record adds
``per_device_argument_bytes``, each argument leaf's bytes over the mesh
axes ``sharding/rules.py`` places it on (the production mesh, or the
multi-pod one).  Exit codes and printed records follow the reference's.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
import weakref
from typing import Any, Dict

import torch
from torch._subclasses.fake_tensor import (FakeTensor, FakeTensorMode,
                                         unset_fake_temporarily)
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.config import INPUT_SHAPES, FederatedConfig, MeshConfig
from repro_torch.configs import ARCHS, get_config
from repro_torch.core.tree_util import tree_map
from repro_torch.launch import archspec
from repro_torch.launch.hlo_stats import collective_bytes

#: modules whose factory calls make host values (keys, masks, arrivals,
#: fault draws), and (module, function) pairs that make the state's host
#: fields or decide on the host: where the fakes lie on the CPU, their
#: tensors stay real
HOST_MODULES = frozenset({
    "repro_torch.random", "repro_torch.federation.participation",
    "repro_torch.federation.stragglers", "repro_torch.federation.faults"})
HOST_FUNCTIONS = frozenset({
    ("repro_torch.optim.sequences", "_round_ctx"),
    ("repro_torch.optim.sequences", "_host_state"),
    ("repro_torch.federation.trainer", "round_ctx"),
    ("repro_torch.federation.trainer", "init_stale"),
    ("repro_torch.optim.flat", "_health_stats"),
    ("repro_torch.optim.flat", "_clip_scale"),
    ("repro_torch.optim.flat", "_trim_bounds")})


def _tensors(*objs) -> list:
    """The tensors among ``objs`` and inside their lists, tuples and dict
    values (an op's arguments and results; cheaper than a pytree walk)."""
    out = []
    stack = list(objs)
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
    return out


def _host_caller() -> bool:
    f = sys._getframe(2)
    while f is not None:
        mod = f.f_globals.get("__name__", "")
        if mod in HOST_MODULES or (mod, f.f_code.co_name) in HOST_FUNCTIONS:
            return True
        f = f.f_back
    return False


class TargetFake(FakeTensorMode):
    """``FakeTensorMode`` for the device only.  An op runs for real when
    no operand is fake and everything it touches is on the CPU; where the
    fakes lie on the CPU too, a factory call (no tensor operand) runs for
    real only if it makes a scalar (a wrapped Python number) or is made by
    the host code above.  Everything else gives fakes.

    Without a card (and on a PyTorch built without CUDA) a ``cuda`` fake
    cannot go through autograd, whose bindings open a device guard for
    the tensor's device.  There the fakes of a ``cuda`` target lie on the
    CPU and stand for CUDA tensors: the kernel wrappers dispatch them as
    CUDA tensors (``kernels.abstract.device_type``), and ``.device`` reads
    ``cpu``."""

    def __init__(self, target: torch.device):
        super().__init__(allow_non_fake_inputs=True)
        target = torch.device(target)
        # what the fakes stand for where they cannot carry it (else None)
        self.stands_for = None
        if target.type == "cuda" and not torch.cuda.is_available():
            self.stands_for, target = "cuda", torch.device("cpu")
        self.target = target
        self._entered = 0

    def __enter__(self):
        from repro_torch.kernels import abstract
        if not self._entered:
            self._saved = abstract.STANDS_FOR
            abstract.STANDS_FOR = self.stands_for
        self._entered += 1
        return super().__enter__()

    def __exit__(self, *exc):
        from repro_torch.kernels import abstract
        out = super().__exit__(*exc)
        self._entered -= 1
        if not self._entered:
            abstract.STANDS_FOR = self._saved
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._on_host(func, args, kwargs):
            return func(*args, **kwargs)
        return super().__torch_dispatch__(func, types, args, kwargs)

    def _on_host(self, func, args, kwargs) -> bool:
        tensors = _tensors(args, kwargs)
        if any(isinstance(t, FakeTensor) or t.device.type != "cpu"
               for t in tensors):
            return False
        dev = kwargs.get("device")
        if dev is not None and torch.device(dev).type != "cpu":
            return False
        if tensors or self.target.type != "cpu":
            return True
        scalar = (func is torch.ops.aten.scalar_tensor.default
                  or (bool(args) and isinstance(args[0], (list, tuple))
                      and len(args[0]) == 0))
        return scalar or _host_caller()


class FakeGenerator(torch.Generator):
    """A CPU generator that reports the target device: the model's
    initializers draw ``randn(..., generator=gen, device=gen.device)``,
    and a CUDA generator needs a card."""

    def __new__(cls, device):
        self = super().__new__(cls)
        self._target = torch.device(device)
        return self

    def __init__(self, device):
        pass

    @property
    def device(self):
        return self._target


#: ops whose result is a zero tensor when every operand is one (a zero
#: tensor holds no memory: autograd's forward-mode zero tangents), and the
#: products, zero when any factor is
_ZERO_KEEPING = frozenset({
    "to", "_to_copy", "expand", "view", "reshape", "_unsafe_view", "clone",
    "alias", "detach", "permute", "transpose", "t", "unsqueeze", "squeeze",
    "select", "slice", "add", "sub", "neg", "sum", "convert_element_type",
    "broadcast_in_dim", "view_of"})
_ZERO_PRODUCTS = frozenset({"mul"})


class _Recorder(TorchDispatchMode):
    """Live bytes of the fake storages (peak included), the ops on fake
    tensors, and their operand and result bytes.

    A zero tensor (``_efficientzerotensor``, what forward-mode AD gives an
    input without a tangent) holds no memory on the card, and nor do the
    zero tensors the ops above make of it; a fake of one carries a
    storage, so the recorder marks such results and counts them as
    empty."""

    def __init__(self):
        super().__init__()
        self.live = self.peak = 0
        self.ops = 0
        self.bytes_accessed = 0
        self._sizes: Dict[int, int] = {}

    def track(self, t, zero: bool = False) -> None:
        if not isinstance(t, FakeTensor):
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self._sizes:
            return
        n = 0 if zero or t._is_zerotensor() else st.nbytes()
        self._sizes[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        self.live -= self._sizes.pop(key, 0)

    def _zero(self, t) -> bool:
        return t._is_zerotensor() or \
            self._sizes.get(t.untyped_storage()._cdata, 1) == 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = [t for t in _tensors(args, kwargs) if isinstance(t, FakeTensor)]
        outs = [t for t in _tensors(out) if isinstance(t, FakeTensor)]
        if ins or outs:
            self.ops += 1
            if not func.is_view:
                self.bytes_accessed += sum(t.numel() * t.element_size()
                                           for t in ins + outs)
        name = func.overloadpacket.__name__
        zeros = [self._zero(t) for t in ins]
        zero = bool(zeros) and (
            (name in _ZERO_KEEPING and all(zeros))
            or (name in _ZERO_PRODUCTS and any(zeros)))
        # a cast to what the tensor already is returns it on the card; the
        # prims of forward-mode AD's decomposed formulas take no card
        # memory (measured op by op against the real step)
        empty = zero or func.namespace == "prims" or (
            name == "to" and len(ins) == 1 and len(outs) == 1
            and outs[0].dtype == ins[0].dtype
            and outs[0].device == ins[0].device)
        for t in outs:
            self.track(t, empty)
        return out


def _storages(tree) -> Dict[int, int]:
    out = {}
    for t in _tensors(tree):
        if isinstance(t, FakeTensor):
            st = t.untyped_storage()
            out[st._cdata] = st.nbytes()
    return out


def _leaves(tree) -> list:
    """Every tensor and int leaf of a tree of dicts, lists, tuples and
    NamedTuples, with its path."""
    from repro_torch.core.tree_util import tree_structure
    td = tree_structure(tree)
    return list(zip(td.paths(), td.flatten_up_to(tree)))


def host_fields(state) -> Dict[str, int]:
    """The leaves of ``state`` the port keeps on the host, with the bytes
    each takes on the reference's device (an int32 for a Python int)."""
    out = {}
    for path, leaf in _leaves(state):
        if isinstance(leaf, FakeTensor):
            continue
        if torch.is_tensor(leaf):
            out[path] = leaf.numel() * leaf.element_size()
        elif isinstance(leaf, int) and not isinstance(leaf, bool):
            out[path] = 4
    return out


@contextlib.contextmanager
def fake_world(size: int):
    """Rank 0 of a fake process group of ``size`` ranks (collectives move
    nothing), unless a process group is already set up."""
    import torch.distributed as dist
    if dist.is_initialized():
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _fakes(mode: TargetFake, tree):
    """``tree`` with every real tensor leaf made a fake on the target."""
    def one(t):
        if not torch.is_tensor(t) or isinstance(t, FakeTensor):
            return t
        if t.device.type == "meta":
            return torch.empty(t.shape, dtype=t.dtype, device=mode.target)
        return mode.from_tensor(t).to(mode.target)
    with mode:
        return tree_map(one, tree)


@contextlib.contextmanager
def healthy_round():
    """Hand the guarded means' screen the values of a healthy round.

    Off a mesh the screen reads each sender's row statistics on the host
    (``optim.flat._row_stats``: finiteness and squared norm): the dry run
    traces their computation and hands the host those of a healthy round,
    every row finite and every norm equal, so the host takes the healthy
    branch.  On a mesh the screen runs on the device
    (``flat._robust_mean_sharded``: the row statistics completed over the
    model axis, the z-score, the aggregate selected by ``where``), so the
    dry run traces all of it, collectives included, whatever the verdicts;
    what it cannot know is their values, which the step's decision record
    reads on the host: it hands the record those of a healthy round, every
    participant healthy.  Neither covers a round whose screen drops a
    sender: on a mesh the ops and the bytes are the same, off it the host
    skips nothing else either."""
    from repro_torch.optim import flat
    orig, orig_sharded = flat._row_stats, flat._robust_mean_sharded

    def stats(x0, w, corrupt):
        orig(x0, w, corrupt)
        m = x0.shape[0]
        with unset_fake_temporarily():
            return (torch.ones(m, dtype=torch.bool),
                    torch.ones(m, dtype=torch.float64))

    def sharded(seg, w, corrupt, robust, shard, m, verdicts):
        traced = None if verdicts is None else []
        orig_sharded(seg, w, corrupt, robust, shard, m, traced)
        with unset_fake_temporarily():
            healthy = (torch.ones(m) if w is None
                       else (w.cpu() > 0).to(torch.float32))
        if verdicts is not None:
            verdicts.extend(healthy for _ in traced)

    flat._row_stats, flat._robust_mean_sharded = stats, sharded
    try:
        yield
    finally:
        flat._row_stats, flat._robust_mean_sharded = orig, orig_sharded


def trace(mode: TargetFake, args, step, *, mesh=None) -> Dict[str, Any]:
    """Trace ``step(*args)`` under ``mode`` (``args`` made under it); the
    record's ``memory``, ``cost``, ``collectives``, ``trace_ops`` and
    ``kernels``, and the arguments and outputs (``_args``, ``_out``)."""
    from repro_torch.analysis.collectives import record_collectives
    from repro_torch.kernels import abstract

    arg_st = _storages(args)
    rec = _Recorder()
    for t in _tensors(args):
        rec.track(t)
    abstract.reset()
    flops = FlopCounterMode(display=False)
    with mode, rec, flops, healthy_round(), \
            record_collectives(mesh) as coll:
        out = step(*args)
    out_st = _storages(out)
    traced = {k: list(v) for k, v in abstract.TRACED.items()}
    abstract.reset()
    arg_bytes = sum(arg_st.values())
    memory = {
        "argument_size_in_bytes": arg_bytes,
        "output_size_in_bytes": sum(out_st.values()),
        "temp_size_in_bytes": rec.peak - arg_bytes,
        "alias_size_in_bytes": sum(n for k, n in out_st.items()
                                   if k in arg_st),
        "host_fields": host_fields(args),
        "output_host_fields": host_fields(out),
    }
    k_flops = sum(v[2] for v in traced.values())
    k_bytes = sum(v[1] for v in traced.values())
    return {"memory": memory,
            "cost": {"flops": float(flops.get_total_flops() + k_flops),
                     "bytes accessed": float(rec.bytes_accessed + k_bytes)},
            "collectives": collective_bytes(coll.ops),
            "trace_ops": rec.ops,
            "kernels": {k: v[0] for k, v in sorted(traced.items())},
            "_args": args, "_out": out, "_entries": coll.counter()}


def _public(rec: Dict[str, Any]) -> Dict[str, Any]:
    return {k: v for k, v in rec.items() if not k.startswith("_")}


# ---------------------------------------------------------------------------
# input specs
# ---------------------------------------------------------------------------

def input_specs(arch: str, shape_name: str, mesh_cfg: MeshConfig,
                optimized: bool = False, num_clients: int | None = None):
    """``meta`` tensors standing in for every model input of this combo
    (shapes and dtypes, no storage).  ``num_clients`` overrides the
    archspec client count (the fused-mesh path sizes M to its mesh)."""
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    S, B = shape.seq_len, shape.global_batch
    i32, bf16 = torch.int32, torch.bfloat16

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    def lm_batch(lead):
        b = {"tokens": meta(lead + (S,), i32),
             "labels": meta(lead + (S,), i32)}
        if cfg.family == "vlm":
            b["patches"] = meta(lead + (cfg.num_patches, cfg.frontend_dim),
                                bf16)
        if cfg.family == "audio":
            b = {"frames": meta(lead + (S, cfg.frontend_dim), bf16),
                 "labels": meta(lead + (S,), i32)}
        return b

    if shape.kind == "train":
        M = (num_clients if num_clients is not None
             else archspec.num_clients(arch, mesh_cfg, optimized))
        one = lm_batch((M, max(B // M, 1)))
        return {"train": one, "val": one}
    if shape.kind == "prefill":
        return lm_batch((B,))
    # decode: one token + position
    return {"tokens": meta((B, 1), i32), "pos": meta((), i32)}


# ---------------------------------------------------------------------------
# builders per mode: each builds under the mode and returns
# (args, step, placements of the args)
# ---------------------------------------------------------------------------

def traced_remat(n_micro: int) -> bool:
    """The layers' remat the dry run traces at ``n_micro`` microbatches:
    on for one; off for several, where each microbatch is rematerialised
    as a whole and the layers' remat would nest inside it, which fake
    tensors cannot carry through forward-mode AD (PyTorch's functorch
    levels escape: ``ADInterpreters.cpp`` asserts)."""
    return n_micro <= 1


def _model(arch: str):
    from repro_torch.models.registry import build_model
    return build_model(get_config(arch), dtype=torch.bfloat16)


def build_train(mode: TargetFake, arch: str, shape_name: str,
                mesh_cfg: MeshConfig, optimized: bool = False):
    """The unfused step of the archspec deployment: the registry factory
    at its ``n_micro``, remat on, its oracles fused or not."""
    from repro_torch.api import registry
    from repro_torch.sharding import rules
    spec = archspec.deploy_spec(arch, optimized)
    M = archspec.num_clients(arch, mesh_cfg, optimized)
    fed = FederatedConfig(algorithm=spec.algorithm, num_clients=M,
                          local_steps=4, placement=spec.placement)
    init, step = registry.get(spec.algorithm).factory(
        _model(arch), fed, n_micro=spec.n_micro_train,
        remat=traced_remat(spec.n_micro_train),
        fuse_oracles=spec.fuse_oracles)
    with mode:
        state = init(FakeGenerator(mode.target))
    state = state._replace(step=fed.local_steps - 1)
    batch = _fakes(mode, input_specs(arch, shape_name, mesh_cfg, optimized))
    placed = (rules.state_specs(state, mesh_cfg, placement=spec.placement),
              rules.batch_specs(batch, mesh_cfg, client_axis=True,
                                placement=spec.placement))
    return (state, batch), step, placed


def build_prefill(mode: TargetFake, arch: str, shape_name: str,
                  mesh_cfg: MeshConfig):
    """The prompt pass as the port's serving runs it (both kernels'
    switches on); the audio encoder's forward with remat."""
    from repro_torch.sharding import rules
    cfg = get_config(arch)
    spec = archspec.deploy_spec(arch)
    model = _model(arch)
    S = INPUT_SHAPES[shape_name].seq_len

    if cfg.family == "audio":
        def fn(params, b):
            logits, _ = model.forward(params, b, remat=True)
            return logits[:, -1, :]
    else:
        def fn(params, b):
            return model.prefill(params, b, cache_len=S, use_flash=True,
                                 use_lru_kernel=True)

    with mode:
        params = model.init(FakeGenerator(mode.target))
    batch = _fakes(mode, input_specs(arch, shape_name, mesh_cfg))
    placed = (rules.param_specs(params, mesh_cfg, placement="client_sharded",
                                client_axis=False, fsdp=spec.serve_fsdp),
              rules.batch_specs(batch, mesh_cfg, client_axis=False))
    return (params, batch), fn, placed


def build_decode(mode: TargetFake, arch: str, shape_name: str,
                 mesh_cfg: MeshConfig):
    """One decode step over caches of the shape's length, in hint mode."""
    from repro_torch.sharding import rules
    from repro_torch.sharding.hints import sharding_hints
    cfg = get_config(arch)
    spec = archspec.deploy_spec(arch)
    model = _model(arch)
    shape = INPUT_SHAPES[shape_name]
    S, B = shape.seq_len, shape.global_batch
    cache_len = S + (cfg.num_patches if cfg.family == "vlm" else 0)

    def fn(params, caches, tokens, pos):
        with sharding_hints():
            return model.decode_step(params, caches, tokens, pos)

    with mode:
        params = model.init(FakeGenerator(mode.target))
        caches = model.init_cache(B, cache_len, mode.target)
    io = _fakes(mode, input_specs(arch, shape_name, mesh_cfg))
    placed = (rules.param_specs(params, mesh_cfg, placement="client_sharded",
                                client_axis=False, fsdp=spec.serve_fsdp),
              rules.cache_specs(caches, mesh_cfg), (), ())
    return (params, caches, io["tokens"], io["pos"]), fn, placed


def _experiment_for_fused(arch: str, fused_mesh: tuple, optimized: bool,
                          overlap: bool, num_clients: int):
    """The declarative Experiment ``--fused-mesh`` traces: the archspec
    deployment as spec fields, built through ``api.build`` as train and
    resume build theirs."""
    from repro_torch.api.spec import (AlgorithmSpec, ExecutionSpec,
                                      Experiment, ProblemSpec, ScheduleSpec)
    spec = archspec.deploy_spec(arch, optimized)
    return Experiment(
        algorithm=AlgorithmSpec(spec.algorithm),
        problem=ProblemSpec(arch=arch, reduced=False,
                            num_clients=num_clients),
        execution=ExecutionSpec(fuse_storm=True,
                                fuse_oracles=spec.fuse_oracles,
                                mesh=tuple(fused_mesh), overlap=overlap,
                                n_micro=spec.n_micro_train,
                                remat=traced_remat(spec.n_micro_train)),
        schedule=ScheduleSpec(local_steps=4))


def build_run(mode: TargetFake, exp, batch=None):
    """(run, args): ``exp`` built for the mode's target, its init, the
    step counter at round 1's communication step, and ``batch`` (default:
    the run's own stream, seed 0) cut to the rank's rows."""
    from repro_torch.api import build as api_build
    # built under the mode: what the build draws for the device (the
    # evaluation batch) is a fake
    with mode:
        run = api_build(exp, device=mode.target)
        state = run.init(FakeGenerator(mode.target))
        if batch is None:
            batch = run.batch_fn(torch.Generator().manual_seed(0))
    state = state._replace(step=run.spec.schedule.local_steps - 1)
    return run, (state, _fakes(mode, run.place_batch(batch)))


# ---------------------------------------------------------------------------
# runners
# ---------------------------------------------------------------------------

# The compressed-collective audit is shared with the static verifier
# (its W103 rule): one byte model, no drift between the two consumers.
from repro_torch.analysis.collectives import (  # noqa: E402
    check_compressed_collectives as _check_compressed_collectives)


def _mesh_size(exp) -> int:
    m = exp.execution.mesh
    if m is None:
        return 1
    if m == "production":
        return 256
    return m[0] * m[1]


def trace_experiment(exp, device="cuda", batch=None):
    """(record fields, run) of one spec traced on ``device``: rank 0 of a
    fake group of its mesh's size if it has a mesh."""
    mode = TargetFake(device)
    with fake_world(_mesh_size(exp)):
        run, args = build_run(mode, exp, batch)
        mesh = None if run.shard is None else run.shard.mesh
        out = trace(mode, args, run.step, mesh=mesh)
    if mesh is not None:
        out["mesh"] = dict(mesh.shape)
    return out, run


def run_experiment(exp_path: str, *, device="cuda") -> Dict[str, Any]:
    """Trace one declarative Experiment spec (``--experiment``): the run
    the train CLI would execute."""
    from repro_torch.api import Experiment
    rec: Dict[str, Any] = {"experiment": exp_path, "kind": "train"}
    t0 = time.time()  # analysis: ignore[L301] trace timing
    out, run = trace_experiment(Experiment.load(exp_path), device)
    rec.update(status="OK", trace_s=round(time.time() - t0, 1))  # analysis: ignore[L301] trace timing
    rec.update(_public(out))
    exp, sharded = run.spec, run.shard is not None
    if exp.compression is not None and exp.compression.quant is not None:
        if not sharded:
            rec["compression_check"] = "unsharded: no collectives to audit"
        else:
            rec["compression_check"] = _check_compressed_collectives(
                exp, run.step.spec, rec["collectives"])
    if exp.telemetry is not None:
        # the dry run's side of the bytes reconciliation: the recorded
        # per-dtype collective bytes of the step beside the analytic
        # per-round model the train CLI's `comm` events carry
        from repro_torch.telemetry import EventLog, comm_plan, round_bytes
        sink = exp.telemetry.sink or "dryrun_events.jsonl"
        with EventLog(sink, experiment=json.loads(exp.to_json()),
                      kind="dryrun") as log:
            log.emit("hlo_collectives",
                     bytes_by_dtype=rec["collectives"]["bytes_by_dtype"],
                     counts=rec["collectives"].get("counts"),
                     sharded=sharded)
            flat_spec = getattr(run.step, "spec", None)
            aspec = getattr(run.step, "aspec", None)
            if flat_spec is not None and aspec is not None:
                plan = comm_plan(flat_spec, aspec, exp.compression)
                rb = round_bytes(plan, 1) if plan is not None else None
                if rb is not None:
                    log.emit("comm", step=exp.schedule.local_steps,
                             retry=0, **rb)
        rec["telemetry_sink"] = sink
    return rec


def run_one(arch: str, shape_name: str, *, multi_pod: bool = False,
            optimized: bool = False, fused_mesh: tuple | None = None,
            overlap: bool = False, device="cuda") -> Dict[str, Any]:
    """Trace one arch × shape (or the fused substrate on ``fused_mesh``)."""
    from repro_torch.sharding import rules
    cfg = get_config(arch)
    ok, reason = archspec.shape_applicable(arch, cfg, shape_name)
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "multi_pod": multi_pod, "optimized": optimized}
    if fused_mesh is not None:
        rec["fused_mesh"] = list(fused_mesh)
        rec["overlap"] = overlap
    if not ok:
        rec.update(status="SKIP", reason=reason)
        return rec

    mesh_cfg = MeshConfig(multi_pod=multi_pod)
    kind = INPUT_SHAPES[shape_name].kind
    if fused_mesh is not None and kind != "train":
        rec.update(status="SKIP",
                   reason="--fused-mesh applies to train shapes only")
        return rec
    t0 = time.time()  # analysis: ignore[L301] trace timing
    mode = TargetFake(device)
    placed = None
    if fused_mesh is not None:
        M = 2 * fused_mesh[0]                 # two clients a data shard
        exp = _experiment_for_fused(arch, fused_mesh, optimized, overlap, M)
        batch = input_specs(arch, shape_name, mesh_cfg, optimized,
                            num_clients=M)
        out, _ = trace_experiment(exp, device, batch)
    else:
        build = {"train": build_train, "prefill": build_prefill,
                 "decode": build_decode}[kind]
        kw = {"optimized": optimized} if kind == "train" else {}
        args, step, specs = build(mode, arch, shape_name, mesh_cfg, **kw)
        out = trace(mode, args, step)
        placed = sum(rules.placed_bytes(a, s, mesh_cfg)
                     for a, s in zip(args, specs))
    rec.update(status="OK", kind=kind,
               trace_s=round(time.time() - t0, 1))  # analysis: ignore[L301] trace timing
    if kind == "train":
        n_micro = archspec.deploy_spec(arch, optimized).n_micro_train
        rec.update(n_micro=n_micro, remat_layers=traced_remat(n_micro))
    rec.update(_public(out))
    if placed is not None:
        rec["per_device_argument_bytes"] = placed
        rec["mesh_shape"] = list(mesh_cfg.shape)
    return rec


def _emit(rec: Dict[str, Any], out_path) -> None:
    print(json.dumps(rec, indent=1), flush=True)
    if out_path:
        with open(out_path, "a") as fh:
            fh.write(json.dumps(rec) + "\n")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="dry run on fake tensors")
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=sorted(INPUT_SHAPES), default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--optimized", action="store_true",
                    help="the optimized deployment (fused oracles, "
                         "client_pure placement for small archs)")
    ap.add_argument("--fused-mesh", default=None, metavar="DATA,MODEL",
                    help="trace the FUSED sharded flat-substrate train step "
                         "on a (data, model) mesh of fake ranks instead of "
                         "the unfused step (train shapes only)")
    ap.add_argument("--overlap", action="store_true",
                    help="with --fused-mesh: the comm/compute overlap "
                         "schedule")
    ap.add_argument("--experiment", default=None, metavar="EXP.json",
                    help="trace ONE declarative Experiment spec instead of "
                         "the (arch × shape) grid: the run launch.train "
                         "would execute (rank 0 of a fake group if the spec "
                         "has a mesh)")
    ap.add_argument("--all", action="store_true",
                    help="run every (arch × shape)")
    ap.add_argument("--out", default=None, help="append JSON records here")
    ap.add_argument("--device", default="cuda",
                    help="the target device of the fake tensors (default "
                         "cuda; no card is needed)")
    args = ap.parse_args(argv)
    fused_mesh = (tuple(int(v) for v in args.fused_mesh.split(","))
                  if args.fused_mesh else None)

    if args.experiment:
        try:
            rec = run_experiment(args.experiment, device=args.device)
        except Exception as e:
            rec = {"experiment": args.experiment, "status": "FAIL",
                   "error": f"{type(e).__name__}: {e}"}
        _emit(rec, args.out)
        if rec["status"] != "OK":
            raise SystemExit(1)
        return

    if args.all:
        combos = [(a, s) for a, s, _, _ in archspec.all_combos()]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        combos = [(args.arch, args.shape)]

    records = []
    for arch, shape_name in combos:
        print(f"=== {arch} × {shape_name} (multi_pod={args.multi_pod}) ===",
              flush=True)
        try:
            rec = run_one(arch, shape_name, multi_pod=args.multi_pod,
                          optimized=args.optimized, fused_mesh=fused_mesh,
                          overlap=args.overlap, device=args.device)
        except Exception as e:        # record failures — they are bugs
            rec = {"arch": arch, "shape": shape_name,
                   "multi_pod": args.multi_pod, "optimized": args.optimized,
                   "status": "FAIL",
                   "error": f"{type(e).__name__}: {e}"}
        _emit(rec, args.out)
        records.append(rec)

    n_ok = sum(r["status"] == "OK" for r in records)
    n_skip = sum(r["status"] == "SKIP" for r in records)
    n_fail = sum(r["status"] == "FAIL" for r in records)
    print(f"done: {n_ok} OK, {n_skip} SKIP, {n_fail} FAIL")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
