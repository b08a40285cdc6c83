"""The dry run (``repro_torch.launch.dryrun``) and what it reads, held to
the reference on the CPU: the deployment table (``launch/archspec.py``),
the input shapes, ``make_model_batch`` bit for bit, the collective byte
model (``launch/hlo_stats.py``) and the kernels' fake rules; then the
unsharded ``--experiment`` record of ``fedbioacc.json`` against the
reference's compiled ``memory_analysis()``, its operations against
``FlopCounterMode`` over the real CPU step, and the three grid kinds on
reduced configs (the train kind in ``test_torch_dryrun_specs.py``).
``repro.launch.dryrun`` sets ``XLA_FLAGS`` when it is imported, so its
``input_specs`` runs in a subprocess."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import torch  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro.config import InputShape as JInputShape  # noqa: E402
from repro.config import MeshConfig as JMesh  # noqa: E402
from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.data.synthetic import make_model_batch as jmake_batch  # noqa: E402
from repro.launch import archspec as jarchspec  # noqa: E402
from repro.launch.hlo_stats import collective_bytes as jcollective_bytes  # noqa: E402

from repro_torch.analysis.collectives import Record  # noqa: E402
from repro_torch.api import Experiment, build  # noqa: E402
from repro_torch.config import INPUT_SHAPES, InputShape, MeshConfig  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.data.synthetic import make_model_batch  # noqa: E402
from repro_torch.kernels import abstract  # noqa: E402
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels.flash import ops as flash_ops  # noqa: E402
from repro_torch.kernels.lru import ops as lru_ops  # noqa: E402
from repro_torch.kernels.storm import kernel as storm  # noqa: E402
from repro_torch.kernels.storm import quantpack as qp  # noqa: E402
from repro_torch.kernels.storm import ref as storm_ref  # noqa: E402
from repro_torch.kernels.storm.ops import storm_update  # noqa: E402
from repro_torch.launch import archspec, dryrun  # noqa: E402
from repro_torch.launch.hlo_stats import collective_bytes  # noqa: E402

from torch_parity import bits  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
SPEC = str(ROOT / "experiments" / "fedbioacc.json")


# --- the deployment table ---------------------------------------------------

def test_archspec_equals_reference():
    combos = archspec.all_combos()
    assert combos == jarchspec.all_combos()
    assert len(combos) == 40
    assert sum(not ok for _, _, ok, _ in combos) == 8
    for arch in ARCHS:
        for optimized in (False, True):
            assert dataclasses.astuple(archspec.deploy_spec(arch, optimized)) \
                == dataclasses.astuple(jarchspec.deploy_spec(arch, optimized))
            for multi_pod in (False, True):
                assert archspec.num_clients(
                    arch, MeshConfig(multi_pod), optimized) == \
                    jarchspec.num_clients(arch, JMesh(multi_pod), optimized)
    for name, shape in INPUT_SHAPES.items():
        assert dataclasses.astuple(shape) == dataclasses.astuple(
            __import__("repro.config", fromlist=["INPUT_SHAPES"])
            .INPUT_SHAPES[name])
    for multi_pod in (False, True):
        m, jm = MeshConfig(multi_pod), JMesh(multi_pod)
        assert (m.shape, m.axes, m.num_devices) == \
            (jm.shape, jm.axes, jm.num_devices)


_REF_SPECS = """
import json, sys
sys.path.insert(0, "src")
import jax
from repro.config import INPUT_SHAPES, MeshConfig
from repro.configs import ARCHS
from repro.launch import dryrun
out = {}
for arch in ARCHS:
    for shape in INPUT_SHAPES:
        for opt in (False, True):
            for mp in (False, True):
                for nc in (None, 8):
                    t = dryrun.input_specs(arch, shape, MeshConfig(mp), opt,
                                           num_clients=nc)
                    out[repr((arch, shape, opt, mp, nc))] = [
                        (jax.tree_util.keystr(k), list(v.shape), str(v.dtype))
                        for k, v in jax.tree_util.tree_leaves_with_path(t)]
print(json.dumps(out))
"""


def test_input_specs_equal_reference():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", _REF_SPECS], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    want = json.loads(res.stdout.strip().splitlines()[-1])
    n = 0
    for arch in ARCHS:
        for shape in INPUT_SHAPES:
            for opt in (False, True):
                for mp in (False, True):
                    for nc in (None, 8):
                        t = dryrun.input_specs(arch, shape, MeshConfig(mp),
                                               opt, num_clients=nc)
                        got = [[k, list(v.shape), str(v.dtype).replace(
                            "torch.", "")] for k, v in dryrun._leaves(t)]
                        assert got == want[repr((arch, shape, opt, mp, nc))]
                        assert all(v.device.type == "meta"
                                   for _, v in dryrun._leaves(t))
                        n += 1
    assert n == 10 * 4 * 8


@pytest.mark.parametrize("num_clients", [0, 2])
@pytest.mark.parametrize("arch", ["mamba2-130m", "gemma2-2b",
                                  "hubert-xlarge", "internvl2-76b",
                                  "olmoe-1b-7b", "recurrentgemma-9b"])
def test_make_model_batch_bitwise(arch, num_clients):
    shape = ("small", 24, 4, "train")
    want = jmake_batch(JARCHS[arch].reduced(), JInputShape(*shape),
                       num_clients=num_clients)
    got = make_model_batch(get_config(arch).reduced(), InputShape(*shape),
                           num_clients=num_clients)
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
        assert str(got[k].dtype).replace("torch.", "") == str(want[k].dtype)
        assert np.array_equal(bits(got[k]), bits(want[k])), k


# --- the collective byte model ----------------------------------------------

_HLO = """
  %ar = bf16[16,1024]{1,0} all-reduce(bf16[16,1024] %p0), replica_groups={}
  %ag.1 = f32[8,256]{1,0} all-gather(f32[8,128] %p1), dimensions={1}
  %a2a = (s32[4,8]{1,0}, s32[4,8]{1,0}) all-to-all(s32[4,8] %x, s32[4,8] %y)
  %cp = u8[100]{0} collective-permute(u8[100] %z), source_target_pairs={{0,1}}
  %ars = bf16[64]{0} all-reduce-start(bf16[64] %w)
  %other = f32[2,2]{1,0} add(f32[2,2] %a, f32[2,2] %b)
"""
# the same collectives as (op, result bytes by dtype), as a run records them
_OPS = [("all-reduce", {"bf16": 16 * 1024 * 2}),
        ("all-gather", {"f32": 8 * 256 * 4}),
        ("all-to-all", {"s32": 2 * 4 * 8 * 4}),
        ("collective-permute", {"u8": 100}),
        ("all-reduce", {"bf16": 64 * 2})]


def test_collective_bytes_equal_reference_parser():
    want = jcollective_bytes(_HLO)
    assert collective_bytes(_OPS) == want
    rec = Record()
    rec.ops.extend(_OPS)
    assert rec.wire() == want
    assert want["counts"]["all-reduce"] == 2


def test_collective_bytes_names_other_ops():
    out = collective_bytes([("collective-broadcast", {"f32": 8})])
    assert out["counts"]["collective-broadcast"] == 1
    assert out["total_bytes"] == 8


# --- the kernels on fakes ----------------------------------------------------

def _no_build(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a fake call reached the kernel build")
    monkeypatch.setattr(kbuild, "load", refuse)
    monkeypatch.setattr(kbuild, "build_all", refuse)


def _counts():
    return ({**storm.CALLS, **qp.CALLS, **flash_ops.CALLS, **lru_ops.CALLS},
            {**storm.LAUNCHES, **qp.LAUNCHES, **flash_ops.LAUNCHES,
             **lru_ops.LAUNCHES})


def _entry_points(gen):
    """(name, wrapper call, plain call) over real CPU inputs ``args``."""
    n, block = 4096, 1024
    tiles = n // block
    p = torch.randn(n, generator=gen).bfloat16()
    f = [torch.randn(n, generator=gen) for _ in range(3)]
    t = [torch.rand(tiles, generator=gen) for _ in range(2)]
    q, s = storm_ref.quantpack_ref(f[0], block)
    qkv = (torch.randn(1, 40, 4, 16, generator=gen),
           torch.randn(1, 40, 2, 16, generator=gen),
           torch.randn(1, 40, 2, 16, generator=gen))
    ab = (torch.rand(2, 33, 12, generator=gen),
          torch.randn(2, 33, 12, generator=gen))
    tree = {"a": torch.randn(3, 5, generator=gen),
            "b": torch.randn(7, generator=gen).bfloat16()}
    mom = {"a": torch.randn(3, 5, generator=gen),
           "b": torch.randn(7, generator=gen)}
    return [
        ("storm3_step", lambda *a: storm.storm3_step(*a, block=block),
         lambda *a: storm_ref.storm3_step_ref(*a, block),
         (p, f[0], f[1], t[0], t[1])),
        ("storm3_update", lambda *a: storm.storm3_update(*a, block=block),
         lambda *a: storm_ref.storm3_update_ref(*a, block),
         (p, f[0], f[1], f[2], t[0], t[1])),
        ("sgd3_step", lambda *a: storm.sgd3_step(*a, block=block),
         lambda *a: storm_ref.sgd3_step_ref(*a, block), (p, f[0], t[0])),
        ("momsgd3_step", lambda *a: storm.momsgd3_step(*a, block=block),
         lambda *a: storm_ref.momsgd3_step_ref(*a, block),
         (p, f[0], f[1], t[0], t[1])),
        ("storm_update", lambda *a: storm.storm_update_flat(*a, 0.1, 0.9),
         lambda *a: storm_ref.storm_update_ref(*a, 0.1, 0.9),
         (p, f[0], f[1], f[2])),
        # two (param, momentum) dtype groups: two calls of the flat kernel
        ("storm_update", lambda *a: storm_update(*a, 0.1, 0.9),
         lambda *a: storm_update(*a, 0.1, 0.9), (tree, mom, mom, mom)),
        ("quantpack", lambda x: qp.quantpack_flat(x, block=block),
         lambda x: storm_ref.quantpack_ref(x, block), (f[0],)),
        ("quantunpack", lambda a, b: qp.quantunpack_flat(a, b, block=block),
         lambda a, b: storm_ref.quantunpack_ref(a, b, block), (q, s)),
        ("flash_attention",
         lambda *a: flash_ops.flash_attention(*a, window=16),
         lambda *a: flash_ops.flash_attention_ref(*a, window=16), qkv),
        ("lru_scan", lru_ops.lru_scan, lru_ops.lru_scan_ref, ab),
    ]


def _meta(x):
    return [(tuple(t.shape), t.dtype) for t in dryrun._tensors(x)]


@pytest.mark.parametrize("target", ["cuda", "cpu"])
def test_kernel_entry_points_on_fakes(target, monkeypatch):
    _no_build(monkeypatch)
    gen = torch.Generator().manual_seed(0)
    for name, wrapper, plain, args in _entry_points(gen):
        want = plain(*args)
        mode = dryrun.TargetFake(target)
        fakes = dryrun._fakes(mode, args)
        calls, launches = _counts()
        abstract.reset()
        with mode:
            got = wrapper(*fakes)
        calls2, launches2 = _counts()
        assert _meta(got) == _meta(want), name
        assert calls2[name] == calls[name] + (
            2 if isinstance(args[0], dict) else 1), name
        assert launches2 == launches, name
        if target == "cuda":
            assert abstract.TRACED, name
        else:
            assert not abstract.TRACED, name     # the plain version ran
    abstract.reset()


def test_fake_rules_record_work_and_variants(monkeypatch):
    _no_build(monkeypatch)
    mode = dryrun.TargetFake("cuda")
    with mode:
        x = torch.empty(8192, device=mode.target)
        a = torch.empty(2, 64, 12, device=mode.target)
        b = torch.empty(2, 64, 10, device=mode.target)
        q = torch.empty(1, 100, 8, 64, dtype=torch.bfloat16,
                        device=mode.target)
        kv = torch.empty(1, 100, 2, 64, dtype=torch.bfloat16,
                         device=mode.target)
        abstract.reset()
        qp.quantpack_flat(x, block=1024)
        lru_ops.lru_scan(a, a)
        lru_ops.lru_scan(b, b)
        flash_ops.flash_attention(q, kv, kv, window=32)
    traced = dict(abstract.TRACED)
    abstract.reset()
    assert traced["quantpack_cluster"] == [1, *qp.work("quantpack", 8192,
                                                        1024)[:2]]
    assert traced["lru_scan_tma"][0] == 1 and \
        traced["lru_scan_lanes"][0] == 1
    w = flash_ops.work(1, 100, 8, 2, 64, torch.bfloat16, causal=True,
                       window=32)
    assert traced["flash_attention"] == [1, w.bytes, w.flops]
    assert w.rate == "bf16_tc"
    pairs = int(flash_ops.band_pairs(100, causal=True, window=32))
    assert w.flops == 4 * 2 * 64 * pairs * 8


def test_work_counts_what_chip_smoke_moves():
    # each input read once, each output written once
    n, block = 8 * 1024, 1024
    assert storm.work("storm3_step", n, torch.bfloat16, block=block) == (
        2 * n + 2 * 4 * n + 2 * 4 * (n // block) + 2 * n + 4 * n, 4 * n,
        "f32")
    assert storm.work("sgd3_step", n, torch.float32, block=block).bytes == \
        4 * n * 3 + 4 * (n // block)
    assert storm.work("storm_update", n, torch.bfloat16,
                      m_dtype=torch.float32).bytes == 2 * 2 * n + 4 * 4 * n
    assert qp.work("quantunpack", n, block) == (n + 4 * (n // block)
                                                 + 4 * n, n, "f32")
    assert lru_ops.work(2, 8, 4, h0=True).bytes == 4 * (3 * 64 + 8)
    for S in (1, 7, 64):
        for causal in (True, False):
            for window in (0, 1, 5, 64, 99):
                mask = flash_ops.flash_attention_ref.__globals__["band_mask"](
                    S, causal=causal, window=window)
                assert flash_ops.band_pairs(
                    S, causal=causal, window=window) == int(mask.sum())


def test_recorder_counts_zero_tensors_as_empty():
    # forward-mode AD's zero tangents hold no memory on the card: neither
    # do their sums and products, nor a cast to what a tensor already is
    mode, rec = dryrun.TargetFake("cuda"), dryrun._Recorder()
    with mode, rec:
        z = torch._efficientzerotensor((256,), dtype=torch.float32,
                                       device=mode.target)
        e = torch.empty(256, device=mode.target)
        y, s = z * e, z + z
        w = e + 1
        c = torch.ops.aten.to.dtype(e, torch.float32)   # e itself on the card
    for t in (z, y, s):
        assert rec._sizes[t.untyped_storage()._cdata] == 0
    assert rec._sizes.get(c.untyped_storage()._cdata) in (0, 256 * 4) and \
        (c.untyped_storage()._cdata == e.untyped_storage()._cdata
         or rec._sizes[c.untyped_storage()._cdata] == 0)
    assert rec.peak == rec.live == 2 * 256 * 4          # e and w
    del w


# --- the unsharded --experiment record --------------------------------------

@pytest.fixture(scope="module")
def fedbioacc_trace():
    return dryrun.trace_experiment(Experiment.load(SPEC), "cpu")


def test_experiment_memory_equals_reference(fedbioacc_trace):
    from repro.api import Experiment as JExperiment
    from repro.api import build as jbuild
    out, _ = fedbioacc_trace
    run = jbuild(JExperiment.load(SPEC))
    st = jax.eval_shape(run.init, jax.random.PRNGKey(0))
    bt = jax.eval_shape(run.batch_fn, jax.random.PRNGKey(0))
    compiled = jax.jit(run.step, donate_argnums=(0,)).lower(st, bt).compile()
    ma = compiled.memory_analysis()
    mem = out["memory"]
    # the port keeps the step counter on the host (an int32 on the device
    # in the reference), in the state and in the step's metrics
    assert mem["host_fields"] == {"[0].step": 4}
    assert mem["output_host_fields"] == {"[0].step": 4, "[1]['step']": 4}
    assert ma.argument_size_in_bytes == \
        mem["argument_size_in_bytes"] + sum(mem["host_fields"].values())
    # XLA's output size also holds the output tuple's table: 8 bytes a leaf
    n_out = len(jax.tree.leaves(jax.eval_shape(run.step, st, bt)))
    assert ma.output_size_in_bytes == mem["output_size_in_bytes"] + sum(
        mem["output_host_fields"].values()) + 8 * n_out


def test_experiment_flops_equal_real_cpu_step(fedbioacc_trace):
    out, _ = fedbioacc_trace
    run = build(Experiment.load(SPEC), device="cpu")
    state = run.init(torch.Generator().manual_seed(0))
    state = state._replace(step=run.spec.schedule.local_steps - 1)
    batch = run.batch_fn(torch.Generator().manual_seed(0))
    counter = FlopCounterMode(display=False)
    with counter:
        run.step(state, batch)
    assert out["cost"]["flops"] == float(counter.get_total_flops())
    assert out["kernels"] == {}              # the plain versions ran
    assert out["cost"]["bytes accessed"] > out["memory"][
        "argument_size_in_bytes"]


def test_experiment_cuda_target_adds_kernel_work():
    spec = Experiment.load(str(ROOT / "experiments" / "fedavg.json"))
    out_cpu, _ = dryrun.trace_experiment(spec, "cpu")
    out, run = dryrun.trace_experiment(spec, "cuda")
    assert out["kernels"] == {"momsgd3_step": 1}
    (grp,) = run.step.spec.groups
    n = run.spec.problem.num_clients * grp.padded
    w = storm.work("momsgd3_step", n, grp.dtype, block=grp.block)
    # the plain version's elementwise ops count no FLOPs; the kernel's do
    assert out["cost"]["flops"] == out_cpu["cost"]["flops"] + w.flops
    for key in ("argument_size_in_bytes", "output_size_in_bytes"):
        assert out["memory"][key] == out_cpu["memory"][key]


def test_cli_prints_the_record(tmp_path, capsys):
    out_file = tmp_path / "rec.jsonl"
    dryrun.main(["--experiment", str(ROOT / "experiments" / "fedavg.json"),
                 "--device", "cpu", "--out", str(out_file)])
    rec = json.loads(out_file.read_text())
    assert rec["status"] == "OK"
    assert {"memory", "cost", "collectives", "trace_ops", "trace_s",
            "kernels"} <= set(rec)
    with pytest.raises(SystemExit):
        dryrun.main(["--experiment", str(tmp_path / "missing.json")])


# --- the grid, on reduced configs -------------------------------------------

@pytest.fixture
def reduced_grid(monkeypatch):
    _reduced_grid(monkeypatch)


def _reduced_grid(monkeypatch):
    """Reduced configs at small shapes, and a deployment of 2 clients and
    2 microbatches, so that the grid's three kinds trace in seconds."""
    monkeypatch.setattr(dryrun, "get_config",
                        lambda a: get_config(a).reduced())
    small = {k: InputShape(k, 32, {"train": 8, "prefill": 2}.get(v.kind, 4),
                           v.kind) for k, v in INPUT_SHAPES.items()}
    monkeypatch.setattr(dryrun, "INPUT_SHAPES", small)
    monkeypatch.setattr(archspec, "_DEFAULT", archspec.DeploySpec(
        "client_sharded", 2, "fedbioacc", 2, False))


@pytest.mark.parametrize("arch,shape,kernels", [
    ("recurrentgemma-9b", "prefill_32k",
     {"flash_attention": 1, "lru_scan_tma": 2}),
    ("recurrentgemma-9b", "decode_32k", {}),
    ("hubert-xlarge", "decode_32k", None),
    ("gemma2-2b", "long_500k", {}),
    ("granite-8b", "long_500k", None),
])
def test_grid_kinds_on_reduced_configs(reduced_grid, arch, shape, kernels,
                                       monkeypatch):
    _no_build(monkeypatch)
    rec = dryrun.run_one(arch, shape, device="cuda")
    if kernels is None:
        ok, reason = jarchspec.shape_applicable(arch, JARCHS[arch], shape)
        assert not ok and rec == {"arch": arch, "shape": shape,
                                  "multi_pod": False, "optimized": False,
                                  "status": "SKIP", "reason": reason}
        return
    assert rec["status"] == "OK", rec
    assert rec["kernels"] == kernels
    mem = rec["memory"]
    assert mem["argument_size_in_bytes"] > 0 and mem["temp_size_in_bytes"] > 0
    assert 0 < rec["per_device_argument_bytes"] < \
        mem["argument_size_in_bytes"]
    assert rec["cost"]["flops"] > 0 and rec["trace_ops"] > 0
    if rec["kind"] == "train":
        assert rec["n_micro"] == 2 and rec["remat_layers"] is False
