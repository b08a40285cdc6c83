"""Drive the PyTorch port on one CUDA card and check it end to end.

    python3 chip_smoke.py

Run from the root of a checkout; takes no arguments and needs one card.
Phases, each of which stops the script with a non-zero exit on failure:

1. the card's name and power limit, as ``nvidia-smi`` reports them;
2. build every CUDA source of the port (one ``nvcc`` each, all at once);
3. every kernel against its plain PyTorch version at the shapes its path
   gives it (full-width Mamba-2-130M, 2 clients: a bf16 buffer and an f32
   buffer; the FedBiOAcc buffers for the STORM pair, FedBiO's for
   ``sgd3_step``, FedAvg's for ``momsgd3_step``), bit for bit, with median
   times over CUDA events;
4. a reduced-model cross-check of each path: two steps on the card against
   two on the CPU from the same initial state and batches (within 1e-4 of
   each buffer's norm: reduction orders differ between the two devices);
5. the paths: ``experiments/fedbioacc.json``, ``fedbio.json``,
   ``fedbio_local.json`` and ``fedavg.json``, each at full Mamba-2-130M
   width (bf16, 2 clients, 1 sequence of 512 tokens each — two SSD chunks),
   four steps (two communication rounds), with the kernels' launch counts
   taken over that path's run alone (its kernel once per dtype buffer per
   step, every other kernel never) and a finite validation loss.

The line before the last is one JSON object describing each kernel, its
``launches`` summed over the paths; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time
from typing import Callable, NamedTuple

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

from repro_torch.api import Experiment, build  # noqa: E402
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels.storm import kernel as storm  # noqa: E402
from repro_torch.kernels.storm import ref as storm_ref  # noqa: E402
from repro_torch.optim.sequences import FlatState  # noqa: E402

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12            # H100 SXM, f32 outside the tensor cores
# path (committed spec) → the kernel its step launches once per dtype buffer
PATHS = {"fedbioacc": "storm3_step", "fedbio": "sgd3_step",
         "fedbio_local": "sgd3_step", "fedavg": "momsgd3_step"}
CLIENTS = 2
KERNEL_RUNS, PLAIN_RUNS = 30, 10


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def timed_ms(fn, runs: int) -> float:
    """Median milliseconds of ``fn()`` over ``runs`` calls, each between two
    CUDA events, after two warm-up calls."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(runs):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    view = torch.int16 if a.element_size() == 2 else torch.int32
    return a.dtype == b.dtype and torch.equal(a.view(view), b.view(view))


def full_width_experiment(exp: Experiment) -> Experiment:
    return exp.edit(**{"problem.reduced": False,
                       "problem.num_clients": CLIENTS,
                       "problem.per_client": 1, "problem.seq_len": 512,
                       "schedule.steps": 4})


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions at the main path's shapes
# ---------------------------------------------------------------------------

class Kernel(NamedTuple):
    wrapper: Callable
    plain: Callable
    n_in: int          # f32 input streams besides p
    n_tables: int      # per-tile f32 tables
    m_out: bool        # writes an f32 stream besides p'
    ops: int           # f32 operations per element
    replaces: str      # the TPU kernel
    path: str          # the path whose buffers it is held and timed at


KERNELS = {
    "storm3_step": Kernel(storm.storm3_step, storm_ref.storm3_step_ref,
                          2, 2, True, 4,
                          "src/repro/kernels/storm/kernel.py:153", "fedbioacc"),
    "storm3_update": Kernel(storm.storm3_update, storm_ref.storm3_update_ref,
                            3, 2, True, 5,
                            "src/repro/kernels/storm/kernel.py:127",
                            "fedbioacc"),
    "sgd3_step": Kernel(storm.sgd3_step, storm_ref.sgd3_step_ref,
                        1, 1, False, 2,
                        "src/repro/kernels/storm/kernel.py:206", "fedbio"),
    "momsgd3_step": Kernel(storm.momsgd3_step, storm_ref.momsgd3_step_ref,
                           2, 2, True, 4,
                           "src/repro/kernels/storm/kernel.py:228", "fedavg"),
}


def kernel_phase(groups_of: dict, dev) -> dict:
    """Per kernel: both buffers of one step of its path — the bitwise check,
    the measured kernel and plain times, and the bound from the bytes and
    operations these inputs need (each input read once, each output written
    once, from the kernel's own signature)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}
    for name, k in KERNELS.items():
        ms = plain_ms = bound_bytes = flops = 0.0
        max_err = 0.0
        for grp in groups_of[k.path]:
            n = CLIENTS * grp.padded
            tiles = n // grp.block
            p = torch.randn(n, generator=gen, device=dev).to(grp.dtype)
            streams = [torch.randn(n, generator=gen, device=dev)
                       for _ in range(k.n_in)]
            tables = [0.1 * torch.rand(tiles, generator=gen, device=dev)]
            tables += [torch.rand(tiles, generator=gen, device=dev)
                       for _ in range(k.n_tables - 1)]
            args = (p, *streams, *tables)
            out = k.wrapper(*args, block=grp.block)
            want = k.plain(*args, grp.block)
            torch.cuda.synchronize()
            out, want = ((o,) if torch.is_tensor(o) else o for o in (out, want))
            for o, w in zip(out, want):
                if not same_bits(o, w):
                    raise SystemExit(f"{name}: kernel differs from the plain "
                                     f"version on the {grp.dtype} buffer")
                max_err = max(max_err, float((o.float() - w.float()).abs().max()))
            del out, want
            k_ms = timed_ms(lambda: k.wrapper(*args, block=grp.block),
                            KERNEL_RUNS)
            p_ms = timed_ms(lambda: k.plain(*args, grp.block), PLAIN_RUNS)
            moved = (2 * n * p.element_size() + k.n_in * n * 4
                     + (n * 4 if k.m_out else 0) + k.n_tables * tiles * 4)
            bound = max(moved / HBM_BYTES_PER_S, k.ops * n / F32_FLOPS_PER_S) * 1e3
            log(f"{name} {str(grp.dtype).replace('torch.', '')} "
                f"[{CLIENTS}, {grp.padded}] ({k.path} path): bitwise equal, "
                f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, {moved} B, "
                f"bound {bound:.4f} ms ({moved / k_ms / 1e6:.1f} GB/s)")
            ms += k_ms
            plain_ms += p_ms
            bound_bytes += moved
            flops += k.ops * n
            del p, streams, tables, args
            torch.cuda.empty_cache()
        bytes_ms = bound_bytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / F32_FLOPS_PER_S * 1e3
        results[name] = {
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/storm3.cu",
            "replaces": k.replaces, "launches": 0, "max_abs_err": max_err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None}
    return results


# ---------------------------------------------------------------------------
# phases 4 and 5: the main path
# ---------------------------------------------------------------------------

def _to(state: FlatState, dev) -> FlatState:
    return FlatState(tuple(b.to(dev) for b in state.vars),
                     tuple(b.to(dev) for b in state.mom), state.step)


def cross_check(exp: Experiment, dev) -> None:
    """Two reduced steps on the card against two on the CPU."""
    name = exp.algorithm.name
    cpu_run = build(exp, device="cpu")
    gpu_run = build(exp, device=dev)
    cpu_state = cpu_run.init(torch.Generator().manual_seed(0))
    gpu_state = _to(cpu_state, dev)
    data = torch.Generator().manual_seed(1)
    for _ in range(2):
        batch = cpu_run.batch_fn(data)
        cpu_state, _ = cpu_run.step(cpu_state, batch)
        gpu_state, _ = gpu_run.step(
            gpu_state, {k: {kk: v.to(dev) for kk, v in b.items()}
                        for k, b in batch.items()})
    worst = 0.0
    for c, g in zip(cpu_state.vars + cpu_state.mom,
                    gpu_state.vars + gpu_state.mom):
        rel = float((g.cpu().float() - c.float()).norm() / c.float().norm())
        worst = max(worst, rel)
    log(f"reduced cross-check, {name}: card vs CPU after 2 steps, worst "
        f"relative buffer difference {worst:.3e} (limit 1e-4)")
    if not worst <= 1e-4:
        raise SystemExit(f"reduced cross-check of {name} failed")


def main_path(exp: Experiment, dev) -> dict:
    run = build(exp, device=dev)
    state = run.init(torch.Generator(device=dev).manual_seed(exp.schedule.seed))
    data = torch.Generator().manual_seed(exp.schedule.seed)
    batches = [run.batch_fn(data) for _ in range(exp.schedule.steps)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    storm.reset_counts()
    step_ms = []
    for batch in batches:
        t0 = time.perf_counter()
        state, _ = run.step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = dict(storm.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    val = run.eval_fn(state)
    name = exp.algorithm.name
    sizes = [f"{str(g.dtype).replace('torch.', '')}[{CLIENTS}, {g.padded}]"
             for g in run.init.spec.groups]
    log(f"path {name}: full-width {run.model_cfg.name}, buffers {sizes}, "
        f"steps {len(step_ms)}, step ms {[round(t, 3) for t in step_ms]}, "
        f"peak memory {peak} B, launches {launches}, val_loss {val}")
    want = dict.fromkeys(launches, 0)
    want[PATHS[name]] = exp.schedule.steps * len(run.init.spec.groups)
    if launches != want:
        raise SystemExit(f"path {name} launched {launches}, expected {want}")
    if not math.isfinite(val):
        raise SystemExit(f"non-finite validation loss {val} on path {name}")
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        raise SystemExit(1)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(card_line())

    t0 = time.perf_counter()
    libs = kbuild.build_all()
    log(f"built {sorted(libs)} for sm_90a in {time.perf_counter() - t0:.2f} s")
    for lib in libs.values():
        log_path = lib.with_suffix(".log")
        if log_path.is_file():
            log(log_path.read_text().strip())

    bases = {name: Experiment.load(os.path.join(ROOT, "experiments",
                                                f"{name}.json"))
             for name in PATHS}
    fulls = {name: full_width_experiment(b) for name, b in bases.items()}
    groups_of = {name: build(f, device=dev).init.spec.groups
                 for name, f in fulls.items()}
    kernels = kernel_phase(groups_of, dev)
    torch.cuda.empty_cache()

    for base in bases.values():
        cross_check(base, dev)
    for full in fulls.values():
        launches = main_path(full, dev)
        torch.cuda.empty_cache()
        for name, k in kernels.items():
            k["launches"] += launches[name]

    print(json.dumps({"kernels": list(kernels.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
