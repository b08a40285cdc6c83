"""Drive the PyTorch port on one CUDA card and check it end to end.

    python3 chip_smoke.py

Run from the root of a checkout; takes no arguments and needs one card.
Phases, each of which stops the script with a non-zero exit on failure:

1. the card's name and power limit, as ``nvidia-smi`` reports them;
2. build every CUDA source of the port (one ``nvcc`` each, all at once);
3. every kernel against its plain PyTorch version at the shapes its path
   gives it (full-width Mamba-2-130M, 2 clients: a bf16 buffer and an f32
   buffer; the FedBiOAcc buffers for the STORM pair, FedBiO's for
   ``sgd3_step``, FedAvg's for ``momsgd3_step``, the f32 inputs of the
   compressed reductions of ``fedbioacc_int8_topk`` for ``quantpack`` and
   ``quantunpack``), bit for bit, with median times over CUDA events; then
   the times of the compressed path's top-k and of its whole compressed
   reduction at the bf16 buffer's shape;
4. a reduced-model cross-check of each path: two steps on the card against
   two on the CPU from the same initial state and batches (within 1e-4 of
   each buffer's norm: reduction orders differ between the two devices).
   The compressed path's top-k and int8 rounding are discontinuous, so
   there every entry that one device kept or rounded otherwise than the
   other must lie near its threshold or half-way point
   (``repro_torch.testing``: ``topk_flips``, ``int8_flips``), and the
   1e-4 holds off the entries and columns those flips reach, the error
   feedback included;
5. the paths: ``experiments/fedbioacc.json``, ``fedbio.json``,
   ``fedbio_local.json``, ``fedavg.json`` and ``fedbioacc_int8_topk.json``,
   each at full Mamba-2-130M width (bf16, 2 clients, 1 sequence of 512
   tokens each — two SSD chunks), four steps (two communication rounds),
   with the kernels' launch counts taken over that path's run alone (as
   ``PATHS`` lists them, every other kernel never) and a finite validation
   loss.

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

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

from repro_torch.api import Experiment, build  # noqa: E402
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels.storm import kernel as storm  # noqa: E402
from repro_torch.kernels.storm import quantpack as qp  # noqa: E402
from repro_torch.kernels.storm import ref as storm_ref  # noqa: E402
from repro_torch.optim import flat  # noqa: E402
from repro_torch.optim.sequences import FlatState  # noqa: E402
from repro_torch.testing import int8_flips, topk_flips  # noqa: E402

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12            # H100 SXM, f32 outside the tensor cores
# path (committed spec) → what its four full-width steps launch over its two
# dtype buffers: the update kernel once per buffer per step; the compressed
# path also packs and unpacks the variables and the momenta of each buffer
# at both communication steps
PATHS = {"fedbioacc": {"storm3_step": 8}, "fedbio": {"sgd3_step": 8},
         "fedbio_local": {"sgd3_step": 8}, "fedavg": {"momsgd3_step": 8},
         "fedbioacc_int8_topk": {"storm3_step": 8, "quantpack": 8,
                                 "quantunpack": 8}}
COMPRESSED = "fedbioacc_int8_topk"
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
    view = {1: torch.int8, 2: torch.int16, 4: torch.int32,
            8: torch.int64}[a.element_size()]
    return a.dtype == b.dtype and torch.equal(a.view(view), b.view(view))


def reset_counts() -> None:
    storm.reset_counts()
    qp.reset_counts()


def launch_counts() -> dict:
    return {**storm.LAUNCHES, **qp.LAUNCHES}


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
    inputs: Callable   # (n, tiles, grp, gen, dev) -> the call's tensors
    ops: int           # f32 operations per element
    replaces: str      # the TPU kernel
    path: str          # the path whose buffers it is held and timed at
    source: str = "src/repro_torch/kernels/csrc/storm3.cu"
    # one PyTorch call that computes the same function (called as ``plain``
    # is), or None and the reason there is none
    library: Callable | None = None
    no_library: str = "no single PyTorch call applies per-tile tables"


def _update_inputs(n_in: int, n_tables: int):
    """p in the buffer's dtype, ``n_in`` f32 streams, per-tile tables."""
    def make(n, tiles, grp, gen, dev):
        p = torch.randn(n, generator=gen, device=dev).to(grp.dtype)
        streams = [torch.randn(n, generator=gen, device=dev)
                   for _ in range(n_in)]
        tables = [0.1 * torch.rand(tiles, generator=gen, device=dev)]
        tables += [torch.rand(tiles, generator=gen, device=dev)
                   for _ in range(n_tables - 1)]
        return (p, *streams, *tables)
    return make


def _pack_inputs(n, tiles, grp, gen, dev):
    """The f32 send of a compressed run (what the path packs)."""
    return (torch.randn(n, generator=gen, device=dev),)


def _unpack_inputs(n, tiles, grp, gen, dev):
    return storm_ref.quantpack_ref(
        torch.randn(n, generator=gen, device=dev), grp.block)


KERNELS = {
    "storm3_step": Kernel(storm.storm3_step, storm_ref.storm3_step_ref,
                          _update_inputs(2, 2), 4,
                          "src/repro/kernels/storm/kernel.py:153", "fedbioacc"),
    "storm3_update": Kernel(storm.storm3_update, storm_ref.storm3_update_ref,
                            _update_inputs(3, 2), 5,
                            "src/repro/kernels/storm/kernel.py:127",
                            "fedbioacc"),
    "sgd3_step": Kernel(storm.sgd3_step, storm_ref.sgd3_step_ref,
                        _update_inputs(1, 1), 2,
                        "src/repro/kernels/storm/kernel.py:206", "fedbio"),
    "momsgd3_step": Kernel(storm.momsgd3_step, storm_ref.momsgd3_step_ref,
                           _update_inputs(2, 2), 4,
                           "src/repro/kernels/storm/kernel.py:228", "fedavg"),
    "quantpack": Kernel(
        qp.quantpack_flat, storm_ref.quantpack_ref, _pack_inputs, 6,
        "src/repro/kernels/storm/quantpack.py:50", COMPRESSED,
        "src/repro_torch/kernels/csrc/quantpack.cu",
        no_library="no single PyTorch call takes per-tile absmax scales and "
        "quantizes"),
    "quantunpack": Kernel(
        qp.quantunpack_flat, storm_ref.quantunpack_ref, _unpack_inputs, 1,
        "src/repro/kernels/storm/quantpack.py:68", COMPRESSED,
        "src/repro_torch/kernels/csrc/quantpack.cu",
        library=lambda q, s, block: torch.mul(q.view(-1, block),
                                              s.view(-1, 1))),
}


def kernel_phase(groups_of: dict, dev) -> dict:
    """Per kernel: both buffers of one step of its path — the bitwise check,
    the measured kernel and plain times, and the bound from the bytes and
    operations these inputs need (each input read once, each output written
    once: the nbytes of the call's own tensors); where one PyTorch call
    computes the same function, its time too, after checking that it
    agrees bit for bit."""
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}
    for name, k in KERNELS.items():
        ms = plain_ms = lib_ms = bound_bytes = flops = 0.0
        max_err = 0.0
        for grp in groups_of[k.path]:
            n = CLIENTS * grp.padded
            tiles = n // grp.block
            args = k.inputs(n, tiles, grp, gen, dev)
            out = k.wrapper(*args, block=grp.block)
            want = k.plain(*args, grp.block)
            torch.cuda.synchronize()
            out, want = ((o,) if torch.is_tensor(o) else o for o in (out, want))
            for o, w in zip(out, want):
                if not same_bits(o, w):
                    raise SystemExit(f"{name}: kernel differs from the plain "
                                     f"version on the {grp.dtype} buffer")
                max_err = max(max_err, float((o.double() - w.double())
                                             .abs().max()))
            moved = sum(t.numel() * t.element_size() for t in (*args, *out))
            del out, want
            k_ms = timed_ms(lambda: k.wrapper(*args, block=grp.block),
                            KERNEL_RUNS)
            p_ms = timed_ms(lambda: k.plain(*args, grp.block), PLAIN_RUNS)
            lib = ""
            if k.library is not None:
                if not same_bits(k.library(*args, grp.block).reshape(-1),
                                 k.wrapper(*args, block=grp.block)):
                    raise SystemExit(f"{name}: the library call differs "
                                     f"from the kernel")
                l_ms = timed_ms(lambda: k.library(*args, grp.block),
                                KERNEL_RUNS)
                lib_ms += l_ms
                lib = f", library {l_ms:.4f} ms (bitwise equal)"
            bound = max(moved / HBM_BYTES_PER_S, k.ops * n / F32_FLOPS_PER_S) * 1e3
            log(f"{name} {str(grp.dtype).replace('torch.', '')} group "
                f"[{CLIENTS}, {grp.padded}] ({k.path} path): bitwise equal, "
                f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms{lib}, {moved} B, "
                f"bound {bound:.4f} ms ({moved / k_ms / 1e6:.1f} GB/s)")
            ms += k_ms
            plain_ms += p_ms
            bound_bytes += moved
            flops += k.ops * n
            del args
            torch.cuda.empty_cache()
        bytes_ms = bound_bytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / F32_FLOPS_PER_S * 1e3
        if k.library is None:
            log(f"{name}: library none: {k.no_library}")
        results[name] = {
            "name": name, "route": "cuda", "source": k.source,
            "replaces": k.replaces, "launches": 0, "max_abs_err": max_err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None if k.library is None else lib_ms}
    return results


def compression_phase(groups, dev) -> None:
    """The times of the compressed path's top-k and of its whole
    compressed reduction (top-k, pack, unpack, the client mean and the
    error feedback), on one run spanning the bf16 buffer's f32 send at its
    full shape."""
    grp = groups[0]
    cfg = flat.CompressCfg(quant="int8", topk_frac=0.1)
    gen = torch.Generator(device=dev).manual_seed(1)
    seg = torch.randn(CLIENTS, grp.padded, generator=gen, device=dev)
    eseg = 0.01 * torch.randn(CLIENTS, grp.padded, generator=gen, device=dev)
    topk_ms = timed_ms(lambda: flat._topk_tiles(seg, grp.block, 0.1), 3)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    mean_ms = timed_ms(
        lambda: flat._compressed_mean(seg, eseg, cfg, grp.block), 3)
    extra = torch.cuda.max_memory_allocated(dev) - base
    log(f"compressed reduction, f32 send [{CLIENTS}, {grp.padded}] with "
        f"error feedback, int8 + top-k 10 %: top-k {topk_ms:.4f} ms, whole "
        f"reduction {mean_ms:.4f} ms, its transient memory {extra} B")
    del seg, eseg
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases 4 and 5: the main path
# ---------------------------------------------------------------------------

def _to(state: FlatState, dev) -> FlatState:
    return FlatState(tuple(b.to(dev) for b in state.vars),
                     tuple(b.to(dev) for b in state.mom), state.step,
                     tuple(tuple(b.to(dev) for b in side)
                           for side in state.ef))


def _recording(topk, calls: list):
    """``topk`` (``flat._topk_tiles``) that also records its input and
    output as f32 numpy arrays on the host."""
    def wrapped(x, block, frac):
        y = topk(x, block, frac)
        calls.append((x.cpu().numpy(), y.cpu().numpy()))
        return y
    return wrapped


def _rel_outside(g: torch.Tensor, c: torch.Tensor, mask) -> float:
    keep = torch.from_numpy(~mask)
    g, c = g.cpu().float()[keep], c.float()[keep]
    return float((g - c).norm() / c.norm())


def cross_check(name: str, exp: Experiment, dev) -> None:
    """Two reduced steps on the card against two on the CPU."""
    cpu_run = build(exp, device="cpu")
    gpu_run = build(exp, device=dev)
    cpu_state = cpu_run.init(torch.Generator().manual_seed(0))
    gpu_state = _to(cpu_state, dev)
    data = torch.Generator().manual_seed(1)
    calls = {"cpu": [], "gpu": []}
    cp = exp.compression
    topk = flat._topk_tiles
    for _ in range(2):
        batch = cpu_run.batch_fn(data)
        try:
            flat._topk_tiles = _recording(topk, calls["cpu"])
            cpu_state, _ = cpu_run.step(cpu_state, batch)
            flat._topk_tiles = _recording(topk, calls["gpu"])
            gpu_state, _ = gpu_run.step(
                gpu_state, {k: {kk: v.to(dev) for kk, v in b.items()}
                            for k, b in batch.items()})
        finally:
            flat._topk_tiles = topk
    pairs = [(g, c, None) for g, c in zip(gpu_state.vars + gpu_state.mom,
                                          cpu_state.vars + cpu_state.mom)]
    flipped = []
    if cp is not None and cp.topk_frac > 0:
        # one round over one f32 buffer: the variables, then the momenta
        if len(cpu_run.init.spec.groups) != 1 or \
                not len(calls["cpu"]) == len(calls["gpu"]) == 2:
            raise SystemExit(f"cross-check of {name}: expected the 2 "
                             f"compressed reductions of one buffer")
        pairs = []
        block = cpu_run.init.spec.groups[0].block
        sides = zip(calls["cpu"], calls["gpu"],
                    (cpu_state.vars, cpu_state.mom),
                    (gpu_state.vars, gpu_state.mom),
                    cpu_state.ef or ((), ()), gpu_state.ef or ((), ()))
        for (c_in, c_out), (g_in, g_out), cb, gb, ce, ge in sides:
            flips = topk_flips(c_in, c_out, g_in, g_out, block, cp.topk_frac)
            if cp.quant == "int8":
                flips |= int8_flips(c_out, g_out, block)
            flipped.append(int(flips.sum()))
            cols = np.broadcast_to(flips.any(axis=0), flips.shape)
            pairs += [(g, c, cols) for g, c in zip(gb, cb)]
            pairs += [(g, c, flips) for g, c in zip(ge, ce)]
    worst = 0.0
    for g, c, mask in pairs:
        if mask is None:
            rel = float((g.cpu().float() - c.float()).norm()
                        / c.float().norm())
        else:
            rel = _rel_outside(g, c, mask)
        worst = max(worst, rel)
    what = "" if not flipped else (
        f", off the {flipped} entries (variables, momenta) that top-k or "
        f"int8 rounding decided otherwise, each within its bound of the "
        f"threshold or half-way point, error feedback included")
    log(f"reduced cross-check, {name}: card vs CPU after 2 steps, worst "
        f"relative buffer difference {worst:.3e} (limit 1e-4){what}")
    if not worst <= 1e-4:
        raise SystemExit(f"reduced cross-check of {name} failed")


def main_path(name: str, exp: Experiment, dev) -> dict:
    run = build(exp, device=dev)
    state = run.init(torch.Generator(device=dev).manual_seed(exp.schedule.seed))
    data = torch.Generator().manual_seed(exp.schedule.seed)
    batches = [run.batch_fn(data) for _ in range(exp.schedule.steps)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    step_ms = []
    for batch in batches:
        t0 = time.perf_counter()
        state, _ = run.step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    val = run.eval_fn(state)
    sizes = [f"{str(g.dtype).replace('torch.', '')}[{CLIENTS}, {g.padded}]"
             for g in run.init.spec.groups]
    log(f"path {name}: full-width {run.model_cfg.name}, buffers {sizes}, "
        f"steps {len(step_ms)}, step ms {[round(t, 3) for t in step_ms]}, "
        f"peak memory {peak} B, launches {launches}, val_loss {val}")
    want = {**dict.fromkeys(launches, 0), **PATHS[name]}
    if len(run.init.spec.groups) != 2 or exp.schedule.steps != 4:
        raise SystemExit(f"path {name}: PATHS counts launches for 4 steps "
                         f"over 2 buffers")
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
    compression_phase(groups_of[COMPRESSED], dev)
    torch.cuda.empty_cache()

    for name, base in bases.items():
        cross_check(name, base, dev)
    for name, full in fulls.items():
        launches = main_path(name, full, dev)
        torch.cuda.empty_cache()
        for kname, k in kernels.items():
            k["launches"] += launches[kname]

    print(json.dumps({"kernels": list(kernels.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
