"""Where one full-width step of the PyTorch port's STORM kind spends its
time.

    python3 scripts/profile_torch_step.py [--experiment PATH]   # on a card

Builds the experiment (default ``experiments/fedbioacc.json``; any spec of
the STORM kind, such as ``fedbioacc_int8_topk.json``) at full Mamba-2-130M
width (bf16, 2 clients, 1 sequence of 512 tokens each — the configuration
``chip_smoke.py`` drives), takes one warm-up step, then:

1. times steps 1, 2 and 3 on the host clock (each ending in a
   synchronize), with the caching allocator's device allocations, frees
   and retries during each (``torch.cuda.memory_stats``; -1 where this
   PyTorch does not count them); the spec's ``local_steps`` of 2 makes
   steps 1 and 3 communicate;
2. times one client's three oracle directions (``hypergrad.fused_oracles``)
   at one iterate — a step evaluates them 2 clients × 2 iterates = 4 times;
3. profiles step 4 (which does not communicate) with ``torch.profiler``
   (CPU + CUDA): the summed device time of all kernels against the step's
   wall time (the device's busy share), the number of kernel launches, and
   the top operators by device time.

Prints the profiler table and a summary line.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.api import Experiment, build  # noqa: E402
from repro_torch.core import hypergrad as hg  # noqa: E402
from repro_torch.core.model_problem import make_model_bilevel  # noqa: E402
from repro_torch.core.tree_util import client_slice  # noqa: E402


ALLOC_KEYS = ("num_device_alloc", "num_device_free", "num_alloc_retries")


def _alloc_counts(dev) -> tuple:
    stats = torch.cuda.memory_stats(dev)
    return tuple(stats.get(k, -1) for k in ALLOC_KEYS)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--experiment",
                    default=os.path.join(ROOT, "experiments",
                                         "fedbioacc.json"))
    ns = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    exp = Experiment.load(ns.experiment)
    exp = exp.edit(**{"problem.reduced": False, "problem.num_clients": 2,
                      "problem.per_client": 1, "problem.seq_len": 512})
    run = build(exp, device=dev)
    state = run.init(torch.Generator(device=dev).manual_seed(0))
    data = torch.Generator().manual_seed(0)
    batches = [run.batch_fn(data) for _ in range(5)]

    state, _ = run.step(state, batches[0])          # warm-up
    torch.cuda.synchronize()
    steps = []
    for t in (1, 2, 3):
        before = _alloc_counts(dev)
        t0 = time.perf_counter()
        state, _ = run.step(state, batches[t])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        delta = [b - a if a >= 0 else -1
                 for a, b in zip(before, _alloc_counts(dev))]
        steps.append(ms)
        print(f"step {t}: {ms:.1f} ms, " + ", ".join(
            f"{k} {d}" for k, d in zip(ALLOC_KEYS, delta)), flush=True)
    step_ms = steps[0]

    f, g = make_model_bilevel(run.model, lower_l2=run.fed.lower_l2)
    views = run.views(state)
    x, y, u = (client_slice(t, 0) for t in (views.x, views.y, views.u))
    b0 = client_slice(batches[4], 0)
    hg.fused_oracles(g, f, x, y, u, b0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hg.fused_oracles(g, f, x, y, u, b0)
    torch.cuda.synchronize()
    oracle_ms = (time.perf_counter() - t0) * 1e3

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = run.step(state, batches[4])
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.device_time_total for e in kernels) / 1e3
    print(prof.key_averages().table(sort_by="device_time_total",
                                    row_limit=25), flush=True)
    print(f"{exp.algorithm.name}, compression {exp.compression}: step 1 "
          f"{step_ms:.1f} ms (host clock); one client's oracles at one "
          f"iterate {oracle_ms:.1f} ms (x4 per step = {4 * oracle_ms:.1f} ms, "
          f"{400 * oracle_ms / step_ms:.1f} % of the step); profiled step "
          f"{prof_ms:.1f} ms (step 4) with {len(kernels)} device activities summing "
          f"to {busy_ms:.1f} ms of device time (busy share "
          f"{100 * busy_ms / prof_ms:.1f} %)", flush=True)


if __name__ == "__main__":
    main()
