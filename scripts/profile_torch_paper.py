"""Where a round of the paper's data-cleaning problem at MNIST's shape
spends its time on the card.

    python3 scripts/profile_torch_paper.py      # on a card

Builds ``data_cleaning_problem`` at MNIST's shape (60,000 training samples
of 784 features, 10 classes, 1,000 validation samples a client, 40 %
corrupted; synthetic, from seed 1) over 10 clients on the card, and
FedBiOAcc with the examples' step sizes, 4 local steps and ``fuse_storm``
(one ``storm3_step`` launch a local step), as ``chip_smoke.py`` phase 9
runs it.  After a warm-up round:

1. times 3 rounds on the host clock (each ending in a synchronize) with the
   round keys on the card (every draw a kernel launch) and 3 with them on
   the host (the Threefry hash in numpy, the index draws copied over; as
   the examples run); the draws are the same;
2. times the parts of a local step: one ``sample_batches`` call on each
   side (a step makes 5: ``fuse_oracles`` is off, as in the examples) and
   the three oracle directions over the 10 clients (a step evaluates them
   at 2 iterates);
3. profiles one round, keys on the host, with ``torch.profiler`` (CPU +
   CUDA): the summed device time of its kernels against the round's wall
   time (the device's busy share), the number of device activities, and
   the top operators by device time and by host time.

Prints the tables and a summary line.
"""
from __future__ import annotations

import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402
from torch.func import vmap  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import random as jr  # noqa: E402
from repro_torch.config import FederatedConfig  # noqa: E402
from repro_torch.core import hypergrad as hg  # noqa: E402
from repro_torch.core import make_algorithm  # noqa: E402
from repro_torch.core.problems import data_cleaning_problem  # noqa: E402

MNIST = dict(num_clients=10, n_train=60_000, n_val=1_000, dim=784,
             classes=10, corrupt_frac=0.4, batch_size=256)


def _ms(fn, runs: int = 3) -> list:
    out = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    prob = data_cleaning_problem(jr.PRNGKey(1, device=dev), **MNIST)
    cfg = FederatedConfig(algorithm="fedbioacc", num_clients=10,
                          local_steps=4, lr_x=0.3, lr_y=0.3, lr_u=0.3,
                          fuse_storm=True)
    alg = make_algorithm(prob, cfg)
    state = alg.init(jr.PRNGKey(0, device=dev))
    state, _ = alg.round(state, jr.PRNGKey(2, device=dev))     # warm-up

    rounds = {}
    for where, kdev in (("card", dev), ("host", torch.device("cpu"))):
        key = jr.PRNGKey(3, device=kdev)

        def one():
            nonlocal state, key
            key, sub = jr.split(key)
            state, _ = alg.round(state, sub)

        rounds[where] = _ms(one)
        sample = _ms(lambda: prob.sample_batches(jr.PRNGKey(4, device=kdev)),
                     10)
        print(f"keys on the {where}: rounds "
              f"{[round(t, 2) for t in rounds[where]]} ms; one "
              f"sample_batches {statistics.median(sample):.3f} ms", flush=True)

    f, g = prob.f, prob.g

    def directions(x, y, u, batches):
        by, bf1, bg1, bf2, bg2 = batches
        return (hg.grad_y(g, x, y, by),
                hg.nu_direction(g, f, x, y, u, bg1, bf1),
                hg.u_residual(g, f, x, y, u, bg2, bf2))

    batches = tuple(prob.sample_batches(k)
                    for k in jr.split(jr.PRNGKey(5, device=dev), 5))
    oracle = _ms(lambda: vmap(directions)(state.x, state.y, state.u, batches),
                 10)
    print(f"the three oracle directions over 10 clients: "
          f"{statistics.median(oracle):.3f} ms (x2 a local step)", flush=True)

    key = jr.PRNGKey(6)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = alg.round(state, key)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time_total for e in kernels) / 1e3
    table = prof.key_averages()
    print(table.table(sort_by="self_device_time_total", row_limit=15),
          flush=True)
    print(table.table(sort_by="self_cpu_time_total", row_limit=15),
          flush=True)
    print(f"data_cleaning fedbioacc at MNIST's shape, 10 clients, 4 local "
          f"steps, fuse_storm: round {statistics.median(rounds['card']):.2f} "
          f"ms with keys on the card, "
          f"{statistics.median(rounds['host']):.2f} ms on the host; "
          f"profiled round (keys on the host) {wall:.2f} ms with {len(kernels)} device "
          f"activities summing to {busy:.2f} ms (busy share "
          f"{100 * busy / wall:.2f} %)", flush=True)


if __name__ == "__main__":
    main()
