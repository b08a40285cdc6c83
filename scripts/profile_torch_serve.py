"""Where full-width serving spends its time in the PyTorch port.

    python3 scripts/profile_torch_serve.py    # on a card
    python3 scripts/profile_torch_serve.py --arch granite-8b --batch 4 \
        --prompt-len 2047

Builds the model at full width (bf16, params drawn on the card from seed 0;
by default RecurrentGemma-9B with the configuration ``chip_smoke.py``
serves it: batch 2, prompt 4096, 16 generated tokens, ``use_flash`` and
``use_lru_kernel`` on), then:

1. times three prefills on the host clock (each ending in a synchronize):
   the first is cold (first use of each operator and matmul shape);
2. times each of the 15 greedy decode steps that follow the last prefill;
3. profiles one more prefill and three decode steps with
   ``torch.profiler`` (CPU + CUDA): the summed device time of all kernels
   against the wall time (the device's busy share), the number of kernel
   launches, the two hand-written kernels' share of the prefill's device
   time, and the top operators by their own device time.

Prints the profiler tables and a summary line per phase.
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

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402

# the model kernels' entry points: the attention (flash_fwd, flash_fwd_tc)
# and the scan (tma_ring_scan; rg_lru_scan where C % 4 != 0)
KERNELS = {"flash-attention": ("flash_fwd",),
           "LRU-scan": ("tma_ring_scan", "rg_lru_scan")}


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _summary(prof, wall_ms: float, what: str) -> None:
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.device_time_total for e in events) / 1e3
    mine = {what: sum(e.device_time_total for e in events
                      if any(k in e.name for k in names)) / 1e3
            for what, names in KERNELS.items()}
    # by each operator's own device time: an aten operator's total also
    # holds CUPTI's "Command Buffer Full" records (the host blocked on a
    # full launch queue), which are no device work and are not in busy_ms
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=20), flush=True)
    print(f"{what}: wall {wall_ms:.3f} ms, {len(events)} device activities "
          f"summing to {busy_ms:.3f} ms (busy {100 * busy_ms / wall_ms:.1f} "
          f"%), of which " + ", ".join(
              f"the {k} kernels {ms:.3f} ms "
              f"({100 * ms / max(busy_ms, 1e-9):.1f} %)"
              for k, ms in mine.items()), flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="recurrentgemma-9b")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=4096)
    ap.add_argument("--gen", type=int, default=16)
    ns = ap.parse_args(argv)
    B, S, GEN = ns.batch, ns.prompt_len, ns.gen
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    cfg = get_config(ns.arch)
    model = build_model(cfg, dtype=torch.bfloat16)
    flags = dict(use_flash=True, use_lru_kernel=True)
    with torch.no_grad():
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        tokens = torch.randint(0, cfg.vocab_size, (B, S),
                               generator=torch.Generator().manual_seed(0))
        batch = {"tokens": tokens.to(dev)}

        def prefill():
            return model.prefill(params, batch, cache_len=S + GEN, **flags)

        prefill_ms = []
        for _ in range(3):
            (last, caches), ms = _timed(prefill)
            prefill_ms.append(round(ms, 3))
        print(f"{ns.arch} prefill {B}x{S}: {prefill_ms} ms (the first cold)",
              flush=True)

        tok = torch.argmax(last, dim=-1)[:, None]
        step_ms = []
        for i in range(GEN - 1):
            (logits, caches), ms = _timed(
                lambda: model.decode_step(params, caches, tok, S + i))
            tok = torch.argmax(logits, dim=-1)[:, None]
            step_ms.append(round(ms, 3))
        print(f"decode steps: {step_ms} ms", flush=True)

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, ms = _timed(prefill)
        _summary(prof, ms, "profiled prefill")

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(3):
                logits, caches = model.decode_step(params, caches, tok,
                                                   S + GEN - 1 + i)
                tok = torch.argmax(logits, dim=-1)[:, None]
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        _summary(prof, ms, "profiled 3 decode steps")


if __name__ == "__main__":
    main()
