"""Batched serving entry point of the PyTorch port (counterpart of
``repro/launch/serve.py``): prefill a batch of prompts, then greedy-decode.

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch gemma2-2b --reduced --device cpu \\
        [--batch 4] [--prompt-len 64] [--gen 32] [--seed 0]

``--arch`` takes the reference's ten names; the audio encoder stops as the
reference's script stops it (no decode step).  A VLM's prompts take
``num_patches`` patch embeddings (``0.1·N(0, 1)`` in f32, as the
reference's script draws them) before their tokens: the caches hold them
too and decoding continues at ``num_patches + prompt_len``.
The device defaults to ``cuda``; without a card the run stops unless
``--device cpu`` is given.  Parameters are drawn from a ``torch.Generator``
seeded with ``--seed`` on the device, the prompts (and patches) from one on
the CPU.
The prefill always sets the reference ``prefill``'s ``use_flash`` and
``use_lru_kernel`` switches: the attention layers' prefill runs the
flash-attention kernel and the recurrent layers' scan the RG-LRU kernel (on
the CPU, their plain versions).  Prints the prefill time and the decode
time per step (host clock around work that ends in a device synchronise),
and stops with an error on non-finite logits.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.api.build import resolve_device
from repro_torch.api.spec import ARCH_NAMES
from repro_torch.configs import get_config
from repro_torch.models.registry import build_model


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=sorted(ARCH_NAMES), required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> dict:
    """Returns ``{"tokens": [B, gen] generated ids, "logits": the last
    decode step's [B, V] logits, "prefill_ms", "decode_ms_per_step"}``."""
    ns = _parser().parse_args(argv)
    cfg = get_config(ns.arch)
    if ns.reduced:
        cfg = cfg.reduced()
    if cfg.family == "audio":
        raise SystemExit("encoder-only architecture has no decode step")
    dev = resolve_device(ns.device)
    model = build_model(cfg, dtype=torch.float32 if ns.reduced
                        else torch.bfloat16)
    with torch.no_grad():
        params = model.init(torch.Generator(device=dev).manual_seed(ns.seed))
        B, S = ns.batch, ns.prompt_len
        host = torch.Generator().manual_seed(ns.seed)
        prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=host)
        batch = {"tokens": prompts.to(dev)}
        offset = 0
        if cfg.family == "vlm":
            batch["patches"] = (0.1 * torch.randn(
                (B, cfg.num_patches, cfg.frontend_dim),
                generator=host)).to(dev)
            offset = cfg.num_patches
        cache_len = offset + S + ns.gen

        _sync(dev)
        t0 = time.perf_counter()  # analysis: ignore[L301] driver timing
        last, caches = model.prefill(params, batch, cache_len=cache_len,
                                     use_flash=True, use_lru_kernel=True)
        _sync(dev)
        prefill_ms = (time.perf_counter() - t0) * 1e3  # analysis: ignore[L301] driver timing
        print(f"arch={cfg.name} device={dev} prefill {B}x{S} in "
              f"{prefill_ms:.3f} ms", flush=True)

        tok = torch.argmax(last, dim=-1)[:, None]
        out = [tok]
        logits = last
        t0 = time.perf_counter()  # analysis: ignore[L301] driver timing
        for i in range(ns.gen - 1):
            logits, caches = model.decode_step(params, caches, tok,
                                               offset + S + i)
            tok = torch.argmax(logits, dim=-1)[:, None]
            out.append(tok)
        _sync(dev)
        steps = max(ns.gen - 1, 0)
        dt = time.perf_counter() - t0  # analysis: ignore[L301] driver timing
        gen = torch.cat(out, dim=1)
    decode_ms = dt * 1e3 / max(steps, 1)
    print(f"decoded {steps} steps x {B} seqs in {dt * 1e3:.3f} ms "
          f"({decode_ms:.3f} ms per step, {steps * B / max(dt, 1e-9):.1f} "
          f"tok/s)", flush=True)
    print("sample token ids:", gen[0, :16].tolist(), flush=True)
    if not bool(torch.isfinite(logits).all()):
        raise SystemExit("non-finite logits")
    return {"tokens": gen, "logits": logits, "prefill_ms": prefill_ms,
            "decode_ms_per_step": decode_ms}


if __name__ == "__main__":
    main()
