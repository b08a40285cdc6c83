"""Continuous-batching serving on the port (counterpart of
``examples/serve_continuous_batching.py``): 6 staggered requests through 2
decode slots of a ``ServeEngine`` on the reduced granite-8b (f32).

Each request is prefilled into a free slot and decoded at its own position;
a finished request frees its slot at once.  The prompts are the
reference's (``repro_torch.random`` draws JAX's bits); the parameters come
from a ``torch.Generator`` seeded 0.

    PYTHONPATH=src python -m repro_torch.examples.serve_continuous_batching \\
        [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import random as jr
from repro_torch.api.build import resolve_device
from repro_torch.configs import ARCHS
from repro_torch.models.registry import build_model
from repro_torch.serving import ServeEngine

SLOTS, CACHE_LEN = 2, 64
BUDGETS = [6, 3, 9, 4, 7, 5]


def main(argv=None) -> dict:
    """Returns {request id: generated tokens}."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    dev = resolve_device(ap.parse_args(argv).device)
    cfg = ARCHS["granite-8b"].reduced()
    model = build_model(cfg, dtype=torch.float32)
    with torch.no_grad():
        params = model.init(torch.Generator(device=dev).manual_seed(0))
    engine = ServeEngine(model, params, max_slots=SLOTS, cache_len=CACHE_LEN)
    key = jr.PRNGKey(0)
    prompts = [jr.randint(jr.fold_in(key, i), (8 + 4 * i,), 0,
                          cfg.vocab_size) for i in range(len(BUDGETS))]
    t0 = time.perf_counter()  # analysis: ignore[L301] driver timing
    rids = [engine.submit(p, n) for p, n in zip(prompts, BUDGETS)]
    results = engine.run_to_completion()
    dt = time.perf_counter() - t0  # analysis: ignore[L301] driver timing
    total = sum(len(v) for v in results.values())
    print(f"served {len(results)} requests / {total} tokens through {SLOTS} "
          f"slots in {dt:.2f}s on {dev}")
    for rid in rids:
        print(f"  request {rid}: {results[rid]}")
    assert set(results) == set(rids)
    print("all requests completed at their own positions; "
          "tests/test_torch_serving.py holds the tokens to isolated decoding")
    return results


if __name__ == "__main__":
    main()
