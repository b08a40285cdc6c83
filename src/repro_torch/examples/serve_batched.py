"""Batched serving on the port (counterpart of ``examples/serve_batched.py``):
prefill then greedy decode on the reduced hybrid model (RG-LRU recurrence
and sliding-window attention), 4 prompts of 48 tokens, 24 tokens each.

    PYTHONPATH=src python -m repro_torch.examples.serve_batched [--device cpu]

The device defaults to ``cuda``: there the prefill runs the flash-attention
and RG-LRU scan kernels, on the CPU their plain versions.
"""
from __future__ import annotations

import argparse

from repro_torch.launch import serve


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return serve.main(["--arch", "recurrentgemma-9b", "--reduced",
                       "--batch", "4", "--prompt-len", "48", "--gen", "24",
                       "--device", args.device])


if __name__ == "__main__":
    main()
