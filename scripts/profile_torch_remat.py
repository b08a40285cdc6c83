"""What rematerialisation costs and saves on one full-width training step.

    python3 scripts/profile_torch_remat.py [--layers N] [--per-client B]

Runs ``chip_smoke.micro_remat_path`` on the card at ``N`` of Mamba-2-130M's
24 layers (published widths otherwise, bf16, 2 clients): two steps of
``experiments/fedbioacc.json`` with ``n_micro`` 2 over ``B`` sequences of
512 tokens a client, with ``execution.remat`` and without, from the same
state and batches.  Prints each run's step times (CUDA events) and peak
memory, and fails unless the two runs' buffers agree bit for bit.
"""
from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=24)
    ap.add_argument("--per-client", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_remat: no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    chip_smoke.log(chip_smoke.card_line())
    chip_smoke.kbuild.build_all()
    chip_smoke.MICRO_EDITS["problem.per_client"] = args.per_client
    chip_smoke.MAIN_LAYERS = args.layers
    with chip_smoke._depth(args.layers):
        chip_smoke.micro_remat_path(torch.device("cuda", 0))


if __name__ == "__main__":
    main()
