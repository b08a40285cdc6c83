"""End-to-end run: federated bilevel training of a reduced Mamba-2 LM
with FedBiOAcc and checkpoints, on the port (counterpart of
``examples/train_lm_federated.py``).

It wraps :func:`repro_torch.launch.train.main` with the reference's flags
(the unfused tree path, the reference's default), plus ``--device``.

    PYTHONPATH=src python -m repro_torch.examples.train_lm_federated \\
        [--steps 200] [--ckpt-dir DIR] [--device cuda|cpu]

Without ``--ckpt-dir`` the checkpoints go to a fresh temporary directory.
"""
from __future__ import annotations

import argparse
import tempfile

from repro_torch.launch import train


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_lm_ckpt_")
    history = train.main([
        "--arch", args.arch, "--reduced", "--algo", "fedbioacc",
        "--steps", str(args.steps), "--clients", "4", "--per-client", "2",
        "--seq", "128", "--ckpt-every", "100",
        "--ckpt-dir", ckpt_dir, "--log-every", "20",
        "--device", args.device,
    ])
    first, last = history[0]["val_loss"], history[-1]["val_loss"]
    print(f"val loss {first:.3f} -> {last:.3f} over {args.steps} steps "
          f"(checkpoints in {ckpt_dir})")
    assert last < first
    return history


if __name__ == "__main__":
    main()
