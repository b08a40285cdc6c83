"""``repro_torch.analysis`` — the static invariant verifier (counterpart of
``repro.analysis``).

Proves the engine's contracts on a spec in three passes, recording one
step at the spec's own size (the port has no abstract trace: its engine
decides rounds on the host and launches kernels through ``ctypes``):

1. **Collectives/wire** (``W1xx``): one step issues exactly the
   ``torch.distributed`` collectives the analytic comm plan implies (one
   sliced reduction per communicated merged run per reduction event, and
   the oracle's row gathers), private tiles never appear in a collective
   operand, and the communication-only subprogram moves byte-exact,
   dtype-exact traffic with zero resharding ops —
   ``repro_torch.analysis.collectives``.
2. **Structure** (``S2xx``): every optional feature off leaves zero state
   leaves and a step trace identical to the pre-feature factory build;
   events-only telemetry is trace-inert — ``repro_torch.analysis.structure``.
3. **Source lint** (``L3xx``): no wall-clock/global-RNG nondeterminism, no
   host sync in engine code, fold_in-pure round randomness, frozen spec
   dataclasses — ``repro_torch.analysis.lint``.

CLI::

    python -m repro_torch.analysis --experiment experiments/fedbioacc.json
    python -m repro_torch.analysis --all experiments/ --lint src/repro_torch

The rule registry (IDs, what each proves, fix-its) lives in
``repro_torch.analysis.rules``; lint findings can be waived per line with
``# analysis: ignore[L3xx]``.
"""
from repro_torch.analysis.rules import LINT_RULES, RULES, Finding, Rule

__all__ = ["RULES", "LINT_RULES", "Rule", "Finding"]
