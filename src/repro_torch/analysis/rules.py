"""The rule registry of the static verifier (counterpart of
``repro/analysis/rules.py``).

Every check ``repro_torch.analysis`` performs carries a :class:`Rule`: a
stable ID (``W1xx`` wire/collective, ``S2xx`` structure/state, ``L3xx``
source lint), what passing it *proves* about the engine, and a fix-it
message.  The IDs and names are the reference's; the texts name the port's
machinery (the step trace, ``torch.distributed``, ``repro_torch.random``).
Findings reference rules by ID, and source code can waive a lint rule per
line with an inline ``# analysis: ignore[L3xx]`` comment (wire/structure
rules have no escape hatch — they are contracts of the built run, not of
style).
"""
from __future__ import annotations

from typing import NamedTuple


class Rule(NamedTuple):
    id: str
    name: str
    proves: str         # the invariant a clean pass establishes
    fixit: str          # what to do when the rule fires


class Finding(NamedTuple):
    """One violation: ``where`` is ``spec-path`` or ``file:line``."""
    rule: str
    where: str
    message: str

    def __str__(self) -> str:
        r = RULES[self.rule]
        return (f"{self.rule} {r.name} {self.where}: {self.message}\n"
                f"    fix: {r.fixit}")


_ALL = (
    Rule("W101", "collective-count",
         "one step issues exactly the torch.distributed collectives the "
         "analytic comm plan implies — one sliced reduction per "
         "communicated merged run per reduction event, plus the oracle's "
         "row gathers over the model axis (the paper's O(eps^-1) "
         "single-collective round)",
         "a reduction was added/dropped outside comm_buffers, or the "
         "expected-collective model in repro_torch.analysis.collectives no "
         "longer mirrors flat._client_mean_masked_sharded — update the "
         "one that changed"),
    Rule("W102", "private-on-wire",
         "no private/non-participant tile ever enters a collective operand "
         "(PRIVATE sections are bit-identical by construction)",
         "a collective operand's size matches a private section run — "
         "slice the reduction around the private extents "
         "(flat._section_runs) instead of communicating them"),
    Rule("W103", "wire-dtype",
         "a quantized policy moves its reduction bytes in the narrow dtype "
         "on the wire (no silent f32 fallback, a 4x comm regression)",
         "the collectives re-widened — check flat._wire_allreduce and the "
         "dtype it hands to torch.distributed"),
    Rule("W104", "wire-bytes",
         "the comm subprogram's collective bytes equal the analytic "
         "telemetry.comm byte model exactly (what `comm` events bill is "
         "what the wire moves)",
         "the byte model and the reduction disagree — reconcile "
         "telemetry.comm.comm_plan / federation.compression with the "
         "reduction in flat.py"),
    Rule("W105", "resharding",
         "no resharding collectives (all-to-all / send-recv / unplanned "
         "all-gather) sit inside the comm subprogram between oracle and "
         "fused update ('zero resharding ops')",
         "a layout change crept into the reduction path — keep the "
         "shard-major flat layout end to end (repro_torch.optim.flat "
         "docstring)"),
    Rule("S201", "state-slots",
         "FlatState optional slots (stale/retry/ef/deadline) are () "
         "exactly when their feature is off — pre-feature checkpoints keep "
         "their structure (the zero-leaf contract)",
         "a feature leaked a state leaf into feature-off builds — gate "
         "the slot on its knob in sequences.make_engine.init_state"),
    Rule("S202", "bare-jaxpr",
         "a spec with every optional layer off records the same step trace "
         "(ATen ops, operand dtypes and shapes, kernel calls) as the "
         "pre-feature factory build — feature-off is the LITERAL baseline "
         "path, not a near miss",
         "a default changed or a feature stopped switching off — diff the "
         "two traces (repro_torch.analysis.structure.jaxpr_diff) and gate "
         "the divergent op on its feature knob"),
    Rule("S203", "telemetry-inert",
         "events-only telemetry (metrics=[]) records the identical step "
         "trace as telemetry=None — observability never perturbs a "
         "trajectory",
         "a metrics computation escaped the `if not tel_groups` gate in "
         "sequences — keep telemetry reads off the step's path"),
    Rule("L301", "nondet-time",
         "engine source draws no wall-clock nondeterminism (time.time, "
         "perf_counter, datetime.now, os.urandom) — trajectories are a "
         "pure function of (spec, seed, step)",
         "compute it from the step counter, or justify driver-side "
         "timing with `# analysis: ignore[L301]` (observability only, "
         "never on a step's path)"),
    Rule("L302", "nondet-random",
         "no stdlib/NumPy/torch global-state RNG (random.*, np.random.*, "
         "torch.manual_seed, torch.randn without generator=) — all "
         "randomness flows through repro_torch.random keys or explicit "
         "torch.Generators derived from the spec seed",
         "use repro_torch.random with a key folded from the spec seed and "
         "the step/round counter, or pass an explicit generator="),
    Rule("L303", "host-sync",
         "engine code never synchronizes a device value to the host "
         "(.item(), float()/int() on torch values, np.asarray on tensors) "
         "— steps stay asynchronous on the card",
         "keep the value on the device (torch), or justify a host "
         "decision or reporting helper with `# analysis: ignore[L303]`"),
    Rule("L304", "prng-fold",
         "round randomness in the engine derives from fold_in on a "
         "spec-seed key — never a carried split chain or an ad-hoc key — "
         "so resume and rollback-retry are bit-exact",
         "replace repro_torch.random.split / ad-hoc PRNGKey with "
         "fold_in(PRNGKey(spec.seed), round_idx); init-time key fans may "
         "justify `# analysis: ignore[L304]`"),
    Rule("L305", "spec-frozen",
         "every *Spec/*Config dataclass is frozen — specs are hashable "
         "keys and cannot drift after build",
         "declare it @dataclass(frozen=True)"),
    Rule("L306", "mutable-default",
         "no mutable default argument values ([], {}, set()) — call-to-"
         "call aliasing cannot corrupt build state",
         "default to None (or a tuple) and materialize inside the "
         "function"),
)

RULES = {r.id: r for r in _ALL}
LINT_RULES = tuple(r.id for r in _ALL if r.id.startswith("L"))
