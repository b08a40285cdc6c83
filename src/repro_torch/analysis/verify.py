"""Per-experiment orchestration of the three verifier passes (counterpart of
``repro/analysis/verify.py``).

``verify_experiment`` checks one Experiment: the collective/wire audit
(W1xx — sharded specs on their ``d·k`` ranks, plus a 2-rank mesh probe for
compressed unsharded specs so that their wire dtype and bytes are proven
too) and the state-slot and step-trace identity audits (S2xx).  Nothing
runs beyond the init and the one step (and communication subprogram) each
audit records, at the spec's own size.

A pass that needs ranks spawns them (``torch.multiprocessing`` spawn, a
gloo world over a ``FileStore`` in a temporary directory, as the train CLI
does); on the card every rank uses ``cuda:0``, whose kernels are built
once here before the ranks start.  Called inside a world of the right size
already (a test's ranks), the pass runs in that world instead.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.analysis.rules import Finding

#: the mesh of the wire probe for compressed UNSHARDED specs — 2 data
#: ranks is the smallest mesh whose reductions cross ranks
PROBE_MESH = (2, 1)

#: seconds a pass on ranks may take before its ranks are killed
RANKS_TIMEOUT = 900.0


def _located(findings: List[Finding], where: str) -> List[Finding]:
    return [f._replace(where=where) for f in findings]


def mesh_pass(exp, *, hlo: bool = True, device=None
              ) -> Tuple[List[Finding], List[str]]:
    """Pass 1 (W101–W105) and S201 of a mesh spec, in the process group
    that is set up (every rank calls it; each gets the same findings).
    Returns (findings, notes)."""
    from repro_torch.analysis import collectives as coll
    from repro_torch.analysis import structure as struct
    from repro_torch.api.build import build

    run = build(exp, device=device)
    before = struct.kernel_calls()
    findings = coll.audit_step_collectives(run)
    calls = {k: v - before[k] for k, v in struct.kernel_calls().items()
             if v != before[k]}
    notes: List[str] = []
    expected, info = coll.expected_step_collectives(run)
    n_ops = sum(expected.values())
    notes.append(f"step: {n_ops} collectives == plan "
                 f"({info['events']} events x {info['comm_elems']} "
                 f"elems/chunk + {sum(info['oracle_gathers'].values())} "
                 f"oracle gathers + {sum(info['telemetry'].values())} "
                 f"telemetry; kernel calls " + " ".join(
                     f"{k}={v}" for k, v in sorted(calls.items())) + ")"
                 if not findings else "step: FAIL")
    if hlo:
        f2 = coll.audit_wire(run)
        findings += f2
        if not f2:
            want = coll.expected_wire_bytes(coll.comm_expected(run),
                                            run.shard.data_size)
            notes.append("wire: " + " + ".join(
                f"{b} B {d}" for d, b in sorted(want.items())))
    findings += struct.audit_state_slots(run)
    return findings, notes


def _rank_pass(rank: int, world: int, store: str, exp_json: str, hlo: bool,
               device, out: str) -> None:
    """One rank of :func:`_on_ranks`: join the world, run
    :func:`mesh_pass`, and (rank 0) write its result to ``out``."""
    from repro_torch.api.spec import Experiment
    from repro_torch.launch.mesh import init_ranks

    init_ranks(rank, world, store)
    torch.set_num_threads(max(1, torch.get_num_threads() // world))
    findings, notes = mesh_pass(Experiment.from_json(exp_json), hlo=hlo,
                                device=device)
    if rank == 0:
        with open(out, "w") as fh:
            json.dump({"findings": [list(f) for f in findings],
                       "notes": notes}, fh)
    dist.barrier()
    dist.destroy_process_group()


def _on_ranks(exp, *, hlo: bool, device) -> Tuple[List[Finding], List[str]]:
    """:func:`mesh_pass` of ``exp`` on its mesh's ranks: in the world that
    is set up when it has their number, else in spawned ranks
    (``launch.mesh.spawn_ranks``, within :data:`RANKS_TIMEOUT`; any rank
    failing fails the pass)."""
    d, k = exp.execution.mesh
    world = d * k
    if dist.is_initialized() and dist.get_world_size() == world:
        return mesh_pass(exp, hlo=hlo, device=device)
    from repro_torch.api.build import resolve_device
    from repro_torch.launch.mesh import spawn_ranks
    if resolve_device(device).type == "cuda":
        from repro_torch.kernels.build import build_all
        build_all(("storm3", "quantpack"))
    tmp = tempfile.mkdtemp(prefix="repro_torch_analysis_")
    out = os.path.join(tmp, "result.json")
    try:
        rc = spawn_ranks(_rank_pass, world, os.path.join(tmp, "store"),
                         (exp.to_json(), hlo, device, out),
                         timeout=RANKS_TIMEOUT)
        if rc:
            raise RuntimeError(f"a rank of mesh ({d}, {k}) failed: exit "
                               f"code {rc}")
        with open(out) as fh:
            res = json.load(fh)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return [Finding(*f) for f in res["findings"]], res["notes"]


def verify_experiment(exp, *, where: str, hlo: bool = True,
                      bare_cache: Optional[Dict[str, Any]] = None,
                      device=None) -> Tuple[List[Finding], List[str]]:
    """(findings, notes) of one Experiment.  ``where`` labels findings
    (normally the spec path); ``hlo=False`` skips the communication
    subprogram's wire audit (step and structure checks only);
    ``bare_cache`` dedupes the S202 baseline across specs sharing a bare
    form; ``device`` is where the runs go (``cuda`` by default)."""
    from repro_torch.analysis import structure as struct
    from repro_torch.api.build import build, checked

    findings: List[Finding] = []
    notes: List[str] = []
    exp = checked(exp)
    if not exp.execution.fuse_storm:
        notes.append("unfused path: skipped (no flat substrate to audit)")
        return findings, notes

    # -- pass 1: collectives/wire (and S201 of the built run) ---------------
    if exp.execution.mesh is not None:
        f1, n1 = _on_ranks(exp, hlo=hlo, device=device)
        findings += _located(f1, where)
        notes += n1
    else:
        notes.append("no wire (unsharded)")
        findings += _located(struct.audit_state_slots(
            build(exp, device=device)), where)
        if exp.compression is not None:
            probe = exp.edit(**{"execution.mesh": PROBE_MESH})
            f1, n1 = _on_ranks(probe, hlo=hlo, device=device)
            f1 = [f for f in f1 if f.rule.startswith("W")]
            findings += _located(f1, f"{where} [mesh probe {PROBE_MESH}]")
            if not f1:
                notes.append(f"wire probe {PROBE_MESH}: " + (
                    n1[-1].removeprefix("wire: ") if hlo else n1[0]))

    # -- pass 2: structure --------------------------------------------------
    findings += _located(struct.audit_bare_jaxpr(exp, bare_cache,
                                                 device=device), where)
    findings += _located(struct.audit_telemetry_inert(exp, device=device),
                         where)
    if not any(f.rule.startswith("S") for f in findings):
        notes.append("state slots + bare/telemetry trace identity OK")
    return findings, notes
