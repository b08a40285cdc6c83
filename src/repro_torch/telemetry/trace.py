"""Phase spans (counterpart of ``repro/telemetry/trace.py``).

Host-side phases (the evaluation, checkpoint writes) are wrapped in
:func:`phase`: a context manager that opens a
``torch.profiler.record_function`` range (so that the phase shows in a
``torch.profiler`` trace), on a run that has started CUDA also an NVTX
range (so that it shows in Nsight), and records the host wall-clock span
as a ``span`` event in the run's
:class:`~repro_torch.telemetry.events.EventLog`.  Device-side phases of
the engine (the oracles, the fused update, the reductions, the metric
passes) are marked with :func:`annotate`, a ``record_function`` range
alone: it names the operators and kernels launched inside it in a
profiler trace and never changes a number.
"""
from __future__ import annotations

import contextlib
import time

import torch


def annotate(name: str):
    """Device-phase marker for engine code: a ``record_function`` range
    named ``name`` (profiler attribution only; numerics untouched)."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def _nvtx(name: str):
    # only where CUDA is already up: a CPU run never creates a context
    if not torch.cuda.is_initialized():
        yield
        return
    torch.cuda.nvtx.range_push(name)
    try:
        yield
    finally:
        torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def phase(name: str, log=None, **fields):
    """Wall-clock and profiler span around a host-side phase; records a
    ``span`` event on ``log`` (ignored when ``log`` is None)."""
    with torch.profiler.record_function(name), _nvtx(name):
        t0 = time.perf_counter()  # analysis: ignore[L301] span timing
        try:
            yield
        finally:
            if log is not None:
                log.emit("span", name=name,
                         dur_s=round(time.perf_counter() - t0, 6), **fields)  # analysis: ignore[L301] span timing
