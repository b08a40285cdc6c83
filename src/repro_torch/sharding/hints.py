"""Intra-model sharding hints (counterpart of ``repro/sharding/hints.py``).

The reference's launchers switch hint mode on around a decode step so that
its attention intermediates carry ``with_sharding_constraint``
annotations for GSPMD.  The port has no GSPMD: it keeps the switch (the
dry run's decode runs inside :func:`sharding_hints`, and :func:`active`
reads it), and :func:`hint` returns its input unchanged.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager

_STATE = threading.local()


@contextmanager
def sharding_hints(enabled: bool = True):
    prev = getattr(_STATE, "on", False)
    _STATE.on = enabled
    try:
        yield
    finally:
        _STATE.on = prev


def active() -> bool:
    return getattr(_STATE, "on", False)


def hint(x, *spec):
    """``x`` itself, in hint mode or not: a placement constraint has no
    meaning without a compiler that partitions the program."""
    return x
