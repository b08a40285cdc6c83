"""The kernels on fake tensors, and each kernel's work per launch.

A wrapper handed a fake tensor (``torch._subclasses.fake_tensor``) that
stands for a CUDA tensor returns fake outputs of its kernel's shapes and
dtypes: no
``nvcc``, no library load, no ``data_ptr()``, no launch.  ``CALLS`` counts
the call as for any call; ``LAUNCHES`` does not move.  The call's work goes
into :data:`TRACED` instead, so the dry run (``launch/dryrun.py``) adds the
kernels' bytes and operations to what ``FlopCounterMode`` counts of the
plain ATen ops.  Fake CPU tensors take the plain version, as real ones do,
except where a dry run's fakes lie on the CPU to stand for CUDA tensors
(:data:`STANDS_FOR`, without a card): wrappers dispatch by
:func:`device_type`.

Each kernel's ``work`` function (``storm.kernel.work``,
``storm.quantpack.work``, ``flash.ops.work``, ``lru.ops.work``) returns
the :class:`Work` of one launch: the bytes it must move (each input read
once, each output written once) and the operations it does, with the peak
rate they run at.  ``chip_smoke.py`` prices each kernel's bound with the
same functions.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

from torch._subclasses.fake_tensor import FakeTensor


class Work(NamedTuple):
    bytes: int
    flops: int
    rate: str = "f32"        # "f32" (CUDA cores) or "bf16_tc" (tensor cores)


#: the device type the fakes of an active dry run stand for where they
#: cannot carry it (set by ``launch.dryrun.TargetFake`` while it is
#: active without a card; None otherwise)
STANDS_FOR = None

#: kernel (or variant) name → [fake calls, bytes, operations] since the
#: last :func:`reset`
TRACED: Dict[str, list] = {}


def is_fake(*tensors) -> bool:
    return any(isinstance(t, FakeTensor) for t in tensors)


def device_type(t) -> str:
    """The device type a wrapper dispatches ``t`` by: a fake's dry-run
    target, else the tensor's own."""
    if STANDS_FOR is not None and isinstance(t, FakeTensor):
        return STANDS_FOR
    return t.device.type


def host_stand_in(t) -> bool:
    """Whether ``t`` is a real CPU tensor handed over beside fakes that
    stand for CUDA tensors: the host tables the engine moves to the
    buffers' device, which on the card gives a contiguous copy and here
    leaves the tensor as it is."""
    return STANDS_FOR == "cuda" and not isinstance(t, FakeTensor) \
        and t.device.type == "cpu"


def record(name: str, work: Work) -> None:
    """Count one fake call of kernel ``name`` and its work."""
    entry = TRACED.setdefault(name, [0, 0, 0])
    entry[0] += 1
    entry[1] += work.bytes
    entry[2] += work.flops


def reset() -> None:
    TRACED.clear()
