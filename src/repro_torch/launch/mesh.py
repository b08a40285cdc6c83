"""Meshes of ``torch.distributed`` ranks (counterpart of
``repro/launch/mesh.py``).

The port's mesh is a ``[data, model]`` grid over a world of ``d·k`` ranks
that is already set up (``torch.distributed.init_process_group``): rank
``i·k + j`` holds client block ``i`` and column chunk ``j`` of the flat
substrate, the reference's row-major ``np.asarray(devices).reshape(d, k)``
order.  Each rank carries the subgroup of its model column (the data axis:
the ranks that average the same columns) and of its data row (the model
axis: the ranks that hold the same clients' rows), and, built on first use
by every rank in the same order, the pods of the hierarchical schedule
along the data axis.

One H100 holds one NCCL rank, so the ranks of a mesh on one card share
``cuda:0`` and talk through gloo, which takes CUDA tensors (it copies them
through the host).  :func:`init_ranks` sets up such a world from a
``FileStore``; :func:`spawn_ranks` starts one from outside a process group.
"""
from __future__ import annotations

import multiprocessing.connection
import os
import time
import warnings

import torch.distributed as dist
import torch.multiprocessing as mp

class Mesh:
    """A ``[data, model]`` grid of the world's ranks: ``shape`` (axis →
    size), ``coords`` (axis → this rank's index), ``group(axis)`` (this
    rank's subgroup along ``axis``) and ``pod_group(n)`` (this rank's pod
    of ``n`` contiguous groups along the data axis)."""

    def __init__(self, data: int, model: int):
        world = dist.get_world_size()
        if world != data * model:
            raise RuntimeError(
                f"mesh ({data}, {model}) needs {data * model} ranks, the "
                f"process group has {world}")
        rank = dist.get_rank()
        self.shape = {"data": data, "model": model}
        self.coords = {"data": rank // model, "model": rank % model}
        self.rank = rank
        i, j = self.coords["data"], self.coords["model"]
        # every rank creates every subgroup, in the same order
        cols = [dist.new_group([r * model + c for r in range(data)])
                for c in range(model)]
        rows = [dist.new_group([r * model + c for c in range(model)])
                for r in range(data)]
        self._groups = {"data": cols[j], "model": rows[i]}
        self._pods: dict = {}

    def group(self, axis: str):
        return self._groups[axis]

    def axes_of(self, group) -> tuple:
        """``(axes, grouped)`` of a group this rank holds, as a collective
        names its axis: its model column ``(("data",), False)``, its data
        row ``(("model",), False)``, a pod ``(("data",), True)``; any other
        group (``None``: the world) spans ``("data", "model")``."""
        if group is self._groups["data"]:
            return ("data",), False
        if group is self._groups["model"]:
            return ("model",), False
        if any(group is g for g in self._pods.values()):
            return ("data",), True
        return ("data", "model"), False

    def pod_group(self, num_groups: int):
        """This rank's pod: the ranks of its model column whose data index
        falls in the same one of ``num_groups`` contiguous groups.  Built
        on the first call, which every rank of the world makes (the
        engine's reductions run in the same order on every rank)."""
        if num_groups not in self._pods:
            d, k = self.shape["data"], self.shape["model"]
            if num_groups < 1 or d % num_groups:
                raise ValueError(f"{num_groups} pods do not divide the mesh "
                                 f"data axis size {d}")
            per = d // num_groups
            for col in range(k):
                for g in range(num_groups):
                    ranks = [r * k + col for r in range(g * per,
                                                        (g + 1) * per)]
                    pg = dist.new_group(ranks)
                    if self.rank in ranks:
                        self._pods[num_groups] = pg
        return self._pods[num_groups]


def init_ranks(rank: int, world: int, store_path: str) -> None:
    """Join a gloo world of ``world`` ranks through a ``FileStore`` at
    ``store_path`` (the ranks share a file system and talk over the
    loopback interface)."""
    # all_gather_into_tensor, which torch 2.11 has and its successor not
    warnings.filterwarnings("ignore", message=".*all_gather_into_tensor",
                            category=FutureWarning)
    # the ranks share one host: gloo talks over the loopback interface
    # (without it, gloo resolves the host's name to pick one)
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)


def spawn_ranks(target, world: int, store: str, args: tuple = (), *,
                timeout: float | None = None) -> int:
    """Run ``target(rank, world, store, *args)`` in ``world`` spawned
    processes (each joins with :func:`init_ranks`) and wait for them.
    Returns 0 when every rank exits 0, else the exit code of the first rank
    seen to fail (1 for a signal); the other ranks are then stopped
    (terminated, killed after 30 s).  Past ``timeout`` seconds the ranks
    are stopped alike and ``TimeoutError`` is raised."""
    deadline = None if timeout is None else time.monotonic() + timeout  # analysis: ignore[L301] join timeout
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, world, store, *args))
             for r in range(world)]
    for p in procs:
        p.start()
    rc = 0
    try:
        # the ranks still running, taken once a round: the sentinel of a
        # rank that exits after this is ready, so the wait returns.  (Read
        # again for the wait, ``exitcode`` could reap the last rank there
        # and leave nothing to wait on: with no timeout, for ever.)
        live = list(procs)
        while live and not rc:
            left = (None if deadline is None
                    else max(0.0, deadline - time.monotonic()))  # analysis: ignore[L301] join timeout
            if not multiprocessing.connection.wait(
                    [p.sentinel for p in live], left):
                raise TimeoutError(f"{world} ranks still running after "
                                   f"{timeout} s")
            live = [p for p in live if p.exitcode is None]
            for p in procs:
                if p.exitcode not in (None, 0) and not rc:
                    rc = p.exitcode if p.exitcode > 0 else 1
    finally:
        for p in procs:
            if p.exitcode is None:
                p.terminate()
            p.join(30)
            if p.exitcode is None:
                p.kill()
                p.join()
    return rc


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def make_production_mesh() -> Mesh:
    """The reference's production mesh, ``(16, 16)``: refused unless the
    world holds its 256 ranks."""
    if _world() < 256:
        raise RuntimeError(
            f"mesh (16, 16) needs 256 devices, found {_world()}; start 256 "
            f"torch.distributed ranks (one NCCL rank a card)")
    return Mesh(16, 16)


def make_debug_mesh(data: int = 1, model: int = 1) -> Mesh:
    """A ``(data, model)`` mesh over the process group that is set up,
    which must hold ``data · model`` ranks."""
    if _world() < data * model or not dist.is_initialized():
        raise RuntimeError(
            f"mesh ({data}, {model}) needs {data * model} devices, found "
            f"{_world()}; run it in a process group of {data * model} ranks "
            f"(the train CLI starts them itself)")
    return Mesh(data, model)
