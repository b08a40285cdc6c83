"""Which collectives gloo takes, on CPU tensors and (with a card) on CUDA
tensors, in a world of spawned ranks that share the host (and ``cuda:0``).

    python3 scripts/probe_gloo_collectives.py [WORLD]

Prints one JSON object: the torch and CUDA versions and, per device, each
collective the sharded substrate uses (``all_reduce`` in f32, bf16 and
int8, async, over a subgroup; ``reduce_scatter_tensor``,
``all_gather_into_tensor``, ``all_gather``, ``gather``, ``scatter``,
``broadcast``) as ``ok`` or the error it raised.
"""
import json
import os
import sys
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _ops(dev: str, world: int, rank: int) -> dict:
    res = {}

    def probe(name, fn):
        try:
            fn()
            res[name] = "ok"
        except Exception as e:      # the probe reports what gloo refuses
            res[name] = f"{type(e).__name__}: {str(e)[:160]}"

    for dt in (torch.float32, torch.bfloat16, torch.int8):
        def reduce(dt=dt):
            x = torch.full((16,), rank + 1, dtype=dt, device=dev)
            dist.all_reduce(x)
            assert int(x[0]) == world * (world + 1) // 2, x
        probe(f"all_reduce_{str(dt).replace('torch.', '')}", reduce)

    def reduce_async():
        x = torch.ones(8, device=dev)
        dist.all_reduce(x, async_op=True).wait()
        assert float(x[0]) == world

    probe("all_reduce_async", reduce_async)
    pair = dist.new_group([0, 1])

    def reduce_subgroup():
        if rank < 2:
            x = torch.ones(8, device=dev)
            dist.all_reduce(x, group=pair)
            assert float(x[0]) == 2

    probe("subgroup_all_reduce", reduce_subgroup)

    def reduce_scatter():
        x = torch.arange(world * 4, dtype=torch.float32, device=dev)
        out = torch.empty(4, device=dev)
        dist.reduce_scatter_tensor(out, x)
        assert float(out[0]) == world * rank * 4

    probe("reduce_scatter_tensor", reduce_scatter)

    def gather_into():
        out = torch.empty(world * 4, device=dev)
        dist.all_gather_into_tensor(out, torch.full((4,), float(rank),
                                                    device=dev))
        assert float(out[-1]) == world - 1

    probe("all_gather_into_tensor", gather_into)
    probe("all_gather", lambda: dist.all_gather(
        [torch.empty(4, device=dev) for _ in range(world)],
        torch.full((4,), float(rank), device=dev)))
    probe("gather", lambda: dist.gather(
        torch.full((4,), float(rank), device=dev),
        [torch.empty(4, device=dev) for _ in range(world)] if rank == 0
        else None, dst=0))

    def scatter():
        x = torch.empty(4, device=dev)
        dist.scatter(x, [torch.full((4,), float(r), device=dev)
                         for r in range(world)] if rank == 0 else None,
                     src=0)
        assert float(x[0]) == rank

    probe("scatter", scatter)
    probe("broadcast", lambda: dist.broadcast(
        torch.full((4,), float(rank), device=dev), 0))
    return res


def _rank(rank: int, world: int, store: str, out: str) -> None:
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    res = {"cpu": _ops("cpu", world, rank)}
    if torch.cuda.is_available():
        torch.cuda.set_device(0)
        res["cuda"] = _ops("cuda", world, rank)
    dist.barrier()
    if rank == 0:
        with open(out, "w") as fh:
            json.dump(res, fh)
    dist.destroy_process_group()


if __name__ == "__main__":
    world = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    tmp = tempfile.mkdtemp()
    out = os.path.join(tmp, "probe.json")
    mp.spawn(_rank, args=(world, os.path.join(tmp, "store"), out),
             nprocs=world, join=True)
    with open(out) as fh:
        print(json.dumps({"torch": torch.__version__,
                          "cuda": torch.version.cuda, "world": world,
                          **json.load(fh)}))
