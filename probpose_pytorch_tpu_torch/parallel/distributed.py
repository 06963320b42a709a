"""Several processes (port of probpose_pytorch_tpu/parallel/distributed.py).

JAX runs one process per host and a mesh over every host's devices. The
port runs one process per rank of a `torch.distributed` world: a rank is
one device, the card `cuda:(local rank % device count)` or the CPU. The
launcher contract is JAX's: the arguments, else the variables
`JAX_COORDINATOR_ADDRESS` (host:port), `JAX_NUM_PROCESSES` and
`JAX_PROCESS_ID` (the address may also be a torch init URL such as
`file:///shared/rendezvous`); in place of `JAX_AUTO_DISTRIBUTED=1` the port reads
torchrun's `RANK`, `WORLD_SIZE`, `MASTER_ADDR`/`MASTER_PORT`, `LOCAL_RANK`
and `LOCAL_WORLD_SIZE`.

The backend follows one rule, printed when the world starts: "nccl" when
every rank has a card of its own, "gloo" on the CPU or when ranks share a
card (NCCL refuses two ranks on one GPU). A rank's card is its index among
the ranks of its host: torchrun's `LOCAL_RANK`, else counted from every
rank's host name, which the ranks exchange through the rendezvous store
before the backend is chosen. Gloo moves CUDA tensors for
all_reduce and broadcast only; parallel/collectives.py stages its other
collectives through host memory on a gloo world with CUDA tensors.

Feeding: every rank of one data index takes the same rows. A loader gives a
rank either the whole global batch (the trainer takes the rank's rows) or
its data index's slice (`batch_iterator(process_index=, process_count=)`
with the mesh's data coordinate and size), as JAX's processes feed their
local slices.
"""

from __future__ import annotations

import os
import socket

import torch
import torch.distributed as dist

__all__ = ["maybe_initialize_distributed", "process_info", "local_batch_size", "backend_for",
           "rank_device", "host_ranks"]


def backend_for(local_world_size: int, device_type: str) -> str:
    """"nccl" when every rank of this host has a card of its own, else
    "gloo"."""
    if device_type == "cuda" and torch.cuda.is_available() \
            and local_world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_device(local_rank: int, device_type: str = "cuda") -> torch.device:
    """The device of a rank: `cuda:(local_rank % device count)`, or the CPU."""
    if device_type == "cuda":
        return torch.device("cuda", local_rank % torch.cuda.device_count())
    return torch.device("cpu")


def host_ranks(hosts: list[str], rank: int) -> tuple[int, int]:
    """(this rank's index among the ranks of its host, the ranks on its
    host), from every rank's host name in rank order."""
    mine = [r for r, h in enumerate(hosts) if h == hosts[rank]]
    return mine.index(rank), len(mine)


def _local_ranks(store, rank: int, world: int) -> tuple[int, int]:
    """(local rank, ranks on this host): torchrun's `LOCAL_RANK` and
    `LOCAL_WORLD_SIZE` where it set them, else every rank's host name
    exchanged through the rendezvous store."""
    env = os.environ
    if env.get("LOCAL_WORLD_SIZE") and env.get("LOCAL_RANK"):
        return int(env["LOCAL_RANK"]), int(env["LOCAL_WORLD_SIZE"])
    store.set(f"probpose/host/{rank}", socket.gethostname())
    return host_ranks([store.get(f"probpose/host/{r}").decode() for r in range(world)], rank)


def maybe_initialize_distributed(coordinator_address: str | None = None,
                                 num_processes: int | None = None,
                                 process_id: int | None = None, *,
                                 device: str = "cuda") -> bool:
    """Start the `torch.distributed` world when a launch of several
    processes is detected, in JAX's order: the arguments; the `JAX_*`
    variables; torchrun's variables. The coordinator is `host:port` or a
    torch init URL (`file:///shared/rendezvous`). `device` ("cuda" or
    "cpu") is where the ranks compute. The ranks on each host are counted
    before the backend is chosen. Returns True when a world is up after
    the call; a second call does nothing."""
    if dist.is_initialized():
        return True
    env = os.environ
    coordinator_address = coordinator_address or env.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None and env.get("JAX_NUM_PROCESSES"):
        num_processes = int(env["JAX_NUM_PROCESSES"])
    if process_id is None and env.get("JAX_PROCESS_ID"):
        process_id = int(env["JAX_PROCESS_ID"])
    if coordinator_address is None:
        if "RANK" not in env or "WORLD_SIZE" not in env:
            return False
        num_processes, process_id = int(env["WORLD_SIZE"]), int(env["RANK"])
        url = "env://"
    elif "://" in coordinator_address:
        url = coordinator_address
    else:
        url = f"tcp://{coordinator_address}"
    if num_processes is None or process_id is None:
        raise ValueError("a launch of several processes needs the process count and this "
                         "process's id (JAX_NUM_PROCESSES, JAX_PROCESS_ID)")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("maybe_initialize_distributed: device 'cuda' asked for, but torch "
                           "sees no CUDA device; pass device='cpu' to run on the CPU")
    store, _, _ = next(dist.rendezvous(url, process_id, num_processes))
    local_rank, on_host = _local_ranks(store, process_id, num_processes)
    backend = backend_for(on_host, device)
    if device == "cuda":
        torch.cuda.set_device(rank_device(local_rank))
    dist.init_process_group(backend, store=store, world_size=num_processes, rank=process_id)
    if process_id == 0:
        print(f"[distributed] {num_processes} processes, backend {backend} "
              f"({'a card per rank' if backend == 'nccl' else 'CPU or shared cards'}), "
              f"{on_host} on this host", flush=True)
    return True


def process_info() -> tuple[int, int]:
    """(process index, process count): the rank and the world size, (0, 1)
    without a world."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def local_batch_size(global_batch_size: int) -> int:
    """Rows per process: the global batch must divide evenly, so every
    rank feeds as many rows (the gathers of the train step need it)."""
    n = process_info()[1]
    if global_batch_size % n != 0:
        raise ValueError(f"global batch {global_batch_size} not divisible by "
                         f"process_count {n}")
    return global_batch_size // n
