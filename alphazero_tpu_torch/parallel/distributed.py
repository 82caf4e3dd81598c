"""Starting the ranks of a multi-process run, and the collectives they use.

Counterpart of the JAX package's ``parallel/distributed.py``.  JAX runs one
program over every device of a host and wires hosts together with
``jax.distributed.initialize``; here every rank is a process of its own in
one ``torch.distributed`` process group:

* :func:`initialize` joins the group at a coordinator ``host:port`` given
  by the caller, or at torchrun's ``MASTER_ADDR``/``MASTER_PORT`` with its
  ``RANK``/``WORLD_SIZE``; with neither it returns False (one process, no
  group).
* :func:`launch` starts the local ranks of the one-command form (``train
  --mesh data=N`` without ``--coordinator``): a world of one runs in the
  calling process, a larger one in spawned processes.  It builds the CUDA
  kernels once before any rank starts, so the ranks do not race ``nvcc``.

Device and backend rules (:func:`plan_ranks`).  Before the group starts,
every rank publishes its host name, its device type and its host's card
count in the rendezvous store and reads every other rank's, so each rank
decides from the same facts.  A rank's local rank is its place among its
host's ranks in rank order; its device is ``cuda:{local_rank %
device_count}`` (``torch.cuda.set_device`` is called before any kernel is
touched) or the CPU when the caller asks for it, where each rank runs one
intra-op thread.  The backend is ``nccl`` when every rank runs on a card
and no host holds more ranks than cards, else ``gloo`` (ranks that share a
card: NCCL refuses two ranks on one GPU; or ranks on the CPU).

Transport rule.  ``all_reduce`` and ``broadcast`` take a tensor where it
lies: NCCL on the card, gloo on the CPU or staging a CUDA tensor through
the host itself.  gloo has no ``all_gather`` of CUDA tensors, so under
gloo :func:`all_gather` copies to the CPU first and returns CPU tensors;
under NCCL it gathers on the card.
"""

from __future__ import annotations

import datetime
import json
import os
import socket
import sys
from typing import Optional

import torch
import torch.distributed as dist

from alphazero_tpu_torch.device import resolve_device


def _local_device(local_rank: int, device: str) -> torch.device:
    dev = resolve_device(device)
    if dev.type != "cuda":
        # CPU ranks share the host's cores, and their small operations gain
        # nothing from a pool of threads that spin against the other ranks'
        torch.set_num_threads(1)
        return dev
    index = local_rank % torch.cuda.device_count()
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


def plan_ranks(facts: list, rank: int) -> tuple:
    """``(local_rank, backend)`` of ``rank`` from every rank's facts
    ``(host, device type, cards on the host)``, listed by rank: the rules
    of the module's docstring."""
    host = facts[rank][0]
    local_rank = [f[0] for f in facts[:rank]].count(host)
    per_host = {}
    for h, _, _ in facts:
        per_host[h] = per_host.get(h, 0) + 1
    own_card = all(kind == "cuda" and per_host[h] <= cards
                   for h, kind, cards in facts)
    return local_rank, "nccl" if own_card else "gloo"


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device="cuda",
               timeout: Optional[float] = None) -> bool:
    """Join the process group: at ``coordinator`` (``host:port``) as rank
    ``process_id`` of ``num_processes``, or from torchrun's environment.
    Returns False, and starts nothing, in a single-process run.  Prints the
    rank, world, device and backend on standard error.  ``timeout`` (s)
    bounds every collective's wait."""
    env = os.environ
    if coordinator is None and "MASTER_ADDR" not in env:
        return False
    world = int(num_processes if num_processes is not None
                else env.get("WORLD_SIZE", 1))
    rank = int(process_id if process_id is not None else env.get("RANK", 0))
    wait = (dist.default_pg_timeout if timeout is None
            else datetime.timedelta(seconds=timeout))
    url = "env://" if coordinator is None else f"tcp://{coordinator}"
    store, rank, world = next(dist.rendezvous(url, rank, world,
                                              timeout=wait))
    kind = resolve_device(device).type
    cards = torch.cuda.device_count() if kind == "cuda" else 0
    store.set(f"az_facts/{rank}",
              json.dumps([socket.gethostname(), kind, cards]))
    facts = [json.loads(store.get(f"az_facts/{r}")) for r in range(world)]
    local_rank, backend = plan_ranks(facts, rank)
    dev = _local_device(local_rank, device)
    dist.init_process_group(backend, store=store, world_size=world,
                            rank=rank, **({} if timeout is None
                                          else {"timeout": wait}))
    _STATE.update(local_rank=local_rank, device=dev, store=store)
    print(f"rank {rank} of {world}: device {dev}, backend {backend}",
          file=sys.stderr, flush=True)
    return True


# this process's rank-local facts, set by initialize
_STATE: dict = {}


def process_info() -> dict:
    """Rank, world, local rank, device and backend of this process (one
    process without a group: rank 0 of 1, backend None)."""
    if not dist.is_initialized():
        return {"rank": 0, "world": 1, "local_rank": 0, "device": None,
                "backend": None}
    return {"rank": dist.get_rank(), "world": dist.get_world_size(),
            "local_rank": _STATE["local_rank"], "device": _STATE["device"],
            "backend": dist.get_backend()}


def free_port() -> int:
    """A TCP port of localhost that is free now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, fn, world, port, device, timeout, args):
    initialize(f"127.0.0.1:{port}", world, rank, device, timeout)
    try:
        fn(*args)
    finally:
        destroy()


def launch(fn, world: int, *args, device="cuda",
           timeout: Optional[float] = None):
    """Run ``fn(*args)`` on ``world`` local ranks of one new process group
    and wait for all of them.  A world of one runs in this process; larger
    worlds spawn one process per rank (``fn`` must be importable: a
    module-level function of a module that the ranks can import), and a
    failing rank stops the others and raises here."""
    if resolve_device(device).type == "cuda":
        from alphazero_tpu_torch.ops import build
        build.build_all()
    port = free_port()
    if world == 1:
        _rank_main(0, fn, 1, port, device, timeout, args)
        return
    import torch.multiprocessing as mp
    mp.start_processes(_rank_main, args=(fn, world, port, device, timeout,
                                         args),
                       nprocs=world, join=True, start_method="spawn")


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce over ``group`` (a no-op without a process
    group); returns ``t``."""
    if dist.is_initialized():
        dist.all_reduce(t, op=op, group=group)
    return t


def broadcast(t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """In-place broadcast from global rank ``src``; returns ``t``."""
    if dist.is_initialized():
        dist.broadcast(t, src)
    return t


def all_gather(t: torch.Tensor, group) -> list:
    """``t`` of every rank of ``group``, in group order (the transport
    rule above: CPU tensors under gloo)."""
    if not dist.is_initialized():
        return [t]
    if dist.get_backend(group) == "gloo":
        t = t.cpu()
    t = t.contiguous()
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t, group=group)
    return out


def destroy():
    """Leave the process group."""
    dist.destroy_process_group()


def barrier():
    if dist.is_initialized():
        dist.barrier()
