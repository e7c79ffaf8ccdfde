"""Multi-process (multi-GPU, multi-host) wiring.

Counterpart of ``tpuseg/parallel/distributed.py``. JAX drives every local
chip from one process per host; PyTorch's idiom is one process per GPU under
``torchrun`` (``python -m torch.distributed.run``). The port takes that idiom
and keeps the JAX package's semantics:

- :func:`initialize_distributed` joins the process group from torchrun's
  environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
  ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``) or from explicit
  arguments (the counterparts of ``JAX_COORDINATOR_ADDRESS``,
  ``JAX_NUM_PROCESSES`` and ``JAX_PROCESS_ID``). Its backend is NCCL on
  the card and gloo on the CPU; under NCCL a second, gloo group carries the
  host-side barriers and broadcasts;
- each process's readers produce only ``global_batch // world`` samples
  (:func:`process_local_batch_size`), the rows
  :func:`process_local_batch_slice` names; under spatial partitioning a
  spatial group's first process reads its data shard's batch, and the
  groups stay inside one host (:func:`check_spatial_groups`);
- ``make_hybrid_mesh`` needs no counterpart: torchrun numbers ranks
  host-contiguously (node k owns ranks ``[k*n, (k+1)*n)`` for n processes
  per node), which is the layout ``make_hybrid_mesh`` builds by sorting
  devices by process.

Failure semantics: every collective has the group's finite timeout, so a
process that dies (a reader crash, a preemption) surfaces on its peers as
a timeout at their next collective, which unwinds through the trainer's
reader-shutdown ``finally``. :func:`host_barrier` raises when a peer does
not arrive; it never degrades to a no-op. The run resumes from the best
checkpoint with ``--resume_checkpoint`` (each process restores it
host-locally).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 600.0

# gloo group for host-side barriers and broadcasts when the default group
# is NCCL (which has no monitored barrier and wants device tensors); made
# on first use, by every process at the same point
_HOST_GROUP = None


def _timeout(seconds: float) -> datetime.timedelta:
    return datetime.timedelta(seconds=seconds)


def local_rank() -> int:
    """This process's index on its node (torchrun's ``LOCAL_RANK``; 0
    outside torchrun): the GPU it owns."""
    return int(os.environ.get("LOCAL_RANK", 0))


def local_world_size() -> int:
    """Processes on this node (torchrun's ``LOCAL_WORLD_SIZE``; 1 outside
    torchrun)."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", 1))


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if is_initialized() else 1


def host_count() -> int:
    """Nodes in the run: processes over processes per node."""
    return max(1, process_count() // local_world_size())


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None,
                           timeout_s: float = DEFAULT_TIMEOUT_S) -> str:
    """Join the process group and return its backend.

    With ``coordinator_address`` (``host:port``, where process 0 listens; or
    a ``file://`` path that every process shares and that does not exist
    yet, a rendezvous no other program can take), ``num_processes`` and
    ``process_id`` all given, the group forms over ``tcp://`` or that file;
    with none given, from torchrun's environment, and without
    that environment it raises. ``backend`` defaults to ``nccl`` when a card
    is visible and ``gloo`` otherwise; under NCCL this process binds its
    GPU, ``cuda:LOCAL_RANK``, first. A failed initialization raises."""
    explicit = (coordinator_address, num_processes, process_id)
    if any(v is not None for v in explicit):
        if any(v is None for v in explicit):
            raise ValueError("explicit initialization takes coordinator_address, "
                             "num_processes and process_id together")
        init_method = (coordinator_address if coordinator_address.startswith("file://")
                       else f"tcp://{coordinator_address}")
        world, rank = int(num_processes), int(process_id)
    else:
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
                   if k not in os.environ]
        if missing:
            raise RuntimeError(
                f"multi-process run without torchrun's environment ({', '.join(missing)} "
                "unset): launch with `python -m torch.distributed.run --nproc_per_node N "
                "-m <module> --multihost 1 ...`, or pass coordinator_address, "
                "num_processes and process_id")
        init_method = "env://"
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(local_rank())
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            timeout=_timeout(timeout_s))
    return backend


def shutdown_distributed() -> None:
    """Leave the process group (a no-op outside one)."""
    global _HOST_GROUP
    if is_initialized():
        dist.destroy_process_group()
    _HOST_GROUP = None


def host_group():
    """The group host-side collectives run over: the default group when it
    is gloo, else a gloo group of every process (collective to create: every
    process reaches its first use at the same point)."""
    global _HOST_GROUP
    if dist.get_backend() == "gloo":
        return None
    if _HOST_GROUP is None:
        _HOST_GROUP = dist.new_group(backend="gloo")
    return _HOST_GROUP


def host_barrier(name: str, timeout_s: float = DEFAULT_TIMEOUT_S) -> str:
    """Wait until every process reaches the barrier ``name``: a
    ``monitored_barrier`` on the gloo group, which names the processes that
    did not arrive. Returns ``"single-process"`` outside a group and
    ``"synced"`` after the wait; raises when a peer does not arrive within
    ``timeout_s``."""
    if process_count() == 1:
        return "single-process"
    try:
        dist.monitored_barrier(group=host_group(), timeout=_timeout(timeout_s),
                               wait_all_ranks=True)
    except RuntimeError as e:
        raise RuntimeError(f"host barrier {name!r} failed: {e}") from e
    return "synced"


def broadcast_seed(value: int) -> int:
    """Process 0's ``value`` on every process (a seed drawn from entropy:
    the replicated model and the dropout and augmentation draws need one
    seed everywhere)."""
    if process_count() == 1:
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64)
    dist.broadcast(t, src=0, group=host_group())
    return int(t.item())


def check_spatial_groups(spatial: int) -> None:
    """Raise unless spatial groups of ``spatial`` consecutive ranks stay
    inside one host: torchrun numbers ranks host-contiguously, so a host's
    process count must divide by ``spatial``. A group that straddled hosts
    would put every halo exchange on the network between them."""
    local = local_world_size()
    if local % spatial:
        raise ValueError(
            f"{local} processes per host not divisible by spatial={spatial}: spatial "
            "groups would straddle hosts")


def process_local_batch_size(global_batch: int,
                             data_shards: Optional[int] = None) -> int:
    """How many samples this process's readers produce per step.

    ``data_shards`` is the global data-axis size (defaults to one per
    process: each process owns one GPU). Under spatial partitioning there
    are fewer data shards than processes: a spatial group's processes
    share one data shard, whose whole batch its first process reads
    (``mesh.spatial_feed``)."""
    n = process_count()
    shards = data_shards or n
    if shards < n:
        if n % shards or global_batch % shards:
            raise ValueError(f"global batch {global_batch} over {n} processes not "
                             f"divisible by {shards} data shards")
        return global_batch // shards
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by {n} hosts")
    local = global_batch // n
    # fail here, with the numbers named, rather than inside the prefetch
    # thread: every data shard of this process needs whole samples
    shards_per_host = shards // n
    if local % shards_per_host:
        raise ValueError(
            f"per-host batch {local} (global {global_batch} / {n} hosts) not "
            f"divisible by {shards_per_host} data shards per host")
    return local


def process_local_batch_slice(global_batch: int) -> slice:
    """The rows of the global batch this process feeds: ranks are
    contiguous on the data axis, so rank k owns ``[k*per, (k+1)*per)``."""
    per = process_local_batch_size(global_batch)
    start = process_index() * per
    return slice(start, start + per)
