"""Data-parallel train steps over a process group.

Counterpart of ``tpuseg/parallel/mesh.py``. The JAX package shards the
batch over a ``(data, spatial)`` device mesh and lets GSPMD insert the
collectives; the port runs one process per GPU and inserts them itself,
with the same contract: the sharded step gives the numbers one device
gives on the global batch.

- **gradients**: ``DistributedDataParallel`` averages them over the ranks
  (each rank's loss is scaled by its own batch, so the mean is the global
  batch's gradient). ``broadcast_buffers=False``: the running statistics
  stay equal without it, because
- **BatchNorm** is synchronized: the model's ``process_group`` makes every
  train-mode BatchNorm all-reduce its per-channel sums (``models/unet.py``),
  23 all-reduces per forward, the JAX package's sync-BN;
- **random draws**: dropout masks and augmentation are drawn for the global
  batch from the replicated generators and each rank keeps its rows;
- **metrics**: loss and accuracy are all-reduced to the global means, equal
  on every rank;
- **ZeRO-1** (``shard_optimizer``): ``ZeroRedundancyOptimizer`` over
  ``KerasAdam``; each rank holds and updates the Adam moments of its
  partition of the parameters and broadcasts the updated ones.

The mesh's ``spatial`` axis (rows sharded too, with halo exchanges around
every conv, pool and deconv level) is not ported yet and raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from tpuseg_torch.parallel.distributed import is_initialized
from tpuseg_torch.train import steps as steps_lib


@dataclass(frozen=True)
class Mesh:
    """One process's place in the data-parallel layout: ``world`` ranks of
    one device each, this process's ``rank``, the ``device`` it computes on,
    and the ``group`` its collectives run over (None without a process
    group)."""

    world: int
    rank: int
    device: torch.device
    group: Optional[object] = None


def make_mesh(device="cuda", spatial: int = 1, group=None) -> Mesh:
    """The data-parallel mesh of this process on ``device``: over ``group``
    (default: every process of the initialized process group), or a
    one-rank mesh without a process group."""
    if spatial != 1:
        raise NotImplementedError(
            f"spatial={spatial}: spatial partitioning (rows sharded over GPUs, with a "
            "hand-written halo exchange around every conv, pool and deconv level) is "
            "not ported yet; it is the next slice of the port")
    device = torch.device(device)
    if not is_initialized():
        return Mesh(1, 0, device)
    group = group if group is not None else dist.group.WORLD
    return Mesh(dist.get_world_size(group), dist.get_rank(group), device, group)


def _src(mesh: Mesh) -> int:
    """The global rank of the mesh's rank 0."""
    return dist.get_global_rank(mesh.group, 0)


def replicate_state(state, mesh: Mesh):
    """Make every rank's model rank 0's: its parameters and buffers (the
    BatchNorm running statistics) broadcast in place."""
    if mesh.group is None:
        return state
    with torch.no_grad():
        for t in list(state.model.parameters()) + list(state.model.buffers()):
            dist.broadcast(t, src=_src(mesh), group=mesh.group)
    return state


def zero_optimizer(optimizer: steps_lib.KerasAdam, mesh: Mesh):
    """ZeRO-1: a ``ZeroRedundancyOptimizer`` over ``KerasAdam`` with
    ``optimizer``'s parameters, hyperparameters, step count and moments;
    each rank keeps the moments of its partition only."""
    from torch.distributed.optim import ZeroRedundancyOptimizer

    if len(optimizer.param_groups) != 1:
        raise ValueError("zero_optimizer takes a KerasAdam with one parameter group")
    group = optimizer.param_groups[0]
    zero = ZeroRedundancyOptimizer(group["params"], optimizer_class=steps_lib.KerasAdam,
                                   process_group=mesh.group, lr=group["lr"],
                                   betas=group["betas"], eps=group["eps"])
    zero.load_state_dict(optimizer.state_dict())
    return zero


def _data_parallel(model, mesh: Mesh, shard_opt: bool, state):
    """Wrap ``model`` for ``mesh``: sync-BN and global draws through its
    process group, the ZeRO-1 optimizer swapped into ``state``, and the DDP
    module the forward runs through."""
    from torch.nn.parallel import DistributedDataParallel

    if shard_opt:
        if state is None:
            raise ValueError("shard_optimizer=True needs the state template")
        state.optimizer = zero_optimizer(state.optimizer, mesh)
    model.process_group = mesh.group
    device_ids = [mesh.device] if mesh.device.type == "cuda" else None
    return DistributedDataParallel(model, device_ids=device_ids, process_group=mesh.group,
                                   broadcast_buffers=False)


def _global_means(metrics, mesh: Mesh):
    """Loss and accuracy averaged over the ranks (equal batches: the global
    batch's), in one all-reduce."""
    with torch.no_grad():
        t = torch.stack([metrics["loss"].detach().float(), metrics["accuracy"].float()])
        dist.all_reduce(t, group=mesh.group)
        t = t / mesh.world
    return {"loss": t[0], "accuracy": t[1]}


def _reduced(tstep, estep, mesh: Mesh):
    return ((lambda state, x, y: _global_means(tstep(state, x, y), mesh)),
            (lambda state, x, y: _global_means(estep(state, x, y), mesh)))


def make_parallel_steps(model, mesh: Mesh, label_smoothing: float = 0.0,
                        shard_optimizer: bool = False, state=None):
    """(train_step, eval_step) over host-preprocessed batches, data-parallel
    over ``mesh``: each rank passes its slice of the global batch. With a
    process group (one rank included, so a single card runs the NCCL path)
    the steps run through DDP with sync-BN and global metrics, and
    ``shard_optimizer=True`` swaps ``state``'s optimizer for ZeRO-1; without
    one, the plain pair of ``train.steps.make_steps``."""
    if mesh.group is None:
        return steps_lib.make_steps(label_smoothing)
    ddp = _data_parallel(model, mesh, shard_optimizer, state)
    return _reduced(*steps_lib.make_steps(label_smoothing, forward=ddp), mesh)


def make_parallel_raw_steps(model, mesh: Mesh, num_classes: int, aug_params=None,
                            augment: bool = True, label_smoothing: float = 0.0,
                            shard_optimizer: bool = False, state=None):
    """Raw-batch (train_step, eval_step) over ``mesh``: augmentation (drawn
    for the global batch, this rank's rows applied), normalization, one-hot,
    forward/backward and Adam, as :func:`make_parallel_steps` runs them."""
    if mesh.group is None:
        return steps_lib.make_raw_steps(num_classes, aug_params, augment, label_smoothing)
    ddp = _data_parallel(model, mesh, shard_optimizer, state)
    return _reduced(*steps_lib.make_raw_steps(num_classes, aug_params, augment,
                                              label_smoothing, forward=ddp,
                                              shard=(mesh.rank, mesh.world)), mesh)


def warm_collectives(mesh: Mesh) -> None:
    """One all-reduce of ones over the mesh before the first step: it sets
    the communicator up while the processes are in step, and its sum must
    be the world size, or the collectives are broken and this raises."""
    if mesh.group is None:
        return
    t = torch.ones(1, device=mesh.device)
    dist.all_reduce(t, group=mesh.group)
    total = float(t.item())
    if total != float(mesh.world):
        raise RuntimeError(f"mesh warm-up all_reduce returned {total}, expected "
                           f"{mesh.world}: cross-process collectives are broken")
