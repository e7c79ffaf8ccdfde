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

The mesh is ``(data, spatial)``, as the JAX package's: ``world = data x
spatial`` ranks in contiguous blocks of ``spatial``, one block per spatial
group. A group holds one data shard, and each of its ranks ``H / spatial``
rows of every image in it:

- **input**: the group's first rank reads the shard's raw batch and
  broadcasts it over the group (:func:`spatial_feed`); each rank augments
  the full images, as JAX keeps augmentation on the ``data`` axis, and only
  then keeps its rows;
- **convs**: every 3x3 conv pads its rows with the neighbours' through the
  model's ``halo`` (``parallel/halo.py``), in train and eval mode; pools,
  deconvs, the 1x1 head and the skips stay local while a rank's rows at a
  level are even; at the first level where they are odd
  (``halo.split_level``) the rows are gathered before the pool, and the
  levels below run on the full rows, the same on every rank of the group;
- **BatchNorm, metrics, gradients**: over the world group, as without
  spatial partitioning: the statistics are those of every pixel of the
  global batch, each rank's loss is its rows' share of the global loss, and
  DDP's mean of the ranks' gradients is the global gradient (through the
  halo's and the all-reduces' backwards);
- **dropout**: each mask is drawn for the global batch at the level's full
  height, and each rank keeps its data rows and its spatial rows.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional

import torch
import torch.distributed as dist

from tpuseg_torch.parallel.distributed import check_spatial_groups, is_initialized
from tpuseg_torch.parallel.halo import Halo
from tpuseg_torch.train import steps as steps_lib


@dataclass(frozen=True)
class Mesh:
    """One process's place in the ``(data, spatial)`` layout: ``world``
    ranks of one device each, this process's ``rank``, the ``device`` it
    computes on, the ``group`` of every rank (DDP, sync-BN, metrics; None
    without a process group), the ``spatial`` size of a spatial group and
    this rank's ``halo`` exchange over its group (None when ``spatial`` is
    1)."""

    world: int
    rank: int
    device: torch.device
    group: Optional[object] = None
    spatial: int = 1
    halo: Optional[Halo] = None

    @property
    def data(self) -> int:
        """Data shards: the number of spatial groups."""
        return self.world // self.spatial

    @property
    def data_rank(self) -> int:
        return self.rank // self.spatial

    @property
    def spatial_rank(self) -> int:
        return self.rank % self.spatial


def make_mesh(device="cuda", spatial: int = 1, group=None) -> Mesh:
    """The ``(data, spatial)`` mesh of this process on ``device``: over
    ``group`` (default: every process of the initialized process group), or
    a one-rank mesh without a process group. ``spatial`` must divide the
    world, and a spatial group may not straddle hosts (``distributed.
    check_spatial_groups``). Every rank makes every spatial group, in the
    same order: ``dist.new_group`` is collective over the default group."""
    device = torch.device(device)
    if not is_initialized():
        if spatial != 1:
            raise ValueError(f"mesh of 1 device is not divisible by spatial={spatial}")
        return Mesh(1, 0, device)
    group = group if group is not None else dist.group.WORLD
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    if spatial < 1 or world % spatial:
        raise ValueError(f"mesh of {world} devices is not divisible by spatial={spatial}")
    if spatial == 1:
        return Mesh(world, rank, device, group)
    check_spatial_groups(spatial)
    ranks = [dist.get_global_rank(group, r) for r in range(world)]
    mine = None
    for start in range(0, world, spatial):
        g = dist.new_group(ranks[start:start + spatial])
        if start == rank - rank % spatial:
            mine = g
    halo = Halo(mine, device)
    print(f"spatial partitioning: mesh {world // spatial} x {spatial} (data x spatial), "
          f"rank {rank} holds row block {halo.rank} of {spatial}, halo route {halo.route}")
    return Mesh(world, rank, device, group, spatial, halo)


def spatial_feed(batches: Optional[Iterator], mesh: Mesh) -> Iterator:
    """The batches of ``mesh``'s spatial group: its first rank draws them
    from ``batches`` (tuples of tensors on the mesh's device) and broadcasts
    each over the group; the other ranks pass None and receive them. A
    header broadcast first carries the shapes and dtypes, or the end of the
    stream. Without spatial partitioning, ``batches`` itself.

    One rank reads for the group because the readers' output interleaves
    their workers' samples in arrival order: two ranks reading the same
    stripe would not get the same batches."""
    if mesh.spatial == 1:
        return batches
    return _feed(batches, mesh.halo.group, mesh.device)


def _feed(batches, group, device):
    src = dist.get_global_rank(group, 0)
    if dist.get_rank() == src:
        try:
            for batch in batches:
                dist.broadcast_object_list([[(t.shape, t.dtype) for t in batch]], src, group,
                                           device=device)
                for t in batch:
                    dist.broadcast(t, src, group)
                yield batch
            dist.broadcast_object_list([None], src, group, device=device)
        finally:
            close = getattr(batches, "close", None)
            if close is not None:
                close()
        return
    while True:
        header = [None]
        dist.broadcast_object_list(header, src, group, device=device)
        if header[0] is None:
            return
        batch = tuple(torch.empty(shape, dtype=dtype, device=device)
                      for shape, dtype in header[0])
        for t in batch:
            dist.broadcast(t, src, group)
        yield batch


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
    model.halo = mesh.halo
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
    """(train_step, eval_step) over host-preprocessed batches, parallel over
    ``mesh``: each rank passes its data shard of the global batch (full
    images; the steps keep this rank's rows). With a
    process group (one rank included, so a single card runs the NCCL path)
    the steps run through DDP with sync-BN and global metrics, and
    ``shard_optimizer=True`` swaps ``state``'s optimizer for ZeRO-1; without
    one, the plain pair of ``train.steps.make_steps``."""
    if mesh.group is None:
        return steps_lib.make_steps(label_smoothing)
    ddp = _data_parallel(model, mesh, shard_optimizer, state)
    return _reduced(*steps_lib.make_steps(label_smoothing, forward=ddp,
                                          rows=(mesh.spatial_rank, mesh.spatial)), mesh)


def make_parallel_raw_steps(model, mesh: Mesh, num_classes: int, aug_params=None,
                            augment: bool = True, label_smoothing: float = 0.0,
                            shard_optimizer: bool = False, state=None):
    """Raw-batch (train_step, eval_step) over ``mesh``: augmentation (drawn
    for the global batch, applied to this rank's data shard), normalization,
    one-hot, this rank's rows, forward/backward and Adam, as
    :func:`make_parallel_steps` runs them."""
    if mesh.group is None:
        return steps_lib.make_raw_steps(num_classes, aug_params, augment, label_smoothing)
    ddp = _data_parallel(model, mesh, shard_optimizer, state)
    return _reduced(*steps_lib.make_raw_steps(num_classes, aug_params, augment,
                                              label_smoothing, forward=ddp,
                                              shard=(mesh.data_rank, mesh.data),
                                              rows=(mesh.spatial_rank, mesh.spatial)), mesh)


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
