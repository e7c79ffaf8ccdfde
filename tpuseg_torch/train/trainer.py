"""Training driver, single GPU.

Counterpart of ``tpuseg/train/trainer.py`` (the reference
``train.py::train_model``, train.py:33-206), with the same orchestration:

- test reader: no augmentation, no shuffle, strided walk; train reader:
  augmentation/balancing per flags (train.py:66-75). With device
  augmentation (the default) the readers ship raw uint samples and the
  train step augments them on the card (``aug/device.py``, kernel K1);
- epoch 0 is an Adam warmup at lr/10 for min(1000, test_every_n_steps)
  steps (train.py:126-132): the lr lives in the optimizer's param group;
- an "epoch" is ``test_every_n_steps`` train steps followed by a full pass
  over the test set (train.py:99-100); both loops run ``size+1`` batches
  because the reference breaks on ``step > size`` (train.py:137, 155);
- train metrics accumulate on the card over a window of
  ``log_every_n_steps`` steps and are read back once per window; per-step
  and per-epoch lines are printed, ``test_loss.csv`` is rewritten every
  epoch (train.py:173-176), and the same scalars go to TensorBoard event
  files under ``tensorboard-<timestamp>/{train,test}`` (train.py:110-119,
  146-148, 167-169): ``loss``, ``accuracy`` and ``images_per_sec`` per
  logged window, the test ``loss`` and ``accuracy`` per epoch, at
  tpuseg's steps (``utils/tb_events.py`` writes them without protobuf);
- ``profile_steps`` N > 0 traces the first N steps of epoch 1 (epoch 0
  warms up) with ``torch.profiler`` into ``<output>/profile``
  (``utils/profiling.trace``; ``python -m tpuseg_torch.utils.trace_analysis``
  reads it); while it records, every step is read back, so the window
  closes at an exact step;
- a checkpoint is written (in the background) only when the test loss
  improves, never for a non-finite loss (train.py:181-184);
- early stopping: best epoch = first within 1e-4 of the minimum; stop when
  ``epochs - best > early_stopping_count`` (train.py:187-199);
- resume restores the full state and the test-loss history.

Runs on ``config.device`` — the card by default; asking for it without one
raises.

``model`` picks the architecture (``models.MODEL_KINDS``): ``unet``, the
default, at ``base_features``; or ``transunet_r50_b16``, TransUNet at its
published widths, whose tile is the database's image side (square images
only; its position embeddings fix it) and which refuses spatial
partitioning, since its attention is global over the tile.

Data parallelism (``parallel/``): in a process group (``cli.train
--multihost 1`` under torchrun, one process per GPU) each rank trains on
``cuda:LOCAL_RANK`` with ``batch_size`` samples, its readers striped by rank,
so the global batch is ``batch_size x world``; the steps run through DDP
with sync-BN and global metrics (``shard_optimizer``: ZeRO-1), every rank
takes the same early-stopping and checkpoint decisions, and rank 0 alone
writes the checkpoint, ``test_loss.csv`` and the TensorBoard files. A
process that sees several GPUs without a process group raises rather than
train on one of them.

Spatial partitioning (``spatial_partitions`` N > 1, ``parallel/halo.py``):
the ranks form a ``(data, spatial)`` mesh of groups of N consecutive ranks
on one host; a group is one replica, so the global batch is ``batch_size x
world / N``. Each group's first rank reads its data shard (readers striped
by data index) and broadcasts the raw batch over the group; every rank
augments the full images and trains on its ``H / N`` rows of each, with a
halo exchange around every 3x3 conv. ``H`` must be a multiple of 16 and
of ``N``, as in the JAX package; where a pool window would straddle two
ranks, the rows are gathered at that level (``halo.split_level``).
"""

from __future__ import annotations

import datetime
import os
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from tpuseg_torch.data.reader import AugmentParams, ImageReader
from tpuseg_torch.infer.runner import resolve_device
from tpuseg_torch.models import MODEL_KINDS, build_model
from tpuseg_torch.parallel import distributed
from tpuseg_torch.parallel import mesh as mesh_lib
from tpuseg_torch.parallel.halo import split_level
from tpuseg_torch.train.prefetch import device_prefetch
from tpuseg_torch.train.steps import create_train_state
from tpuseg_torch.utils.checkpoint import AsyncCheckpointWriter, restore_train_state
from tpuseg_torch.utils.profiling import ThroughputMeter
from tpuseg_torch.utils.tb_events import EventFileWriter

CONVERGENCE_TOLERANCE = 1e-4  # train.py:187


@dataclass
class TrainConfig:
    train_database: str
    test_database: str
    output_folder: str
    batch_size: int = 4  # train.py:220
    number_classes: int = 2
    learning_rate: float = 3e-4
    test_every_n_steps: int = 1000
    balance_classes: bool = False
    use_augmentation: bool = True
    early_stopping_count: int = 10
    reader_count: int = 1  # train.py:232
    label_smoothing: float = 0.0
    seed: Optional[int] = None
    augment_params: AugmentParams = field(default_factory=AugmentParams)
    warmup_steps_cap: int = 1000  # train.py:127
    # caps TOTAL epochs including any resumed test-loss history; a resumed
    # run always gets at least one new epoch
    max_epochs: Optional[int] = None
    dtype: str = "bfloat16"
    base_features: int = 64  # reference _BASELINE_FEATURE_DEPTH (model.py:20)
    # readers ship raw uint samples and augmentation/zscore/one-hot run on
    # the card (aug/device.py); False runs the reference's host pipeline
    device_augment: bool = True
    # a training checkpoint to resume the full state from
    resume_checkpoint: Optional[str] = None
    # ZeRO-1: the Adam moments sharded over the process group's ranks
    shard_optimizer: bool = False
    # spatial partitioning: each image's rows sharded over a group of N
    # GPUs of one host, with a halo exchange around every 3x3 conv; a group
    # is one replica, so the global batch is batch_size x (GPUs / N). The
    # image height must be a multiple of 16 and of N
    spatial_partitions: int = 1
    # torch.profiler trace of the first N steps of epoch 1 (after the
    # warmup epoch) into <output_folder>/profile; 0 disables
    profile_steps: int = 0
    # data echoing (arXiv:1907.05550): optimizer steps per fetched batch;
    # with device augmentation each echo re-augments the raw batch
    batch_echo: int = 1
    # read back/print train metrics every N steps (the window mean); 1 is
    # the reference's per-step print
    log_every_n_steps: int = 1
    # "cuda" (default) or "cpu"; "cuda" without a card raises
    device: str = "cuda"
    # the architecture, one of models.MODEL_KINDS
    model: str = "unet"


@dataclass
class TrainResult:
    test_loss: List[float]
    best_epoch: int
    epochs_run: int
    checkpoint_path: str
    final_train_loss: float
    # the mean train loss of every logged window, in order
    train_losses: List[float] = field(default_factory=list)
    steps: int = 0  # optimizer steps taken, counting resumed ones
    images_per_sec: Optional[float] = None  # the meter's last reading


def _device_seed(seed: Optional[int]) -> int:
    """The run's seed: the configured one, or fresh entropy when unseeded —
    a fixed default would replay identical dropout and augmentation streams
    across nominally independent runs. The ranks of a process group must
    agree on it (the model and the generators are replicated), so rank 0's
    draw is broadcast."""
    if seed is not None:
        return seed
    return distributed.broadcast_seed(int.from_bytes(os.urandom(4), "little"))


def _train_device(cfg: TrainConfig) -> torch.device:
    """The device this process trains on: ``cfg.device``, and under a process
    group on the card its GPU, ``cuda:LOCAL_RANK``. Several visible GPUs
    without a process group raise: training would use one of them."""
    device = resolve_device(cfg.device)
    if device.type != "cuda":
        return device
    if distributed.is_initialized():
        return torch.device("cuda", distributed.local_rank())
    n = torch.cuda.device_count()
    if n > 1:
        raise RuntimeError(
            f"{n} GPUs are visible but no process group is initialized, so training "
            f"would use one of them: launch one process per GPU with `torchrun "
            f"--nproc_per_node {n} -m tpuseg_torch.cli.train --multihost 1 ...`, or "
            "expose one GPU (CUDA_VISIBLE_DEVICES)")
    return device


class _NullWriter:
    """The event writer of a rank that does not write (rank 0 does)."""

    def add_scalar(self, *args) -> None:
        pass

    def close(self) -> None:
        pass


def _summary_writers(output_folder: str):
    """The train and test event writers, in ``tensorboard-<timestamp>/
    {train,test}`` (tpuseg's layout); null writers off rank 0."""
    if distributed.process_index() != 0:
        return _NullWriter(), _NullWriter()
    current_time = datetime.datetime.now().strftime("%Y%m%dT%H%M%S")
    root = os.path.join(output_folder, "tensorboard-" + current_time)
    return EventFileWriter(os.path.join(root, "train")), EventFileWriter(os.path.join(root, "test"))


def _resumed_history(cfg: TrainConfig) -> List[float]:
    """The test-loss history of the run a resume continues: the csv in the
    output folder when the checkpoint lives there, else the one beside the
    checkpoint (<old_output>/checkpoint/ckpt -> <old_output>/test_loss.csv),
    else the output folder's with a warning (it may be an unrelated run's)."""
    out_fp = os.path.join(cfg.output_folder, "test_loss.csv")
    ckpt_parent = os.path.dirname(os.path.dirname(os.path.abspath(cfg.resume_checkpoint)))
    ckpt_fp = os.path.join(ckpt_parent, "test_loss.csv")
    same_dir = os.path.realpath(ckpt_parent) == os.path.realpath(cfg.output_folder)
    candidates = [out_fp] if same_dir else [ckpt_fp, out_fp]
    if not same_dir and os.path.exists(ckpt_fp) and os.path.exists(out_fp):
        print(f"WARNING: test_loss.csv exists both beside the resume checkpoint "
              f"({ckpt_fp}) and in the output folder ({out_fp}); using the "
              "checkpoint-side history — the output-folder copy is from a different run")
    for hist_fp in candidates:
        if os.path.exists(hist_fp):
            if hist_fp == out_fp and not same_dir:
                print(f"WARNING: no test_loss.csv beside the resume checkpoint "
                      f"({ckpt_fp}); adopting the output-folder history {out_fp} — if "
                      "this output dir is reused from an UNRELATED run, delete that "
                      "csv first or best-checkpoint selection will trust the wrong losses")
            with open(hist_fp) as f:
                history = [float(line) for line in f if line.strip()]
            print(f"Resumed test-loss history: {len(history)} epochs from {hist_fp}")
            return history
    print("WARNING: no test_loss.csv found in the output folder or beside the resume "
          "checkpoint — best-checkpoint selection and early-stopping patience are "
          "RESTARTING from scratch; the first post-resume epoch will overwrite the "
          "stored best checkpoint even if its loss is worse")
    return []


def _device_params(ap: AugmentParams):
    from tpuseg_torch.aug.device import DeviceAugmentParams

    return DeviceAugmentParams(
        reflection=ap.reflection_flag,
        rotation=ap.rotation_flag,
        jitter_severity=ap.jitter_augmentation_severity,
        noise_severity=ap.noise_augmentation_severity,
        scale_severity=ap.scale_augmentation_severity,
        blur_max_sigma=ap.blur_max_sigma,
        intensity_severity=ap.intensity_augmentation_severity or 0.0,
    )


def _barrier_after_first(it, name: str):
    """Yield from ``it``, with every process meeting at a host barrier once
    its first item is ready (reader start-up time differs per process and
    is the last unsynchronized wait before step one); closes ``it`` on
    close, so the prefetch thread stops."""
    try:
        first = True
        for item in it:
            if first:
                distributed.host_barrier(name)
            first = False
            yield item
    finally:
        it.close()


def _build_model(cfg: TrainConfig, image_size) -> torch.nn.Module:
    """The run's model: the U-Net at ``base_features``, or TransUNet at the
    database's tile."""
    channels = image_size[2]
    if cfg.model == "unet":
        return build_model("unet", num_classes=cfg.number_classes, num_channels=channels,
                           base_features=cfg.base_features, dtype=cfg.dtype)
    height, width = image_size[:2]
    if height != width:
        raise ValueError(f"{cfg.model} trains on square tiles (its position embeddings fix "
                         f"the tile), but the database's images are {height} x {width}")
    return build_model(cfg.model, num_classes=cfg.number_classes, num_channels=channels,
                       img_size=height, dtype=cfg.dtype)


def check_model_options(cfg: TrainConfig) -> None:
    """Refuse what the configured model cannot do, before any work."""
    if cfg.model not in MODEL_KINDS:
        raise ValueError(f"unknown model {cfg.model!r}; the port has {list(MODEL_KINDS)}")
    if cfg.model != "unet" and cfg.spatial_partitions > 1:
        raise ValueError(f"{cfg.model} cannot be spatially partitioned (--spatial "
                         f"{cfg.spatial_partitions}): its attention is global over the tile, "
                         "which a halo exchange cannot split; train it data-parallel")


def train_model(config: TrainConfig) -> TrainResult:
    cfg = config
    check_model_options(cfg)
    print(f"model = {cfg.model}")
    print(f"batch_size = {cfg.batch_size}")
    print(f"number_classes = {cfg.number_classes}")
    print(f"learning_rate = {cfg.learning_rate}")
    print(f"test_every_n_steps = {cfg.test_every_n_steps}")
    print(f"balance_classes = {cfg.balance_classes}")
    print(f"use_augmentation = {cfg.use_augmentation}")
    print(f"train_database = {cfg.train_database}")
    print(f"test_database = {cfg.test_database}")
    print(f"output folder = {cfg.output_folder}")
    print(f"early_stopping count = {cfg.early_stopping_count}")
    print(f"reader_count = {cfg.reader_count}")

    if cfg.spatial_partitions < 1:
        raise ValueError(f"spatial_partitions must be >= 1, got {cfg.spatial_partitions}")
    device = _train_device(cfg)
    print(f"device = {device}")
    mesh = mesh_lib.make_mesh(device, spatial=cfg.spatial_partitions)
    rank = mesh.rank
    # a replica is one spatial group, so replicas are the data shards
    global_batch_size = cfg.batch_size * mesh.data
    local_batch_size = distributed.process_local_batch_size(global_batch_size,
                                                            data_shards=mesh.data)
    print(f"devices = {mesh.world} over {distributed.host_count()} host(s), "
          f"global_batch_size = {global_batch_size}")
    os.makedirs(cfg.output_folder, exist_ok=True)
    raw = cfg.device_augment
    # the spatial group's first rank reads and broadcasts (mesh.spatial_feed)
    reads = mesh.spatial_rank == 0

    # readers striped by data shard: seeded shuffled streams differ per
    # shard and the strided test walk partitions the keys over the shards
    host_kw = dict(process_index=mesh.data_rank, process_count=mesh.data)
    print("Setting up test image reader")
    test_reader = ImageReader(
        cfg.test_database, use_augmentation=False, shuffle=False,
        num_workers=cfg.reader_count, balance_classes=False,
        number_classes=cfg.number_classes, layout="nhwc", seed=cfg.seed, raw_mode=raw,
        **host_kw)
    print(f"Test Reader has {test_reader.get_image_count()} images")

    print("Setting up training image reader")
    train_reader = ImageReader(
        cfg.train_database, use_augmentation=cfg.use_augmentation and not raw,
        shuffle=True, num_workers=cfg.reader_count,
        balance_classes=cfg.balance_classes, number_classes=cfg.number_classes,
        layout="nhwc", seed=cfg.seed, augment_params=cfg.augment_params, raw_mode=raw,
        **host_kw)
    print(f"Train Reader has {train_reader.get_image_count()} images")

    if mesh.spatial > 1:
        level = split_level(train_reader.get_image_size()[0], mesh.spatial)
        print("spatial partitioning: every pool on one rank" if level is None else
              f"spatial partitioning: rows gathered at level {level}, before pool "
              f"{level + 1} (its window would straddle two ranks)")
    model = _build_model(cfg, train_reader.get_image_size())
    state = create_train_state(model, _device_seed(cfg.seed), cfg.learning_rate, device)
    resumed = False
    resumed_history: List[float] = []
    if cfg.resume_checkpoint:
        # every process restores host-locally
        restore_train_state(cfg.resume_checkpoint, state)
        resumed = state.step > 0
        print(f"Resumed training state from {cfg.resume_checkpoint} at step {state.step}")
        resumed_history = _resumed_history(cfg)
    mesh_lib.replicate_state(state, mesh)
    if raw:
        tstep, estep = mesh_lib.make_parallel_raw_steps(
            model, mesh, cfg.number_classes, _device_params(cfg.augment_params),
            augment=cfg.use_augmentation, label_smoothing=cfg.label_smoothing,
            shard_optimizer=cfg.shard_optimizer, state=state)
    else:
        tstep, estep = mesh_lib.make_parallel_steps(
            model, mesh, cfg.label_smoothing, shard_optimizer=cfg.shard_optimizer,
            state=state)
    mesh_lib.warm_collectives(mesh)

    checkpoint_path = os.path.join(cfg.output_folder, "checkpoint", "ckpt")
    train_epoch_size = cfg.test_every_n_steps  # train.py:99
    test_epoch_size = test_reader.get_image_count() / cfg.batch_size  # train.py:100
    test_loss: List[float] = list(resumed_history)
    train_losses: List[float] = []
    ckpt_writer = AsyncCheckpointWriter()
    meter = ThroughputMeter()
    train_iter = None
    profile_ctx = profiler = None
    train_writer, test_writer = _summary_writers(cfg.output_folder)

    try:
        def batches(reader):
            # the group's first rank reads; the others receive its batches
            it = device_prefetch(reader.batches(local_batch_size), device) if reads else None
            return mesh_lib.spatial_feed(it, mesh)

        if reads:
            print("Starting Readers")
            train_reader.startup()
            test_reader.startup()
        train_iter = _barrier_after_first(batches(train_reader), "tpuseg_torch:first-batch")

        # resumed runs continue the epoch numbering and skip the lr/10
        # warmup epoch — the restored optimizer is already warm
        epoch = len(resumed_history)
        best_epoch = 0
        saved_checkpoint = False
        final_train_loss = float("nan")
        print("Running Network")
        while True:
            print(f"---- Epoch: {epoch} ----")
            if epoch == 0 and not resumed:
                cur_train_epoch_size = min(cfg.warmup_steps_cap, train_epoch_size)
                print(f"Performing Adam Optimizer learning rate warmup for "
                      f"{cur_train_epoch_size} steps")
                state.lr = cfg.learning_rate / 10
            else:
                cur_train_epoch_size = train_epoch_size
                state.lr = cfg.learning_rate

            if cfg.profile_steps and epoch == 1 and rank == 0:
                # epoch 1 = the first steady-state epoch (epoch 0 warms up)
                from tpuseg_torch.utils.profiling import trace

                profile_ctx = trace(os.path.join(cfg.output_folder, "profile"), device)
                profiler = profile_ctx.__enter__()
                print(f"Profiling {cfg.profile_steps} steps -> {cfg.output_folder}/profile")

            start_time = time.time()
            log_every = max(1, int(cfg.log_every_n_steps))
            echo = max(1, int(cfg.batch_echo))
            win_loss = win_acc = None
            win_count = 0
            win_images = 0  # data actually fetched (echoed steps reuse it)
            # reference runs steps 0..size inclusive (break on step > size)
            for step in range(cur_train_epoch_size + 1):
                if step % echo == 0:
                    try:
                        images, labels = next(train_iter)
                    except StopIteration:
                        raise RuntimeError(
                            "train stream ended: a train reader worker died (see the "
                            "Reader Error banner above) or the train database is "
                            "smaller than one batch") from None
                    win_images += global_batch_size
                metrics = tstep(state, images, labels)
                # device-side accumulation: lazy adds, no host sync
                win_loss = metrics["loss"] if win_loss is None else win_loss + metrics["loss"]
                win_acc = (metrics["accuracy"] if win_acc is None
                           else win_acc + metrics["accuracy"])
                win_count += 1
                # profiling reads every step back, to close at an exact step
                if (step % log_every == log_every - 1 or step == cur_train_epoch_size
                        or profile_ctx is not None):
                    loss = win_loss.item() / win_count  # syncs the step chain
                    acc = win_acc.item() / win_count
                    meter.update(win_images)
                    print(f"Train Epoch {epoch}: Batch {step}/{train_epoch_size}: "
                          f"Loss {loss} Accuracy = {acc}")
                    global_step = int(epoch * train_epoch_size + step)
                    train_writer.add_scalar("loss", loss, global_step)
                    train_writer.add_scalar("accuracy", acc, global_step)
                    if meter.images_per_sec:
                        train_writer.add_scalar("images_per_sec", meter.images_per_sec,
                                                global_step)
                    train_losses.append(loss)
                    final_train_loss = loss
                    win_loss = win_acc = None
                    win_count = 0
                    win_images = 0
                if profile_ctx is not None:
                    # at the requested step count, or at the epoch's end if
                    # the epoch is shorter: never record into later epochs
                    if step + 1 >= cfg.profile_steps or step == cur_train_epoch_size:
                        profile_ctx.__exit__(None, None, None)
                        profile_ctx = profiler = None
                    else:
                        profiler.step()
            if meter.images_per_sec:
                print(f"Train images/s (last {meter.window} windows): {meter.images_per_sec}")

            # test epoch (train.py:152-171); the iterator is closed so its
            # producer thread stops consuming the shared reader queue
            sum_loss = sum_acc = None
            n_eval = 0
            test_iter = batches(test_reader)
            try:
                for _ in range(int(test_epoch_size) + 1):
                    try:
                        images, labels = next(test_iter)
                    except StopIteration:
                        break
                    m = estep(state, images, labels)
                    sum_loss = m["loss"] if sum_loss is None else sum_loss + m["loss"]
                    sum_acc = m["accuracy"] if sum_acc is None else sum_acc + m["accuracy"]
                    n_eval += 1
            finally:
                test_iter.close()
            if not n_eval:
                raise RuntimeError(
                    "test epoch produced no batches — the test readers died or the "
                    "test database is smaller than one batch")
            test_loss.append(sum_loss.item() / n_eval)
            mean_acc = sum_acc.item() / n_eval
            print(f"Test Epoch: {epoch}: Loss = {test_loss[-1]} Accuracy = {mean_acc}")
            test_writer.add_scalar("loss", test_loss[-1], int((epoch + 1) * train_epoch_size))
            test_writer.add_scalar("accuracy", mean_acc, int((epoch + 1) * train_epoch_size))

            if rank == 0:  # peers would clobber the same file
                with open(os.path.join(cfg.output_folder, "test_loss.csv"), "w") as csvfile:
                    for v in test_loss:
                        csvfile.write(str(v) + "\n")

            print(f"Epoch took: {time.time() - start_time} s")

            # checkpoint-on-best (train.py:181-184), in the background. A
            # non-finite loss never saves and never counts as best: argmin
            # would select a NaN and overwrite the stored best checkpoint.
            # The test loss is global, so every rank decides alike (a ZeRO-1
            # save gathers the moments from every rank; rank 0 writes)
            if (np.isfinite(test_loss[-1])
                    and (len(test_loss) - 1) == int(np.nanargmin(test_loss))):
                print(f"Test loss improved: {np.nanmin(test_loss)}, saving checkpoint")
                ckpt_writer.save(checkpoint_path, state)
                saved_checkpoint = True

            # early stopping (train.py:187-199)
            print("Best Current Epoch Selection:")
            print("Test Loss:")
            print(test_loss)
            if not np.isfinite(test_loss).any():
                raise RuntimeError("training diverged: every test loss is non-finite")
            min_test_loss = np.nanmin(test_loss)
            error_from_best = np.abs(np.asarray(test_loss) - min_test_loss)
            error_from_best[~np.isfinite(error_from_best)] = np.inf
            error_from_best[error_from_best < CONVERGENCE_TOLERANCE] = 0
            best_epoch = int(np.where(error_from_best == 0)[0][0])
            print(f"Best epoch: {best_epoch}")

            if len(test_loss) - best_epoch > cfg.early_stopping_count:
                break
            if cfg.max_epochs is not None and epoch + 1 >= cfg.max_epochs:
                if resumed_history:
                    print(f"max_epochs={cfg.max_epochs} reached — the cap counts TOTAL "
                          f"epochs including the {len(resumed_history)} resumed from history")
                break
            epoch += 1
        # leave together: no process may act on this run's artifacts (resume
        # from the checkpoint) before rank 0's write has landed
        ckpt_writer.wait()
        distributed.host_barrier("tpuseg_torch:train-exit")
    finally:
        # reader shutdown must be unconditional: the forkserver workers are
        # non-daemon and loop forever, so skipping it (e.g. because a
        # background write re-raised) would hang the process at exit
        try:
            if profile_ctx is not None:
                profile_ctx.__exit__(None, None, None)
            ckpt_writer.wait()  # flush any in-flight checkpoint write
            if train_iter is not None:
                train_iter.close()
        finally:
            print("Shutting down train_reader")
            train_reader.shutdown()
            print("Shutting down test_reader")
            test_reader.shutdown()
            train_writer.close()
            test_writer.close()

    if not saved_checkpoint:
        # nothing was written to this run's output dir: don't hand callers
        # a path that does not exist
        if cfg.resume_checkpoint:
            print("No epoch improved on the resumed history — "
                  "TrainResult.checkpoint_path points at the resume checkpoint, "
                  "which remains the best")
            checkpoint_path = cfg.resume_checkpoint
        else:
            print(f"WARNING: no checkpoint was written this run; {checkpoint_path} "
                  "does not exist")

    return TrainResult(
        test_loss=test_loss,
        best_epoch=best_epoch,
        epochs_run=epoch + 1,
        checkpoint_path=checkpoint_path,
        final_train_loss=final_train_loss,
        train_losses=train_losses,
        steps=state.step,
        images_per_sec=meter.images_per_sec,
    )
