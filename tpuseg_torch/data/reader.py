"""Parallel data engine: multiprocess readers over a tsrstore database.

The port's own copy of ``tpuseg/data/reader.py`` (reference
``imagereader.ImageReader``, imagereader.py:77-355): N forkserver worker
processes, each with its own zero-copy view of the store, feed a bounded
output queue with starvation telemetry. In **raw mode** workers ship compact
raw (uint16/uint8) samples and augmentation/normalize/one-hot run on the
card inside the train step (``tpuseg_torch.aug.device``); otherwise they
run the host augmentation (``tpuseg_torch.aug.host``), z-score and one-hot.

The module imports neither torch nor anything that does, so the workers
start without loading torch. Sampling (shuffle, class balance, the
worker-strided walk that restarts instead of wrapping) and the per-worker
seeds are the JAX package's, so a seeded reader yields the same samples in
the same order in both packages.
"""

from __future__ import annotations

import multiprocessing
import queue as pyqueue
import random
import time
import traceback
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np

from tpuseg_torch import SIZE_FACTOR
from tpuseg_torch.aug.host import augment_image
from tpuseg_torch.data.build_db import deserialize_image_mask_pair
from tpuseg_torch.data.preprocess import one_hot_labels, zscore_normalize
from tpuseg_torch.data.recordstore import RecordReader


@dataclass(frozen=True)
class AugmentParams:
    """Reference defaults from imagereader.py:79-85."""

    reflection_flag: bool = True
    rotation_flag: bool = True
    jitter_augmentation_severity: float = 0.1  # fraction of the FOV
    noise_augmentation_severity: float = 0.02  # fraction of dynamic range
    scale_augmentation_severity: float = 0.1
    blur_max_sigma: float = 2.0  # pixels
    intensity_augmentation_severity: Optional[float] = None


class ImageReader:
    def __init__(
        self,
        img_db: str,
        use_augmentation: bool = True,
        balance_classes: bool = False,
        shuffle: bool = True,
        num_workers: int = 1,
        number_classes: int = 2,
        augment_params: AugmentParams = AugmentParams(),
        queue_depth_per_worker: int = 100,  # imagereader.py:100
        raw_mode: bool = False,
        layout: str = "nchw",  # reference contract; "nhwc" for the trainer
        seed: Optional[int] = None,
        process_index: int = 0,
        process_count: int = 1,
    ):
        self.image_db = img_db
        self.use_augmentation = use_augmentation
        self.balance_classes = balance_classes
        self.shuffle = shuffle
        self.nb_workers = num_workers
        self.nb_classes = number_classes
        self.augment_params = augment_params
        self.raw_mode = raw_mode
        if layout not in ("nchw", "nhwc"):
            raise ValueError(f"layout must be 'nchw' or 'nhwc', got {layout}")
        self.layout = layout
        self.seed = seed
        if not (0 <= process_index < process_count):
            raise ValueError(
                f"process_index {process_index} out of range for "
                f"process_count {process_count}")
        self.process_index = process_index
        self.process_count = process_count

        self.queue_starvation = False
        self.maxOutQSize = num_workers * queue_depth_per_worker
        self.workers: Optional[list] = None

        # forkserver, not fork: the parent runs torch/CUDA and prefetch
        # threads, and forking a threaded process can hand the child a locked
        # mutex. The forkserver daemon is a clean exec'd python, so children
        # inherit no locks; and unlike 'spawn', children unpickle this module
        # rather than re-importing __main__, so unguarded user scripts don't
        # re-execute. Worker imports are torch-free => fast startup.
        # Queues are created by startup() (fresh ones per run); placeholders
        # here only make pre-startup misuse fail with a clear None error.
        self._mp = multiprocessing.get_context("forkserver")
        self.terminateQ = None
        self.outQ = None
        self.idQ = None

        # probe the database: image geometry, %16 contract, key index
        store = RecordReader(self.image_db)
        try:
            self.keys_flat: List[bytes] = store.keys()
            self.num_keys = len(self.keys_flat)
            if not self.keys_flat:
                raise IOError(f"empty database: {img_db}")
            img, _ = deserialize_image_mask_pair(store.get_at(0))
            self.image_size = [img.shape[0], img.shape[1], img.shape[2]]
            if self.image_size[0] % SIZE_FACTOR != 0 or self.image_size[1] % SIZE_FACTOR != 0:
                raise IOError(
                    "Input Image tile height needs to be a multiple of 16 to allow "
                    "integer sized downscaled feature maps. Input images should be "
                    "either HW or HWC dimension ordering")

            # per-class key index for balanced sampling (imagereader.py:141-154)
            self.keys: List[List[bytes]] = [[]]
            if self.balance_classes:
                for key in self.keys_flat:
                    present = key.decode("ascii").split(":")[1].split(",")
                    for k_str in present:
                        k = int(k_str)
                        while len(self.keys) <= k:
                            self.keys.append([])
                        self.keys[k].append(key)
                # fail here, not in the workers: if no in-range class has a
                # single example, the balanced re-draw loop could never
                # terminate (workers would spin without polling terminateQ)
                if not any(self.keys[i]
                           for i in range(min(self.nb_classes, len(self.keys)))):
                    raise IOError(
                        f"balance_classes: none of classes 0..{self.nb_classes - 1} "
                        f"has any examples in {img_db} (observed classes: "
                        f"{[i for i, ks in enumerate(self.keys) if ks]})")
        finally:
            store.close()

        print(f"Dataset has {len(self.keys_flat)} examples")
        if self.balance_classes:
            print("Dataset Example Count by Class:")
            for i, ks in enumerate(self.keys):
                print(f"  class: {i} count: {len(ks)}")

    # --- geometry accessors (imagereader.py:161-173) ---

    def get_image_count(self) -> int:
        return self.num_keys

    def get_image_size(self):
        return self.image_size

    def get_image_tensor_shape(self):
        if self.layout == "nchw":
            return [self.image_size[2], self.image_size[0], self.image_size[1]]
        return [self.image_size[0], self.image_size[1], self.image_size[2]]

    def get_label_tensor_shape(self):
        return [self.image_size[0], self.image_size[1]]

    # --- worker lifecycle (imagereader.py:175-207) ---

    def __getstate__(self):
        """Spawned workers pickle this object as the Process target; the
        process handles and mp context stay behind. Non-balanced workers
        never look keys up by value, so the key lists stay behind too —
        shipping a large database's full key space through the forkserver
        once per worker was pure startup IPC."""
        state = self.__dict__.copy()
        state["workers"] = None
        state["_mp"] = None
        state.pop("_key_pos_cache", None)
        if not self.balance_classes:
            state["keys_flat"] = []
            state["keys"] = [[]]
        return state

    def startup(self) -> None:
        if self.workers:
            # a second startup would orphan the first worker set (rebound
            # self.workers, replaced queues): unreachable live processes
            # that hang interpreter exit
            raise RuntimeError(
                "ImageReader.startup() called while workers are running; "
                "call shutdown() first")
        self.workers = None
        # fresh queues every run: after a shutdown the old outQ still holds
        # the workers' final None sentinels (and possibly stale batches), and
        # terminateQ may hold unconsumed stop tokens — either would end or
        # poison a restarted stream instantly
        self.terminateQ = self._mp.Queue(maxsize=self.nb_workers)
        self.outQ = self._mp.Queue(maxsize=self.maxOutQSize)
        self.idQ = self._mp.Queue(maxsize=self.nb_workers)
        for i in range(self.nb_workers):
            self.idQ.put(i)
        self.workers = [
            self._mp.Process(target=self._image_loader) for _ in range(self.nb_workers)
        ]
        for w in self.workers:
            w.start()

    def shutdown(self, timeout: float = 30.0) -> None:
        """Stop workers and drain the output queue.

        Termination is decided by worker liveness, not by counting None
        sentinels (the reference's protocol, imagereader.py:188-207): any
        concurrent consumer — e.g. a prefetch thread — may steal sentinels,
        which would spin a count-based drain forever. Stuck workers are
        terminated after ``timeout``."""
        if not self.workers:
            return
        for _ in self.workers:
            self.terminateQ.put(None)
        deadline = time.time() + timeout
        # keep draining so workers blocked in outQ.put can reach the
        # terminate check and exit
        while any(w.is_alive() for w in self.workers) and time.time() < deadline:
            try:
                self.outQ.get(timeout=0.05)
            except pyqueue.Empty:
                pass
        for w in self.workers:
            w.join(timeout=5.0)
            if w.is_alive():
                print(f"ImageReader: terminating unresponsive worker {w.pid}")
                w.terminate()
                w.join(timeout=5.0)
        self.workers = None

    # --- sampling (imagereader.py:209-243) ---

    def _next_index(self, rng: random.Random) -> int:
        """Index into keys_flat for the next sample."""
        if self.shuffle:
            if self.balance_classes:
                nb_examples = 0
                while nb_examples == 0:
                    label_idx = rng.randint(0, self.nb_classes - 1)
                    try:
                        # guard every draw, not just the first — the
                        # reference wraps the whole access (imagereader.py:221-229)
                        nb_examples = len(self.keys[label_idx])
                    except IndexError:
                        print("ImageReader Error: Number of classes specified "
                              "differs from number of observed classes in data")
                        raise
                key = self.keys[label_idx][rng.randint(0, nb_examples - 1)]
                return self._key_pos[key]
            return rng.randint(0, self.num_keys - 1)
        idx = self.key_idx
        # restart, don't mod-wrap: ``(idx + T) % N`` drifts workers onto
        # shared gcd(T, N) cosets whenever T does not divide N — duplicating
        # keys across the fleet and never visiting others. Each
        # worker owns exactly its residue class and replays it
        self.key_idx += self.nb_workers * self.process_count
        if self.key_idx >= self.num_keys:
            self.key_idx = self._walk_start
        return idx

    def _init_worker_sampling(self, worker_id: int):
        """Per-worker sampling state: the global stride start and the RNGs.

        The global worker id ``process_index*nb_workers + worker_id`` drives
        both the no-shuffle interleave (the host-level generalization of the
        reference's worker-strided walk, imagereader.py:239-241) and the
        seeded RNG streams, so no two workers anywhere in a multi-host fleet
        share a stream. Returns ``(rng, nprng)``; sets ``self.key_idx``."""
        global_worker_id = self.process_index * self.nb_workers + worker_id
        # wrapped so more workers than records is safe (the reference indexes
        # keys_flat[worker_id] raw, imagereader.py:247, and crashes there)
        self._walk_start = global_worker_id % self.num_keys
        self.key_idx = self._walk_start
        seed = None if self.seed is None else self.seed + global_worker_id
        return random.Random(seed), np.random.default_rng(seed)

    @property
    def _key_pos(self):
        pos = getattr(self, "_key_pos_cache", None)
        if pos is None:
            pos = {k: i for i, k in enumerate(self.keys_flat)}
            self._key_pos_cache = pos
        return pos

    # --- the worker hot loop (imagereader.py:245-325) ---

    def _image_loader(self) -> None:
        termination = False
        worker_id = self.idQ.get()
        rng, nprng = self._init_worker_sampling(worker_id)
        try:
            store = RecordReader(self.image_db)  # own zero-copy view per process
            ap = self.augment_params

            while not termination:
                try:
                    if self.terminateQ.get_nowait() is None:
                        termination = True
                        break
                except pyqueue.Empty:
                    pass

                idx = self._next_index(rng)
                img, msk = deserialize_image_mask_pair(store.get_at(idx))

                if self.raw_mode:
                    # compact raw sample; augment/normalize/one-hot happen on device
                    self.outQ.put((img, msk))
                    continue

                if self.use_augmentation:
                    img, msk = augment_image(
                        img.astype(np.float32), msk,
                        reflection_flag=ap.reflection_flag,
                        rotation_flag=ap.rotation_flag,
                        jitter_augmentation_severity=ap.jitter_augmentation_severity,
                        noise_augmentation_severity=ap.noise_augmentation_severity,
                        scale_augmentation_severity=ap.scale_augmentation_severity,
                        blur_augmentation_max_sigma=ap.blur_max_sigma,
                        intensity_augmentation_severity=ap.intensity_augmentation_severity,
                        rng=nprng,
                    )

                if self.layout == "nhwc":
                    # normalize in HWC directly (per-channel stats are
                    # layout-independent) — the old CHW round trip paid two
                    # full-image transposed copies per sample
                    img = zscore_normalize(img.astype(np.float32),
                                           channels_first=False)
                else:
                    img = zscore_normalize(
                        img.transpose((2, 0, 1)).astype(np.float32))
                oh = one_hot_labels(msk.astype(np.int32), self.nb_classes)
                self.outQ.put((img, oh))
        except Exception as e:
            print("***************** Reader Error *****************")
            print(e)
            traceback.print_exc()
            print("***************** Reader Error *****************")
        finally:
            self.outQ.put(None)  # shutdown confirmation sentinel

    # --- consumption (imagereader.py:327-355) ---

    def get_example(self):
        qsize = self.outQ.qsize()
        if qsize < int(0.1 * self.maxOutQSize):
            if not self.queue_starvation:
                print("Input Queue Starvation !!!!")
            self.queue_starvation = True
        if self.queue_starvation and qsize > int(0.5 * self.maxOutQSize):
            print("Input Queue Starvation Over")
            self.queue_starvation = False
        return self.outQ.get()

    def generator(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        while True:
            batch = self.get_example()
            if batch is None:
                return
            yield batch

    def get_queue_size(self) -> int:
        return self.outQ.qsize()

    def batches(self, batch_size: int) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Stacked numpy batches — the tf.data.batch() equivalent
        (train.py:85). Infinite while workers run."""
        gen = self.generator()
        while True:
            imgs, lbls = [], []
            for _ in range(batch_size):
                try:
                    img, lbl = next(gen)
                except StopIteration:
                    return
                imgs.append(img)
                lbls.append(lbl)
            yield np.stack(imgs), np.stack(lbls)

    def __enter__(self):
        self.startup()
        return self

    def __exit__(self, *exc):
        self.shutdown()
