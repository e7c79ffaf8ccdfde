"""The port's checkpoints: ``torch.save``d dicts, written atomically.

- :func:`save_model` writes ``{"config", "state_dict"}``: the U-Net's
  constructor arguments (:meth:`UNet.config`) and its weights.
- A training checkpoint (:class:`AsyncCheckpointWriter`, which the
  trainer calls, at ``<output>/checkpoint/ckpt``) holds the same two keys
  plus the optimizer state (moments, step count, lr), the step, the lr and
  both generator states — everything :func:`restore_train_state` needs to
  resume.

:func:`load_model` reads either kind, so a trained checkpoint serves
through ``tpuseg_torch.cli.inference`` as it is. Orbax checkpoints of the
JAX package need jax to read; converting them waits for the tooling slice —
until then :mod:`tpuseg_torch.utils.jax_bridge` maps in-memory flax
variables.
"""

from __future__ import annotations

import os
import threading
from typing import Optional, Union

import torch

from tpuseg_torch.models.unet import UNet


def _to_cpu(obj):
    """A copy of ``obj`` with every tensor copied to the CPU, so a later
    in-place update on the device cannot reach it."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def _write(path: str, doc: dict) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp"
    torch.save(doc, tmp)
    os.replace(tmp, path)  # a reader never sees half a file


def save_model(path: str, model: UNet) -> None:
    """Write ``model``'s config and weights (CPU tensors) to ``path``,
    atomically (temp file + ``os.replace``)."""
    _write(path, {"config": model.config(), "state_dict": _to_cpu(model.state_dict())})


def load_model(path: str, dtype: Union[str, torch.dtype] = torch.bfloat16,
               device: Union[str, torch.device] = "cpu") -> UNet:
    """Rebuild the U-Net a :func:`save_model` file or a training checkpoint
    describes, restore its weights (model.py:81-83), and return it in eval
    mode on ``device``."""
    doc = torch.load(path, map_location="cpu", weights_only=True)
    model = UNet(dtype=dtype, **doc["config"])
    model.load_state_dict(doc["state_dict"])
    return model.to(device).eval()


def train_checkpoint(state) -> dict:
    """A training checkpoint of ``state`` (a ``train.steps.TrainState``),
    snapshotted to the CPU: the caller may go on updating the state in
    place as soon as this returns."""
    return {
        "config": state.model.config(),
        "state_dict": _to_cpu(state.model.state_dict()),
        "optimizer": _to_cpu(state.optimizer.state_dict()),
        "step": int(state.step),
        "lr": float(state.lr),
        "rng": {"augment": state.aug_generator.get_state(),
                "dropout": state.dropout_generator.get_state()},
    }


def restore_train_state(path: str, state):
    """Load a training checkpoint into ``state`` in place (weights,
    optimizer, step, lr, generators) and return it. The checkpoint's model
    must have ``state``'s configuration."""
    doc = torch.load(path, map_location="cpu", weights_only=True)
    if "optimizer" not in doc:
        raise ValueError(f"{path} is a model checkpoint, not a training checkpoint: "
                         "it holds no optimizer state to resume from")
    if doc["config"] != state.model.config():
        raise ValueError(f"{path} holds a U-Net {doc['config']}, but the run builds "
                         f"{state.model.config()}")
    state.model.load_state_dict(doc["state_dict"])
    state.optimizer.load_state_dict(doc["optimizer"])
    state.aug_generator.set_state(doc["rng"]["augment"])
    state.dropout_generator.set_state(doc["rng"]["dropout"])
    state.step = int(doc["step"])
    state.lr = float(doc["lr"])
    return state


class AsyncCheckpointWriter:
    """Background-thread checkpoint writer.

    JAX's writer hands the thread immutable arrays. The port's optimizer
    updates the state in place, so :meth:`save` snapshots the state to the
    CPU before it returns, and only the file write goes to the thread. Only
    one write is in flight — a new request waits for the previous one,
    which keeps best-checkpoint ordering.

    A failed background write re-raises at the next :meth:`save` or
    :meth:`wait`: a swallowed exception would let training finish
    "successfully" with a missing or stale checkpoint.
    """

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _run(self, path: str, doc: dict) -> None:
        try:
            _write(path, doc)
        except BaseException as e:  # re-raised on the caller's thread
            self._error = e

    def save(self, path: str, state) -> None:
        self.wait()
        doc = train_checkpoint(state)
        self._thread = threading.Thread(target=self._run, args=(path, doc), daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join any in-flight write; re-raises its failure."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise RuntimeError("background checkpoint write failed") from error
