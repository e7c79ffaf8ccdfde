"""The port's checkpoints: ``torch.save``d dicts, written atomically.

- :func:`save_model` writes ``{"model", "config", "state_dict"}``: the
  model's kind (``models.MODEL_KINDS``: ``unet`` or ``transunet_r50_b16``),
  its constructor arguments (its ``config()``) and its weights. A file
  without ``"model"`` holds a U-Net, as every checkpoint did before the
  port had a second model.
- A training checkpoint (:class:`AsyncCheckpointWriter`, which the
  trainer calls, at ``<output>/checkpoint/ckpt``) holds the same two keys
  plus the optimizer state (moments, step count, lr), the step, the lr and
  both generator states — everything :func:`restore_train_state` needs to
  resume. A data-parallel run's checkpoint is the same file, written by
  rank 0 alone (a ZeRO-1 optimizer's shards gathered into ``KerasAdam``'s
  layout), so it resumes on any number of GPUs.

:func:`load_model` reads either kind, so a trained checkpoint serves
through ``tpuseg_torch.cli.inference`` as it is. A reference TensorFlow
checkpoint becomes a training checkpoint through
``tpuseg_torch.cli.import_checkpoint`` (no TensorFlow needed) and goes back
through ``cli.export_checkpoint``; the JAX package's orbax checkpoints need
jax to read, so ``scripts/convert_orbax_checkpoint.py`` converts them both
ways beside ``tpuseg`` (:mod:`tpuseg_torch.utils.jax_bridge` maps the
variables).
"""

from __future__ import annotations

import os
import threading
from typing import Optional, Union

import torch

from tpuseg_torch.models import build_model
from tpuseg_torch.parallel.distributed import process_index


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


def write_checkpoint(path: str, doc: dict) -> None:
    """``torch.save`` ``doc`` to ``path`` through a temp file and
    ``os.replace``: a reader never sees half a file."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp"
    torch.save(doc, tmp)
    os.replace(tmp, path)


def save_model(path: str, model: torch.nn.Module) -> None:
    """Write ``model``'s kind, config and weights (CPU tensors) to ``path``,
    atomically (temp file + ``os.replace``)."""
    write_checkpoint(path, {"model": model.kind, "config": model.config(),
                            "state_dict": _to_cpu(model.state_dict())})


def load_model(path: str, dtype: Union[str, torch.dtype] = torch.bfloat16,
               device: Union[str, torch.device] = "cpu") -> torch.nn.Module:
    """Rebuild the model a :func:`save_model` file or a training checkpoint
    describes (a U-Net where it names no kind), restore its weights
    (model.py:81-83), and return it in eval mode on ``device``."""
    doc = torch.load(path, map_location="cpu", weights_only=True)
    model = build_model(doc.get("model", "unet"), dtype=dtype, **doc["config"])
    model.load_state_dict(doc["state_dict"])
    return model.to(device).eval()


def _is_zero(optimizer) -> bool:
    from torch.distributed.optim import ZeroRedundancyOptimizer

    return isinstance(optimizer, ZeroRedundancyOptimizer)


# the keys of a KerasAdam parameter group besides its parameters
_ADAM_GROUP_KEYS = ("lr", "betas", "eps", "step")


def optimizer_state(optimizer) -> Optional[dict]:
    """The optimizer's state dict in ``KerasAdam``'s own layout. A ZeRO-1
    optimizer's shards are gathered to rank 0 (every rank must call this)
    and mapped to that layout — moments keyed by the parameter's index in
    the model, one parameter group — so its checkpoint resumes in a
    single-GPU run and the reverse; ranks other than 0 get None."""
    if not _is_zero(optimizer):
        return optimizer.state_dict()
    optimizer.consolidate_state_dict(to=0)
    if process_index() != 0:
        return None
    sd = optimizer.state_dict()
    groups = [{**{k: g[k] for k in _ADAM_GROUP_KEYS}, "params": list(g["params"])}
              for g in sd["param_groups"]]
    return {"state": {i: st for i, st in sd["state"].items() if st is not None},
            "param_groups": groups}


def train_checkpoint(state) -> Optional[dict]:
    """A training checkpoint of ``state`` (a ``train.steps.TrainState``),
    snapshotted to the CPU: the caller may go on updating the state in
    place as soon as this returns. Under a process group every rank calls
    it (a ZeRO-1 optimizer gathers its shards) and only rank 0 gets the
    checkpoint; the others get None."""
    opt = optimizer_state(state.optimizer)
    if process_index() != 0:
        return None
    return {
        "model": state.model.kind,
        "config": state.model.config(),
        "state_dict": _to_cpu(state.model.state_dict()),
        "optimizer": _to_cpu(opt),
        "step": int(state.step),
        "lr": float(state.lr),
        "rng": {"augment": state.aug_generator.get_state(),
                "dropout": state.dropout_generator.get_state()},
    }


def restore_train_state(path: str, state):
    """Load a training checkpoint into ``state`` in place (weights,
    optimizer, step, lr, and the generators where it holds them) and
    return it. The checkpoint's model must have ``state``'s configuration.
    Every process restores host-locally; a ZeRO-1 optimizer keeps only its
    partition's moments."""
    doc = torch.load(path, map_location="cpu", weights_only=True)
    if "optimizer" not in doc:
        raise ValueError(f"{path} is a model checkpoint, not a training checkpoint: "
                         "it holds no optimizer state to resume from")
    held = (doc.get("model", "unet"), doc["config"])
    built = (state.model.kind, state.model.config())
    if held != built:
        raise ValueError(f"{path} holds a {held[0]} {held[1]}, but the run builds a "
                         f"{built[0]} {built[1]}")
    state.model.load_state_dict(doc["state_dict"])
    state.optimizer.load_state_dict(doc["optimizer"])
    if "rng" in doc:  # an imported checkpoint has none: the run's seed draws
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
            write_checkpoint(path, doc)
        except BaseException as e:  # re-raised on the caller's thread
            self._error = e

    def save(self, path: str, state) -> None:
        """Snapshot ``state`` and write it in the background. Under a
        process group every rank calls this and rank 0 alone writes."""
        self.wait()
        doc = train_checkpoint(state)
        if doc is None:
            return
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
