"""The port's checkpoint: a ``torch.save``d ``{"config", "state_dict"}``.

``config`` holds the U-Net's constructor arguments (:meth:`UNet.config`),
so a checkpoint rebuilds its own model. Orbax checkpoints of the JAX
package need jax to read; converting them waits for the tooling slice —
until then :mod:`tpuseg_torch.utils.jax_bridge` maps in-memory flax
variables.
"""

from __future__ import annotations

import os
from typing import Union

import torch

from tpuseg_torch.models.unet import UNet


def save_model(path: str, model: UNet) -> None:
    """Write ``model``'s config and weights (CPU tensors) to ``path``,
    atomically (temp file + ``os.replace``)."""
    doc = {"config": model.config(),
           "state_dict": {k: v.detach().cpu() for k, v in model.state_dict().items()}}
    tmp = f"{path}.tmp"
    torch.save(doc, tmp)
    os.replace(tmp, path)


def load_model(path: str, dtype: Union[str, torch.dtype] = torch.bfloat16,
               device: Union[str, torch.device] = "cpu") -> UNet:
    """Rebuild the U-Net a :func:`save_model` file describes, restore its
    weights (model.py:81-83), and return it in eval mode on ``device``."""
    doc = torch.load(path, map_location="cpu", weights_only=True)
    model = UNet(dtype=dtype, **doc["config"])
    model.load_state_dict(doc["state_dict"])
    return model.to(device).eval()
