"""The port's models, by the kind a checkpoint stores: ``unet``
(:class:`models.unet.UNet`, the default, and the kind of a checkpoint that
names none) and ``transunet_r50_b16`` (:class:`models.transunet.TransUNet`)."""

from __future__ import annotations

import torch

MODEL_KINDS = ("unet", "transunet_r50_b16")


def _check(kind: str) -> None:
    if kind not in MODEL_KINDS:
        raise ValueError(f"unknown model kind {kind!r}; the port has {list(MODEL_KINDS)}")


def build_model(kind: str, **kwargs) -> torch.nn.Module:
    """The model of ``kind`` from its constructor arguments (a checkpoint's
    ``config``, and the dtype)."""
    _check(kind)
    if kind == "unet":
        from tpuseg_torch.models.unet import UNet

        return UNet(**kwargs)
    from tpuseg_torch.models.transunet import TransUNet

    return TransUNet(**kwargs)

