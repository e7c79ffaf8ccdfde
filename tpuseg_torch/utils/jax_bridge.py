"""Flax U-Net variables <-> the port's ``state_dict``.

Takes the JAX package's ``{"params": ..., "batch_stats": ...}`` as nested
dicts of **numpy** arrays (the caller converts them, e.g. with
``jax.device_get``; this module imports no jax) and returns tensors keyed
as :class:`tpuseg_torch.models.unet.UNet` names them.

- Conv kernels: flax HWIO -> torch OIHW.
- BatchNorm: ``scale``/``bias`` -> ``weight``/``bias``, ``mean``/``var``
  -> ``running_mean``/``running_var``.
- ``conv_transpose`` deconv: flax places ``x[i,j] @ w[1-dy, 1-dx]`` at
  output phase (dy, dx) (``tpuseg/infer/quant.py:266-284``, pinned in
  ``tests/test_quant.py``); ``torch.nn.ConvTranspose2d(k=2, s=2)`` places
  ``x[i,j] @ W[:, :, dy, dx]``. So the kernel flips both spatial axes and
  permutes to ``(in, out, kh, kw)``.
- ``pixel_shuffle`` deconv: a 1x1 conv, HWIO -> OIHW like any conv; the
  model's depth-to-space uses the JAX package's phase-major order.

:func:`state_dict_to_flax` is the exact inverse (transposes and flips
only), for serving a port-trained model with the JAX package
(``scripts/convert_orbax_checkpoint.py``).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from tpuseg_torch.models.unet import UNet


def _conv(kernel) -> np.ndarray:
    return np.asarray(kernel, np.float32).transpose(3, 2, 0, 1)


def _conv_transpose(kernel) -> np.ndarray:
    return np.flip(np.asarray(kernel, np.float32), (0, 1)).transpose(2, 3, 0, 1)


def flax_to_state_dict(variables, deconv_impl: str = "conv_transpose"
                       ) -> Dict[str, torch.Tensor]:
    params, stats = variables["params"], variables["batch_stats"]
    out: Dict[str, np.ndarray] = {}
    for name, p in params.items():
        if "deconv" in p:
            k = p["deconv"]["kernel"]
            out[f"{name}.deconv.weight"] = (
                _conv(k) if deconv_impl == "pixel_shuffle" else _conv_transpose(k))
        else:
            out[f"{name}.conv.weight"] = _conv(p["conv"]["kernel"])
            out[f"{name}.conv.bias"] = np.asarray(p["conv"]["bias"], np.float32)
        out[f"{name}.bn.weight"] = np.asarray(p["bn"]["scale"], np.float32)
        out[f"{name}.bn.bias"] = np.asarray(p["bn"]["bias"], np.float32)
        out[f"{name}.bn.running_mean"] = np.asarray(stats[name]["bn"]["mean"], np.float32)
        out[f"{name}.bn.running_var"] = np.asarray(stats[name]["bn"]["var"], np.float32)
    sd = {k: torch.from_numpy(np.array(v)) for k, v in out.items()}  # owned copies
    for name in params:
        sd[f"{name}.bn.num_batches_tracked"] = torch.tensor(0)
    return sd


def state_dict_to_flax(state_dict, deconv_impl: str = "conv_transpose") -> dict:
    """The port's ``state_dict`` -> ``{"params", "batch_stats"}`` nested
    dicts of float32 numpy arrays, as the JAX package's U-Net names them."""
    def arr(name):
        return np.asarray(state_dict[name].detach().cpu(), np.float32)

    def to_hwio(w):
        return np.ascontiguousarray(w.transpose(2, 3, 1, 0))

    blocks = list(dict.fromkeys(k.split(".")[0] for k in state_dict))
    params, stats = {}, {}
    for name in blocks:
        if f"{name}.deconv.weight" in state_dict:
            w = arr(f"{name}.deconv.weight")
            k = (to_hwio(w) if deconv_impl == "pixel_shuffle"
                 else np.ascontiguousarray(np.flip(w.transpose(2, 3, 0, 1), (0, 1))))
            params[name] = {"deconv": {"kernel": k}}
        else:
            params[name] = {"conv": {"kernel": to_hwio(arr(f"{name}.conv.weight")),
                                     "bias": arr(f"{name}.conv.bias")}}
        params[name]["bn"] = {"scale": arr(f"{name}.bn.weight"), "bias": arr(f"{name}.bn.bias")}
        stats[name] = {"bn": {"mean": arr(f"{name}.bn.running_mean"),
                              "var": arr(f"{name}.bn.running_var")}}
    return {"params": params, "batch_stats": stats}


def unet_from_flax(variables, num_classes: int, num_channels: int,
                   base_features: int, dtype=torch.float32,
                   deconv_impl: str = "conv_transpose") -> UNet:
    """A port U-Net in eval mode holding the flax ``variables``."""
    model = UNet(num_classes, num_channels, base_features, dtype, deconv_impl)
    model.load_state_dict(flax_to_state_dict(variables, deconv_impl))
    return model.eval()
