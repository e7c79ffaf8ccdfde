"""The U-Net's weights, made from the seed on the device in a few calls.

Keras initialisation, as the reference model gets it: glorot-uniform
kernels, zero biases, BatchNorm scale 1 and shift 0. The running
statistics are jittered (mean ~ N(0, 0.3^2), variance ~ U(0.5, 2.0)), so
that eval BatchNorm is not the identity. All kernels come from one
uniform draw and all running statistics from two more, on ``device``.

The dict is in PyTorch's layout under the U-Net's layer names
(``enc1a.conv.weight`` as ``(out, in, kh, kw)``, ``dec4up.deconv.weight``
as ``(in, out, 2, 2)``, ``head.bn.running_var``, ...): the program loads
it as its ``state_dict``, and the plain reference reads it as it is.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from work import unet


def _kernel_shape(layer: dict):
    k = layer["k"]
    if layer["kind"] == "deconv":
        return (layer["cin"], layer["cout"], k, k)
    return (layer["cout"], layer["cin"], k, k)


def make(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Keras-initialised float32 weights of the configuration's U-Net."""
    g = torch.Generator(device=device).manual_seed(seed)
    layers = unet.layers(cfg)
    shapes = [_kernel_shape(layer) for layer in layers]
    sizes = [math.prod(s) for s in shapes]
    u = torch.rand(sum(sizes), generator=g, device=device)
    channels = sum(layer["cout"] for layer in layers)
    rmean = torch.randn(channels, generator=g, device=device) * 0.3
    rvar = torch.rand(channels, generator=g, device=device) * 1.5 + 0.5
    out: Dict[str, torch.Tensor] = {}
    w0 = c0 = 0
    for layer, shape, size in zip(layers, shapes, sizes):
        name, c = layer["name"], layer["cout"]
        receptive = shape[2] * shape[3]
        limit = math.sqrt(6.0 / (shape[0] * receptive + shape[1] * receptive))
        kernel = (u[w0:w0 + size] * (2 * limit) - limit).view(shape)
        if layer["kind"] == "deconv":
            out[f"{name}.deconv.weight"] = kernel
        else:
            out[f"{name}.conv.weight"] = kernel
            out[f"{name}.conv.bias"] = torch.zeros(c, device=device)
        out[f"{name}.bn.weight"] = torch.ones(c, device=device)
        out[f"{name}.bn.bias"] = torch.zeros(c, device=device)
        out[f"{name}.bn.running_mean"] = rmean[c0:c0 + c].clone()
        out[f"{name}.bn.running_var"] = rvar[c0:c0 + c].clone()
        w0 += size
        c0 += c
    return out
