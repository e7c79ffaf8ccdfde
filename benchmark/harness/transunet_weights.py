"""TransUNet's weights, made from the seed on the device in a few calls.

The source's initialization (``work/transunet.py::params`` names each
tensor's), drawn from one generator: every uniform tensor from one uniform
draw and every normal one from one normal draw, in the inventory's order,
on ``device``. Position embeddings are N(0, 0.02^2) (the source's are
zeros, then loaded from ImageNet-21k weights); BatchNorm's running mean is 0
and its variance 1, ``nn.BatchNorm2d``'s start.

The dict is in PyTorch's layout under the program's names
(``resnet.block1.unit1.conv1.weight`` as ``(out, in, kh, kw)``,
``layers.0.attn.query.weight`` as ``(out, in)``, ``embed.position`` as
``(1, L, hidden)``, ...): the program loads it as its ``state_dict``, and the
plain reference (``reference/transunet.py``) reads it as it is.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from work import transunet

UNIFORM = ("kaiming", "bias", "xavier")


def make(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Float32 weights of the configuration's TransUNet."""
    g = torch.Generator(device=device).manual_seed(seed)
    params = transunet.params(cfg)
    n_uniform = sum(math.prod(p["shape"]) for p in params if p["init"] in UNIFORM)
    n_normal = sum(math.prod(p["shape"]) for p in params if p["init"] == "normal")
    u = torch.rand(n_uniform, generator=g, device=device)
    z = torch.randn(n_normal, generator=g, device=device)
    out: Dict[str, torch.Tensor] = {}
    iu = iz = 0
    for p in params:
        shape, size = tuple(p["shape"]), math.prod(p["shape"])
        if p["init"] in UNIFORM:
            out[p["name"]] = (u[iu:iu + size] * (2 * p["bound"]) - p["bound"]).view(shape)
            iu += size
        elif p["init"] == "normal":
            out[p["name"]] = (z[iz:iz + size] * p["std"]).view(shape)
            iz += size
        else:
            fill = 1.0 if p["init"] == "ones" else 0.0
            out[p["name"]] = torch.full(shape, fill, device=device)
    return out
