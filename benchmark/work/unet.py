"""The U-Net's layers and the operations of a forward pass, from its sizes.

The graph is usnistgov/semantic-segmentation-unet ``UNet/model.py:85-146``:
four levels down (two 3x3 conv blocks, then a 2x2 max pool), a bottleneck
of two 3x3 conv blocks, four levels up (a 2x2 stride-2 transposed conv,
the concat with the skip, two 3x3 conv blocks), and a 1x1 head block.
Every conv block and every transposed conv is followed by a BatchNorm.

Operations count 2 per multiply-add. A transposed 2x2 stride-2 conv
computes one tap per output pixel (each output pixel takes one of the four
kernel taps), so its multiply-adds are ``out_pixels * cin * cout``.
Pools, ReLUs, BatchNorms and the concats are left out: they are not
multiply-adds.
"""

from __future__ import annotations

from typing import List


def layers(cfg: dict) -> List[dict]:
    """The 23 layers with a BatchNorm, in the forward's order: ``name``,
    ``kind`` (``conv`` or ``deconv``), ``k`` (kernel side), ``cin``,
    ``cout`` and ``level`` (the output is ``size >> level`` on a side)."""
    f, levels = cfg["base_features"], cfg["levels"]
    out, cin = [], cfg["num_channels"]
    names = [f"enc{i + 1}" for i in range(levels)] + ["bottleneck"]
    for level, name in enumerate(names):
        cout = f << level
        out += [dict(name=name + "a", kind="conv", k=3, cin=cin, cout=cout, level=level),
                dict(name=name + "b", kind="conv", k=3, cin=cout, cout=cout, level=level)]
        cin = cout
    for level in range(levels - 1, -1, -1):
        cout = f << level
        name = f"dec{level + 1}"
        out += [dict(name=name + "up", kind="deconv", k=2, cin=cin, cout=cout, level=level),
                dict(name=name + "a", kind="conv", k=3, cin=2 * cout, cout=cout, level=level),
                dict(name=name + "b", kind="conv", k=3, cin=cout, cout=cout, level=level)]
        cin = cout
    out.append(dict(name="head", kind="conv", k=1, cin=cin, cout=cfg["num_classes"], level=0))
    return out


def out_pixels(layer: dict, height: int, width: int) -> int:
    return (height >> layer["level"]) * (width >> layer["level"])


def macs(layer: dict, height: int, width: int) -> int:
    """Multiply-adds of one image's pass through ``layer``."""
    taps = 1 if layer["kind"] == "deconv" else layer["k"] ** 2
    return out_pixels(layer, height, width) * taps * layer["cin"] * layer["cout"]


def forward_ops(cfg: dict, height: int, width: int) -> int:
    """Operations of one image's forward pass at ``height x width``."""
    return 2 * sum(macs(layer, height, width) for layer in layers(cfg))


def train_ops(cfg: dict, height: int, width: int) -> int:
    """Operations of one image's train step: the forward, and a backward
    of twice its work (the gradients of the inputs and of the weights)."""
    return 3 * forward_ops(cfg, height, width)
