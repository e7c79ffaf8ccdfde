"""K3's work in one predict call of the blocked int8 walk.

K3 (``tpuseg_torch/csrc/int8_conv.cu``) runs 21 of the U-Net's 23 layers
in int8: every conv block but ``enc1a`` (K5's) and ``head`` (K2's), and
the four transposed convs. The blocked walk holds the full-resolution
edge (``enc1b``, ``dec1a``, ``dec1b``) as 2x2 blocks of pixels, 4x the
channels at half the side; the weights of those blocks are zero where a
tap does not reach, and K3 skips those zero K-steps. So the work the
weights need is the plain layer's, which is what is counted here: 12.30
TOP for a call of 8 tiles of 1024^2 at base 64.

The bound of a layer is the larger of its operations at the int8 peak
and its bytes at the memory's rate: the int8 input codes, the int8
weights and the int8 output, each read or written once, and for the four
layers whose output is also pooled (K3's store forms) the pooled output.
"""

from __future__ import annotations

from work import unet

NOT_K3 = ("enc1a", "head")


def blocks(cfg: dict):
    return [layer for layer in unet.layers(cfg) if layer["name"] not in NOT_K3]


def layer_work(layer: dict, batch: int, tile: int):
    """``(operations, bytes)`` of one call of K3 for ``layer``."""
    ops = 2 * batch * unet.macs(layer, tile, tile)
    px_out = batch * unet.out_pixels(layer, tile, tile)
    # a 3x3 or 1x1 conv reads its input at its output's resolution; a
    # transposed 2x2 stride-2 conv at half the side
    px_in = px_out // 4 if layer["kind"] == "deconv" else px_out
    nbytes = (px_in * layer["cin"] + layer["k"] ** 2 * layer["cin"] * layer["cout"]
              + px_out * layer["cout"])
    if layer["name"].startswith("enc") and layer["name"].endswith("b"):
        nbytes += px_out * layer["cout"] // 4  # the pooled output of the store form
    return ops, nbytes


def call_bound_s(cfg: dict, batch: int, tile: int, peak_ops: float, hbm: float) -> float:
    """Seconds K3 needs at least for one predict call of ``batch`` tiles."""
    total = 0.0
    for layer in blocks(cfg):
        ops, nbytes = layer_work(layer, batch, tile)
        total += max(ops / peak_ops, nbytes / hbm)
    return total


def call_ops(cfg: dict, batch: int, tile: int) -> int:
    return sum(layer_work(layer, batch, tile)[0] for layer in blocks(cfg))
