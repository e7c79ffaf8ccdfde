"""K4's bytes: the BatchNorm kernels of the bf16 U-Net.

K4 (``tpuseg_torch/csrc/batchnorm.cu``) runs each of the 23 layers'
bias + ReLU + BatchNorm as (a) stats, (b) apply, (c) backward reduce and
(d) backward apply. Each is bound by memory: its bytes are the activations
it must read and write once, in the model's dtype (bf16, 2 bytes): (a) x;
(b) x and y; (c) x and the gradient g; (d) x, g and dx. Eval serving runs
(b) alone, on the running statistics. The per-channel vectors (a few KB a
layer) are counted too.
"""

from __future__ import annotations

from work import unet

# activations read or written by each kernel, in units of the layer's x
TENSORS = {"stats": 1, "apply": 2, "backward_reduce": 2, "backward_apply": 3}
VECTOR_BYTES = 4 * 6  # bias, gamma, beta, running mean and var, one more f32 row a channel


def layer_bytes(layer: dict, batch: int, height: int, width: int, kernels,
                elem: int = 2) -> int:
    n = batch * unet.out_pixels(layer, height, width) * layer["cout"]
    return sum(TENSORS[k] * n * elem + VECTOR_BYTES * layer["cout"] for k in kernels)


def serve_bytes(cfg: dict, batch: int, tile: int) -> int:
    """Bytes of one eval predict call's 23 applies."""
    return sum(layer_bytes(layer, batch, tile, tile, ("apply",)) for layer in unet.layers(cfg))


def train_bytes(cfg: dict, batch: int, size: int) -> int:
    """Bytes of one train step's 23 x 4 kernels."""
    return sum(layer_bytes(layer, batch, size, size, TENSORS) for layer in unet.layers(cfg))
