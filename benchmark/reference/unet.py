"""The plain reference U-Net: float32 PyTorch operations and nothing else.

usnistgov/semantic-segmentation-unet ``UNet/model.py:85-146`` in eval
mode: each conv block is a 3x3 (head: 1x1) same conv with bias, then ReLU,
then BatchNorm on its running statistics (Keras: eps 1e-3); each up step
is a bias-free 2x2 stride-2 transposed conv, then BatchNorm; the skip is
concatenated before the up path's output; pools are 2x2 max pools. It
reads the weights dict of ``harness/weights.py`` as it is and imports
nothing of the program. TF32 is turned off while it runs, so a float32
product stays float32 on the card.

``quant_bits`` makes the same graph the control that computes in a lower
precision than the configuration states: every layer but the first conv
and the head takes symmetric per-output-channel weights of that many bits,
and every block's output but the head's is rounded to that many bits on
a per-tensor scale set by :func:`calibrate` (the 99.9th percentile of its
magnitude over the calibration crops), as an int8 walk rounds to 8.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

EPS = 1e-3
FP_LAYERS = ("enc1a", "head")
PERCENTILE = 99.9


@contextlib.contextmanager
def no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _bn(x, w, name):
    """Eval BatchNorm on the running statistics, in float32."""
    scale = w[f"{name}.bn.weight"] / torch.sqrt(w[f"{name}.bn.running_var"] + EPS)
    shift = w[f"{name}.bn.bias"] - w[f"{name}.bn.running_mean"] * scale
    return (x.float() * scale[None, :, None, None] + shift[None, :, None, None]).to(x.dtype)


def _quant_weight(kernel: torch.Tensor, bits: int, out_dim: int) -> torch.Tensor:
    qmax = 2 ** (bits - 1) - 1
    dims = [d for d in range(kernel.ndim) if d != out_dim]
    amax = kernel.abs().amax(dim=dims, keepdim=True)
    scale = torch.where(amax > 0, amax, torch.ones_like(amax)) / qmax
    return torch.clamp(torch.round(kernel / scale), -qmax, qmax) * scale


def _quant_act(x: torch.Tensor, bits: int, rng: float) -> torch.Tensor:
    qmax = 2 ** (bits - 1) - 1
    scale = max(rng, 1e-12) / qmax
    return torch.clamp(torch.round(x / scale), -qmax, qmax) * scale


def _percentile(x: torch.Tensor, q: float) -> float:
    v = x.abs().flatten()
    k = max(1, min(v.numel(), int(round(q / 100.0 * v.numel()))))
    return float(torch.kthvalue(v.float(), k).values)


def forward(w: Dict[str, torch.Tensor], x: torch.Tensor, levels: int = 4,
            quant_bits: Optional[int] = None, ranges: Optional[Dict[str, float]] = None,
            tap: Optional[Callable[[str, torch.Tensor], None]] = None,
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """NHWC batch -> NHWC float32 logits. ``tap(name, y)`` sees each
    block's output. ``dtype`` other than float32 computes each conv in that
    dtype and rounds each BatchNorm's output to it (a yardstick for the
    rounding of a lower precision, not the reference)."""
    x = x.to(dtype).permute(0, 3, 1, 2)

    def out(name, y):
        if tap is not None:
            tap(name, y)
        if quant_bits is not None and name != "head":
            y = _quant_act(y, quant_bits, ranges[name])
        return y

    def kernel(name, key, out_dim):
        k = w[key].to(dtype)
        if quant_bits is not None and name not in FP_LAYERS:
            k = _quant_weight(k, quant_bits, out_dim)
        return k

    def conv(name, y):
        k = kernel(name, f"{name}.conv.weight", 0)
        y = F.conv2d(y, k, w[f"{name}.conv.bias"].to(dtype), padding=k.shape[-1] // 2)
        return out(name, _bn(torch.relu(y), w, name))

    def up(name, y):
        y = F.conv_transpose2d(y, kernel(name, f"{name}.deconv.weight", 1), stride=2)
        return out(name, _bn(y, w, name))

    skips = []
    names = [f"enc{i + 1}" for i in range(levels)]
    for name in names:
        x = conv(name + "b", conv(name + "a", x))
        skips.append(x)
        x = F.max_pool2d(x, 2)
    x = conv("bottleneckb", conv("bottlenecka", x))
    for level in range(levels, 0, -1):
        name = f"dec{level}"
        x = torch.cat([skips[level - 1], up(name + "up", x)], dim=1)
        x = conv(name + "b", conv(name + "a", x))
    return conv("head", x).permute(0, 2, 3, 1).float()


def calibrate(w: Dict[str, torch.Tensor], crops, levels: int = 4,
              percentile: float = PERCENTILE) -> Dict[str, float]:
    """Per-block output range of the float32 forward over the crops: the
    ``percentile`` of its magnitude, averaged over the crops."""
    per: Dict[str, list] = {}
    with torch.no_grad(), no_tf32():
        for crop in crops:
            forward(w, crop[None], levels,
                    tap=lambda name, y: per.setdefault(name, []).append(
                        _percentile(y, percentile)))
    return {k: sum(v) / len(v) for k, v in per.items()}
