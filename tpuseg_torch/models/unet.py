"""The reference U-Net (``UNet/model.py:85-146``) as a PyTorch ``nn.Module``.

Counterpart of ``tpuseg/models/unet.py``; the structure, constants and
parameter inventory are the same, so :mod:`tpuseg_torch.utils.jax_bridge`
maps a flax checkpoint onto this module one tensor at a time.

- every conv block is Conv(3x3, same) -> **ReLU -> BatchNorm** (the
  reference's activation-before-norm order, model.py:28-37);
- the deconv block is a bias-free 2x2/stride-2 transposed conv -> BN, in
  the ``conv_transpose`` or ``pixel_shuffle`` form (a 1x1 conv to
  ``4*features`` followed by a phase-major depth-to-space);
- Dropout(0.5) after enc4 and after the bottleneck, its mask drawn from
  the generator passed to :meth:`UNet.forward` (not torch's global one);
  concat order is (skip, up); the 1x1 head is a full conv block (ReLU and
  BN included);
- BatchNorm uses the Keras constants: eps 1e-3, momentum 0.99.

Layout: :meth:`UNet.forward` takes and returns NHWC, like the JAX model;
inside, tensors are NCHW views with channels-last strides, the layout
cuDNN runs fastest. ``dtype=torch.bfloat16`` computes each conv in bf16
on bf16-cast fp32 parameters and each BatchNorm in fp32 before casting
back to bf16 — where flax puts its casts.

Train-mode BatchNorm is computed by hand to match flax, not through
``nn.BatchNorm2d``: batch statistics over N,H,W in float32 with the biased
variance ``E[x^2] - E[x]^2`` (flax's fast variance, clipped at 0), the
output ``(x - mean) * (rsqrt(var + eps) * scale) + bias``, and the running
update ``running = 0.99 * running + 0.01 * batch`` on that biased variance
(``nn.BatchNorm2d`` would update ``running_var`` with the unbiased one).
Eval mode normalizes with the running statistics through ``F.batch_norm``.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from tpuseg_torch import SIZE_FACTOR

BASELINE_FEATURE_DEPTH = 64  # ref model.py:20
KERNEL_SIZE = 3  # ref model.py:21
DECONV_KERNEL_SIZE = 2  # ref model.py:22
POOLING_STRIDE = 2  # ref model.py:23

# Keras layer defaults the reference inherits implicitly.
BN_MOMENTUM = 0.99  # running = m * running + (1 - m) * batch; torch's m is 0.01
BN_EPSILON = 1e-3
DROPOUT_RATE = 0.5  # ref model.py:105, 112

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def as_dtype(dtype: Union[str, torch.dtype]) -> torch.dtype:
    return DTYPES[dtype] if isinstance(dtype, str) else dtype


def _bn(x: torch.Tensor, bn: nn.BatchNorm2d, dtype: torch.dtype) -> torch.Tensor:
    # flax promotes to fp32 for the normalization and casts the result back
    if not bn.training:
        return bn(x.float()).to(dtype)
    xf = x.float()
    mean = xf.mean((0, 2, 3))
    var = torch.clamp_min((xf * xf).mean((0, 2, 3)) - mean * mean, 0.0)
    with torch.no_grad():  # flax's update, in its own convention
        m = BN_MOMENTUM
        bn.running_mean.copy_(m * bn.running_mean + (1 - m) * mean)
        bn.running_var.copy_(m * bn.running_var + (1 - m) * var)
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    y = (xf - mean[:, None, None]) * mul[:, None, None] + bn.bias[:, None, None]
    return y.to(dtype)


def _dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]
             ) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability ``1 - rate`` and scale the
    kept values by ``1 / (1 - rate)``; the mask comes from ``generator``."""
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class ConvBlock(nn.Module):
    """Conv(kxk, same, stride 1) -> ReLU -> BatchNorm (ref model.py:28-37)."""

    def __init__(self, cin: int, features: int, kernel: int = KERNEL_SIZE):
        super().__init__()
        self.conv = nn.Conv2d(cin, features, kernel, padding=kernel // 2)
        self.bn = nn.BatchNorm2d(features, eps=BN_EPSILON, momentum=1 - BN_MOMENTUM)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        c = self.conv
        x = F.conv2d(x, c.weight.to(dtype), c.bias.to(dtype), padding=c.padding)
        return _bn(F.relu(x), self.bn, dtype)


def depth_to_space(y: torch.Tensor) -> torch.Tensor:
    """NCHW ``(B, 4F, h, w)`` with phase-major channels ``(dy*2+dx)*F + c``
    -> ``(B, F, 2h, 2w)``: the order of the JAX package's reshape, which is
    not ``F.pixel_shuffle``'s (``c*4 + dy*2 + dx``)."""
    b, c4, h, w = y.shape
    f = c4 // 4
    y = y.reshape(b, 2, 2, f, h, w).permute(0, 3, 4, 1, 5, 2)
    return y.reshape(b, f, 2 * h, 2 * w)


class DeconvBlock(nn.Module):
    """Bias-free 2x2/stride-2 transposed conv -> BatchNorm (ref
    model.py:39-48); see ``tpuseg/models/unet.py`` for why the bias goes."""

    def __init__(self, cin: int, features: int, impl: str = "conv_transpose"):
        super().__init__()
        if impl not in ("conv_transpose", "pixel_shuffle"):
            raise ValueError(
                f"deconv impl must be 'conv_transpose' or 'pixel_shuffle', "
                f"got {impl!r}")
        self.impl = impl
        if impl == "pixel_shuffle":
            self.deconv = nn.Conv2d(cin, 4 * features, 1, bias=False)
        else:
            self.deconv = nn.ConvTranspose2d(cin, features, DECONV_KERNEL_SIZE,
                                             stride=POOLING_STRIDE, bias=False)
        self.bn = nn.BatchNorm2d(features, eps=BN_EPSILON, momentum=1 - BN_MOMENTUM)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        w = self.deconv.weight.to(dtype)
        if self.impl == "pixel_shuffle":
            x = depth_to_space(F.conv2d(x, w))
        else:
            x = F.conv_transpose2d(x, w, stride=POOLING_STRIDE)
        return _bn(x, self.bn, dtype)


def _pool(x: torch.Tensor) -> torch.Tensor:
    """MaxPool 2x2 stride 2 (ref model.py:50-53)."""
    return F.max_pool2d(x, POOLING_STRIDE)


class UNet(nn.Module):
    """The reference U-Net graph (model.py:85-146), 4 down / 4 up levels.

    ``forward`` takes an NHWC batch and returns NHWC float32 **logits**
    (pre-softmax), like ``tpuseg.models.unet.UNet.__call__``. Submodules
    carry the flax block names (``enc1a`` ... ``dec1up`` ... ``head``).
    """

    def __init__(self, num_classes: int, num_channels: int = 1,
                 base_features: int = BASELINE_FEATURE_DEPTH,
                 dtype: Union[str, torch.dtype] = torch.bfloat16,
                 deconv_impl: str = "conv_transpose"):
        super().__init__()
        self.num_classes = num_classes
        self.num_channels = num_channels
        self.base_features = base_features
        self.dtype = as_dtype(dtype)
        self.deconv_impl = deconv_impl
        f = base_features
        widths = {"enc1": f, "enc2": 2 * f, "enc3": 4 * f, "enc4": 8 * f,
                  "bottleneck": 16 * f}
        cin = num_channels
        for name, feats in widths.items():
            self.add_module(f"{name}a", ConvBlock(cin, feats))
            self.add_module(f"{name}b", ConvBlock(feats, feats))
            cin = feats
        for name, feats in (("dec4", 8 * f), ("dec3", 4 * f), ("dec2", 2 * f),
                            ("dec1", f)):
            self.add_module(f"{name}up", DeconvBlock(cin, feats, deconv_impl))
            self.add_module(f"{name}a", ConvBlock(2 * feats, feats))
            self.add_module(f"{name}b", ConvBlock(feats, feats))
            cin = feats
        self.head = ConvBlock(f, num_classes, kernel=1)
        # 0 turns dropout off in train mode too (the parity tests do)
        self.dropout_rate = DROPOUT_RATE

    def config(self) -> dict:
        """Constructor arguments, as the port's checkpoint stores them."""
        return {"num_classes": self.num_classes,
                "num_channels": self.num_channels,
                "base_features": self.base_features,
                "deconv_impl": self.deconv_impl}

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """NHWC batch -> NHWC float32 logits. In train mode BatchNorm uses
        (and updates) batch statistics and dropout draws its masks from
        ``generator`` (on ``x``'s device; None uses torch's global one)."""
        if x.ndim != 4:
            raise ValueError(f"UNet expects NHWC input, got shape {tuple(x.shape)}")
        if x.shape[1] % SIZE_FACTOR or x.shape[2] % SIZE_FACTOR:
            # same contract the reference enforces at imagereader.py:136-139
            raise ValueError(
                f"Input H,W must be multiples of {SIZE_FACTOR} to allow integer "
                f"sized downscaled feature maps; got H={x.shape[1]}, W={x.shape[2]}")
        dt = self.dtype
        x = x.to(dt).permute(0, 3, 1, 2)  # NCHW view, channels-last strides

        def pair(name, x):
            x = getattr(self, f"{name}a")(x, dt)
            return getattr(self, f"{name}b")(x, dt)

        enc1 = pair("enc1", x)
        enc2 = pair("enc2", _pool(enc1))
        enc3 = pair("enc3", _pool(enc2))
        def drop(x):
            if not self.training or not self.dropout_rate:
                return x
            return _dropout(x, self.dropout_rate, generator)

        enc4 = drop(pair("enc4", _pool(enc3)))
        bott = drop(pair("bottleneck", _pool(enc4)))

        def up(x, skip, name):
            x = getattr(self, f"{name}up")(x, dt)
            # concat order (skip, up), model.py:117
            return pair(name, torch.cat([skip, x], dim=1))

        dec4 = up(bott, enc4, "dec4")
        dec3 = up(dec4, enc3, "dec3")
        dec2 = up(dec3, enc2, "dec2")
        dec1 = up(dec2, enc1, "dec1")
        # 1x1 head through the full conv block (ReLU+BN), ref model.py:136
        logits = self.head(dec1, dt)
        return logits.permute(0, 2, 3, 1).float()


def init_unet(model: UNet, generator: Optional[torch.Generator] = None) -> UNet:
    """Keras initialization (glorot_uniform kernels, zero biases, BN
    gamma=1/beta=0, running mean 0 / var 1), drawn from ``generator``."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            nn.init.xavier_uniform_(m.weight, generator=generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
    return model
