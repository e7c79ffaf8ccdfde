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

A block's conv bias, ReLU and BatchNorm run as K4
(``tpuseg_torch/ops/batchnorm.py``: hand kernels on the card, their plain
versions on the CPU), not through ``nn.BatchNorm2d``: the conv output is
rounded to the dtype, ``+ bias`` rounded again (flax's ``y += bias``), then
ReLU; batch statistics over N,H,W in float32 with the biased variance
``E[x^2] - E[x]^2`` (flax's fast variance, clipped at 0), the output
``(x - mean) * (rsqrt(var + eps) * scale) + bias``, and the running update
``running = 0.99 * running + 0.01 * batch`` on that biased variance
(``nn.BatchNorm2d`` would update ``running_var`` with the unbiased one).
Eval mode uses the same formula on the running statistics. K4 takes rows
of channels: the model keeps every activation channels-last (the input is
made so on entry, conv weights go to cuDNN channels-last, the
depth-to-space writes NHWC, and dropout's mask takes its input's layout).

A forward without a ``halo`` and with the max pool in place runs K4's
store forms: at every level in an eval forward without grad (serving, the
trainer's test steps), at levels 1-3 in train mode (dropout sits between
``enc4b`` and its skip). Such a level allocates its concat buffer ``[B,
2F, H, W]``; the encoder pair's second block stores its output (the skip)
into the first half and returns its 2x2 max pool from the same pass, and
the deconv block stores into the second half, so no ``torch.cat`` or max
pool runs, and in eval mode each buffer goes once the decoder has read it.
In train mode the backward of the skip's block takes the pool's gradient
inside K4 (``ops/batchnorm.py``'s pooled (c) and (d)): no index tensor,
pool backward or gradient add. A forward with grad in eval mode (the ERF
probe's) and the spatial walk keep the concat and the pool; the logits
are the same bits either way, and on the CPU so is a train step's every
gradient.

Data parallelism (``tpuseg_torch/parallel/mesh.py``) sets
``UNet.process_group``; train mode then takes the batch statistics of the
global batch (sync-BN, the JAX package's sharded semantics) and draws each
dropout mask for the global batch, keeping this rank's rows. Spatial
partitioning also sets ``UNet.halo`` (``parallel/halo.py``): the input is
this rank's rows of each image, every 3x3 conv pads them with the
neighbouring ranks' rows (in eval mode too) and convolves with ``padding=(0,
1)``, and each dropout mask is drawn at the level's full height. Where a
pool window would straddle two ranks (``halo.split_level``), the level's
rows are gathered before that pool; the deeper levels and the deconv back
run on the full rows, the same on every rank of the group (plain padding,
BatchNorm sums all-reduced as before: every rank adds the same sums and
counts, so the statistics do not change), and the rank keeps its rows of
that deconv's output for the concat with its skip.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from tpuseg_torch import SIZE_FACTOR
from tpuseg_torch.ops.batchnorm import conv_bn, conv_bn_into
from tpuseg_torch.parallel.halo import split_level

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


def _dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
             group=None, halo=None, full_rows: bool = False) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability ``1 - rate`` and scale the
    kept values by ``1 / (1 - rate)``; the mask comes from ``generator``.
    With a process ``group`` the mask is drawn for the global batch (every
    data shard's batch stacked in order, at the full height of the ``halo``'s
    spatial group) and this rank keeps its batch rows and its image rows
    (all of them where ``x`` already holds the full height, ``full_rows``),
    so the ranks drop out as one process of the global batch does from the
    same generator state."""
    keep = 1.0 - rate
    if group is None:
        mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    else:
        import torch.distributed as dist

        s, sr = (halo.size, halo.rank) if halo is not None else (1, 0)
        b, h = x.shape[0], x.shape[2]
        rows = slice(None) if full_rows else slice(sr * h, (sr + 1) * h)
        first = dist.get_rank(group) // s * b
        shape = (b * dist.get_world_size(group) // s, x.shape[1],
                 h if full_rows else h * s, x.shape[3])
        mask = torch.rand(shape, generator=generator, device=x.device)
        mask = mask[first:first + b, :, rows] < keep
    # the mask copied into x's layout: torch.where and its backward write
    # their condition's, and the model keeps activations channels-last
    mask = torch.empty_like(x, dtype=torch.bool).copy_(mask)
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def _weight(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A conv weight in the compute dtype, channels-last: the conv then
    writes a channels-last output also where its input's layout is
    ambiguous (a 1 x 1 image, both layouts at once), as K4 needs."""
    return w.to(dtype, memory_format=torch.channels_last)


class ConvBlock(nn.Module):
    """Conv(kxk, same, stride 1) -> ReLU -> BatchNorm (ref model.py:28-37).
    With a ``halo`` a 3x3 conv takes its row padding from the neighbouring
    ranks; with ``cat`` (a level's concat buffer) the output goes into its
    first half and ``(cat, pooled)`` comes back, K4's store forms
    (``conv_bn_into``)."""

    def __init__(self, cin: int, features: int, kernel: int = KERNEL_SIZE):
        super().__init__()
        self.conv = nn.Conv2d(cin, features, kernel, padding=kernel // 2)
        self.bn = nn.BatchNorm2d(features, eps=BN_EPSILON, momentum=1 - BN_MOMENTUM)

    def forward(self, x: torch.Tensor, dtype: torch.dtype, group=None, halo=None,
                cat: Optional[torch.Tensor] = None):
        c = self.conv
        padding = c.padding
        if halo is not None and padding[0]:
            x = halo(x)
            padding = (0, padding[1])
        x = F.conv2d(x, _weight(c.weight, dtype), padding=padding)
        if cat is not None:
            return conv_bn_into(x, c.bias, True, self.bn, BN_MOMENTUM, group, cat, skip=True)
        return conv_bn(x, c.bias, True, self.bn, BN_MOMENTUM, group)


def depth_to_space(y: torch.Tensor) -> torch.Tensor:
    """NCHW ``(B, 4F, h, w)`` with phase-major channels ``(dy*2+dx)*F + c``
    -> ``(B, F, 2h, 2w)``: the order of the JAX package's reshape, which is
    not ``F.pixel_shuffle``'s (``c*4 + dy*2 + dx``). Written NHWC, as the
    JAX package reshapes, so the result is channels-last."""
    b, c4, h, w = y.shape
    f = c4 // 4
    y = y.permute(0, 2, 3, 1).reshape(b, h, w, 2, 2, f).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(b, 2 * h, 2 * w, f).permute(0, 3, 1, 2)


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

    def forward(self, x: torch.Tensor, dtype: torch.dtype, group=None,
                cat: Optional[torch.Tensor] = None) -> torch.Tensor:
        """With ``cat`` (a level's concat buffer) the output goes into its
        second half and ``cat`` comes back (``conv_bn_into``)."""
        w = _weight(self.deconv.weight, dtype)
        if self.impl == "pixel_shuffle":
            x = depth_to_space(F.conv2d(x, w))
        else:
            x = F.conv_transpose2d(x, w, stride=POOLING_STRIDE)
        if cat is not None:
            return conv_bn_into(x, None, False, self.bn, BN_MOMENTUM, group, cat, skip=False)
        return conv_bn(x, None, False, self.bn, BN_MOMENTUM, group)


def _max_pool(x: torch.Tensor) -> torch.Tensor:
    """MaxPool 2x2 stride 2 (ref model.py:50-53)."""
    return F.max_pool2d(x, POOLING_STRIDE)


# The walk's pool. K4's pooled form computes this max pool, so the store
# forms run only while it is in place (the spatial tests swap in average
# pooling to compare with the JAX package's mesh).
_pool = _max_pool


class UNet(nn.Module):
    """The reference U-Net graph (model.py:85-146), 4 down / 4 up levels.

    ``forward`` takes an NHWC batch and returns NHWC float32 **logits**
    (pre-softmax), like ``tpuseg.models.unet.UNet.__call__``. Submodules
    carry the flax block names (``enc1a`` ... ``dec1up`` ... ``head``).
    """

    kind = "unet"

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
        # data parallelism (parallel/mesh.py): the process group train-mode
        # BatchNorm reduces its statistics over and dropout draws its global
        # mask for; None trains on this process's batch alone
        self.process_group = None
        # spatial partitioning (parallel/halo.py): the exchange every 3x3
        # conv pads its rows through, in train and eval mode; None pads
        # with zeros
        self.halo = None

    def config(self) -> dict:
        """Constructor arguments, as the port's checkpoint stores them."""
        return {"num_classes": self.num_classes,
                "num_channels": self.num_channels,
                "base_features": self.base_features,
                "deconv_impl": self.deconv_impl}

    def initialize(self, generator: Optional[torch.Generator] = None) -> "UNet":
        """:func:`init_unet`."""
        return init_unet(self, generator)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """NHWC batch -> NHWC float32 logits. In train mode BatchNorm uses
        (and updates) batch statistics and dropout draws its masks from
        ``generator`` (on ``x``'s device; None uses torch's global one)."""
        if x.ndim != 4:
            raise ValueError(f"UNet expects NHWC input, got shape {tuple(x.shape)}")
        halo = self.halo
        spatial = halo.size if halo is not None else 1
        # x holds this rank's rows: the whole image is `spatial` times taller
        height = x.shape[1] * spatial
        if height % SIZE_FACTOR or x.shape[2] % SIZE_FACTOR:
            # same contract the reference enforces at imagereader.py:136-139
            raise ValueError(
                f"Input H,W must be multiples of {SIZE_FACTOR} to allow integer "
                f"sized downscaled feature maps; got H={height}, W={x.shape[2]}")
        # the level whose rows are gathered before its pool (None: no gather)
        gather_at = split_level(height, spatial)
        dt = self.dtype
        # train-mode collectives only: eval BatchNorm reads running statistics
        # (the halo exchange and the gather run in both modes)
        group = self.process_group if self.training else None
        # NCHW view, channels-last strides (a copy only where the caller's
        # batch is not NHWC-contiguous, as apply_nchw's is)
        x = x.to(dt).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        # below the gathered level the rows are full: no halo
        pad = [halo if gather_at is None or level <= gather_at else None
               for level in range(5)]

        def pair(name, x, level):
            x = getattr(self, f"{name}a")(x, dt, group, pad[level])
            return getattr(self, f"{name}b")(x, dt, group, pad[level])

        def drop(x, level):
            if not self.training or not self.dropout_rate:
                return x
            return _dropout(x, self.dropout_rate, generator, group, halo,
                            full_rows=pad[level] is None)

        # the levels whose concat and pool are K4's store forms (module docstring)
        form_levels = ()
        if halo is None and _pool is _max_pool:
            if self.training:
                form_levels = range(3)
            elif not torch.is_grad_enabled():
                form_levels = range(4)
        skips = []
        for level, name in enumerate(("enc1", "enc2", "enc3", "enc4")):
            if level in form_levels:
                x = getattr(self, f"{name}a")(x, dt, group)
                n, f, h, w = x.shape
                cat = torch.empty((n, 2 * f, h, w), dtype=x.dtype, device=x.device,
                                  memory_format=torch.channels_last)
                cat, x = getattr(self, f"{name}b")(x, dt, group, cat=cat)
                skips.append(cat)
                continue
            x = pair(name, x, level)
            if name == "enc4":
                x = drop(x, level)
            skips.append(x)
            if level == gather_at:
                x = halo.gather(x)
            x = _pool(x)
        x = drop(pair("bottleneck", x, 4), 4)
        for level, name in reversed(list(enumerate(("dec1", "dec2", "dec3", "dec4")))):
            if level in form_levels:
                cat, skips[level] = skips[level], None
                cat = getattr(self, f"{name}up")(x, dt, group, cat=cat)
                x = getattr(self, f"{name}a")(cat, dt, group)
                del cat  # eval: read by dec{level}a, freed before dec{level}b allocates
                x = getattr(self, f"{name}b")(x, dt, group)
                continue
            x = getattr(self, f"{name}up")(x, dt, group)
            if level == gather_at:
                h = x.shape[2] // spatial
                x = x[:, :, halo.rank * h:(halo.rank + 1) * h]
            # concat order (skip, up), model.py:117
            x = pair(name, torch.cat([skips[level], x], dim=1), level)
        # 1x1 head through the full conv block (ReLU+BN), ref model.py:136
        logits = self.head(x, dt, group)
        return logits.permute(0, 2, 3, 1).float()

    def probabilities(self, x: torch.Tensor,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Reference-contract output: softmax over the class axis (model.py:142)."""
        return torch.softmax(self.forward(x, generator), dim=-1)


def apply_nchw(model: UNet, images_nchw: torch.Tensor, **kwargs) -> torch.Tensor:
    """Reference-layout entry point: NCHW in, NHWC softmax out (model.py:73,
    139-142)."""
    return model.probabilities(images_nchw.permute(0, 2, 3, 1), **kwargs)


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
