"""TransUNet R50-ViT-B/16 (Chen et al., arXiv:2102.04306) as a PyTorch ``nn.Module``.

The graph of github.com/Beckschen/TransUNet (``networks/vit_seg_configs.py::
get_r50_b16_config``, ``networks/vit_seg_modeling.py``,
``networks/vit_seg_modeling_resnet_skip.py``), with its widths by default:

- **input**: a one-channel image is repeated to three (``x.repeat(1, 3, 1,
  1)``); here the root conv's standardized weight is summed over its three
  input channels instead, the same mathematics;
- **ResNet** (BiT's ResNetV2, post-activation despite its unit's name):
  every conv is a ``StdConv2d`` without bias, its weight standardized each
  forward, ``(w - mean) / sqrt(var + 1e-5)`` over ``(cin, kh, kw)`` with the
  biased variance, so the gradient flows through the standardization. The
  root is a 7x7/2 conv (pad 3), GroupNorm(32, eps 1e-6) and ReLU: skip 3 at
  1/2; then a 3x3/2 max pool with no padding (256 -> 127 at 512^2). Each
  bottleneck unit is ``relu(gn1(conv1x1))``, ``relu(gn2(conv3x3/stride))``,
  ``gn3(conv1x1)``, then ``relu(y + residual)``, the residual
  ``gn_proj(conv1x1/stride(x))`` (GroupNorm(cout, cout), eps 1e-5) where the
  stride or width changes. Blocks of 3, 4 and 9 units (widths 256, 512,
  1024; the second and third start with stride 2). Block 1's output is
  zero-padded at the bottom and right to ``S/4`` (127 -> 128): skip 2;
  block 2's output is skip 1;
- **ViT-B/16** over the 1/16 map: a 1x1 conv with bias (1024 -> 768), the
  ``(S/16)^2`` tokens plus learned position embeddings, dropout 0.1; twelve
  pre-LN layers, ``h = x + out(attn(ln1(x)))`` then ``x = h +
  drop(fc2(drop(gelu(fc1(ln2(h))))))`` (LayerNorm eps 1e-6, 12 heads of 64,
  softmax of ``qk^T / 8``, exact GELU, MLP 3072), then a final LayerNorm.
  The source's attention dropout and its projection dropout both take
  ``attention_dropout_rate``, 0.0, so they draw nothing;
- **decoder** (``DecoderCup``): the tokens as a ``[N, 768, S/16, S/16]`` map,
  ``conv_more`` (768 -> 512), then four blocks of a bilinear x2 upsampling
  (``align_corners=True``), the concat ``[x, skip]`` and two ``Conv2dReLU``
  (512+512 -> 256, 256+256 -> 128, 128+64 -> 64, 64+0 -> 16); the head is
  a 3x3 conv with bias (16 -> classes). A ``Conv2dReLU`` is a 3x3 conv
  without bias, BatchNorm (``nn.BatchNorm2d``'s eps 1e-5 and momentum 0.1)
  and ReLU: K4 in its order after (``ops/batchnorm.py``, ``RELU_AFTER``), in
  train and eval mode. K4 updates the running variance with the batch's
  biased variance, where ``nn.BatchNorm2d`` takes the unbiased one.

:meth:`TransUNet.forward` takes an NHWC batch and returns NHWC float32
logits, as ``UNet`` does. Inside, the ResNet runs in NCHW (PyTorch's
GroupNorm on the card takes NCHW, and copies a channels-last input there
and back); its skips and the decoder are NCHW views with channels-last
strides (decoder conv weights go to cuDNN channels-last, so each conv
writes channels-last, as K4 needs), and the tokens are ``[N, L, D]``
contiguous. ``dtype=torch.bfloat16`` computes convs, linears, attention and
the norms in bf16 on bf16-cast fp32 parameters (the norms' statistics in
f32 inside PyTorch's ops; K4 in f32). The parameters reach the compute
dtype in a few launches, where a cast a tensor would take one each way
(the step is otherwise bound by the host's launches): the ResNet's conv
weights are standardized by one LayerNorm a fan-in and cast at once
(:func:`standardized_together`), its GroupNorms' scales and shifts and all
of the ViT's parameters are each cast as one tensor (:func:`cast_together`,
cut by :func:`views`; q, k and v side by side, so one GEMM computes them),
and the 1x1 patch conv is a linear over the tokens. Attention is
``F.scaled_dot_product_attention``, restricted on the card to the flash
backend for bf16 (a fallback raises rather than slows down), the math
backend for float32 and on the CPU. GroupNorm and LayerNorm are PyTorch's
ops.

Dropout (train mode, rate ``dropout_rate``) draws its masks from the
``generator`` given to :meth:`TransUNet.forward`, in this order:
``torch.rand(shape, generator=generator) < 0.9`` for the embeddings
``[N, L, D]``, then for each layer the MLP's two, after the GELU ``[N, L,
mlp]`` and after fc2 ``[N, L, D]``. With a process group (data
parallelism) each mask is drawn for the global batch and this rank keeps
its rows, as the U-Net does; train-mode BatchNorm then reduces its sums
over the group (sync-BN). Spatial partitioning cannot split global
attention: a ``halo`` is refused.

Spans ``model.resnet``, ``model.vit`` and ``model.decoder`` mark the
forward's three parts (``utils/profiling.span``: on only inside
``profiling.spans()``); ``COUNTS`` counts attention calls and GroupNorm
calls, and :func:`reset_counts` zeroes them.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from tpuseg_torch.models.unet import as_dtype
from tpuseg_torch.ops.batchnorm import RELU_AFTER, conv_bn
from tpuseg_torch.utils.profiling import span

KIND = "transunet_r50_b16"

GN_GROUPS = 32
GN_EPS = 1e-6  # gn1, gn2, gn3 and the root's (vit_seg_modeling_resnet_skip.py)
STD_EPS = 1e-5  # StdConv2d's weight standardization
LN_EPS = 1e-6
BN_EPS = 1e-5  # nn.BatchNorm2d's defaults, which Conv2dReLU takes
BN_MOMENTUM = 0.1  # torch's: running = 0.9 * running + 0.1 * batch
DROPOUT_RATE = 0.1  # get_b16_config: transformer.dropout_rate
POSITION_STD = 0.02

# attention calls and GroupNorm calls since the counts were last reset
COUNTS: Dict[str, int] = {"attention": 0, "group_norm": 0}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def _weight(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A conv weight in the compute dtype, channels-last (see ``UNet``)."""
    return w.to(dtype, memory_format=torch.channels_last)


def cast_together(tensors: Sequence[torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    """``tensors`` flattened into one tensor of ``dtype``: one cat and one
    cast forward, one cast backward (the cat's gradient is views), where a
    cast a parameter would take a launch each way."""
    return torch.cat([t.reshape(-1) for t in tensors]).to(dtype)


def views(flat: torch.Tensor, shapes) -> List[torch.Tensor]:
    """``flat`` cut into consecutive views of ``shapes`` by one ``split``,
    whose backward is one cat (a slice's would fill and add a gradient the
    size of ``flat`` for each view)."""
    parts = flat.split([math.prod(shape) for shape in shapes])
    return [t.view(shape) for t, shape in zip(parts, shapes)]


def standardized(w: torch.Tensor) -> torch.Tensor:
    """StdConv2d's weight: ``(w - mean) / sqrt(var + 1e-5)`` over ``(cin, kh,
    kw)`` of each output channel, the biased variance (a LayerNorm without
    affine over each output channel's row)."""
    return F.layer_norm(w.reshape(w.shape[0], -1), (w[0].numel(),), eps=STD_EPS).view(w.shape)


def standardized_together(convs: Sequence[nn.Conv2d], dtype: torch.dtype) -> Dict:
    """:func:`standardized` weights of ``convs`` in ``dtype``, by conv: one
    LayerNorm over the stacked rows of all weights of a fan-in, then one
    cast of them all."""
    groups: Dict[int, List[nn.Conv2d]] = {}
    for c in convs:
        groups.setdefault(c.weight[0].numel(), []).append(c)
    order = [c for group in groups.values() for c in group]
    rows = [F.layer_norm(torch.cat([c.weight.reshape(-1, fan_in) for c in group]), (fan_in,),
                         eps=STD_EPS) for fan_in, group in groups.items()]
    return dict(zip(order, views(cast_together(rows, dtype), [c.weight.shape for c in order])))


def _dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
             group=None) -> torch.Tensor:
    """Keep with probability ``1 - rate``, scaled by ``1 / (1 - rate)``; the
    mask ``torch.rand(x.shape, generator=generator) < 1 - rate``, or with a
    process ``group`` this rank's rows of the global batch's mask."""
    keep = 1.0 - rate
    if group is None:
        mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    else:
        import torch.distributed as dist

        b = x.shape[0]
        first = dist.get_rank(group) * b
        shape = (b * dist.get_world_size(group),) + tuple(x.shape[1:])
        mask = torch.rand(shape, generator=generator, device=x.device)[first:first + b] < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``softmax(q k^T / sqrt(d)) v`` over ``[N, heads, L, d]``: the flash
    backend on the card for half types (nothing else: a fallback raises),
    the math backend for float32 and on the CPU."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    COUNTS["attention"] += 1
    flash = q.device.type == "cuda" and q.dtype in (torch.bfloat16, torch.float16)
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION if flash else SDPBackend.MATH):
        return F.scaled_dot_product_attention(q, k, v)


def _group_norm(x: torch.Tensor, gn: nn.GroupNorm, p: Dict) -> torch.Tensor:
    COUNTS["group_norm"] += 1
    return F.group_norm(x, gn.num_groups, *p[gn], gn.eps)


class Bottleneck(nn.Module):
    """``PreActBottleneck`` of the source: conv1x1 -> GN -> ReLU, conv3x3
    (stride) -> GN -> ReLU, conv1x1 -> GN, plus the residual, ReLU."""

    def __init__(self, cin: int, cout: int, cmid: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cmid, 1, bias=False)
        self.gn1 = nn.GroupNorm(GN_GROUPS, cmid, eps=GN_EPS)
        self.conv2 = nn.Conv2d(cmid, cmid, 3, stride=stride, padding=1, bias=False)
        self.gn2 = nn.GroupNorm(GN_GROUPS, cmid, eps=GN_EPS)
        self.conv3 = nn.Conv2d(cmid, cout, 1, bias=False)
        self.gn3 = nn.GroupNorm(GN_GROUPS, cout, eps=GN_EPS)
        self.projects = stride != 1 or cin != cout
        if self.projects:
            self.downsample = nn.Conv2d(cin, cout, 1, stride=stride, bias=False)
            self.gn_proj = nn.GroupNorm(cout, cout)

    def forward(self, x: torch.Tensor, p: Dict) -> torch.Tensor:
        """``p``: each conv's standardized weight and each GroupNorm's
        ``(weight, bias)``, in the compute dtype."""
        def conv(y, c):
            return F.conv2d(y, p[c], None, c.stride, c.padding)

        residual = x
        if self.projects:
            residual = _group_norm(conv(x, self.downsample), self.gn_proj, p)
        y = torch.relu(_group_norm(conv(x, self.conv1), self.gn1, p))
        y = torch.relu(_group_norm(conv(y, self.conv2), self.gn2, p))
        y = _group_norm(conv(y, self.conv3), self.gn3, p)
        return torch.relu(residual + y)


class ResNetBlock(nn.Module):
    """Units ``unit1`` ... ``unitN``; the first takes the stride."""

    def __init__(self, units: int, cin: int, cout: int, cmid: int, stride: int):
        super().__init__()
        self.units = units
        for i in range(1, units + 1):
            self.add_module(f"unit{i}", Bottleneck(cin if i == 1 else cout, cout, cmid,
                                                   stride if i == 1 else 1))

    def forward(self, x: torch.Tensor, p: Dict) -> torch.Tensor:
        for i in range(1, self.units + 1):
            x = getattr(self, f"unit{i}")(x, p)
        return x


class Root(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.conv = nn.Conv2d(3, width, 7, stride=2, padding=3, bias=False)
        self.gn = nn.GroupNorm(GN_GROUPS, width, eps=GN_EPS)


class ResNetV2(nn.Module):
    """The hybrid encoder's ResNet: ``(x at 1/16, [skip 1, skip 2, skip 3])``.
    It runs in NCHW (PyTorch's GroupNorm on the card copies a channels-last
    input to NCHW and back); the skips leave it channels-last."""

    def __init__(self, block_units: Sequence[int], width: int):
        super().__init__()
        self.root = Root(width)
        self.block1 = ResNetBlock(block_units[0], width, 4 * width, width, 1)
        self.block2 = ResNetBlock(block_units[1], 4 * width, 8 * width, 2 * width, 2)
        self.block3 = ResNetBlock(block_units[2], 8 * width, 16 * width, 4 * width, 2)

    def parameters_in(self, dt: torch.dtype) -> Dict:
        """Every body conv's standardized weight and every GroupNorm's
        ``(weight, bias)`` in ``dt``, by module, in a few launches."""
        convs = [m for m in self.modules() if isinstance(m, nn.Conv2d) and m is not self.root.conv]
        norms = [m for m in self.modules() if isinstance(m, nn.GroupNorm)]
        affine = views(cast_together([t for g in norms for t in (g.weight, g.bias)], dt),
                       [t.shape for g in norms for t in (g.weight, g.bias)])
        p = standardized_together(convs, dt)
        p.update({g: (affine[2 * i], affine[2 * i + 1]) for i, g in enumerate(norms)})
        return p

    def forward(self, x: torch.Tensor, dt: torch.dtype):
        size = x.shape[2]
        p = self.parameters_in(dt)
        w = standardized(self.root.conv.weight)
        if x.shape[1] == 1:  # a one-channel input repeated to the conv's three
            w = w.sum(dim=1, keepdim=True)
        x = F.conv2d(x, w.to(dt), None, self.root.conv.stride, self.root.conv.padding)
        x = torch.relu(_group_norm(x, self.root.gn, p))
        features = [x]
        x = F.max_pool2d(x, 3, 2, 0)
        for i, block in enumerate((self.block1, self.block2)):
            x = block(x, p)
            right = size // 4 // (i + 1)
            pad = right - x.shape[2]
            # the source's zero pad at the bottom and right (127 -> 128)
            features.append(F.pad(x, (0, pad, 0, pad)) if pad else x)
        skips = [f.contiguous(memory_format=torch.channels_last) for f in features[::-1]]
        return self.block3(x, p), skips


class Embeddings(nn.Module):
    def __init__(self, cin: int, hidden: int, n_patches: int):
        super().__init__()
        self.patch = nn.Conv2d(cin, hidden, 1)
        self.position = nn.Parameter(torch.zeros(1, n_patches, hidden))


class Attention(nn.Module):
    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.heads = heads
        self.query = nn.Linear(hidden, hidden)
        self.key = nn.Linear(hidden, hidden)
        self.value = nn.Linear(hidden, hidden)
        self.out = nn.Linear(hidden, hidden)


class Mlp(nn.Module):
    def __init__(self, hidden: int, mlp_dim: int):
        super().__init__()
        self.fc1 = nn.Linear(hidden, mlp_dim)
        self.fc2 = nn.Linear(mlp_dim, hidden)


class Layer(nn.Module):
    def __init__(self, hidden: int, heads: int, mlp_dim: int):
        super().__init__()
        self.attention_norm = nn.LayerNorm(hidden, eps=LN_EPS)
        self.attn = Attention(hidden, heads)
        self.ffn_norm = nn.LayerNorm(hidden, eps=LN_EPS)
        self.ffn = Mlp(hidden, mlp_dim)

    def tensors(self) -> List[torch.Tensor]:
        """The layer's parameters in :meth:`forward`'s order: q, k and v's
        weights side by side, then their biases, so that their casts are
        one ``[3 * hidden, hidden]`` weight and one bias."""
        a, f = self.attn, self.ffn
        return [self.attention_norm.weight, self.attention_norm.bias,
                a.query.weight, a.key.weight, a.value.weight, a.query.bias, a.key.bias,
                a.value.bias, a.out.weight, a.out.bias, self.ffn_norm.weight,
                self.ffn_norm.bias, f.fc1.weight, f.fc1.bias, f.fc2.weight, f.fc2.bias]

    def forward(self, x: torch.Tensor, p: List[torch.Tensor], drop) -> torch.Tensor:
        """``p``: :meth:`tensors` in the compute dtype, q, k and v fused."""
        ln1_w, ln1_b, qkv_w, qkv_b, out_w, out_b, ln2_w, ln2_b, fc1_w, fc1_b, fc2_w, fc2_b = p
        n, length, hidden = x.shape
        y = F.layer_norm(x, (hidden,), ln1_w, ln1_b, self.attention_norm.eps)
        qkv = F.linear(y, qkv_w, qkv_b).view(n, length, 3, self.attn.heads, -1)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
        ctx = attention(q, k, v).transpose(1, 2).reshape(n, length, hidden)
        x = x + F.linear(ctx, out_w, out_b)
        y = F.layer_norm(x, (hidden,), ln2_w, ln2_b, self.ffn_norm.eps)
        y = drop(F.gelu(F.linear(y, fc1_w, fc1_b)))
        return x + drop(F.linear(y, fc2_w, fc2_b))


class Conv2dReLU(nn.Module):
    """3x3 conv without bias -> BatchNorm -> ReLU, the last two as K4."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3, padding=1, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=BN_EPS, momentum=BN_MOMENTUM)

    def forward(self, x: torch.Tensor, dt: torch.dtype, group=None) -> torch.Tensor:
        x = F.conv2d(x, _weight(self.conv.weight, dt), padding=1)
        # K4's momentum is the running statistics' share: 1 - torch's
        return conv_bn(x, None, RELU_AFTER, self.bn, 1.0 - self.bn.momentum, group)


class DecoderBlock(nn.Module):
    def __init__(self, cin: int, cout: int, skip: int):
        super().__init__()
        self.conv1 = Conv2dReLU(cin + skip, cout)
        self.conv2 = Conv2dReLU(cout, cout)

    def forward(self, x, skip, dt, group=None):
        x = F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)
        if skip is not None:
            x = torch.cat([x, skip], dim=1)
        return self.conv2(self.conv1(x, dt, group), dt, group)


class Decoder(nn.Module):
    def __init__(self, hidden: int, head_channels: int, channels: Sequence[int],
                 skips: Sequence[int]):
        super().__init__()
        self.conv_more = Conv2dReLU(hidden, head_channels)
        cins = [head_channels] + list(channels[:-1])
        self.blocks = nn.ModuleList(DecoderBlock(a, b, s)
                                    for a, b, s in zip(cins, channels, skips))


class TransUNet(nn.Module):
    """TransUNet R50-ViT-B/16 at ``img_size`` (square, a multiple of 16: the
    position embeddings fix the tile). Defaults are the published widths."""

    kind = KIND

    def __init__(self, num_classes: int = 2, num_channels: int = 1, img_size: int = 512,
                 dtype: Union[str, torch.dtype] = torch.bfloat16, width: int = 64,
                 block_units: Sequence[int] = (3, 4, 9), hidden: int = 768,
                 num_layers: int = 12, num_heads: int = 12, mlp_dim: int = 3072,
                 head_channels: int = 512,
                 decoder_channels: Sequence[int] = (256, 128, 64, 16), n_skip: int = 3):
        super().__init__()
        if num_channels not in (1, 3):
            raise ValueError(f"TransUNet takes 1 or 3 channels (its root conv takes 3, a "
                             f"single channel repeated), got {num_channels}")
        if img_size % 16:
            raise ValueError(f"TransUNet's img_size must be a multiple of 16, got {img_size}")
        if hidden % num_heads:
            raise ValueError(f"hidden {hidden} is not a multiple of num_heads {num_heads}")
        self.num_classes, self.num_channels, self.img_size = num_classes, num_channels, img_size
        self.width, self.block_units = width, tuple(block_units)
        self.hidden, self.num_layers, self.num_heads = hidden, num_layers, num_heads
        self.mlp_dim, self.head_channels = mlp_dim, head_channels
        self.decoder_channels, self.n_skip = tuple(decoder_channels), n_skip
        self.dtype = as_dtype(dtype)
        self.resnet = ResNetV2(self.block_units, width)
        self.embed = Embeddings(16 * width, hidden, (img_size // 16) ** 2)
        self.layers = nn.ModuleList(Layer(hidden, num_heads, mlp_dim) for _ in range(num_layers))
        self.encoder_norm = nn.LayerNorm(hidden, eps=LN_EPS)
        skips = [8 * width, 4 * width, width, 0][:n_skip] + [0] * (4 - n_skip)
        self.decoder = Decoder(hidden, head_channels, self.decoder_channels, skips)
        self.head = nn.Conv2d(self.decoder_channels[-1], num_classes, 3, padding=1)
        # 0 turns dropout off in train mode too
        self.dropout_rate = DROPOUT_RATE
        # data parallelism: the process group train-mode BatchNorm reduces
        # its sums over and dropout draws its global masks for
        self.process_group = None
        # spatial partitioning sets it; TransUNet refuses it
        self.halo = None

    def config(self) -> dict:
        """Constructor arguments, as the port's checkpoint stores them."""
        return {"num_classes": self.num_classes, "num_channels": self.num_channels,
                "img_size": self.img_size, "width": self.width,
                "block_units": list(self.block_units), "hidden": self.hidden,
                "num_layers": self.num_layers, "num_heads": self.num_heads,
                "mlp_dim": self.mlp_dim, "head_channels": self.head_channels,
                "decoder_channels": list(self.decoder_channels), "n_skip": self.n_skip}

    def initialize(self, generator: Optional[torch.Generator] = None) -> "TransUNet":
        """:func:`init_transunet`."""
        return init_transunet(self, generator)

    def vit(self, x: torch.Tensor, dt: torch.dtype, drop) -> torch.Tensor:
        """The ResNet's NCHW output -> the encoder's ``[N, L, D]`` tokens. Its
        parameters are cast in one go; the 1x1 patch conv is a linear over
        the tokens."""
        e, h = self.embed, self.hidden
        per_layer = [layer.tensors() for layer in self.layers]
        tensors = [e.patch.weight, e.patch.bias, e.position] + \
            [t for ts in per_layer for t in ts] + [self.encoder_norm.weight, self.encoder_norm.bias]
        flat = cast_together(tensors, dt)
        shapes = [(h, e.patch.weight[0].numel()), (h,), e.position.shape]
        for _ in self.layers:  # q, k and v's weights and biases as one of each
            shapes += [(h,), (h,), (3 * h, h), (3 * h,), (h, h), (h,), (h,), (h,),
                       (self.mlp_dim, h), (self.mlp_dim,), (h, self.mlp_dim), (h,)]
        p = views(flat, shapes + [(h,), (h,)])
        n, c, rows, cols = x.shape
        x = F.linear(x.permute(0, 2, 3, 1).reshape(n, rows * cols, c), p[0], p[1])
        x = drop(x + p[2])
        for i, layer in enumerate(self.layers):
            x = layer(x, p[3 + 12 * i:15 + 12 * i], drop)
        return F.layer_norm(x, (h,), p[-2], p[-1], self.encoder_norm.eps)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """NHWC batch -> NHWC float32 logits. In train mode BatchNorm uses
        (and updates) batch statistics and dropout draws its masks from
        ``generator`` (on ``x``'s device; None uses torch's global one), in
        the order of the module docstring."""
        if x.ndim != 4 or x.shape[1] != self.img_size or x.shape[2] != self.img_size:
            raise ValueError(f"TransUNet at img_size {self.img_size} takes NHWC batches of "
                             f"{self.img_size}^2 tiles, got shape {tuple(x.shape)}")
        if self.halo is not None:
            raise ValueError("TransUNet cannot be spatially partitioned: its attention is "
                             "global over the tile")
        dt = self.dtype
        group = self.process_group if self.training else None
        rate = self.dropout_rate if self.training else 0.0

        def drop(t):
            return _dropout(t, rate, generator, group) if rate else t

        x = x.to(dt).permute(0, 3, 1, 2).contiguous()
        with span("model.resnet"):
            x, skips = self.resnet(x, dt)
        with span("model.vit"):
            x = self.vit(x, dt, drop)
        with span("model.decoder"):
            # the tokens as an NCHW view with channels-last strides
            n, side = x.shape[0], self.img_size // 16
            x = x.view(n, side, side, self.hidden).permute(0, 3, 1, 2)
            x = self.decoder.conv_more(x, dt, group)
            for i, block in enumerate(self.decoder.blocks):
                x = block(x, skips[i] if i < self.n_skip else None, dt, group)
            x = F.conv2d(x, _weight(self.head.weight, dt), self.head.bias.to(dt), padding=1)
        return x.permute(0, 2, 3, 1).float()


def init_transunet(model: TransUNet,
                   generator: Optional[torch.Generator] = None) -> TransUNet:
    """The source's initialization, drawn from ``generator``: PyTorch's
    defaults for the convs and the attention's linears (kaiming-uniform,
    ``a = sqrt(5)``, biases uniform in ``+-1/sqrt(fan_in)``), xavier-uniform
    MLP weights with N(0, 1e-6^2) biases, norms' scale 1 and shift 0, and
    position embeddings N(0, 0.02^2) (the source's are zeros, loaded from
    ImageNet-21k weights)."""
    g = generator
    mlps = {m.fc1 for m in model.modules() if isinstance(m, Mlp)} | \
        {m.fc2 for m in model.modules() if isinstance(m, Mlp)}
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            if m in mlps:
                nn.init.xavier_uniform_(m.weight, generator=g)
                nn.init.normal_(m.bias, std=1e-6, generator=g)
                continue
            nn.init.kaiming_uniform_(m.weight, a=math.sqrt(5), generator=g)
            if m.bias is not None:
                bound = 1.0 / math.sqrt(m.weight[0].numel())
                nn.init.uniform_(m.bias, -bound, bound, generator=g)
        elif isinstance(m, (nn.GroupNorm, nn.LayerNorm, nn.BatchNorm2d)):
            m.reset_parameters()
    nn.init.normal_(model.embed.position, std=POSITION_STD, generator=g)
    return model
