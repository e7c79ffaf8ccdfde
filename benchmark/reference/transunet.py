"""The plain reference TransUNet: float32 PyTorch operations and nothing else.

github.com/Beckschen/TransUNet's R50-ViT-B/16 (``networks/vit_seg_modeling
.py``, ``vit_seg_modeling_resnet_skip.py``) written out op by op in NCHW on
the weights dict of ``harness/transunet_weights.py``: the single channel
repeated to three, weight-standardized convs (``(w - mean) / sqrt(var +
1e-5)``, the biased variance), GroupNorm(32, eps 1e-6) and the projection's
GroupNorm(cout, cout, eps 1e-5), the 3x3/2 max pool without padding, block
1's output zero-padded at the bottom and right to ``S/4``; the 1x1 patch
embedding, the tokens plus the position embeddings, pre-LN layers
(LayerNorm eps 1e-6) with attention as an explicit softmax of ``qk^T /
sqrt(64)``, exact GELU; then the decoder's bilinear x2 upsamplings
(``align_corners=True``), the concats ``[x, skip]``, conv -> BatchNorm (eps
1e-5) -> ReLU, and the 3x3 head. It imports nothing of the program. TF32 is
turned off while it runs (``reference/unet.py::no_tf32``), so a float32
product stays float32 on the card.

``train`` normalizes BatchNorm with the batch's mean and biased variance
and applies dropout (rate 0.1) with masks drawn from ``g_drop`` as the
program draws them: ``torch.rand(shape) < 0.9`` for the embeddings ``[N, L,
D]``, then each layer's MLP after the GELU ``[N, L, mlp]`` and after fc2
``[N, L, D]``. Eval mode uses the running statistics and no dropout.

``dtype`` narrower than float32 keeps the activations and their gradients
in that dtype, with every conv and linear computed on operands rounded to
it and every norm, softmax and GELU computed in float32 and rounded back (a
yardstick for the rounding of that precision, not the reference); float64
computes all of it in float64 (for the tests). ``fp8``
makes it the control that computes in the precision below bf16, as fp8
training does: every conv and every linear takes its input and weight
rounded to float8 e4m3 forward and its output gradient rounded to e5m2
backward, each on a per-tensor scale, with float32 sums.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from reference.train import E4M3_MAX, E5M2_MAX, _round

GN_GROUPS, GN_EPS, STD_EPS, LN_EPS, BN_EPS = 32, 1e-6, 1e-5, 1e-6, 1e-5
DROPOUT = 0.1


def _wide(y: torch.Tensor) -> torch.Tensor:
    """``y`` in float32, or as it is where it is wider already."""
    return y if y.dtype in (torch.float32, torch.float64) else y.float()


class _Fp8(torch.autograd.Function):
    """``op(x, w, b)`` computed as fp8 training computes it: e4m3 input and
    weight forward, e5m2 output gradient backward, float32 sums."""

    @staticmethod
    def forward(ctx, x, w, b, op):
        xq, wq = _round(x, torch.float8_e4m3fn, E4M3_MAX), _round(w, torch.float8_e4m3fn,
                                                                  E4M3_MAX)
        ctx.save_for_backward(xq, wq, b)
        ctx.op = op
        return op(xq, wq, b)

    @staticmethod
    def backward(ctx, gy):
        xq, wq, b = ctx.saved_tensors
        gq = _round(gy, torch.float8_e5m2, E5M2_MAX)
        with torch.enable_grad():
            x_, w_ = xq.detach().requires_grad_(True), wq.detach().requires_grad_(True)
            b_ = None if b is None else b.detach().requires_grad_(True)
            inputs = [t for t in (x_, w_, b_) if t is not None]
            grads = list(torch.autograd.grad(ctx.op(x_, w_, b_), inputs, gq))
        return grads[0], grads[1], grads[2] if b is not None else None, None


def _cfg_numbers(cfg: dict):
    t = cfg["transformer"]
    return (cfg["resnet"]["num_layers"], t["num_layers"], t["num_heads"], cfg["n_skip"])


def forward(w: Dict[str, torch.Tensor], x: torch.Tensor, cfg: dict, train: bool = False,
            g_drop: Optional[torch.Generator] = None, fp8: bool = False,
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """NHWC float32 batch -> NHWC float32 logits."""
    units, layers, heads, n_skip = _cfg_numbers(cfg)

    def product(op: Callable, y, weight, bias):
        if fp8:
            return _Fp8.apply(y, weight, bias, op)
        return op(y, weight.to(dtype), None if bias is None else bias.to(dtype))

    def conv(y, name, stride=1, padding=0, std=False, bias=False):
        k = w[f"{name}.weight"]
        if std:
            var, mean = torch.var_mean(k, dim=(1, 2, 3), keepdim=True, correction=0)
            k = (k - mean) / torch.sqrt(var + STD_EPS)
        b = w[f"{name}.bias"] if bias else None
        return product(lambda a, kk, bb: F.conv2d(a, kk, bb, stride, padding), y, k, b)

    def linear(y, name):
        return product(F.linear, y, w[f"{name}.weight"], w[f"{name}.bias"])

    def gn(y, name, groups=GN_GROUPS, eps=GN_EPS):
        return F.group_norm(_wide(y), groups, w[f"{name}.weight"].to(_wide(y).dtype),
                            w[f"{name}.bias"].to(_wide(y).dtype), eps).to(dtype)

    def ln(y, name):
        return F.layer_norm(_wide(y), (y.shape[-1],), w[f"{name}.weight"].to(_wide(y).dtype),
                            w[f"{name}.bias"].to(_wide(y).dtype), LN_EPS).to(dtype)

    def drop(y):
        if not train:
            return y
        keep = 1.0 - DROPOUT
        mask = torch.rand(y.shape, generator=g_drop, device=y.device) < keep
        return torch.where(mask, y / keep, torch.zeros((), dtype=y.dtype, device=y.device))

    def bn_relu(y, name):
        yf = _wide(y)
        if train:
            var, mean = torch.var_mean(yf, dim=(0, 2, 3), correction=0)
        else:
            mean, var = w[f"{name}.running_mean"], w[f"{name}.running_var"]
        scale = torch.rsqrt(var + BN_EPS) * w[f"{name}.weight"]
        out = ((yf - mean[None, :, None, None]) * scale[None, :, None, None]
               + w[f"{name}.bias"][None, :, None, None])
        return torch.relu(out).to(dtype)

    x = x.to(dtype).permute(0, 3, 1, 2)
    if x.shape[1] == 1:
        x = x.repeat(1, 3, 1, 1)
    size = x.shape[2]
    # the ResNet
    x = torch.relu(gn(conv(x, "resnet.root.conv", 2, 3, std=True), "resnet.root.gn"))
    features = [x]
    x = F.max_pool2d(x, 3, 2, 0)
    for b in range(3):
        for u in range(1, units[b] + 1):
            p = f"resnet.block{b + 1}.unit{u}"
            stride = 2 if b > 0 and u == 1 else 1
            residual = x
            if u == 1:
                residual = gn(conv(x, f"{p}.downsample", stride, std=True), f"{p}.gn_proj",
                              groups=w[f"{p}.gn_proj.weight"].shape[0], eps=1e-5)
            y = torch.relu(gn(conv(x, f"{p}.conv1", std=True), f"{p}.gn1"))
            y = torch.relu(gn(conv(y, f"{p}.conv2", stride, 1, std=True), f"{p}.gn2"))
            y = gn(conv(y, f"{p}.conv3", std=True), f"{p}.gn3")
            x = torch.relu(residual + y)
        if b < 2:
            right = size // 4 // (b + 1)
            feat = torch.zeros((x.shape[0], x.shape[1], right, right), dtype=x.dtype,
                               device=x.device)
            feat[:, :, :x.shape[2], :x.shape[3]] = x
            features.append(feat)
    # the ViT
    x = conv(x, "embed.patch", bias=True)
    n, d, h, wd = x.shape
    x = drop(x.flatten(2).transpose(1, 2) + w["embed.position"].to(dtype))
    dh = d // heads
    for i in range(layers):
        p = f"layers.{i}"
        y = ln(x, f"{p}.attention_norm")
        q, k, v = (linear(y, f"{p}.attn.{t}").view(n, -1, heads, dh).transpose(1, 2)
                   for t in ("query", "key", "value"))
        scores = _wide(torch.matmul(q, k.transpose(-1, -2))) / dh ** 0.5
        probs = torch.softmax(scores, dim=-1).to(dtype)
        ctx = torch.matmul(probs, v).transpose(1, 2).reshape(n, -1, d)
        x = x + linear(ctx, f"{p}.attn.out")
        y = ln(x, f"{p}.ffn_norm")
        y = drop(F.gelu(_wide(linear(y, f"{p}.ffn.fc1"))).to(dtype))
        x = x + drop(linear(y, f"{p}.ffn.fc2"))
    x = ln(x, "encoder_norm")
    # the decoder
    x = x.transpose(1, 2).reshape(n, d, h, wd)
    x = bn_relu(conv(x, "decoder.conv_more.conv", padding=1), "decoder.conv_more.bn")
    skips = features[::-1]
    for i in range(4):
        x = F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)
        if i < n_skip:
            x = torch.cat([x, skips[i]], dim=1)
        for c in ("conv1", "conv2"):
            p = f"decoder.blocks.{i}.{c}"
            x = bn_relu(conv(x, f"{p}.conv", padding=1), f"{p}.bn")
    x = conv(x, "head", padding=1, bias=True)
    return _wide(x.permute(0, 2, 3, 1))
