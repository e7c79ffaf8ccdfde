"""The plain reference train step: float32 PyTorch, autograd, Keras Adam.

usnistgov ``UNet/model.py:85-146, 204-228`` in train mode: each conv block
is a same conv with bias, ReLU, then BatchNorm on the batch's mean and
biased variance (Keras: eps 1e-3); dropout (rate 0.5) after the fourth
level and after the bottleneck, its masks drawn from a generator on the
device as the program draws them; the loss is the per-pixel categorical
cross-entropy from a float32 log-softmax, summed over the batch, divided
by the batch and averaged over the pixels (``model.py:211-215``); Adam
follows the Keras rule (``eps`` 1e-7 on the uncorrected root of the second
moment, ``lr * sqrt(1 - b2^t) / (1 - b1^t)``). Batches are augmented by
:mod:`reference.augment` from a generator seeded as the program's. It
imports nothing of the program, and TF32 is off while it runs.

``fp8`` makes it the control that computes in the precision below the
configuration's bf16, as fp8 training does: every conv takes its input
and weights rounded to float8 e4m3 forward and its output gradient rounded
to e5m2 backward, each on a per-tensor scale, with float32 sums.

:func:`compare` gives the numbers that decide ``correct``.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from reference import augment
from reference import unet

BETAS, ADAM_EPS, DROPOUT = (0.9, 0.999), 1e-7, 0.5
DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}
E4M3_MAX, E5M2_MAX = 448.0, 57344.0


def trainable(weights: Dict[str, torch.Tensor]) -> List[str]:
    return [k for k in weights if "running" not in k]


def _round(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """``x`` rounded to the float8 ``dtype`` on a per-tensor scale that
    maps its largest magnitude to ``top``, back in float32."""
    scale = x.abs().amax().clamp_min(1e-30) / top
    return (x / scale).to(dtype).float() * scale


class _Fp8Conv(torch.autograd.Function):
    """A conv (``transposed``: a 2x2 stride-2 transposed conv) computed as
    fp8 training computes it: e4m3 input and weights forward, e5m2 output
    gradient backward, each GEMM's products summed in float32."""

    @staticmethod
    def forward(ctx, x, k, bias, transposed: bool):
        xq, kq = _round(x, torch.float8_e4m3fn, E4M3_MAX), _round(k, torch.float8_e4m3fn,
                                                                  E4M3_MAX)
        ctx.save_for_backward(xq, kq, bias)
        ctx.transposed = transposed
        return _conv(xq, kq, bias, transposed)

    @staticmethod
    def backward(ctx, gy):
        xq, kq, bias = ctx.saved_tensors
        gq = _round(gy, torch.float8_e5m2, E5M2_MAX)
        with torch.enable_grad():
            x_, k_ = xq.detach().requires_grad_(True), kq.detach().requires_grad_(True)
            b_ = None if bias is None else bias.detach().requires_grad_(True)
            inputs = [t for t in (x_, k_, b_) if t is not None]
            grads = list(torch.autograd.grad(_conv(x_, k_, b_, ctx.transposed), inputs, gq))
        gx, gk = grads[0], grads[1]
        return gx, gk, grads[2] if bias is not None else None, None


def _conv(x, k, bias, transposed: bool):
    if transposed:
        return F.conv_transpose2d(x, k, stride=2)
    return F.conv2d(x, k, bias, padding=k.shape[-1] // 2)


def forward(w: Dict[str, torch.Tensor], x: torch.Tensor, g_drop: torch.Generator,
            levels: int = 4, fp8: bool = False,
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """NHWC float32 batch -> NHWC float32 logits, BatchNorm on batch
    statistics. ``dtype`` other than float32 keeps the activations and
    their gradients in that dtype and computes each BatchNorm in float32
    (a yardstick for the rounding of that precision, not the reference)."""
    def conv_op(y, k, bias, transposed=False):
        if fp8:
            return _Fp8Conv.apply(y, k, bias, transposed)
        return _conv(y, k.to(dtype), None if bias is None else bias.to(dtype), transposed)

    x = x.to(dtype).permute(0, 3, 1, 2)

    def bn(y, name):
        yf = y.float()
        var, mean = torch.var_mean(yf, dim=(0, 2, 3), correction=0)
        scale = torch.rsqrt(var + unet.EPS) * w[f"{name}.bn.weight"]
        return ((yf - mean[None, :, None, None]) * scale[None, :, None, None]
                + w[f"{name}.bn.bias"][None, :, None, None]).to(dtype)

    def conv(name, y):
        y = conv_op(y, w[f"{name}.conv.weight"], w[f"{name}.conv.bias"])
        return bn(torch.relu(y), name)

    def drop(y):
        keep = 1.0 - DROPOUT
        mask = torch.rand(y.shape, generator=g_drop, device=y.device) < keep
        return torch.where(mask, y / keep, torch.zeros((), dtype=y.dtype, device=y.device))

    skips = []
    for i in range(levels):
        name = f"enc{i + 1}"
        x = conv(name + "b", conv(name + "a", x))
        if i == levels - 1:
            x = drop(x)
        skips.append(x)
        x = F.max_pool2d(x, 2)
    x = drop(conv("bottleneckb", conv("bottlenecka", x)))
    for level in range(levels, 0, -1):
        name = f"dec{level}"
        up = bn(conv_op(x, w[f"{name}up.deconv.weight"], None, True), name + "up")
        x = conv(name + "b", conv(name + "a", torch.cat([skips[level - 1], up], dim=1)))
    return conv("head", x).permute(0, 2, 3, 1).float()


def loss_fn(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    per_pixel = -torch.sum(labels * torch.log_softmax(logits.float(), dim=-1), dim=-1)
    return torch.mean(torch.sum(per_pixel, dim=0) / logits.shape[0])


def run_steps(weights: Dict[str, torch.Tensor], batches, aug_seed: int, drop_seed: int,
              lr: float, aug_params: Dict, num_classes: int, levels: int, device,
              fp8: bool = False, dtype: torch.dtype = torch.float32) -> Dict:
    """Train from ``weights`` on ``batches`` (raw images and masks), one step
    each: ``losses``, the first step's gradient norm of each leaf
    (``grad_norms``) and each leaf's change after the last step
    (``change_norms``)."""
    names = trainable(weights)
    leaves = {k: weights[k].detach().clone().float().requires_grad_(True) for k in names}
    m = {k: torch.zeros_like(v) for k, v in leaves.items()}
    v2 = {k: torch.zeros_like(v) for k, v in leaves.items()}
    g_aug = torch.Generator(device=device).manual_seed(aug_seed)
    g_drop = torch.Generator(device=device).manual_seed(drop_seed)
    b1, b2 = BETAS
    out = {"losses": []}
    with unet.no_tf32():
        for t, (img, msk) in enumerate(batches, start=1):
            x, y = augment.augment(g_aug, img, msk, aug_params, num_classes)
            loss = loss_fn(forward(leaves, x, g_drop, levels, fp8, dtype), y)
            grads = dict(zip(names, torch.autograd.grad(loss, [leaves[k] for k in names])))
            out["losses"].append(float(loss.detach()))
            if t == 1:
                out["grads"] = {k: g.detach().clone() for k, g in grads.items()}
                out["grad_norms"] = {k: float(g.norm()) for k, g in grads.items()}
            scale = (1.0 - b2 ** t) ** 0.5 / (1.0 - b1 ** t)
            with torch.no_grad():
                for k in names:
                    m[k].mul_(b1).add_(grads[k] * (1 - b1))
                    v2[k].mul_(b2).add_(grads[k] * grads[k] * (1 - b2))
                    leaves[k].add_(-lr * m[k] * scale / (torch.sqrt(v2[k]) + ADAM_EPS))
            del grads, loss, x, y
    out["change_norms"] = {k: float((leaves[k].detach() - weights[k]).norm()) for k in names}
    return out


def _median(values) -> float:
    v = sorted(values)
    return v[len(v) // 2] if v else 0.0


def compare(got: Dict, ref: Dict, still: float = 1e-3, yardstick: Dict = None
            ) -> Dict[str, float]:
    """The numbers: ``loss_gap``, the largest over the steps of the gap
    between the losses over the reference's; ``grad_gap`` and
    ``change_gap``, the worst leaf's gap between the program's norm and the
    reference's (first gradient; change after the steps), over the larger
    of the reference's norm of that leaf and the median leaf's; and
    ``grad_err`` and ``grad_err_median``, the worst and the median leaf's
    norm of the difference of the first gradients over the same scale,
    which read the noise of each element (the norms of two gradients part
    little where one carries unbiased noise). With ``yardstick`` (the
    reference computed in the configuration's precision), ``grad_dev``:
    the median over the leaves of the norm of the difference between the
    program's first gradient and the yardstick's, over the yardstick's own
    from the reference's: how far the program computes from a computation
    in its stated precision, in units of that precision's departure from
    float32. Leaves whose reference gradient is under ``still`` times the
    median leaf's move by round-off alone and are left out."""
    med_g = _median(ref["grad_norms"].values())
    keep = [k for k, g in ref["grad_norms"].items() if g >= still * med_g]
    med_c = _median(ref["change_norms"][k] for k in keep)

    def gaps(kind, med):
        return {k: abs(got[kind][k] - ref[kind][k]) / max(ref[kind][k], med) for k in keep}

    def worst(kind, med):
        return max(gaps(kind, med).values())

    errs = leaf_errors(got, ref, keep, med_g)
    out = {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"])),
           "grad_gap": worst("grad_norms", med_g),
           "change_gap": worst("change_norms", med_c),
           "grad_err": max(errs.values()),
           "grad_err_median": _median(errs.values()),
           "worst_leaf": {kind: max(gaps(kind, med).items(), key=lambda kv: kv[1])[0]
                          for kind, med in (("grad_norms", med_g), ("change_norms", med_c))}}
    if yardstick is not None:
        ys = leaf_errors(yardstick, ref, keep, med_g)
        dev = leaf_errors(got, yardstick, keep, med_g)
        out["grad_dev"] = _median(dev[k] / ys[k] if ys[k] > 0 else float("inf") for k in keep)
    return out


def leaf_errors(got: Dict, ref: Dict, keep, med_g: float) -> Dict[str, float]:
    """Each leaf's norm of the difference of the first gradients over the
    larger of ``ref``'s norm of that leaf and ``med_g``."""
    return {k: float((got["grads"][k].float().cpu() - ref["grads"][k].float().cpu()).norm())
            / max(ref["grad_norms"][k], med_g) for k in keep}
