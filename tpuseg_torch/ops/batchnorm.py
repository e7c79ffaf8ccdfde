"""K4: the conv block's bias + ReLU + BatchNorm, and the deconv block's
BatchNorm, as hand kernels with a hand backward, in two orders: the
U-Net's ReLU before the normalization, and TransUNet's after it.

Counterpart of the BatchNorm of ``tpuseg/models/unet.py`` (``ConvBlock``,
``:94-102``: conv, ``+ bias``, ``nn.relu``, ``nn.BatchNorm``; ``DeconvBlock``,
``:163-170``: deconv, ``nn.BatchNorm``), which XLA fuses on the TPU. The
input ``x`` is the conv's output without its bias, in the model's dtype, an
NCHW view whose memory is rows of channels: ``[M = N*H*W, C]`` with a row
stride ``ld >= C`` (channels-last when ``ld == C``; a channel slice of a
channels-last tensor otherwise). Per channel, with flax's roundings:

    a    = relu(r(x + r(bias)))        (r: round to x's dtype; bias, relu optional)
    y    = r(((a - mean) * mul) + beta),   mul = rsqrt(var + eps) * gamma

in f32, each operation rounded on its own (``flax.linen.normalization.
_normalize``'s order). Train mode takes ``mean`` and the fast variance
``var = max(E[a^2] - E[a]^2, 0)`` of the batch (flax's, clipped at 0), eval
mode the running statistics. Four kernels, in
``tpuseg_torch/csrc/batchnorm.cu``:

- (a) :func:`batch_stats`: per channel ``[sum a, sum a^2, n]`` in f32, per-block
  partials reduced by the last block in a fixed order (deterministic);
- (b) ``y = r(((a - mean) * mul) + beta)``: :func:`bn_apply_train` derives
  ``mean`` and ``mul`` in the kernel from (a)'s sums as :func:`finalize`
  does (and writes them, ``[mean, var, rstd, mul, unclipped]``, and updates
  the running statistics), :func:`bn_apply_eval` from the running
  statistics; both with two store forms: ``y`` into a channel slice of a
  wider channels-last buffer (the decoder's concat), and the 2x2/2 max of
  ``y`` as a second output of the same pass (``F.max_pool2d(y, 2)`` bit for
  bit);
- (c) :func:`backward_reduce`: per channel ``[sum g, sum g*ahat]`` with
  ``ahat = (a - mean) * rstd``, and with a bias also ``[sum relu'*g, sum
  relu', sum relu'*ahat]``, from which the bias gradient follows without a
  third pass; with ``gp``, the gradient of (b)'s pooled output, its pooled
  form (below);
- (d) :func:`backward_apply`: ``dx = relu' * ((g - k1) - ahat * k2) * mul``
  with per-channel ``k1 = sum g / n``, ``k2 = sum g*ahat / n`` given (zero in
  eval mode, whose input gradient the ERF probe takes);
  :func:`backward_apply_train` derives them in the kernel from (c)'s sums
  and writes the bias gradient too, and has the pooled form as (c) does.

The pooled forms of (c) and (d) are the backward of (b)'s pooled form in
train mode: ``g`` is the gradient of the concat half y went to, ``gp`` that
of the pooled output. Each 2x2 window's four y are recomputed from x,
``mean``, ``mul`` and ``beta`` (the bits (b) wrote), its argmax tap taken
by (b)'s rule (the first maximum in row-major order, the last NaN:
``F.max_pool2d``'s index), and ``r(g + (tap is the argmax ? gp : 0))``
stands for ``g``: the add autograd makes of the concat's and the pool's
gradients, rounded as it rounds (``-0 + 0`` is ``+0``). No index tensor is
stored, no pool backward runs and no gradient is added apart.

``relu`` names the order: :data:`RELU_NONE` (0, the deconv block's),
:data:`RELU_BEFORE` (1, or ``True``: the U-Net's conv block, above) or
:data:`RELU_AFTER` (2: TransUNet's ``Conv2dReLU``, conv -> BatchNorm ->
ReLU, which takes no bias). In the order after ``a = x``, (a) takes the
statistics of x, (b) writes ``y = relu(r(((a - mean) * mul) + beta))``, and
(c) and (d) take ``g' = g * (y > 0)`` (zero where ``y <= 0``, autograd's
rule for ReLU, so NaN passes) in ``g``'s place, with ``y`` recomputed from
``x`` (so they also take ``mul`` and ``beta``). It is a compile-time form of
(b), (c) and (d), so the U-Net's forms compile as they did; it has no store
forms. ``AFTER`` counts its kernel launches and its applies (on either
device).

A layer in train mode without a process group is these four launches and
no other op: no per-channel op runs between them (the vectors, the running
statistics and the bias gradient come out of (b) and (d)), and the
reductions' plans are cached by shape and their scratch and counters
reused, so a launch costs one call into the library.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it runs the plain PyTorch version (``_*_plain``, the derivations
:func:`finalize` and the running update of ``conv_bn`` as they were), which
rounds like the kernel: (b) and (d) are bit-equal to it given the same
vectors, (a) and (c) sum in another order. ``LAUNCHES`` counts kernel
launches by kernel, ``FORMS`` the eval applies that took a store form,
``TRAIN_FORMS`` the train applies and pooled backwards that did.
:class:`TrainBatchNorm`, :class:`TrainCatBatchNorm` and
:class:`EvalBatchNorm` are the autograd Functions the model calls;
:func:`conv_bn` runs a block without forms, :func:`conv_bn_into` both
modes' forms at a U-Net level.

Train mode with a process ``group`` (sync-BN) all-reduces (a)'s ``[sum a,
sum a^2, n]`` forward, between (a) and (b), and ``[sum g, sum g*ahat]``
backward, between (c) and (d), which gives the gradient a differentiable
all-reduce of the sums would; the parameter
gradients stay this rank's own sums (``dgamma = sum g*ahat``, ``dbeta =
sum g``, ``dbias``), which DDP then averages. Where the variance clips,
no gradient flows through it (``clamp_min``'s rule).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from tpuseg_torch.kernels.build import current_stream, launch, load

# Kernel launches since the counts were last reset, by kernel (CPU calls
# don't count).
LAUNCHES: Dict[str, int] = {"stats": 0, "apply": 0, "backward_reduce": 0,
                            "backward_apply": 0}
# Eval applies since the counts were last reset that stored y into a
# channel slice (``out``) and that also pooled it (``pool``), on either
# device; a pooled apply is still one "apply" launch.
FORMS: Dict[str, int] = {"slice": 0, "pool": 0}
# Likewise the train applies, and the train backwards whose (c) and (d)
# took the pooled form (a layer each: still one launch of each kernel).
TRAIN_FORMS: Dict[str, int] = {"slice": 0, "pool": 0, "pooled_backward": 0}
# The order after since the counts were last reset: kernel launches (also
# counted in LAUNCHES) and (b)'s applies, train and eval, on either device.
AFTER: Dict[str, int] = {"launches": 0, "applies": 0}
# Incoming gradients a backward had to copy into rows of channels first
# (see :func:`_gradient_rows`).
GRAD_COPIES = 0

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# where the ReLU goes (``relu``): none, before the normalization, after it
RELU_NONE, RELU_BEFORE, RELU_AFTER = 0, 1, 2


def reset_counts() -> None:
    global GRAD_COPIES
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    for k in FORMS:
        FORMS[k] = 0
    for k in TRAIN_FORMS:
        TRAIN_FORMS[k] = 0
    for k in AFTER:
        AFTER[k] = 0
    GRAD_COPIES = 0


def row_stride(t: torch.Tensor) -> Optional[int]:
    """``ld`` if the NCHW view ``t`` lies in memory as ``[N*H*W, C]`` rows of
    stride ``ld >= C`` (element ``(n, c, h, w)`` at ``((n*H + h)*W + w)*ld +
    c``), else None. Size-1 dimensions' strides do not matter."""
    if t.ndim != 4:
        return None
    n, c, h, w = t.shape
    sn, sc, sh, sw = t.stride()
    ld = sw if w > 1 else sh if h > 1 else sn if n > 1 else c
    if (c > 1 and sc != 1) or ld < c:
        return None
    if (w > 1 and sw != ld) or (h > 1 and sh != w * ld) or (n > 1 and sn != h * w * ld):
        return None
    return ld


def _check_rows(name: str, t: torch.Tensor, like: Optional[torch.Tensor] = None) -> int:
    ld = row_stride(t)
    if ld is None:
        raise ValueError(f"{name} {tuple(t.shape)} with strides {t.stride()} is not rows of "
                         "channels (channels-last, or a channel slice of it): K4 does not "
                         "copy its inputs; convert them where they are made")
    if t.device.type == "cuda" and t.dtype not in DTYPE_CODES:
        raise TypeError(f"{name} must be float32 or bfloat16 for the kernel, got {t.dtype}")
    if like is not None and (t.shape != like.shape or t.dtype != like.dtype
                             or t.device != like.device):
        raise ValueError(f"{name} {t.dtype} {tuple(t.shape)} on {t.device} does not match x's "
                         f"{like.dtype} {tuple(like.shape)} on {like.device}")
    return ld


def _check_vectors(x: torch.Tensor, **vectors) -> None:
    """Per-channel vectors: contiguous ``[C]`` on x's device, float32 for the
    kernel (the plain version also takes the float64 of a float64 model)."""
    c = x.shape[1]
    for name, v in vectors.items():
        if v is None:
            continue
        if (x.device.type == "cuda" and v.dtype != torch.float32) \
                or not v.dtype.is_floating_point or tuple(v.shape) != (c,) \
                or v.device != x.device or not v.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 [{c}] on {x.device}, got "
                             f"{v.dtype} {tuple(v.shape)} on {v.device}")


def _channels_last(shape, dtype, device) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=device, memory_format=torch.channels_last)


# ---------------------------------------------------------------------------
# the plain versions (any device): the CPU path, and the kernels' yardstick
# ---------------------------------------------------------------------------

def _c(v: torch.Tensor) -> torch.Tensor:
    return v[:, None, None]


def activation(x: torch.Tensor, bias: Optional[torch.Tensor], relu: int) -> torch.Tensor:
    """``relu(r(x + r(bias)))`` in x's dtype: flax's ``y += bias`` in the
    conv's dtype, then ``nn.relu`` (only in the order before)."""
    a = x if bias is None else x + _c(bias.to(x.dtype))
    return torch.relu(a) if relu == RELU_BEFORE else a


def _relu_mask(a: torch.Tensor) -> torch.Tensor:
    """relu' as autograd takes it: 0 where the output is <= 0."""
    return a > 0


def _stats_plain(x, bias, relu) -> torch.Tensor:
    a = activation(x, bias, relu).float()
    return torch.stack([a.sum((0, 2, 3)), (a * a).sum((0, 2, 3))])


def _apply_plain(x, bias, relu, mean, mul, beta) -> torch.Tensor:
    a = activation(x, bias, relu).float()
    y = ((a - _c(mean)) * _c(mul) + _c(beta)).to(x.dtype)
    return torch.relu(y) if relu == RELU_AFTER else y


def _after_gradient(x, g, mean, mul, beta) -> torch.Tensor:
    """The order after's ``g'``: ``g`` where ``y = relu(r(((x - mean) * mul)
    + beta))`` is above 0, else 0 (autograd's ReLU rule: zero where ``y <=
    0``)."""
    y = _apply_plain(x, None, RELU_NONE, mean, mul, beta)
    return torch.where(y <= 0, torch.zeros((), dtype=g.dtype, device=g.device), g)


def _pooled_gradient(x, bias, relu, g, gp, mean, mul, beta) -> torch.Tensor:
    """The pooled forms' ``g``, channels-last: ``g + gp`` at each 2x2
    window's argmax tap of ``y`` (recomputed as (b) computes it), ``g + 0``
    at the other three, in g's dtype (autograd's add of the concat's and the
    pool's gradients). The argmax by the pooled form's rule: ``v`` where ``v
    > max`` or ``v`` is NaN, from ``-inf``, over the taps in row-major
    order."""
    y = _apply_plain(x, bias, relu, mean, mul, beta)
    taps = [(dy, dx) for dy in (0, 1) for dx in (0, 1)]
    mx = torch.full(gp.shape, float("-inf"), dtype=y.dtype, device=y.device)
    arg = torch.zeros(gp.shape, dtype=torch.long, device=y.device)
    for q, (dy, dx) in enumerate(taps):
        v = y[:, :, dy::2, dx::2]
        take = (v > mx) | torch.isnan(v)
        mx, arg = torch.where(take, v, mx), torch.where(take, q, arg)
    out = torch.empty_like(g, memory_format=torch.channels_last)
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    for q, (dy, dx) in enumerate(taps):
        out[:, :, dy::2, dx::2] = g[:, :, dy::2, dx::2] + torch.where(arg == q, gp, zero)
    return out


def _ahat(a, mean, rstd):
    return (a - _c(mean)) * _c(rstd)


def _backward_reduce_plain(x, bias, relu, g, mean, rstd, mul=None, beta=None,
                           gp=None) -> torch.Tensor:
    if relu == RELU_AFTER:
        g = _after_gradient(x, g, mean, mul, beta)
    if gp is not None:
        g = _pooled_gradient(x, bias, relu, g, gp, mean, mul, beta)
    a = activation(x, bias, relu).float()
    gf = g.float()
    ahat = _ahat(a, mean, rstd)
    sums = [gf.sum((0, 2, 3)), (gf * ahat).sum((0, 2, 3))]
    if bias is not None:
        m = _relu_mask(a) if relu == RELU_BEFORE else torch.ones_like(a, dtype=torch.bool)
        sums += [torch.where(m, gf, 0.0).sum((0, 2, 3)), m.float().sum((0, 2, 3)),
                 torch.where(m, ahat, 0.0).sum((0, 2, 3))]
    return torch.stack(sums)


def _backward_apply_plain(x, bias, relu, g, mean, rstd, mul, k1, k2, beta=None) -> torch.Tensor:
    if relu == RELU_AFTER:
        g = _after_gradient(x, g, mean, mul, beta)
    a = activation(x, bias, relu).float()
    t = (g.float() - _c(k1)) - _ahat(a, mean, rstd) * _c(k2)
    dx = t * _c(mul)
    if relu == RELU_BEFORE:
        dx = torch.where(_relu_mask(a), dx, 0.0)
    return dx.to(x.dtype)


def finalize(stats: torch.Tensor, eps: float, gamma: torch.Tensor):
    """From ``[sum a, sum a^2, n]``: mean, the clipped fast variance, whether
    it was not clipped (the gradient flows through it there), rsqrt(var +
    eps) and mul."""
    mean = stats[0] / stats[2]
    raw = stats[1] / stats[2] - mean * mean
    var = torch.clamp_min(raw, 0.0)
    rstd = torch.rsqrt(var + eps)
    return mean, var, raw >= 0, rstd, rstd * gamma


def _stats_count_plain(x, bias, relu) -> torch.Tensor:
    """(a)'s sums and the count n of rows, ``[3, C]``."""
    stats = _stats_plain(x, bias, relu)
    n = x.shape[0] * x.shape[2] * x.shape[3]
    return torch.cat([stats, stats.new_full((1, stats.shape[1]), float(n))])


def _store_plain(y, out, pool):
    """(b)'s store forms as the eager ops they replace: ``y`` copied into
    ``out`` and ``F.max_pool2d(y, 2)``; ``y``, or ``(y, pooled)``."""
    pooled = F.max_pool2d(y, 2) if pool else None
    if out is not None:
        y = out.copy_(y)
    return y if pooled is None else (y, pooled)


def _apply_train_plain(x, bias, relu, stats, gamma, beta, eps, running_mean, running_var,
                       momentum, out=None, pool=False):
    """(b) in train mode: :func:`finalize` of the sums, the running
    statistics' update (flax's ``momentum * running + (1 - momentum) *
    batch``), and ``(y, [mean, var, rstd, mul, unclipped])``, y with the
    store forms as :func:`_store_plain`."""
    mean, var, unclipped, rstd, mul = finalize(stats, eps, gamma)
    if running_mean is not None:
        running_mean.copy_(momentum * running_mean + (1 - momentum) * mean)
        running_var.copy_(momentum * running_var + (1 - momentum) * var)
    vec = torch.stack([mean, var, rstd, mul, unclipped.to(mean.dtype)])
    return _store_plain(_apply_plain(x, bias, relu, mean, mul, beta), out, pool), vec


def _apply_eval_plain(x, bias, relu, running_mean, running_var, gamma, beta, eps, out=None,
                      pool=False):
    """(b) in eval mode: rsqrt and mul from the running variance; its store
    forms as :func:`_store_plain`."""
    rstd = torch.rsqrt(running_var + eps)
    return _store_plain(_apply_plain(x, bias, relu, running_mean, rstd * gamma, beta), out, pool)


def _backward_apply_train_plain(x, bias, relu, g, stats, vec, sums, totals, beta=None, gp=None):
    """(d) in train mode: ``k1 = sum g / n`` and ``k2 = sum g*ahat / n`` (0
    where the variance clipped) from ``totals``, then ``(dx, dbias)``, the
    bias gradient from this rank's ``sums`` (None without a bias); with
    ``gp`` the pooled form."""
    n = stats[2]
    k1 = totals[0] / n
    k2 = torch.where(vec[4] != 0, totals[1] / n, 0.0)
    if gp is not None:
        g = _pooled_gradient(x, bias, relu, g, gp, vec[0], vec[3], beta)
    dx = _backward_apply_plain(x, bias, relu, g, vec[0], vec[2], vec[3], k1, k2, beta)
    dbias = None if bias is None else vec[3] * ((sums[2] - k1 * sums[3]) - k2 * sums[4])
    return dx, dbias


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

_COUNTERS: Dict[tuple, torch.Tensor] = {}
_SCRATCH: Dict[tuple, torch.Tensor] = {}
_PLANS: Dict[tuple, Dict[str, int]] = {}
_FAILED = {kind: f"batchnorm {kind} kernel launch failed" for kind in LAUNCHES}


def _counters(device: torch.device, stream: int) -> torch.Tensor:
    """The reduction kernels' last-block counters for ``stream`` on
    ``device``: zeroed once, and left at zero by every launch, so two
    reductions share them only in stream order. A kernel that faults
    midway leaves them non-zero, but its error is sticky: the process's
    CUDA context takes no further launches."""
    t = _COUNTERS.get((device, stream))
    if t is None:
        t = _COUNTERS[(device, stream)] = torch.zeros(64, dtype=torch.int32, device=device)
    return t


def _scratch(device: torch.device, stream: int, floats: int) -> torch.Tensor:
    """The reductions' per-block partials for ``stream`` on ``device``, grown
    to the largest plan seen: a reduction writes and reads them within its
    launch, so launches in stream order share them."""
    t = _SCRATCH.get((device, stream))
    if t is None or t.numel() < floats:
        t = _SCRATCH[(device, stream)] = torch.empty(max(floats, 1 << 16), dtype=torch.float32,
                                                     device=device)
    return t


def _ptr(v: Optional[torch.Tensor]) -> Optional[int]:
    return None if v is None else v.data_ptr()


def _rows(x: torch.Tensor):
    return x.shape[0] * x.shape[2] * x.shape[3], x.shape[1]


def _pooled_args(x, gp):
    """The C interface's ``gp, ldgp, width``: the pooled gradient, its row
    stride and x's width (0 without the pooled form)."""
    if gp is None:
        return None, 0, 0
    return gp.data_ptr(), row_stride(gp), x.shape[3]


PLAN_KEYS = ("scratch", "blocks", "rows_per_block", "depth", "path")


def reduce_plan(x: torch.Tensor, ldx: int, g: Optional[torch.Tensor] = None, ldg: int = 0,
                nsums: int = 2, gp: Optional[torch.Tensor] = None) -> Dict[str, int]:
    """The library's plan of the reduction (a) (``g`` None) or (c) (with
    ``gp`` its pooled form) on these CUDA tensors: ``scratch`` floats,
    ``blocks``, ``rows_per_block``, ``depth``, the most f32 additions between
    a term and its sum, so that each sum is within ``gamma_depth * sum |t|``
    of the exact one, and ``path`` (0 one element a thread, 1 a 16-byte
    vector of one row, P > 1 the packed narrow path, a 16-byte load of P
    whole rows). Asked of the library once for each shape, row strides and
    alignment, then cached."""
    m, c = _rows(x)
    pooled = _pooled_args(x, gp)
    key = (x.dtype, m, c, ldx, g is None, ldg, nsums, x.data_ptr() % 16,
           0 if g is None else g.data_ptr() % 16, *pooled[1:], (pooled[0] or 0) % 16)
    plan = _PLANS.get(key)
    if plan is None:
        out = (ctypes.c_longlong * len(PLAN_KEYS))()
        if load("batchnorm").tpuseg_bn_reduce_plan(x.data_ptr(), ldx, _ptr(g), ldg, *pooled,
                                                   DTYPE_CODES[x.dtype], m, c, nsums, out):
            raise ValueError(f"K4 refuses [{m}, {c}] (at most 64 channel tiles)")
        plan = _PLANS[key] = dict(zip(PLAN_KEYS, out))
    return plan


def _reduce_out(x, ldx, g, ldg, nsums: int, rows: int, gp=None):
    """The reduction's output ``[rows, C]`` and its partials."""
    plan = reduce_plan(x, ldx, g, ldg, nsums, gp)
    stream = current_stream(x.device)
    out = torch.empty((rows, x.shape[1]), dtype=torch.float32, device=x.device)
    return out, _scratch(x.device, stream, plan["scratch"]), stream


def _launch_stats(x, bias, relu, *, ldx) -> torch.Tensor:
    out, scratch, stream = _reduce_out(x, ldx, None, 0, 2, 3)
    launch("batchnorm", "tpuseg_bn_stats", x.device, stream, x.data_ptr(), ldx,
           DTYPE_CODES[x.dtype], _ptr(bias), int(relu), *_rows(x), out.data_ptr(),
           scratch.data_ptr(), _counters(x.device, stream).data_ptr(), what=_FAILED["stats"])
    LAUNCHES["stats"] += 1
    return out


def _apply(x, bias, relu, train, stats, gamma, eps, vec, running_mean, running_var, momentum,
           beta, *, ldx, out=None, pool=False):
    """(b) into ``out`` (rows of channels, checked) or a new channels-last
    ``y``; with ``pool`` ``(y, pooled)``."""
    n, c, h, w = x.shape
    y = _channels_last(x.shape, x.dtype, x.device) if out is None else out
    pooled = _channels_last((n, c, h // 2, w // 2), x.dtype, x.device) if pool else None
    launch("batchnorm", "tpuseg_bn_apply", x.device, current_stream(x.device), x.data_ptr(),
           ldx, DTYPE_CODES[x.dtype], _ptr(bias), int(relu), int(train), _ptr(stats),
           gamma.data_ptr(), eps, _ptr(vec), _ptr(running_mean), _ptr(running_var), momentum,
           1 - momentum, beta.data_ptr(), *_rows(x), y.data_ptr(), row_stride(y), _ptr(pooled), w,
           what=_FAILED["apply"])
    LAUNCHES["apply"] += 1
    return y if pooled is None else (y, pooled)


def _launch_apply_train(x, bias, relu, stats, gamma, beta, eps, running_mean, running_var,
                        momentum, *, ldx, out=None, pool=False):
    vec = torch.empty((5, x.shape[1]), dtype=torch.float32, device=x.device)
    y = _apply(x, bias, relu, True, stats, gamma, eps, vec, running_mean, running_var, momentum,
               beta, ldx=ldx, out=out, pool=pool)
    return y, vec


def _launch_apply_eval(x, bias, relu, running_mean, running_var, gamma, beta, eps, *, ldx,
                       out=None, pool=False):
    return _apply(x, bias, relu, False, None, gamma, eps, None, running_mean, running_var, 0.0,
                  beta, ldx=ldx, out=out, pool=pool)


def _launch_backward_reduce(x, bias, relu, g, mean, rstd, mul=None, beta=None, *, ldx, ldg,
                            gp=None) -> torch.Tensor:
    nsums = 2 if bias is None else 5
    out, scratch, stream = _reduce_out(x, ldx, g, ldg, nsums, nsums, gp)
    launch("batchnorm", "tpuseg_bn_backward_reduce", x.device, stream, x.data_ptr(), ldx,
           g.data_ptr(), ldg, *_pooled_args(x, gp), DTYPE_CODES[x.dtype], _ptr(bias), int(relu),
           mean.data_ptr(), rstd.data_ptr(), _ptr(mul), _ptr(beta), *_rows(x), nsums,
           out.data_ptr(), scratch.data_ptr(), _counters(x.device, stream).data_ptr(),
           what=_FAILED["backward_reduce"])
    LAUNCHES["backward_reduce"] += 1
    return out


def _backward(x, bias, relu, g, mean, rstd, mul, beta, train, k1, k2, stats, totals, unclipped,
              sums, dbias, *, ldx, ldg, gp=None) -> torch.Tensor:
    dx = _channels_last(x.shape, x.dtype, x.device)
    launch("batchnorm", "tpuseg_bn_backward_apply", x.device, current_stream(x.device),
           x.data_ptr(), ldx, g.data_ptr(), ldg, *_pooled_args(x, gp), DTYPE_CODES[x.dtype],
           _ptr(bias), int(relu), mean.data_ptr(), rstd.data_ptr(), mul.data_ptr(), _ptr(beta),
           int(train), _ptr(k1), _ptr(k2), _ptr(stats), _ptr(totals), _ptr(unclipped),
           _ptr(sums), _ptr(dbias), *_rows(x), dx.data_ptr(), x.shape[1],
           what=_FAILED["backward_apply"])
    LAUNCHES["backward_apply"] += 1
    return dx


def _launch_backward_apply(x, bias, relu, g, mean, rstd, mul, k1, k2, beta=None, *, ldx,
                           ldg) -> torch.Tensor:
    return _backward(x, bias, relu, g, mean, rstd, mul, beta, False, k1, k2, None, None, None,
                     None, None, ldx=ldx, ldg=ldg)


def _launch_backward_apply_train(x, bias, relu, g, stats, vec, sums, totals, beta=None, *, ldx,
                                 ldg, gp=None):
    dbias = None if bias is None else torch.empty_like(bias)
    dx = _backward(x, bias, relu, g, vec[0], vec[2], vec[3], beta, True, None, None, stats,
                   totals, vec[4], sums, dbias, ldx=ldx, ldg=ldg, gp=gp)
    return dx, dbias


# ---------------------------------------------------------------------------
# the wrappers: the kernel on a CUDA tensor, the plain version on a CPU one
# ---------------------------------------------------------------------------

def _device(x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"K4 runs on cuda or cpu tensors, not {x.device}")
    return x.device.type


def _check_order(relu: int, bias: Optional[torch.Tensor], **after) -> None:
    """``relu`` is one of the three orders; the order after takes no bias
    and needs the vectors ``after`` (those that recompute y)."""
    if relu not in (RELU_NONE, RELU_BEFORE, RELU_AFTER):
        raise ValueError(f"relu must be RELU_NONE, RELU_BEFORE or RELU_AFTER, got {relu!r}")
    if relu == RELU_AFTER:
        if bias is not None:
            raise ValueError("the order after takes no bias (a conv before a BatchNorm has "
                             "none)")
        missing = [k for k, v in after.items() if v is None]
        if missing:
            raise ValueError(f"the order after's backward needs {missing} to recompute y")


def _launched_after(relu: int) -> None:
    if relu == RELU_AFTER:
        AFTER["launches"] += 1


def _check_sums(x: torch.Tensor, **matrices) -> None:
    """Per-channel rows: a contiguous ``[rows, C]`` on x's device with at
    least the rows given (float32 for the kernel)."""
    c = x.shape[1]
    for name, (v, rows) in matrices.items():
        if (x.device.type == "cuda" and v.dtype != torch.float32) \
                or not v.dtype.is_floating_point or v.ndim != 2 or v.shape[0] < rows \
                or v.shape[1] != c or v.device != x.device or not v.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 [{rows}, {c}] on {x.device},"
                             f" got {v.dtype} {tuple(v.shape)} on {v.device}")


def _check_forms(x: torch.Tensor, relu: int, out: Optional[torch.Tensor], pool: bool) -> None:
    """(b)'s store forms: ``out`` rows of channels of x's shape, dtype and
    device; ``pool`` an even H and W; none in the order after."""
    if relu == RELU_AFTER and (out is not None or pool):
        raise ValueError("the order after has no store forms")
    if out is not None:
        _check_rows("out", out, x)
    if pool and (x.shape[2] % 2 or x.shape[3] % 2):
        raise ValueError(f"the pooled form takes an even H and W, got {tuple(x.shape[2:])}")


def _check_pooled(x: torch.Tensor, bias: Optional[torch.Tensor], relu: int,
                  gp: Optional[torch.Tensor], **recompute) -> None:
    """The pooled backward's ``gp``: rows of channels of the pooled output's
    shape ``[N, C, H/2, W/2]``, x's dtype and device; it recomputes y from
    the vectors ``recompute``; it is a conv block's (a bias; the order after
    has no pooled form)."""
    if gp is None:
        return
    n, c, h, w = x.shape
    _check_forms(x, relu, None, True)
    if bias is None:
        raise ValueError("the pooled backward is a conv block's: it takes a bias")
    _check_rows("gp", gp)
    if tuple(gp.shape) != (n, c, h // 2, w // 2) or gp.dtype != x.dtype \
            or gp.device != x.device:
        raise ValueError(f"gp {gp.dtype} {tuple(gp.shape)} on {gp.device} is not the pooled "
                         f"output's gradient, {x.dtype} {(n, c, h // 2, w // 2)} on {x.device}")
    missing = [k for k, v in recompute.items() if v is None]
    if missing:
        raise ValueError(f"the pooled backward needs {missing} to recompute y")


def batch_stats(x: torch.Tensor, bias: Optional[torch.Tensor], relu: int) -> torch.Tensor:
    """(a): f32 ``[3, C]``, per channel ``[sum a, sum a^2, n]`` over the ``n =
    N*H*W`` rows."""
    ldx = _check_rows("x", x)
    _check_order(relu, bias)
    _check_vectors(x, bias=bias)
    if _device(x) == "cpu":
        return _stats_count_plain(x, bias, relu)
    _launched_after(relu)
    return _launch_stats(x, bias, relu, ldx=ldx)


def bn_apply_train(x: torch.Tensor, bias: Optional[torch.Tensor], relu: int,
                   stats: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float,
                   running_mean: Optional[torch.Tensor] = None,
                   running_var: Optional[torch.Tensor] = None, momentum: float = 0.0,
                   out: Optional[torch.Tensor] = None, pool: bool = False):
    """(b) in train mode on (a)'s ``stats`` ``[3, C]`` (or their all-reduce):
    ``(y, vec)``, ``y`` channels-last in x's dtype, ``vec`` ``[5, C]`` =
    ``[mean, var, rstd, mul,
    unclipped (1. or 0.)]`` as :func:`finalize` gives them; with the running
    statistics, also sets each to ``momentum * it + (1 - momentum) *
    batch``, in place. ``out`` and ``pool`` are :func:`bn_apply_eval`'s
    store forms (``y`` is then what it returns), counted in
    ``TRAIN_FORMS``."""
    ldx = _check_rows("x", x)
    _check_order(relu, bias)
    _check_vectors(x, bias=bias, gamma=gamma, beta=beta, running_mean=running_mean,
                   running_var=running_var)
    _check_sums(x, stats=(stats, 3))
    _check_forms(x, relu, out, pool)
    if (running_mean is None) != (running_var is None):
        raise ValueError("running_mean and running_var go together")
    if relu == RELU_AFTER:
        AFTER["applies"] += 1
    TRAIN_FORMS["slice"] += out is not None
    TRAIN_FORMS["pool"] += pool
    if _device(x) == "cpu":
        return _apply_train_plain(x, bias, relu, stats, gamma, beta, eps, running_mean,
                                  running_var, momentum, out=out, pool=pool)
    _launched_after(relu)
    return _launch_apply_train(x, bias, relu, stats, gamma, beta, eps, running_mean,
                               running_var, momentum, ldx=ldx, out=out, pool=pool)


def bn_apply_eval(x: torch.Tensor, bias: Optional[torch.Tensor], relu: int,
                  running_mean: torch.Tensor, running_var: torch.Tensor, gamma: torch.Tensor,
                  beta: torch.Tensor, eps: float, out: Optional[torch.Tensor] = None,
                  pool: bool = False):
    """(b) in eval mode: ``y`` with ``mean`` the running mean and ``mul =
    rsqrt(running_var + eps) * gamma`` derived in the kernel. Store forms:
    with ``out`` (x's shape, dtype and device, rows of channels: a channel
    slice of a concat buffer) ``y`` is stored there and ``out`` returned;
    with ``pool`` (even H and W) the same pass also gives the 2x2/2 max of
    ``y``, channels-last, and ``(y, pooled)`` is returned."""
    ldx = _check_rows("x", x)
    _check_order(relu, bias)
    _check_vectors(x, bias=bias, running_mean=running_mean, running_var=running_var,
                   gamma=gamma, beta=beta)
    _check_forms(x, relu, out, pool)
    if relu == RELU_AFTER:
        AFTER["applies"] += 1
    if _device(x) == "cpu":
        y = _apply_eval_plain(x, bias, relu, running_mean, running_var, gamma, beta, eps, out,
                              pool)
    else:
        _launched_after(relu)
        y = _launch_apply_eval(x, bias, relu, running_mean, running_var, gamma, beta, eps,
                               ldx=ldx, out=out, pool=pool)
    if out is not None:
        FORMS["slice"] += 1
    if pool:
        FORMS["pool"] += 1
    return y


def backward_reduce(x: torch.Tensor, bias: Optional[torch.Tensor], relu: int, g: torch.Tensor,
                    mean: torch.Tensor, rstd: torch.Tensor, mul: Optional[torch.Tensor] = None,
                    beta: Optional[torch.Tensor] = None,
                    gp: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(c): f32 ``[2, C]`` (``[sum g, sum g*ahat]``), or ``[5, C]`` with a
    bias (also ``sum relu'*g, sum relu', sum relu'*ahat``; relu' is 1
    without a ReLU before). The order after takes ``g'`` for ``g``, from
    ``mul`` and ``beta``; with ``gp`` (the gradient of (b)'s pooled output)
    the pooled form (module docstring), also from ``mul`` and ``beta``."""
    ldx, ldg = _check_rows("x", x), _check_rows("g", g, x)
    _check_order(relu, bias, mul=mul, beta=beta)
    _check_vectors(x, bias=bias, mean=mean, rstd=rstd, mul=mul, beta=beta)
    _check_pooled(x, bias, relu, gp, mul=mul, beta=beta)
    if _device(x) == "cpu":
        return _backward_reduce_plain(x, bias, relu, g, mean, rstd, mul, beta, gp=gp)
    _launched_after(relu)
    return _launch_backward_reduce(x, bias, relu, g, mean, rstd, mul, beta, ldx=ldx, ldg=ldg,
                                   gp=gp)


def backward_apply(x: torch.Tensor, bias: Optional[torch.Tensor], relu: int, g: torch.Tensor,
                   mean: torch.Tensor, rstd: torch.Tensor, mul: torch.Tensor, k1: torch.Tensor,
                   k2: torch.Tensor, beta: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(d): ``dx = relu' * r(((g - k1) - ahat * k2) * mul)``, channels-last,
    x's dtype; the order after takes ``g'`` for ``g`` (from ``beta``) and no
    relu'."""
    ldx, ldg = _check_rows("x", x), _check_rows("g", g, x)
    _check_order(relu, bias, beta=beta)
    _check_vectors(x, bias=bias, mean=mean, rstd=rstd, mul=mul, k1=k1, k2=k2, beta=beta)
    if _device(x) == "cpu":
        return _backward_apply_plain(x, bias, relu, g, mean, rstd, mul, k1, k2, beta)
    _launched_after(relu)
    return _launch_backward_apply(x, bias, relu, g, mean, rstd, mul, k1, k2, beta, ldx=ldx,
                                  ldg=ldg)


def backward_apply_train(x: torch.Tensor, bias: Optional[torch.Tensor], relu: int,
                         g: torch.Tensor, stats: torch.Tensor, vec: torch.Tensor,
                         sums: torch.Tensor, totals: torch.Tensor,
                         beta: Optional[torch.Tensor] = None, gp: Optional[torch.Tensor] = None):
    """(d) in train mode: ``k1 = totals[0] / n`` and ``k2 = totals[1] / n``
    (0 where ``vec``'s variance clipped) derived in the kernel, with ``n =
    stats[2]``; ``(dx, dbias)``, the bias gradient ``mul * ((sums[2] - k1 *
    sums[3]) - k2 * sums[4])`` from this rank's (c) ``sums`` (None without a
    bias). ``totals`` is ``sums`` itself, or the all-reduce of its first two
    rows across a process group. The order after needs ``beta``; so does the
    pooled form, with ``gp`` (as :func:`backward_reduce`'s; counted in
    ``TRAIN_FORMS``)."""
    ldx, ldg = _check_rows("x", x), _check_rows("g", g, x)
    _check_order(relu, bias, beta=beta)
    _check_vectors(x, bias=bias, beta=beta)
    _check_sums(x, stats=(stats, 3), vec=(vec, 5), sums=(sums, 2 if bias is None else 5),
                totals=(totals, 2))
    _check_pooled(x, bias, relu, gp, beta=beta)
    TRAIN_FORMS["pooled_backward"] += gp is not None
    if _device(x) == "cpu":
        return _backward_apply_train_plain(x, bias, relu, g, stats, vec, sums, totals, beta,
                                           gp=gp)
    _launched_after(relu)
    return _launch_backward_apply_train(x, bias, relu, g, stats, vec, sums, totals, beta,
                                        ldx=ldx, ldg=ldg, gp=gp)


# ---------------------------------------------------------------------------
# the autograd Functions
# ---------------------------------------------------------------------------

def _gradient_rows(g: torch.Tensor) -> torch.Tensor:
    """The incoming gradient as rows of channels. The concat's backward hands
    a channel slice (rows of stride ``ld > C``, taken as they are); an
    expanded or NCHW gradient (a loss summed straight off the logits, say)
    is copied to channels-last here, and counted in ``GRAD_COPIES``."""
    global GRAD_COPIES
    if row_stride(g) is not None:
        return g
    GRAD_COPIES += 1
    return g.contiguous(memory_format=torch.channels_last)


def _train_stats(x, bias, relu: int, group) -> torch.Tensor:
    """(a)'s sums, all-reduced across ``group`` (sync-BN) where one is given."""
    stats = batch_stats(x, bias, relu)
    if group is not None:
        # torch.distributed.nn.functional's all-reduce (the call the parallel
        # tests count); inside a Function's forward it records no graph: the
        # backward all-reduces the gradient's sums (_train_backward)
        from torch.distributed.nn.functional import all_reduce

        stats = all_reduce(stats, group=group)
    return stats


def _train_backward(ctx, g: torch.Tensor, gp: Optional[torch.Tensor] = None):
    """A train Function's (c) and (d) on the saved ``(x, bias, stats, vec,
    beta)``, ``[sum g, sum g*ahat]`` all-reduced across ``ctx.group`` between
    them; with ``gp`` their pooled forms. ``(dx, dbias, sums)``, each
    gradient None where its input asks for none."""
    x, bias, stats, vec, beta = ctx.saved_tensors
    g = _gradient_rows(g)
    # the order after and the pooled forms recompute y from mul and beta
    mul = vec[3] if beta is not None else None
    sums = backward_reduce(x, bias, ctx.relu, g, vec[0], vec[2], mul, beta, gp=gp)
    totals = sums
    if ctx.group is not None:
        import torch.distributed as dist

        totals = sums[:2].clone()
        dist.all_reduce(totals, group=ctx.group)
    dx, dbias = backward_apply_train(x, bias, ctx.relu, g, stats, vec, sums, totals, beta, gp=gp)
    need = ctx.needs_input_grad
    return dx if need[0] else None, dbias if need[1] else None, sums


class TrainBatchNorm(torch.autograd.Function):
    """Train mode: ``(y, mean, var)`` of the batch (of the global batch with
    a ``group``); mean and var take no gradient. ``running`` is empty, or
    ``(running_mean, running_var, momentum)``, which (b) updates in place."""

    @staticmethod
    def forward(ctx, x, bias, gamma, beta, relu: int, eps: float, group, *running):
        stats = _train_stats(x, bias, relu, group)
        y, vec = bn_apply_train(x, bias, relu, stats, gamma, beta, eps, *running)
        ctx.relu, ctx.group, ctx.n_running = relu, group, len(running)
        ctx.save_for_backward(x, bias, stats, vec, beta if relu == RELU_AFTER else None)
        mean, var = vec[0], vec[1]
        ctx.mark_non_differentiable(mean, var)
        # no zero gradients filled in for mean and var (a launch each)
        ctx.set_materialize_grads(False)
        return y, mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        dx, dbias, sums = _train_backward(ctx, gy)
        return (dx, dbias, sums[1], sums[0], None, None, None) + (None,) * ctx.n_running


class TrainCatBatchNorm(torch.autograd.Function):
    """Train mode's store forms at a U-Net level (:func:`conv_bn_into`): y
    goes into the level's concat buffer ``cat`` ``[N, 2C, H, W]``,
    channels-last, which is modified in place and returned. With ``skip``
    (the encoder's second block) y goes into its first half and the 2x2/2
    max of y comes out of the same pass: ``(cat, pooled)``; else (the deconv
    block) into its second half: ``cat``. Statistics as
    :class:`TrainBatchNorm`'s. The backward reads its half of cat's gradient
    (rows of stride 2C) and, with ``skip``, the pooled output's gradient in
    (c)'s and (d)'s pooled forms; the deconv's passes cat's gradient on
    whole, of which the skip's reads only its own half (the second half's
    values before the deconv wrote them fed nothing)."""

    @staticmethod
    def forward(ctx, x, bias, cat, gamma, beta, relu: int, eps: float, group, skip: bool,
                *running):
        stats = _train_stats(x, bias, relu, group)
        c = x.shape[1]
        half = cat[:, :c] if skip else cat[:, c:]
        y, vec = bn_apply_train(x, bias, relu, stats, gamma, beta, eps, *running, out=half,
                                pool=skip)
        ctx.mark_dirty(cat)
        ctx.relu, ctx.group, ctx.skip, ctx.n_running = relu, group, skip, len(running)
        ctx.save_for_backward(x, bias, stats, vec, beta if skip else None)
        return (cat, y[1]) if skip else cat

    @staticmethod
    def backward(ctx, gcat, gp=None):
        c = ctx.saved_tensors[0].shape[1]
        g = gcat[:, :c] if ctx.skip else gcat[:, c:]
        dx, dbias, sums = _train_backward(ctx, g, _gradient_rows(gp) if ctx.skip else None)
        return (dx, dbias, None if ctx.skip else gcat, sums[1], sums[0], None, None, None,
                None) + (None,) * ctx.n_running


class EvalBatchNorm(torch.autograd.Function):
    """Eval mode, on the running statistics: ``y``, with ``mul`` derived in
    (b); its input gradient is (d) with zero sums, and parameter gradients,
    where asked for, come from (c) without the mean terms."""

    @staticmethod
    def forward(ctx, x, bias, gamma, beta, running_mean, running_var, relu: int, eps: float):
        y = bn_apply_eval(x, bias, relu, running_mean, running_var, gamma, beta, eps)
        ctx.relu, ctx.eps = relu, eps
        ctx.save_for_backward(x, bias, gamma, running_mean, running_var,
                              beta if relu == RELU_AFTER else None)
        return y

    @staticmethod
    def backward(ctx, gy):
        x, bias, gamma, mean, var, beta = ctx.saved_tensors
        rstd = torch.rsqrt(var + ctx.eps)
        mul = rstd * gamma
        g = _gradient_rows(gy)
        need = ctx.needs_input_grad
        dx = dbias = dgamma = dbeta = None
        if need[0]:
            zero = torch.zeros_like(mean)
            dx = backward_apply(x, bias, ctx.relu, g, mean, rstd, mul, zero, zero, beta)
        if need[1] or need[2] or need[3]:
            sums = backward_reduce(x, bias, ctx.relu, g, mean, rstd,
                                   mul if beta is not None else None, beta)
            dbeta, dgamma = sums[0], sums[1]
            if bias is not None:
                dbias = mul * sums[2]
        return dx, dbias, dgamma, dbeta, None, None, None, None


def conv_bn(x: torch.Tensor, bias: Optional[torch.Tensor], relu: int,
            bn: torch.nn.BatchNorm2d, momentum: float, group=None):
    """A block's ``bias -> ReLU -> BatchNorm`` on the conv output ``x``
    (without its bias), or with ``relu`` :data:`RELU_AFTER` its
    ``BatchNorm -> ReLU``: train mode normalizes with the batch statistics and
    updates ``bn``'s running ones (flax's ``running = momentum * running +
    (1 - momentum) * batch``, the biased variance) inside (b), eval mode
    with the running statistics."""
    if not bn.training:
        return EvalBatchNorm.apply(x, bias, bn.weight, bn.bias, bn.running_mean,
                                   bn.running_var, relu, bn.eps)
    y, _, _ = TrainBatchNorm.apply(x, bias, bn.weight, bn.bias, relu, bn.eps, group,
                                   bn.running_mean, bn.running_var, momentum)
    return y


def conv_bn_into(x: torch.Tensor, bias: Optional[torch.Tensor], relu: int,
                 bn: torch.nn.BatchNorm2d, momentum: float, group, cat: torch.Tensor,
                 skip: bool):
    """:func:`conv_bn` with K4's store forms at a U-Net level, in eval mode
    without grad and in train mode (with or without a ``group``): y goes
    into the level's concat buffer ``cat`` ``[N, 2C, H, W]`` (channels-last),
    into its first half with ``skip`` (the encoder's second block, whose 2x2/2
    max pool comes out of the same pass: ``(cat, pooled)``), else into its
    second half (the deconv block: ``cat``). Train mode runs
    :class:`TrainCatBatchNorm`, eval mode (b)'s eval forms, which record no
    graph and so are refused with grad enabled."""
    if bn.training:
        return TrainCatBatchNorm.apply(x, bias, cat, bn.weight, bn.bias, relu, bn.eps, group,
                                       skip, bn.running_mean, bn.running_var, momentum)
    if torch.is_grad_enabled():
        raise ValueError("K4's eval store forms are eval applies without grad")
    c = x.shape[1]
    args = (x, bias, relu, bn.running_mean, bn.running_var, bn.weight, bn.bias, bn.eps)
    if skip:
        _, pooled = bn_apply_eval(*args, out=cat[:, :c], pool=True)
        return cat, pooled
    bn_apply_eval(*args, out=cat[:, c:])
    return cat
