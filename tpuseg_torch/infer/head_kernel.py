"""The int8 serving walks' 1x1 head fused with its argmax: K2 (blocked,
with per-phase argmax and depth-to-space) and K6 (dense).

K2 is the port of the TPU kernel ``tpuseg/infer/head_kernel.py::_head_kernel``
(Pallas, through ``_head_pallas``). In the ``int8_blocked`` serving walk
the head is a 1x1 conv from the phase-major dec1b edge ``(B, h, w, 4C)`` to
``4*ncls`` blocked logits; this function runs that conv, its dequant (fp
head) or wscale multiply (int8 head), the folded ReLU+BN epilogue (the
reference's 1x1 head is a full conv block, model.py:136), a first-max
argmax per phase, and writes the int32 labels straight into the dense
``(B, 2h, 2w)`` mask — no logits tensor exists in device memory.

On a CUDA tensor it launches the hand-written kernel in
``tpuseg_torch/csrc/head_argmax.cu`` (built at first use by
:mod:`tpuseg_torch.kernels.build`) or raises; on a CPU tensor it runs
:func:`_blocked_head_argmax_plain`, the same function in plain PyTorch.
Nothing falls back from one to the other. ``LAUNCHES`` counts kernel
launches.

The kernel has two routes, chosen here from dtypes by :func:`kernel_route`
and passed to the C entry: ``"mma"`` (tensor cores fed from registers) for
int8 activations with a bf16 (fp head) or int8 (int8 head) weight, the
serving path; ``"general"`` for an fp edge into the head (bf16/f32
activations) or an f32 weight. ``LAST_ROUTE`` names the route of the last
launch.

K6, :func:`dense_head_argmax`, is the dense walk's head (``--quantize
int8``, and ``int8_auto``'s small batches): the JAX package leaves it to
XLA, which fuses ``conv_block``'s head (``tpuseg/infer/quant.py:544-560``)
and ``predict``'s argmax (``:785-786``) into one program. Here it is the
same CUDA source with the dense layout (one label a pixel, no
depth-to-space), launched through its own C entry and counted in
``DENSE_LAUNCHES``; :func:`_dense_head_argmax_plain` is its plain version.
It takes ``C % 16 == 0`` (:func:`dense_head_eligible`); other heads keep
the eager conv head plus argmax.

Numerics: the int8 head accumulates int8 x int8 in int32 — exact — and
rounds its epilogue where the plain version does, so labels are
bit-equal. The fp head computes the same products (a product of two bf16
values is exact in f32) but sums them in another order, so genuine
argmax near-ties can land either way.
"""

from __future__ import annotations

import numpy as np
import torch

# Largest class count the kernel takes; larger heads use the conv head plus
# argmax (quant.py), the JAX package's rule (head_kernel.py:58).
_MAX_KERNEL_CLASSES = 8

# Kernel launches since the counter was last reset (CPU calls don't count):
# K2's, and K6's.
LAUNCHES = 0
DENSE_LAUNCHES = 0
# The route of the last launch of either kernel ("mma" or "general").
LAST_ROUTE = None

_DTYPE_CODES = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}
_ROUTE_CODES = {"general": 0, "mma": 1}


def head_kernel_eligible(ncls: int) -> bool:
    return ncls <= _MAX_KERNEL_CLASSES


def dense_head_eligible(ncls: int, c: int) -> bool:
    """Whether K6 takes a dense head of ``c`` input channels: K2's class
    rule, and 16-byte channel rows (``c % 16 == 0``; 64 at the reference
    width)."""
    return 1 <= ncls <= _MAX_KERNEL_CLASSES and c % 16 == 0


def kernel_route(x_dtype: torch.dtype, wt_dtype: torch.dtype, fp: bool) -> str:
    """``"mma"`` for int8 activations with a bf16 weight (fp head) or an int8
    weight (int8 head); ``"general"`` for bf16/f32 activations or an f32
    weight, whose f32 products the tensor cores cannot form exactly."""
    if x_dtype == torch.int8 and wt_dtype == (torch.bfloat16 if fp else torch.int8):
        return "mma"
    return "general"


def _head_logits(x2: torch.Tensor, sv: torch.Tensor, wt: torch.Tensor,
                 epi: torch.Tensor, fp: bool) -> torch.Tensor:
    """The 1x1 head and its epilogue on rows ``x2 [N, K]``: f32 ``[N, O]``."""
    if fp:
        xf = (x2.float() * sv).to(wt.dtype).float()
        y = xf @ wt.float().T
    else:
        # int8 x int8 sums are integers below 2^53: exact in float64
        y = (x2.double() @ wt.double().T).float() * epi[3]
    return torch.clamp_min(y + epi[0], 0.0) * epi[1] + epi[2]


def _blocked_head_argmax_plain(x: torch.Tensor, sv: torch.Tensor,
                               wt: torch.Tensor, epi: torch.Tensor,
                               ncls: int, fp: bool) -> torch.Tensor:
    """K2's function in plain PyTorch (any device): the CPU path, and the
    kernel's yardstick on the card."""
    b, h, w, c4 = x.shape
    y = _head_logits(x.reshape(-1, c4), sv, wt, epi, fp)
    lbl = torch.argmax(y.reshape(b, h, w, 2, 2, ncls), dim=-1)  # first max
    return lbl.permute(0, 1, 3, 2, 4).reshape(b, 2 * h, 2 * w).to(torch.int32)


def _dense_head_argmax_plain(x: torch.Tensor, sv: torch.Tensor,
                             wt: torch.Tensor, epi: torch.Tensor,
                             ncls: int, fp: bool) -> torch.Tensor:
    """K6's function in plain PyTorch (any device): the CPU path, and the
    kernel's yardstick on the card."""
    b, h, w, c = x.shape
    y = _head_logits(x.reshape(-1, c), sv, wt, epi, fp)
    return torch.argmax(y, dim=-1).reshape(b, h, w).to(torch.int32)  # first max


def _check(x, sv, wt, epi, ncls: int, fp: bool) -> None:
    b, h, w, c4 = x.shape
    if not 1 <= ncls <= _MAX_KERNEL_CLASSES:
        raise ValueError(f"head kernel takes 1..{_MAX_KERNEL_CLASSES} classes, got {ncls}")
    if fp:
        if x.dtype not in _DTYPE_CODES or wt.dtype not in (torch.bfloat16, torch.float32):
            raise TypeError(f"fp head takes x int8/bf16/f32 and wt bf16/f32, "
                            f"got {x.dtype} and {wt.dtype}")
    elif x.dtype != torch.int8 or wt.dtype != torch.int8:
        raise TypeError(f"int8 head takes int8 x and wt, got {x.dtype} and {wt.dtype}")
    if c4 % 16:
        raise ValueError(f"head kernel needs 4C % 16 == 0, got {c4}")
    if tuple(wt.shape) != (4 * ncls, c4) or tuple(sv.shape) != (c4,) \
            or tuple(epi.shape) != (4, 4 * ncls):
        raise ValueError(f"shapes: x {tuple(x.shape)}, sv {tuple(sv.shape)}, "
                         f"wt {tuple(wt.shape)}, epi {tuple(epi.shape)} for ncls={ncls}")
    if sv.dtype != torch.float32 or epi.dtype != torch.float32:
        raise TypeError("sv and epi must be float32")
    for name, t in (("x", x), ("sv", sv), ("wt", wt), ("epi", epi)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.data_ptr() % 16 or wt.data_ptr() % 16:
        raise ValueError("x and wt must be 16-byte aligned for vector loads")
    if b * h * w >= 2 ** 31:
        raise ValueError(f"{b * h * w} pixels exceed the kernel's int32 index range")


def _launch(x, sv, wt, epi, ncls: int, fp: bool) -> torch.Tensor:
    global LAUNCHES, LAST_ROUTE
    from tpuseg_torch.kernels.build import current_stream, launch

    _check(x, sv, wt, epi, ncls, fp)
    route = kernel_route(x.dtype, wt.dtype, fp)
    b, h, w, c4 = x.shape
    out = torch.empty((b, 2 * h, 2 * w), dtype=torch.int32, device=x.device)
    launch("head_argmax", "tpuseg_head_argmax", x.device, current_stream(x.device),
           x.data_ptr(), _DTYPE_CODES[x.dtype], sv.data_ptr(), wt.data_ptr(),
           _DTYPE_CODES[wt.dtype], epi.data_ptr(), out.data_ptr(), b, h, w, c4, ncls, int(fp),
           _ROUTE_CODES[route], what=f"head_argmax kernel launch failed ({route} route)")
    LAUNCHES += 1
    LAST_ROUTE = route
    return out


def blocked_head_argmax(x: torch.Tensor, sv, wt: torch.Tensor, epi, ncls: int,
                        fp: bool) -> torch.Tensor:
    """Blocked head + argmax + depth-to-space: ``(B, h, w, 4C)``
    phase-major activations -> dense ``(B, 2h, 2w)`` int32 labels.

    ``x`` int8 (or bf16/f32 when the edge into the head is fp), ``sv``
    f32 ``[4C]`` input dequant scales (fp head; None means ones), ``wt``
    ``[4*ncls, 4C]`` transposed head weights (bf16/f32 for the fp head,
    int8 otherwise), ``epi`` f32 ``[4, 4*ncls]`` = (bias, bn_scale,
    bn_shift, wscale) rows. ``sv`` and ``epi`` may be numpy arrays; pass
    tensors on ``x``'s device to keep host copies off the hot path.
    """
    dev = x.device
    if sv is None:  # fp edge into the head (e.g. --fp_blocks dec1b,head)
        sv = torch.ones(x.shape[-1], dtype=torch.float32, device=dev)
    sv = torch.as_tensor(np.asarray(sv, np.float32) if isinstance(sv, np.ndarray) else sv,
                         device=dev)
    epi = torch.as_tensor(np.asarray(epi, np.float32) if isinstance(epi, np.ndarray) else epi,
                          device=dev)
    if dev.type == "cpu":
        return _blocked_head_argmax_plain(x, sv, wt, epi, ncls, fp)
    if dev.type != "cuda":
        raise ValueError(f"blocked_head_argmax runs on cuda or cpu tensors, not {dev}")
    return _launch(x, sv, wt, epi, ncls, fp)


def _check_dense(x, sv, wt, epi, ncls: int, fp: bool) -> None:
    """K6's contract, on either device."""
    if x.dim() != 4 or x.dtype != torch.int8:
        raise TypeError(f"dense head takes int8 x [B, H, W, C], got {x.dtype} "
                        f"{tuple(x.shape)}")
    c = x.shape[-1]
    if not 1 <= ncls <= _MAX_KERNEL_CLASSES:
        raise ValueError(f"head kernel takes 1..{_MAX_KERNEL_CLASSES} classes, got {ncls}")
    if c % 16:
        raise ValueError(f"dense head kernel needs C % 16 == 0, got {c}")
    want = (torch.bfloat16, torch.float32) if fp else (torch.int8,)
    if wt.dtype not in want:
        raise TypeError(f"{'fp' if fp else 'int8'} dense head takes wt {want}, got {wt.dtype}")
    if tuple(wt.shape) != (ncls, c) or tuple(sv.shape) != (c,) \
            or tuple(epi.shape) != (4, ncls):
        raise ValueError(f"shapes: x {tuple(x.shape)}, sv {tuple(sv.shape)}, "
                         f"wt {tuple(wt.shape)}, epi {tuple(epi.shape)} for ncls={ncls}")
    if sv.dtype != torch.float32 or epi.dtype != torch.float32:
        raise TypeError("sv and epi must be float32")
    for name, t in (("x", x), ("sv", sv), ("wt", wt), ("epi", epi)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.numel() // c >= 2 ** 31:
        raise ValueError(f"{x.numel() // c} pixels exceed the kernel's int32 index range")


def _launch_dense(x, sv, wt, epi, ncls: int, fp: bool) -> torch.Tensor:
    global DENSE_LAUNCHES, LAST_ROUTE
    from tpuseg_torch.kernels.build import current_stream, launch

    if x.data_ptr() % 16 or wt.data_ptr() % 16:
        raise ValueError("x and wt must be 16-byte aligned for vector loads")
    route = kernel_route(x.dtype, wt.dtype, fp)
    b, h, w, c = x.shape
    out = torch.empty((b, h, w), dtype=torch.int32, device=x.device)
    launch("head_argmax", "tpuseg_dense_head_argmax", x.device, current_stream(x.device),
           x.data_ptr(), sv.data_ptr(), wt.data_ptr(), _DTYPE_CODES[wt.dtype], epi.data_ptr(),
           out.data_ptr(), b * h * w, c, ncls, int(fp), _ROUTE_CODES[route],
           what=f"dense head kernel launch failed ({route} route)")
    DENSE_LAUNCHES += 1
    LAST_ROUTE = route
    return out


def dense_head_argmax(x: torch.Tensor, sv: torch.Tensor, wt: torch.Tensor,
                      epi: torch.Tensor, ncls: int, fp: bool) -> torch.Tensor:
    """K6, the dense head + argmax: int8 ``(B, H, W, C)`` activations ->
    ``(B, H, W)`` int32 labels.

    ``sv`` f32 ``[C]`` input dequant scales (read by the fp head), ``wt``
    ``[ncls, C]`` transposed head weights (bf16/f32 for the fp head, int8
    otherwise), ``epi`` f32 ``[4, ncls]`` = (bias, bn_scale, bn_shift,
    wscale) rows, all on ``x``'s device. A CUDA tensor launches the kernel
    (its route from :func:`kernel_route`) or raises; a CPU tensor runs
    :func:`_dense_head_argmax_plain`.
    """
    _check_dense(x, sv, wt, epi, ncls, fp)
    if x.device.type == "cpu":
        return _dense_head_argmax_plain(x, sv, wt, epi, ncls, fp)
    if x.device.type != "cuda":
        raise ValueError(f"dense_head_argmax runs on cuda or cpu tensors, not {x.device}")
    return _launch_dense(x, sv, wt, epi, ncls, fp)
