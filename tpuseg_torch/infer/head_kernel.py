"""Blocked int8 head fused with per-phase argmax and depth-to-space.

Port of the TPU kernel ``tpuseg/infer/head_kernel.py::_head_kernel``
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

# Kernel launches since the counter was last reset (CPU calls don't count).
LAUNCHES = 0
# The route of the last kernel launch ("mma" or "general").
LAST_ROUTE = None

_DTYPE_CODES = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}
_ROUTE_CODES = {"general": 0, "mma": 1}


def head_kernel_eligible(ncls: int) -> bool:
    return ncls <= _MAX_KERNEL_CLASSES


def kernel_route(x_dtype: torch.dtype, wt_dtype: torch.dtype, fp: bool) -> str:
    """``"mma"`` for int8 activations with a bf16 weight (fp head) or an int8
    weight (int8 head); ``"general"`` for bf16/f32 activations or an f32
    weight, whose f32 products the tensor cores cannot form exactly."""
    if x_dtype == torch.int8 and wt_dtype == (torch.bfloat16 if fp else torch.int8):
        return "mma"
    return "general"


def _blocked_head_argmax_plain(x: torch.Tensor, sv: torch.Tensor,
                               wt: torch.Tensor, epi: torch.Tensor,
                               ncls: int, fp: bool) -> torch.Tensor:
    """The kernel's function in plain PyTorch (any device): the CPU path,
    and the kernel's yardstick on the card."""
    b, h, w, c4 = x.shape
    x2 = x.reshape(-1, c4)
    if fp:
        xf = (x2.float() * sv).to(wt.dtype).float()
        y = xf @ wt.float().T
    else:
        # int8 x int8 sums are integers below 2^53: exact in float64
        y = (x2.double() @ wt.double().T).float() * epi[3]
    y = torch.clamp_min(y + epi[0], 0.0) * epi[1] + epi[2]
    lbl = torch.argmax(y.reshape(b, h, w, 2, 2, ncls), dim=-1)  # first max
    return lbl.permute(0, 1, 3, 2, 4).reshape(b, 2 * h, 2 * w).to(torch.int32)


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
    from tpuseg_torch.kernels.build import load

    _check(x, sv, wt, epi, ncls, fp)
    route = kernel_route(x.dtype, wt.dtype, fp)
    lib = load("head_argmax")
    b, h, w, c4 = x.shape
    out = torch.empty((b, 2 * h, 2 * w), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.tpuseg_head_argmax(
            x.data_ptr(), _DTYPE_CODES[x.dtype], sv.data_ptr(), wt.data_ptr(),
            _DTYPE_CODES[wt.dtype], epi.data_ptr(), out.data_ptr(),
            b, h, w, c4, ncls, int(fp), _ROUTE_CODES[route], stream)
    if err:
        msg = lib.tpuseg_cuda_error_string(err).decode()
        raise RuntimeError(f"head_argmax kernel launch failed ({route} route): {msg} ({err})")
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
