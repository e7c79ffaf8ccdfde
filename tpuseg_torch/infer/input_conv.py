"""K5: the fp input conv of the quantized walk, its epilogue fused.

Under the default ``fp_blocks`` the first conv block, ``enc1a``, stays in
floating point on both int8 walks: its input is the z-scored network input.
In the JAX package it is the fp branch of ``conv_block`` in
``_quantized_raw_fn`` (``tpuseg/infer/quant.py:544-560``: ``_conv_fp``
with bf16 operands and f32 sums, ReLU, folded BN) and ``emit``'s requantize
(``:526``), which XLA fuses into one conv fusion (blocked at ``:665-674``).
Here it is one function, :func:`input_conv`:

    acc = sum over (ky, kx, c), in that order, of r(x) * r(w)   (SAME zeros)
    q = clamp(rint((max(acc + b, 0) * s + t) / so), -127, 127)  as int8

with ``r`` rounding an operand to the compute dtype and back, one f32
accumulator per output starting at 0, each product and sum rounded on its
own, and ``so`` dividing as a 0-dim device tensor (PyTorch's CUDA division
by a Python scalar multiplies by its reciprocal, which rounds differently
from the true division the JAX package does). The output is ``(B, H, W,
F)``, or with ``blocked`` the phase-major ``(B, H/2, W/2, 4F)`` of
``quant._s2d``, whose channel ``(py * 2 + px) * F + f`` holds pixel ``(2i +
py, 2j + px)``: the blocked walk hands it the dense batch and the dense
kernel, so each output sums the 9*C products the blocked conv's 36*C taps
reduce to (the other 27*C are ``_block_weight``'s structural zeros).

On a CUDA tensor it launches the hand-written kernel in
``tpuseg_torch/csrc/input_conv.cu`` (built at first use by
:mod:`tpuseg_torch.kernels.build`) or raises; on a CPU tensor it runs
:func:`_input_conv_plain`, the same operations in plain PyTorch (9*C
broadcast products and sums). Nothing falls back from one to the other.
Both round and sum alike, so the kernel is bit-equal to the plain version.
``LAUNCHES`` counts kernel launches. The kernel's library plans each
launch itself (the output channels of a block, its halo buffers, whether
its codes leave by bulk copy, a persistent grid); :func:`launch_plan` asks
it for the launch it would make.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# Kernel launches since the counter was last reset (CPU calls don't count).
LAUNCHES = 0

# The operand dtypes the kernel rounds to, and their codes in the C interface.
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def conv_sums(x: torch.Tensor, w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The f32 sums of the SAME 3x3 conv of NHWC ``x`` with HWIO ``w``,
    operands rounded to ``dtype``: one accumulator per output from 0, taps
    added in ``(ky, kx, c)`` order, each product and sum its own operation
    (no ``addcmul``, which may contract)."""
    b, h, wd, c = x.shape
    xp = F.pad(x.to(dtype).float(), (0, 0, 1, 1, 1, 1))
    wr = w.to(dtype).float()
    acc = x.new_zeros((b, h, wd, w.shape[-1]), dtype=torch.float32)
    for ky in range(3):
        for kx in range(3):
            for ci in range(c):
                acc.add_(xp[:, ky:ky + h, kx:kx + wd, ci:ci + 1] * wr[ky, kx, ci])
    return acc


def affine(y: torch.Tensor, b: torch.Tensor, s: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """The block's ReLU and folded BN on f32 sums."""
    return torch.clamp_min(y + b, 0.0) * s + t


def requant(y: torch.Tensor, so: torch.Tensor) -> torch.Tensor:
    """Requantize to the block's output range (``quant.py``'s ``emit``)."""
    return torch.clamp(torch.round(y / so), -127, 127).to(torch.int8)


def _input_conv_plain(x, w, b, s, t, so, dtype, blocked):
    """The kernel's function in plain PyTorch (any device)."""
    from tpuseg_torch.infer.quant import _s2d  # quant imports this module

    q = requant(affine(conv_sums(x, w, dtype), b, s, t), so)
    return _s2d(q) if blocked else q


def _check_shapes(x, w, b, s, t, so, blocked) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be 4-D NHWC, got {tuple(x.shape)}")
    bsz, h, wd, c = x.shape
    if w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, c):
        raise ValueError(f"w must be HWIO (3, 3, {c}, F) for x's {c} channels, "
                         f"got {tuple(w.shape)}")
    f = w.shape[3]
    if min(bsz, h, wd, f) < 1:
        raise ValueError(f"empty input {tuple(x.shape)} or weights {tuple(w.shape)}")
    for name, v in (("b", b), ("s", s), ("t", t)):
        if tuple(v.shape) != (f,):
            raise ValueError(f"{name} has shape {tuple(v.shape)}, want ({f},)")
    if so.numel() != 1:
        raise ValueError(f"so must be a scalar, got {tuple(so.shape)}")
    if blocked and (h % 2 or wd % 2):
        raise ValueError(f"the blocked layout needs even H and W, got {h} x {wd}")


def _check(x, w, b, s, t, so, dtype) -> None:
    if dtype not in DTYPE_CODES:
        raise ValueError(f"the kernel rounds operands to {sorted(map(str, DTYPE_CODES))}, "
                         f"not {dtype}")
    for name, v in (("x", x), ("w", w), ("b", b), ("s", s), ("t", t), ("so", so)):
        if v.dtype != torch.float32 or v.device != x.device or not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32 on {x.device}, "
                             f"got {v.dtype} on {v.device}")
    bsz, h, wd, _ = x.shape
    if bsz * h * wd >= 2 ** 31:
        raise ValueError(f"{bsz * h * wd} output pixels exceed the kernel's 32-bit index range")


def _launch(x, w, b, s, t, so, dtype, blocked) -> torch.Tensor:
    """One kernel launch, planned by the library."""
    global LAUNCHES
    from tpuseg_torch.kernels.build import current_stream, launch

    _check(x, w, b, s, t, so, dtype)
    bsz, h, wd, c = x.shape
    f = w.shape[3]
    shape = (bsz, h // 2, wd // 2, 4 * f) if blocked else (bsz, h, wd, f)
    out = torch.empty(shape, dtype=torch.int8, device=x.device)
    launch("input_conv", "tpuseg_input_conv", x.device, current_stream(x.device), x.data_ptr(),
           w.data_ptr(), b.data_ptr(), s.data_ptr(), t.data_ptr(), so.data_ptr(), out.data_ptr(),
           bsz, h, wd, c, f, DTYPE_CODES[dtype], int(blocked),
           what=f"input_conv kernel launch failed for x {tuple(x.shape)} and {f} output "
                f"channels",
           note="; the plan refuses C >= 120, whose weights leave no room in shared memory")
    LAUNCHES += 1
    return out


def launch_plan(shape, f: int, dtype: torch.dtype, blocked: bool, device) -> dict:
    """The launch the kernel makes for an NHWC input of ``shape`` and ``f``
    output channels on a CUDA ``device``, without making it: the grid,
    resident blocks per SM, SMs, tiles, shared memory, the tile, the output
    channels of a chunk (``fc``), the halo buffers (``stages``) and whether
    the codes leave by bulk copy (``staged``)."""
    import ctypes

    from tpuseg_torch.kernels.build import check, load

    bsz, h, wd, c = shape
    lib = load("input_conv")
    out = (ctypes.c_int * 10)()
    with torch.cuda.device(device):  # the plan reads the current device's SMs
        err = lib.tpuseg_input_conv_plan(bsz, h, wd, c, f, DTYPE_CODES[dtype], int(blocked),
                                         out)
    check(lib, err, f"input_conv plan failed for {tuple(shape)} and {f} output channels")
    keys = ("grid", "resident_per_sm", "sms", "tiles", "smem_bytes", "tile_h", "tile_w", "fc",
            "stages", "staged")
    plan = dict(zip(keys, out))
    plan["staged"] = bool(plan["staged"])
    return plan


def requant_mismatches(so: torch.Tensor, count: int = 0, seed: int = 0) -> dict:
    """Hold the kernel's reciprocal requantize against its true division
    for each scale of the CUDA vector ``so``: over every f32 value with
    ``count`` 0, else over ``count`` hashed draws each (half random bit
    patterns, half within 8 ulps of the rounding's ties). Returns the
    numbers of values whose codes differ (``codes``), whose quotients differ
    (``quotients``) and whose quotients differ outside underflow (``normal``:
    |v| >= 2^-100 and a normal true quotient), the largest |true quotient|
    and |v| among the values whose quotients differ (``largest_quotient``,
    ``largest_value``), and up to 8 ``(so, v)`` whose codes differ
    (``examples``)."""
    from tpuseg_torch.kernels.build import current_stream, launch

    if so.dtype != torch.float32 or so.device.type != "cuda" or so.dim() != 1:
        raise ValueError(f"so must be a CUDA float32 vector, got {so.dtype} {tuple(so.shape)} "
                         f"on {so.device}")
    so = so.contiguous()
    out = torch.zeros(21, dtype=torch.int64, device=so.device)
    launch("input_conv", "tpuseg_input_conv_check_requant", so.device, current_stream(so.device),
           so.data_ptr(), so.numel(), count, int(count == 0), seed, out.data_ptr(),
           what="requant check failed")
    codes, quotients, normal, *bits = out.tolist()

    def floats(words):
        return torch.tensor(words, dtype=torch.int64).to(torch.int32).view(torch.float32).tolist()

    largest_q, largest_v = floats(bits[:2])
    return {"codes": codes, "quotients": quotients, "normal": normal,
            "largest_quotient": largest_q, "largest_value": largest_v,
            "examples": [floats(bits[2 + 2 * j:4 + 2 * j]) for j in range(min(codes, 8))]}


def input_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, s: torch.Tensor,
               t: torch.Tensor, so: torch.Tensor, dtype: torch.dtype,
               blocked: bool = False) -> torch.Tensor:
    """SAME 3x3 conv of the NHWC f32 network input ``x`` with the folded
    f32 HWIO ``w`` (operands rounded to ``dtype``, f32 sums), then ``max(+
    b, 0) * s + t`` and the requantize by the 0-dim ``so``: int8 ``(B, H,
    W, F)``, or with ``blocked`` ``(B, H/2, W/2, 4F)`` phase-major."""
    _check_shapes(x, w, b, s, t, so, blocked)
    dev = x.device
    if dev.type == "cpu":
        return _input_conv_plain(x, w, b, s, t, so, dtype, blocked)
    if dev.type != "cuda":
        raise ValueError(f"input_conv runs on cuda or cpu tensors, not {dev}")
    return _launch(x, w, b, s, t, so, dtype, blocked)
