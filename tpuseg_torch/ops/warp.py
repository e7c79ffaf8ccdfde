"""Batched affine warp: rot90 + three Paeth shears, then a separable
scale/translate resample.

Counterpart of ``tpuseg/ops/warp.py`` (see there for the derivation and the
reference lines). Rotation by theta is an exact rot90^k (theta reduced to
[-45, 45] degrees) followed by R^-1(theta) = X(a) Y(b) X(a) with
a = -tan(theta/2), b = sin(theta), where an x-shear shifts every row by a
per-row constant: ``out[n,h,c] = in[n,h,c + offset[n,h]]``, bilinear, with
a numpy-'reflect' (mirror) boundary. The scale/translate stage is two
batched matmuls against per-sample bilinear weight matrices.

The row shear is kernel K1 (:func:`_shear_rows`): on a CUDA tensor it
launches the hand-written kernel in ``tpuseg_torch/csrc/shear_rows.cu``
(built at first use by :mod:`tpuseg_torch.kernels.build`) or raises; on a
CPU tensor it runs :func:`_shear_rows_plain`, the same function in plain
PyTorch. Nothing falls back from one to the other. The JAX package's three
forms of the shear (XLA barrel shifter, Pallas roll, Pallas DMA) and its
``TPUSEG_SHEAR`` knob have one counterpart here. ``LAUNCHES`` counts kernel
launches.

Square images only (rot90 would change a non-square shape): callers pad
to square, warp and crop (``tpuseg_torch.aug.device``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# Kernel launches since the counter was last reset (CPU calls don't count).
LAUNCHES = 0


def _mirror_float(x: torch.Tensor, size: int) -> torch.Tensor:
    """Continuous numpy-'reflect' fold of coordinates into [0, size-1]."""
    if size <= 1:
        return torch.zeros_like(x)
    period = 2.0 * (size - 1)
    x = torch.remainder(torch.abs(x), period)
    return torch.where(x > size - 1, period - x, x)


# ---------------------------------------------------------------------------
# K1: out[n, h, c] = (1-f[n,h]) * img[n, h, s[n,h] + c] + f[n,h] * img[n, h, s[n,h] + c + 1]
# ---------------------------------------------------------------------------

def _shear_rows_plain(img_padded: torch.Tensor, shift: torch.Tensor, frac: torch.Tensor,
                      out_width: int) -> torch.Tensor:
    """K1's function in plain PyTorch (any device): the CPU path, and the
    kernel's yardstick on the card. Shifts are clamped to
    [0, Wp - out_width - 1], as the kernel clamps them, so no tap leaves the
    row (the callers clip them there already)."""
    n, h, wp = img_padded.shape
    s = shift.long().clamp(0, wp - out_width - 1)
    idx = s[..., None] + torch.arange(out_width, device=img_padded.device)
    x0 = torch.gather(img_padded, 2, idx)
    x1 = torch.gather(img_padded, 2, idx + 1)
    f = frac[..., None]
    return x0 * (1.0 - f) + x1 * f


def _check_shear(img_padded, shift, frac, out_width: int) -> None:
    if img_padded.ndim != 3 or img_padded.dtype != torch.float32:
        raise TypeError(f"img_padded must be float32 [N, H, Wp], got "
                        f"{img_padded.dtype} {tuple(img_padded.shape)}")
    n, h, wp = img_padded.shape
    if shift.dtype != torch.int32 or frac.dtype != torch.float32:
        raise TypeError(f"shift must be int32 and frac float32, got {shift.dtype} "
                        f"and {frac.dtype}")
    if tuple(shift.shape) != (n, h) or tuple(frac.shape) != (n, h):
        raise ValueError(f"shift {tuple(shift.shape)} and frac {tuple(frac.shape)} "
                         f"must be [N, H] = {(n, h)}")
    if not 1 <= out_width <= wp - 1:
        raise ValueError(f"out_width {out_width} needs 1 <= out_width <= Wp - 1 = {wp - 1}")
    for name, t in (("shift", shift), ("frac", frac)):
        if t.device != img_padded.device:
            raise ValueError(f"{name} is on {t.device}, img_padded on {img_padded.device}")


def _launch_shear(img_padded, shift, frac, out_width: int) -> torch.Tensor:
    global LAUNCHES
    from tpuseg_torch.kernels.build import current_stream, launch

    for name, t in (("img_padded", img_padded), ("shift", shift), ("frac", frac)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n, h, wp = img_padded.shape
    out = torch.empty((n, h, out_width), dtype=torch.float32, device=img_padded.device)
    if out.numel() == 0:
        return out
    if n * h >= 2 ** 31:
        raise ValueError(f"{n * h} rows exceed the kernel's int32 row range")
    dev = img_padded.device
    launch("shear_rows", "tpuseg_shear_rows", dev, current_stream(dev), img_padded.data_ptr(),
           shift.data_ptr(), frac.data_ptr(), out.data_ptr(), n, h, wp, out_width,
           what="shear_rows kernel launch failed")
    LAUNCHES += 1
    return out


def _shear_rows(img_padded: torch.Tensor, shift: torch.Tensor, frac: torch.Tensor,
                out_width: int) -> torch.Tensor:
    """K1: img_padded f32 [N, H, Wp], shift i32 [N, H] (into padded
    columns), frac f32 [N, H] -> f32 [N, H, out_width]. Launches the CUDA
    kernel for CUDA tensors (or raises), runs the plain version for CPU
    tensors."""
    _check_shear(img_padded, shift, frac, out_width)
    dev = img_padded.device
    if dev.type == "cpu":
        return _shear_rows_plain(img_padded, shift, frac, out_width)
    if dev.type != "cuda":
        raise ValueError(f"_shear_rows runs on cuda or cpu tensors, not {dev}")
    return _launch_shear(img_padded, shift, frac, out_width)


def _apply_shear_x(img: torch.Tensor, offset: torch.Tensor) -> torch.Tensor:
    """out[n,h,c] = in[n,h, c + offset[n,h]] with mirror boundary.
    img [N, H, W] f32; offset [N, H] f32 (can be fractional)."""
    n, h, w = img.shape
    pad = int(0.3536 * max(h, w)) + 3  # max Paeth shear reach (static)
    padded = F.pad(img, (pad, pad), mode="reflect").contiguous()
    # sampling col for output col 0 is offset; shift into padded coords
    start = offset + pad
    base = torch.floor(start)
    shift = base.to(torch.int32).clamp_(0, padded.shape[2] - w - 1)
    frac = (start - base).float()
    return _shear_rows(padded, shift, frac.contiguous(), w)


def _apply_shear_y(img: torch.Tensor, offset: torch.Tensor) -> torch.Tensor:
    """out[n,h,c] = in[n, h + offset[n,c], c] — via transpose + x-shear."""
    return _apply_shear_x(img.transpose(1, 2), offset).transpose(1, 2)


# ---------------------------------------------------------------------------
# Separable scale+translate as batched matmuls
# ---------------------------------------------------------------------------

def _resample_weights(src: torch.Tensor, in_size: int) -> torch.Tensor:
    """src [B, out] float sample positions -> bilinear weights [B, out, in]."""
    src_m = _mirror_float(src, in_size)
    taps = torch.arange(in_size, dtype=torch.float32, device=src.device)
    return torch.clamp_min(1.0 - torch.abs(src_m[..., None] - taps), 0.0)


def scale_translate(img: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor,
                    tx: torch.Tensor, ty: torch.Tensor) -> torch.Tensor:
    """Reference warp stage (augment.py:165-167): corner-anchored scale then
    translate; inverse map in = (out - t)/s. img [B,H,W,C]; params [B]."""
    b, h, w, c = img.shape
    rows_out = torch.arange(h, dtype=torch.float32, device=img.device).expand(b, h)
    cols_out = torch.arange(w, dtype=torch.float32, device=img.device).expand(b, w)
    wr = _resample_weights((rows_out - ty[:, None]) / sy[:, None], h)  # [B,H,H]
    wc = _resample_weights((cols_out - tx[:, None]) / sx[:, None], w)  # [B,W,W]
    out = torch.einsum("boi,biwc->bowc", wr, img)
    return torch.einsum("boi,bhic->bhoc", wc, out)


# ---------------------------------------------------------------------------
# Rotation: rot90^k + Paeth shears
# ---------------------------------------------------------------------------

def _rot90_batch(img: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Exact per-sample rot90^k (CCW), square images. img [B,H,W,C], k [B]."""
    r1 = img.transpose(1, 2).flip(1)  # rot90 CCW
    r2 = img.flip((1, 2))
    r3 = img.transpose(1, 2).flip(2)
    k = k[:, None, None, None]
    out = torch.where(k == 1, r1, img)
    out = torch.where(k == 2, r2, out)
    return torch.where(k == 3, r3, out)


def rotate(img: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Rotate content CCW by per-sample theta (radians) about the center,
    bilinear, mirror boundary. img [B,H,W,C] f32 with H == W."""
    b, h, w, c = img.shape
    if h != w:
        raise ValueError(f"Paeth rotation path requires square images, got {h}x{w}")
    # reduce to |theta'| <= 45deg with an exact quarter-turn
    k = torch.round(theta / (math.pi / 2)).to(torch.int32)
    theta_r = theta - k.float() * (math.pi / 2)
    img = _rot90_batch(img, torch.remainder(k, 4))

    a = -torch.tan(theta_r / 2.0)  # x-shear factor
    bf = torch.sin(theta_r)  # y-shear factor
    cy, cx = h / 2.0 - 0.5, w / 2.0 - 0.5
    rows = torch.arange(h, dtype=torch.float32, device=img.device).expand(b, h)
    cols = torch.arange(w, dtype=torch.float32, device=img.device).expand(b, w)

    flat = img.permute(0, 3, 1, 2).reshape(b * c, h, w)  # fold channels
    off_x = torch.repeat_interleave(a[:, None] * (rows - cy), c, dim=0)
    flat = _apply_shear_x(flat, off_x)
    off_y = torch.repeat_interleave(bf[:, None] * (cols - cx), c, dim=0)
    flat = _apply_shear_y(flat, off_y)
    flat = _apply_shear_x(flat, off_x)
    return flat.reshape(b, c, h, w).permute(0, 2, 3, 1)


def warp_affine_batch(img: torch.Tensor, theta: torch.Tensor, tx: torch.Tensor,
                      ty: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor) -> torch.Tensor:
    """Full reference affine (rotate stage then scale/translate stage) for a
    batch with per-sample parameters. img [B,H,W,C] float32."""
    return scale_translate(rotate(img, theta), sx, sy, tx, ty)
