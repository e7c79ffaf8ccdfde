"""On-device augmentation of raw uint batches.

Counterpart of ``tpuseg/aug/device.py``: the affine warp (rot90 + Paeth
shears through kernel K1, then a separable scale/translate; ``ops/warp.py``),
reflections, additive noise, blur, an intensity shift, z-score and one-hot
run on the card on the raw uint16/uint8 batch the readers ship. The
semantics, and the two divergences from the host path, are the JAX
package's (see its docstring).

The random draws are split from the arithmetic:

- :func:`draw_augmentation` draws every random quantity of one batch from
  an explicit ``torch.Generator`` (the JAX package's ``_sample_affine`` per
  sample, the reflections, the noise amplitude and normal field, the blur
  sigma, the intensity value and sign);
- :func:`apply_augmentation` applies given draws and has no randomness, so
  the tests can feed it the JAX package's own ``jax.random`` draws.

The port's generator gives other numbers than ``jax.random`` from the same
seed; the distributions are the same.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from tpuseg_torch.ops import warp as warp_lib


@dataclass(frozen=True)
class DeviceAugmentParams:
    """Mirrors data.reader.AugmentParams (reference imagereader.py:79-85)."""

    reflection: bool = True
    rotation: bool = True
    jitter_severity: float = 0.1
    noise_severity: float = 0.02
    scale_severity: float = 0.1
    blur_max_sigma: float = 2.0
    intensity_severity: float = 0.0

    # blur kernel taps; 4*sigma_max each side covers the gaussian support
    @property
    def blur_kernel_size(self) -> int:
        k = int(4 * self.blur_max_sigma) * 2 + 1
        return max(k, 1)


@dataclass
class AugmentDraws:
    """Every random quantity of one batch of B samples of [H, W, C]:
    theta/tx/ty/sx/sy f32 [B], refl_x/refl_y bool [B], noise_u f32 [B] in
    [-1, 1), noise f32 [B, H, W, C] standard normal, blur_sigma f32 [B],
    intensity_u f32 [B] in [0, 1), intensity_sign f32 [B] of +-1."""

    theta: torch.Tensor
    refl_x: torch.Tensor
    refl_y: torch.Tensor
    tx: torch.Tensor
    ty: torch.Tensor
    sx: torch.Tensor
    sy: torch.Tensor
    noise_u: torch.Tensor
    noise: torch.Tensor
    blur_sigma: torch.Tensor
    intensity_u: torch.Tensor
    intensity_sign: torch.Tensor

    def to(self, device) -> "AugmentDraws":
        return AugmentDraws(**{f.name: getattr(self, f.name).to(device)
                               for f in dataclasses.fields(self)})


def draw_augmentation(generator: Optional[torch.Generator], b: int, h: int, w: int,
                      c: int, p: DeviceAugmentParams,
                      device=None) -> AugmentDraws:
    """Draw one batch's augmentation from ``generator`` (on ``device``):
    the quantities of ``tpuseg.aug.device._sample_affine`` per sample and of
    ``_augment_batch``, with their distributions."""
    def rand(*shape):
        return torch.rand(shape, generator=generator, device=device)

    zeros = torch.zeros(b, device=device)
    theta = rand(b) * (2 * math.pi) if p.rotation else zeros
    refl_x = (rand(b) < 0.5) if p.reflection else zeros.bool()
    refl_y = (rand(b) < 0.5) if p.reflection else zeros.bool()
    jit_amp_x = rand(b) * p.jitter_severity * w
    jit_amp_y = rand(b) * p.jitter_severity * h
    sign_x = torch.where(rand(b) < 0.5, -1.0, 1.0)
    sign_y = torch.where(rand(b) < 0.5, -1.0, 1.0)
    # reference truncates jitter to whole pixels (augment.py:88, 93)
    tx = sign_x * torch.floor(jit_amp_x) if p.jitter_severity > 0 else zeros
    ty = sign_y * torch.floor(jit_amp_y) if p.jitter_severity > 0 else zeros
    s = rand(b, 2) * (2 * p.scale_severity) + (1 - p.scale_severity)
    sx = s[:, 0] if p.scale_severity > 0 else zeros + 1.0
    sy = s[:, 1] if p.scale_severity > 0 else zeros + 1.0
    noise_u = rand(b) * 2.0 - 1.0
    noise = torch.randn((b, h, w, c), generator=generator, device=device)
    blur_sigma = (rand(b) * 2.0 - 1.0) * p.blur_max_sigma
    intensity_u = rand(b)
    intensity_sign = torch.where(rand(b) < 0.5, 1.0, -1.0)
    return AugmentDraws(theta, refl_x, refl_y, tx, ty, sx, sy, noise_u, noise,
                        blur_sigma, intensity_u, intensity_sign)


def _gaussian_kernel(sigma: torch.Tensor, size: int) -> torch.Tensor:
    """1-D gaussian taps [B, size] per sigma [B]; sigma<=0 degenerates to a
    delta (no blur)."""
    half = size // 2
    x = torch.arange(-half, half + 1, dtype=torch.float32, device=sigma.device)
    safe = torch.clamp_min(sigma, 1e-6)[:, None]
    k = torch.exp(-0.5 * (x / safe) ** 2)
    k = k / torch.sum(k, dim=-1, keepdim=True)
    delta = (x == 0).float()
    return torch.where(sigma[:, None] > 0, k, delta)


def _pad_symmetric(x: torch.Tensor, half: int, dim: int) -> torch.Tensor:
    """numpy ``pad(mode="symmetric")`` along ``dim``: the edge sample is
    repeated (scipy calls this mode 'reflect'). ``F.pad`` has no such mode,
    and its 'reflect' (mirror, edge not repeated) is another function."""
    n = x.shape[dim]
    if half > n:
        raise ValueError(f"symmetric pad of {half} exceeds the dimension {n}")
    lo = x.narrow(dim, 0, half).flip(dim)
    hi = x.narrow(dim, n - half, half).flip(dim)
    return torch.cat([lo, x, hi], dim=dim)


def _separable_blur(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Per-sample separable blur of [B,H,W,C] with taps [B, size], padding
    numpy-'symmetric' as the JAX package does (its note: numpy 'reflect'
    diverged from the host path by up to 8% near every border). The taps
    are summed in the JAX package's order."""
    b, h, w, c = img.shape
    size = kernel.shape[1]
    half = size // 2
    x = _pad_symmetric(_pad_symmetric(img, half, 1), half, 2)
    kern = kernel[:, :, None, None, None]
    rows = 0
    for i in range(size):
        rows = rows + kern[:, i] * x[:, i:i + h]
    cols = 0
    for i in range(size):
        cols = cols + kern[:, i] * rows[:, :, i:i + w]
    return cols


def _reflect_pad_to_square(x: torch.Tensor, s_dim: int, py: int, px: int) -> torch.Tensor:
    """Reflect-pad [N,H,W,C] to [N,s_dim,s_dim,C] with (py, px) leading pads.
    np-style 'reflect' caps each pad step at dim-1, so extreme aspect ratios
    pad iteratively (mirror-of-mirror), matching mirror boundary semantics."""
    n, h, w, c = x.shape
    pads = [(py, s_dim - h - py), (px, s_dim - w - px)]
    x = x.permute(0, 3, 1, 2)  # F.pad pads the trailing dims
    while any(p != (0, 0) for p in pads):
        step, rem = [], []
        for (lo, hi), cur in zip(pads, (x.shape[2], x.shape[3])):
            s_lo, s_hi = min(lo, cur - 1), min(hi, cur - 1)
            step.append((s_lo, s_hi))
            rem.append((lo - s_lo, hi - s_hi))
        x = torch.nn.functional.pad(x, (*step[1], *step[0]), mode="reflect")
        pads = rem
    return x.permute(0, 2, 3, 1)


def _zscore(img: torch.Tensor) -> torch.Tensor:
    """Per-sample, per-channel z-score with the reference's std<=1 guard
    (imagereader.py:44-49). img [B,H,W,C]."""
    mean = torch.mean(img, dim=(1, 2), keepdim=True)
    std = torch.std(img, dim=(1, 2), keepdim=True, correction=0)
    return (img - mean) / torch.where(std <= 1.0, 1.0, std)


def _dynamic_range(images: torch.Tensor) -> torch.Tensor:
    flat = images.reshape(images.shape[0], -1)
    return flat.amax(dim=1) - flat.amin(dim=1)


def apply_augmentation(images: torch.Tensor, masks: torch.Tensor, d: AugmentDraws,
                       p: DeviceAugmentParams) -> Tuple[torch.Tensor, torch.Tensor]:
    """Augment float32 images [B,H,W,C] and masks [B,H,W] with the draws
    ``d`` (on the images' device): the arithmetic of
    ``tpuseg.aug.device._augment_batch``. Returns (images, rounded float
    masks)."""
    b, h, w, c = images.shape
    stacked = torch.cat([images, masks[..., None].float()], dim=-1)
    if h == w:
        stacked = warp_lib.warp_affine_batch(stacked, d.theta, d.tx, d.ty, d.sx, d.sy)
    else:
        # non-square: reflect-pad to square -> warp -> crop; the corner-
        # anchored scale/translate is conjugated by the pad shift:
        # t' = t + p * (1 - s)
        s_dim = max(h, w)
        py, px = (s_dim - h) // 2, (s_dim - w) // 2
        padded = _reflect_pad_to_square(stacked, s_dim, py, px)
        padded = warp_lib.warp_affine_batch(
            padded, d.theta, d.tx + px * (1.0 - d.sx), d.ty + py * (1.0 - d.sy), d.sx, d.sy)
        stacked = padded[:, py:py + h, px:px + w, :]
    images, masks_f = stacked[..., :c], stacked[..., c]

    refl_x = d.refl_x[:, None, None, None]
    refl_y = d.refl_y[:, None, None, None]
    images = torch.where(refl_x, images.flip(2), images)
    masks_f = torch.where(refl_x[..., 0], masks_f.flip(2), masks_f)
    images = torch.where(refl_y, images.flip(1), images)
    masks_f = torch.where(refl_y[..., 0], masks_f.flip(1), masks_f)

    if p.noise_severity > 0:
        sigma_max = p.noise_severity * _dynamic_range(images)
        sigma = (d.noise_u * sigma_max)[:, None, None, None]
        images = images + d.noise * sigma

    if p.blur_max_sigma > 0:
        kerns = _gaussian_kernel(torch.clamp_min(d.blur_sigma, 0.0), p.blur_kernel_size)
        images = _separable_blur(images, kerns)

    if p.intensity_severity > 0:
        value = d.intensity_u * p.intensity_severity * _dynamic_range(images)
        images = images + (d.intensity_sign * value)[:, None, None, None]

    return images, torch.round(masks_f)


def preprocess(images: torch.Tensor, masks: torch.Tensor,
               num_classes: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Z-score float images [B,H,W,C]; one-hot integer masks [B,H,W] to
    float32 [B,H,W,num_classes] (out-of-range labels give all zeros, as
    ``jax.nn.one_hot`` does; no device sync)."""
    classes = torch.arange(num_classes, device=masks.device)
    labels = (masks[..., None].long() == classes).float()
    return _zscore(images), labels


def augment_and_preprocess_batch(
    generator: Optional[torch.Generator],
    images: torch.Tensor,  # [N,H,W,C] any real dtype
    masks: torch.Tensor,  # [N,H,W] integer
    params: DeviceAugmentParams = DeviceAugmentParams(),
    num_classes: int = 2,
    augment: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Raw uint batch -> (normalized float32 images, one-hot float32
    labels), on the batch's device, with draws from ``generator``."""
    images = images.float()
    if augment:
        b, h, w, c = images.shape
        draws = draw_augmentation(generator, b, h, w, c, params, images.device)
        images, masks_f = apply_augmentation(images, masks, draws, params)
        masks = masks_f.to(torch.int32)
    return preprocess(images, masks, num_classes)
