"""The training step's device augmentation, in plain PyTorch.

A frozen copy of the port's ``aug/device.py`` and ``ops/warp.py`` (the
arithmetic of usnistgov ``UNet/augment.py`` and ``imagereader.py``), so that
the reference draws the same augmentation from a generator seeded as the
program's and applies it without the program: the draws in the same order
and shapes (:func:`draw`), then the affine warp (an exact rot90 and three
Paeth shears with a mirror boundary, then a separable scale/translate),
the reflections, additive noise scaled to the dynamic range, a separable
Gaussian blur with a numpy-symmetric boundary, and an intensity shift;
then the z-score (std <= 1 only shifts) and the one-hot labels. The row
shear, a CUDA kernel in the program, is its plain form here.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F


def draw(g: torch.Generator, b: int, h: int, w: int, c: int, p: Dict, device) -> Dict:
    def rand(*shape):
        return torch.rand(shape, generator=g, device=device)

    zeros = torch.zeros(b, device=device)
    d = {"theta": rand(b) * (2 * math.pi) if p["rotation"] else zeros}
    d["refl_x"] = (rand(b) < 0.5) if p["reflection"] else zeros.bool()
    d["refl_y"] = (rand(b) < 0.5) if p["reflection"] else zeros.bool()
    jit_x = rand(b) * p["jitter_severity"] * w
    jit_y = rand(b) * p["jitter_severity"] * h
    sign_x = torch.where(rand(b) < 0.5, -1.0, 1.0)
    sign_y = torch.where(rand(b) < 0.5, -1.0, 1.0)
    d["tx"] = sign_x * torch.floor(jit_x) if p["jitter_severity"] > 0 else zeros
    d["ty"] = sign_y * torch.floor(jit_y) if p["jitter_severity"] > 0 else zeros
    s = rand(b, 2) * (2 * p["scale_severity"]) + (1 - p["scale_severity"])
    d["sx"] = s[:, 0] if p["scale_severity"] > 0 else zeros + 1.0
    d["sy"] = s[:, 1] if p["scale_severity"] > 0 else zeros + 1.0
    d["noise_u"] = rand(b) * 2.0 - 1.0
    d["noise"] = torch.randn((b, h, w, c), generator=g, device=device)
    d["blur_sigma"] = (rand(b) * 2.0 - 1.0) * p["blur_max_sigma"]
    d["intensity_u"] = rand(b)
    d["intensity_sign"] = torch.where(rand(b) < 0.5, 1.0, -1.0)
    return d


def _mirror(x: torch.Tensor, size: int) -> torch.Tensor:
    if size <= 1:
        return torch.zeros_like(x)
    period = 2.0 * (size - 1)
    x = torch.remainder(torch.abs(x), period)
    return torch.where(x > size - 1, period - x, x)


def _shear_x(img: torch.Tensor, offset: torch.Tensor) -> torch.Tensor:
    """out[n, h, c] = in[n, h, c + offset[n, h]], bilinear, mirror boundary."""
    n, h, w = img.shape
    pad = int(0.3536 * max(h, w)) + 3
    padded = F.pad(img, (pad, pad), mode="reflect")
    start = offset + pad
    base = torch.floor(start)
    s = base.to(torch.int32).clamp_(0, padded.shape[2] - w - 1).long()
    f = (start - base).float()[..., None]
    idx = s[..., None] + torch.arange(w, device=img.device)
    return torch.gather(padded, 2, idx) * (1.0 - f) + torch.gather(padded, 2, idx + 1) * f


def _rotate(img: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    b, h, w, c = img.shape
    k = torch.round(theta / (math.pi / 2)).to(torch.int32)
    theta_r = theta - k.float() * (math.pi / 2)
    k = torch.remainder(k, 4)[:, None, None, None]
    out = torch.where(k == 1, img.transpose(1, 2).flip(1), img)
    out = torch.where(k == 2, img.flip((1, 2)), out)
    img = torch.where(k == 3, img.transpose(1, 2).flip(2), out)
    a = -torch.tan(theta_r / 2.0)
    bf = torch.sin(theta_r)
    cy, cx = h / 2.0 - 0.5, w / 2.0 - 0.5
    rows = torch.arange(h, dtype=torch.float32, device=img.device).expand(b, h)
    cols = torch.arange(w, dtype=torch.float32, device=img.device).expand(b, w)
    flat = img.permute(0, 3, 1, 2).reshape(b * c, h, w)
    off_x = torch.repeat_interleave(a[:, None] * (rows - cy), c, dim=0)
    flat = _shear_x(flat, off_x)
    off_y = torch.repeat_interleave(bf[:, None] * (cols - cx), c, dim=0)
    flat = _shear_x(flat.transpose(1, 2), off_y).transpose(1, 2)
    flat = _shear_x(flat, off_x)
    return flat.reshape(b, c, h, w).permute(0, 2, 3, 1)


def _weights(src: torch.Tensor, n: int) -> torch.Tensor:
    taps = torch.arange(n, dtype=torch.float32, device=src.device)
    return torch.clamp_min(1.0 - torch.abs(_mirror(src, n)[..., None] - taps), 0.0)


def _scale_translate(img, sx, sy, tx, ty):
    b, h, w, c = img.shape
    rows = torch.arange(h, dtype=torch.float32, device=img.device).expand(b, h)
    cols = torch.arange(w, dtype=torch.float32, device=img.device).expand(b, w)
    wr = _weights((rows - ty[:, None]) / sy[:, None], h)
    wc = _weights((cols - tx[:, None]) / sx[:, None], w)
    out = torch.einsum("boi,biwc->bowc", wr, img)
    return torch.einsum("boi,bhic->bhoc", wc, out)


def _pad_symmetric(x: torch.Tensor, half: int, dim: int) -> torch.Tensor:
    n = x.shape[dim]
    return torch.cat([x.narrow(dim, 0, half).flip(dim), x,
                      x.narrow(dim, n - half, half).flip(dim)], dim=dim)


def _blur(img: torch.Tensor, sigma: torch.Tensor, size: int) -> torch.Tensor:
    half = size // 2
    t = torch.arange(-half, half + 1, dtype=torch.float32, device=img.device)
    k = torch.exp(-0.5 * (t / torch.clamp_min(sigma, 1e-6)[:, None]) ** 2)
    k = k / torch.sum(k, dim=-1, keepdim=True)
    k = torch.where(sigma[:, None] > 0, k, (t == 0).float())
    b, h, w, c = img.shape
    x = _pad_symmetric(_pad_symmetric(img, half, 1), half, 2)
    kern = k[:, :, None, None, None]
    rows = 0
    for i in range(size):
        rows = rows + kern[:, i] * x[:, i:i + h]
    cols = 0
    for i in range(size):
        cols = cols + kern[:, i] * rows[:, :, i:i + w]
    return cols


def _range(images: torch.Tensor) -> torch.Tensor:
    flat = images.reshape(images.shape[0], -1)
    return flat.amax(dim=1) - flat.amin(dim=1)


def augment(g: torch.Generator, images: torch.Tensor, masks: torch.Tensor, p: Dict,
            num_classes: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Raw ``[B, H, W, C]`` images and ``[B, H, W]`` masks (square) ->
    z-scored float32 images and one-hot float32 labels."""
    images = images.float()
    b, h, w, c = images.shape
    d = draw(g, b, h, w, c, p, images.device)
    stacked = torch.cat([images, masks[..., None].float()], dim=-1)
    stacked = _scale_translate(_rotate(stacked, d["theta"]), d["sx"], d["sy"], d["tx"], d["ty"])
    images, m = stacked[..., :c], stacked[..., c]
    rx, ry = d["refl_x"][:, None, None, None], d["refl_y"][:, None, None, None]
    images = torch.where(rx, images.flip(2), images)
    m = torch.where(rx[..., 0], m.flip(2), m)
    images = torch.where(ry, images.flip(1), images)
    m = torch.where(ry[..., 0], m.flip(1), m)
    if p["noise_severity"] > 0:
        sigma = (d["noise_u"] * p["noise_severity"] * _range(images))[:, None, None, None]
        images = images + d["noise"] * sigma
    if p["blur_max_sigma"] > 0:
        images = _blur(images, torch.clamp_min(d["blur_sigma"], 0.0),
                       max(int(4 * p["blur_max_sigma"]) * 2 + 1, 1))
    if p["intensity_severity"] > 0:
        value = d["intensity_u"] * p["intensity_severity"] * _range(images)
        images = images + (d["intensity_sign"] * value)[:, None, None, None]
    labels = torch.round(m).to(torch.int32)
    mean = torch.mean(images, dim=(1, 2), keepdim=True)
    std = torch.std(images, dim=(1, 2), keepdim=True, correction=0)
    images = (images - mean) / torch.where(std <= 1.0, 1.0, std)
    onehot = (labels[..., None].long() == torch.arange(num_classes, device=labels.device)).float()
    return images, onehot
