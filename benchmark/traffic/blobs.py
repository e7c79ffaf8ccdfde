"""A pool of learnable segmentation pairs, made from the seed on the device.

Each pair is a one-channel uint16 image and its uint8 mask: the mask
thresholds a smoothed random field (sigma 12 pixels: blobs), and the image
is brighter inside the blobs (+1200 counts on 2000) under smooth shading
(sigma 40, scaled to 400 counts) and pixel noise (250 counts), clipped to
0..65535. It is the training pair of the repository's checks
(``chip_smoke.py::blob_pair``), with the Gaussian filters (scipy's, reflect
boundary, truncated at 4 sigma) run as separable convolutions on the
device from a ``torch.Generator`` there, so a pool of 64 pairs of 512^2
takes a fraction of a second.

Images come back as int32 ``[N, H, W, 1]`` and masks as uint8 ``[N, H,
W]``, on the device, as the training step takes raw batches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def gaussian(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """scipy.ndimage.gaussian_filter of each ``[H, W]`` plane of ``x``
    (``[N, H, W]``): reflect boundary (the edge sample repeated), taps to
    4 sigma (to the plane's side, where that is shorter)."""
    r = min(int(4.0 * sigma + 0.5), min(x.shape[1:]))
    t = torch.arange(-r, r + 1, dtype=torch.float32, device=x.device)
    k = torch.exp(-0.5 * (t / sigma) ** 2)
    k = k / k.sum()
    y = x[:, None]
    y = torch.cat([y[..., :r, :].flip(-2), y, y[..., -r:, :].flip(-2)], dim=-2)
    y = F.conv2d(y, k.view(1, 1, -1, 1))
    y = torch.cat([y[..., :r].flip(-1), y, y[..., -r:].flip(-1)], dim=-1)
    return F.conv2d(y, k.view(1, 1, 1, -1))[:, 0]


def make_pool(spec: dict, seed: int, device):
    """``spec["pool"]`` pairs of ``spec["size"]``^2 pixels."""
    g = torch.Generator(device=device).manual_seed(seed)
    n, s = spec["pool"], spec["size"]

    def normal():
        return torch.randn((n, s, s), generator=g, device=device)

    msk = gaussian(normal(), 12.0) > 0
    shade = gaussian(normal(), 40.0)
    shade = shade / shade.std(dim=(1, 2), keepdim=True)
    img = 2000.0 + 1200.0 * msk.float() + 400.0 * shade + 250.0 * normal()
    img = torch.clamp(img, 0, 65535).to(torch.int32)
    return img[..., None].contiguous(), msk.to(torch.uint8).contiguous()
