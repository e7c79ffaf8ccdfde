"""A pool of synthetic microscopy slides, made from the seed on the device.

Each slide is one channel of uint16 intensities: a smooth field of two
crossed sinusoids of random low frequencies (0.005 to 0.03 radians a
pixel) around 2000 counts, with an amplitude of 700 counts, plus pixel
noise of 150 counts, clipped to 0..65535. It is the image of the
repository's serving checks (``scripts/ab_torch.py::image``), drawn with
a ``torch.Generator`` on the device instead of numpy's on the host, so a
pool of large slides takes well under a second to make. The slides come
back to host memory, where a serving client holds its images.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch


def slide(g: torch.Generator, size: int, device) -> np.ndarray:
    f = torch.rand(4, generator=g, device=device) * 0.025 + 0.005
    ax = torch.arange(size, dtype=torch.float32, device=device)
    yy, xx = ax[:, None], ax[None, :]
    field = (torch.sin(yy * f[0] + xx * f[1]) + torch.cos(yy * f[2] - xx * f[3])) * 700 + 2000
    noise = torch.randn((size, size), generator=g, device=device) * 150
    img = torch.clamp(field + noise, 0, 65535).to(torch.int32)
    return img.cpu().numpy().astype(np.uint16)


def make_pool(spec: dict, seed: int, device) -> List[np.ndarray]:
    """``spec["pool"]`` distinct slides of ``spec["size"]``^2 pixels."""
    g = torch.Generator(device=device).manual_seed(seed)
    return [slide(g, spec["size"], device) for _ in range(spec["pool"])]
