"""Plain halo-tiled segmentation of a large image, and the judge of a mask.

The geometry is the reference's (usnistgov ``UNet/inference.py:27-136``):
the image is z-scored with its own mean and standard deviation (a
standard deviation of 1 or less only shifts the mean,
``imagereader.py:44-49``), reflect-padded to a multiple of 16, cut into a
grid of zones of ``tile - 2 * radius`` pixels, each zone computed in the
window of ``tile`` pixels around it (slid to fit inside the image), and
each zone's logits kept from its window. Everything here is numpy or plain
PyTorch; it imports nothing of the program.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

SIZE_FACTOR = 16


def zscore(img: np.ndarray) -> np.ndarray:
    x = img.astype(np.float32)
    mean, std = np.mean(x), np.std(x)
    return x - mean if std <= 1.0 else (x - mean) / std


def placements(height: int, width: int, tile: int, radius: int
               ) -> List[Tuple[int, int, int, int, int, int]]:
    """``(zone_y, zone_x, zone_y_end, zone_x_end, window_y, window_x)``."""
    zor = tile - 2 * radius
    full_h, full_w = max(height, tile), max(width, tile)
    out = []
    for i in range(0, height, zor):
        for j in range(0, width, zor):
            out.append((i, j, min(i + zor, height), min(j + zor, width),
                        min(max(i - radius, 0), full_h - tile),
                        min(max(j - radius, 0), full_w - tile)))
    return out


def logits(img: np.ndarray, forward: Callable[[torch.Tensor], torch.Tensor], tile: int,
           radius: int, batch: int, device) -> torch.Tensor:
    """``(H, W, classes)`` float32 logits of a 2-D image, stitched from its
    windows, on ``device``."""
    x = zscore(img)
    h, w = x.shape
    py, px = (-h) % SIZE_FACTOR, (-w) % SIZE_FACTOR
    x = np.pad(x, ((0, py), (0, px)), mode="reflect") if (py or px) else x
    hp, wp = x.shape
    ey, ex = max(0, tile - hp), max(0, tile - wp)
    x = np.pad(x, ((0, ey), (0, ex)), mode="reflect") if (ey or ex) else x
    xt = torch.from_numpy(np.ascontiguousarray(x)).to(device)
    places = placements(hp, wp, tile, radius)
    out = None
    for s in range(0, len(places), batch):
        part = places[s:s + batch]
        windows = torch.stack([xt[y:y + tile, x0:x0 + tile] for *_, y, x0 in part])[..., None]
        with torch.no_grad():
            lg = forward(windows)
        if out is None:
            out = torch.empty((hp, wp, lg.shape[-1]), dtype=torch.float32, device=device)
        for k, (i, j, ye, xe, y, x0) in enumerate(part):
            out[i:ye, j:xe] = lg[k, i - y:ye - y, j - x0:xe - x0]
    return out[:h, :w]


def judge(mask: np.ndarray, ref_logits: torch.Tensor, threshold: float = 0.0
          ) -> Dict[str, float]:
    """How a served mask departs from the reference's logits. ``gap`` is
    how far a pixel's served class scores below the reference's best:
    ``mismatched`` pixels have a gap above 0 and ``beyond`` a gap above
    ``threshold``, of ``pixels``; ``gap_max`` is the widest gap and
    ``margin_mean`` the mean gap between the reference's best two classes.
    ``flip_margin`` is the reference margin below which lie twice as many
    pixels as were mismatched: noise that flips a pixel's class with even
    odds below some margin and never above it mismatches half the pixels
    below it, so ``flip_margin`` reads a served path's noise in logits,
    whatever the density of small margins. A mask of the wrong shape or
    with labels out of range counts every pixel as beyond."""
    pixels = float(ref_logits.shape[0] * ref_logits.shape[1])
    m = torch.from_numpy(np.ascontiguousarray(mask)).to(ref_logits.device).long()
    if (tuple(m.shape) != tuple(ref_logits.shape[:2]) or int(m.min()) < 0
            or int(m.max()) >= ref_logits.shape[-1]):
        return {"pixels": pixels, "mismatched": pixels, "beyond": pixels,
                "gap_max": 0.0, "margin_mean": 1.0, "flip_margin": 0.0}
    best = ref_logits.max(dim=-1).values
    gap = best - ref_logits.gather(-1, m[..., None])[..., 0]
    top2 = ref_logits.topk(2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1]).flatten()
    mismatched = int((gap > 0).sum())
    k = min(margin.numel(), 2 * mismatched)
    return {"pixels": pixels, "mismatched": float(mismatched),
            "beyond": float((gap > threshold).sum()), "gap_max": float(gap.max()),
            "margin_mean": float(margin.double().mean()),
            "flip_margin": float(margin.kthvalue(k).values) if k else 0.0}
