"""The numbers that decide ``correct`` for a served mask.

A mask is judged against the float32 reference's logits of its slide
(``tiled.logits``). Every lower precision flips the class of pixels whose
two best logits lie close; how close depends on the model and the seed as
much as on the precision. So the reference is also computed in the
precision the configuration states (the *yardstick*: bf16 convs and
roundings, or 8-bit weights and activations on the reference's own
calibration), and its flip margin ``y`` (``tiled.judge``) says how close
that precision flips. The number compared is ``flips_beyond_ppm``: the
pixels, per million, whose served class scores below the reference's best
by more than ``factor * y``. A path that computes in the stated precision
flips almost nothing that far out; one in the next precision below, an
altered answer or a dropped tile flips many. Beside it are kept, uncompared,
the share of mismatched pixels and the widest gap over the mean margin.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from reference import tiled
from reference import unet

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}


def centre_crops(pool, side: int, count: int) -> List[np.ndarray]:
    """Central crops of at most ``side`` of ``count`` evenly spaced slides,
    z-scored with each whole slide's statistics (``tiled.zscore``)."""
    out = []
    for i in range(count):
        z = tiled.zscore(pool[(i * len(pool)) // count])
        h, w = min(z.shape[0], side), min(z.shape[1], side)
        y0, x0 = (z.shape[0] - h) // 2, (z.shape[1] - w) // 2
        out.append(np.ascontiguousarray(z[y0:y0 + h, x0:x0 + w, None]))
    return out


def forward_kwargs(spec: dict, weights, levels: int, pool, device) -> dict:
    """The reference's keyword arguments for a precision ``spec``:
    ``{"dtype": "bfloat16"}``, or ``{"quant_bits": n, "calibration":
    {"images", "max_dim", "percentile"}}`` with ranges calibrated here."""
    if "dtype" in spec:
        return {"dtype": DTYPES[spec["dtype"]]}
    cal = spec["calibration"]
    crops = [torch.from_numpy(c).to(device)
             for c in centre_crops(pool, cal["max_dim"], min(cal["images"], len(pool)))]
    return {"quant_bits": spec["quant_bits"],
            "ranges": unet.calibrate(weights, crops, levels, cal["percentile"])}


def judge_slide(img: np.ndarray, masks, weights, levels: int, tile: int, radius: int,
                batch: int, yardstick: dict, factor: float, device,
                controls: Dict[str, dict] = None) -> Dict[str, List[dict]]:
    """Judge ``masks`` (``{name: [mask, ...]}``) of one slide, and the
    masks of the reference computed as each of ``controls`` (``{name:
    forward kwargs}``), by ``flips_beyond_ppm`` against the float32
    reference with this slide's yardstick."""
    def run(**kw):
        return tiled.logits(img, lambda x: unet.forward(weights, x, levels, **kw), tile,
                            radius, batch, device)

    with unet.no_tf32():
        lg = run()
        y = tiled.judge(run(**yardstick).argmax(dim=-1).to(torch.uint8).cpu().numpy(),
                        lg)["flip_margin"]
        masks = dict(masks)
        for name, kw in (controls or {}).items():
            masks[name] = [run(**kw).argmax(dim=-1).to(torch.uint8).cpu().numpy()]
        out = {}
        for name, ms in masks.items():
            out[name] = []
            for mask in ms:
                j = tiled.judge(mask, lg, factor * y)
                j["yardstick_flip_margin"] = y
                out[name].append(j)
    del lg
    return out


def numbers(judgements: List[dict]) -> Dict[str, float]:
    """``flips_beyond_ppm``, the largest over the masks, and beside it the
    share of mismatched pixels over all of them (%) and the widest gap
    over its slide's mean margin."""
    def over_margin(j):
        return j["gap_max"] / j["margin_mean"] if j["margin_mean"] > 0 else math.inf

    pixels = sum(j["pixels"] for j in judgements)
    return {"flips_beyond_ppm": max(1e6 * j["beyond"] / j["pixels"] for j in judgements),
            "mismatch_pct": 100.0 * sum(j["mismatched"] for j in judgements) / pixels,
            "gap_x_margin": max(over_margin(j) for j in judgements)}
