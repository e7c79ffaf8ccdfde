"""Closed-loop serving of large slides through the program's tiled inference.

One client serves a pool of slides in a seeded order, as the inference
CLI serves a folder: each image goes to
``tpuseg_torch.infer.tiled.inference_tiled`` with its z-score statistics
(``tpuseg_torch.data.preprocess.zscore_stats``, as the CLI's read-ahead
computes them), and the next starts as soon as its mask is back on the
host. The configuration's ``serve`` section picks the predict function as
the CLI builds it for ``--quantize`` (``none``: the model in its dtype;
``int8`` or ``int8_blocked``: folded, calibrated on central crops of an
evenly spaced sample of the pool, and quantized).

Set-up makes the weights (``harness/weights.py``) and the pool
(``traffic/<generator>.py``) from the seed, sets the BatchNorms' running
statistics jittered from the seed; it gives the head a bias that keeps
its ReLU open and a class-1 shift that gives each class about half of
the pixels of the slides' centres (both by the plain reference,
``shape_head``), builds the predict function and serves ``warm_passes``
images. The window serves
images for ``seconds``. With tracing, ``trace_items`` images halfway
through the window are profiled.

Once the window has closed and the program's state is freed, a sample of
the served masks drawn from the seed is judged against the plain
reference's logits (``reference/check.py``): the pixels per million whose
served class scores below the reference's best by more than the cell's
factor times the margin at which the reference, computed in the
configuration's precision, flips classes.
"""

from __future__ import annotations

import gc
import statistics
import time
from typing import Dict, List

import numpy as np
import torch

from harness import checks as checks_lib
from harness import weights as weights_lib
from harness.common import child_seeds, make_pool, sync
from reference import check as ref_check
from reference import tiled as ref_tiled
from reference import unet as ref_unet


def centre(img: np.ndarray, side: int) -> np.ndarray:
    h, w = min(img.shape[0], side), min(img.shape[1], side)
    y0, x0 = (img.shape[0] - h) // 2, (img.shape[1] - w) // 2
    return img[y0:y0 + h, x0:x0 + w]


def shape_head(cfg: dict, weights: Dict[str, torch.Tensor], pool, side: int,
               device) -> Dict[str, float]:
    """Give the random head what a trained one has, by the plain reference
    over the centres of the pool's slides. First the head conv's bias
    lifts each class's input to its ReLU above 0 (by minus its least value
    plus one standard deviation there): a random head's ReLU otherwise
    zeroes both classes on a share of the pixels, which then all get the
    same two logits, one exact tie. The head's BatchNorm then holds the
    mean and variance of its input there, so that the logits are centred
    and of unit scale (jittered statistics leave them far from 0, where
    bf16 logits are coarse). Last, the class-1 shift moves by the median
    class-0 minus class-1 logit, so that each class takes about half of
    the pixels."""
    import torch.nn.functional as F

    batch = torch.from_numpy(np.stack(ref_check.centre_crops(pool, side, len(pool)))).to(device)
    feats = {}
    with torch.no_grad(), ref_unet.no_tf32():
        ref_unet.forward(weights, batch, cfg["levels"],
                         tap=lambda name, y: feats.update({name: y} if name == "dec1b" else {}))
        pre = F.conv2d(feats.pop("dec1b"), weights["head.conv.weight"],
                       weights["head.conv.bias"])
        lift = -pre.amin(dim=(0, 2, 3)) + pre.std(dim=(0, 2, 3))
        weights["head.conv.bias"] += lift
        var, mean = torch.var_mean(torch.relu(pre + lift[None, :, None, None]),
                                   dim=(0, 2, 3), correction=0)
        weights["head.bn.running_mean"].copy_(mean)
        weights["head.bn.running_var"].copy_(var)
        del pre
        lg = ref_unet.forward(weights, batch, cfg["levels"])
    m = (lg[..., 0] - lg[..., 1]).flatten()
    shift = float(m.kthvalue(max(1, m.numel() // 2)).values)
    weights["head.bn.bias"][1] += shift
    return {"head_lift": [float(v) for v in lift], "head_shift": shift}


def calibration_crops(pool, stats, cal: dict) -> List[np.ndarray]:
    """The runner's calibration inputs: central crops of at most
    ``max_dim`` of ``images`` evenly spaced slides, z-scored with each
    whole slide's statistics."""
    k = max(1, min(cal["images"], len(pool)))
    out = []
    for i in range(k):
        j = (i * len(pool)) // k
        mean, std = stats[j]
        crop = centre(pool[j], cal["max_dim"]).astype(np.float32)[..., None]
        out.append((crop - mean) / np.where(std <= 1.0, 1.0, std))
    return out


def build_predict(cfg: dict, weights: Dict[str, torch.Tensor], pool, stats, device):
    """The program's predict function for the configuration's serving path."""
    from tpuseg_torch.infer import quant
    from tpuseg_torch.infer.tiled import make_predict_fn
    from tpuseg_torch.models.unet import UNet

    serve = cfg["serve"]
    if device.type == "cuda":
        from tpuseg_torch.kernels import build

        build.build(serve["kernels"])
    mode = serve["quantize"]
    dtype = serve["dtype"] if mode == "none" else "float32"
    with torch.device(device):
        model = UNet(cfg["num_classes"], cfg["num_channels"], cfg["base_features"], dtype=dtype)
    missing, unexpected = model.load_state_dict(weights, strict=False)
    if unexpected or any(not k.endswith("num_batches_tracked") for k in missing):
        raise RuntimeError(f"weights do not fit the model: missing {missing}, "
                           f"unexpected {unexpected}")
    model.eval()
    if mode == "none":
        return make_predict_fn(model)
    cal = serve["calibration"]
    folded = quant.fold_variables(model)
    ranges = quant.calibrate(folded, calibration_crops(pool, stats, cal),
                             deconv_impl=model.deconv_impl, percentile=cal["percentile"],
                             device=device)
    del model
    return quant.make_quantized_predict_fn(folded, ranges, deconv_impl="conv_transpose",
                                           blocked_edges=mode == "int8_blocked")


def setup(cell, seed: int, device) -> dict:
    """Everything a window needs, made from ``seed``; ``phases`` holds the
    seconds each step took, synchronised."""
    from tpuseg_torch.data.preprocess import zscore_stats

    cfg, traffic = cell.config, cell.traffic
    s_weights, s_pool, s_order, s_sample = child_seeds(seed, 4)
    phases, t = {}, time.perf_counter()

    def done(name):
        nonlocal t
        sync(device)
        phases[name] = time.perf_counter() - t
        t = time.perf_counter()

    weights = weights_lib.make(cfg, s_weights, device)
    done("weights")
    pool = make_pool(traffic, s_pool, device)
    done("pool")
    stats = [zscore_stats(img) for img in pool]
    done("zscore_stats")
    head = shape_head(cfg, weights, pool, traffic["balance_side"], device)
    done("head")
    predict = build_predict(cfg, weights, pool, stats, device)
    done("predict_fn")
    return {"weights": weights, "pool": pool, "stats": stats, "predict": predict,
            "head": head, "order_seed": s_order, "sample_seed": s_sample, "phases": phases}


def serve_one(state: dict, traffic: dict, idx: int, device) -> np.ndarray:
    from tpuseg_torch.infer.tiled import inference_tiled

    return inference_tiled(state["pool"][idx], state["predict"], traffic["tile"],
                           traffic["radius"], traffic["batch"], state["num_classes"],
                           state["stats"][idx], device)


class Order:
    """Pool indices in the seeded order: a fresh permutation of the pool
    for every round."""

    def __init__(self, n: int, seed: int):
        self.rng, self.n, self.buf = np.random.default_rng(seed), n, []

    def next(self) -> int:
        if not self.buf:
            self.buf = list(self.rng.permutation(self.n))
        return int(self.buf.pop(0))


def judge(cell, state: dict, kept, device) -> List[dict]:
    """Judge the kept ``(request, slide, mask)`` (``reference/check.py``)
    with the cell's yardstick and factor."""
    cfg, traffic, spec = cell.config, cell.traffic, checks_lib.spec(cell.name)
    yardstick = ref_check.forward_kwargs(spec["yardstick"], state["weights"], cfg["levels"],
                                         state["pool"], device)
    by_slide: Dict[int, list] = {}
    for _, idx, mask in sorted(kept, key=lambda r: r[0]):
        by_slide.setdefault(idx, []).append(mask)
    out: List[dict] = []
    for idx, masks in sorted(by_slide.items()):
        out += ref_check.judge_slide(state["pool"][idx], {"served": masks}, state["weights"],
                                     cfg["levels"], traffic["tile"], traffic["radius"],
                                     traffic["reference_batch"], yardstick, spec["factor"],
                                     device)["served"]
    return out


def run(cell, seed: int, seconds: float, trace: bool, device, process_start: float,
        tmpdir: str) -> dict:
    from harness import trace as trace_lib

    traffic = cell.traffic
    started = time.perf_counter() - process_start
    state = setup(cell, seed, device)
    state["phases"]["process_start"] = started
    state["num_classes"] = cell.config["num_classes"]
    pool = state["pool"]
    order = Order(len(pool), state["order_seed"])
    t0 = time.perf_counter()
    for i in range(traffic["warm_passes"]):
        serve_one(state, traffic, i % len(pool), device)
    state["phases"]["warm"] = time.perf_counter() - t0
    # a uniform sample of the window's answers, drawn from the seed as they
    # come (reservoir sampling): at most check_sample masks are kept
    rng = np.random.default_rng(state["sample_seed"])
    k = traffic["check_sample"]
    pixels = pool[0].shape[0] * pool[0].shape[1]
    if device.type == "cuda":
        setup_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    latencies, kept, failed = [], {}, 0
    summary, stretch = None, (0, 0.0)
    sync(device)
    t_start = time.perf_counter()
    setup_s = t_start - process_start
    deadline = t_start + seconds
    n = 0

    def request():
        nonlocal n, failed
        idx = order.next()
        t0 = time.perf_counter()
        mask = serve_one(state, traffic, idx, device)
        latencies.append(time.perf_counter() - t0)
        if mask.shape != pool[idx].shape:
            failed += 1
        slot = n if n < k else int(rng.integers(0, n + 1))
        if slot < k:
            kept[slot] = (n, idx, mask)
        n += 1

    while time.perf_counter() < deadline:
        if trace and summary is None and time.perf_counter() >= t_start + seconds / 2:
            n0, t0 = n, time.perf_counter()
            summary = trace_lib.profile_stretch(request, traffic["trace_items"], tmpdir)
            stretch = (n - n0, time.perf_counter() - t0)
            continue
        request()
    t_end = time.perf_counter()
    window = t_end - t_start
    peak = 0
    if device.type == "cuda":
        peak = torch.cuda.max_memory_allocated(device)
    state["predict"] = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = ref_check.numbers(judge(cell, state, list(kept.values()), device))
    lat_ms = sorted(1e3 * x for x in latencies)
    e2e = {"serve_mp_s": n * pixels / 1e6 / window,
           "serve_p95_ms": statistics.quantiles(lat_ms, n=20, method="inclusive")[18]
           if len(lat_ms) > 1 else lat_ms[0],
           "setup_s": setup_s}
    tiles = len(ref_tiled.placements(pool[0].shape[0], pool[0].shape[1], traffic["tile"],
                                     traffic["radius"]))
    ctx = {"kind": "serve", "config": cell.config, "traffic": traffic, "trace": summary,
           "window": {"items": n, "seconds": window, "items_outside": n - stretch[0],
                      "seconds_outside": window - stretch[1]},
           "tiles_per_image": tiles,
           "calls_per_image": [min(traffic["batch"], tiles - s)
                               for s in range(0, tiles, traffic["batch"])],
           "peak_window_bytes": peak}
    checks = checks_lib.compare(cell.name, numbers)
    return {"end_to_end": e2e, "ctx": ctx, "trace": summary, "checks": checks,
            "attempted": n, "failed": failed,
            "memory_peak_bytes": max(peak, setup_peak) if device.type == "cuda" else 0,
            "notes": {"head": state["head"], "setup_phases": state["phases"],
                      "judged": sorted(n for n, _, _ in kept.values()),
                      "uncompared": {k: v for k, v in numbers.items() if k not in checks}}}
