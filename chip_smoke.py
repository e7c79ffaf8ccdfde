#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path once on one NVIDIA card.

    python3 chip_smoke.py [--seed N] [--out results.json]

Run from the root of a checkout, on a machine with a card, the CUDA toolkit
(``nvcc``) and PyTorch built for CUDA. Imports nothing of JAX or of the JAX
package. Phases, each fatal on failure:

1. setup: print the card (``nvidia-smi``) and build every CUDA kernel of
   the path from ``tpuseg_torch/csrc`` (one ``nvcc`` per source, in
   parallel);
2. kernels: call each kernel's wrapper on card tensors at the shape the
   serving path gives it, hold the result against its plain PyTorch
   version, and time both with CUDA events beside the card's bound;
3. reference: on a small input, the full-width int8_blocked engine on the
   card against the same engine on the CPU (whose arithmetic the CPU tests
   pin to the JAX package), and the folded f32 walk on the card against
   the f32 model on the CPU;
4. main path: serve a folder (one 4096^2 and four 256^2 uint16 images) with
   a full-width random U-Net (base 64, 1 channel, 2 classes) through
   ``python -m tpuseg_torch.cli.inference --quantize int8_blocked`` with the
   launch counters zeroed just before and read just after, check every
   mask, serve it again with ``--quantize int8`` and compare the masks,
   then time the tiled engines on the 4096^2 image and profile one
   int8_blocked pass (device time by kernel, busy share).

The last lines are ``{"kernels": [...]}``, the card's name and power limit,
and ``{"ok": true, "device": {...}}``. Without a card it exits 1 and prints
no result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12}  # H100 SXM dense tensor-core rates
MAIN_SHAPE = (8, 512, 512, 256)  # dec1b edge of 8 tiles of 1024^2 at base 64
NCLS = 2
TILE, BATCH = 1024, 8
BIG, SMALL, N_SMALL = 4096, 256, 4
BASE = 64  # the reference width (model.py:20)


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return res.stdout.strip()


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def head_inputs(fp: bool, seed: int, dev):
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    b, h, w, c4 = MAIN_SHAPE
    x = torch.randint(-127, 128, MAIN_SHAPE, generator=g, device=dev, dtype=torch.int8)
    sv = torch.rand(c4, generator=g, device=dev) * 0.09 + 0.01
    epi = torch.randn(4, 4 * NCLS, generator=g, device=dev)
    if fp:
        wt = (torch.randn(4 * NCLS, c4, generator=g, device=dev) * 0.3).to(torch.bfloat16)
        epi[3] = 1.0
    else:
        wt = torch.randint(-127, 128, (4 * NCLS, c4), generator=g, device=dev,
                           dtype=torch.int8)
        epi[3] = torch.rand(4 * NCLS, generator=g, device=dev) * 9e-4 + 1e-4
    return x, sv, wt, epi


def phase_kernels(seed: int, dev) -> dict:
    """K2 at the serving shape: the kernel against its plain version in
    both variants (the fp head is the served default), timed in turns
    (plain, kernel, kernel, plain)."""
    import torch

    from tpuseg_torch.infer import head_kernel as hk

    out = {}
    for fp in (True, False):
        x, sv, wt, epi = head_inputs(fp, seed, dev)
        got = hk.blocked_head_argmax(x, sv, wt, epi, NCLS, fp=fp)
        want = hk._blocked_head_argmax_plain(x, sv, wt, epi, NCLS, fp)
        torch.cuda.synchronize()
        if got.shape != (MAIN_SHAPE[0], 2 * MAIN_SHAPE[1], 2 * MAIN_SHAPE[2]) \
                or got.dtype != torch.int32:
            raise AssertionError(f"head kernel returned {tuple(got.shape)} {got.dtype}")
        agree = (got == want).double().mean().item()
        max_err = (got - want).abs().max().item()
        if fp and agree < 0.9999:
            raise AssertionError(f"fp head kernel agrees with plain on {agree} < 0.9999")
        if not fp and not torch.equal(got, want):
            raise AssertionError(f"int8 head kernel differs from plain (agreement {agree})")
        del got, want
        p1 = cuda_ms(lambda: hk._blocked_head_argmax_plain(x, sv, wt, epi, NCLS, fp), 3, 1)
        k1 = cuda_ms(lambda: hk.blocked_head_argmax(x, sv, wt, epi, NCLS, fp=fp), 20)
        k2 = cuda_ms(lambda: hk.blocked_head_argmax(x, sv, wt, epi, NCLS, fp=fp), 20)
        p2 = cuda_ms(lambda: hk._blocked_head_argmax_plain(x, sv, wt, epi, NCLS, fp), 3, 1)
        b, h, w, c4 = MAIN_SHAPE
        nbytes = (x.numel() * x.element_size() + sv.numel() * 4
                  + wt.numel() * wt.element_size() + epi.numel() * 4 + b * 4 * h * w * 4)
        ops = 2 * b * h * w * c4 * 4 * NCLS
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_OPS["bf16" if fp else "int8"] * 1e3
        out["fp" if fp else "int8"] = {
            "agree": agree, "max_abs_err": max_err, "ms": (k1 + k2) / 2,
            "ms_runs": [k1, k2], "plain_ms": (p1 + p2) / 2, "plain_ms_runs": [p1, p2],
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops}
        log(f"head kernel fp={fp}: agree {agree}, {out['fp' if fp else 'int8']['ms']:.4f} ms "
            f"(plain {(p1 + p2) / 2:.3f} ms, bound {max(t_bytes, t_ops):.4f} ms)")
        del x, sv, wt, epi
        torch.cuda.empty_cache()
    return out


def make_model(seed: int):
    """Full-width U-Net (base 64, 1 channel, 2 classes) with Keras-init
    random weights and jittered BN running statistics, from ``seed``."""
    import torch

    from tpuseg_torch.models.unet import UNet, init_unet

    g = torch.Generator().manual_seed(seed)
    model = init_unet(UNet(NCLS, 1, BASE, dtype=torch.float32), g)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(torch.randn(m.num_features, generator=g) * 0.3)
                m.running_var.copy_(torch.rand(m.num_features, generator=g) * 1.5 + 0.5)
    return model.eval()


def write_images(folder: str, seed: int) -> dict:
    """One BIG^2 and N_SMALL SMALL^2 uint16 images: smooth structure plus
    noise, as microscopy-like intensities."""
    import numpy as np

    from tpuseg_torch.utils.imagio import imwrite

    rng = np.random.default_rng(seed)
    os.makedirs(folder, exist_ok=True)
    shapes = {}

    def img(n):
        yy, xx = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
        f = rng.uniform(0.005, 0.03, 4)
        field = (np.sin(yy * f[0] + xx * f[1]) + np.cos(yy * f[2] - xx * f[3])) * 700 + 2000
        return np.clip(field + rng.normal(0, 150, (n, n)), 0, 65535).astype(np.uint16)

    shapes["big.tif"] = (BIG, BIG)
    imwrite(os.path.join(folder, "big.tif"), img(BIG))
    for i in range(N_SMALL):
        shapes[f"small{i}.tif"] = (SMALL, SMALL)
        imwrite(os.path.join(folder, f"small{i}.tif"), img(SMALL))
    return shapes


def phase_reference(model, seed: int, dev) -> dict:
    """Small-input reference: the full-width engines on the card against
    the CPU (plain head, CPU convs)."""
    import numpy as np
    import torch

    from tpuseg_torch.infer import quant

    x = torch.from_numpy(np.random.default_rng(seed + 1).normal(0, 1, (2, 64, 64, 1))
                         .astype(np.float32))
    folded = quant.fold_variables(model)
    ranges = quant.calibrate(folded, [x[0, ..., 0].numpy()], device="cpu")
    with torch.no_grad():
        want_logits = model(x)
    got_logits = quant.make_folded_logits_fn(folded)(x.to(dev)).cpu()
    if not torch.isfinite(got_logits).all():
        raise AssertionError("folded f32 walk on the card gave non-finite logits")
    scale = want_logits.abs().max().item()
    logit_err = (got_logits - want_logits).abs().max().item() / scale
    if logit_err > 1e-3:
        raise AssertionError(f"folded f32 walk on the card vs the CPU model: rel err {logit_err}")
    fn = quant.make_quantized_predict_fn(folded, ranges, blocked_edges=True)
    got = fn(x.to(dev)).cpu()
    want = fn(x)
    agree = (got == want).double().mean().item()
    if got.shape != (2, 64, 64) or agree < 0.999:
        raise AssertionError(f"int8_blocked on the card vs the CPU: shape {tuple(got.shape)}, "
                             f"agreement {agree}")
    log(f"reference: folded f32 rel err {logit_err:.2e}, int8_blocked card/CPU agreement {agree}")
    return {"folded_f32_rel_err": logit_err, "int8_blocked_card_vs_cpu_agree": agree}


def phase_profile(fn, big, radius: int, stats, dev) -> dict:
    """Where the time goes: one tiled pass over the BIG^2 image under
    ``torch.profiler``; device time by kernel and the kernels' share of the
    pass's wall time (one stream, so kernel times add; the wall time
    includes the profiler's own cost)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpuseg_torch.infer.tiled import inference_tiled

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        inference_tiled(big, fn, TILE, radius, BATCH, NCLS, stats, dev)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = sorted(((e.key, e.device_time_total / 1e3, e.count)
                      for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                     key=lambda r: -r[1])
    busy_ms = sum(ms for _, ms, _ in kernels)
    if busy_ms == 0:
        log("profile: the profiler saw no device time (busy share not measured)")
        return {"wall_ms": wall_ms, "busy_ms": None, "top": []}
    log(f"profile: {wall_ms:.1f} ms wall, kernels {busy_ms:.1f} ms "
        f"({busy_ms / wall_ms:.1%} busy), {sum(n for _, _, n in kernels)} launches")
    top = [{"kernel": k[:120], "ms": ms, "share": ms / busy_ms, "count": n}
           for k, ms, n in kernels[:12]]
    for r in top:
        log(f"  {r['ms']:9.2f} ms {r['share']:6.1%} x{r['count']:<5d} {r['kernel']}")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "top": top}


def phase_main(seed: int, work: str, dev, card: str) -> dict:
    import numpy as np
    import torch

    from tpuseg_torch.cli.inference import main as cli
    from tpuseg_torch.data.preprocess import zscore_stats
    from tpuseg_torch.infer import head_kernel
    from tpuseg_torch.infer.erf import estimate_radius
    from tpuseg_torch.infer.runner import InferenceConfig, _quantized_predict_fn
    from tpuseg_torch.infer.tiled import (inference_single_batch, inference_tiled,
                                          make_predict_fn)
    from tpuseg_torch.utils.checkpoint import load_model, save_model
    from tpuseg_torch.utils.imagio import imread

    res: dict = {}
    imgdir = os.path.join(work, "images")
    shapes = write_images(imgdir, seed)
    ckpt = os.path.join(work, "model.pt")
    model = make_model(seed)
    save_model(ckpt, model)
    res["reference"] = phase_reference(model, seed, dev)
    cal = os.path.join(work, "cal.json")
    common = ["--checkpoint_filepath", ckpt, "--image_folder", imgdir,
              "--number_classes", str(NCLS), "--number_channels", "1",
              "--base_features", str(BASE), "--device", dev.type, "--tile_size", str(TILE),
              "--batch_size", str(BATCH), "--seed", str(seed)]

    # the main path: launch counts zeroed just before, read just after
    out_blocked = os.path.join(work, "masks_int8_blocked")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    head_kernel.LAUNCHES = 0
    t0 = time.perf_counter()
    written = cli(common + ["--output_folder", out_blocked, "--quantize", "int8_blocked",
                           "--calibration_out", cal])
    torch.cuda.synchronize()
    res["main_path_s"] = time.perf_counter() - t0
    res["launches"] = {"blocked_head_argmax": head_kernel.LAUNCHES}
    res["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    if head_kernel.LAUNCHES == 0:
        raise AssertionError("the int8_blocked main path launched no head kernel")
    if sorted(os.path.basename(p) for p in written) != sorted(shapes):
        raise AssertionError(f"masks written: {written}")
    for name, shape in shapes.items():
        m = imread(os.path.join(out_blocked, name))
        if m.shape != shape or not np.isin(m, np.arange(NCLS)).all():
            raise AssertionError(f"{name}: mask {m.shape} {m.dtype}, labels {np.unique(m)[:8]}")
    log(f"main path: {len(written)} masks in {res['main_path_s']:.2f} s, "
        f"{head_kernel.LAUNCHES} head kernel launches, peak {res['peak_mem_gib']:.2f} GiB")

    # dense int8 from the same scales: the same quantized network
    out_dense = os.path.join(work, "masks_int8")
    cli(common + ["--output_folder", out_dense, "--quantize", "int8", "--calibration_in", cal])
    agree = {}
    for name in shapes:
        a = imread(os.path.join(out_blocked, name))
        b = imread(os.path.join(out_dense, name))
        agree[name] = float((a == b).mean())
    total = sum(agree[n] * np.prod(s) for n, s in shapes.items()) / sum(
        np.prod(s) for s in shapes.values())
    res["int8_blocked_vs_int8_agree"] = float(total)
    res["int8_blocked_vs_int8_agree_per_image"] = agree
    if total < 0.999:
        raise AssertionError(f"int8_blocked vs int8 masks agree on {total} < 0.999: {agree}")
    log(f"int8_blocked vs int8 mask agreement {total}")

    # tiled engines on the big image, timed in turns; every dispatch of the
    # blocked engine must launch the kernel
    bf16 = load_model(ckpt, dtype="bfloat16", device=dev)
    radius = estimate_radius(bf16, 1, rng=np.random.default_rng(seed))
    big = imread(os.path.join(imgdir, "big.tif"))
    small = [imread(os.path.join(imgdir, f"small{i}.tif")) for i in range(N_SMALL)]
    fns = {"none": make_predict_fn(bf16)}
    for mode in ("int8_blocked", "int8"):
        cfg = InferenceConfig(ckpt, imgdir, work, NCLS, 1, base_features=BASE,
                              quantize=mode, calibration_in=cal)
        fns[mode] = _quantized_predict_fn(cfg, bf16, [], dev)[0]
    stats = zscore_stats(big)
    head_kernel.LAUNCHES = 0
    inference_single_batch(small, fns["int8_blocked"], BATCH, device=dev)
    res["launches_small_dispatch"] = head_kernel.LAUNCHES
    head_kernel.LAUNCHES = 0
    inference_tiled(big, fns["int8_blocked"], TILE, radius, BATCH, NCLS, stats, dev)
    res["launches_tiled_dispatch"] = head_kernel.LAUNCHES
    if not (res["launches_small_dispatch"] and res["launches_tiled_dispatch"]):
        raise AssertionError(f"a dispatch launched no head kernel: {res}")
    times = {m: [] for m in fns}
    for rnd in range(3):
        for mode in (fns if rnd % 2 == 0 else list(fns)[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            inference_tiled(big, fns[mode], TILE, radius, BATCH, NCLS, stats, dev)
            times[mode].append(time.perf_counter() - t0)
    res["radius"] = radius
    res["tiled_s"] = times
    res["tiled_mp_s"] = {m: BIG * BIG / 1e6 / sorted(t)[1] for m, t in times.items()}
    log(f"tiled {BIG}^2 (tile {TILE}, radius {radius}, batch {BATCH}) MP/s on {card}, "
        "median of 3: " + ", ".join(f"{m} {v:.2f}" for m, v in res["tiled_mp_s"].items()))
    res["profile_int8_blocked"] = phase_profile(fns["int8_blocked"], big, radius, stats, dev)
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="also write all results as JSON here")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs an "
              "NVIDIA card", file=sys.stderr)
        return 1
    try:
        import tpuseg_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})", file=sys.stderr)
        return 1
    from tpuseg_torch.kernels import build

    # f32 matmuls in full precision (PyTorch's default, stated); the port
    # turns cuDNN's TF32 off around its own f32 convs
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    build.build()
    build_s = time.perf_counter() - t0
    log(f"built {sorted(build.SOURCES)} in {build_s:.1f} s")
    for name, text in build.BUILD_LOGS.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    kern = phase_kernels(args.seed, dev)
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke")
    main_res = phase_main(args.seed, work, dev, card)

    fp, s8 = kern["fp"], kern["int8"]
    kernels = [{
        "name": "blocked_head_argmax", "route": "cuda",
        "source": "tpuseg_torch/csrc/head_argmax.cu",
        "replaces": "tpuseg/infer/head_kernel.py:83",
        "launches": main_res["launches"]["blocked_head_argmax"],
        "max_abs_err": fp["max_abs_err"], "ms": fp["ms"], "plain_ms": fp["plain_ms"],
        "bound_ms": fp["bound_ms"], "bound_by": fp["bound_by"], "library_ms": None,
        "library_note": "no single PyTorch call computes head + per-phase argmax + "
                        "depth-to-space",
        "shape": list(MAIN_SHAPE), "ncls": NCLS,
        "tolerance": "fp head: labels agree on >= 0.9999 (f32 sum order); "
                     "int8 head: labels bit-equal",
        "agree": fp["agree"], "int8_variant": s8,
    }]
    summary = {"card": card, "torch": torch.__version__, "build_s": build_s,
               "kernels": kern, "main": main_res,
               "total_s": time.perf_counter() - t_start}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    log(f"total {summary['total_s']:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
