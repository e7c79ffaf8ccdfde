#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths once on one
NVIDIA card.

    python3 chip_smoke.py [--seed N] [--out results.json]

Run from the root of a checkout, on a machine with a card, the CUDA toolkit
(``nvcc``) and PyTorch built for CUDA. Imports nothing of JAX or of the JAX
package. Phases, each fatal on failure:

1. setup: print the card (``nvidia-smi``) and build every CUDA kernel of
   the path from ``tpuseg_torch/csrc`` (one ``nvcc`` per source, in
   parallel);
2. kernels: call each kernel's wrapper on card tensors at the shape its
   main path gives it (K2, the blocked head+argmax: serving, both heads,
   which must take its mma route; K1, the row shear: training), hold the
   result against its plain PyTorch version, and time both in turns by
   profiler device time with the L2 flushed (K2 also with CUDA events),
   beside the card's bound and a PyTorch library call that computes the
   same function where one exists; K2's mma kernels' registers and spills
   come from the build log, and a spill fails;
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
   int8_blocked pass (device time by kernel, busy share);
5. training reference: one f32 train step at base 4 on 64^2 inputs on the
   card (cuDNN TF32 off) against the same step on the CPU, from the same
   weights and batch, dropout off;
6. training main path: write 64 train and 16 test records (512^2 uint16
   images, uint8 masks from a thresholded smooth random field) with the
   port's RecordWriter, train through ``tpuseg_torch.cli.train`` at base
   64, bf16, batch 8, 20 steps between test epochs, 2 epochs, device
   augmentation on, with the shear kernel's launch count zeroed just before
   and read just after (it must be 3 per train step); check the losses,
   test_loss.csv and the checkpoint, serve a test image with the trained
   checkpoint through ``tpuseg_torch.cli.inference --quantize none``; then
   time steady-state train steps (img/s, median of 3 windows), record peak
   memory, profile a few steps (device time by kernel and group, busy
   share, the augmentation's share), compare the trained batch's loss with
   running and with batch BatchNorm statistics, and time a step with
   BatchNorm skipped.

The last lines are ``{"kernels": [...]}``, the card's name and power limit,
and ``{"ok": true, "device": {...}}``. Without a card it exits 1 and prints
no result.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12}  # H100 SXM dense tensor-core rates
MAIN_SHAPE = (8, 512, 512, 256)  # dec1b edge of 8 tiles of 1024^2 at base 64
F32_OPS = 67e12  # H100 SXM float32 outside the tensor cores
# K1 at the training shape: batch 8 x (1 image + 1 mask channel) rows of
# 512^2, mirror-padded by int(0.3536 * 512) + 3 = 184 on each side
SHEAR_N, SHEAR_H, SHEAR_W = 16, 512, 512
SHEAR_WP = SHEAR_W + 2 * (int(0.3536 * SHEAR_W) + 3)
TRAIN_SIZE, TRAIN_BATCH, N_TRAIN, N_TEST = 512, 8, 64, 16
TEST_EVERY, EPOCHS, LOG_EVERY = 20, 2, 7
TRAIN_LR = 1e-3  # warmup epoch at 1e-4: a few dozen steps must move the loss
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


def device_ms_cold(fn, reps: int) -> float:
    """Mean device time of the kernels ``fn`` launches, from the profiler's
    device timestamps, with the L2 cache flushed before each call (a 128 MB
    ``bitwise_not_``, whose kernel is left out of the sum). Unlike events
    around the call, it does not count the host's time to launch: a call
    shorter than its own Python wrapper would otherwise time the wrapper."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    flush = torch.zeros(32 * 2 ** 20, dtype=torch.int32, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.bitwise_not_()
            fn()
        torch.cuda.synchronize()
    total = sum(e.device_time_total for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and "bitwise_not" not in e.key)
    if total == 0:
        raise RuntimeError("the profiler saw no device time for the timed call")
    return total / 1e3 / reps


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


def ptxas_report(text: str) -> dict:
    """Registers and spill bytes of each kernel in a ``-Xptxas -v`` log,
    keyed by the (mangled) entry name."""
    report: dict = {}
    fn = None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties for )([\w$]+)", line)
        if m:
            fn = m.group(1)
            report.setdefault(fn, {})
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            report[fn]["spill_stores"] = int(m.group(1))
            report[fn]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            report[fn]["registers"] = int(m.group(1))
    return report


def kernel_label(mangled: str) -> str:
    """A readable label for a mangled kernel name from a ptxas log:
    head_mma_kernel<fp, nt, breg> spelled out, others with the
    anonymous-namespace prefix cut."""
    m = re.search(r"head_mma_kernelILb(\d)ELi(\d)ELb(\d)E", mangled)
    if m:
        return f"head_mma_kernel<fp={m.group(1)},nt={m.group(2)},breg={m.group(3)}>"
    return re.sub(r"^_ZN.*?_cu_[0-9a-f]{8}\d+", "", mangled)[:60]


def head_build_report() -> dict:
    """K2's mma kernels: registers and spills from this process's build
    log (logged by ``main``). A spill in a kernel of the mma route is a
    defect and fails."""
    from tpuseg_torch.kernels import build

    text = build.BUILD_LOGS.get("head_argmax")
    if text is None:
        log("head_argmax was not built by this process: registers and spills not read")
        return {}
    report = {kernel_label(k): v for k, v in ptxas_report(text).items()
              if "head_mma_kernel" in k}
    if not report:
        raise AssertionError("no head_mma_kernel in the head_argmax build log")
    spills = {k: r for k, r in report.items()
              if r.get("spill_stores", 0) or r.get("spill_loads", 0)}
    if spills:
        raise AssertionError(f"mma-route kernels spill: {spills}")
    return report


def phase_kernels(seed: int, dev) -> dict:
    """K2 at the serving shape: the kernel against its plain version in
    both variants (the fp head is the served default), both on the mma
    route, timed in turns (plain, kernel, kernel, plain) two ways: CUDA
    events around back-to-back calls, and profiler device time with the L2
    flushed before each call."""
    import torch

    from tpuseg_torch.infer import head_kernel as hk

    out = {"build": head_build_report()}
    for fp in (True, False):
        x, sv, wt, epi = head_inputs(fp, seed, dev)
        route = hk.kernel_route(x.dtype, wt.dtype, fp)
        got = hk.blocked_head_argmax(x, sv, wt, epi, NCLS, fp=fp)
        want = hk._blocked_head_argmax_plain(x, sv, wt, epi, NCLS, fp)
        torch.cuda.synchronize()
        if route != "mma" or hk.LAST_ROUTE != route:
            raise AssertionError(f"head kernel fp={fp} took the {hk.LAST_ROUTE} route, not mma")
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
        fns = {"plain": (lambda: hk._blocked_head_argmax_plain(x, sv, wt, epi, NCLS, fp), 3),
               "kernel": (lambda: hk.blocked_head_argmax(x, sv, wt, epi, NCLS, fp=fp), 20)}
        events = {"plain": [], "kernel": []}
        device = {"plain": [], "kernel": []}
        for name in ("plain", "kernel", "kernel", "plain"):
            fn, reps = fns[name]
            events[name].append(cuda_ms(fn, reps, 1))
            device[name].append(device_ms_cold(fn, reps))
        b, h, w, c4 = MAIN_SHAPE
        nbytes = (x.numel() * x.element_size() + sv.numel() * 4
                  + wt.numel() * wt.element_size() + epi.numel() * 4 + b * 4 * h * w * 4)
        ops = 2 * b * h * w * c4 * 4 * NCLS
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_OPS["bf16" if fp else "int8"] * 1e3
        bound = max(t_bytes, t_ops)
        ms, ev_ms = sum(device["kernel"]) / 2, sum(events["kernel"]) / 2
        out["fp" if fp else "int8"] = r = {
            "route": route, "agree": agree, "max_abs_err": max_err,
            "ms": ms, "ms_runs": device["kernel"],
            "events_ms": ev_ms, "events_ms_runs": events["kernel"],
            "plain_ms": sum(device["plain"]) / 2, "plain_ms_runs": device["plain"],
            "plain_events_ms": sum(events["plain"]) / 2,
            "plain_events_ms_runs": events["plain"],
            "bound_ms": bound, "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "share_of_bound": bound / ms, "events_share_of_bound": bound / ev_ms,
            "bytes": nbytes, "ops": ops}
        log(f"head kernel fp={fp} ({route} route): agree {agree}; device time (L2 flushed) "
            f"{device['kernel'][0]:.4f} / {device['kernel'][1]:.4f} ms "
            f"({r['share_of_bound']:.1%} of bound), events {events['kernel'][0]:.4f} / "
            f"{events['kernel'][1]:.4f} ms ({r['events_share_of_bound']:.1%}); plain "
            f"{r['plain_ms']:.3f} ms device, {r['plain_events_ms']:.3f} ms events; "
            f"bound {bound:.4f} ms ({r['bound_by']})")
        del x, sv, wt, epi
        torch.cuda.empty_cache()
    return out


def phase_shear(seed: int, dev) -> dict:
    """K1 at the training shape: the kernel bit-equal to its plain version,
    and the kernel, the plain version and F.grid_sample (bilinear,
    align_corners=True, on [N, 1, H, Wp]: the same 1-D blend, the
    yardstick) timed in turns by their device time with the L2 flushed
    before each call. The kernel is shorter than its wrapper's host time,
    so CUDA events around back-to-back calls (also recorded) time the
    host, not the kernel."""
    import torch
    import torch.nn.functional as F

    from tpuseg_torch.ops import warp

    n, h, w, wp = SHEAR_N, SHEAR_H, SHEAR_W, SHEAR_WP
    g = torch.Generator(device=dev).manual_seed(seed)
    img = torch.rand((n, h, wp), generator=g, device=dev) * 4000
    shift = torch.randint(0, wp - w, (n, h), generator=g, device=dev, dtype=torch.int32)
    frac = torch.rand((n, h), generator=g, device=dev)
    got = warp._shear_rows(img, shift, frac, w)
    want = warp._shear_rows_plain(img, shift, frac, w)
    torch.cuda.synchronize()
    max_err = (got - want).abs().max().item()
    if got.shape != (n, h, w) or not torch.equal(got, want):
        raise AssertionError(f"shear kernel differs from plain: shape {tuple(got.shape)}, "
                             f"max abs err {max_err}")
    # grid_sample's sample points: x = s + c + f in padded columns, y = row
    px = shift[..., None].float() + torch.arange(w, device=dev) + frac[..., None]
    gx = 2 * px / (wp - 1) - 1
    gy = (2 * torch.arange(h, device=dev, dtype=torch.float32) / (h - 1) - 1)[None, :, None]
    grid = torch.stack([gx, gy.expand(n, h, w)], dim=-1)
    inp = img[:, None]

    def lib():
        return F.grid_sample(inp, grid, mode="bilinear", align_corners=True)

    lib_err = (lib()[:, 0] - want).abs().max().item()
    del got, want
    runs = {"plain": [], "kernel": [], "library": []}
    fns = {"plain": lambda: warp._shear_rows_plain(img, shift, frac, w),
           "kernel": lambda: warp._shear_rows(img, shift, frac, w), "library": lib}
    for order in (("plain", "kernel", "library"), ("library", "kernel", "plain")):
        for k in order:
            runs[k].append(device_ms_cold(fns[k], 20))
    events_ms = cuda_ms(fns["kernel"], 50)
    nbytes = n * h * ((w + 1) * 4 + w * 4 + 8)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 3 * n * h * w / F32_OPS * 1e3
    out = {"max_abs_err": max_err, "bit_equal": True,
           "ms": sum(runs["kernel"]) / 2, "ms_runs": runs["kernel"],
           "events_ms_back_to_back": events_ms,
           "plain_ms": sum(runs["plain"]) / 2, "plain_ms_runs": runs["plain"],
           "library_ms": sum(runs["library"]) / 2, "library_ms_runs": runs["library"],
           "library_max_abs_err": lib_err,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": nbytes, "shape": [n, h, wp, w]}
    log(f"shear kernel [{n},{h},{wp}]->{w}: bit-equal, {out['ms']:.4f} ms device time "
        f"(events around back-to-back calls: {events_ms:.4f}), "
        f"plain {out['plain_ms']:.4f} ms, grid_sample "
        f"{out['library_ms']:.4f} ms (max err {lib_err:.2e}), bound {out['bound_ms']:.4f} ms")
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


# kernel-name fragments -> group, first match wins (a name heuristic)
KERNEL_GROUPS = (
    ("K1 shear_rows", ("shear_rows",)),
    ("K2 head_argmax", ("head_mma_kernel", "head_fp_kernel", "head_s8_kernel")),
    ("layout transposes", ("nchwToNhwc", "nhwcToNchw")),
    ("cuDNN / GEMM", ("cudnn", "xmma", "gemm", "cutlass", "sm90_", "sm80_", "wgrad", "dgrad")),
    ("reductions", ("reduce_kernel",)),
    ("copies and casts", ("copy", "Cat", "Memcpy", "Memset")),
    ("elementwise", ("elementwise",)),
)


def kernel_group(name: str) -> str:
    for group, keys in KERNEL_GROUPS:
        if any(k in name for k in keys):
            return group
    return "other"


def device_profile(run, what: str) -> dict:
    """Where the time goes: ``run()`` under ``torch.profiler``; device time
    by kernel and by group of kernels (``KERNEL_GROUPS``), and the kernels'
    share of the wall time (one stream, so kernel times add; the wall time
    includes the profiler's own cost)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = sorted(((e.key, e.device_time_total / 1e3, e.count)
                      for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                     key=lambda r: -r[1])
    busy_ms = sum(ms for _, ms, _ in kernels)
    if busy_ms == 0:
        log(f"profile {what}: the profiler saw no device time (busy share not measured)")
        return {"wall_ms": wall_ms, "busy_ms": None, "top": [], "by_group": {},
                "by_kernel": {}}
    log(f"profile {what}: {wall_ms:.1f} ms wall, kernels {busy_ms:.1f} ms "
        f"({busy_ms / wall_ms:.1%} busy), {sum(n for _, _, n in kernels)} launches")
    groups: dict = {}
    for k, ms, _ in kernels:
        groups[kernel_group(k)] = groups.get(kernel_group(k), 0.0) + ms
    by_group = {g: {"ms": ms, "share": ms / busy_ms}
                for g, ms in sorted(groups.items(), key=lambda r: -r[1])}
    log("  by group: " + ", ".join(f"{g} {v['ms']:.2f} ms ({v['share']:.1%})"
                                   for g, v in by_group.items()))
    top = [{"kernel": k[:120], "ms": ms, "share": ms / busy_ms, "count": n}
           for k, ms, n in kernels[:12]]
    for r in top:
        log(f"  {r['ms']:9.2f} ms {r['share']:6.1%} x{r['count']:<5d} {r['kernel']}")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "top": top, "by_group": by_group,
            "by_kernel": {k: [ms, n] for k, ms, n in kernels}}


def phase_profile(fn, big, radius: int, stats, dev) -> dict:
    """One tiled int8_blocked pass over the BIG^2 image, profiled."""
    from tpuseg_torch.infer.tiled import inference_tiled

    return device_profile(
        lambda: inference_tiled(big, fn, TILE, radius, BATCH, NCLS, stats, dev),
        "tiled int8_blocked")


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


def phase_train_reference(seed: int, dev) -> dict:
    """One f32 train step at base 4 on 64^2 inputs, on the card with cuDNN's
    TF32 off and on the CPU, from the same weights and batch, dropout off.
    Tolerances (those of tests/test_torch_steps.py, where the CPU step is
    held to the JAX package's): loss rtol 1e-5; every gradient within 1e-3
    of its tensor's largest; parameters >= 99.5% within atol 1e-6 + rtol
    1e-4 and all within lr/4 (Keras Adam's normalized update turns last-bit
    gradient differences near |g| ~ eps into visible fractions of lr)."""
    import copy

    import numpy as np
    import torch

    from tpuseg_torch.models.unet import UNet, init_unet
    from tpuseg_torch.train.steps import KerasAdam, TrainState, train_step

    lr = 1e-3
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        cpu_model = init_unet(UNet(NCLS, 1, 4, torch.float32), torch.Generator().manual_seed(seed))
        cpu_model.dropout_rate = 0.0
        card_model = copy.deepcopy(cpu_model).to(dev)
        rng = np.random.default_rng(seed + 2)
        x = torch.from_numpy(rng.normal(0, 1, (2, 64, 64, 1)).astype(np.float32))
        y = torch.nn.functional.one_hot((x[..., 0] + torch.from_numpy(
            rng.normal(0, 0.5, (2, 64, 64)).astype(np.float32)) > 0).long(), NCLS).float()
        states = {}
        for name, model, d in (("cpu", cpu_model, "cpu"), ("card", card_model, dev)):
            st = TrainState(model, KerasAdam(model.parameters(), lr=lr),
                            torch.Generator(device=d), torch.Generator(device=d))
            m = train_step(st, x.to(d), y.to(d))
            states[name] = (st, m["loss"].item())
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    (cpu, cpu_loss), (card, card_loss) = states["cpu"], states["card"]
    loss_rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    grad_err = 0.0
    n_ok = n_all = 0
    max_diff = 0.0
    for (name, pc), (_, pg) in zip(cpu.model.named_parameters(), card.model.named_parameters()):
        gc, gg = pc.grad, pg.grad.cpu()
        grad_err = max(grad_err, ((gg - gc).abs().max() / gc.abs().max()).item())
        d = (pg.detach().cpu() - pc.detach()).abs()
        n_all += d.numel()
        n_ok += int((d <= 1e-6 + 1e-4 * pc.detach().abs()).sum())
        max_diff = max(max_diff, d.max().item())
    res = {"loss_card": card_loss, "loss_cpu": cpu_loss, "loss_rel_err": loss_rel,
           "grad_rel_err": grad_err, "params_within_tol": n_ok / n_all,
           "param_max_abs_diff": max_diff, "lr": lr}
    log(f"train reference (base 4, 64^2, f32, TF32 off): loss card {card_loss:.7f} "
        f"cpu {cpu_loss:.7f} (rel {loss_rel:.2e}), grad rel err {grad_err:.2e}, params "
        f"within tol {n_ok / n_all:.5f}, max diff {max_diff:.2e}")
    if not (loss_rel <= 1e-5 and grad_err <= 1e-3 and n_ok / n_all >= 0.995
            and max_diff <= lr / 4):
        raise AssertionError(f"train step on the card vs the CPU out of tolerance: {res}")
    return res


def write_train_dbs(work: str, seed: int):
    """N_TRAIN + N_TEST records of TRAIN_SIZE^2 uint16 images with uint8
    masks, in the record layout of bench.py (keys tileNNNN:0,1). The mask
    thresholds a smoothed random field (blobs) and the image is brighter
    inside them, under smooth and pixel noise: a learnable task."""
    import numpy as np
    from scipy.ndimage import gaussian_filter

    from tpuseg_torch.data.build_db import serialize_image_mask_pair
    from tpuseg_torch.data.recordstore import RecordWriter

    rng = np.random.default_rng(seed + 3)
    paths = []
    for name, n in (("train", N_TRAIN), ("test", N_TEST)):
        path = os.path.join(work, f"{name}.lmdb")
        with RecordWriter(path) as w:
            for i in range(n):
                field = gaussian_filter(rng.normal(0, 1, (TRAIN_SIZE, TRAIN_SIZE)), 12)
                msk = (field > 0).astype(np.uint8)
                shade = gaussian_filter(rng.normal(0, 1, (TRAIN_SIZE, TRAIN_SIZE)), 40)
                img = (2000.0 + 1200.0 * msk + 400.0 * shade / shade.std()
                       + rng.normal(0, 250, (TRAIN_SIZE, TRAIN_SIZE)))
                w.put(f"tile{i:04d}:0,1", serialize_image_mask_pair(
                    np.clip(img, 0, 65535).astype(np.uint16), msk))
        paths.append(path)
    return paths


def phase_train(seed: int, work: str, dev, card: str) -> dict:
    import numpy as np
    import torch

    from tpuseg_torch.aug.device import DeviceAugmentParams, augment_and_preprocess_batch
    from tpuseg_torch.cli.inference import main as infer_cli
    from tpuseg_torch.cli.train import main as train_cli
    from tpuseg_torch.data.build_db import deserialize_image_mask_pair
    from tpuseg_torch.data.recordstore import RecordReader
    from tpuseg_torch.infer import head_kernel
    from tpuseg_torch.models import unet as unet_mod
    from tpuseg_torch.models.unet import DROPOUT_RATE, UNet
    from tpuseg_torch.ops import warp
    from tpuseg_torch.ops.losses import cce_from_logits, reference_scalar_loss
    from tpuseg_torch.train.steps import create_train_state, eval_step, make_raw_steps
    from tpuseg_torch.utils.checkpoint import load_model
    from tpuseg_torch.utils.imagio import imread, imwrite

    res: dict = {"reference": phase_train_reference(seed, dev)}
    t0 = time.perf_counter()
    train_db, test_db = write_train_dbs(work, seed)
    res["db_write_s"] = time.perf_counter() - t0
    out = os.path.join(work, "train_out")

    # the main path: launch counts zeroed just before, read just after
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    warp.LAUNCHES = 0
    head_kernel.LAUNCHES = 0
    t0 = time.perf_counter()
    result = train_cli([
        "--train_database", train_db, "--test_database", test_db, "--output_dir", out,
        "--batch_size", str(TRAIN_BATCH), "--test_every_n_steps", str(TEST_EVERY),
        "--max_epochs", str(EPOCHS), "--seed", str(seed), "--device", "cuda",
        "--base_features", str(BASE), "--dtype", "bfloat16",
        "--log_every_n_steps", str(LOG_EVERY), "--reader_count", "2",
        "--learning_rate", str(TRAIN_LR)])
    torch.cuda.synchronize()
    res["main_path_s"] = time.perf_counter() - t0
    res["launches"] = {"shear_rows": warp.LAUNCHES, "blocked_head_argmax": head_kernel.LAUNCHES}
    res["peak_mem_gib_main"] = torch.cuda.max_memory_allocated() / 2 ** 30
    res["steps"] = result.steps
    res["train_losses"] = result.train_losses
    res["test_loss"] = result.test_loss
    res["cli_images_per_sec"] = result.images_per_sec
    log(f"train main path: {result.steps} steps in {res['main_path_s']:.1f} s, "
        f"{warp.LAUNCHES} shear launches, losses {[round(v, 4) for v in result.train_losses]}, "
        f"test {result.test_loss}")
    if result.steps != EPOCHS * (TEST_EVERY + 1):
        raise AssertionError(f"{result.steps} train steps, expected {EPOCHS * (TEST_EVERY + 1)}")
    if warp.LAUNCHES != 3 * result.steps:
        raise AssertionError(f"{warp.LAUNCHES} shear launches for {result.steps} train "
                             "steps: expected 3 per step (x, y, x shears)")
    if not (np.isfinite(result.train_losses).all() and np.isfinite(result.test_loss).all()):
        raise AssertionError(f"non-finite losses: {result.train_losses} {result.test_loss}")
    if not result.train_losses[-1] < result.train_losses[0]:
        raise AssertionError(f"train loss did not fall: {result.train_losses}")
    with open(os.path.join(out, "test_loss.csv")) as f:
        rows = [line for line in f if line.strip()]
    if len(rows) != EPOCHS:
        raise AssertionError(f"test_loss.csv has {len(rows)} rows, expected {EPOCHS}")

    # the trained checkpoint serves through the inference CLI
    ckpt = result.checkpoint_path
    model = load_model(ckpt, dtype="bfloat16", device=dev)
    if model.config() != {"num_classes": NCLS, "num_channels": 1, "base_features": BASE,
                          "deconv_impl": "conv_transpose"}:
        raise AssertionError(f"checkpoint config {model.config()}")
    with RecordReader(test_db) as r:
        img, msk = deserialize_image_mask_pair(r.get_at(0))
    imgdir = os.path.join(work, "train_serve_in")
    os.makedirs(imgdir, exist_ok=True)
    imwrite(os.path.join(imgdir, "test0.tif"), np.ascontiguousarray(img[..., 0]))
    written = infer_cli(["--checkpoint_filepath", ckpt, "--image_folder", imgdir,
                         "--output_folder", os.path.join(work, "train_serve_out"),
                         "--number_classes", str(NCLS), "--number_channels", "1",
                         "--base_features", str(BASE), "--device", "cuda",
                         "--quantize", "none", "--seed", str(seed)])
    pred = imread(written[0])
    if pred.shape != msk.shape or not np.isin(pred, np.arange(NCLS)).all():
        raise AssertionError(f"served mask {pred.shape} {np.unique(pred)[:8]}")
    res["served_pixel_accuracy"] = float((pred == msk).mean())
    log(f"trained checkpoint served test0: pixel accuracy {res['served_pixel_accuracy']:.4f}")

    # steady-state train steps on one raw batch held on the card
    state = create_train_state(UNet(NCLS, 1, BASE, "bfloat16"), seed, TRAIN_LR, dev)
    params = DeviceAugmentParams()
    tstep, _ = make_raw_steps(NCLS, params)
    with RecordReader(train_db) as r:
        recs = [deserialize_image_mask_pair(r.get_at(i)) for i in range(TRAIN_BATCH)]
    raw_img = torch.from_numpy(np.stack([a.astype(np.int32) for a, _ in recs])).to(dev)
    raw_msk = torch.from_numpy(np.stack([m for _, m in recs])).to(dev)
    for _ in range(3):
        tstep(state, raw_img, raw_msk)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    windows = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            m = tstep(state, raw_img, raw_msk)
        m["loss"].item()
        windows.append(TRAIN_BATCH * 10 / (time.perf_counter() - t0))
    res["img_per_s_windows"] = windows
    res["img_per_s"] = sorted(windows)[1]
    res["peak_mem_gib_steady"] = torch.cuda.max_memory_allocated() / 2 ** 30
    step_ms = cuda_ms(lambda: tstep(state, raw_img, raw_msk), 10, 1)
    aug_ms = cuda_ms(lambda: augment_and_preprocess_batch(
        state.aug_generator, raw_img, raw_msk, params, NCLS), 10, 1)
    res["step_ms"] = step_ms
    res["augment_ms"] = aug_ms
    res["augment_share"] = aug_ms / step_ms
    log(f"train steps (512^2, batch 8, base 64, bf16, device augmentation) on {card}: "
        f"{res['img_per_s']:.2f} img/s (median of {[round(v, 2) for v in windows]}), "
        f"step {step_ms:.2f} ms, augmentation {aug_ms:.2f} ms ({aug_ms / step_ms:.1%}), "
        f"peak {res['peak_mem_gib_steady']:.2f} GiB")

    def three_steps():
        for _ in range(3):
            tstep(state, raw_img, raw_msk)

    prof = device_profile(three_steps, "3 train steps")
    shear_ms = sum(ms for k, (ms, _) in prof["by_kernel"].items() if "shear_rows" in k)
    prof["shear_kernel_ms"] = shear_ms
    prof["shear_kernel_share"] = shear_ms / prof["busy_ms"] if prof["busy_ms"] else None
    del prof["by_kernel"]
    res["profile_train"] = prof

    # BatchNorm after a few dozen steps: the trained batch's loss in eval
    # mode (running statistics, momentum 0.99) against the same weights
    # normalised with the batch's own statistics (this forward updates the
    # running statistics; nothing reads them afterwards)
    images, labels = augment_and_preprocess_batch(None, raw_img, raw_msk, params, NCLS,
                                                  augment=False)
    bn = {"steps": state.step, "loss_running_stats": eval_step(state, images, labels)["loss"].item()}
    state.model.train()
    state.model.dropout_rate = 0.0
    with torch.no_grad():
        logits = state.model(images)
    state.model.dropout_rate = DROPOUT_RATE
    bn["loss_batch_stats"] = reference_scalar_loss(cce_from_logits(logits, labels),
                                                   TRAIN_BATCH).item()
    # timing only, last because it ruins the weights: the step with every
    # BatchNorm (and its f32 casts) skipped bounds what a fused BatchNorm
    # kernel could save
    real_bn = unet_mod._bn
    unet_mod._bn = lambda x, bn_module, dtype: x
    try:
        bn["step_ms_without_bn"] = cuda_ms(lambda: tstep(state, raw_img, raw_msk), 10, 1)
    finally:
        unet_mod._bn = real_bn
    res["bn_check"] = bn
    log(f"after {bn['steps']} steps on one batch: loss {bn['loss_running_stats']:.4f} with "
        f"running statistics, {bn['loss_batch_stats']:.4f} with batch statistics; step "
        f"{bn['step_ms_without_bn']:.2f} ms with BatchNorm skipped (timing only) against "
        f"{step_ms:.2f} ms")
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
        for fn, r in sorted(ptxas_report(text).items()):
            log(f"  {name}: {kernel_label(fn)}: {r.get('registers')} registers, spill "
                f"stores {r.get('spill_stores')} B, spill loads {r.get('spill_loads')} B")

    kern = phase_kernels(args.seed, dev)
    shear = phase_shear(args.seed, dev)
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke")
    main_res = phase_main(args.seed, work, dev, card)
    train_res = phase_train(args.seed, work, dev, card)

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
        "timing": "device time per call from the profiler, L2 flushed before each; "
                  "events_ms: CUDA events around back-to-back calls",
        "events_ms": fp["events_ms"], "share_of_bound": fp["share_of_bound"],
        "kernel_route": fp["route"], "shape": list(MAIN_SHAPE), "ncls": NCLS,
        "tolerance": "fp head: labels agree on >= 0.9999 (f32 sum order); "
                     "int8 head: labels bit-equal",
        "agree": fp["agree"], "int8_variant": s8,
    }, {
        "name": "shear_rows", "route": "cuda",
        "source": "tpuseg_torch/csrc/shear_rows.cu",
        "replaces": "tpuseg/ops/warp.py:67",
        "also_replaces": "tpuseg/ops/warp.py:147",
        "launches": train_res["launches"]["shear_rows"],
        "max_abs_err": shear["max_abs_err"], "ms": shear["ms"],
        "plain_ms": shear["plain_ms"], "bound_ms": shear["bound_ms"],
        "bound_by": shear["bound_by"], "library_ms": shear["library_ms"],
        "library_call": "F.grid_sample(mode='bilinear', align_corners=True) on [N,1,H,Wp]",
        "library_max_abs_err": shear["library_max_abs_err"],
        "timing": "device time per call from the profiler, L2 flushed before each",
        "shape": shear["shape"],
        "tolerance": "bit-equal to the plain version",
    }]
    summary = {"card": card, "torch": torch.__version__, "build_s": build_s,
               "kernels": kern, "shear": shear, "main": main_res, "train": train_res,
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
