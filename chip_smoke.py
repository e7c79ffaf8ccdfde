#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving, training, migration,
multi-GPU and spatial paths once on one NVIDIA card.

    python3 chip_smoke.py [--seed N] [--out results.json]

Run from the root of a checkout, on a machine with a card, the CUDA toolkit
(``nvcc``) and PyTorch built for CUDA. Imports nothing of JAX or of the JAX
package. The card's peaks, the work counts, the seeded weights and the
blob pairs are the benchmark's (``benchmark/``, imported where a phase
uses them). Phases, each fatal on failure:

1. setup: print the card (``nvidia-smi``) and build every CUDA kernel of
   the path from ``tpuseg_torch/csrc`` (one ``nvcc`` per source, in
   parallel), logging each kernel's registers and spills;
2. kernels: each kernel on card tensors at the shape its main path gives
   it (K2, the blocked head+argmax, and K6, the dense head+argmax: both
   heads, on the mma route, K6 beside the eager chain it replaced; K3, the
   int8 conv with its epilogue fused: the 21 block shapes of a predict
   call through both routes, on codes that are not degenerate, and the
   walks' 8 store-form blocks in those forms, the dense walk's enc1b and
   dec1up besides; K5, the fp input conv: C 1 and 3, dense and
   phase-major, its reciprocal requantize on every f32 value, its
   persistent grid and its SASS issue floor; K4, the blocks' bias + ReLU +
   BatchNorm: its four kernels at enc1's and the head's train shapes, bf16
   and f32, its eval and train store forms, and TransUNet's order after;
   K1, the row shear), first checked against its plain PyTorch version
   (``k1_check`` ... ``k6_check`` and K4's ``k4_*_check``, which the
   ``cuda`` tests call too: bit-equal for K1, K3, K5 and the int8 K2 and
   K6, K4's sums within their summation bound), then both timed in turns
   with the L2 flushed (profiler device time, K2 also by CUDA events; K3,
   K4 and K5 by CUDA events around each call behind a spin kernel) beside
   the card's bound and a PyTorch library call that computes the same
   function where one exists (K3: ``_int_mm`` on the prebuilt im2col; K4:
   PyTorch's sync-BN kernels and ``F.batch_norm``; K5: cuDNN's conv), K3
   also at each N-tile width; registers and spills come from the build
   log, and a spill of K2, K3, K5 or K6 fails;
3. reference: on a small input, the full-width int8_blocked engine on the
   card against the same engine on the CPU (whose arithmetic the CPU tests
   pin to the JAX package), likewise the dense int8 engine (one K6
   launch), and the folded f32 walk on the card against the f32 model on
   the CPU;
4. main path: shape the head of the benchmark's random U-Net (base 64,
   1 channel, 2 classes; ``drivers/serve_tiled.py::shape_head``) so that
   about half the pixels take each class;
   serve a folder (one 4096^2 and four 256^2 uint16 images) through
   ``python -m tpuseg_torch.cli.inference --quantize int8_blocked`` with the
   launch counters zeroed just before and read just after (K3 launched 21
   times and K5 once per K2 launch, one of each per predict call, K3 all
   on its ``"wgmma"`` route), check every mask, serve it again with K3's plain
   version swapped in on the card (masks equal on every pixel, the first
   call's convs at phase 2's 21 shapes) and with ``--quantize int8`` (no
   K2, one K6 and 21 K3 launches per predict call, again against K3's
   plain version on every pixel, and through K6's plain version on >=
   0.9999 of pixels) and compare the masks; serve it with ``--quantize
   int8_auto`` (K2 for the 4096^2 image, K6 for the batch of small ones,
   masks equal to the two modes' on every pixel); then serve both modes with K5's
   plain version swapped in (masks equal on every pixel; the output scales
   K5 was given there checked on every f32 value as in phase 2), time the tiled
   engines on the 4096^2 image (K5 once per predict call in both int8
   modes, K6 once a predict call of ``int8`` and never of
   ``int8_blocked``; a tiled ``int8`` pass with the head quantized
   through K6's int8 route and through its plain version, masks equal on
   every pixel; K4's apply 23 times a predict call of ``none``, whose
   masks through K4 equal those through K4's plain versions on every
   pixel; each mode's pass through the copy pipeline equal on every pixel
   to a whole-image stitch, in two passes in a row, and the copies that
   its schedule overlaps crossing, in the device trace, while kernels
   ran) and profile one pass of int8_blocked, int8 and none each (device
   time by kernel and group, K3's, K5's, K2's or K6's and K4's shares,
   busy share; in the int8 passes no eager edge kernel on int8 codes, the
   ``amax`` of a max-pool, a concat, a depth-to-space copy or a phase max,
   beside the upload's copies); the plain-conv runs check the store forms
   of each call's 8 form blocks;
5. training reference: one f32 train step at base 4 on 64^2 inputs on the
   card (cuDNN TF32 off) against the same step on the CPU, from the same
   weights and batch, dropout off;
6. training main path: write 64 train and 16 test records (512^2 uint16
   images, uint8 masks from a thresholded smooth random field) with the
   port's RecordWriter, train through ``tpuseg_torch.cli.train`` at base
   64, bf16, batch 8, 20 steps between test epochs, 2 epochs, device
   augmentation on, with the shear kernel's and K4's launch counts zeroed
   just before and read just after (3 shears a train step; each of K4's
   kernels 23 times a train step, and 23 more applies a test forward);
   check the losses, test_loss.csv and the checkpoint, serve a test image with the trained
   checkpoint through ``tpuseg_torch.cli.inference --quantize none``; then
   time steady-state train steps (img/s, median of 3 windows, and this
   process's CPU time a step), record peak
   memory, profile a few steps (device time by kernel and group, busy
   share, the augmentation's share), run 3 train steps through K4 and
   through its plain versions from one fresh state (losses within
   ``K4_PARITY_RTOL``, finite and falling), compare the trained batch's
   loss with running and with batch BatchNorm statistics, and time a step
   with K4 (bias, ReLU, BatchNorm) skipped;
7. whole-slide streaming, end to end: write phase 4's 4096^2 image as a
   tiled BigTIFF (tile 512); run the int8_blocked predict function through
   ``inference_tiled_streaming`` and ``inference_tiled`` with equal
   statistics (labels agree on >= 0.9999, K2 and K5 launched once and K3
   21 times per chunk of each zone row); stream the 4096^2 and 8192^2 slides
   through K2 and through the same engine with K2's plain version as the
   head (masks
   agree on >= 0.9999 at every shape the path gives K2); time both
   engines in turns, and profile one streamed pass beside the host's
   decode and deflate times alone; then, each as its own process reaped
   with ``os.wait4`` (wall time, peak RSS, K2 launches), the inference CLI
   in RAM (``--calibration_out``) and streaming (``--streaming
   --calibration_in``) at 4096^2 and 8192^2, masks agreeing on >= 0.999;
   the ``tpuseg_torch.cli.evaluate`` entry point on the streamed masks
   against the in-RAM ones (pixel accuracy equal to numpy's agreement, and
   ``segmentation_metrics`` on card tensors giving the host's confusion
   counts); 8 tiled-BigTIFF slide pairs built by ``cli.build_lmdb`` (keys
   as ``tiling_boxes`` implies), converted to LMDB by ``cli.convert_db`` and
   one back (records byte-equal), and a few train steps through
   ``tpuseg_torch.cli.train`` on the LMDB copies (finite losses, 3 shear
   launches a step);
8. migration and tooling: write phase 4's balanced model as a Keras 2
   reference ``tf.train.Checkpoint`` with the port's numpy bundle writer
   (no TensorFlow anywhere), import it through
   ``tpuseg_torch.cli.import_checkpoint`` (weights bit-equal, tensorflow
   never loaded), serve phase 4's folder from it through ``cli.inference
   --quantize int8_blocked`` (K2 launched as often as in phase 4, masks
   agreeing with phase 4's on >= 0.9999), then resume training from it
   through ``cli.train --resume_checkpoint --profile_steps 5`` on phase 6's
   databases (base 64, bf16, batch 8, two epochs of 7 steps; 3 shear
   launches a step); ``trace_analysis.analyze`` of the profiled window must
   count 5 steps and 15 shear launches and give a busy share, and the
   TensorBoard event files must read back (CRCs) with one scalar per tag
   per logged window and test epoch;
9. multi-GPU on the one card: (a) ``tpuseg_torch.cli.train --multihost 1
   --shard_optimizer 1`` under ``python -m torch.distributed.run
   --standalone --nproc_per_node 1`` on phase 6's databases (base 64,
   bf16, batch 8, two epochs of 7 steps): the child joins NCCL, its losses
   are finite and fall, 3 K1 launches a step counted in the child; its
   checkpoint serves phase 4's folder with phase 4's K2 launch count; in
   this process the steady img/s of the DDP + sync-BN + ZeRO-1 step at
   world size 1 beside the plain step, in turns (reported, not gated);
   (b) two gloo ranks on the card (base 16, 256^2, f32 with TF32 off,
   augmentation and dropout on, ZeRO-1, batch 4 each) against one process
   of batch 8 over 3 steps: the ranks bit-equal, the first loss and
   gradients and the later losses within ``phase_multigpu_gloo``'s
   tolerances, 3 K1 launches a step on each rank; (c) phase 4's 4096^2
   image with ``inference_tiled(..., devices=[card, card])`` against
   ``devices=[card]`` for ``int8_blocked`` and ``none``: masks bit-equal,
   K2 launched once per full chunk of each shard; (d) two torchrun ranks of
   ``cli.inference --multihost 1 --device cuda:0 --quantize int8_blocked``
   stripe phase 4's folder: each mask written once, agreeing with phase
   4's on >= 0.9999, the calibration scales equal on both ranks;
10. spatial partitioning on the one card, two gloo ranks on cuda:0 whose
   halo exchanges take the host-staged route (NCCL refuses two ranks on one
   card): (a) phase 9 (b)'s run on a (1, 2) mesh, each rank augmenting the
   global batch and training on half of its rows, against phase 9 (b)'s
   one process, with (b)'s gates, and an eval step before training (loss
   rtol 1e-5, accuracy within ``SP_EVAL_ACC_ATOL``); (b) the main path,
   ``train_model(TrainConfig(spatial_partitions=2))`` in two processes
   joined over ``tcp://`` with gloo, on phase 6's databases (base 64, bf16,
   512^2, global batch 8, two epochs of 7 steps), K1's count zeroed just
   before and read just after in each: the same losses on both ranks,
   finite and falling, 3 K1 launches a step on each, one checkpoint (rank
   0's), which serves phase 4's folder with phase 4's K2 count; then each
   rank times steady spatial steps (against phase 6's plain step: overhead,
   not scaling, on a shared card), its peak device memory, and the halo
   exchange's route, bytes a step and share of profiled steps; (c) heights
   whose pool windows straddle the two ranks, so each rank gathers the
   rows of the level ``halo.split_level`` names before its pool: (i) (a)'s
   run at 240 x 256 (gathered at level 3) against its own one process,
   with (a)'s gates and the exchange and gather counts the split implies;
   (ii) ``train_model(spatial_partitions=2)`` on 528^2 records (level 3),
   one epoch of 7 steps: the same losses on both ranks, finite and falling,
   3 K1 launches a step on each, 2 gathers a steady step; its steady step
   beside (b)'s, the gather's bytes and profiled share, and peak memory.

The last lines are ``{"kernels": [...]}``, the card's name and power limit,
and ``{"ok": true, "device": {...}}``. Without a card it exits 1 and prints
no result.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import io
import json
import os
import re
import subprocess
import sys
import time

BENCH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "benchmark")
MAIN_SHAPE = (8, 512, 512, 256)  # dec1b edge of 8 tiles of 1024^2 at base 64
DENSE_SHAPE = (8, 1024, 1024, 64)  # the dense walk's dec1b edge, K6's input
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
# phase 7: slides as tiled BigTIFF (tile 512), streamed at BIG^2 and BIG2^2;
# N_SLIDES slide pairs of SLIDE^2 for the database tools, then one epoch of
# SLIDE_TEST_EVERY + 1 train steps at SLIDE_BASE on their LMDB copies
STREAM_TILE, BIG2 = 512, 8192
N_SLIDES, SLIDE, SLIDE_BASE, SLIDE_TEST_EVERY = 8, 1024, 16, 4
# phase 8: the resumed run's epochs of MIGRATE_TEST_EVERY + 1 steps, the
# first PROFILE_STEPS of epoch 1 traced
MIGRATE_TEST_EVERY, MIGRATE_LOG_EVERY, PROFILE_STEPS = 6, 3, 5


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def bench(name: str):
    """The benchmark's module ``name`` (``benchmark/`` put on the path on
    first use), so that only the phases that use it depend on it."""
    if BENCH not in sys.path:
        sys.path.insert(0, BENCH)
    return importlib.import_module(name)


def bytes_ms(nbytes: float) -> float:
    """Milliseconds to move ``nbytes`` at the card's memory rate."""
    return nbytes / bench("harness.peaks").HBM_BYTES_PER_S * 1e3


def ops_ms(ops: float, kind: str) -> float:
    """Milliseconds for ``ops`` at the card's ``kind`` peak (bf16, int8,
    float32)."""
    return ops / bench("harness.peaks").OPS_PER_S[kind] * 1e3


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


LEAD_IN = 64  # spin kernels at the head of a profiler window (see profiler_lead_in)
TIMER_FALLBACKS: list = []  # timed calls whose profiler windows all lost records


def profiler_lead_in(n: int) -> None:
    """Launch ``n`` short spin kernels and wait for them, first thing in a
    profiler window. On an H100 under torch.profiler the first few kernel
    records of a window go missing, more of them the longer the process
    has run (none in its first 20 s, 1 after 26 s, 3 after 56 s, in
    probes of the K1 window): the spins take that loss, and how many of
    them the window saw says whether it reached the timed kernels."""
    import torch

    for _ in range(n):
        torch.cuda._sleep(1000)
    torch.cuda.synchronize()


def device_ms_cold(fn, reps: int, attempts: int = 3) -> float:
    """Mean device time of the kernels ``fn`` launches, from the profiler's
    device timestamps, with the L2 cache flushed before each call (a 128 MB
    ``bitwise_not_``, whose kernel is left out of the sum). Unlike events
    around the call, it does not count the host's time to launch: a call
    shorter than its own Python wrapper would otherwise time the wrapper.
    Each window starts with :func:`profiler_lead_in` and is kept only if
    it saw some of the spins, every flush, and each timed kernel a multiple
    of ``reps`` times; another is taken otherwise, with 8 times the spins,
    up to ``attempts``. If none is kept, the call is timed by
    :func:`events_ms_cold` and counted in ``TIMER_FALLBACKS``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    flush = torch.zeros(32 * 2 ** 20, dtype=torch.int32, device="cuda")
    fn()
    torch.cuda.synchronize()
    lead = LEAD_IN
    for attempt in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            profiler_lead_in(lead)
            for _ in range(reps):
                flush.bitwise_not_()
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        spins = sum(e.count for e in events if "spin_kernel" in e.key)
        flushes = sum(e.count for e in events if "bitwise_not" in e.key)
        timed = [e for e in events if "bitwise_not" not in e.key and "spin_kernel" not in e.key]
        total = sum(e.device_time_total for e in timed)
        if spins and flushes == reps and total > 0 and all(e.count % reps == 0 for e in timed):
            return total / 1e3 / reps
        log(f"profiler window {attempt + 1}/{attempts} incomplete ({spins} of {lead} "
            f"lead-in spins, {flushes} of {reps} flushes, timed kernel counts "
            f"{sorted(e.count for e in timed)}): taken again")
        lead *= 8
    log("no complete profiler window: this call is timed by CUDA events instead")
    TIMER_FALLBACKS.append(reps)
    return events_ms_cold(fn, reps)


def events_ms_cold(fn, reps: int) -> float:
    """Mean time of one call of ``fn`` on the card, from CUDA events
    recorded just before and just after each call, with the L2 cache
    flushed before each (as in :func:`device_ms_cold`) and a ~1 ms spin
    kernel between the flush and the first event: by the time the card
    reaches that event the host has queued the call, so the host's time to
    launch it is not counted. For calls of a quarter of a millisecond and
    more (K3's) the launch gaps inside are a few microseconds. It opens no
    profiler window, so it loses no record (:func:`profiler_lead_in`)."""
    import torch

    flush = torch.zeros(32 * 2 ** 20, dtype=torch.int32, device="cuda")
    fn()
    torch.cuda.synchronize()
    marks = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(reps)]
    for start, end in marks:
        flush.bitwise_not_()
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in marks) / reps


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
    (dense_)head_mma_kernel<fp, nt, breg> spelled out, others with the
    anonymous-namespace prefix cut."""
    m = re.search(r"\d((?:dense_)?head_mma_kernel)ILb(\d)ELi(\d)ELb(\d)E", mangled)
    if m:
        return f"{m.group(1)}<fp={m.group(2)},nt={m.group(3)},breg={m.group(4)}>"
    m = re.search(r"int8_conv_kernelILi(\d)ELb(\d)E", mangled)
    if m:
        return f"int8_conv_kernel<mode={m.group(1)},aligned={m.group(2)}>"
    m = re.search(r"int8_conv_wgmma_kernelILi(\d)ELi(\d+)ELb(\d)E", mangled)
    if m:
        return (f"int8_conv_wgmma_kernel<mode={m.group(1)},bn={m.group(2)},"
                f"looped={m.group(3)}>")
    m = re.search(r"input_conv_kernelILb(\d)ELb(\d)ELb(\d)ELb(\d)E", mangled)
    if m:
        return (f"input_conv_kernel<bf16={m.group(1)},blocked={m.group(2)},c1={m.group(3)},"
                f"staged={m.group(4)}>")
    m = re.search(r"bn_(reduce|apply)_kernelI(f|13__nv_bfloat16)Li(\d+)E(?:Li(\d)E)?Lb(\d)E",
                  mangled)
    if m:
        t = "bf16" if m.group(2) != "f" else "f32"
        ns = f",ns={m.group(4)}" if m.group(4) else ""
        return f"bn_{m.group(1)}_kernel<{t},vec={m.group(3)}{ns},bwd={m.group(5)}>"
    return re.sub(r"^_ZN.*?_cu_[0-9a-f]{8}\d+", "", mangled)[:60]


def build_report(lib: str, kernel: str, spill_fails: bool) -> dict:
    """Registers and spills of the kernels named ``kernel`` in library
    ``lib``, from this process's build log (logged by ``main``); with
    ``spill_fails`` a spill is a defect and fails."""
    from tpuseg_torch.kernels import build

    text = build.BUILD_LOGS.get(lib)
    if text is None:
        log(f"{lib} was not built by this process: registers and spills not read")
        return {}
    report = {kernel_label(k): v for k, v in ptxas_report(text).items() if kernel in k}
    if not report:
        raise AssertionError(f"no {kernel} in the {lib} build log")
    spills = {k: r for k, r in report.items()
              if r.get("spill_stores", 0) or r.get("spill_loads", 0)}
    if spills and spill_fails:
        raise AssertionError(f"{kernel} spills: {spills}")
    return report


def k2_check(fp: bool, x, sv, wt, epi) -> dict:
    """K2 on ``head_inputs`` against its plain version: the mma route, the
    int8 head bit-equal, the fp head on >= 0.9999 of labels (f32 sum
    order)."""
    import torch

    from tpuseg_torch.infer import head_kernel as hk

    route = hk.kernel_route(x.dtype, wt.dtype, fp)
    got = hk.blocked_head_argmax(x, sv, wt, epi, NCLS, fp=fp)
    want = hk._blocked_head_argmax_plain(x, sv, wt, epi, NCLS, fp)
    torch.cuda.synchronize()
    if route != "mma" or hk.LAST_ROUTE != route:
        raise AssertionError(f"head kernel fp={fp} took the {hk.LAST_ROUTE} route, not mma")
    b, h, w, _ = x.shape
    if got.shape != (b, 2 * h, 2 * w) or got.dtype != torch.int32:
        raise AssertionError(f"head kernel returned {tuple(got.shape)} {got.dtype}")
    agree = (got == want).double().mean().item()
    max_err = (got - want).abs().max().item()
    if fp and agree < 0.9999:
        raise AssertionError(f"fp head kernel agrees with plain on {agree} < 0.9999")
    if not fp and not torch.equal(got, want):
        raise AssertionError(f"int8 head kernel differs from plain (agreement {agree})")
    return {"route": route, "agree": agree, "max_abs_err": max_err}


def phase_kernels(seed: int, dev) -> dict:
    """K2 at the serving shape in both variants (the fp head is the served
    default), checked (:func:`k2_check`), timed in turns (plain, kernel,
    kernel, plain) two ways: CUDA events around back-to-back calls, and
    profiler device time with the L2 flushed before each call."""
    import torch

    from tpuseg_torch.infer import head_kernel as hk

    out = {"build": build_report("head_argmax", "head_mma_kernel", spill_fails=True)}
    for fp in (True, False):
        x, sv, wt, epi = head_inputs(fp, seed, dev)
        check = k2_check(fp, x, sv, wt, epi)
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
        t_bytes = bytes_ms(nbytes)
        t_ops = ops_ms(ops, "bf16" if fp else "int8")
        bound = max(t_bytes, t_ops)
        ms, ev_ms = sum(device["kernel"]) / 2, sum(events["kernel"]) / 2
        out["fp" if fp else "int8"] = r = {
            **check, "ms": ms, "ms_runs": device["kernel"],
            "events_ms": ev_ms, "events_ms_runs": events["kernel"],
            "plain_ms": sum(device["plain"]) / 2, "plain_ms_runs": device["plain"],
            "plain_events_ms": sum(events["plain"]) / 2,
            "plain_events_ms_runs": events["plain"],
            "bound_ms": bound, "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "share_of_bound": bound / ms, "events_share_of_bound": bound / ev_ms,
            "bytes": nbytes, "ops": ops}
        log(f"head kernel fp={fp} ({r['route']} route): agree {r['agree']}; device time "
            f"(L2 flushed) "
            f"{device['kernel'][0]:.4f} / {device['kernel'][1]:.4f} ms "
            f"({r['share_of_bound']:.1%} of bound), events {events['kernel'][0]:.4f} / "
            f"{events['kernel'][1]:.4f} ms ({r['events_share_of_bound']:.1%}); plain "
            f"{r['plain_ms']:.3f} ms device, {r['plain_events_ms']:.3f} ms events; "
            f"bound {bound:.4f} ms ({r['bound_by']})")
        del x, sv, wt, epi
        torch.cuda.empty_cache()
    out["dense"] = phase_dense_head(seed, dev)
    return out


def dense_head_inputs(fp: bool, seed: int, dev):
    """K6's inputs at the dense walk's dec1b edge: int8 codes, scales, a
    [ncls, C] weight (bf16 for the fp head, int8 codes for the int8 head)
    and (b, s, t, wscale) rows, a positive BatchNorm scale s and small b
    and t as a trained head's, so that both classes take many pixels."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    c = DENSE_SHAPE[-1]
    x = torch.randint(-127, 128, DENSE_SHAPE, generator=g, device=dev, dtype=torch.int8)
    sv = torch.rand(c, generator=g, device=dev) * 0.09 + 0.01
    epi = torch.randn(4, NCLS, generator=g, device=dev) * 0.3
    epi[1] = torch.rand(NCLS, generator=g, device=dev) + 0.5
    if fp:
        wt = (torch.randn(NCLS, c, generator=g, device=dev) * 0.3).to(torch.bfloat16)
        epi[3] = 1.0
    else:
        wt = torch.randint(-127, 128, (NCLS, c), generator=g, device=dev, dtype=torch.int8)
        epi[3] = torch.rand(NCLS, generator=g, device=dev) * 9e-4 + 1e-4
    return x, sv, wt, epi


def eager_dense_head(x, sv, wt, epi, fp: bool, op=None):
    """The dense walk's head as the port ran it before K6: the fp head
    dequantized to bf16, cuDNN's f32 conv between two permutes, four
    elementwise epilogue passes; the int8 head through K3 (``op``, the
    head's ``Int8ConvWeights``) with its ``"relu_f32"`` epilogue; then
    ``torch.argmax`` over the f32 logits."""
    import torch

    from tpuseg_torch.infer import int8_conv, quant

    b, s, t = epi[0], epi[1], epi[2]
    if fp:
        w = wt.float()[:, :, None, None]
        y = quant._conv_fp((x.float() * sv).to(torch.bfloat16), w, torch.bfloat16)
        y = torch.clamp_min(y + b, 0.0) * s + t
    else:
        y = int8_conv.int8_conv(x, op, int8_conv.Epilogue("relu_f32", epi[3], b, s, t, None))
    return torch.argmax(y, dim=-1).to(torch.int32)


def k6_check(fp: bool, x, sv, wt, epi, op) -> dict:
    """K6 on ``dense_head_inputs`` against its plain version: one launch on
    the mma route, the int8 head bit-equal, the fp head on >= 0.9999 of
    labels; the eager chain it replaced (:func:`eager_dense_head`, ``op``
    the int8 head's K3 weights) on >= 0.9999, and class 1 taking between 1%
    and 99% of the labels."""
    import torch

    from tpuseg_torch.infer import head_kernel as hk

    before = hk.DENSE_LAUNCHES
    got = hk.dense_head_argmax(x, sv, wt, epi, NCLS, fp=fp)
    want = hk._dense_head_argmax_plain(x, sv, wt, epi, NCLS, fp)
    eager = eager_dense_head(x, sv, wt, epi, fp, op)
    torch.cuda.synchronize()
    if hk.DENSE_LAUNCHES != before + 1 or hk.LAST_ROUTE != "mma":
        raise AssertionError(f"K6 fp={fp}: {hk.DENSE_LAUNCHES - before} launches on the "
                             f"{hk.LAST_ROUTE} route, not one on mma")
    if got.shape != x.shape[:3] or got.dtype != torch.int32:
        raise AssertionError(f"K6 returned {tuple(got.shape)} {got.dtype}")
    agree = (got == want).double().mean().item()
    eager_agree = (eager == want).double().mean().item()
    class1 = (want == 1).double().mean().item()
    if fp and agree < 0.9999:
        raise AssertionError(f"fp K6 agrees with plain on {agree} < 0.9999")
    if not fp and not torch.equal(got, want):
        raise AssertionError(f"int8 K6 differs from plain (agreement {agree})")
    if eager_agree < 0.9999 or not 0.01 < class1 < 0.99:
        raise AssertionError(f"K6 fp={fp}: the eager chain agrees with plain on "
                             f"{eager_agree}, class 1 takes {class1} of labels")
    return {"route": "mma", "agree": agree, "max_abs_err": (got - want).abs().max().item(),
            "eager_agree": eager_agree, "class1_share": class1}


def phase_dense_head(seed: int, dev) -> dict:
    """K6 at the dense walk's shape ([8, 1024, 1024, 64], 2 classes), both
    heads, checked (:func:`k6_check`), then timed in turns by profiler
    device time with the L2 flushed before each call (plain, kernel,
    kernel, plain), beside the eager chain it replaced
    (:func:`eager_dense_head`) and its bound. No single PyTorch call computes head + argmax."""
    import numpy as np
    import torch

    from tpuseg_torch.infer import head_kernel as hk
    from tpuseg_torch.infer import int8_conv

    k3_saved = int8_conv.LAUNCHES, dict(int8_conv.ROUTE_LAUNCHES)
    out = {"build": build_report("head_argmax", "dense_head_mma_kernel", spill_fails=True)}
    for fp in (True, False):
        x, sv, wt, epi = dense_head_inputs(fp, seed, dev)
        op = None if fp else int8_conv.Int8ConvWeights(
            np.ascontiguousarray(wt.cpu().numpy().T[None, None]))
        check = k6_check(fp, x, sv, wt, epi, op)
        fns = {"plain": lambda: hk._dense_head_argmax_plain(x, sv, wt, epi, NCLS, fp),
               "kernel": lambda: hk.dense_head_argmax(x, sv, wt, epi, NCLS, fp=fp),
               "eager": lambda: eager_dense_head(x, sv, wt, epi, fp, op)}
        runs = {name: [] for name in fns}
        for name in ("plain", "eager", "kernel", "kernel", "eager", "plain"):
            runs[name].append(device_ms_cold(fns[name], 20 if name == "kernel" else 3))
        npix = x.numel() // x.shape[-1]
        nbytes = (x.numel() + sv.numel() * 4 + wt.numel() * wt.element_size()
                  + epi.numel() * 4 + npix * 4)
        ops = 2 * x.numel() * NCLS
        t_bytes = bytes_ms(nbytes)
        t_ops = ops_ms(ops, "bf16" if fp else "int8")
        bound = max(t_bytes, t_ops)
        ms = sum(runs["kernel"]) / 2
        out["fp" if fp else "int8"] = r = {
            **check, "ms": ms, "ms_runs": runs["kernel"],
            "plain_ms": sum(runs["plain"]) / 2, "plain_ms_runs": runs["plain"],
            "eager_ms": sum(runs["eager"]) / 2, "eager_ms_runs": runs["eager"],
            "bound_ms": bound, "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "share_of_bound": bound / ms, "bytes": nbytes, "ops": ops,
            "shape": list(DENSE_SHAPE)}
        log(f"K6 dense head fp={fp} (mma route): agree {r['agree']} (eager chain "
            f"{r['eager_agree']}, class 1 {r['class1_share']:.3f}); device time (L2 flushed) "
            f"{runs['kernel'][0]:.4f} / {runs['kernel'][1]:.4f} ms ({r['share_of_bound']:.1%} "
            f"of bound), plain {r['plain_ms']:.3f} ms, eager chain {r['eager_ms']:.3f} ms; "
            f"bound {bound:.4f} ms ({r['bound_by']})")
        del x, sv, wt, epi, op
        torch.cuda.empty_cache()
    int8_conv.LAUNCHES, int8_conv.ROUTE_LAUNCHES = k3_saved
    return out


def shear_inputs(seed: int, dev):
    """K1's inputs at the training shape: rows of ``SHEAR_WP`` padded
    pixels, a shift and a fraction a row."""
    import torch

    n, h, w, wp = SHEAR_N, SHEAR_H, SHEAR_W, SHEAR_WP
    g = torch.Generator(device=dev).manual_seed(seed)
    img = torch.rand((n, h, wp), generator=g, device=dev) * 4000
    shift = torch.randint(0, wp - w, (n, h), generator=g, device=dev, dtype=torch.int32)
    return img, shift, torch.rand((n, h), generator=g, device=dev)


def k1_check(img, shift, frac, w: int) -> dict:
    """K1 bit-equal (``torch.equal``) to its plain version."""
    import torch

    from tpuseg_torch.ops import warp

    got = warp._shear_rows(img, shift, frac, w)
    want = warp._shear_rows_plain(img, shift, frac, w)
    torch.cuda.synchronize()
    max_err = (got - want).abs().max().item() if got.shape == want.shape else float("inf")
    if got.shape != (*img.shape[:2], w) or not torch.equal(got, want):
        raise AssertionError(f"shear kernel differs from plain: shape {tuple(got.shape)}, "
                             f"max abs err {max_err}")
    return {"max_abs_err": max_err, "bit_equal": True}


def phase_shear(seed: int, dev) -> dict:
    """K1 at the training shape, checked (:func:`k1_check`); the kernel, the plain
    version and F.grid_sample (bilinear, align_corners=True, on [N, 1, H,
    Wp]: the same 1-D blend, the yardstick) timed in turns by their device
    time with the L2 flushed before each call. The kernel is shorter than
    its wrapper's host time, so CUDA events around back-to-back calls (also
    recorded) time the host, not the kernel."""
    import torch
    import torch.nn.functional as F

    from tpuseg_torch.ops import warp

    n, h, w, wp = SHEAR_N, SHEAR_H, SHEAR_W, SHEAR_WP
    img, shift, frac = shear_inputs(seed, dev)
    check = k1_check(img, shift, frac, w)
    # grid_sample's sample points: x = s + c + f in padded columns, y = row
    px = shift[..., None].float() + torch.arange(w, device=dev) + frac[..., None]
    gx = 2 * px / (wp - 1) - 1
    gy = (2 * torch.arange(h, device=dev, dtype=torch.float32) / (h - 1) - 1)[None, :, None]
    grid = torch.stack([gx, gy.expand(n, h, w)], dim=-1)
    inp = img[:, None]

    def lib():
        return F.grid_sample(inp, grid, mode="bilinear", align_corners=True)

    lib_err = (lib()[:, 0] - warp._shear_rows_plain(img, shift, frac, w)).abs().max().item()
    runs = {"plain": [], "kernel": [], "library": []}
    fns = {"plain": lambda: warp._shear_rows_plain(img, shift, frac, w),
           "kernel": lambda: warp._shear_rows(img, shift, frac, w), "library": lib}
    for order in (("plain", "kernel", "library"), ("library", "kernel", "plain")):
        for k in order:
            runs[k].append(device_ms_cold(fns[k], 20))
    events_ms = cuda_ms(fns["kernel"], 50)
    nbytes = n * h * ((w + 1) * 4 + w * 4 + 8)
    t_bytes = bytes_ms(nbytes)
    t_ops = ops_ms(3 * n * h * w, "float32")
    out = {**check, "ms": sum(runs["kernel"]) / 2, "ms_runs": runs["kernel"],
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


def k3_blocks() -> list:
    """K3's 21 calls in one int8_blocked predict call on the main path
    (BATCH tiles of TILE^2, base BASE, fp_blocks enc1a and head), in the
    walk's order: (block, x shape, kernel size, Cout, epilogue mode). At
    batch 8, 1024^2, base 64: enc1b (8, 512, 512, 256) 3x3 -> 256, ...,
    dec4up (8, 64, 64, 1024) 1x1 -> 2048, ..., dec1a (8, 512, 512, 512)
    3x3 -> 256."""
    b, f = BATCH, BASE

    def at(level, c):  # level 1 is the blocked edge's and enc2's TILE/2
        side = TILE >> level
        return (b, side, side, c)

    conv, up = "relu_requant", "affine_requant"
    blocks = [("enc1b", at(1, 4 * f), 3, 4 * f, conv)]
    cin = f
    for level, name in enumerate(("enc2", "enc3", "enc4", "bottleneck"), start=1):
        cout = 2 ** level * f
        blocks += [(name + "a", at(level, cin), 3, cout, conv),
                   (name + "b", at(level, cout), 3, cout, conv)]
        cin = cout
    for level, name in ((3, "dec4"), (2, "dec3"), (1, "dec2")):
        cout = 2 ** level * f
        blocks += [(name + "up", at(level + 1, 2 * cout), 1, 4 * cout, up),
                   (name + "a", at(level, 2 * cout), 3, cout, conv),
                   (name + "b", at(level, cout), 3, cout, conv)]
    blocks += [("dec1up", at(1, 2 * f), 1, 4 * f, up),
               ("dec1a", at(1, 8 * f), 3, 4 * f, conv),
               ("dec1b", at(1, 4 * f), 3, 4 * f, conv)]
    return blocks


K3_PER_CALL = 21  # K3 launches of one predict call with the default fp_blocks
# the blocked edge convs of the int8_blocked walk and the concat structure
# of their input channels (quant.py's blocked_conv_block)
K3_BLOCKED = {"enc1b": (BASE,), "dec1a": (BASE, BASE), "dec1b": (BASE,)}


def k3_form(name: str, cout: int):
    """The store forms K3 makes the block's call with in the walks at
    ``BASE`` (quant.py's ``skip_and_pool``, ``blocked_enc1``,
    ``up_concat``): ``{"ctot", "offset", "d2s", "pool"}``, the concat
    buffer's width and the output's channel offset in it, or None. A skip's
    producer stores into channels [0, C) of a 2C-wide buffer and pools; a
    deconv stores into channels [C, 2C), with depth-to-space unless it is
    the blocked walk's dec1up. ``dense_`` names the dense walk's blocks."""
    blocked = not name.startswith("dense_")
    name = name.replace("dense_", "")
    if name in ("enc1b", "enc2b", "enc3b", "enc4b"):
        pool = "phase" if blocked and name == "enc1b" else "spatial"
        return {"ctot": 2 * cout, "offset": 0, "d2s": False, "pool": pool}
    if name.endswith("up"):
        d2s = not blocked or name != "dec1up"  # the blocked dec1up: 4F -> 4F blocked
        c = cout // 4 if d2s else cout
        return {"ctot": 2 * c, "offset": c, "d2s": d2s, "pool": None}
    return None


# the dense walk's (``--quantize int8``) blocks with store forms whose
# shapes differ from the blocked walk's: enc1b at full resolution with a
# 2x2 pool, dec1up with depth-to-space (C 64) into the 1024^2 buffer
K3_DENSE_FORM_BLOCKS = [
    ("dense_enc1b", (BATCH, TILE, TILE, BASE), 3, BASE, "relu_requant"),
    ("dense_dec1up", (BATCH, TILE // 2, TILE // 2, 2 * BASE), 1, 4 * BASE, "affine_requant")]


def k3_eager_edge(y, form: dict, skip):
    """The walk's former eager op on K3's output ``y``, which the store
    form replaces: the 2x2 max-pool or the phase max of a skip's producer
    (its concat counted with the deconv), or a deconv's depth-to-space and
    the concat (``skip``, up)."""
    import torch

    from tpuseg_torch.infer import quant

    if form["pool"] == "spatial":
        return quant._maxpool(y)
    if form["pool"] == "phase":
        c = y.shape[-1] // 4
        return torch.maximum(torch.maximum(y[..., :c], y[..., c:2 * c]),
                             torch.maximum(y[..., 2 * c:3 * c], y[..., 3 * c:]))
    return torch.cat([skip, quant._d2s(y) if form["d2s"] else y], dim=-1)


def k3_form_buffer(x, op, form: dict, seed: int, dev):
    """The concat buffer of a block's store form (random codes from
    ``seed``) and the channels [offset, offset + C) K3 stores into."""
    import torch

    b, h, w, _ = x.shape
    c = op.cout // 4 if form["d2s"] else op.cout
    oh, ow = (2 * h, 2 * w) if form["d2s"] else (h, w)
    g = torch.Generator(device=dev).manual_seed(seed)
    buf = torch.randint(-127, 128, (b, oh, ow, form["ctot"]), generator=g, device=dev,
                        dtype=torch.int8)
    return buf, slice(form["offset"], form["offset"] + c)


def k3_form_check(name: str, x, op, epi, form: dict, seed: int, dev) -> dict:
    """K3's store form at one block: the fused call, one launch on the
    wgmma route, against the plain version's forms on the same concat
    buffer (the other channels random codes; the buffer and the pooled
    codes ``torch.equal``); a phase max also at N tile 256 (one tile for
    the four phases), equal to the rule's width."""
    import torch

    from tpuseg_torch.infer import int8_conv as k3

    d2s, pool = form["d2s"], form["pool"]
    buf, ch = k3_form_buffer(x, op, form, seed, dev)
    buf_plain = buf.clone()
    launches = k3.LAUNCHES
    got = k3.int8_conv(x, op, epi, out=buf[..., ch], d2s=d2s, pool=pool)
    if k3.LAUNCHES != launches + 1 or k3.LAST_ROUTE != "wgmma":
        raise AssertionError(f"K3 {name} with its forms: {k3.LAUNCHES - launches} launches on "
                             f"{k3.LAST_ROUTE}")
    want = k3._int8_conv_plain(x, op, epi, buf_plain[..., ch], d2s, pool)
    torch.cuda.synchronize()
    got_pool = got[1] if pool else None
    want_pool = want[1] if pool else None
    err = (buf.float() - buf_plain.float()).abs().max().item()
    if not torch.equal(buf, buf_plain) or (pool and (got_pool.shape != want_pool.shape or
                                                     not torch.equal(got_pool, want_pool))):
        raise AssertionError(f"K3 {name} {form}: the store form differs from the plain "
                             f"version's (buffer max abs err {err})")
    if pool:
        err = max(err, (got_pool.float() - want_pool.float()).abs().max().item())
    if pool == "phase":  # the other width that takes it: all four phases in one tile
        buf_plain[..., ch] = 0
        wide = k3._launch(x, op, epi, out=buf_plain[..., ch], pool=pool, bn=256)[1]
        torch.cuda.synchronize()
        if not torch.equal(buf_plain, buf) or not torch.equal(wide, got_pool):
            raise AssertionError(f"K3 {name}: the phase max at N tile 256 differs from the "
                                 "rule's width")
    return {"form": form, "form_max_abs_err": err}


def k3_form_block(name: str, x, op, epi, form: dict, seed: int, dev) -> dict:
    """K3's store form at one block: checked (:func:`k3_form_check`), then
    in turns with the L2 flushed (CUDA events around each call): the fused
    call, the old K3 call plus the eager op it replaces
    (:func:`k3_eager_edge`), the eager op alone, the plain version's forms,
    for a 2x2 pool the old call at the pooled patch width (64) beside the
    cost model's (128), and for a phase max the call at N tile 256 beside
    the rule's width."""
    from tpuseg_torch.infer import int8_conv as k3

    check = k3_form_check(name, x, op, epi, form, seed, dev)
    d2s, pool = form["d2s"], form["pool"]
    h, w = x.shape[1:3]
    buf, ch = k3_form_buffer(x, op, form, seed, dev)
    out, skip = buf[..., ch], buf[..., :ch.start].contiguous()
    y = k3.int8_conv(x, op, epi)
    fns = {"fused": (lambda: k3.int8_conv(x, op, epi, out=out, d2s=d2s, pool=pool), 5),
           "unfused": (lambda: k3_eager_edge(k3.int8_conv(x, op, epi), form, skip), 5),
           "edge": (lambda: k3_eager_edge(y, form, skip), 5),
           "plain": (lambda: k3._int8_conv_plain(x, op, epi, out, d2s, pool), 1)}
    if pool == "spatial":
        fns["unfused_k3_bw64"] = (lambda: k3._launch(x, op, epi, bw=64), 5)
    if pool == "phase":
        fns["fused_bn256"] = (lambda: k3._launch(x, op, epi, out=out, pool=pool, bn=256), 5)
    runs = {n: [] for n in fns}
    for order in (list(fns), list(fns)[::-1]):
        for n in order:
            fn, reps = fns[n]
            runs[n].append(events_ms_cold(fn, reps))
    ms = {n: sum(r) / 2 for n, r in runs.items()}
    route_bn = k3.n_tile_width("wgmma", op.cout, op.kernel(dev).host_counts, pool)
    return {**check, "fused_bn": route_bn, "fused_bw": k3.patch_width(h, w, pool),
            "fused_ms": ms["fused"], "fused_ms_runs": runs["fused"],
            "unfused_ms": ms["unfused"], "unfused_ms_runs": runs["unfused"],
            "edge_ms": ms["edge"], "plain_form_ms": ms["plain"],
            "unfused_k3_bw64_ms": ms.get("unfused_k3_bw64"),
            "fused_bn256_ms": ms.get("fused_bn256"),
            "pooled_bytes": x.shape[0] * h * w * op.cout // 4 if pool else 0}


def k3_reset() -> None:
    """Zero K3's launch counts, in all and by route."""
    from tpuseg_torch.infer import int8_conv

    int8_conv.LAUNCHES = 0
    int8_conv.ROUTE_LAUNCHES = dict.fromkeys(int8_conv.ROUTES, 0)


def k3_routes(what: str) -> dict:
    """K3's launches by route since :func:`k3_reset`; every one must have
    taken the ``"wgmma"`` route (no block of a served walk has Cin % 16)."""
    from tpuseg_torch.infer import int8_conv

    routes = dict(int8_conv.ROUTE_LAUNCHES)
    if routes.get("wgmma") != int8_conv.LAUNCHES or any(
            n for r, n in routes.items() if r != "wgmma"):
        raise AssertionError(f"{what}: K3 launches by route {routes}, "
                             f"{int8_conv.LAUNCHES} in all: not all on wgmma")
    return routes


def k3_inputs(name: str, shape, k: int, cout: int, mode: str, seed: int, dev):
    """Random int8 codes and per-channel vectors that spread the requantized
    codes over the int8 range: for codes uniform in [-127, 127] (E[x^2] =
    5461) f(acc) * ws is about N(0, 1). The blocked edge convs' codes are
    random unblocked 3x3 codes put through the port's ``_block_weight``, as
    the main path's are, so 3/4 of them are structural zeros and the fan-in
    is that of the non-zero taps."""
    import numpy as np
    import torch

    from tpuseg_torch.infer import int8_conv as k3
    from tpuseg_torch.infer.quant import _block_weight

    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randint(-127, 128, shape, generator=g, device=dev, dtype=torch.int8)
    cin = shape[-1]
    rng = np.random.default_rng(seed)
    if name in K3_BLOCKED:
        groups = K3_BLOCKED[name]
        w0 = rng.integers(-127, 128, (k, k, sum(groups), cout // 4)).astype(np.float32)
        wq = _block_weight(w0, groups).astype(np.int8)
        fan_in = k * k * sum(groups)
    else:
        wq = rng.integers(-127, 128, (k, k, cin, cout)).astype(np.int8)
        fan_in = k * k * cin

    def vec(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    epi = k3.Epilogue(
        mode, vec(rng.uniform(0.5, 1.5, cout) / (np.sqrt(fan_in) * 5461.0)),
        None if mode == "affine_requant" else vec(rng.normal(0, 0.3, cout)),
        vec(rng.uniform(0.5, 1.5, cout)), vec(rng.normal(0, 0.3, cout)),
        vec(np.float32(2.0 / 127.0)))
    return x, k3.Int8ConvWeights(wq), epi


def k3_build_report() -> dict:
    """Registers and spills (ptxas) and dynamic shared memory of every K3
    kernel variant; a spill fails (spilled sums or epilogue state slow
    every block that takes the variant)."""
    from tpuseg_torch.kernels.build import load

    lib = load("int8_conv")
    report = build_report("int8_conv", "int8_conv_", spill_fails=True)
    for label, r in report.items():
        m = re.search(r"bn=(\d+)", label)
        r["smem_bytes"] = lib.tpuseg_int8_conv_smem_bytes(1, int(m.group(1))) if m \
            else lib.tpuseg_int8_conv_smem_bytes(0, 128)
    return report


def k3_check(name: str, x, op, epi) -> dict:
    """K3 on ``k3_inputs`` through both routes, each the route asked for,
    bit-equal (``torch.equal``) to the plain version, on codes that are not
    degenerate (>= 64 distinct, at most half clipped)."""
    import torch

    from tpuseg_torch.infer import int8_conv as k3

    want = k3._int8_conv_plain(x, op, epi)
    got = {}
    for route in k3.ROUTES:
        got[route] = k3._launch(x, op, epi, route=route)
        if k3.LAST_ROUTE != route:
            raise AssertionError(f"K3 {name}: asked for {route}, ran {k3.LAST_ROUTE}")
    torch.cuda.synchronize()
    err = 0.0
    for route, y in got.items():
        e = (y.float() - want.float()).abs().max().item() if y.shape == want.shape \
            else float("inf")
        err = max(err, e)
        if y.shape != want.shape or y.dtype != torch.int8 or not torch.equal(y, want):
            raise AssertionError(f"K3 {name} {tuple(x.shape)} {route} route: differs from "
                                 f"plain (max abs err {e})")
    codes = torch.unique(want).numel()
    clipped = (want.abs() == 127).float().mean().item()
    if codes < 64 or clipped > 0.5:
        raise AssertionError(f"K3 {name}: degenerate codes ({codes} distinct, "
                             f"{clipped:.1%} clipped)")
    return {"codes": codes, "clipped": clipped, "max_abs_err": err}


def phase_int8_conv(seed: int, dev) -> dict:
    """K3 at each of the 21 block shapes of a main-path predict call, on the
    main path's kind of weights (the blocked edge convs' codes blocked),
    checked (:func:`k3_check`); then, in turns with the L2 flushed, by CUDA events around each call
    (:func:`events_ms_cold`), the ``"wgmma"`` route as the wrapper picks
    it, the ``"mma"`` route (with skipping), the plain version, the GEMM
    alone (``torch._int_mm`` on the prebuilt im2col matrix, zeros
    included: a yardstick the port never calls on the card), and the
    ``"wgmma"`` route at each N-tile width (the timings that fix
    ``n_tile_width``'s weights). The 8 blocks whose call the walks make
    with store forms (:func:`k3_form`: the skips' producers with their
    pools, the deconvs into the concat buffers) are checked and timed in
    those forms too (:func:`k3_form_block`), and so are the dense walk's two
    form blocks of other shapes (``K3_DENSE_FORM_BLOCKS``, left out of the
    sums over a call). The bound counts the operations the weights need
    (2*M times ``needed_macs``: the blocked convs' zero K-steps left out)
    at the int8 peak, or the bytes (x, weights and epilogue vectors read
    once, the output written once, and the pooled output of a form);
    ``bound_dense_ms`` counts every tap. ``walk_ms``, the K3 time of a
    predict call, sums each block's call as the walk makes it (with its
    forms); ``ms`` the calls without forms."""
    import torch

    from tpuseg_torch.infer import int8_conv as k3

    out = {"build": k3_build_report(), "blocks": [], "dense_form_blocks": []}
    for i, (name, shape, k, cout, mode) in enumerate(k3_blocks() + K3_DENSE_FORM_BLOCKS):
        x, op, epi = k3_inputs(name, shape, k, cout, mode, seed + i, dev)
        check = k3_check(name, x, op, epi)
        route = k3.kernel_route(shape[-1])
        kw_ = op.kernel(dev)
        bn = k3.n_tile_width(route, cout, kw_.host_counts)
        wm = op.plain(dev)
        a = k3._im2col(k3._pad_same(x, op), x, op, wm.shape[1], 0, shape[1])
        fns = {"plain": (lambda: k3._int8_conv_plain(x, op, epi), 1),
               "wgmma": (lambda: k3.int8_conv(x, op, epi), 5),
               "mma": (lambda: k3._launch(x, op, epi, route="mma"), 5),
               "library": (lambda: torch._int_mm(a, wm.t()), 3)}
        for width in k3.N_TILES:
            fns[f"wgmma_bn{width}"] = (
                lambda width=width: k3._launch(x, op, epi, route="wgmma", bn=width), 3)
        runs = {n: [] for n in fns}
        for order in (list(fns), list(fns)[::-1]):
            for n in order:
                fn, reps = fns[n]
                runs[n].append(events_ms_cold(fn, reps))
        b, h, w, cin = shape
        m, kk = b * h * w, k * k * cin
        macs = k3.needed_macs(op._wq)
        ops, ops_dense = 2 * m * macs, 2 * m * kk * cout
        nbytes = m * cin + cout * kk + 4 * cout * (3 if mode == "affine_requant" else 4) + 4 \
            + m * cout
        t_bytes = bytes_ms(nbytes)
        t_ops, t_dense = ops_ms(ops, "int8"), ops_ms(ops_dense, "int8")
        ms = {n: sum(r) / 2 for n, r in runs.items()}
        r = {"block": name, "shape": list(shape), "k": k, "cout": cout, "mode": mode,
             "blocked": name in K3_BLOCKED, "route": route, "bn": bn,
             "bw": k3.patch_width(h, w), "ksteps": kw_.wm.shape[1] // 64,
             "ksteps_run_per_tile": {str(width): kw_.host_counts[width].tolist()
                                     for width in sorted(kw_.host_counts)},
             **check, "ms": ms["wgmma"], "ms_runs": runs["wgmma"],
             "mma_ms": ms["mma"], "mma_ms_runs": runs["mma"],
             "plain_ms": ms["plain"], "plain_ms_runs": runs["plain"],
             "library_ms": ms["library"], "library_ms_runs": runs["library"],
             "wgmma_ms_by_bn": {width: ms[f"wgmma_bn{width}"] for width in k3.N_TILES},
             "bound_ms": max(t_ops, t_bytes),
             "bound_by": "operations" if t_ops >= t_bytes else "bytes",
             "bound_dense_ms": max(t_dense, t_bytes),
             "ops": ops, "ops_dense": ops_dense, "bytes": nbytes}
        r["share_of_bound"] = r["bound_ms"] / r["ms"]
        r["mma_share_of_bound"] = r["bound_ms"] / r["mma_ms"]
        form = k3_form(name, cout)
        r["walk_ms"], r["walk_bound_ms"] = r["ms"], r["bound_ms"]
        r["ops_ms"], r["walk_bytes_ms"] = t_ops, t_bytes
        if form is not None:
            r.update(k3_form_block(name, x, op, epi, form, seed + 100 + i, dev))
            t_fused = bytes_ms(nbytes + r["pooled_bytes"])
            r["walk_ms"], r["walk_bound_ms"] = r["fused_ms"], max(t_ops, t_fused)
            r["walk_bytes_ms"] = t_fused
            r["fused_bound_by"] = "operations" if t_ops >= t_fused else "bytes"
            log(f"K3 {name:<11} store form {form}: bit-equal to the plain version's, bn "
                f"{r['fused_bn']} bw {r['fused_bw']}; fused {r['fused_ms_runs'][0]:.3f} / "
                f"{r['fused_ms_runs'][1]:.3f} ms ({r['walk_bound_ms'] / r['fused_ms']:.1%} of "
                f"{r['walk_bound_ms']:.3f}), old call + eager op {r['unfused_ms']:.3f} (the op "
                f"alone {r['edge_ms']:.3f})"
                + (f", old call at bw 64 {r['unfused_k3_bw64_ms']:.3f}"
                   if r["unfused_k3_bw64_ms"] else "")
                + (f", fused at bn 256 {r['fused_bn256_ms']:.3f}" if r["fused_bn256_ms"] else "")
                + f"; plain {r['plain_form_ms']:.3f}")
        out["dense_form_blocks" if name.startswith("dense_") else "blocks"].append(r)
        log(f"K3 {name:<11} {shape} {k}x{k} -> {cout:<4} {mode}: both routes bit-equal, "
            f"{check['codes']} codes, {check['clipped']:.2%} clipped; wgmma bn {bn} bw {r['bw']} "
            f"{r['ms_runs'][0]:.3f} / {r['ms_runs'][1]:.3f} ms ({r['share_of_bound']:.1%} of "
            f"{r['bound_ms']:.3f} ms, {r['bound_by']}; dense bound {r['bound_dense_ms']:.3f}), "
            f"by bn " + " / ".join(f"{v:.3f}" for v in r["wgmma_ms_by_bn"].values())
            + f"; mma {r['mma_ms']:.3f}, plain {r['plain_ms']:.3f}, _int_mm alone "
            f"{r['library_ms']:.3f}")
        del x, op, epi, a, wm
        torch.cuda.empty_cache()
    for key in ("ms", "mma_ms", "plain_ms", "library_ms", "bound_ms", "bound_dense_ms",
                "walk_ms", "walk_bound_ms"):
        out[key] = sum(r[key] for r in out["blocks"])
    forms = [r for r in out["blocks"] if r.get("form")]
    for key in ("fused_ms", "unfused_ms", "edge_ms", "plain_form_ms"):
        out[f"forms_{key}"] = sum(r[key] for r in forms)
    out["forms_k3_alone_ms"] = sum(r["ms"] for r in forms)
    out["walk_plain_ms"] = sum(r["plain_form_ms"] if r.get("form") else r["plain_ms"]
                               for r in out["blocks"])
    out["walk_share_of_bound"] = out["walk_bound_ms"] / out["walk_ms"]
    out["walk_bound_by"] = "operations" if sum(r["ops_ms"] for r in out["blocks"]) >= sum(
        r["walk_bytes_ms"] for r in out["blocks"]) else "bytes"
    if len(forms) != 8:
        raise AssertionError(f"{len(forms)} blocks with store forms, not 8")
    out["wgmma_ms_by_bn"] = {width: sum(r["wgmma_ms_by_bn"][width] for r in out["blocks"])
                             for width in k3.N_TILES}
    out["wgmma_ms_best_bn"] = sum(min(r["wgmma_ms_by_bn"].values()) for r in out["blocks"])
    out["share_of_bound"] = out["bound_ms"] / out["ms"]
    out["ops"] = sum(r["ops"] for r in out["blocks"])
    out["ops_dense"] = sum(r["ops_dense"] for r in out["blocks"])
    out["max_abs_err"] = max(max(r["max_abs_err"], r.get("form_max_abs_err", 0))
                             for r in out["blocks"] + out["dense_form_blocks"])
    if out["ms"] >= out["mma_ms"]:
        log(f"K3: the wgmma route ({out['ms']:.2f} ms) is not faster than the mma route "
            f"({out['mma_ms']:.2f} ms) over a call")
    log(f"K3 over one predict call's 21 blocks: wgmma {out['ms']:.2f} ms "
        f"({out['share_of_bound']:.1%} of the {out['bound_ms']:.2f} ms bound on needed work, "
        f"{out['ops'] / 1e12:.2f} TOP; dense bound {out['bound_dense_ms']:.2f} ms), mma "
        f"{out['mma_ms']:.2f} ms, plain {out['plain_ms']:.2f} ms, _int_mm alone "
        f"{out['library_ms']:.2f} ms; wgmma at one width throughout: "
        + ", ".join(f"bn {w} {v:.2f}" for w, v in out["wgmma_ms_by_bn"].items())
        + f", best width per shape {out['wgmma_ms_best_bn']:.2f}")
    log(f"K3 as the walk calls it (8 blocks with store forms): {out['walk_ms']:.2f} ms a call "
        f"({out['walk_share_of_bound']:.1%} of {out['walk_bound_ms']:.2f} ms); the 8 form "
        f"blocks fused {out['forms_fused_ms']:.2f} ms against the old calls + eager ops "
        f"{out['forms_unfused_ms']:.2f} (K3 alone {out['forms_k3_alone_ms']:.2f}, the ops "
        f"alone {out['forms_edge_ms']:.2f})")
    return out


K5_PER_CALL = 1  # K5 launches of one predict call (enc1a, default fp_blocks)


def k5_inputs(c: int, seed: int, dev) -> list:
    """A z-scored batch of BATCH tiles of TILE^2 with ``c`` channels and
    enc1a's operands at width BASE: the kernel, epilogue vectors and an
    output scale that spread the codes over the int8 range."""
    import numpy as np
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((BATCH, TILE, TILE, c), generator=g, device=dev)
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(0, 1, (3, 3, c, BASE)) / np.sqrt(9 * c), rng.normal(0, 0.3, BASE),
              rng.uniform(0.5, 1.5, BASE), rng.normal(0, 0.3, BASE), np.asarray(2.5 / 127.0)]
    return [x] + [torch.from_numpy(np.asarray(a, np.float32)).to(dev) for a in arrays]


def eager_input_block(args: list, dtype, blocked: bool):
    """The path K5 replaced, as ``quant.py`` ran it before: cuDNN's f32 conv
    on operands rounded to ``dtype`` (the blocked walk's on the
    space-to-depth batch with ``_block_weight``'s kernel), then the
    epilogue and the requantize as eager passes. Returns it as a call, its
    weights prepared once, as the walk cached them."""
    import torch

    from tpuseg_torch.infer import quant

    x, w, b, s, t, so = args
    if blocked:
        w_oihw = quant._oihw(quant._block_weight(w.cpu().numpy(), (x.shape[-1],)), x.device)
        b, s, t = (v.repeat(4) for v in (b, s, t))
    else:
        w_oihw = quant._oihw(w.cpu().numpy(), x.device)

    def run():
        xin = quant._s2d(x).to(dtype) if blocked else x
        y = torch.clamp_min(quant._conv_fp(xin, w_oihw, dtype) + b, 0.0) * s + t
        return torch.clamp(torch.round(y / so), -127, 127).to(torch.int8)

    return run


K5_OUTPUTS_PER_ITEM = 32  # csrc/input_conv.cu: kItem pixels x kNG channels
K5_RANDOM_SCALES, K5_RANDOM_VALUES = 256, 2 ** 24


def clock_max_mhz() -> float:
    res = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         timeout=60, check=True)
    return float(res.stdout.split()[0])


def k5_sass(blocked: bool) -> dict:
    """Instructions per output of the served K5 variant (bf16, C 1, staged
    codes), from the SASS of the built library (``cuobjdump --dump-sass``):
    one item of the innermost loop that holds an item's 9 x 32 FFMAs,
    traced from its head to its back edge along the path the served scales
    take (at each forward branch, the side without the true division's FCHK
    and MUFU; unconditional branches followed). An item is 32 outputs."""
    from collections import Counter

    from tpuseg_torch.kernels import build

    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "--dump-sass", str(build._lib_path("input_conv"))],
                          capture_output=True, text=True, timeout=300, check=True).stdout
    name = f"input_conv_kernelILb1ELb{int(blocked)}ELb1ELb1E"
    func = next(part for part in text.split("Function : ")[1:]
                if name in part.split("\n", 1)[0])
    ins = [(int(a, 16), t.strip())
           for a, t in re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", func)]
    index = {a: i for i, (a, _) in enumerate(ins)}

    def op(t):
        return re.sub(r"^@!?U?P\w+\s+", "", t).split()[0]

    def target(t):
        m = re.search(r"\bBRA\S*\s+0x([0-9a-f]+)", t)
        return int(m.group(1), 16) if m else None

    loops = []
    for i, (a, t) in enumerate(ins):
        tg = target(t)
        if tg is not None and tg < a and tg in index:
            body = ins[index[tg]:i + 1]
            if sum(op(u).startswith("FFMA") for _, u in body) >= 9 * K5_OUTPUTS_PER_ITEM:
                loops.append((len(body), tg, a))
    if not loops:
        raise AssertionError(f"no item loop in the SASS of {name}")
    _, head, back = min(loops)
    trace, i = [], index[head]
    while len(trace) < 20000:
        a, t = ins[i]
        trace.append(op(t))
        tg = target(t)
        if a == back:
            break
        if tg is None or tg not in index:
            i += 1
        elif not t.startswith("@"):
            i = index[tg]
        else:
            j = index[tg]
            skipped = [op(u) for _, u in ins[i + 1:j]]
            i = j if any(o.startswith(("FCHK", "MUFU", "CALL")) for o in skipped) else i + 1
    if trace.count("FCHK") or len(trace) >= 20000:
        raise AssertionError(f"the traced item of {name} is not the reciprocal route")
    counts = Counter(o.split(".")[0] for o in trace)
    return {"kernel": kernel_label(name), "per_item": len(trace),
            "per_output": len(trace) / K5_OUTPUTS_PER_ITEM,
            "by_opcode_per_output": {k: v / K5_OUTPUTS_PER_ITEM
                                     for k, v in counts.most_common()},
            "function_instructions": len(ins)}


def k5_division_check(so, count: int, seed: int) -> dict:
    """K5's reciprocal requantize against the true division
    (``input_conv.requant_mismatches``) for each scale of the CUDA vector
    ``so``: every f32 value with ``count`` 0, else ``count`` draws each.
    Fails on any value whose code differs, and on any value whose quotient
    differs outside underflow (|v| >= 2^-100 and a normal quotient, where
    the correction is correctly rounded, so a difference there would be a
    fault that other scales could meet with other codes); reports the
    values whose quotients differ, and the largest of their true quotients
    and of their |v|."""
    from tpuseg_torch.infer import input_conv as k5

    t0 = time.perf_counter()
    m = k5.requant_mismatches(so, count, seed)
    values = so.tolist()
    r = {"scales": len(values), "scale_values": values[:8],
         "values_each": 2 ** 32 if count == 0 else count,
         "reciprocal_route": all(2.0 ** -64 <= v <= 2.0 ** 64 for v in values),
         "code_mismatches": m["codes"], "quotient_mismatches": m["quotients"],
         "quotient_mismatches_outside_underflow": m["normal"],
         "largest_mismatched_quotient": m["largest_quotient"],
         "largest_mismatched_value": m["largest_value"],
         "first_mismatches": m["examples"],
         "s": time.perf_counter() - t0}
    what = "every f32 value" if count == 0 else f"{count} values each"
    if m["codes"] or m["normal"] or not r["reciprocal_route"]:
        raise AssertionError(f"K5's reciprocal requantize: {m['codes']} codes and "
                             f"{m['normal']} quotients outside underflow differ from the true "
                             f"division's over {what} of {len(values)} scales; {r}")
    log(f"K5 division check, {len(values)} scale(s) ({values[:3]}...), {what}: codes equal "
        f"to __fdiv_rn's everywhere; quotients differ on {m['quotients']}, none outside "
        f"underflow (|v| >= 2^-100, normal quotient); among them the largest |quotient| "
        f"{m['largest_quotient']:.3e}, the largest |v| {m['largest_value']:.3e}; "
        f"{r['s']:.3f} s")
    return r


def k5_division_cases(so, seed: int, dev) -> dict:
    """The arguments of :func:`k5_division_check` for the output scale
    ``so`` on every f32 value and for ``K5_RANDOM_SCALES`` scales drawn over
    2^-64..2^64 on ``K5_RANDOM_VALUES`` values each."""
    import numpy as np
    import torch

    scales = 2.0 ** np.random.default_rng(seed).uniform(-64, 64, K5_RANDOM_SCALES)
    return {"phase2_scale_every_value": (so.reshape(1), 0, seed),
            "random_scales": (torch.tensor(scales, dtype=torch.float32, device=dev),
                              K5_RANDOM_VALUES, seed)}


def k5_check(args: list, dtype, blocked: bool) -> dict:
    """K5 on ``k5_inputs``: one launch, bit-equal (``torch.equal``) to its
    plain version, on codes that are not degenerate (>= 64 distinct, at most
    half clipped); beside the eager path it replaced
    (:func:`eager_input_block`: its sums run in another order, so its codes
    are reported, not gated)."""
    import torch

    from tpuseg_torch.infer import input_conv as k5

    c = args[0].shape[-1]
    before = k5.LAUNCHES
    got = k5.input_conv(*args, dtype, blocked)
    want = k5._input_conv_plain(*args, dtype, blocked)
    eager = eager_input_block(args, dtype, blocked)()
    torch.cuda.synchronize()
    if k5.LAUNCHES != before + 1:
        raise AssertionError(f"K5 C {c} blocked={blocked}: the wrapper did not launch")
    err = (got.float() - want.float()).abs().max().item() \
        if got.shape == want.shape else float("inf")
    if got.shape != want.shape or got.dtype != torch.int8 or not torch.equal(got, want):
        raise AssertionError(f"K5 C {c} blocked={blocked}: {tuple(got.shape)} "
                             f"{got.dtype} differs from plain (max abs err {err})")
    codes = torch.unique(want).numel()
    clipped = (want.abs() == 127).float().mean().item()
    if codes < 64 or clipped > 0.5:
        raise AssertionError(f"K5 C {c}: degenerate codes ({codes} distinct, "
                             f"{clipped:.1%} clipped)")
    diff = (eager.int() - want.int()).abs()
    return {"c": c, "blocked": blocked, "shape": list(got.shape), "max_abs_err": err,
            "codes": codes, "clipped": clipped,
            "eager_codes_equal": (diff == 0).double().mean().item(),
            "eager_max_code_diff": diff.max().item()}


def phase_input_conv(seed: int, dev) -> dict:
    """K5 at the main path's shapes (BATCH tiles of TILE^2, C 1, F BASE, bf16
    operands), in both layouts, and at C 3, checked (:func:`k5_check`); its
    reciprocal requantize (:func:`k5_division_cases`); its launch plan
    (persistent grid, resident blocks an SM); its SASS instructions per
    output and the issue floor they set at the card's ``clocks.max.sm``;
    then, in turns with the L2 flushed, by CUDA events around each call
    (:func:`events_ms_cold`), the kernel, the plain version and the eager
    path in both layouts, and cuDNN's ``F.conv2d`` alone (f32 out, TF32
    off, on the rounded operands, as ``_conv_fp`` runs it: the product, a
    yardstick the port no longer calls for enc1a). The bound: the input,
    weights and vectors read once and the codes written once at the card's
    memory rate, or the multiply-adds at the f32 CUDA-core peak, whichever
    is longer."""
    import torch
    import torch.nn.functional as F

    from tpuseg_torch.infer import input_conv as k5
    from tpuseg_torch.infer import quant

    dtype = torch.bfloat16
    out = {"build": build_report("input_conv", "input_conv_kernel", spill_fails=True),
           "cases": []}
    for c in (1, 3):
        args = k5_inputs(c, seed + c, dev)
        for blocked in (False, True):
            out["cases"].append(r := k5_check(args, dtype, blocked))
            log(f"K5 C {c} {'blocked' if blocked else 'dense'} {tuple(r['shape'])}: bit-equal "
                f"to plain, {r['codes']} codes, {r['clipped']:.2%} clipped; the eager path's "
                f"codes equal on {r['eager_codes_equal']:.6f} (max diff "
                f"{r['eager_max_code_diff']})")
        del args
        torch.cuda.empty_cache()

    args = k5_inputs(1, seed + 1, dev)
    x, w = args[0], args[1]
    out["division"] = {name: k5_division_check(*case)
                       for name, case in k5_division_cases(args[5], seed, dev).items()}
    layouts = {"dense": False, "blocked": True}
    out["plan"] = {lay: k5.launch_plan(tuple(x.shape), BASE, dtype, blocked, dev)
                   for lay, blocked in layouts.items()}
    out["clock_max_mhz"] = clock_max_mhz()
    outputs = x.shape[0] * x.shape[1] * x.shape[2] * BASE
    out["sass"], out["issue_floor_ms"] = {}, {}
    for lay, blocked in layouts.items():
        out["sass"][lay] = r = k5_sass(blocked)
        sms = out["plan"][lay]["sms"]
        out["issue_floor_ms"][lay] = (outputs * r["per_output"] / 32 / (4 * sms)
                                      / (out["clock_max_mhz"] * 1e6) * 1e3)
        plan = out["plan"][lay]
        log(f"K5 {lay}: grid {plan['grid']} blocks ({plan['resident_per_sm']} an SM x {sms} "
            f"SMs, {plan['tiles']} tiles of {plan['tile_h']} x {plan['tile_w']}), "
            f"{plan['smem_bytes']} B shared; SASS {r['per_output']:.2f} instructions "
            f"an output ({r['by_opcode_per_output']}): issue floor "
            f"{out['issue_floor_ms'][lay]:.4f} ms at {out['clock_max_mhz']:.0f} MHz")
    xf = x.to(dtype).float().permute(0, 3, 1, 2)
    wf = w.permute(3, 2, 0, 1).contiguous().to(dtype).float()

    def library():
        with quant._ieee_f32():
            return F.conv2d(xf, wf, padding=1)

    fns = {"library": (library, 5)}
    for lay, blocked in layouts.items():
        fns[f"kernel_{lay}"] = (lambda blocked=blocked: k5.input_conv(*args, dtype, blocked), 10)
        fns[f"plain_{lay}"] = (
            lambda blocked=blocked: k5._input_conv_plain(*args, dtype, blocked), 2)
        fns[f"eager_{lay}"] = (eager_input_block(args, dtype, blocked), 3)
    runs = {n: [] for n in fns}
    for order in (list(fns), list(fns)[::-1]):
        for n in order:
            fn, reps = fns[n]
            runs[n].append(events_ms_cold(fn, reps))
    ms = {n: sum(r) / 2 for n, r in runs.items()}
    b, h, wd, c = x.shape
    nbytes = 4 * (x.numel() + w.numel() + 3 * BASE + 1) + b * h * wd * BASE
    macs = b * h * wd * 9 * c * BASE
    t_bytes, t_ops = bytes_ms(nbytes), ops_ms(2 * macs, "float32")
    out.update({"shape": list(x.shape), "f": BASE, "dtype": "bfloat16",
                "ms": ms["kernel_blocked"], "ms_runs": runs["kernel_blocked"],
                "dense_ms": ms["kernel_dense"], "dense_ms_runs": runs["kernel_dense"],
                "plain_ms": ms["plain_blocked"], "plain_dense_ms": ms["plain_dense"],
                "eager_ms": ms["eager_blocked"], "eager_dense_ms": ms["eager_dense"],
                "eager_ms_runs": {k: runs[f"eager_{k}"] for k in layouts},
                "library_ms": ms["library"], "library_ms_runs": runs["library"],
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bound_bytes_ms": t_bytes, "bound_ops_ms": t_ops, "bytes": nbytes, "macs": macs,
                "max_abs_err": max(r["max_abs_err"] for r in out["cases"])})
    out["share_of_bound"] = out["bound_ms"] / out["ms"]
    out["dense_share_of_bound"] = out["bound_ms"] / out["dense_ms"]
    out["share_of_issue_floor"] = out["issue_floor_ms"]["blocked"] / out["ms"]
    out["dense_share_of_issue_floor"] = out["issue_floor_ms"]["dense"] / out["dense_ms"]
    log(f"K5 {tuple(x.shape)} -> {BASE} (bf16 operands): blocked {runs['kernel_blocked'][0]:.4f}"
        f" / {runs['kernel_blocked'][1]:.4f} ms ({out['share_of_bound']:.1%} of the "
        f"{out['bound_ms']:.4f} ms bound, {out['bound_by']}; ops {t_ops:.4f} ms; "
        f"{out['share_of_issue_floor']:.1%} of the issue floor), dense "
        f"{runs['kernel_dense'][0]:.4f} / {runs['kernel_dense'][1]:.4f} ms "
        f"({out['dense_share_of_bound']:.1%}, {out['dense_share_of_issue_floor']:.1%}); plain "
        f"{out['plain_ms']:.3f} / {out['plain_dense_ms']:.3f} ms; the eager path it replaced "
        f"{out['eager_ms']:.3f} / {out['eager_dense_ms']:.3f} ms; cuDNN F.conv2d alone "
        f"{out['library_ms']:.4f} ms")
    del args, x, w, xf, wf
    torch.cuda.empty_cache()
    return out


K4_LAYERS = 23  # BatchNorm layers of the U-Net: 18 conv blocks, 4 deconvs, the head
K4_KINDS = ("stats", "apply", "backward_reduce", "backward_apply")
# K4 at the training main path's shapes (NCHW, rows of channels): enc1's
# conv blocks and the head, batch TRAIN_BATCH of TRAIN_SIZE^2
K4_SHAPES = {"enc1": (TRAIN_BATCH, BASE, TRAIN_SIZE, TRAIN_SIZE),
             "head": (TRAIN_BATCH, NCLS, TRAIN_SIZE, TRAIN_SIZE)}
# K4's eval store forms at enc1b of a serving call: BATCH tiles of TILE^2
K4_FORM_SHAPE = (BATCH, BASE, TILE, TILE)


def k4_inputs(shape, dtype, seed: int, dev):
    """A conv block's view of K4 at ``shape``: the conv output x (rows of
    channels, in ``dtype``), the conv bias, BN's gamma and beta, and an
    incoming gradient."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    n, c, h, w = shape

    def rows(scale, shift):
        t = torch.randn((n, h, w, c), generator=g, device=dev) * scale + shift
        return t.to(dtype).permute(0, 3, 1, 2)

    x = rows(0.8, 0.1)
    bias = torch.randn(c, generator=g, device=dev) * 0.3
    gamma = torch.rand(c, generator=g, device=dev) + 0.5
    beta = torch.randn(c, generator=g, device=dev) * 0.3
    return x, bias, gamma, beta, rows(1e-3, 0.0)


def bits(t):
    """``t``'s bit patterns, every NaN as one pattern (its payload aside)."""
    import torch

    t = torch.where(torch.isnan(t), torch.full_like(t, float("nan")), t)
    return t.contiguous().view(torch.int16 if t.element_size() == 2 else torch.int32)


def k4_sum_check(name: str, got, plain, terms, plan, faults: dict | None = None) -> dict:
    """The sums ``got[k]`` of a K4 reduction against the float64 sums of
    ``terms`` (callables, each giving float64 ``[C, M]`` terms in the
    kernel's row order, exact: products taken in float64) and the bound of
    the summation the kernel does, ``gamma_d * sum |t|`` (u = 2^-24), with
    ``d = min(plan["depth"], M - 1)``: the most f32 additions between a term
    and its sum in the library's plan (a thread's rows, the block's row
    lanes, the blocks). The plain f32 sums ``plain`` (PyTorch's order, not
    stated), unless None, are held to the kernel's bound counted twice,
    once for each of the two sums. Then faults planted in ``got`` must fail
    the same check: the first block's rows dropped, each sum set to zero in
    turn, and the sums ``faults`` names. Returns the largest errors and
    their largest share of the bound."""
    import torch

    exact, mag, first = [], [], []
    for term in terms:
        t = term()
        rows = t.shape[1]
        exact.append(t.sum(1))
        mag.append(t.abs().sum(1))
        first.append(t[:, :plan["rows_per_block"]].sum(1))
        del t
    exact, mag, first = torch.stack(exact), torch.stack(mag), torch.stack(first)
    torch.cuda.empty_cache()
    d = max(min(plan["depth"], rows - 1), 1)
    bound = d * 2.0 ** -24 / (1 - d * 2.0 ** -24) * mag

    def beyond(sums) -> bool:
        return not bool(((sums.double() - exact).abs() <= bound).all())

    err = (got.double() - exact).abs()
    if beyond(got):
        k, c = divmod(int((err - bound).argmax()), err.shape[1])
        raise AssertionError(f"K4 {name} sum {k}: error {err[k, c].item()} beyond the bound "
                             f"{bound[k, c].item()} of its summation (depth {d})")
    plain_diff = (plain.double() - got.double()).abs() if plain is not None else err * 0
    if not bool((plain_diff <= 2 * bound).all()):
        raise AssertionError(f"K4 {name}: the plain f32 sums differ by {plain_diff.max().item()}"
                             f", beyond twice the kernel's summation bound")
    faults = {"first block dropped": got.double() - first, **(faults or {})}
    for k in range(got.shape[0]):
        zeroed = got.double().clone()
        zeroed[k] = 0
        faults[f"sum {k} zeroed"] = zeroed
    missed = [f for f, sums in faults.items() if not beyond(sums)]
    if missed:
        raise AssertionError(f"K4 {name}: the sum check passes planted faults: {missed}")
    share = torch.where(bound > 0, err / bound, 0.0).max().item()
    return {"max_abs_err": err.max().item(), "share_of_bound": share,
            "plain_diff": plain_diff.max().item(), "depth": d,
            "faults_caught": len(faults)}


K4_RSQRT_ULPS = 2  # CUDA's stated bound for rsqrtf; torch.rsqrt compiles to it on the card


def k4_vector_check(name: str, x, bias, gy, gamma, beta, stats, vec, sums, dx, dbias, running,
                    run) -> dict:
    """What (b) and (d) derive inside the kernels, against the eager
    arithmetic they replaced on the same sums: for (a)'s sums as they are
    (no group) and doubled (what an all-reduce over two ranks holding the
    same batch gives: sums and n doubled), (b)'s mean, variance and mask
    bit-equal to ``finalize``'s, its rstd and mul within ``K4_RSQRT_ULPS``
    ulps of torch.rsqrt's (counted; 0 where the kernel's rsqrtf is what
    torch.rsqrt runs), y bit-equal to (b)'s plain version on the kernel's
    own vectors, the running statistics it updated bit-equal to the
    two-line update ``conv_bn`` made before (``running`` before, ``run``
    after); (d)'s dx and bias gradient bit-equal to the plain (d) and the
    eager formula with k1 and k2 taken eagerly from the same totals; and
    eval-mode (b) against its plain version (bit-equal where the train
    rstd was)."""
    import torch

    from tpuseg_torch.ops import batchnorm as bn

    def ulps(a, b) -> int:
        return int((a.view(torch.int32).long() - b.view(torch.int32).long()).abs().max())

    res = {"rstd_ulps": 0, "mul_ulps": 0, "cases": []}
    variants = {"none": (stats, vec, sums, dx, dbias)}
    st2 = stats * 2
    y2, vec2 = bn.bn_apply_train(x, bias, True, st2, gamma, beta, 1e-3)
    totals2 = (sums[:2] * 2).contiguous()
    dx2, dbias2 = bn.backward_apply_train(x, bias, True, gy, st2, vec2, sums, totals2)
    variants["group"] = (st2, vec2, totals2, dx2, dbias2)
    if not torch.equal(y2, bn._apply_plain(x, bias, True, vec2[0], vec2[3], beta)):
        raise AssertionError(f"K4 {name}: (b) on all-reduced sums differs from its plain version")
    for group, (st, v, totals, dxv, dbv) in variants.items():
        mean, var, unclipped, rstd, mul = bn.finalize(st, 1e-3, gamma)
        if not (torch.equal(v[0], mean) and torch.equal(v[1], var)
                and torch.equal(v[4] != 0, unclipped)):
            raise AssertionError(f"K4 {name} ({group}): the kernel's mean, var or mask differs "
                                 "from finalize's on the same sums")
        ur, um = ulps(v[2], rstd), ulps(v[3], mul)
        res["rstd_ulps"], res["mul_ulps"] = max(res["rstd_ulps"], ur), max(res["mul_ulps"], um)
        if max(ur, um) > K4_RSQRT_ULPS:
            raise AssertionError(f"K4 {name} ({group}): rstd {ur} and mul {um} ulps off "
                                 f"finalize's, beyond {K4_RSQRT_ULPS}")
        k1 = totals[0] / st[2]
        k2 = torch.where(v[4] != 0, totals[1] / st[2], 0.0)
        if not torch.equal(dxv, bn._backward_apply_plain(x, bias, True, gy, v[0], v[2], v[3],
                                                         k1, k2)):
            raise AssertionError(f"K4 {name} ({group}): (d) differs from its plain version on "
                                 "k1 and k2 taken eagerly")
        if not torch.equal(dbv, v[3] * ((sums[2] - k1 * sums[3]) - k2 * sums[4])):
            raise AssertionError(f"K4 {name} ({group}): the kernel's bias gradient differs from "
                                 "the eager formula")
        res["cases"].append(group)
    if not (torch.equal(run[0], 0.99 * running[0] + (1 - 0.99) * vec[0])
            and torch.equal(run[1], 0.99 * running[1] + (1 - 0.99) * vec[1])):
        raise AssertionError(f"K4 {name}: the running statistics differ from the two-line update")
    ye = bn.bn_apply_eval(x, bias, True, running[0], running[1], gamma, beta, 1e-3)
    ye_plain = bn._apply_eval_plain(x, bias, True, running[0], running[1], gamma, beta, 1e-3)
    res["eval_max_abs_diff"] = (ye.float() - ye_plain.float()).abs().max().item()
    if res["rstd_ulps"] == 0 and not torch.equal(ye, ye_plain):
        raise AssertionError(f"K4 {name}: eval-mode (b) differs from its plain version")
    return res


def eager_batchnorm(x, bias, gamma, beta, running, train: bool):
    """The chain K4 replaced (the model before K4; there cuDNN added the bias
    inside the conv, here one add): ReLU, the f32 cast, the batch sums or
    ``F.batch_norm`` on the running statistics, the affine map, the cast
    back."""
    import torch
    import torch.nn.functional as F

    a = F.relu(x + bias.to(x.dtype)[:, None, None])
    if not train:
        return F.batch_norm(a.float(), running[0], running[1], gamma, beta, False, 0.0,
                            1e-3).to(x.dtype)
    xf = a.float()
    n = xf.shape[0] * xf.shape[2] * xf.shape[3]
    mean = xf.sum((0, 2, 3)) / n
    var = torch.clamp_min((xf * xf).sum((0, 2, 3)) / n - mean * mean, 0.0)
    mul = torch.rsqrt(var + 1e-3) * gamma
    return ((xf - mean[:, None, None]) * mul[:, None, None] + beta[:, None, None]).to(x.dtype)


# TransUNet's decoder at 512^2, batch 16: conv_more and the four blocks'
# widths (K4's order after); then the packed narrow path (C 2) and the
# element path (C 3) at small shapes
K4_AFTER_SHAPES = {"conv_more": (16, 512, 32, 32), "block0": (16, 256, 64, 64),
                   "block1": (16, 128, 128, 128), "block2": (16, 64, 256, 256),
                   "block3": (16, 16, 512, 512), "packed": (4, 2, 40, 24),
                   "element": (4, 3, 40, 24)}


def k4_after_check(name: str, x, gamma, beta, gy) -> dict:
    """K4's order after (TransUNet's conv -> BatchNorm -> ReLU, no bias) on
    ``k4_inputs``: six launches counted in ``AFTER``; (b) and (d), train
    and eval, bit-equal (``torch.equal``) to their plain versions given the
    same vectors; the running statistics bit-equal to the two-line update;
    no negative y; (a) and (c) within the bound of their summation
    (:func:`k4_sum_check`, with its planted faults)."""
    import torch

    from tpuseg_torch.ops import batchnorm as bn

    after, dev, c = bn.RELU_AFTER, x.device, x.shape[1]
    running = (torch.randn(c, device=dev) * 0.3, torch.rand(c, device=dev) + 0.5)
    run = tuple(t.clone() for t in running)
    before = dict(bn.AFTER)
    stats = bn.batch_stats(x, None, after)
    y, vec = bn.bn_apply_train(x, None, after, stats, gamma, beta, 1e-5, *run, 0.9)
    sums = bn.backward_reduce(x, None, after, gy, vec[0], vec[2], vec[3], beta)
    dx, _ = bn.backward_apply_train(x, None, after, gy, stats, vec, sums, sums, beta)
    ye = bn.bn_apply_eval(x, None, after, *running, gamma, beta, 1e-5)
    rstd_e = torch.rsqrt(running[1] + 1e-5)
    mul_e = rstd_e * gamma
    zero = torch.zeros_like(gamma)
    dxe = bn.backward_apply(x, None, after, gy, running[0], rstd_e, mul_e, zero, zero, beta)
    torch.cuda.synchronize()
    if bn.AFTER["launches"] != before["launches"] + 6:
        raise AssertionError(f"K4 after {name}: launches {bn.AFTER} after {before}")
    mean, rstd, mul = vec[0], vec[2], vec[3]
    k1 = sums[0] / stats[2]
    k2 = torch.where(vec[4] != 0, sums[1] / stats[2], 0.0)
    plain = {"apply": bn._apply_plain(x, None, after, mean, mul, beta),
             "backward_apply": bn._backward_apply_plain(x, None, after, gy, mean, rstd, mul,
                                                        k1, k2, beta),
             "eval_apply": bn._apply_eval_plain(x, None, after, *running, gamma, beta, 1e-5),
             "eval_backward_apply": bn._backward_apply_plain(
                 x, None, after, gy, running[0], rstd_e, mul_e, zero, zero, beta)}
    got = {"apply": y, "backward_apply": dx, "eval_apply": ye, "eval_backward_apply": dxe}
    differ = [k for k in got if not torch.equal(got[k], plain[k])]
    if differ:
        raise AssertionError(f"K4 after {name}: {differ} differ from the plain versions")
    if not (torch.equal(run[0], 0.9 * running[0] + (1 - 0.9) * mean)
            and torch.equal(run[1], 0.9 * running[1] + (1 - 0.9) * vec[1])):
        raise AssertionError(f"K4 after {name}: the running statistics differ from the "
                             "two-line update")
    if bool((y < 0).any()):
        raise AssertionError(f"K4 after {name}: (b) wrote a negative y")
    kept = float((plain["apply"] > 0).float().mean())
    del y, dx, ye, dxe, plain, got

    def rows(t):  # f32 [C, M], in the kernel's row order
        return t.float().permute(1, 0, 2, 3).reshape(c, -1)

    def gprime():  # g' as the kernel takes it: g where relu(y) > 0
        ypre = bn._apply_plain(x, None, bn.RELU_NONE, mean, mul, beta)
        return rows(torch.where(ypre <= 0, torch.zeros((), dtype=gy.dtype, device=dev),
                                gy)).double()

    def ahat():
        return (rows(x) - mean[:, None]) * rstd[:, None]

    check_a = k4_sum_check(f"after {name} stats", stats[:2], bn._stats_plain(x, None, after),
                           [lambda: rows(x).double(), lambda: rows(x).double() ** 2],
                           bn.reduce_plan(x, bn.row_stride(x)))
    check_c = k4_sum_check(f"after {name} backward reduce", sums,
                           bn._backward_reduce_plain(x, None, after, gy, mean, rstd, mul, beta),
                           [gprime, lambda: gprime() * ahat().double()],
                           bn.reduce_plan(x, bn.row_stride(x), gy, bn.row_stride(gy), 2))
    return {"kept_share": kept, "sum_check": {"stats": check_a, "backward_reduce": check_c}}


K4_AFTER_CASES = [(k, "bfloat16") for k in K4_AFTER_SHAPES] + [("block3", "float32")]


def k4_after(seed: int, dev) -> dict:
    """K4's order after at the decoder's shapes, bf16 (and block3 in f32
    too), checked (:func:`k4_after_check`); each layer's four kernels timed
    against their plain versions (:func:`events_ms_cold`), with the bytes
    they must move at the card's rate as the bound. Run it alone with
    ``python -c "import torch, chip_smoke; chip_smoke.k4_after(0,
    torch.device('cuda'))"``."""
    import torch

    from tpuseg_torch.ops import batchnorm as bn

    after = bn.RELU_AFTER
    out = {"cases": {}}
    for i, (where, dtype) in enumerate(K4_AFTER_CASES):
        shape = K4_AFTER_SHAPES[where]
        name = f"{where}_{dtype}"
        x, _, gamma, beta, gy = k4_inputs(shape, getattr(torch, dtype), seed + 100 + i, dev)
        check = k4_after_check(name, x, gamma, beta, gy)
        run = (torch.zeros(shape[1], device=dev), torch.ones(shape[1], device=dev))
        stats = bn.batch_stats(x, None, after)
        vec = bn.bn_apply_train(x, None, after, stats, gamma, beta, 1e-5)[1]
        mean, rstd, mul = vec[0], vec[2], vec[3]
        sums = bn.backward_reduce(x, None, after, gy, mean, rstd, mul, beta)
        fns = {
            "kernel_stats": (lambda: bn.batch_stats(x, None, after), 10),
            "kernel_apply": (lambda: bn.bn_apply_train(x, None, after, stats, gamma, beta, 1e-5,
                                                       *run, 0.9), 10),
            "kernel_backward_reduce": (lambda: bn.backward_reduce(
                x, None, after, gy, mean, rstd, mul, beta), 10),
            "kernel_backward_apply": (lambda: bn.backward_apply_train(
                x, None, after, gy, stats, vec, sums, sums, beta), 10),
            "plain_stats": (lambda: bn._stats_count_plain(x, None, after), 3),
            "plain_apply": (lambda: bn._apply_train_plain(x, None, after, stats, gamma, beta,
                                                          1e-5, *run, 0.9), 3),
            "plain_backward_reduce": (lambda: bn._backward_reduce_plain(
                x, None, after, gy, mean, rstd, mul, beta), 3),
            "plain_backward_apply": (lambda: bn._backward_apply_train_plain(
                x, None, after, gy, stats, vec, sums, sums, beta), 3),
        }
        ms = {k: events_ms_cold(fn, reps) for k, (fn, reps) in fns.items()}
        act = x.numel() * x.element_size()
        share = {k: bytes_ms(bench("work.k4").TENSORS[k] * act) / ms[f"kernel_{k}"]
                 for k in K4_KINDS}
        out["cases"][name] = {"shape": list(shape), "dtype": str(getattr(torch, dtype)),
                              "ms": ms, "share_of_bound": share, **check}
        log(f"K4 after {name} {tuple(shape)}: (b), (d) train and eval bit-equal to plain; "
            f"(a), (c) within their summation bound; {check['kept_share']:.1%} of y above 0; "
            "ms " + ", ".join(f"{k} {ms['kernel_' + k]:.4f} ({share[k]:.1%} of its bound; "
                              f"plain {ms['plain_' + k]:.3f})" for k in K4_KINDS))
        del x, gamma, beta, gy, fns
        torch.cuda.empty_cache()
    return out


def k4_check(name: str, x, bias, gamma, beta, gy) -> dict:
    """K4's four kernels on ``k4_inputs`` as a conv block feeds them (bias
    and ReLU on), (b) and (d) in their train forms: one launch each; (a)'s
    count row; (b) and (d) bit-equal (``torch.equal``) to their plain
    versions given the same vectors, and channels-last; what they derive
    (:func:`k4_vector_check`); (a) and (c) within the bound of the summation
    they do, from the library's plan, of the float64 sums (stated in
    :func:`k4_sum_check`, not tuned; planted faults must fail it); the
    reductions the same bits twice more."""
    import torch

    from tpuseg_torch.ops import batchnorm as bn

    dev = x.device
    n, c = x.shape[0] * x.shape[2] * x.shape[3], x.shape[1]
    before = dict(bn.LAUNCHES)
    running = (torch.randn(c, device=dev) * 0.3, torch.rand(c, device=dev) + 0.5)
    run = tuple(t.clone() for t in running)
    stats = bn.batch_stats(x, bias, True)
    y, vec = bn.bn_apply_train(x, bias, True, stats, gamma, beta, 1e-3, *run, 0.99)
    sums = bn.backward_reduce(x, bias, True, gy, vec[0], vec[2])
    dx, dbias = bn.backward_apply_train(x, bias, True, gy, stats, vec, sums, sums)
    torch.cuda.synchronize()
    if any(bn.LAUNCHES[k] != before[k] + 1 for k in K4_KINDS):
        raise AssertionError(f"K4 {name}: launches {bn.LAUNCHES} after {before}")
    if not bool((stats[2] == n).all()):
        raise AssertionError(f"K4 {name}: (a)'s count row {stats[2].unique()} is not {n}")
    vectors = k4_vector_check(name, x, bias, gy, gamma, beta, stats, vec, sums, dx, dbias,
                              running, run)
    mean, rstd, mul = vec[0], vec[2], vec[3]
    k1 = sums[0] / stats[2]
    k2 = torch.where(vec[4] != 0, sums[1] / stats[2], 0.0)
    y_plain = bn._apply_plain(x, bias, True, mean, mul, beta)
    dx_plain = bn._backward_apply_plain(x, bias, True, gy, mean, rstd, mul, k1, k2)
    if not (torch.equal(y, y_plain) and torch.equal(dx, dx_plain)):
        raise AssertionError(f"K4 {name}: (b) or (d) differs from its plain version")
    elt_err = {"apply": (y.float() - y_plain.float()).abs().max().item(),
               "backward_apply": (dx.float() - dx_plain.float()).abs().max().item()}
    del y_plain, dx_plain
    if bn.row_stride(y) != c or bn.row_stride(dx) != c:
        raise AssertionError(f"K4 {name}: outputs not channels-last")
    del y, dx
    for _ in range(2):
        if not (torch.equal(bn.batch_stats(x, bias, True), stats) and torch.equal(
                bn.backward_reduce(x, bias, True, gy, mean, rstd), sums)):
            raise AssertionError(f"K4 {name}: a reduction changed from launch to launch")

    def act():  # a as f32 [C, M], in the kernel's row order
        return bn.activation(x, bias, True).float().permute(1, 0, 2, 3).reshape(c, -1)

    def ahat():  # rounded as the kernel rounds it
        return (act() - mean[:, None]) * rstd[:, None]

    def grad():
        return gy.permute(1, 0, 2, 3).reshape(c, -1).double()

    def pos():
        return act() > 0

    check_a = k4_sum_check(f"{name} stats", stats[:2], bn._stats_plain(x, bias, True),
                           [lambda: act().double(), lambda: act().double() ** 2],
                           bn.reduce_plan(x, bn.row_stride(x)))
    check_c = k4_sum_check(
        f"{name} backward reduce", sums,
        bn._backward_reduce_plain(x, bias, True, gy, mean, rstd),
        [grad, lambda: grad() * ahat().double(),
         lambda: torch.where(pos(), grad(), 0.0), lambda: pos().double(),
         lambda: torch.where(pos(), ahat(), 0.0).double()],
        bn.reduce_plan(x, bn.row_stride(x), gy, bn.row_stride(gy), 5))
    torch.cuda.empty_cache()
    return {"vectors": vectors,
            "max_abs_err": {"stats": check_a["max_abs_err"], **elt_err,
                            "backward_reduce": check_c["max_abs_err"]},
            "sum_check": {"stats": check_a, "backward_reduce": check_c},
            "clipped_channels": int((vec[4] == 0).sum())}


def phase_batchnorm(seed: int, dev) -> dict:
    """K4 at the training main path's shapes, enc1's [8, 64, 512, 512] and the
    head's [8, 2, 512, 512], bf16 (the main path's) and f32, as a conv
    block feeds it (bias and ReLU on), checked (:func:`k4_check`); then
    each kernel, its plain version, one PyTorch call that computes its
    function on the same inputs (PyTorch's own sync-BN kernels:
    ``torch.batch_norm_stats``, ``batch_norm_elemt``,
    ``batch_norm_backward_reduce``, ``batch_norm_backward_elemt``; BN
    alone, without the bias and ReLU, so less work), ``F.batch_norm`` in
    train forward, eval forward and backward (BN alone too), and the eager
    chain K4 replaced, timed in turns with the L2 flushed by CUDA events
    around each call (:func:`events_ms_cold`). Each kernel's bound: the
    bytes it must move (x read, g read, the output written; (a) and (c)
    read only) at the card's memory rate."""
    import torch
    import torch.nn.functional as F

    from tpuseg_torch.ops import batchnorm as bn

    out = {"build": build_report("batchnorm", "bn_", spill_fails=False), "cases": {}}
    empty = events_ms_cold(lambda: torch.cuda._sleep(0), 20)
    out["empty_launch_ms"] = empty
    log(f"K4: an empty launch (torch.cuda._sleep(0)) {empty * 1e3:.2f} us (CUDA events, as "
        f"the kernels)")
    for (where, shape), dtype in [(k, d) for k in K4_SHAPES.items()
                                  for d in (torch.bfloat16, torch.float32)]:
        name = f"{where}_{str(dtype).split('.')[-1]}"
        x, bias, gamma, beta, gy = k4_inputs(shape, dtype, seed + len(out["cases"]), dev)
        check = k4_check(name, x, bias, gamma, beta, gy)
        check_a, check_c = check["sum_check"]["stats"], check["sum_check"]["backward_reduce"]
        n = shape[0] * shape[2] * shape[3]
        running = run = (torch.zeros(shape[1], device=dev), torch.ones(shape[1], device=dev))
        stats = bn.batch_stats(x, bias, True)
        vec = bn.bn_apply_train(x, bias, True, stats, gamma, beta, 1e-3)[1]
        mean, rstd = vec[0], vec[2]
        sums = bn.backward_reduce(x, bias, True, gy, mean, rstd)
        count = torch.tensor([n], dtype=torch.int32, device=dev)
        xr = x.detach().requires_grad_()
        g_, b_ = gamma.detach().requires_grad_(), beta.detach().requires_grad_()
        y_lib = F.batch_norm(xr, running[0].clone(), running[1].clone(), g_, b_, True, 0.01, 1e-3)
        xe = x.detach().requires_grad_()
        bias_e, gamma_e, beta_e = (t.detach().requires_grad_() for t in (bias, gamma, beta))
        y_eager = eager_batchnorm(xe, bias_e, gamma_e, beta_e, running, True)
        # (b) and (d) timed in their train forms (the main path's): the
        # vectors derived in the prologue, the running statistics updated
        fns = {
            "kernel_stats": (lambda: bn.batch_stats(x, bias, True), 10),
            "kernel_apply": (lambda: bn.bn_apply_train(x, bias, True, stats, gamma, beta, 1e-3,
                                                       *run, 0.99), 10),
            "kernel_backward_reduce": (
                lambda: bn.backward_reduce(x, bias, True, gy, mean, rstd), 10),
            "kernel_backward_apply": (lambda: bn.backward_apply_train(
                x, bias, True, gy, stats, vec, sums, sums), 10),
            "plain_stats": (lambda: bn._stats_count_plain(x, bias, True), 3),
            "plain_apply": (lambda: bn._apply_train_plain(x, bias, True, stats, gamma, beta,
                                                          1e-3, *run, 0.99), 3),
            "plain_backward_reduce": (
                lambda: bn._backward_reduce_plain(x, bias, True, gy, mean, rstd), 3),
            "plain_backward_apply": (lambda: bn._backward_apply_train_plain(
                x, bias, True, gy, stats, vec, sums, sums), 3),
            "library_stats": (lambda: torch.batch_norm_stats(x, 1e-3), 10),
            "library_apply": (lambda: torch.batch_norm_elemt(x, gamma, beta, mean, rstd, 1e-3),
                              10),
            "library_backward_reduce": (lambda: torch.batch_norm_backward_reduce(
                gy, x, mean, rstd, gamma, True, True, True), 10),
            "library_backward_apply": (lambda: torch.batch_norm_backward_elemt(
                gy, x, mean, rstd, gamma, sums[0], sums[1], count), 10),
            "F.batch_norm_train_forward": (lambda: F.batch_norm(
                x, running[0].clone(), running[1].clone(), gamma, beta, True, 0.01, 1e-3), 10),
            "F.batch_norm_eval_forward": (lambda: F.batch_norm(
                x, running[0], running[1], gamma, beta, False, 0.0, 1e-3), 10),
            "F.batch_norm_backward": (lambda: torch.autograd.grad(
                y_lib, (xr, g_, b_), gy, retain_graph=True), 10),
            "eager_train_forward": (
                lambda: eager_batchnorm(x, bias, gamma, beta, running, True), 3),
            "eager_eval_forward": (
                lambda: eager_batchnorm(x, bias, gamma, beta, running, False), 3),
            "eager_backward": (lambda: torch.autograd.grad(
                y_eager, (xe, bias_e, gamma_e, beta_e), gy, retain_graph=True), 3),
        }
        runs = {k: [] for k in fns}
        for order in (list(fns), list(fns)[::-1]):
            for k in order:
                fn, reps = fns[k]
                runs[k].append(events_ms_cold(fn, reps))
        ms = {k: sum(v) / 2 for k, v in runs.items()}
        es = x.element_size()
        act = n * shape[1] * es
        moved = {k: bench("work.k4").TENSORS[k] * act for k in K4_KINDS}
        r = {"shape": list(shape), "dtype": str(dtype), "ms": ms, "ms_runs": runs, **check,
             "bytes": moved, "bound_ms": {k: bytes_ms(b) for k, b in moved.items()}}
        r["share_of_bound"] = {k: r["bound_ms"][k] / ms[f"kernel_{k}"] for k in K4_KINDS}
        # a kernel too small for half its bound is held to its bound plus
        # an empty kernel's launch plus 2 us (reported, not gated: a time)
        r["within_target"] = {k: r["share_of_bound"][k] >= 0.5 or ms[f"kernel_{k}"] <= (
            r["bound_ms"][k] + out["empty_launch_ms"] + 0.002) for k in K4_KINDS}
        out["cases"][name] = r
        log(f"K4 {name} {tuple(shape)}: (b), (d) bit-equal to plain; (a), (c) within the "
            f"bound of their summation (depth {check_a['depth']}, {check_c['depth']}; largest "
            f"errors {check_a['max_abs_err']:.3g}, {check_c['max_abs_err']:.3g}, at most "
            f"{max(check_a['share_of_bound'], check_c['share_of_bound']):.3g} of the bound; "
            f"plain f32 sums within twice it; {check_a['faults_caught']} + "
            f"{check_c['faults_caught']} planted faults caught); deterministic; "
            f"{check['clipped_channels']} channels clipped")
        v = check["vectors"]
        log(f"  vectors: mean, var and mask bit-equal to finalize, group and none; rstd and "
            f"mul {v['rstd_ulps']} and {v['mul_ulps']} ulps off torch.rsqrt's "
            f"(gate {K4_RSQRT_ULPS}); running statistics, k1, k2 and dbias bit-equal")
        log("  ms: " + ", ".join(
            f"{k} {ms['kernel_' + k]:.4f} ({r['share_of_bound'][k]:.1%} of "
            f"{r['bound_ms'][k]:.4f}; plain {ms['plain_' + k]:.3f}, library "
            f"{ms['library_' + k]:.4f})" for k in K4_KINDS))
        log("  F.batch_norm train fwd {:.4f}, eval fwd {:.4f}, backward {:.4f}; the eager chain "
            "it replaced: train fwd {:.3f}, eval fwd {:.3f}, backward {:.3f}".format(
                ms["F.batch_norm_train_forward"], ms["F.batch_norm_eval_forward"],
                ms["F.batch_norm_backward"], ms["eager_train_forward"],
                ms["eager_eval_forward"], ms["eager_backward"]))
        del x, bias, gamma, beta, gy, xr, y_lib, xe, y_eager, fns
        torch.cuda.empty_cache()
    out["max_abs_err"] = {k: max(r["max_abs_err"][k] for r in out["cases"].values())
                          for k in K4_KINDS}
    out["forms"] = k4_forms(seed, dev)
    out["train_forms"] = k4_train_forms(seed, dev)
    out["after"] = k4_after(seed, dev)
    return out


def k4_form_inputs(seed: int, dev):
    """(b)'s eval arguments at ``K4_FORM_SHAPE`` (bf16, bias and ReLU on,
    running statistics), and the deconv's half of the concat buffer."""
    import torch

    c = K4_FORM_SHAPE[1]
    x, bias, gamma, beta, _ = k4_inputs(K4_FORM_SHAPE, torch.bfloat16, seed, dev)
    up = k4_inputs(K4_FORM_SHAPE, torch.bfloat16, seed + 1, dev)[0]
    g = torch.Generator(device=dev).manual_seed(seed + 2)
    rm = torch.randn(c, generator=g, device=dev) * 0.3
    rv = torch.rand(c, generator=g, device=dev) * 1.5 + 0.5
    return (x, bias, True, rm, rv, gamma, beta, 1e-3), up


def k4_forms_check(args: tuple, up) -> dict:
    """(b)'s eval store forms on ``k4_form_inputs``: the slice form (y into
    the first half of the level's concat buffer), then the pooled form
    (also the 2x2/2 max), held bit for bit to the eager ops they replace,
    (b) alone followed by ``torch.cat`` with the deconv half and
    ``F.max_pool2d``."""
    import torch
    import torch.nn.functional as F

    from tpuseg_torch.ops import batchnorm as bn

    x = args[0]
    n, c, h, w = x.shape
    buf = torch.empty((n, 2 * c, h, w), dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last)
    y_old = bn.bn_apply_eval(*args)
    want_pool = F.max_pool2d(y_old, 2)
    want_cat = torch.cat([y_old, up], 1)
    buf[:, c:].copy_(up)

    def bits(t):
        return t.contiguous().view(torch.int16)

    bn.bn_apply_eval(*args, out=buf[:, :c])
    slice_equal = torch.equal(bits(buf), bits(want_cat))
    buf[:, :c].zero_()
    _, pooled = bn.bn_apply_eval(*args, out=buf[:, :c], pool=True)
    pool_equal = torch.equal(bits(buf), bits(want_cat)) and torch.equal(bits(pooled),
                                                                        bits(want_pool))
    if not (slice_equal and pool_equal):
        raise AssertionError(f"K4's store forms differ from (b) + torch.cat + F.max_pool2d: "
                             f"slice {slice_equal}, pooled {pool_equal}")
    return {"bit_equal": True}


def k4_forms(seed: int, dev) -> dict:
    """K4's eval store forms at enc1b of a serving call (``K4_FORM_SHAPE``,
    bf16, bias and ReLU on), checked (:func:`k4_forms_check`); then each form,
    (b) alone, the max pool and the concat timed in turns with the L2
    flushed (:func:`events_ms_cold`), each beside its bytes at the card's
    memory rate (slice: x and y; pooled: x, y and y/4; the pool: y and y/4;
    the concat: both halves read and written). The old path's share of a
    skip is (b) + the pool + half the concat."""
    import torch
    import torch.nn.functional as F

    from tpuseg_torch.ops import batchnorm as bn

    n, c, h, w = K4_FORM_SHAPE
    args, up = k4_form_inputs(seed, dev)
    check = k4_forms_check(args, up)
    torch.cuda.empty_cache()
    x = args[0]
    buf = torch.empty((n, 2 * c, h, w), dtype=x.dtype, device=dev,
                      memory_format=torch.channels_last)
    y_old = bn.bn_apply_eval(*args)
    fns = {"form_pool": lambda: bn.bn_apply_eval(*args, out=buf[:, :c], pool=True),
           "form_slice": lambda: bn.bn_apply_eval(*args, out=buf[:, :c]),
           "apply": lambda: bn.bn_apply_eval(*args),
           "max_pool": lambda: F.max_pool2d(y_old, 2),
           "cat": lambda: torch.cat([y_old, up], 1)}
    runs = {k: [] for k in fns}
    for order in (list(fns), list(fns)[::-1]):
        for k in order:
            runs[k].append(events_ms_cold(fns[k], 10))
    ms = {k: sum(v) / 2 for k, v in runs.items()}
    act = n * c * h * w * x.element_size()
    moved = {"form_pool": 2.25 * act, "form_slice": 2 * act, "apply": 2 * act,
             "max_pool": 1.25 * act, "cat": 4 * act}
    bound = {k: bytes_ms(b) for k, b in moved.items()}
    old = ms["apply"] + ms["max_pool"] + ms["cat"] / 2
    out = {"shape": list(K4_FORM_SHAPE), "dtype": "torch.bfloat16", "ms": ms, "ms_runs": runs,
           "bound_ms": bound, "share_of_bound": {k: bound[k] / ms[k] for k in ms},
           "old_skip_ms": old, **check}
    log(f"K4 store forms {K4_FORM_SHAPE} bf16, bit-equal to (b) + torch.cat + F.max_pool2d; "
        "ms: " + ", ".join(f"{k} {ms[k]:.4f} ({out['share_of_bound'][k]:.1%} of "
                           f"{bound[k]:.4f})" for k in fns)
        + f"; the old skip: (b) + pool + half the concat {old:.4f}")
    del x, up, buf, y_old, fns
    torch.cuda.empty_cache()
    return out


K4_TRAIN_FORM_SHAPE = (16, BASE, 512, 512)  # enc1b of a batch-16, 512^2 train step


def k4_pooled_backward_check(x, bias, beta, gs, gp, stats, vec) -> dict:
    """The pooled (c) and (d) of a skip's producer (bias and ReLU on; (a)'s
    ``stats``, (b)'s ``vec``) on the slice's gradient ``gs`` and the pooled
    output's ``gp``, against the eager path they replace (the pool's
    backward on (b)'s y, autograd's add, (c) and (d)): one launch of (d) and
    two of (c), the same bits, in the pooled form; the pooled gradient
    bit-equal to ``_pooled_gradient``'s; the pooled (d) bit-equal to its
    plain version given the same sums; the pooled (c)'s sums within the
    bound of its own plan of the float64 sums of that gradient's terms
    (:func:`k4_sum_check`: the plain pooled (c) within twice it, and (c) on
    the slice's gradient alone, what a pooled (c) that dropped gp gives,
    among the planted faults), and within 1e-4 of their largest of (c) on
    the eager path's gradient, where gp dropped must fall outside."""
    import torch
    import torch.nn.functional as F

    from tpuseg_torch.ops import batchnorm as bn

    c = x.shape[1]
    mean, rstd, mul = vec[0], vec[2], vec[3]
    before, forms = dict(bn.LAUNCHES), bn.TRAIN_FORMS["pooled_backward"]
    sums = bn.backward_reduce(x, bias, True, gs, mean, rstd, mul, beta, gp=gp)
    again = bn.backward_reduce(x, bias, True, gs, mean, rstd, mul, beta, gp=gp)
    dx, dbias = bn.backward_apply_train(x, bias, True, gs, stats, vec, sums, sums, beta, gp=gp)
    torch.cuda.synchronize()
    launched = [bn.LAUNCHES[k] - before[k] for k in ("backward_reduce", "backward_apply")]
    if launched != [2, 1] or bn.TRAIN_FORMS["pooled_backward"] != forms + 1:
        raise AssertionError(f"K4's pooled backward: {launched} launches of (c) and (d), "
                             f"{bn.TRAIN_FORMS['pooled_backward'] - forms} pooled")
    want_dx, want_dbias = bn._backward_apply_train_plain(x, bias, True, gs, stats, vec, sums,
                                                         sums, beta, gp=gp)
    y = bn._apply_plain(x, bias, True, mean, mul, beta)
    idx = F.max_pool2d(y, 2, return_indices=True)[1]
    geff = gs + torch.ops.aten.max_pool2d_with_indices_backward(gp, y, [2, 2], [2, 2], [0, 0],
                                                                [1, 1], False, idx)
    checks = {"same_bits": torch.equal(sums, again),
              "dx": torch.equal(bits(dx), bits(want_dx)) and torch.equal(dbias, want_dbias),
              "pooled_gradient": torch.equal(
                  bits(geff), bits(bn._pooled_gradient(x, bias, True, gs, gp, mean, mul, beta)))}
    del y, idx, dx, want_dx, again
    eager = bn.backward_reduce(x, bias, True, geff, mean, rstd)
    dropped = bn.backward_reduce(x, bias, True, gs, mean, rstd)

    def gap(a):
        return float(((a - eager).abs() / eager.abs().amax(1, keepdim=True)).max())

    sums_gap, dropped_gap = gap(sums), gap(dropped)
    if not all(checks.values()) or sums_gap > 1e-4 or dropped_gap <= 1e-4:
        raise AssertionError(f"K4's pooled backward differs from the eager path: {checks}, sums "
                             f"{sums_gap:.3g} of their largest (gp dropped: {dropped_gap:.3g})")

    def act():  # a as f32 [C, M], in the kernel's row order
        return bn.activation(x, bias, True).float().permute(1, 0, 2, 3).reshape(c, -1)

    def ahat():  # rounded as the kernel rounds it
        return (act() - mean[:, None]) * rstd[:, None]

    def grad():  # the pooled gradient, checked above to be the one the kernel forms
        return geff.float().permute(1, 0, 2, 3).reshape(c, -1).double()

    def pos():
        return act() > 0

    sum_check = k4_sum_check(
        "pooled backward reduce", sums,
        bn._backward_reduce_plain(x, bias, True, gs, mean, rstd, mul, beta, gp=gp),
        [grad, lambda: grad() * ahat().double(), lambda: torch.where(pos(), grad(), 0.0),
         lambda: pos().double(), lambda: torch.where(pos(), ahat(), 0.0).double()],
        bn.reduce_plan(x, bn.row_stride(x), gs, bn.row_stride(gs), 5, gp=gp),
        {"gp dropped": dropped.double()})
    del geff
    torch.cuda.empty_cache()
    return {"checks": checks, "sums_gap": sums_gap, "dropped_gap": dropped_gap,
            "sum_check": sum_check}


def k4_train_forms_check(x, bias, gamma, beta, up, gcat, gp) -> dict:
    """K4's train forms of a skip's producer (bias and ReLU on) and of the
    deconv beside it (``up``, neither), against the eager path they
    replace: (b)'s pooled form and the deconv's slice form write the concat
    buffer (two launches, counted in ``TRAIN_FORMS``; each leaves the other
    half as it was) and the pooled output bit-equal to ``torch.cat`` and
    ``F.max_pool2d`` of (b)'s output without forms, with the same vectors
    and running statistics, and that output to (b)'s plain version; then
    the pooled backward on the concat buffer's gradient ``gcat`` and the
    pooled output's ``gp`` (:func:`k4_pooled_backward_check`)."""
    import torch
    import torch.nn.functional as F

    from tpuseg_torch.ops import batchnorm as bn

    n, c, h, w = x.shape
    dev = x.device
    stats, up_stats = bn.batch_stats(x, bias, True), bn.batch_stats(up, None, False)
    run = [torch.rand(c, device=dev) + 0.5 for _ in range(4)]
    want_run = [r.clone() for r in run]
    y_old, want_vec = bn.bn_apply_train(x, bias, True, stats, gamma, beta, 1e-3, *want_run[:2],
                                        0.99)
    up_old, _ = bn.bn_apply_train(up, None, False, up_stats, gamma, beta, 1e-3, *want_run[2:],
                                  0.99)
    buf = torch.full((n, 2 * c, h, w), 7.0, dtype=x.dtype, device=dev).contiguous(
        memory_format=torch.channels_last)
    before, forms = bn.LAUNCHES["apply"], dict(bn.TRAIN_FORMS)
    (y, pooled), vec = bn.bn_apply_train(x, bias, True, stats, gamma, beta, 1e-3, *run[:2], 0.99,
                                         out=buf[:, :c], pool=True)
    other_half = torch.equal(bits(buf[:, c:]), bits(torch.full_like(up_old, 7.0)))
    bn.bn_apply_train(up, None, False, up_stats, gamma, beta, 1e-3, *run[2:], 0.99,
                      out=buf[:, c:])
    torch.cuda.synchronize()
    counted = {k: bn.TRAIN_FORMS[k] - forms[k] for k in forms}
    checks = {
        "plain": torch.equal(bits(y_old), bits(bn._apply_plain(x, bias, True, want_vec[0],
                                                               want_vec[3], beta))),
        "launches": bn.LAUNCHES["apply"] == before + 2 and y.data_ptr() == buf.data_ptr()
        and counted == {"slice": 2, "pool": 1, "pooled_backward": 0},
        "other_half": other_half,
        "concat": torch.equal(bits(buf), bits(torch.cat([y_old, up_old], 1))),
        "pooled": bn.row_stride(pooled) == c
        and torch.equal(bits(pooled), bits(F.max_pool2d(y_old, 2))),
        "vectors": torch.equal(vec, want_vec)
        and all(torch.equal(a, r) for a, r in zip(run, want_run))}
    if not all(checks.values()):
        raise AssertionError(f"K4's train forms differ from the eager path: {checks}")
    del y_old, up_old, buf, y, pooled
    torch.cuda.empty_cache()
    res = k4_pooled_backward_check(x, bias, beta, gcat[:, :c], gp, stats, vec)
    return {**res, "checks": {**checks, **res["checks"]}}


def k4_train_forms(seed: int, dev) -> dict:
    """K4's train forms at enc1b of a batch-16, 512^2 train step
    (``K4_TRAIN_FORM_SHAPE``, bf16, bias and ReLU on) against the eager path
    they replace (:func:`k4_train_forms_check`): forward, (b) then
    ``F.max_pool2d`` with its indices and half a ``torch.cat``, against
    (b)'s pooled form into the concat buffer; backward, the pool's
    backward, autograd's add of the skip's two gradients, (c) and (d),
    against the pooled (c) and (d). Then each call timed in turns with the
    L2 flushed (:func:`events_ms_cold`), beside its bytes at the card's
    memory rate (in activations: (b) 2 and pooled 2.25; the pool 1.25 +
    int64 indices 1; its backward 0.25 + 1 + 1; the add 3; (c) 2 and pooled
    2.25; (d) 3 and pooled 3.25)."""
    import torch
    import torch.nn.functional as F

    from tpuseg_torch.ops import batchnorm as bn

    n, c, h, w = K4_TRAIN_FORM_SHAPE
    bf16 = torch.bfloat16
    x, bias, gamma, beta, _ = k4_inputs(K4_TRAIN_FORM_SHAPE, bf16, seed, dev)
    up = k4_inputs(K4_TRAIN_FORM_SHAPE, bf16, seed + 1, dev)[0]
    g = torch.Generator(device=dev).manual_seed(seed + 2)

    def rows(ch, hh, ww):
        return (torch.randn((n, hh, ww, ch), generator=g, device=dev) * 1e-3).to(bf16).permute(
            0, 3, 1, 2)

    gcat, gp = rows(2 * c, h, w), rows(c, h // 2, w // 2)
    check = k4_train_forms_check(x, bias, gamma, beta, up, gcat, gp)
    gs = gcat[:, :c]
    buf = torch.empty((n, 2 * c, h, w), dtype=bf16, device=dev, memory_format=torch.channels_last)
    stats = bn.batch_stats(x, bias, True)
    y, vec = bn.bn_apply_train(x, bias, True, stats, gamma, beta, 1e-3)
    idx = F.max_pool2d(y, 2, return_indices=True)[1]
    sums = bn.backward_reduce(x, bias, True, gs, vec[0], vec[2], vec[3], beta, gp=gp)

    def pool_backward():
        return torch.ops.aten.max_pool2d_with_indices_backward(gp, y, [2, 2], [2, 2], [0, 0],
                                                               [1, 1], False, idx)

    fns = {"apply": lambda: bn.bn_apply_train(x, bias, True, stats, gamma, beta, 1e-3),
           "form_pool": lambda: bn.bn_apply_train(x, bias, True, stats, gamma, beta, 1e-3,
                                                  out=buf[:, :c], pool=True),
           "max_pool": lambda: F.max_pool2d(y, 2, return_indices=True),
           "cat": lambda: torch.cat([y, up], 1),
           "pool_backward": pool_backward,
           "add": lambda: gs + pooled_grad,
           "reduce": lambda: bn.backward_reduce(x, bias, True, gs, vec[0], vec[2]),
           "apply_backward": lambda: bn.backward_apply_train(x, bias, True, gs, stats, vec, sums,
                                                             sums),
           "reduce_pooled": lambda: bn.backward_reduce(x, bias, True, gs, vec[0], vec[2], vec[3],
                                                       beta, gp=gp),
           "apply_backward_pooled": lambda: bn.backward_apply_train(x, bias, True, gs, stats, vec,
                                                                    sums, sums, beta, gp=gp)}
    pooled_grad = pool_backward()
    runs = {k: [] for k in fns}
    for order in (list(fns), list(fns)[::-1]):
        for k in order:
            runs[k].append(events_ms_cold(fns[k], 10))
    ms = {k: sum(v) / 2 for k, v in runs.items()}
    act = n * c * h * w * x.element_size()
    moved = {"apply": 2, "form_pool": 2.25, "max_pool": 2.25, "cat": 4, "pool_backward": 2.25,
             "add": 3, "reduce": 2, "apply_backward": 3, "reduce_pooled": 2.25,
             "apply_backward_pooled": 3.25}
    bound = {k: bytes_ms(moved[k] * act) for k in moved}
    old = {"forward": ms["apply"] + ms["max_pool"] + ms["cat"] / 2,
           "backward": ms["pool_backward"] + ms["add"] + ms["reduce"] + ms["apply_backward"]}
    new = {"forward": ms["form_pool"], "backward": ms["reduce_pooled"]
           + ms["apply_backward_pooled"]}
    out = {"shape": list(K4_TRAIN_FORM_SHAPE), "dtype": "torch.bfloat16", "ms": ms,
           "ms_runs": runs, "bound_ms": bound, "share_of_bound": {k: bound[k] / ms[k] for k in ms},
           "old_ms": old, "new_ms": new, **check}
    log(f"K4 train forms {K4_TRAIN_FORM_SHAPE} bf16, checked; ms: "
        + ", ".join(f"{k} {ms[k]:.4f} ({out['share_of_bound'][k]:.1%} of {bound[k]:.4f})"
                    for k in fns)
        + f"; a skip's forward {old['forward']:.4f} -> {new['forward']:.4f}, backward "
          f"{old['backward']:.4f} -> {new['backward']:.4f}; pooled (c) at "
          f"{check['sum_check']['share_of_bound']:.3g} of its bound (depth "
          f"{check['sum_check']['depth']}), sums {check['sums_gap']:.3g} off the eager path's "
          f"(gp dropped: {check['dropped_gap']:.3g})")
    del x, up, buf, y, idx, gcat, gp, fns, pooled_grad
    torch.cuda.empty_cache()
    return out


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
    from tpuseg_torch.infer import head_kernel

    dense = quant.make_quantized_predict_fn(folded, ranges)
    before = head_kernel.DENSE_LAUNCHES
    got = dense(x.to(dev)).cpu()
    launched = head_kernel.DENSE_LAUNCHES - before
    dense_agree = (got == dense(x)).double().mean().item()
    if got.shape != (2, 64, 64) or dense_agree < 0.999 or launched != 1:
        raise AssertionError(f"int8 on the card vs the CPU: shape {tuple(got.shape)}, agreement "
                             f"{dense_agree}, {launched} K6 launches (want 1)")
    log(f"reference: folded f32 rel err {logit_err:.2e}, int8_blocked card/CPU agreement {agree}, "
        f"int8 (K6) card/CPU agreement {dense_agree}")
    return {"folded_f32_rel_err": logit_err, "int8_blocked_card_vs_cpu_agree": agree,
            "int8_card_vs_cpu_agree": dense_agree}


def device_profile(run, what: str, attempts: int = 3) -> dict:
    """Where the time goes: ``run()`` under ``torch.profiler``; device time
    by kernel and by group of kernels (``trace_analysis.KERNEL_GROUPS``, the
    grouping ``python -m tpuseg_torch.utils.trace_analysis`` uses), and the
    kernels' share of the wall time (one stream, so kernel times add; the
    wall time includes the profiler's own cost). The window starts with
    :func:`profiler_lead_in`, whose spins are left out; if it saw none of
    them, ``run()`` is profiled again behind 8 times the spins, up to
    ``attempts`` windows, and after that the busy share is not measured."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpuseg_torch.utils.trace_analysis import kernel_group

    lead = LEAD_IN
    for attempt in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            profiler_lead_in(lead)
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        spins = sum(e.count for e in events if "spin_kernel" in e.key)
        kernels = sorted(((e.key, e.device_time_total / 1e3, e.count) for e in events
                          if "spin_kernel" not in e.key), key=lambda r: -r[1])
        busy_ms = sum(ms for _, ms, _ in kernels)
        if busy_ms and spins:
            break
        log(f"profile {what}, window {attempt + 1}/{attempts}: the profiler saw {busy_ms:.3f} "
            f"ms of device time and {spins} of {lead} lead-in spins")
        lead *= 8
    else:
        log(f"profile {what}: busy share not measured")
        return {"wall_ms": wall_ms, "busy_ms": None, "top": [], "by_group": {},
                "by_kernel": {}, "lead_in_seen": spins, "launches": None,
                "launches_by_group": {}}
    log(f"profile {what}: {wall_ms:.1f} ms wall, kernels {busy_ms:.1f} ms "
        f"({busy_ms / wall_ms:.1%} busy), {sum(n for _, _, n in kernels)} launches")
    groups: dict = {}
    launches: dict = {}
    for k, ms, count in kernels:
        groups[kernel_group(k)] = groups.get(kernel_group(k), 0.0) + ms
        launches[kernel_group(k)] = launches.get(kernel_group(k), 0) + count
    by_group = {g: {"ms": ms, "share": ms / busy_ms}
                for g, ms in sorted(groups.items(), key=lambda r: -r[1])}
    log("  by group: " + ", ".join(f"{g} {v['ms']:.2f} ms ({v['share']:.1%})"
                                   for g, v in by_group.items()))
    top = [{"kernel": k[:120], "ms": ms, "share": ms / busy_ms, "count": n}
           for k, ms, n in kernels[:12]]
    for r in top:
        log(f"  {r['ms']:9.2f} ms {r['share']:6.1%} x{r['count']:<5d} {r['kernel']}")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "top": top, "by_group": by_group,
            "by_kernel": {k: [ms, n] for k, ms, n in kernels}, "lead_in_seen": spins,
            "launches": sum(launches.values()), "launches_by_group": launches}


def phase_int8_head(model, cal: str, big, radius: int, stats, calls: int, dev) -> dict:
    """The dense walk with its head quantized (``fp_blocks`` without
    ``"head"``): K6's int8 route takes the place of K3's ``"relu_f32"``
    launch (21 K3 launches a predict call, not 22). One tiled pass of the
    BIG^2 image through K6 and one through its plain version: the masks
    equal on every pixel (exact int32 sums)."""
    import torch

    from tpuseg_torch.infer import head_kernel, int8_conv, quant
    from tpuseg_torch.infer.tiled import inference_tiled

    fn = quant.make_quantized_predict_fn(quant.fold_variables(model), quant.load_act_ranges(cal),
                                         fp_blocks=("enc1a",), deconv_impl=model.deconv_impl)
    head_kernel.DENSE_LAUNCHES = 0
    k3_reset()
    masks = inference_tiled(big, fn, TILE, radius, BATCH, NCLS, stats, dev)
    res = {"k6_launches": head_kernel.DENSE_LAUNCHES, "k3_launches": int8_conv.LAUNCHES,
           "route": head_kernel.LAST_ROUTE}
    if res != {"k6_launches": calls, "k3_launches": K3_PER_CALL * calls, "route": "mma"}:
        raise AssertionError(f"the tiled int8 pass with an int8 head launched {res}; want K6 "
                             f"on mma once and K3 {K3_PER_CALL} times a predict call ({calls})")
    with plain_dense_head() as plain_calls:
        masks_plain = inference_tiled(big, fn, TILE, radius, BATCH, NCLS, stats, dev)
    torch.cuda.synchronize()
    res["plain_calls"] = len(plain_calls)
    res["pixels_differing"] = int((masks != masks_plain).sum()) \
        if masks.shape == masks_plain.shape else -1
    res["class1_share"] = float((masks == 1).mean())
    if head_kernel.DENSE_LAUNCHES != calls or len(plain_calls) != calls \
            or res["pixels_differing"]:
        raise AssertionError(f"int8 head through K6 and through its plain version: {res}")
    if not 0.01 < res["class1_share"] < 0.99:
        raise AssertionError(f"class 1 takes {res['class1_share']} of the int8-head mask; the "
                             "comparison could not fail")
    log(f"int8 head (fp_blocks enc1a): K6 {calls} launches, K3 {K3_PER_CALL} a call; masks "
        f"through K6 and its plain version equal on every pixel (class 1 "
        f"{res['class1_share']:.4f})")
    return res


EDGE_KINDS = ("amax", "cat", "copy", "maximum", "other")


def edge_kernels(prof: dict) -> dict:
    """The int8 walk's eager edge ops in a profiled pass: kernels outside
    the port's own groups whose names carry int8 codes (``signed char``, or
    a 1-byte concat): the max-pool's ``amax``, the concat, the
    depth-to-space copy and the phase max. K3's store forms leave none.
    Beside them the upload's host-to-device copies."""
    from tpuseg_torch.utils.trace_analysis import kernel_group

    launches, ms = dict.fromkeys(EDGE_KINDS, 0), dict.fromkeys(EDGE_KINDS, 0.0)
    for k, (t, n) in prof["by_kernel"].items():
        if re.match(r"K\d ", kernel_group(k)) or not (
                re.search(r"(?<!un)signed char", k) or "OpaqueType<1u>" in k):
            continue
        kind = ("amax" if "ReduceOp<signed char" in k else "cat" if "CatArray" in k else
                "copy" if "direct_copy" in k else "maximum" if "maximum" in k else "other")
        launches[kind] += n
        ms[kind] += t
    upload = [(t, n) for k, (t, n) in prof["by_kernel"].items() if k.startswith("Memcpy HtoD")]
    return {"launches": launches, "ms": ms, "upload_ms": sum(t for t, _ in upload),
            "upload_copies": sum(n for _, n in upload)}


def whole_image_stitch(img, fn, radius: int, stats, dev, tile: int = TILE,
                       batch: int = BATCH, ncls: int = NCLS):
    """The tiled pass without its copy pipeline: the whole image padded,
    up at once and z-scored on the card, its windows through ``fn``
    ``batch`` at a time, every zone stitched, the cropped mask down at once
    (numpy, uint8 at <= 256 classes)."""
    import numpy as np
    import torch

    from tpuseg_torch.infer.tiled import _zor_placements

    h0, w0 = img.shape[:2]
    img = img.reshape(h0, w0, -1)
    h, w = -(-h0 // 16) * 16, -(-w0 // 16) * 16
    img = np.pad(img, ((0, h - h0), (0, w - w0), (0, 0)), mode="reflect")
    img = np.pad(img, ((0, max(0, tile - h)), (0, max(0, tile - w)), (0, 0)), mode="reflect")
    x = torch.from_numpy(img.astype(np.float32)).to(dev)
    mean, std = (torch.from_numpy(np.asarray(s, np.float32).reshape(-1)).to(dev) for s in stats)
    x = torch.where(std <= 1.0, x - mean, (x - mean) / std)
    placements = _zor_placements(h, w, tile - 2 * radius, tile, radius, img.shape[0],
                                 img.shape[1])
    mask = torch.zeros((h, w), dtype=torch.uint8 if ncls <= 256 else torch.int32, device=dev)
    for s in range(0, len(placements), batch):
        part = placements[s:s + batch]
        out = fn(torch.stack([x[ys:ys + tile, xs:xs + tile] for (_, _, _, _, ys, xs) in part]))
        for k, (i, j, ye, xe, ys, xs) in enumerate(part):
            mask[i:ye, j:xe] = out[k, i - ys:ye - ys, j - xs:xe - xs]
    return mask[:h0, :w0].cpu().numpy()


def copy_overlap(run) -> list:
    """``run()`` under ``torch.profiler``, behind :func:`profiler_lead_in`:
    :func:`copy_shares` of the window's device trace."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        profiler_lead_in(LEAD_IN)
        run()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        prof.export_chrome_trace(os.path.join(d, "trace.json"))
        with open(os.path.join(d, "trace.json")) as f:
            return copy_shares(json.load(f)["traceEvents"])


def _host_copy(e) -> bool:
    return e.get("cat") == "gpu_memcpy" and ("HtoD" in e["name"] or "DtoH" in e["name"])


def copy_shares(events) -> list:
    """Each host-device copy of at least 64 KiB among the Chrome trace's
    ``events``, in order, as ``(direction, bytes, share)``: ``HtoD``,
    ``DtoH`` or ``other``, and the part of the copy's time in which the
    card worked on something else (a kernel other than a lead-in spin, a
    copy on the card, a memset)."""
    busy = []  # the union of the card's own work, in µs
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                       if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                       and "spin_kernel" not in e["name"] and not _host_copy(e)):
        if busy and a <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], b)
        else:
            busy.append([a, b])
    out = []
    for e in sorted((e for e in events if e.get("cat") == "gpu_memcpy"
                     and e.get("args", {}).get("bytes", 0) >= 1 << 16), key=lambda e: e["ts"]):
        a, b = e["ts"], e["ts"] + e["dur"]
        ran = sum(max(0.0, min(b, y) - max(a, x)) for x, y in busy)
        out.append(("HtoD" if "HtoD" in e["name"] else "DtoH" if "DtoH" in e["name"] else "other",
                    e["args"]["bytes"], ran / max(b - a, 1e-9)))
    return out


def tiled_pipeline_check(img, fn, radius: int, stats, dev) -> dict:
    """``inference_tiled``'s copy pipeline on the card against
    :func:`whole_image_stitch` with the same predict function: masks equal
    on every pixel in two passes straight after each other (a staging
    buffer reused under a copy still in flight would show in the second),
    ``PIPELINE`` the same in both, and in the second pass's device trace
    (:func:`copy_overlap`) the copies that the schedule sends while a call
    runs did cross, for most of their time, while the card worked: every
    upload byte below the first call's read limit and every download byte
    above the last call's rows, and no other. (A copy queued behind the
    call it should overlap runs while the card waits for it: its share is
    near 0.) Raises on failure."""
    import numpy as np
    import torch

    from tpuseg_torch.infer import tiled

    want = whole_image_stitch(img, fn, radius, stats, dev)
    masks, counts = [tiled.inference_tiled(img, fn, TILE, radius, BATCH, NCLS, stats, dev)], []
    counts.append(dict(tiled.PIPELINE))
    copies = copy_overlap(lambda: masks.append(
        tiled.inference_tiled(img, fn, TILE, radius, BATCH, NCLS, stats, dev)))
    counts.append(dict(tiled.PIPELINE))
    h16, w16 = -(-img.shape[0] // 16) * 16, -(-img.shape[1] // 16) * 16  # the mask's
    h, w = max(TILE, h16), max(TILE, w16)  # the shipped image's
    plan = tiled._plan(tiled._zor_placements(h16, w16, TILE - 2 * radius, TILE, radius, h, w),
                       TILE, BATCH, img.shape[0])
    row_up = w * img.dtype.itemsize * (img.size // (img.shape[0] * img.shape[1]))
    row_down = w16 * np.dtype(np.uint8 if NCLS <= 256 else np.int32).itemsize
    last_down = [a for a, z in plan.downs if z > a][-1]
    overlapped = {d: sum(n for k, n, share in copies if k == d and share > 0.5)
                  for d in ("HtoD", "DtoH")}
    res = {"pixels_differing": [int((m != want).sum()) if m.shape == want.shape else -1
                                for m in masks],
           "dtype": str(masks[0].dtype), "pipeline": counts[0],
           "copies": [(k, n, round(share, 4)) for k, n, share in copies],
           "overlapped_bytes": overlapped,
           "want_overlapped_bytes": {"HtoD": (h - plan.reads[0]) * row_up,
                                     "DtoH": last_down * row_down},
           "class1_share": float((want == 1).mean())}
    if any(res["pixels_differing"]) or masks[0].dtype != want.dtype or counts[0] != counts[1] \
            or overlapped != res["want_overlapped_bytes"]:
        raise AssertionError(f"the tiled copy pipeline against the whole-image stitch: {res}; "
                             f"PIPELINE of the two passes {counts}")
    return res


def phase_profile(fn, big, radius: int, stats, dev, mode: str) -> dict:
    """One tiled pass of ``mode``'s predict function over the BIG^2 image,
    profiled."""
    from tpuseg_torch.infer.tiled import inference_tiled

    return device_profile(
        lambda: inference_tiled(big, fn, TILE, radius, BATCH, NCLS, stats, dev),
        f"tiled {mode}")


def serving_unet(seed: int, img, dev):
    """The benchmark's seeded serving U-Net (Keras init, jittered running
    statistics), in float32 on the CPU and in eval mode, with its head
    shaped over the centre of ``img`` (``drivers/serve_tiled.py::
    shape_head``): about half the pixels take each class, many near a tie.
    Returns the model and the shaping's numbers."""
    import torch

    from tpuseg_torch.models.unet import UNet

    with open(os.path.join(BENCH, "configs", "unet-nist-bf16.json")) as f:
        cfg = json.load(f)
    weights = bench("harness.weights").make(cfg, seed, dev)
    head = bench("drivers.serve_tiled").shape_head(cfg, weights, [img], TILE, dev)
    model = UNet(NCLS, 1, BASE, dtype=torch.float32)
    missing, unexpected = model.load_state_dict({k: v.cpu() for k, v in weights.items()},
                                                strict=False)
    if unexpected or any(not k.endswith("num_batches_tracked") for k in missing):
        raise AssertionError(f"the benchmark's weights do not fit the model: missing {missing}, "
                             f"unexpected {unexpected}")
    return model.eval(), head


def phase_main(seed: int, work: str, dev, card: str) -> dict:
    import numpy as np
    import torch

    from tpuseg_torch.cli.inference import main as cli
    from tpuseg_torch.data.preprocess import zscore_stats
    from tpuseg_torch.infer import head_kernel, input_conv, int8_conv
    from tpuseg_torch.infer.erf import estimate_radius
    from tpuseg_torch.infer.runner import InferenceConfig, _quantized_predict_fn
    from tpuseg_torch.infer.tiled import (inference_single_batch, inference_tiled,
                                          make_predict_fn)
    from tpuseg_torch.ops import batchnorm as bn_mod
    from tpuseg_torch.utils.checkpoint import load_model, save_model
    from tpuseg_torch.utils.imagio import imread

    res: dict = {}
    imgdir = os.path.join(work, "images")
    shapes = write_images(imgdir, seed)
    big = imread(os.path.join(imgdir, "big.tif"))
    # the benchmark's U-Net with its head shaped over ``big``, so that the
    # masks compared below and in phases 7-8 can differ where they would
    model, res["head"] = serving_unet(seed, big, dev)
    ckpt = os.path.join(work, "model.pt")
    save_model(ckpt, model)
    log(f"shaped head: class-1 shift {res['head']['head_shift']:.4f}, bias lift "
        f"{res['head']['head_lift']}")
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
    head_kernel.DENSE_LAUNCHES = 0
    k3_reset()
    input_conv.LAUNCHES = 0
    t0 = time.perf_counter()
    written = cli(common + ["--output_folder", out_blocked, "--quantize", "int8_blocked",
                           "--calibration_out", cal])
    torch.cuda.synchronize()
    res["main_path_s"] = time.perf_counter() - t0
    k2 = head_kernel.LAUNCHES
    res["launches"] = {"blocked_head_argmax": k2, "int8_conv": int8_conv.LAUNCHES,
                       "int8_conv_routes": k3_routes("the int8_blocked main path"),
                       "input_conv": input_conv.LAUNCHES,
                       "dense_head_argmax_int8_blocked": head_kernel.DENSE_LAUNCHES}
    res["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    if k2 == 0:
        raise AssertionError("the int8_blocked main path launched no head kernel")
    if head_kernel.DENSE_LAUNCHES:
        raise AssertionError(f"the int8_blocked main path launched K6 "
                             f"{head_kernel.DENSE_LAUNCHES} times")
    if int8_conv.LAUNCHES != K3_PER_CALL * k2:
        raise AssertionError(f"the int8_blocked main path launched K3 {int8_conv.LAUNCHES} "
                             f"times, not {K3_PER_CALL} x K2's {k2}")
    if input_conv.LAUNCHES != K5_PER_CALL * k2:
        raise AssertionError(f"the int8_blocked main path launched K5 {input_conv.LAUNCHES} "
                             f"times, not {K5_PER_CALL} x K2's {k2}")
    if sorted(os.path.basename(p) for p in written) != sorted(shapes):
        raise AssertionError(f"masks written: {written}")
    for name, shape in shapes.items():
        m = imread(os.path.join(out_blocked, name))
        if m.shape != shape or not np.isin(m, np.arange(NCLS)).all():
            raise AssertionError(f"{name}: mask {m.shape} {m.dtype}, labels {np.unique(m)[:8]}")
    log(f"main path: {len(written)} masks in {res['main_path_s']:.2f} s, "
        f"{k2} head kernel launches, {res['launches']['int8_conv']} K3 launches, "
        f"{res['launches']['input_conv']} K5 launches, peak {res['peak_mem_gib']:.2f} GiB")

    # the same run with K3's plain version swapped in on the card: every
    # pixel must agree, and the first call's convs take the 21 block shapes
    # phase 2 holds K3 to
    out_plain = os.path.join(work, "masks_int8_blocked_plain_conv")
    head_kernel.LAUNCHES = 0
    k3_reset()
    with plain_conv() as calls:
        cli(common + ["--output_folder", out_plain, "--quantize", "int8_blocked",
                      "--calibration_in", cal])
    calls_k2 = [calls[i:i + K3_PER_CALL] for i in range(0, len(calls), K3_PER_CALL)]
    want_call = [(b[1], b[2], b[3], b[4], k3_form(b[0], b[3])) for b in k3_blocks()]
    if int8_conv.LAUNCHES or len(calls) != K3_PER_CALL * head_kernel.LAUNCHES \
            or head_kernel.LAUNCHES != k2 or want_call not in calls_k2:
        raise AssertionError(f"plain-conv run: {int8_conv.LAUNCHES} K3 launches, {len(calls)} "
                             f"plain calls, {head_kernel.LAUNCHES} K2 launches (want {k2}); "
                             f"first call's convs {calls[:K3_PER_CALL]}")
    differ = {}
    for name in shapes:
        a = imread(os.path.join(out_blocked, name))
        b = imread(os.path.join(out_plain, name))
        differ[name] = int((a != b).sum()) if a.shape == b.shape else -1
    res["k3_vs_plain_conv_pixels_differing"] = differ
    if any(differ.values()):
        raise AssertionError(f"masks through K3 and through its plain version differ: {differ}")
    log(f"int8_blocked through K3's plain version: {len(calls)} plain calls, masks equal on "
        "every pixel")

    # dense int8 from the same scales: the same quantized network, without
    # the blocked edges and K2
    out_dense = os.path.join(work, "masks_int8")
    k3_reset()
    input_conv.LAUNCHES = 0
    head_kernel.LAUNCHES = 0
    head_kernel.DENSE_LAUNCHES = 0
    cli(common + ["--output_folder", out_dense, "--quantize", "int8", "--calibration_in", cal])
    res["launches"]["int8_conv_dense_cli"] = int8_conv.LAUNCHES
    res["launches"]["int8_conv_dense_cli_routes"] = k3_routes("--quantize int8")
    res["launches"]["input_conv_dense_cli"] = input_conv.LAUNCHES
    res["launches"]["dense_head_argmax"] = head_kernel.DENSE_LAUNCHES
    if head_kernel.DENSE_LAUNCHES != k2 or head_kernel.LAUNCHES:
        raise AssertionError(f"--quantize int8 launched K6 {head_kernel.DENSE_LAUNCHES} times "
                             f"and K2 {head_kernel.LAUNCHES} times, not K6 once a predict call "
                             f"({k2} calls) and K2 never")
    if int8_conv.LAUNCHES != K3_PER_CALL * k2:  # the same predict calls as the blocked run
        raise AssertionError(f"--quantize int8 launched K3 {int8_conv.LAUNCHES} times, not "
                             f"{K3_PER_CALL} x {k2} predict calls")
    if input_conv.LAUNCHES != K5_PER_CALL * k2:
        raise AssertionError(f"--quantize int8 launched K5 {input_conv.LAUNCHES} times, not "
                             f"{K5_PER_CALL} x {k2} predict calls")
    # and through K3's plain version: every pixel equal in this mode too
    out_dense_plain = os.path.join(work, "masks_int8_plain_conv")
    k3_reset()
    with plain_conv() as calls_dense:
        cli(common + ["--output_folder", out_dense_plain, "--quantize", "int8",
                      "--calibration_in", cal])
    dense_forms = [c[4] for c in calls_dense[:K3_PER_CALL]]
    want_forms = [k3_form(n, c) for n, c in
                  (("dense_enc1b", BASE), ("dense_enc2b", 2 * BASE), ("dense_enc3b", 4 * BASE),
                   ("dense_enc4b", 8 * BASE), ("dense_dec4up", 32 * BASE),
                   ("dense_dec3up", 16 * BASE), ("dense_dec2up", 8 * BASE),
                   ("dense_dec1up", 4 * BASE))]
    if int8_conv.LAUNCHES or len(calls_dense) != K3_PER_CALL * k2 \
            or [f for f in dense_forms if f] != want_forms:
        raise AssertionError(f"--quantize int8 with the plain conv: {int8_conv.LAUNCHES} K3 "
                             f"launches, {len(calls_dense)} plain calls, the first call's "
                             f"store forms {dense_forms}")
    differ = {}
    for name in shapes:
        a = imread(os.path.join(out_dense, name))
        b = imread(os.path.join(out_dense_plain, name))
        differ[name] = int((a != b).sum()) if a.shape == b.shape else -1
    res["k3_vs_plain_conv_pixels_differing_int8"] = differ
    if any(differ.values()):
        raise AssertionError(f"--quantize int8 masks through K3 and through its plain version "
                             f"differ: {differ}")
    log(f"int8 through K3's plain version: {len(calls_dense)} plain calls, masks equal on "
        "every pixel")

    # and through K6's plain version: the served head is fp, whose sums run
    # in another order on the tensor cores, so >= 0.9999 of pixels agree
    out_dense_plain6 = os.path.join(work, "masks_int8_plain_head")
    head_kernel.DENSE_LAUNCHES = 0
    with plain_dense_head() as calls6:
        cli(common + ["--output_folder", out_dense_plain6, "--quantize", "int8",
                      "--calibration_in", cal])
    if head_kernel.DENSE_LAUNCHES or len(calls6) != k2:
        raise AssertionError(f"--quantize int8 with K6's plain version: "
                             f"{head_kernel.DENSE_LAUNCHES} K6 launches, {len(calls6)} plain "
                             f"calls (want {k2})")
    res["k6_vs_plain_agree_int8"] = agree6 = mask_agreement(out_dense, out_dense_plain6, shapes)
    if agree6["all"] < 0.9999:
        raise AssertionError(f"--quantize int8 masks through K6 and through its plain version "
                             f"agree on {agree6} < 0.9999")
    log(f"int8 through K6's plain version: {len(calls6)} plain calls, masks agree on "
        f"{agree6['all']} of pixels (fp head)")

    # int8_auto: the halo-tiled image blocked (K2), the small images in one
    # dense batch (K6); its masks are the two runs' above on every pixel
    out_auto = os.path.join(work, "masks_int8_auto")
    head_kernel.LAUNCHES = 0
    head_kernel.DENSE_LAUNCHES = 0
    k3_reset()
    input_conv.LAUNCHES = 0
    cli(common + ["--output_folder", out_auto, "--quantize", "int8_auto", "--calibration_in", cal])
    small_calls = -(-N_SMALL // BATCH)
    res["launches"]["int8_auto_cli"] = auto = {
        "blocked_head_argmax": head_kernel.LAUNCHES,
        "dense_head_argmax": head_kernel.DENSE_LAUNCHES,
        "int8_conv": int8_conv.LAUNCHES, "input_conv": input_conv.LAUNCHES}
    want_auto = {"blocked_head_argmax": k2 - small_calls, "dense_head_argmax": small_calls,
                 "int8_conv": K3_PER_CALL * k2, "input_conv": K5_PER_CALL * k2}
    if auto != want_auto:
        raise AssertionError(f"--quantize int8_auto launched {auto}, not {want_auto}")
    differ = {}
    for name in shapes:
        a = imread(os.path.join(out_auto, name))
        b = imread(os.path.join(out_blocked if name == "big.tif" else out_dense, name))
        differ[name] = int((a != b).sum()) if a.shape == b.shape else -1
    res["int8_auto_vs_modes_pixels_differing"] = differ
    if any(differ.values()):
        raise AssertionError(f"int8_auto masks differ from int8_blocked's (big.tif) or int8's "
                             f"(small images): {differ}")
    log(f"int8_auto: {auto}; masks equal to int8_blocked's (big.tif) and int8's (small) on "
        "every pixel")

    # both modes again with K5's plain version swapped in on the card: every
    # pixel must agree with the runs through K5
    res["k5_vs_plain_pixels_differing"] = {}
    main_scales = []
    for mode, out_k5 in (("int8_blocked", out_blocked), ("int8", out_dense)):
        out_plain5 = os.path.join(work, f"masks_{mode}_plain_input_conv")
        input_conv.LAUNCHES = 0
        with plain_input_conv() as (calls5, scales5):
            cli(common + ["--output_folder", out_plain5, "--quantize", mode,
                          "--calibration_in", cal])
        want5 = [((BATCH, TILE, TILE, 1), mode == "int8_blocked")]
        if input_conv.LAUNCHES or len(calls5) != K5_PER_CALL * k2 \
                or not set(want5) <= set(calls5):
            raise AssertionError(f"{mode} with K5's plain version: {input_conv.LAUNCHES} K5 "
                                 f"launches, plain calls {calls5}")
        differ = {}
        for name in shapes:
            a = imread(os.path.join(out_k5, name))
            b = imread(os.path.join(out_plain5, name))
            differ[name] = int((a != b).sum()) if a.shape == b.shape else -1
        res["k5_vs_plain_pixels_differing"][mode] = differ
        if any(differ.values()):
            raise AssertionError(f"{mode} masks through K5 and through its plain version "
                                 f"differ: {differ}")
        log(f"{mode} through K5's plain version: {len(calls5)} plain calls, masks equal on "
            "every pixel")
        main_scales += scales5
    res["k5_division_main"] = k5_division_check(torch.unique(torch.cat(main_scales)), 0, seed)
    agree = mask_agreement(out_blocked, out_dense, shapes)
    total = agree.pop("all")
    res["int8_blocked_vs_int8_agree"] = total
    res["int8_blocked_vs_int8_agree_per_image"] = agree
    res["class1_share_big"] = float((imread(os.path.join(out_blocked, "big.tif")) == 1).mean())
    if total < 0.999:
        raise AssertionError(f"int8_blocked vs int8 masks agree on {total} < 0.999: {agree}")
    if not 0.01 < res["class1_share_big"] < 0.99:
        raise AssertionError(f"class 1 takes {res['class1_share_big']} of big.tif's pixels; "
                             "the mask comparison could not fail")
    log(f"int8_blocked vs int8 mask agreement {total}, class 1 "
        f"{res['class1_share_big']:.4f} of big.tif")

    # tiled engines on the big image, timed in turns; every dispatch of the
    # blocked engine must launch the kernel
    bf16 = load_model(ckpt, dtype="bfloat16", device=dev)
    radius = estimate_radius(bf16, 1, rng=np.random.default_rng(seed))
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
    head_kernel.DENSE_LAUNCHES = 0
    k3_reset()
    input_conv.LAUNCHES = 0
    inference_tiled(big, fns["int8_blocked"], TILE, radius, BATCH, NCLS, stats, dev)
    res["launches_tiled_dispatch"] = head_kernel.LAUNCHES
    res["k6_launches_tiled_dispatch"] = head_kernel.DENSE_LAUNCHES
    res["k3_launches_tiled_dispatch"] = int8_conv.LAUNCHES
    res["k3_routes_tiled_dispatch"] = k3_routes("the tiled int8_blocked pass")
    res["k5_launches_tiled_dispatch"] = input_conv.LAUNCHES
    if not (res["launches_small_dispatch"] and res["launches_tiled_dispatch"]):
        raise AssertionError(f"a dispatch launched no head kernel: {res}")
    k3_reset()
    input_conv.LAUNCHES = 0
    head_kernel.LAUNCHES = 0
    head_kernel.DENSE_LAUNCHES = 0
    inference_tiled(big, fns["int8"], TILE, radius, BATCH, NCLS, stats, dev)
    res["k3_launches_tiled_dispatch_int8"] = int8_conv.LAUNCHES
    res["k3_routes_tiled_dispatch_int8"] = k3_routes("the tiled int8 pass")
    res["k5_launches_tiled_dispatch_int8"] = input_conv.LAUNCHES
    res["k6_launches_tiled_dispatch_int8"] = head_kernel.DENSE_LAUNCHES
    calls = in_ram_launches(BIG, BIG, radius)
    if res["k6_launches_tiled_dispatch"] or head_kernel.LAUNCHES \
            or res["k6_launches_tiled_dispatch_int8"] != calls:
        raise AssertionError(f"tiled K6 launches: int8_blocked {res['k6_launches_tiled_dispatch']}"
                             f", int8 {res['k6_launches_tiled_dispatch_int8']} ({calls} predict "
                             f"calls, K2 {head_kernel.LAUNCHES})")
    res["int8_head"] = phase_int8_head(bf16, cal, big, radius, stats, calls, dev)
    if res["k3_launches_tiled_dispatch"] != K3_PER_CALL * res["launches_tiled_dispatch"] \
            or res["k3_launches_tiled_dispatch_int8"] != K3_PER_CALL * calls:
        raise AssertionError(f"tiled K3 launches: int8_blocked {res['k3_launches_tiled_dispatch']}"
                             f" (K2 {res['launches_tiled_dispatch']}), int8 "
                             f"{res['k3_launches_tiled_dispatch_int8']} ({calls} predict calls)")
    if res["k5_launches_tiled_dispatch"] != K5_PER_CALL * res["launches_tiled_dispatch"] \
            or res["k5_launches_tiled_dispatch_int8"] != K5_PER_CALL * calls:
        raise AssertionError(f"tiled K5 launches: int8_blocked {res['k5_launches_tiled_dispatch']}"
                             f" (K2 {res['launches_tiled_dispatch']}), int8 "
                             f"{res['k5_launches_tiled_dispatch_int8']} ({calls} predict calls)")
    # K4 on the bf16 `none` walk: one apply per BatchNorm layer a predict
    # call (eval reads the running statistics: no reduction), and the masks
    # through K4 equal those through its plain versions on every pixel
    bn_mod.reset_counts()
    masks_k4 = inference_tiled(big, fns["none"], TILE, radius, BATCH, NCLS, stats, dev)
    res["k4_launches_tiled_none"] = dict(bn_mod.LAUNCHES)
    res["k4_forms_tiled_none"] = dict(bn_mod.FORMS)
    want = {"stats": 0, "apply": K4_LAYERS * calls, "backward_reduce": 0, "backward_apply": 0}
    if res["k4_launches_tiled_none"] != want:
        raise AssertionError(f"the tiled none pass launched K4 {res['k4_launches_tiled_none']}, "
                             f"not {want} ({calls} predict calls)")
    # the store forms: every skip into its concat buffer, pooled in the same pass
    want_forms = {"slice": 8 * calls, "pool": 4 * calls}
    if res["k4_forms_tiled_none"] != want_forms:
        raise AssertionError(f"the tiled none pass took K4's forms {res['k4_forms_tiled_none']}, "
                             f"not {want_forms}")
    with plain_batchnorm() as k4_calls:
        masks_plain = inference_tiled(big, fns["none"], TILE, radius, BATCH, NCLS, stats, dev)
    if any(bn_mod.LAUNCHES[k] != want[k] for k in want) or k4_calls["apply"] != want["apply"]:
        raise AssertionError(f"none with K4's plain versions: launches {bn_mod.LAUNCHES}, plain "
                             f"calls {k4_calls}")
    res["k4_vs_plain_pixels_differing_none"] = int((masks_k4 != masks_plain).sum()) \
        if masks_k4.shape == masks_plain.shape else -1
    res["class1_share_big_none"] = float((masks_k4 == 1).mean())
    if res["k4_vs_plain_pixels_differing_none"]:
        raise AssertionError(f"none masks through K4 and through its plain versions differ on "
                             f"{res['k4_vs_plain_pixels_differing_none']} pixels")
    if not 0.01 < res["class1_share_big_none"] < 0.99:
        raise AssertionError(f"class 1 takes {res['class1_share_big_none']} of the none mask; "
                             "the comparison could not fail")
    log(f"none through K4: {K4_LAYERS} applies a predict call ({calls} calls), masks equal to "
        f"the plain versions' on every pixel (class 1 {res['class1_share_big_none']:.4f})")
    del masks_k4, masks_plain
    # the copy pipeline of each mode's pass against the whole-image stitch
    res["tiled_pipeline"] = {m: tiled_pipeline_check(big, fns[m], radius, stats, dev)
                             for m in fns}
    log("tiled copy pipeline: masks equal to the whole-image stitch's on every pixel in "
        f"{', '.join(fns)}, two passes each; PIPELINE "
        f"{res['tiled_pipeline']['none']['pipeline']}; bytes crossed while the card worked "
        f"{res['tiled_pipeline']['none']['overlapped_bytes']}")
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
    for mode in ("int8_blocked", "int8", "none"):
        res[f"profile_{mode}"] = prof = phase_profile(fns[mode], big, radius, stats, dev, mode)
        if prof["busy_ms"] is None:
            continue
        head = {"int8_blocked": "K2 head_argmax", "int8": "K6 dense_head_argmax"}.get(mode)
        for group in (("K4 batchnorm",) if mode == "none" else
                      ("K3 int8_conv", "K5 input_conv", head)):
            g = prof["by_group"].get(group)
            if g is None:
                raise AssertionError(f"the profiled {mode} pass shows no {group} kernel")
            log(f"{group} in the profiled {mode} pass: {g['ms']:.2f} ms, {g['share']:.1%} "
                "of device time")
        other = {"int8_blocked": "K6 dense_head_argmax", "int8": "K2 head_argmax"}.get(mode)
        if other in prof["by_group"]:
            raise AssertionError(f"the profiled {mode} pass ran {other}")
        if mode != "none":
            prof["edge_kernels"] = edges = edge_kernels(prof)
            log(f"the profiled {mode} pass's int8 edge kernels (amax, cat, depth-to-space copy, "
                f"phase max): {edges['launches']}; the upload's copies {edges['upload_copies']}, "
                f"{edges['upload_ms']:.2f} ms")
            if any(edges["launches"].values()):
                raise AssertionError(f"the profiled {mode} pass ran eager edge ops on int8 "
                                     f"codes: {edges}")
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


def blob_pairs(n: int, height: int, width: int, seed: int) -> list:
    """``n`` of the benchmark's learnable pairs (``traffic/blobs.py``: a
    uint16 image brighter inside the blobs of its uint8 mask, under smooth
    and pixel noise), made on the card from ``seed`` and cut to ``height``
    x ``width``, as numpy ``(image, mask)`` pairs."""
    import numpy as np
    import torch

    dev = "cuda" if torch.cuda.is_available() else "cpu"
    img, msk = bench("traffic.blobs").make_pool({"pool": n, "size": max(height, width)}, seed,
                                                dev)
    img = img[:, :height, :width, 0].cpu().numpy().astype(np.uint16)
    return list(zip(img, msk[:, :height, :width].cpu().numpy()))


def write_train_dbs(work: str, seed: int, size: int = TRAIN_SIZE, n_train: int = N_TRAIN,
                    n_test: int = N_TEST):
    """``n_train`` + ``n_test`` records of ``size``^2 :func:`blob_pairs` in
    ``work``, in the record layout of bench.py (keys tileNNNN:0,1)."""
    from tpuseg_torch.data.build_db import serialize_image_mask_pair
    from tpuseg_torch.data.recordstore import RecordWriter

    pairs = iter(blob_pairs(n_train + n_test, size, size, seed + 3))
    paths = []
    os.makedirs(work, exist_ok=True)
    for name, n in (("train", n_train), ("test", n_test)):
        path = os.path.join(work, f"{name}.lmdb")
        with RecordWriter(path) as w:
            for i in range(n):
                w.put(f"tile{i:04d}:0,1", serialize_image_mask_pair(*next(pairs)))
        paths.append(path)
    return paths


K4_PARITY_STEPS = 3
# losses of the K4 and plain-version steps: the bf16 activations round the
# same, but the batch sums run in another order, so a few activations land
# one bf16 rounding apart, and Keras Adam's normalized update carries that
# into the next steps' weights
K4_PARITY_RTOL = 2e-2


# aten ops that compute nothing: allocations and views
NO_WORK_OPS = {"empty", "empty_like", "empty_strided", "select", "slice", "alias", "view",
               "as_strided", "detach"}


def k4_eager_ops(dev) -> dict:
    """The aten ops a train-mode ``conv_bn`` without a group issues on the
    card, forward and backward (a dispatch mode records every op): besides
    K4's four launches only allocations and views, no per-channel op
    between them. At enc2's width, [8, 128, 256, 256] bf16."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from tpuseg_torch.ops import batchnorm as bn

    ops: list = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            ops.append(func.__name__.split(".")[0])
            return func(*args, **(kwargs or {}))

    x, bias, gamma, beta, gy = k4_inputs((TRAIN_BATCH, 2 * BASE, TRAIN_SIZE // 2,
                                          TRAIN_SIZE // 2), torch.bfloat16, 7, dev)
    x = x.detach().requires_grad_()
    bias = bias.detach().requires_grad_()
    norm = torch.nn.BatchNorm2d(2 * BASE, eps=1e-3).to(dev).train()
    torch.cuda.synchronize()
    before = dict(bn.LAUNCHES)
    with Record():
        y = bn.conv_bn(x, bias, True, norm, 0.99)
        y.backward(gy)
    torch.cuda.synchronize()
    launched = {k: bn.LAUNCHES[k] - before[k] for k in K4_KINDS}
    counts = {op: ops.count(op) for op in sorted(set(ops))}
    log(f"train-mode conv_bn on the card, forward and backward: K4 launches {launched}, aten "
        f"ops {counts}")
    if set(ops) - NO_WORK_OPS:
        raise AssertionError(f"a train-mode conv_bn ran eager ops besides K4: "
                             f"{sorted(set(ops) - NO_WORK_OPS)}")
    if any(n != 1 for n in launched.values()):
        raise AssertionError(f"a train-mode conv_bn launched K4 {launched}, not once each")
    return {"ops": counts, "k4_launches": launched}


def k4_parity(seed: int, dev, raw_img, raw_msk, params) -> dict:
    """K4_PARITY_STEPS train steps through K4 and through its plain versions
    (``plain_batchnorm``), each from the same fresh state: the losses within
    K4_PARITY_RTOL of each other, finite, and falling in both."""
    import math

    from tpuseg_torch.models.unet import UNet
    from tpuseg_torch.train.steps import create_train_state, make_raw_steps

    tstep, _ = make_raw_steps(NCLS, params)
    losses = {}
    for name in ("k4", "plain"):
        state = create_train_state(UNet(NCLS, 1, BASE, "bfloat16"), seed, TRAIN_LR, dev)
        with (plain_batchnorm() if name == "plain" else contextlib.nullcontext()):
            losses[name] = [tstep(state, raw_img, raw_msk)["loss"].item()
                            for _ in range(K4_PARITY_STEPS)]
        del state
    rel = [abs(a - b) / abs(b) for a, b in zip(losses["k4"], losses["plain"])]
    res = {"losses": losses, "rel_diff": rel, "rtol": K4_PARITY_RTOL}
    log(f"train steps through K4 and through its plain versions: losses {losses['k4']} and "
        f"{losses['plain']}, relative differences {[f'{r:.2e}' for r in rel]}")
    for name, ls in losses.items():
        if not all(map(math.isfinite, ls)) or not ls[-1] < ls[0]:
            raise AssertionError(f"{name} steps: losses {ls} not finite and falling")
    if max(rel) > K4_PARITY_RTOL:
        raise AssertionError(f"K4 steps' losses differ from the plain versions' by {rel}")
    return res


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
    from tpuseg_torch.ops import batchnorm as bn_mod
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
    bn_mod.reset_counts()
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
    res["launches"] = {"shear_rows": warp.LAUNCHES, "blocked_head_argmax": head_kernel.LAUNCHES,
                       "batchnorm": dict(bn_mod.LAUNCHES),
                       "batchnorm_gradient_copies": bn_mod.GRAD_COPIES}
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
    # K4: each train step runs every BatchNorm layer's (a) and (b) forward
    # and (c) and (d) backward; each eval forward of the test epochs one (b)
    k4 = res["launches"]["batchnorm"]
    evals = (k4["apply"] - k4["stats"]) // K4_LAYERS
    res["launches"]["batchnorm_eval_forwards"] = evals
    if any(k4[k] != K4_LAYERS * result.steps for k in ("stats", "backward_reduce",
                                                         "backward_apply")) \
            or evals <= 0 or k4["apply"] != K4_LAYERS * (result.steps + evals):
        raise AssertionError(f"K4 launches {k4} for {result.steps} train steps: expected "
                             f"{K4_LAYERS} of each kind a step, and {K4_LAYERS} applies a test "
                             "forward")
    if bn_mod.GRAD_COPIES:  # every gradient reaches K4 as rows of channels
        raise AssertionError(f"K4's backward copied {bn_mod.GRAD_COPIES} incoming gradients "
                             "to channels-last: a layer upstream writes another layout")
    log(f"K4 launches: {k4} ({K4_LAYERS} of each a train step, {K4_LAYERS} applies in each of "
        f"{evals} test forwards); {bn_mod.GRAD_COPIES} incoming gradients copied to "
        "channels-last")
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
    windows, host_ms = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0, c0 = time.perf_counter(), time.process_time()
        for _ in range(10):
            m = tstep(state, raw_img, raw_msk)
        m["loss"].item()
        windows.append(TRAIN_BATCH * 10 / (time.perf_counter() - t0))
        host_ms.append((time.process_time() - c0) / 10 * 1e3)
    res["img_per_s_windows"] = windows
    res["img_per_s"] = sorted(windows)[1]
    # this process's CPU time a step (all its threads): near the step's
    # wall time, the host sets the pace
    res["host_cpu_ms_per_step_windows"] = host_ms
    res["host_cpu_ms_per_step"] = sorted(host_ms)[1]
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
        f"host CPU {res['host_cpu_ms_per_step']:.2f} ms a step, "
        f"peak {res['peak_mem_gib_steady']:.2f} GiB")

    def three_steps():
        for _ in range(3):
            tstep(state, raw_img, raw_msk)

    prof = device_profile(three_steps, "3 train steps")
    if prof["launches"] is not None:
        res["launches_per_step"] = prof["launches"] / 3
        res["launches_per_step_by_group"] = {g: n / 3 for g, n in
                                             prof["launches_by_group"].items()}
        log(f"kernel launches a train step: {res['launches_per_step']:.1f} ("
            + ", ".join(f"{g} {n:.1f}" for g, n in res["launches_per_step_by_group"].items())
            + ")")
    res["k4_conv_bn_ops"] = k4_eager_ops(dev)
    shear_ms = sum(ms for k, (ms, _) in prof["by_kernel"].items() if "shear_rows" in k)
    prof["shear_kernel_ms"] = shear_ms
    prof["shear_kernel_share"] = shear_ms / prof["busy_ms"] if prof["busy_ms"] else None
    del prof["by_kernel"]
    res["profile_train"] = prof
    if prof["busy_ms"] is not None and "K4 batchnorm" not in prof["by_group"]:
        raise AssertionError("the profiled train steps show no K4 kernel")

    # the train step through K4 against the same step through its plain
    # versions: two states from one seed, K4_PARITY_STEPS steps each on the
    # raw batch (augmentation and dropout from the same generators)
    res["k4_vs_plain_steps"] = k4_parity(seed, dev, raw_img, raw_msk, params)

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
    # block's bias, ReLU and BatchNorm (K4) skipped bounds what K4 costs
    real_bn = unet_mod.conv_bn
    unet_mod.conv_bn = lambda x, bias, relu, bn_module, momentum, group=None, **forms: x
    try:
        bn["step_ms_without_bn"] = cuda_ms(lambda: tstep(state, raw_img, raw_msk), 10, 1)
    finally:
        unet_mod.conv_bn = real_bn
    res["bn_check"] = bn
    log(f"after {bn['steps']} steps on one batch: loss {bn['loss_running_stats']:.4f} with "
        f"running statistics, {bn['loss_batch_stats']:.4f} with batch statistics; step "
        f"{bn['step_ms_without_bn']:.2f} ms with BatchNorm skipped (timing only) against "
        f"{step_ms:.2f} ms")
    return res


# run as `python -c`: the module's own main under a thread that samples the
# process's resident set every 5 ms, with a mark where the runner's
# load_model returns (before it: imports, the CUDA context, the model;
# after it: calibration, reading, serving and writing the slide); then the
# K2 wrapper's count, the peaks and the process's own ru_maxrss
_COUNTED_CLI = """import os, resource, runpy, sys, threading, time
from tpuseg_torch.infer import head_kernel, runner
PAGE = os.sysconf("SC_PAGE_SIZE")
def rss():
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * PAGE
mem = {{"peak": 0, "loaded": 0, "peak_after_load": 0}}
def sample():
    while True:
        r = rss()
        mem["peak"] = max(mem["peak"], r)
        if mem["loaded"]:
            mem["peak_after_load"] = max(mem["peak_after_load"], r)
        time.sleep(0.005)
load_model = runner.load_model
def marked_load_model(*args, **kwargs):
    model = load_model(*args, **kwargs)
    mem["loaded"] = mem["peak_after_load"] = rss()
    return model
runner.load_model = marked_load_model
threading.Thread(target=sample, daemon=True).start()
sys.argv[0] = {module!r}
runpy.run_module({module!r}, run_name="__main__")
print("K2_LAUNCHES", head_kernel.LAUNCHES)
for key, value in mem.items():
    print("RSS", key, value)
print("RU_MAXRSS_KB", resource.getrusage(resource.RUSAGE_SELF).ru_maxrss)
"""


def run_cli(module: str, args, logbase: str, counted: bool = False) -> dict:
    """``python -m module args`` as its own process from the checkout's
    root, reaped with ``os.wait4``: wall time, standard output and, with
    ``counted``, the K2 launches and the peaks of the resident set sampled
    inside that process (``_COUNTED_CLI``). wait4's ``ru_maxrss`` and the child's own are kept
    beside it (``wait4_maxrss_mib``, ``ru_maxrss_mib``) but are no child's
    alone on Linux: exec records the high-water mark of the memory image
    it replaces, and Python spawns from a vfork that shares this (large)
    process's image. Fails on a non-zero exit."""
    root = os.path.dirname(os.path.abspath(__file__))
    cmd = ([sys.executable, "-c", _COUNTED_CLI.format(module=module)] if counted
           else [sys.executable, "-m", module])
    with open(logbase + ".out", "w") as out, open(logbase + ".err", "w") as err:
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd + list(args), cwd=root, stdout=out, stderr=err)
        _, status, usage = os.wait4(proc.pid, 0)
        wall = time.perf_counter() - t0
    proc.returncode = os.waitstatus_to_exitcode(status)
    with open(logbase + ".out") as f:
        stdout = f.read()
    if proc.returncode != 0:
        with open(logbase + ".err") as f:
            raise AssertionError(f"{module} exited {proc.returncode}: {f.read()[-3000:]}")
    res = {"wall_s": wall, "wait4_maxrss_mib": usage.ru_maxrss / 1024, "stdout": stdout}
    if counted:
        res["k2_launches"] = int(re.search(r"^K2_LAUNCHES (\d+)$", stdout, re.M).group(1))
        rss = {k: int(v) / 2 ** 20 for k, v in re.findall(r"^RSS (\w+) (\d+)$", stdout, re.M)}
        res["peak_rss_mib"] = rss["peak"]
        res["rss_at_load_mib"] = rss["loaded"]
        # what the slide adds: calibration, reading, serving and writing it
        res["slide_rss_mib"] = rss["peak_after_load"] - rss["loaded"]
        res["ru_maxrss_mib"] = int(re.search(r"^RU_MAXRSS_KB (\d+)$", stdout, re.M)
                                   .group(1)) / 1024
    return res


def stream_chunks(height: int, width: int, radius: int) -> list:
    """The batch of each K2 launch of one streamed int8_blocked pass: one
    launch per chunk of at most BATCH windows in each zone row."""
    zor = TILE - 2 * radius
    rows, cols = -(-height // zor), -(-width // zor)
    return [min(BATCH, cols - c) for _ in range(rows) for c in range(0, cols, BATCH)]


def stream_launches(height: int, width: int, radius: int) -> int:
    return len(stream_chunks(height, width, radius))


@contextlib.contextmanager
def plain_head():
    """K2's wrapper with the kernel's launch swapped for its plain version
    on the same card tensors: the predict function then runs K2-free and
    counts no launch. Yields the shapes of the activations it is given."""
    from tpuseg_torch.infer import head_kernel

    launch, shapes = head_kernel._launch, []

    def plain(x, sv, wt, epi, ncls, fp):
        shapes.append(list(x.shape))
        return head_kernel._blocked_head_argmax_plain(x, sv, wt, epi, ncls, fp)

    head_kernel._launch = plain
    try:
        yield shapes
    finally:
        head_kernel._launch = launch


@contextlib.contextmanager
def plain_dense_head():
    """K6's wrapper with the kernel's launch swapped for its plain version
    on the same card tensors: the dense predict function then runs K6-free
    and counts no launch. Yields the shapes of the activations it is given."""
    from tpuseg_torch.infer import head_kernel

    launch, shapes = head_kernel._launch_dense, []

    def plain(x, sv, wt, epi, ncls, fp):
        shapes.append(list(x.shape))
        return head_kernel._dense_head_argmax_plain(x, sv, wt, epi, ncls, fp)

    head_kernel._launch_dense = plain
    try:
        yield shapes
    finally:
        head_kernel._launch_dense = launch


def mask_agreement(dir_a: str, dir_b: str, shapes: dict) -> dict:
    """Share of equal pixels between the masks of two output folders, per
    image and over all pixels (``"all"``)."""
    import numpy as np

    from tpuseg_torch.utils.imagio import imread

    agree = {name: float((imread(os.path.join(dir_a, name))
                          == imread(os.path.join(dir_b, name))).mean()) for name in shapes}
    agree["all"] = float(sum(agree[n] * np.prod(s) for n, s in shapes.items())
                         / sum(np.prod(s) for s in shapes.values()))
    return agree


@contextlib.contextmanager
def plain_conv():
    """K3's wrapper with the kernel's launch swapped for its plain version
    on the same card tensors: the predict function then runs K3-free and
    counts no launch. Yields (x shape, kernel size, Cout, mode, store forms)
    of each call, the forms as :func:`k3_form` gives them (None without)."""
    from tpuseg_torch.infer import int8_conv

    launch, calls = int8_conv._launch, []

    def plain(x, weights, epilogue, out=None, d2s=False, pool=None):
        form = None
        if out is not None or pool is not None:
            form = {"ctot": None if out is None else out.stride(2),
                    "offset": None if out is None else out.storage_offset() % out.stride(2),
                    "d2s": d2s, "pool": pool}
        calls.append((tuple(x.shape), weights.kh, weights.cout, epilogue.mode, form))
        return int8_conv._int8_conv_plain(x, weights, epilogue, out, d2s, pool)

    int8_conv._launch = plain
    try:
        yield calls
    finally:
        int8_conv._launch = launch


@contextlib.contextmanager
def plain_input_conv():
    """K5's wrapper with the kernel's launch swapped for its plain version
    on the same card tensors: the predict function then runs K5-free and
    counts no launch. Yields (x shape, blocked) of each call, and the
    output scales ``so`` it was given."""
    from tpuseg_torch.infer import input_conv

    launch, calls, scales = input_conv._launch, [], []

    def plain(x, w, b, s, t, so, dtype, blocked):
        calls.append((tuple(x.shape), blocked))
        scales.append(so.reshape(1))
        return input_conv._input_conv_plain(x, w, b, s, t, so, dtype, blocked)

    input_conv._launch = plain
    try:
        yield calls, scales
    finally:
        input_conv._launch = launch


@contextlib.contextmanager
def plain_batchnorm():
    """K4's wrappers with each kernel's launch swapped for its plain version
    on the same card tensors: the model then runs K4-free and counts no
    launch. Yields the number of calls each took."""
    from tpuseg_torch.ops import batchnorm as bn

    swaps = [("stats", "_launch_stats", bn._stats_count_plain),
             ("apply", "_launch_apply_train", bn._apply_train_plain),
             ("apply", "_launch_apply_eval", bn._apply_eval_plain),
             ("backward_reduce", "_launch_backward_reduce", bn._backward_reduce_plain),
             ("backward_apply", "_launch_backward_apply", bn._backward_apply_plain),
             ("backward_apply", "_launch_backward_apply_train", bn._backward_apply_train_plain)]
    real = {attr: getattr(bn, attr) for _, attr, _ in swaps}
    calls = dict.fromkeys(K4_KINDS, 0)

    def plain(kind, fn):
        def run(*args, ldx=None, ldg=None, **forms):
            calls[kind] += 1
            return fn(*args, **forms)
        return run

    for kind, attr, fn in swaps:
        setattr(bn, attr, plain(kind, fn))
    try:
        yield calls
    finally:
        for attr, fn in real.items():
            setattr(bn, attr, fn)


def in_ram_launches(height: int, width: int, radius: int) -> int:
    """K2 launches of one tiled int8_blocked pass: one per chunk of at most
    BATCH windows over the whole grid."""
    zor = TILE - 2 * radius
    rows, cols = -(-height // zor), -(-width // zor)
    return -(-rows * cols // BATCH)


def phase_stream_engine(work: str, dev, radius: int) -> dict:
    """Streaming against in-RAM on the BIG^2 image written as a tiled
    BigTIFF: labels, K2 launches (counts zeroed just before the streamed
    pass, read just after); K2 against its plain version at the streamed
    shapes, end to end, at BIG^2 and BIG2^2; both engines timed in turns,
    one streamed pass profiled, and the host's share alone: reading the
    slide's regions (decode) and writing the mask (deflate)."""
    import numpy as np
    import torch

    from tpuseg_torch.data.preprocess import zscore_stats
    from tpuseg_torch.infer import head_kernel, input_conv, int8_conv
    from tpuseg_torch.infer.runner import InferenceConfig, _quantized_predict_fn
    from tpuseg_torch.infer.tiled import inference_tiled, inference_tiled_streaming
    from tpuseg_torch.utils.bigtiff import BigTiffReader, read_bigtiff, write_bigtiff
    from tpuseg_torch.utils.checkpoint import load_model

    src = os.path.join(work, f"slides{BIG}", "slide.tif")
    big = read_bigtiff(src)
    ckpt = os.path.join(work, "model.pt")
    # calibrated on the slide as the in-RAM CLI calibrates
    cfg = InferenceConfig(ckpt, work, work, NCLS, 1, base_features=BASE,
                          quantize="int8_blocked")
    fn = _quantized_predict_fn(cfg, load_model(ckpt, dtype="bfloat16", device=dev), [src],
                               dev)[0]
    stats = zscore_stats(big)
    out = os.path.join(work, "stream_engine")
    os.makedirs(out, exist_ok=True)
    mask_path = os.path.join(out, "slide.tif")

    def in_ram():
        return inference_tiled(big, fn, TILE, radius, BATCH, NCLS, stats, dev)

    def streaming(side=BIG, dst=mask_path):
        with BigTiffReader(os.path.join(work, f"slides{side}", "slide.tif")) as reader:
            inference_tiled_streaming(reader, fn, dst, TILE, radius, BATCH,
                                      num_classes=NCLS, norm_stats=stats, progress=False,
                                      device=dev)

    want = in_ram()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    head_kernel.LAUNCHES = 0
    k3_reset()
    input_conv.LAUNCHES = 0
    streaming()
    torch.cuda.synchronize()
    res = {"launches": head_kernel.LAUNCHES, "k3_launches": int8_conv.LAUNCHES,
           "k3_routes": k3_routes("the streamed pass"), "k5_launches": input_conv.LAUNCHES,
           "expected_launches": stream_launches(BIG, BIG, radius),
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    if res["launches"] != res["expected_launches"]:
        raise AssertionError(f"streamed pass launched K2 {res['launches']} times, expected "
                             f"{res['expected_launches']}")
    if res["k3_launches"] != K3_PER_CALL * res["expected_launches"]:
        raise AssertionError(f"streamed pass launched K3 {res['k3_launches']} times, not "
                             f"{K3_PER_CALL} per chunk ({res['expected_launches']} chunks)")
    if res["k5_launches"] != K5_PER_CALL * res["expected_launches"]:
        raise AssertionError(f"streamed pass launched K5 {res['k5_launches']} times, not "
                             f"{K5_PER_CALL} per chunk ({res['expected_launches']} chunks)")
    got = read_bigtiff(mask_path)
    if got.shape != want.shape or got.dtype != np.uint8:
        raise AssertionError(f"streamed mask {got.shape} {got.dtype}, in-RAM {want.shape}")
    res["pixels_differing"] = int((got != want).sum())
    res["agree"] = 1.0 - res["pixels_differing"] / got.size
    if res["agree"] < 0.9999:
        raise AssertionError(f"streamed vs in-RAM labels agree on {res['agree']} < 0.9999")

    # K2 against its plain version at the shapes this path gives it
    # ([5, ...] a zone row at BIG^2; [8, ...] and [2, ...] at BIG2^2): each
    # slide streamed through K2 and through the same engine with the plain
    # head, the masks compared. The int8 sums are exact and the fp head's
    # f32 sums run in another order: labels agree on >= 0.9999, and on a
    # balanced model, so that the comparison can fail
    res["vs_plain"] = {}
    for side in (BIG, BIG2):
        k2_path = mask_path if side == BIG else os.path.join(out, f"slide{side}.tif")
        if side != BIG:
            streaming(side, k2_path)
        plain_path = os.path.join(out, f"slide{side}_plain.tif")
        before = head_kernel.LAUNCHES
        with plain_head() as shapes:
            streaming(side, plain_path)
        want_shapes = [[b] + list(MAIN_SHAPE[1:]) for b in stream_chunks(side, side, radius)]
        if head_kernel.LAUNCHES != before or shapes != want_shapes:
            raise AssertionError(f"{side}^2 plain-head pass: {head_kernel.LAUNCHES - before} K2 "
                                 f"launches, head shapes {shapes} vs {want_shapes}")
        a, b = read_bigtiff(k2_path), read_bigtiff(plain_path)
        n = int((a != b).sum())
        r = res["vs_plain"][side] = {
            "pixels_differing": n, "agree": 1.0 - n / b.size,
            "class1_share": float((b == 1).mean()),
            "head_batches": sorted(set(s[0] for s in shapes))}
        if a.shape != (side, side) or r["agree"] < 0.9999:
            raise AssertionError(f"{side}^2: K2's streamed mask {a.shape} agrees with the "
                                 f"plain head's on {r['agree']} < 0.9999")
        if not 0.01 < r["class1_share"] < 0.99:
            raise AssertionError(f"{side}^2: class 1 takes {r['class1_share']} of the pixels; "
                                 "the comparison could not fail")
        log(f"streamed {side}^2, K2 vs plain head (batches {r['head_batches']}, "
            f"{len(shapes)} calls): {n} pixels differ (agreement {r['agree']}), class 1 "
            f"{r['class1_share']:.4f} of the pixels")
    times = {"in_ram": [], "streaming": []}
    for name in ("in_ram", "streaming", "streaming", "in_ram"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (in_ram if name == "in_ram" else streaming)()
        times[name].append(time.perf_counter() - t0)
    res["s"] = times
    res["mp_s"] = {k: BIG * BIG / 1e6 / (sum(v) / len(v)) for k, v in times.items()}
    log(f"streamed vs in-RAM {BIG}^2 int8_blocked: {res['pixels_differing']} pixels differ "
        f"(agreement {res['agree']}), K2 launches {res['launches']} (expected "
        f"{res['expected_launches']}), K3 launches {res['k3_launches']}, K5 launches "
        f"{res['k5_launches']}, MP/s streamed {res['mp_s']['streaming']:.2f}, in RAM "
        f"{res['mp_s']['in_ram']:.2f}, peak device memory streamed {res['peak_mem_gib']:.2f} GiB")

    res["profile"] = device_profile(streaming, f"streamed int8_blocked {BIG}^2")
    zor = TILE - 2 * radius
    t0 = time.perf_counter()
    with BigTiffReader(src) as reader:
        for y in range(0, BIG, zor):
            reader.read_region(y, 0, min(zor, BIG - y), BIG)
    res["host_decode_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    write_bigtiff(os.path.join(out, "deflate.tif"), want, tile=(zor, zor))
    res["host_deflate_s"] = time.perf_counter() - t0
    log(f"host alone: reading the slide's regions {res['host_decode_s']:.3f} s, writing the "
        f"mask {res['host_deflate_s']:.3f} s")
    return res


def phase_stream_clis(work: str, dev, radius: int) -> dict:
    """The inference CLI disk to disk, in RAM and streaming, at BIG^2 and
    BIG2^2, each in its own process; then the evaluate CLI on the BIG^2
    masks, and the same counts from ``segmentation_metrics`` on the card."""
    import numpy as np
    import torch

    from tpuseg_torch.cli.evaluate import main as evaluate_cli
    from tpuseg_torch.ops import metrics
    from tpuseg_torch.utils.bigtiff import BigTiffReader, read_bigtiff

    common = ["--checkpoint_filepath", os.path.join(work, "model.pt"),
              "--number_classes", str(NCLS), "--number_channels", "1",
              "--base_features", str(BASE), "--device", dev.type, "--tile_size", str(TILE),
              "--batch_size", str(BATCH), "--radius", str(radius),
              "--quantize", "int8_blocked"]
    res: dict = {"runs": {}, "agree": {}}
    for side in (BIG, BIG2):
        # the in-RAM run calibrates on the slide; the streamed run reuses
        # its scales, so the two masks come from one quantized network
        cal = os.path.join(work, f"cal_slide{side}.json")
        for mode in ("in_ram", "streaming"):
            extra = (["--calibration_out", cal] if mode == "in_ram"
                     else ["--calibration_in", cal, "--streaming"])
            tag = f"{mode}{side}"
            r = run_cli("tpuseg_torch.cli.inference",
                        common + extra + ["--image_folder", os.path.join(work, f"slides{side}"),
                                          "--output_folder", os.path.join(work, f"masks_{tag}")],
                        os.path.join(work, f"cli_{tag}"), counted=True)
            del r["stdout"]
            r["mp_s"] = side * side / 1e6 / r["wall_s"]
            want = (stream_launches if mode == "streaming" else in_ram_launches)(side, side, radius)
            if r["k2_launches"] != want:
                raise AssertionError(f"{tag}: K2 launched {r['k2_launches']} times, expected {want}")
            res["runs"][tag] = r
            log(f"CLI {mode} {side}^2 disk to disk: {r['wall_s']:.2f} s ({r['mp_s']:.2f} MP/s, "
                f"process start included), peak RSS sampled {r['peak_rss_mib']:.0f} MiB, "
                f"{r['rss_at_load_mib']:.0f} when the model was loaded, the slide's part "
                f"{r['slide_rss_mib']:.0f} (ru_maxrss {r['ru_maxrss_mib']:.0f}, wait4 "
                f"{r['wait4_maxrss_mib']:.0f}), K2 launches {r['k2_launches']}")
        a, b = (read_bigtiff(os.path.join(work, f"masks_{m}{side}", "slide.tif"))
                for m in ("streaming", "in_ram"))
        res["agree"][side] = float((a == b).mean())
        if a.shape != (side, side) or res["agree"][side] < 0.999:
            raise AssertionError(f"{side}^2: streamed mask {a.shape} agrees with the in-RAM "
                                 f"one on {res['agree'][side]} < 0.999")
    log(f"CLI streamed vs in-RAM mask agreement: {res['agree']}")

    # the evaluate CLI is host-only: its entry point runs in this process
    pred_dir, truth_dir = (os.path.join(work, f"masks_{m}{BIG}") for m in ("streaming", "in_ram"))
    stdout = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(stdout):
        rc = evaluate_cli(["--pred_folder", pred_dir, "--truth_folder", truth_dir,
                           "--number_classes", str(NCLS)])
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"evaluate CLI returned {rc}")
    ev = json.loads(stdout.getvalue())
    a, b = (read_bigtiff(os.path.join(d, "slide.tif")) for d in (pred_dir, truth_dir))
    agree = float((a == b).mean())
    grids = {}
    for what, d in (("pred", pred_dir), ("truth", truth_dir)):
        with BigTiffReader(os.path.join(d, "slide.tif")) as rd:
            grids[what] = [rd.tile_height, rd.tile_width]
    if abs(ev["pixel_accuracy"] - agree) > 1e-12:
        raise AssertionError(f"evaluate pixel_accuracy {ev['pixel_accuracy']} vs numpy "
                             f"agreement {agree}")
    card = metrics.segmentation_metrics(torch.from_numpy(a).to(dev),
                                        torch.from_numpy(b).to(dev), NCLS)
    cm_card = card["confusion"].cpu().numpy()
    cm_host = metrics._bincount_cm(a, b, NCLS)
    if not np.array_equal(cm_card, cm_host):
        raise AssertionError(f"confusion on the card {cm_card.tolist()} vs host "
                             f"{cm_host.tolist()}")
    res["evaluate"] = {"cli": ev, "numpy_agree": agree, "tile_grids": grids,
                       "confusion": cm_host.tolist(), "wall_s": wall,
                       "card_pixel_accuracy": card["pixel_accuracy"].item(),
                       "card_mean_iou": card["mean_iou"].item()}
    log(f"evaluate CLI (pred tiles {grids['pred']}, truth tiles {grids['truth']}): pixel "
        f"accuracy {ev['pixel_accuracy']!r} = numpy {agree!r}, mIoU {ev['mean_iou']:.6f}; "
        f"card confusion {cm_card.tolist()} equals the host's")
    return res


def phase_slide_data(seed: int, work: str, dev) -> dict:
    """N_SLIDES tiled-BigTIFF pairs built by the build CLI, converted to
    LMDB and one back by the convert CLI, then trained on as LMDB through
    the train CLI with the shear launch count zeroed just before and read
    just after."""
    import random

    import numpy as np
    import torch

    from tpuseg_torch.cli.train import main as train_cli
    from tpuseg_torch.data.build_db import tiling_boxes
    from tpuseg_torch.data.recordstore import LmdbRecordReader, RecordReader
    from tpuseg_torch.ops import warp
    from tpuseg_torch.utils.bigtiff import write_bigtiff

    res: dict = {}
    folders = {k: os.path.join(work, f"slide_{k}") for k in ("images", "masks")}
    for d in folders.values():
        os.makedirs(d, exist_ok=True)
    masks = {}
    for i, (img, msk) in enumerate(blob_pairs(N_SLIDES, SLIDE, SLIDE, seed + 5)):
        name = f"slide{i}.tif"
        masks[name] = msk
        write_bigtiff(os.path.join(folders["images"], name), img, tile=(STREAM_TILE, STREAM_TILE))
        write_bigtiff(os.path.join(folders["masks"], name), masks[name],
                      tile=(STREAM_TILE, STREAM_TILE))
    dbdir = os.path.join(work, "slide_dbs")
    r = run_cli("tpuseg_torch.cli.build_lmdb",
                ["--image_folder", folders["images"], "--mask_folder", folders["masks"],
                 "--output_folder", dbdir, "--dataset_name", "slides", "--use_tiling", "1",
                 "--tile_size", str(STREAM_TILE), "--seed", str(seed)],
                os.path.join(work, "cli_build"))
    res["build_s"] = r["wall_s"]

    # the split and the keys that the seed and tiling_boxes imply
    names = [f for f in os.listdir(folders["masks"]) if f.endswith(".tif")]
    random.Random(seed).shuffle(names)
    n_train = int(0.8 * len(names))

    def records(db):
        with RecordReader(db) as rd:
            return type(rd), [(k, rd.get_at(i)) for i, k in enumerate(rd.keys())]

    dbs, res["records"] = {}, {}
    for split, split_names in (("train", names[:n_train]), ("test", names[n_train:])):
        want = sorted(
            f"{os.path.splitext(n)[0]}_i{y}_j{x}:"
            f"{','.join(str(c) for c in np.unique(masks[n][y:ye, x:xe]))}".encode()
            for n in split_names for y, x, ye, xe in tiling_boxes(SLIDE, SLIDE, STREAM_TILE))
        db = dbs[split] = os.path.join(dbdir, f"{split}-slides.lmdb")
        kind, recs = records(db)
        if [k for k, _ in recs] != want:
            raise AssertionError(f"{split}: keys {[k for k, _ in recs][:4]}... vs "
                                 f"{want[:4]}... ({len(recs)} vs {len(want)})")
        res["records"][split] = len(recs)
        ref = os.path.join(dbdir, f"{split}-slides-ref.lmdb")
        run_cli("tpuseg_torch.cli.convert_db", ["--input_database", db, "--output_database",
                                                ref, "--format", "lmdb"],
                os.path.join(work, f"cli_convert_{split}"))
        ref_kind, ref_recs = records(ref)
        if ref_kind is not LmdbRecordReader or ref_recs != recs:
            raise AssertionError(f"{split}: the LMDB copy ({ref_kind.__name__}) differs")
        dbs[split + "_ref"] = ref
    back = os.path.join(dbdir, "train-slides-back.lmdb")
    run_cli("tpuseg_torch.cli.convert_db", ["--input_database", dbs["train_ref"],
                                            "--output_database", back, "--format", "tsr"],
            os.path.join(work, "cli_convert_back"))
    back_kind, back_recs = records(back)
    if back_kind is not RecordReader or back_recs != records(dbs["train"])[1]:
        raise AssertionError("train database converted to LMDB and back differs")
    log(f"build CLI: {res['records']} records of {STREAM_TILE}^2 from {N_SLIDES} slides of "
        f"{SLIDE}^2, keys as tiling_boxes implies; LMDB copies and the round trip "
        "byte-equal")

    torch.cuda.synchronize()
    warp.LAUNCHES = 0
    result = train_cli([
        "--train_database", dbs["train_ref"], "--test_database", dbs["test_ref"],
        "--output_dir", os.path.join(work, "slide_train"), "--batch_size", str(TRAIN_BATCH),
        "--test_every_n_steps", str(SLIDE_TEST_EVERY), "--max_epochs", "1",
        "--seed", str(seed), "--device", dev.type, "--base_features", str(SLIDE_BASE),
        "--dtype", "bfloat16", "--reader_count", "2", "--learning_rate", str(TRAIN_LR)])
    torch.cuda.synchronize()
    res["train"] = {"steps": result.steps, "shear_launches": warp.LAUNCHES,
                    "train_losses": result.train_losses, "test_loss": result.test_loss}
    log(f"train CLI on the LMDB copies (base {SLIDE_BASE}): {result.steps} steps, "
        f"{warp.LAUNCHES} shear launches, losses {result.train_losses}, test {result.test_loss}")
    if result.steps != SLIDE_TEST_EVERY + 1 or warp.LAUNCHES != 3 * result.steps:
        raise AssertionError(f"{result.steps} steps and {warp.LAUNCHES} shear launches: "
                             f"expected {SLIDE_TEST_EVERY + 1} and 3 per step")
    if not (np.isfinite(result.train_losses).all() and np.isfinite(result.test_loss).all()):
        raise AssertionError(f"non-finite losses: {result.train_losses} {result.test_loss}")
    return res


def phase_stream(seed: int, work: str, dev, radius: int) -> dict:
    """Phase 7: the slides, then whole-slide streaming end to end with
    phase 4's balanced model."""
    import numpy as np

    from tpuseg_torch.utils.bigtiff import write_bigtiff
    from tpuseg_torch.utils.imagio import imread

    big = imread(os.path.join(work, "images", "big.tif"))
    for side in (BIG, BIG2):
        folder = os.path.join(work, f"slides{side}")
        os.makedirs(folder, exist_ok=True)
        img = np.tile(big, (side // BIG, side // BIG))
        write_bigtiff(os.path.join(folder, "slide.tif"), img, tile=(STREAM_TILE, STREAM_TILE),
                      level=1)
    return {"engine": phase_stream_engine(work, dev, radius),
            "clis": phase_stream_clis(work, dev, radius),
            "data": phase_slide_data(seed, work, dev)}


def phase_migration(seed: int, work: str, dev, main_res: dict, train_res: dict) -> dict:
    """Phase 8: phase 4's balanced model written as a Keras 2 reference
    checkpoint without TensorFlow, imported through the import CLI (weights
    bit-equal, TensorFlow never loaded), served through K2 as phase 4 served
    it (K2's count zeroed just before, read just after), then resumed through
    the train CLI on phase 6's databases with a profiled window (K1's count
    zeroed just before, read just after) whose trace the trace analysis
    reads, and whose event files are read back."""
    import glob

    import numpy as np
    import torch

    from tpuseg_torch.cli.import_checkpoint import main as import_cli
    from tpuseg_torch.cli.inference import main as infer_cli
    from tpuseg_torch.cli.train import main as train_cli
    from tpuseg_torch.infer import head_kernel
    from tpuseg_torch.ops import warp
    from tpuseg_torch.utils import tb_events, trace_analysis
    from tpuseg_torch.utils.imagio import imread
    from tpuseg_torch.utils.tf_bundle import write_bundle
    from tpuseg_torch.utils.tf_export import keras2_checkpoint_tensors

    t_phase = time.perf_counter()
    res: dict = {}
    sd = torch.load(os.path.join(work, "model.pt"), map_location="cpu",
                    weights_only=True)["state_dict"]
    t0 = time.perf_counter()
    tensors = keras2_checkpoint_tensors(sd)
    tensors["optimizer/iter/.ATTRIBUTES/VARIABLE_VALUE"] = np.int64(0)
    prefix = write_bundle(os.path.join(work, "tfckpt", "ckpt"), tensors)
    res["write_s"] = time.perf_counter() - t0
    res["checkpoint_bytes"] = sum(os.path.getsize(p) for p in glob.glob(prefix + ".*"))

    imported_dir = os.path.join(work, "imported")
    t0 = time.perf_counter()
    geometry = import_cli(["--tf_checkpoint", os.path.dirname(prefix),
                           "--output_folder", imported_dir])
    res["import_s"] = time.perf_counter() - t0
    if "tensorflow" in sys.modules:
        raise AssertionError("the import loaded tensorflow")
    if geometry != {"number_channels": 1, "base_features": BASE, "number_classes": NCLS}:
        raise AssertionError(f"imported geometry {geometry}")
    imported = os.path.join(imported_dir, "ckpt")
    got = torch.load(imported, map_location="cpu", weights_only=True)["state_dict"]
    differ = sorted(k for k in sd if k not in got or not torch.equal(got[k], sd[k]))
    if set(got) != set(sd) or differ:
        raise AssertionError(f"imported weights differ from the model's: {differ[:5]}")
    log(f"migration: Keras 2 reference checkpoint of {res['checkpoint_bytes'] / 1e6:.1f} MB "
        f"written in {res['write_s']:.2f} s without TensorFlow; imported in "
        f"{res['import_s']:.2f} s ({len(sd)} tensors bit-equal, tensorflow not loaded)")

    # serve phase 4's folder from the imported checkpoint, as phase 4 did
    imgdir = os.path.join(work, "images")
    out = os.path.join(work, "masks_imported")
    cal = os.path.join(work, "cal_imported.json")
    torch.cuda.synchronize()
    head_kernel.LAUNCHES = 0
    t0 = time.perf_counter()
    written = infer_cli(["--checkpoint_filepath", imported, "--image_folder", imgdir,
                         "--output_folder", out, "--number_classes", str(NCLS),
                         "--number_channels", "1", "--base_features", str(BASE),
                         "--device", dev.type, "--tile_size", str(TILE),
                         "--batch_size", str(BATCH), "--seed", str(seed),
                         "--quantize", "int8_blocked", "--calibration_out", cal])
    torch.cuda.synchronize()
    res["serve_s"] = time.perf_counter() - t0
    res["k2_launches"] = head_kernel.LAUNCHES
    want_launches = main_res["launches"]["blocked_head_argmax"]
    if res["k2_launches"] != want_launches:
        raise AssertionError(f"serving the imported checkpoint launched K2 "
                             f"{res['k2_launches']} times, phase 4 {want_launches}")
    same = total = 0
    for path in written:
        name = os.path.basename(path)
        a, b = imread(path), imread(os.path.join(work, "masks_int8_blocked", name))
        if a.shape != b.shape:
            raise AssertionError(f"{name}: mask {a.shape} vs phase 4's {b.shape}")
        same += int((a == b).sum())
        total += a.size
    res["agree_with_phase4"] = same / total
    res["pixels_differing"] = total - same
    with open(cal) as f, open(os.path.join(work, "cal.json")) as g:
        mine, theirs = json.load(f)["act_ranges"], json.load(g)["act_ranges"]
    res["calibration_max_rel_diff"] = max(abs(mine[k] - theirs[k]) / max(abs(theirs[k]), 1e-30)
                                          for k in theirs)
    log(f"served the imported checkpoint (int8_blocked): {len(written)} masks in "
        f"{res['serve_s']:.2f} s, K2 launches {res['k2_launches']} (phase 4: "
        f"{want_launches}), masks agree with phase 4's on {res['agree_with_phase4']!r} "
        f"({res['pixels_differing']} pixels differ), calibration ranges within "
        f"{res['calibration_max_rel_diff']:.2e} of phase 4's")
    if res["agree_with_phase4"] < 0.9999:
        raise AssertionError(f"masks agree with phase 4's on {res['agree_with_phase4']} < 0.9999")

    # resume training from the imported checkpoint, epoch 1 profiled
    tout = os.path.join(work, "migrated_train")
    torch.cuda.synchronize()
    warp.LAUNCHES = 0
    t0 = time.perf_counter()
    result = train_cli([
        "--train_database", os.path.join(work, "train.lmdb"),
        "--test_database", os.path.join(work, "test.lmdb"), "--output_dir", tout,
        "--resume_checkpoint", imported, "--profile_steps", str(PROFILE_STEPS),
        "--batch_size", str(TRAIN_BATCH), "--test_every_n_steps", str(MIGRATE_TEST_EVERY),
        "--max_epochs", "2", "--seed", str(seed), "--device", dev.type,
        "--base_features", str(BASE), "--dtype", "bfloat16",
        "--log_every_n_steps", str(MIGRATE_LOG_EVERY), "--reader_count", "2",
        "--learning_rate", str(TRAIN_LR)])
    torch.cuda.synchronize()
    res["train_s"] = time.perf_counter() - t0
    steps = 2 * (MIGRATE_TEST_EVERY + 1)
    res["train"] = {"steps": result.steps, "shear_launches": warp.LAUNCHES,
                    "train_losses": result.train_losses, "test_loss": result.test_loss}
    if result.steps != steps or warp.LAUNCHES != 3 * steps:
        raise AssertionError(f"{result.steps} steps and {warp.LAUNCHES} shear launches: "
                             f"expected {steps} and 3 per step")
    if not (np.isfinite(result.train_losses).all() and np.isfinite(result.test_loss).all()):
        raise AssertionError(f"non-finite losses: {result.train_losses} {result.test_loss}")
    trace = trace_analysis.analyze(os.path.join(tout, "profile"), top=12)
    if trace["device_plane"] is None:
        raise AssertionError(f"the profiled window holds no device events: {trace['note']}")
    shear = trace["groups"].get("K1 shear_rows", {}).get("count", 0)
    res["trace"] = {k: v for k, v in trace.items() if k != "top_kernels"}
    res["trace"]["top_kernels"] = [[ms, share, n, name[:120]]
                                   for ms, share, n, name in trace["top_kernels"]]
    log(f"resumed training: {result.steps} steps in {res['train_s']:.1f} s, {warp.LAUNCHES} "
        f"shear launches, losses {[round(v, 4) for v in result.train_losses]}, test "
        f"{result.test_loss}; trace of {trace['steps']} steps: {trace['total_ms']:.1f} ms of "
        f"device time ({trace['ms_per_step']:.1f} ms/step), busy {trace['busy_share']:.1%} "
        f"of {trace['window_ms']:.1f} ms (steps "
        f"{', '.join(f'{ms:.1f}' for ms in trace['step_wall_ms'])} ms), K1 launches {shear}")
    phase6 = train_res["profile_train"]["by_group"]
    for group, g in trace["groups"].items():
        was = phase6.get(group, {}).get("share")
        log(f"  {group:<18} {g['ms']:9.2f} ms {g['share']:6.1%} x{g['count']:<6d} (phase 6 "
            f"profile_train: {'-' if was is None else f'{was:.1%}'})")
    if trace["steps"] != PROFILE_STEPS or shear != 3 * PROFILE_STEPS or \
            trace["busy_share"] is None:
        raise AssertionError(f"trace: {trace['steps']} steps, {shear} shear launches, busy "
                             f"{trace['busy_share']}: expected {PROFILE_STEPS}, "
                             f"{3 * PROFILE_STEPS} and a share")

    # the event files: CRCs checked by reading, scalars per tag counted
    (tb,) = glob.glob(os.path.join(tout, "tensorboard-*"))
    counts = {}
    for split in ("train", "test"):
        (path,) = glob.glob(os.path.join(tb, split, "events.out.tfevents.*"))
        events = tb_events.read_events(path)
        if events[0].get("file_version") != tb_events.FILE_VERSION:
            raise AssertionError(f"{path}: first event {events[0]}")
        counts[split] = {}
        for e in events[1:]:
            counts[split][e["tag"]] = counts[split].get(e["tag"], 0) + 1
        if split == "train":
            losses = [e["value"] for e in events if e.get("tag") == "loss"]
            if losses != [float(np.float32(v)) for v in result.train_losses]:
                raise AssertionError(f"train loss events {losses} vs {result.train_losses}")
    n = len(result.train_losses)
    want = {"train": {"loss": n, "accuracy": n, "images_per_sec": n - 1},
            "test": {"loss": 2, "accuracy": 2}}
    res["event_counts"] = counts
    if counts != want:
        raise AssertionError(f"event counts {counts}, expected {want}")
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"event files: {counts}, CRCs checked; phase 8 took {res['phase_s']:.1f} s")
    return res


# phase 9: multi-GPU paths on one card. (a) NCCL at world size 1 through
# torchrun: two epochs of MG_TEST_EVERY + 1 steps; (b) two gloo ranks of
# DP_BATCH against one process of 2 * DP_BATCH at DP_BASE, DP_SIZE^2, f32,
# DP_STEPS steps, ZeRO-1; (c) tiles sharded over [card, card]; (d) two
# striped serving ranks
MG_TEST_EVERY, MG_LOG_EVERY = 6, 3
DP_BASE, DP_SIZE, DP_BATCH, DP_STEPS = 16, 256, 4, 3
# (b)'s gradient gate: per-tensor relative L2 error of the first step's
# gradients. Last-bit differences in the BatchNorm sums grow through the
# f32 variance's cancellation to about 1e-2 at these shapes; with the
# sync-BN all-reduce's gradient cut, the error is of order 1
DP_GRAD_L2 = 5e-2

# run by torchrun: the module's main with the launch counters read after,
# "{rank}" in an argument replaced by the rank
_TORCHRUN_CHILD = """import importlib, json, os, sys

if __name__ == "__main__":  # the readers' forkserver workers import __main__
    from tpuseg_torch.infer import head_kernel
    from tpuseg_torch.ops import warp
    rank = os.environ["RANK"]
    args = [a.replace("{rank}", rank) for a in sys.argv[2:]]
    result = importlib.import_module(sys.argv[1]).main(args)
    out = {"k1_launches": warp.LAUNCHES, "k2_launches": head_kernel.LAUNCHES}
    if isinstance(result, list):
        out["written"] = result
    else:
        out.update(steps=result.steps, train_losses=result.train_losses,
                   test_loss=result.test_loss, checkpoint_path=result.checkpoint_path)
    print(f"RANK {rank} RESULT " + json.dumps(out), flush=True)
"""


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def wait_all(procs, timeout: float) -> None:
    """Wait for every process; on a timeout or a failure kill the process
    groups still alive (each started in a session of its own)."""
    import signal

    deadline = time.perf_counter() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.perf_counter()))
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()


def run_torchrun(nproc: int, module: str, args, logbase: str, timeout: float = 600) -> dict:
    """``module``'s main under ``python -m torch.distributed.run --standalone
    --nproc_per_node nproc`` from the checkout's root, each rank counting
    its K1 and K2 launches (``_TORCHRUN_CHILD``): wall time, output and
    each rank's result. Fails on a non-zero exit."""
    root = os.path.dirname(os.path.abspath(__file__))
    script = logbase + "_child.py"
    with open(script, "w") as f:
        f.write(_TORCHRUN_CHILD)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(nproc), script, module, *args]
    # the child script lives in the work folder: the checkout goes on its path
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    with open(logbase + ".out", "w") as out, open(logbase + ".err", "w") as err:
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, cwd=root, env=env, stdout=out, stderr=err,
                                start_new_session=True)
        wait_all([proc], timeout)
        wall = time.perf_counter() - t0
    with open(logbase + ".out") as f:
        stdout = f.read()
    if proc.returncode != 0:
        with open(logbase + ".err") as f:
            raise AssertionError(f"torchrun {module} exited {proc.returncode}: "
                                 f"{f.read()[-3000:]}")
    ranks = {int(r): json.loads(j)
             for r, j in re.findall(r"^RANK (\d+) RESULT (.*)$", stdout, re.M)}
    if sorted(ranks) != list(range(nproc)):
        raise AssertionError(f"torchrun {module}: results of ranks {sorted(ranks)}")
    return {"wall_s": wall, "stdout": stdout, "ranks": ranks}


def raw_batch(path: str, n: int, dev):
    """The first ``n`` records of a database as a raw card batch."""
    import numpy as np
    import torch

    from tpuseg_torch.data.build_db import deserialize_image_mask_pair
    from tpuseg_torch.data.recordstore import RecordReader

    with RecordReader(path) as r:
        recs = [deserialize_image_mask_pair(r.get_at(i)) for i in range(n)]
    return (torch.from_numpy(np.stack([a.astype(np.int32) for a, _ in recs])).to(dev),
            torch.from_numpy(np.stack([m for _, m in recs])).to(dev))


def dp_worker(rank: int, world: int, port: int, seed: int, out_path: str,
              device: str = "cuda:0", spatial: int = 1, height: int = DP_SIZE) -> None:
    """Phase 9 (b)'s and phase 10 (a)'s and (c)'s rank ``rank`` of ``world``
    on the card (world 1: one process, no process group) on a mesh of
    ``spatial`` row shards: an eval step, then DP_STEPS raw steps at
    DP_BASE on ``height`` x DP_SIZE images, f32 with TF32 off, augmentation
    and dropout on, this rank's data shard of each global batch of 2 *
    DP_BATCH (ZeRO-1 with a group); saves its eval, losses, gradients,
    state, K1 launches and halo and gather counts to ``out_path``."""
    import numpy as np
    import torch

    from tpuseg_torch.models.unet import UNet
    from tpuseg_torch.ops import warp
    from tpuseg_torch.parallel import distributed
    from tpuseg_torch.parallel import mesh as mesh_lib
    from tpuseg_torch.train.steps import create_train_state

    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    try:
        if world > 1:
            distributed.initialize_distributed(f"127.0.0.1:{port}", world, rank,
                                               backend="gloo", timeout_s=300)
        state = create_train_state(UNet(NCLS, 1, DP_BASE, "float32"), seed, TRAIN_LR, dev)
        mesh = mesh_lib.make_mesh(dev, spatial=spatial)
        tstep, estep = mesh_lib.make_parallel_raw_steps(state.model, mesh, NCLS,
                                                        shard_optimizer=world > 1, state=state)
        pairs = blob_pairs(DP_STEPS * 2 * DP_BATCH, height, DP_SIZE, seed + 9)
        per = 2 * DP_BATCH // mesh.data

        def batch(step):
            mine = pairs[step * 2 * DP_BATCH:][mesh.data_rank * per:(mesh.data_rank + 1) * per]
            img = torch.from_numpy(np.stack([a[..., None].astype(np.int32) for a, _ in mine]))
            return img.to(dev), torch.from_numpy(np.stack([m for _, m in mine])).to(dev)

        m = estep(state, *batch(0))
        out = {"losses": [], "grads": [], "world": world,
               "optimizer": type(state.optimizer).__name__,
               "eval": [m["loss"].item(), m["accuracy"].item()]}
        warp.LAUNCHES = 0
        for step in range(DP_STEPS):
            out["losses"].append(tstep(state, *batch(step))["loss"].item())
            # copies: on the CPU .cpu() would alias the state updated in place
            out["grads"].append({k: p.grad.detach().cpu().clone() for k, p in
                                 state.model.named_parameters()})
            if step == 0:
                out["state_dict0"] = {k: v.detach().cpu().clone()
                                      for k, v in state.model.state_dict().items()}
        out["k1_launches"] = warp.LAUNCHES
        out["state_dict"] = {k: v.detach().cpu() for k, v in state.model.state_dict().items()}
        if mesh.halo is not None:
            out["halo"] = {"route": mesh.halo.route, "exchanges": mesh.halo.exchanges,
                           "bytes_sent": mesh.halo.bytes_sent, "gathers": mesh.halo.gathers,
                           "gather_bytes": mesh.halo.gather_bytes}
        torch.save(out, out_path)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
        distributed.shutdown_distributed()


def serve_phase4_folder(ckpt: str, work: str, out_name: str, dev, main_res: dict) -> int:
    """Serve phase 4's folder from the training checkpoint ``ckpt`` through
    ``cli.inference --quantize int8_blocked`` as phase 4 served (radius
    pinned), with K2's count zeroed just before and read just after; fails
    unless every mask holds class labels and K2 launched as often as in
    phase 4. Returns K2's launches."""
    import numpy as np
    import torch

    from tpuseg_torch.cli.inference import main as infer_cli
    from tpuseg_torch.infer import head_kernel
    from tpuseg_torch.utils.imagio import imread

    head_kernel.LAUNCHES = 0
    written = infer_cli(["--checkpoint_filepath", ckpt, "--image_folder",
                         os.path.join(work, "images"), "--output_folder",
                         os.path.join(work, out_name), "--number_classes", str(NCLS),
                         "--number_channels", "1", "--base_features", str(BASE), "--device",
                         dev.type, "--tile_size", str(TILE), "--batch_size", str(BATCH),
                         "--radius", str(main_res["radius"]), "--quantize", "int8_blocked"])
    torch.cuda.synchronize()
    launches = head_kernel.LAUNCHES
    want = main_res["launches"]["blocked_head_argmax"]
    for path in written:
        m = imread(path)
        if not np.isin(m, np.arange(NCLS)).all():
            raise AssertionError(f"{path}: labels {np.unique(m)[:8]}")
    if len(written) != 1 + N_SMALL or launches != want:
        raise AssertionError(f"served {len(written)} masks with {launches} K2 launches; "
                             f"phase 4: {1 + N_SMALL}, {want}")
    return launches


def phase_multigpu_nccl(seed: int, work: str, dev, main_res: dict, train_res: dict) -> dict:
    """Phase 9 (a): the train CLI under torchrun at world size 1 (NCCL,
    DDP, sync-BN, ZeRO-1) on phase 6's databases, its checkpoint served as
    phase 4 served its model, and in this process the steady img/s of the
    DDP + sync-BN + ZeRO-1 step beside the plain step, in turns."""
    import numpy as np
    import torch

    from tpuseg_torch.aug.device import DeviceAugmentParams
    from tpuseg_torch.models.unet import UNet
    from tpuseg_torch.parallel import distributed
    from tpuseg_torch.parallel import mesh as mesh_lib
    from tpuseg_torch.train.steps import create_train_state, make_raw_steps

    res: dict = {}
    steps = 2 * (MG_TEST_EVERY + 1)
    run = run_torchrun(1, "tpuseg_torch.cli.train", [
        "--train_database", os.path.join(work, "train.lmdb"),
        "--test_database", os.path.join(work, "test.lmdb"),
        "--output_dir", os.path.join(work, "mg_train"), "--multihost", "1",
        "--shard_optimizer", "1", "--batch_size", str(TRAIN_BATCH),
        "--test_every_n_steps", str(MG_TEST_EVERY), "--max_epochs", "2", "--seed", str(seed),
        "--device", dev.type, "--base_features", str(BASE), "--dtype", "bfloat16",
        "--log_every_n_steps", str(MG_LOG_EVERY), "--reader_count", "2",
        "--learning_rate", str(TRAIN_LR)], os.path.join(work, "mg_train_log"))
    backend = "nccl" if dev.type == "cuda" else "gloo"
    r = run["ranks"][0]
    res["cli"] = {"wall_s": run["wall_s"], **{k: r[k] for k in ("steps", "k1_launches",
                                                               "train_losses", "test_loss")}}
    joined = re.search(r"backend (\w+)", run["stdout"])
    res["backend"] = joined.group(1) if joined else None
    log(f"(a) torchrun world 1: backend {res['backend']}, {r['steps']} steps in "
        f"{run['wall_s']:.1f} s, {r['k1_launches']} K1 launches, losses "
        f"{[round(v, 4) for v in r['train_losses']]}, test {r['test_loss']}")
    if res["backend"] != backend:
        raise AssertionError(f"the world-size-1 run joined {res['backend']}, not {backend}")
    if "devices = 1 over 1 host(s), global_batch_size = 8" not in run["stdout"]:
        raise AssertionError("the world-size-1 run did not print its data-parallel layout")
    if r["steps"] != steps or r["k1_launches"] != 3 * steps:
        raise AssertionError(f"{r['steps']} steps, {r['k1_launches']} K1 launches: expected "
                             f"{steps} and 3 per step")
    losses = r["train_losses"]
    if not (np.isfinite(losses).all() and np.isfinite(r["test_loss"]).all()
            and losses[-1] < losses[0]):
        raise AssertionError(f"losses not finite and falling: {losses} {r['test_loss']}")

    # its checkpoint serves phase 4's folder as phase 4 served (radius pinned)
    res["served_k2_launches"] = serve_phase4_folder(r["checkpoint_path"], work, "mg_served",
                                                    dev, main_res)
    log(f"(a) its checkpoint served phase 4's folder: {1 + N_SMALL} masks, "
        f"{res['served_k2_launches']} K2 launches (phase 4's count)")

    # steady img/s: the DDP + sync-BN + ZeRO-1 step at world size 1 (NCCL)
    # beside the plain step, 3 windows of 10 steps each, in turns
    distributed.initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0, backend=backend)
    try:
        mesh = mesh_lib.make_mesh(dev)
        params = DeviceAugmentParams()
        raw_img, raw_msk = raw_batch(os.path.join(work, "train.lmdb"), TRAIN_BATCH, dev)
        plain_state = create_train_state(UNet(NCLS, 1, BASE, "bfloat16"), seed, TRAIN_LR, dev)
        dp_state = create_train_state(UNet(NCLS, 1, BASE, "bfloat16"), seed, TRAIN_LR, dev)
        arms = {"plain": (plain_state, make_raw_steps(NCLS, params)[0]),
                "ddp_syncbn_zero1": (dp_state, mesh_lib.make_parallel_raw_steps(
                    dp_state.model, mesh, NCLS, params, shard_optimizer=True,
                    state=dp_state)[0])}
        mesh_lib.warm_collectives(mesh)
        for state, step in arms.values():
            for _ in range(3):
                step(state, raw_img, raw_msk)
        windows = {k: [] for k in arms}
        for order in (("plain", "ddp_syncbn_zero1"), ("ddp_syncbn_zero1", "plain"),
                      ("plain", "ddp_syncbn_zero1")):
            for k in order:
                state, step = arms[k]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(10):
                    m = step(state, raw_img, raw_msk)
                m["loss"].item()
                windows[k].append(TRAIN_BATCH * 10 / (time.perf_counter() - t0))
    finally:
        distributed.shutdown_distributed()
    res["img_per_s_windows"] = windows
    res["img_per_s"] = {k: sorted(v)[1] for k, v in windows.items()}
    res["ratio"] = res["img_per_s"]["ddp_syncbn_zero1"] / res["img_per_s"]["plain"]
    log(f"(a) steady img/s ({TRAIN_SIZE}^2, batch {TRAIN_BATCH}, base {BASE}, bf16), median "
        "of 3 windows in turns: "
        f"plain {res['img_per_s']['plain']:.2f}, DDP + sync-BN + ZeRO-1 at world size 1 "
        f"{res['img_per_s']['ddp_syncbn_zero1']:.2f} ({res['ratio']:.3f}x; phase 6 plain "
        f"{train_res['img_per_s']:.2f})")
    return res


def start_children(work: str, name: str, calls, env=None) -> list:
    """Start each of ``calls`` (Python source calling a function of this
    module) as a process of its own in the checkout's root, in a session of
    its own (``wait_all`` kills it), with its output in
    ``work/{name}{i}.log``."""
    root = os.path.dirname(os.path.abspath(__file__))
    procs = []
    for i, call in enumerate(calls):
        with open(os.path.join(work, f"{name}{i}.log"), "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", f"import chip_smoke; chip_smoke.{call}"],
                cwd=root, stdout=f, stderr=subprocess.STDOUT, start_new_session=True,
                env=dict(os.environ, **(env or {}))))
    return procs


def check_children(procs, work: str, name: str) -> None:
    """Fail with the end of its log when a child exited other than 0."""
    for i, p in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(work, f"{name}{i}.log")) as f:
                raise AssertionError(f"{name} {i} exited {p.returncode}: {f.read()[-3000:]}")


def phase_multigpu_gloo(seed: int, work: str, dev) -> dict:
    """Phase 9 (b): two gloo ranks on the one card (DP_BATCH each, ZeRO-1)
    against one process on the global batch, in this process. Gates: the
    ranks bit-equal to each other; the first step's loss rtol 1e-5, its
    gradients within DP_GRAD_L2 per tensor and its BatchNorm running
    statistics atol 1e-5 (tests/test_parallel.py); the later losses rtol
    1e-3; 3 K1 launches a step on each rank. Each step's gradient error and
    the parameters after the first and the last step are reported, not
    gated: the statistics' last-bit differences (the ranks sum in another
    order) pass through the f32 variance E[x^2] - E[x]^2, which cancels on
    channels whose mean is large against their spread, and Keras Adam's
    normalized update and the following steps amplify what is left."""
    import torch

    port = free_port()
    paths = [os.path.join(work, f"dp_rank{r}.pt") for r in range(2)]
    procs = start_children(work, "dp_rank", [
        f"dp_worker({r}, 2, {port}, {seed}, {paths[r]!r}, {str(dev)!r})" for r in range(2)])
    t0 = time.perf_counter()
    ref_path = os.path.join(work, "dp_one.pt")
    try:
        dp_worker(0, 1, 0, seed, ref_path, str(dev))
    finally:
        wait_all(procs, 600)
    wall = time.perf_counter() - t0
    check_children(procs, work, "dp_rank")
    ranks = [torch.load(p, weights_only=False) for p in paths]
    one = torch.load(ref_path, weights_only=False)
    differ = [k for k in ranks[0]["state_dict"]
              if not torch.equal(ranks[0]["state_dict"][k], ranks[1]["state_dict"][k])]
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(ranks[0]["losses"], one["losses"])]
    grad_l2 = [max(((got[k] - g).norm() / g.norm()).item() for k, g in want.items())
               for got, want in zip(ranks[0]["grads"], one["grads"])]

    def params_close(got, want):
        """Share of parameter elements within tests/test_torch_steps.py's
        atol 1e-6 + rtol 1e-4, the largest parameter difference, and the
        largest BatchNorm running-statistics difference."""
        n = n_ok = 0
        max_diff = max_stat = 0.0
        for k, v in want.items():
            if "num_batches" in k:
                continue
            d = (got[k] - v).abs()
            if "running" in k:
                max_stat = max(max_stat, d.max().item())
                continue
            n += d.numel()
            n_ok += int((d <= 1e-6 + 1e-4 * v.abs()).sum())
            max_diff = max(max_diff, d.max().item())
        return n_ok / n, max_diff, max_stat

    first = params_close(ranks[0]["state_dict0"], one["state_dict0"])
    last = params_close(ranks[0]["state_dict"], one["state_dict"])
    res = {"wall_s": wall, "losses_ranks": [r["losses"] for r in ranks],
           "losses_one": one["losses"], "loss_rel_err": loss_rel,
           "grad_l2_rel_err_max_by_step": grad_l2, "ranks_state_differ": differ,
           "params_within_steps_tol": {"first_step": first[0], "last_step": last[0]},
           "param_max_abs_diff": {"first_step": first[1], "last_step": last[1]},
           "bn_running_max_abs_diff_first_step": first[2],
           "k1_launches_ranks": [r["k1_launches"] for r in ranks],
           "optimizer_ranks": [r["optimizer"] for r in ranks]}
    log(f"(b) two gloo ranks of {DP_BATCH} on one card (base {DP_BASE}, {DP_SIZE}^2, f32, "
        f"ZeRO-1) vs one process of {2 * DP_BATCH}: loss rel err {loss_rel}, gradient L2 "
        f"rel err max by step {[f'{e:.2e}' for e in grad_l2]}, ranks' states differ in "
        f"{len(differ)} tensors; after the first step parameters within the step "
        f"tolerance {first[0]:.4f} (max diff {first[1]:.2e}), BN running statistics max "
        f"diff {first[2]:.2e}; after step {DP_STEPS} {last[0]:.4f} (max diff "
        f"{last[1]:.2e}); K1 launches {res['k1_launches_ranks']}, {wall:.1f} s")
    if differ or ranks[0]["losses"] != ranks[1]["losses"]:
        raise AssertionError(f"the ranks diverged: {differ[:5]}")
    if (loss_rel[0] > 1e-5 or max(loss_rel[1:]) > 1e-3 or grad_l2[0] > DP_GRAD_L2
            or first[2] > 1e-5):
        raise AssertionError(f"two ranks against one process out of tolerance: {res}")
    if res["k1_launches_ranks"] != [3 * DP_STEPS] * 2 or \
            res["optimizer_ranks"] != ["ZeroRedundancyOptimizer"] * 2:
        raise AssertionError(f"ranks: {res['k1_launches_ranks']} K1 launches, optimizers "
                             f"{res['optimizer_ranks']}")
    return res


def sharded_launches(n_tiles: int, shards: int) -> int:
    """K2 launches of one tiled pass with a device list of ``shards``
    entries: every chunk full, the last group padded."""
    group = BATCH * shards
    return -(-n_tiles // group) * shards


def phase_multigpu_serving(seed: int, work: str, dev, main_res: dict) -> dict:
    """Phase 9 (c) and (d): the 4096^2 image with its tiles sharded over
    [card, card] against [card] (masks bit-equal, K2 launches as
    predicted), and two torchrun ranks of the inference CLI striping phase
    4's folder on cuda:0 (each mask written once, agreeing with phase 4's,
    calibration scales equal on both ranks)."""
    import copy

    import torch

    from tpuseg_torch.data.preprocess import zscore_stats
    from tpuseg_torch.infer import head_kernel
    from tpuseg_torch.infer.runner import InferenceConfig, _quantized_predict_fn
    from tpuseg_torch.infer.tiled import inference_tiled, make_predict_fn
    from tpuseg_torch.utils.checkpoint import load_model
    from tpuseg_torch.utils.imagio import imread

    res: dict = {"sharded": {}}
    ckpt, imgdir, cal = (os.path.join(work, n) for n in ("model.pt", "images", "cal.json"))
    bf16 = load_model(ckpt, dtype="bfloat16", device=dev)
    big = imread(os.path.join(imgdir, "big.tif"))
    stats = zscore_stats(big)
    radius = main_res["radius"]
    side = -(-BIG // (TILE - 2 * radius))
    n_tiles = side * side
    cfg = InferenceConfig(ckpt, imgdir, work, NCLS, 1, base_features=BASE,
                          quantize="int8_blocked", calibration_in=cal)
    replicas = {"int8_blocked": _quantized_predict_fn(cfg, bf16, [], dev, replicas=2)[0],
                "none": [make_predict_fn(bf16), make_predict_fn(copy.deepcopy(bf16))]}
    for mode, fns in replicas.items():
        out = {}
        masks = {}
        for name, devs in (("one", [dev]), ("two", [dev, dev])):
            torch.cuda.synchronize()
            head_kernel.LAUNCHES = 0
            t0 = time.perf_counter()
            masks[name] = inference_tiled(big, fns[:len(devs)], TILE, radius, BATCH, NCLS,
                                          stats, dev, devices=devs)
            out[f"{name}_s"] = time.perf_counter() - t0
            out[f"k2_{name}"] = head_kernel.LAUNCHES
        plain = inference_tiled(big, fns[0], TILE, radius, BATCH, NCLS, stats, dev)
        out["pixels_differing"] = int((masks["one"] != masks["two"]).sum())
        out["agree_with_unpadded_engine"] = float((masks["one"] == plain).mean())
        want = ({"one": sharded_launches(n_tiles, 1), "two": sharded_launches(n_tiles, 2)}
                if mode == "int8_blocked" else {"one": 0, "two": 0})
        out["k2_predicted"] = want
        res["sharded"][mode] = out
        log(f"(c) {mode}: {n_tiles} tiles over [card, card] against [card]: "
            f"{out['pixels_differing']} pixels differ, K2 launches {out['k2_one']} and "
            f"{out['k2_two']} (predicted {want['one']} and {want['two']}), "
            f"{out['one_s']:.2f} and {out['two_s']:.2f} s; against the unpadded engine "
            f"{out['agree_with_unpadded_engine']}")
        if out["pixels_differing"] or (out["k2_one"], out["k2_two"]) != (want["one"],
                                                                        want["two"]):
            raise AssertionError(f"sharded serving ({mode}): {out}")

    # (d) the folder striped over two torchrun ranks on cuda:0
    out_dir = os.path.join(work, "mg_striped")
    run = run_torchrun(2, "tpuseg_torch.cli.inference", [
        "--checkpoint_filepath", ckpt, "--image_folder", imgdir, "--output_folder", out_dir,
        "--number_classes", str(NCLS), "--number_channels", "1", "--base_features", str(BASE),
        "--device", "cuda:0" if dev.type == "cuda" else "cpu", "--tile_size", str(TILE),
        "--batch_size", str(BATCH),
        "--seed", str(seed), "--quantize", "int8_blocked", "--multihost", "1",
        "--calibration_out", os.path.join(work, "mg_cal_rank{rank}.json")],
        os.path.join(work, "mg_serve_log"))
    written = [os.path.basename(p) for r in sorted(run["ranks"])
               for p in run["ranks"][r]["written"]]
    same = total = 0
    for name in written:
        a = imread(os.path.join(out_dir, name))
        b = imread(os.path.join(work, "masks_int8_blocked", name))
        if a.shape != b.shape:
            raise AssertionError(f"{name}: mask {a.shape} vs phase 4's {b.shape}")
        same += int((a == b).sum())
        total += a.size
    scales = []
    for r in range(2):
        with open(os.path.join(work, f"mg_cal_rank{r}.json")) as f:
            scales.append(json.load(f)["act_ranges"])
    with open(cal) as f:
        phase4 = json.load(f)["act_ranges"]
    res["striped"] = {
        "wall_s": run["wall_s"], "written_by_rank": {r: run["ranks"][r]["written"]
                                                     for r in sorted(run["ranks"])},
        "k2_launches_ranks": [run["ranks"][r]["k2_launches"] for r in range(2)],
        "agree_with_phase4": same / total, "pixels_differing": total - same,
        "scales_equal_across_ranks": scales[0] == scales[1],
        "scales_max_rel_diff_phase4": max(abs(scales[0][k] - v) / max(abs(v), 1e-30)
                                          for k, v in phase4.items())}
    st = res["striped"]
    log(f"(d) two striped ranks on cuda:0: {len(written)} masks written "
        f"({[len(v) for v in st['written_by_rank'].values()]} per rank) in "
        f"{run['wall_s']:.1f} s, agreeing with phase 4's on {st['agree_with_phase4']!r} "
        f"({st['pixels_differing']} pixels differ), K2 launches {st['k2_launches_ranks']}, "
        f"scales equal across ranks: {st['scales_equal_across_ranks']}, within "
        f"{st['scales_max_rel_diff_phase4']:.2e} of phase 4's")
    if sorted(written) != sorted(os.listdir(imgdir)) or len(set(written)) != len(written):
        raise AssertionError(f"striped ranks wrote {written}")
    if not st["scales_equal_across_ranks"] or st["agree_with_phase4"] < 0.9999:
        raise AssertionError(f"striped serving: {st}")
    return res


def phase_multigpu(seed: int, work: str, dev, main_res: dict, train_res: dict) -> dict:
    """Phase 9: the multi-GPU paths on the one card (module docstring)."""
    t0 = time.perf_counter()
    res = {"nccl": phase_multigpu_nccl(seed, work, dev, main_res, train_res),
           "gloo": phase_multigpu_gloo(seed, work, dev)}
    res.update(phase_multigpu_serving(seed, work, dev, main_res))
    res["phase_s"] = time.perf_counter() - t0
    log(f"phase 9 took {res['phase_s']:.1f} s")
    return res


# phase 10: spatial partitioning on the one card, two gloo ranks on cuda:0
# (NCCL refuses two ranks on one card), so the halos take the host-staged
# gloo route. (a) phase 9 (b)'s run at spatial 2 (data 1) against its one
# process; (b) train_model(spatial_partitions=2) in two processes on phase
# 6's databases, two epochs of SP_TEST_EVERY + 1 steps, then each rank
# times SP_WINDOWS windows of SP_STEPS steady steps and profiles
# SP_PROFILED steps
SP_TEST_EVERY, SP_LOG_EVERY = 6, 3
SP_WINDOWS, SP_STEPS, SP_PROFILED = 3, 5, 3
# (a)'s eval accuracy: a pixel of 2 * DP_BATCH * DP_SIZE^2 is 1.9e-6, and
# cuDNN may pick another algorithm for a half image, which can flip a
# near-tied argmax
SP_EVAL_ACC_ATOL = 1e-5
# (c): heights whose pool windows straddle the two ranks. (i) (a)'s run on
# SP_PARITY_H x DP_SIZE images (a rank's rows 120, 60, 30, 15 down the
# levels: gathered at level 3); (ii) train_model on SP_SIZE^2 records (264,
# 132, 66, 33: level 3), one epoch of SP_TEST_EVERY + 1 steps. That epoch
# is the warmup at lr / 10, so SP_LR puts it at phase 6's TRAIN_LR
SP_PARITY_H = 240
SP_SIZE, SP_N_TRAIN, SP_N_TEST, SP_LR, SP_STRADDLE_WINDOWS = 528, 24, 16, 10 * TRAIN_LR, 2


def spatial_train_worker(rank: int, port: int, seed: int, work: str, out_path: str,
                         device: str = "cuda:0", dbs: str = "", epochs: int = 2,
                         lr: float = TRAIN_LR, out_name: str = "sp_train",
                         windows: int = SP_WINDOWS) -> None:
    """Phase 10 (b)'s and (c)'s rank ``rank`` of 2 (``LOCAL_WORLD_SIZE=2`` in
    its environment: one host): ``train_model(spatial_partitions=2)`` for
    ``epochs`` epochs on the databases in ``dbs`` (default ``work``: phase
    6's) at base 64, bf16, a global batch of TRAIN_BATCH, with K1's count
    zeroed just before and read just after; then ``windows`` windows of
    steady steps of the same spatial step on a raw batch held on the card,
    timed, with the device memory's peak, and SP_PROFILED steps profiled
    for the halo exchange's and the row gather's shares. Saves its results
    as JSON to ``out_path``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpuseg_torch.aug.device import DeviceAugmentParams
    from tpuseg_torch.models.unet import UNet
    from tpuseg_torch.ops import warp
    from tpuseg_torch.parallel import distributed
    from tpuseg_torch.parallel import mesh as mesh_lib
    from tpuseg_torch.train.steps import create_train_state
    from tpuseg_torch.train.trainer import TrainConfig, train_model
    from tpuseg_torch.utils.profiling import spans

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    distributed.initialize_distributed(f"127.0.0.1:{port}", 2, rank, backend="gloo",
                                       timeout_s=600)
    try:
        train_db, test_db = (os.path.join(dbs or work, f"{n}.lmdb") for n in ("train", "test"))
        if cuda:
            torch.cuda.init()  # the peak counters exist once CUDA is initialised
            torch.cuda.reset_peak_memory_stats(dev)
        warp.LAUNCHES = 0
        t0 = time.perf_counter()
        result = train_model(TrainConfig(
            train_db, test_db, os.path.join(work, out_name), batch_size=TRAIN_BATCH,
            test_every_n_steps=SP_TEST_EVERY, max_epochs=epochs, seed=seed, dtype="bfloat16",
            base_features=BASE, spatial_partitions=2, log_every_n_steps=SP_LOG_EVERY,
            reader_count=2, learning_rate=lr, device=dev.type))
        sync()
        out = {"wall_s": time.perf_counter() - t0, "k1_launches": warp.LAUNCHES,
               "steps": result.steps, "train_losses": result.train_losses,
               "test_loss": result.test_loss, "checkpoint_path": result.checkpoint_path,
               "peak_mem_gib_main": (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                                     if cuda else None)}

        # the steady spatial step (DDP, sync-BN, halos) on one raw batch
        mesh = mesh_lib.make_mesh(dev, spatial=2)
        state = create_train_state(UNet(NCLS, 1, BASE, "bfloat16"), seed, TRAIN_LR, dev)
        tstep, _ = mesh_lib.make_parallel_raw_steps(state.model, mesh, NCLS,
                                                    DeviceAugmentParams())
        raw_img, raw_msk = raw_batch(train_db, TRAIN_BATCH, dev)
        halo = mesh.halo
        for _ in range(3):
            tstep(state, raw_img, raw_msk)
        sync()
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        sent = halo.exchanges, halo.bytes_sent, halo.gathers, halo.gather_bytes
        step_ms = []
        for _ in range(windows):
            sync()
            t0 = time.perf_counter()
            for _ in range(SP_STEPS):
                m = tstep(state, raw_img, raw_msk)
            m["loss"].item()
            step_ms.append((time.perf_counter() - t0) * 1e3 / SP_STEPS)
        n = windows * SP_STEPS
        out.update(step_ms_windows=step_ms, step_ms=sorted(step_ms)[len(step_ms) // 2],
                   peak_mem_gib_steady=(torch.cuda.max_memory_allocated(dev) / 2 ** 30
                                        if cuda else None),
                   halo_route=halo.route, exchanges_per_step=(halo.exchanges - sent[0]) / n,
                   halo_bytes_per_step=(halo.bytes_sent - sent[1]) / n,
                   gathers_per_step=(halo.gathers - sent[2]) / n,
                   gather_bytes_per_step=(halo.gather_bytes - sent[3]) / n)
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        sync()
        with spans(), profile(activities=activities) as prof:
            if cuda:
                profiler_lead_in(LEAD_IN)
            t0 = time.perf_counter()
            for _ in range(SP_PROFILED):
                tstep(state, raw_img, raw_msk)
            sync()
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = prof.key_averages()
        halo_ms = sum(e.cpu_time_total for e in events
                      if e.key.startswith("halo_exchange:")) / 1e3
        gather_ms = sum(e.cpu_time_total for e in events
                        if e.key.startswith(("row_gather:", "row_gather_backward:"))) / 1e3
        # the gloo ops' ranges (on gloo's threads; an asynchronous op, as
        # DDP's bucket all-reduces are, overlaps the step) and this rank's
        # kernel time (the other rank's kernels share the card)
        gloo_ms = {e.key: e.cpu_time_total / 1e3 for e in events if e.key.startswith("gloo:")}
        busy_ms = sum(e.device_time_total for e in events
                      if e.device_type == DeviceType.CUDA and "spin_kernel" not in e.key) / 1e3
        out["profile"] = {"steps": SP_PROFILED, "wall_ms": wall_ms, "halo_ms": halo_ms,
                          "halo_share": halo_ms / wall_ms, "gather_ms": gather_ms,
                          "gather_share": gather_ms / wall_ms, "gloo_ms": gloo_ms,
                          "kernel_ms": busy_ms, "kernel_share": busy_ms / wall_ms}
        with open(out_path, "w") as f:
            json.dump(out, f)
    finally:
        distributed.shutdown_distributed()


def phase_spatial_parity(seed: int, work: str, dev, height: int = DP_SIZE,
                         label: str = "(a)") -> dict:
    """Phase 10 (a), and (c) (i) at another ``height``: phase 9 (b)'s two
    gloo ranks at spatial 2 (data 1: each rank augments the global batch
    and trains on half of its rows) against one process (phase 9 (b)'s at
    DP_SIZE rows, else run here while the ranks run), with its gates
    (module docstring), and the eval step before training held to one
    process's: loss rtol 1e-5, accuracy within SP_EVAL_ACC_ATOL. The halo
    exchanges and row gathers must be those ``halo.split_level`` implies."""
    import torch

    from tpuseg_torch.parallel.halo import split_level

    name = "sp_rank" if height == DP_SIZE else f"sp{height}_rank"
    port = free_port()
    paths = [os.path.join(work, f"{name}{r}.pt") for r in range(2)]
    t0 = time.perf_counter()
    procs = start_children(work, name, [
        f"dp_worker({r}, 2, {port}, {seed}, {paths[r]!r}, {str(dev)!r}, spatial=2, "
        f"height={height})" for r in range(2)], env={"LOCAL_WORLD_SIZE": "2"})
    one_path = os.path.join(work, "dp_one.pt" if height == DP_SIZE else f"sp{height}_one.pt")
    try:
        if height != DP_SIZE:
            dp_worker(0, 1, 0, seed, one_path, str(dev), height=height)
    finally:
        wait_all(procs, 600)
    wall = time.perf_counter() - t0
    check_children(procs, work, name)
    ranks = [torch.load(p, weights_only=False) for p in paths]
    one = torch.load(one_path, weights_only=False)
    differ = [k for k in ranks[0]["state_dict"]
              if not torch.equal(ranks[0]["state_dict"][k], ranks[1]["state_dict"][k])]
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(ranks[0]["losses"], one["losses"])]
    grad_l2 = [max(((got[k] - g).norm() / g.norm()).item() for k, g in want.items())
               for got, want in zip(ranks[0]["grads"], one["grads"])]
    stat = max((ranks[0]["state_dict0"][k] - v).abs().max().item()
               for k, v in one["state_dict0"].items() if "running" in k)
    eval_rel = abs(ranks[0]["eval"][0] - one["eval"][0]) / abs(one["eval"][0])
    eval_acc = abs(ranks[0]["eval"][1] - one["eval"][1])
    level = split_level(height, 2)
    # an eval step's forward and DP_STEPS train steps' forward and backward
    # (enc1a's input takes no gradient): the row-sharded levels' 3x3 convs
    # exchange, and a gather runs once each way
    convs = 18 if level is None else 4 * (level + 1)
    want_counts = {"exchanges": convs + DP_STEPS * (2 * convs - 1),
                   "gathers": 0 if level is None else 1 + 2 * DP_STEPS}
    res = {"height": height, "split_level": level, "wall_s": wall,
           "losses_ranks": [r["losses"] for r in ranks],
           "losses_one": one["losses"], "loss_rel_err": loss_rel,
           "grad_l2_rel_err_max_by_step": grad_l2, "ranks_state_differ": differ,
           "bn_running_max_abs_diff_first_step": stat,
           "eval_ranks": [r["eval"] for r in ranks], "eval_one": one["eval"],
           "eval_loss_rel_err": eval_rel, "eval_acc_abs_err": eval_acc,
           "k1_launches_ranks": [r["k1_launches"] for r in ranks],
           "halo_ranks": [r["halo"] for r in ranks], "want_counts": want_counts}
    log(f"{label} two gloo ranks at spatial 2 on one card (base {DP_BASE}, {height} x "
        f"{DP_SIZE}, f32, ZeRO-1, global batch {2 * DP_BATCH}; rows gathered at level "
        f"{level}) vs one process: loss rel err {loss_rel}, "
        f"gradient L2 rel err max by step {[f'{e:.2e}' for e in grad_l2]}, BN running "
        f"statistics max diff {stat:.2e}, eval loss rel err {eval_rel:.2e} and accuracy "
        f"diff {eval_acc:.2e}, ranks' states differ in {len(differ)} tensors; K1 launches "
        f"{res['k1_launches_ranks']}; halo {ranks[0]['halo']}; {wall:.1f} s")
    if differ or ranks[0]["losses"] != ranks[1]["losses"] or \
            ranks[0]["eval"] != ranks[1]["eval"]:
        raise AssertionError(f"the ranks diverged: {differ[:5]}")
    if (loss_rel[0] > 1e-5 or max(loss_rel[1:]) > 1e-3 or grad_l2[0] > DP_GRAD_L2
            or stat > 1e-5 or eval_rel > 1e-5 or eval_acc > SP_EVAL_ACC_ATOL):
        raise AssertionError(f"spatial ranks against one process out of tolerance: {res}")
    if res["k1_launches_ranks"] != [3 * DP_STEPS] * 2:
        raise AssertionError(f"ranks: {res['k1_launches_ranks']} K1 launches")
    for r in ranks:
        if {k: r["halo"][k] for k in want_counts} != want_counts:
            raise AssertionError(f"halo counts {r['halo']}, expected {want_counts}")
    return res


def phase_spatial_train(seed: int, work: str, dev, main_res: dict, train_res: dict) -> dict:
    """Phase 10 (b), the slice's main path: ``train_model(spatial_partitions
    =2)`` in two processes on cuda:0 over gloo (``spatial_train_worker``).
    Gates: both ranks report the same losses, finite and falling; 3 K1
    launches a step on each; one checkpoint, from rank 0, which serves phase
    4's folder with phase 4's K2 count. Reports the steady step against
    phase 6's plain step (two ranks share the card: overhead, not scaling),
    the halo exchange's route, bytes and share of a profiled step, and the
    peak device memory per rank."""
    import numpy as np

    import shutil

    out = os.path.join(work, "sp_train")
    shutil.rmtree(out, ignore_errors=True)  # its artifacts are counted below
    port = free_port()
    paths = [os.path.join(work, f"sp_train_rank{r}.json") for r in range(2)]
    t0 = time.perf_counter()
    procs = start_children(work, "sp_train_rank", [
        f"spatial_train_worker({r}, {port}, {seed}, {work!r}, {paths[r]!r}, {str(dev)!r})"
        for r in range(2)], env={"LOCAL_WORLD_SIZE": "2"})
    wait_all(procs, 900)
    wall = time.perf_counter() - t0
    check_children(procs, work, "sp_train_rank")
    ranks = []
    for path in paths:
        with open(path) as f:
            ranks.append(json.load(f))
    with open(os.path.join(work, "sp_train_rank0.log")) as f:
        stdout = f.read()
    steps = 2 * (SP_TEST_EVERY + 1)
    r0 = ranks[0]
    res = {"wall_s": wall, "steps": r0["steps"], "train_losses": r0["train_losses"],
           "test_loss": r0["test_loss"], "k1_launches_ranks": [r["k1_launches"] for r in ranks],
           "halo_route": r0["halo_route"], "exchanges_per_step": r0["exchanges_per_step"],
           "halo_bytes_per_step": r0["halo_bytes_per_step"],
           "step_ms_ranks": [r["step_ms"] for r in ranks],
           "step_ms_windows_ranks": [r["step_ms_windows"] for r in ranks],
           "plain_step_ms_phase6": train_res["step_ms"],
           "profile_ranks": [r["profile"] for r in ranks],
           "peak_mem_gib_main_ranks": [r["peak_mem_gib_main"] for r in ranks],
           "peak_mem_gib_steady_ranks": [r["peak_mem_gib_steady"] for r in ranks],
           "peak_mem_gib_steady_phase6": train_res["peak_mem_gib_steady"]}
    log(f"(b) train_model(spatial_partitions=2), two ranks on one card: {r0['steps']} steps "
        f"in {r0['wall_s']:.1f} s, K1 launches {res['k1_launches_ranks']}, losses "
        f"{[round(v, 4) for v in r0['train_losses']]}, test {r0['test_loss']}")
    for r in ranks[1:]:
        if (r["train_losses"], r["test_loss"], r["steps"]) != \
                (r0["train_losses"], r0["test_loss"], r0["steps"]):
            raise AssertionError(f"the ranks report different runs: {r0} {r}")
    if f"devices = 2 over 1 host(s), global_batch_size = {TRAIN_BATCH}" not in stdout:
        raise AssertionError("the spatial run did not print its layout")
    if f"halo route {r0['halo_route']}" not in stdout:
        raise AssertionError("the spatial run did not name its halo route")
    if r0["steps"] != steps or res["k1_launches_ranks"] != [3 * steps] * 2:
        raise AssertionError(f"{r0['steps']} steps, {res['k1_launches_ranks']} K1 launches: "
                             f"expected {steps} and 3 per step on each rank")
    losses = r0["train_losses"]
    if not (np.isfinite(losses).all() and np.isfinite(r0["test_loss"]).all()
            and losses[-1] < losses[0]):
        raise AssertionError(f"losses not finite and falling: {losses} {r0['test_loss']}")
    boards = [d for d in os.listdir(out) if d.startswith("tensorboard-")]
    if not os.path.isfile(r0["checkpoint_path"]) or len(boards) != 1:
        raise AssertionError(f"artifacts: checkpoint {r0['checkpoint_path']}, event folders "
                             f"{boards}")
    res["served_k2_launches"] = serve_phase4_folder(r0["checkpoint_path"], work,
                                                    "sp_served", dev, main_res)
    prof = r0["profile"]
    log(f"(b) its checkpoint served phase 4's folder with {res['served_k2_launches']} K2 "
        f"launches (phase 4's count)")
    log(f"(b) steady spatial step ({TRAIN_SIZE}^2, global batch {TRAIN_BATCH}, base {BASE}, "
        f"bf16, two ranks on one card): {res['step_ms_ranks']} ms a step on each rank "
        f"(median of {SP_WINDOWS} windows of {SP_STEPS}) against phase 6's plain step "
        f"{train_res['step_ms']:.2f} ms; halo route {r0['halo_route']}, "
        f"{r0['exchanges_per_step']:.0f} exchanges and {r0['halo_bytes_per_step'] / 1e6:.2f} "
        f"MB sent a step a rank; halo share of {SP_PROFILED} profiled steps "
        f"{[round(p['halo_share'], 4) for p in res['profile_ranks']]} "
        f"({prof['halo_ms']:.1f} of {prof['wall_ms']:.1f} ms on rank 0; its kernels "
        f"{prof['kernel_ms']:.1f} ms, gloo ops' ranges "
        f"{ {k: round(v, 1) for k, v in prof['gloo_ms'].items()} } ms); peak memory per "
        f"rank {res['peak_mem_gib_steady_ranks']} GiB steady, "
        f"{res['peak_mem_gib_main_ranks']} GiB in train_model (phase 6 steady: "
        f"{train_res['peak_mem_gib_steady']})")
    return res


def phase_spatial_straddle_train(seed: int, work: str, dev, train_b: dict) -> dict:
    """Phase 10 (c) (ii): ``train_model(spatial_partitions=2)`` in two
    processes on cuda:0 over gloo on SP_SIZE^2 records, whose fourth pool
    window straddles the ranks (``spatial_train_worker``). Gates: both
    ranks report the same losses, finite and falling; the trainer names the
    gathered level; 3 K1 launches a step on each; 2 row gathers a steady
    step. Reports the steady step against (b)'s, the gather's bytes a step
    and share of the profiled steps, and the peak device memory per rank."""
    import shutil

    import numpy as np

    from tpuseg_torch.parallel.halo import split_level

    dbs = os.path.join(work, f"sp{SP_SIZE}")
    t0 = time.perf_counter()
    write_train_dbs(dbs, seed, SP_SIZE, SP_N_TRAIN, SP_N_TEST)
    write_s = time.perf_counter() - t0
    name = f"sp{SP_SIZE}_train"
    shutil.rmtree(os.path.join(work, name), ignore_errors=True)
    port = free_port()
    paths = [os.path.join(work, f"{name}_rank{r}.json") for r in range(2)]
    t0 = time.perf_counter()
    procs = start_children(work, f"{name}_rank", [
        f"spatial_train_worker({r}, {port}, {seed}, {work!r}, {paths[r]!r}, {str(dev)!r}, "
        f"dbs={dbs!r}, epochs=1, lr={SP_LR!r}, out_name={name!r}, "
        f"windows={SP_STRADDLE_WINDOWS})" for r in range(2)], env={"LOCAL_WORLD_SIZE": "2"})
    wait_all(procs, 600)
    wall = time.perf_counter() - t0
    check_children(procs, work, f"{name}_rank")
    ranks = []
    for path in paths:
        with open(path) as f:
            ranks.append(json.load(f))
    with open(os.path.join(work, f"{name}_rank0.log")) as f:
        stdout = f.read()
    steps = SP_TEST_EVERY + 1
    level = split_level(SP_SIZE, 2)
    r0 = ranks[0]
    res = {"size": SP_SIZE, "split_level": level, "write_dbs_s": write_s, "wall_s": wall,
           "steps": r0["steps"], "train_losses": r0["train_losses"],
           "test_loss": r0["test_loss"], "k1_launches_ranks": [r["k1_launches"] for r in ranks],
           "halo_route": r0["halo_route"], "exchanges_per_step": r0["exchanges_per_step"],
           "halo_bytes_per_step": r0["halo_bytes_per_step"],
           "gathers_per_step": r0["gathers_per_step"],
           "gather_bytes_per_step": r0["gather_bytes_per_step"],
           "step_ms_ranks": [r["step_ms"] for r in ranks],
           "step_ms_windows_ranks": [r["step_ms_windows"] for r in ranks],
           "step_ms_ranks_b": train_b["step_ms_ranks"],
           "profile_ranks": [r["profile"] for r in ranks],
           "peak_mem_gib_main_ranks": [r["peak_mem_gib_main"] for r in ranks],
           "peak_mem_gib_steady_ranks": [r["peak_mem_gib_steady"] for r in ranks],
           "peak_mem_gib_steady_ranks_b": train_b["peak_mem_gib_steady_ranks"]}
    log(f"(c) (ii) train_model(spatial_partitions=2) on {SP_SIZE}^2 records (rows gathered "
        f"at level {level}), two ranks on one card: {r0['steps']} steps in "
        f"{r0['wall_s']:.1f} s, K1 launches {res['k1_launches_ranks']}, losses "
        f"{[round(v, 4) for v in r0['train_losses']]}, test {r0['test_loss']}")
    for r in ranks[1:]:
        if (r["train_losses"], r["test_loss"], r["steps"]) != \
                (r0["train_losses"], r0["test_loss"], r0["steps"]):
            raise AssertionError(f"the ranks report different runs: {r0} {r}")
    if f"rows gathered at level {level}, before pool {level + 1}" not in stdout:
        raise AssertionError("the straddling run did not name its gathered level")
    if r0["steps"] != steps or res["k1_launches_ranks"] != [3 * steps] * 2:
        raise AssertionError(f"{r0['steps']} steps, {res['k1_launches_ranks']} K1 launches: "
                             f"expected {steps} and 3 per step on each rank")
    losses = r0["train_losses"]
    if not (np.isfinite(losses).all() and np.isfinite(r0["test_loss"]).all()
            and losses[-1] < losses[0]):
        raise AssertionError(f"losses not finite and falling: {losses} {r0['test_loss']}")
    if any(r["gathers_per_step"] != 2 for r in ranks):
        raise AssertionError(f"row gathers a step: {[r['gathers_per_step'] for r in ranks]}")
    prof = r0["profile"]
    log(f"(c) (ii) steady straddling step ({SP_SIZE}^2, global batch {TRAIN_BATCH}, base "
        f"{BASE}, bf16): {res['step_ms_ranks']} ms a step on each rank (median of "
        f"{SP_STRADDLE_WINDOWS} windows of {SP_STEPS}) against (b)'s {train_b['step_ms_ranks']} "
        f"at {TRAIN_SIZE}^2; row gather {r0['gathers_per_step']:.0f} calls and "
        f"{r0['gather_bytes_per_step'] / 1e6:.2f} MB a step a rank, its share of "
        f"{SP_PROFILED} profiled steps {[round(p['gather_share'], 4) for p in res['profile_ranks']]} "
        f"({prof['gather_ms']:.1f} of {prof['wall_ms']:.1f} ms on rank 0); halo "
        f"{r0['exchanges_per_step']:.0f} exchanges, {r0['halo_bytes_per_step'] / 1e6:.2f} MB "
        f"a step, share {[round(p['halo_share'], 4) for p in res['profile_ranks']]}; peak "
        f"memory per rank {res['peak_mem_gib_steady_ranks']} GiB steady, "
        f"{res['peak_mem_gib_main_ranks']} GiB in train_model ((b) steady: "
        f"{train_b['peak_mem_gib_steady_ranks']})")
    return res


def phase_spatial(seed: int, work: str, dev, main_res: dict, train_res: dict) -> dict:
    """Phase 10: spatial partitioning on the one card (module docstring)."""
    import torch

    if dev.type == "cuda":  # the ranks share the card with this process
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = {"parity": phase_spatial_parity(seed, work, dev),
           "train": phase_spatial_train(seed, work, dev, main_res, train_res)}
    t_c = time.perf_counter()
    res["straddle"] = {
        "parity": phase_spatial_parity(seed, work, dev, SP_PARITY_H, "(c) (i)"),
        "train": phase_spatial_straddle_train(seed, work, dev, res["train"])}
    res["straddle"]["phase_s"] = time.perf_counter() - t_c
    res["phase_s"] = time.perf_counter() - t0
    log(f"phase 10 took {res['phase_s']:.1f} s, (c) {res['straddle']['phase_s']:.1f} s of it")
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
    k3 = phase_int8_conv(args.seed, dev)
    k5 = phase_input_conv(args.seed, dev)
    k4 = phase_batchnorm(args.seed, dev)
    shear = phase_shear(args.seed, dev)
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke")
    main_res = phase_main(args.seed, work, dev, card)
    train_res = phase_train(args.seed, work, dev, card)
    stream_res = phase_stream(args.seed, work, dev, main_res["radius"])
    migration_res = phase_migration(args.seed, work, dev, main_res, train_res)
    multigpu_res = phase_multigpu(args.seed, work, dev, main_res, train_res)
    spatial_res = phase_spatial(args.seed, work, dev, main_res, train_res)

    fp, s8 = kern["fp"], kern["int8"]
    kernels = [{
        "name": "blocked_head_argmax", "route": "cuda",
        "source": "tpuseg_torch/csrc/head_argmax.cu",
        "replaces": "tpuseg/infer/head_kernel.py:83",
        "launches": main_res["launches"]["blocked_head_argmax"],
        "launches_streaming": stream_res["engine"]["launches"],
        "launches_by_cli_run": {k: r["k2_launches"]
                                for k, r in stream_res["clis"]["runs"].items()},
        "launches_migration": migration_res["k2_launches"],
        "launches_multigpu": {
            "served_nccl_world1_checkpoint": multigpu_res["nccl"]["served_k2_launches"],
            "tiled_one_shard": multigpu_res["sharded"]["int8_blocked"]["k2_one"],
            "tiled_two_shards": multigpu_res["sharded"]["int8_blocked"]["k2_two"],
            "striped_ranks": multigpu_res["striped"]["k2_launches_ranks"]},
        "launches_spatial": {
            "served_spatial_checkpoint": spatial_res["train"]["served_k2_launches"]},
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
        "streamed_vs_plain_head_agree": {side: r["agree"] for side, r
                                         in stream_res["engine"]["vs_plain"].items()},
    }, {
        "name": "shear_rows", "route": "cuda",
        "source": "tpuseg_torch/csrc/shear_rows.cu",
        "replaces": "tpuseg/ops/warp.py:67",
        "also_replaces": "tpuseg/ops/warp.py:147",
        "launches": train_res["launches"]["shear_rows"],
        "launches_migration": migration_res["train"]["shear_launches"],
        "launches_multigpu": {"nccl_world1_cli": multigpu_res["nccl"]["cli"]["k1_launches"],
                              "gloo_two_ranks": multigpu_res["gloo"]["k1_launches_ranks"]},
        "launches_spatial": {
            "train_model_ranks": spatial_res["train"]["k1_launches_ranks"],
            "parity_ranks": spatial_res["parity"]["k1_launches_ranks"],
            "straddle_train_model_ranks": spatial_res["straddle"]["train"]["k1_launches_ranks"],
            "straddle_parity_ranks": spatial_res["straddle"]["parity"]["k1_launches_ranks"]},
        "max_abs_err": shear["max_abs_err"], "ms": shear["ms"],
        "plain_ms": shear["plain_ms"], "bound_ms": shear["bound_ms"],
        "bound_by": shear["bound_by"], "library_ms": shear["library_ms"],
        "library_call": "F.grid_sample(mode='bilinear', align_corners=True) on [N,1,H,Wp]",
        "library_max_abs_err": shear["library_max_abs_err"],
        "timing": "device time per call from the profiler, L2 flushed before each",
        "shape": shear["shape"],
        "tolerance": "bit-equal to the plain version",
    }, {
        "name": "int8_conv", "route": "cuda", "kernel_route": "wgmma",
        "source": "tpuseg_torch/csrc/int8_conv.cu",
        "replaces": "tpuseg/infer/quant.py:173",
        "replaces_note": "XLA-fused on the TPU, not a Pallas kernel: _conv_s8 and the "
                         "epilogue XLA fuses behind it in _quantized_raw_fn (:496)",
        "launches": main_res["launches"]["int8_conv"],
        "launches_by_route": main_res["launches"]["int8_conv_routes"],
        "launches_per_predict_call": K3_PER_CALL,
        "launches_int8_cli": main_res["launches"]["int8_conv_dense_cli"],
        "launches_tiled": {"int8_blocked": main_res["k3_launches_tiled_dispatch"],
                           "int8": main_res["k3_launches_tiled_dispatch_int8"]},
        "launches_streaming": stream_res["engine"]["k3_launches"],
        "max_abs_err": k3["max_abs_err"], "ms": k3["walk_ms"], "plain_ms": k3["walk_plain_ms"],
        "bound_ms": k3["walk_bound_ms"], "bound_by": k3["walk_bound_by"],
        "bound_note": "per block the larger of the operations the weights need (the blocked "
                      "convs' all-zero K-steps left out) and the bytes (the pooled output of a "
                      "store form included), summed; bound_dense_ms counts every tap",
        "bound_dense_ms": k3["bound_dense_ms"], "library_ms": k3["library_ms"],
        "forms": {r["block"]: r["form"] for r in k3["blocks"] if r.get("form")},
        "forms_note": "the store forms the walks make K3's calls with: out= a channel slice "
                      "of the skip's concat buffer (ctot wide, at offset), d2s the deconv's "
                      "depth-to-space, pool the 2x2 max or the blocked enc1b's phase max; "
                      "they replace the walks' eager max-pools, phase max, concats and "
                      "depth-to-space copies",
        "ms_without_forms": k3["ms"], "bound_ms_without_forms": k3["bound_ms"],
        "forms_fused_ms": k3["forms_fused_ms"], "forms_unfused_ms": k3["forms_unfused_ms"],
        "forms_k3_alone_ms": k3["forms_k3_alone_ms"], "forms_edge_ms": k3["forms_edge_ms"],
        "dense_form_blocks": {r["block"]: {"form": r["form"], "fused_ms": r["fused_ms"],
                                           "unfused_ms": r["unfused_ms"],
                                           "bound_ms": r["walk_bound_ms"]}
                              for r in k3["dense_form_blocks"]},
        "edge_kernels_profiled": {m: main_res[f"profile_{m}"].get("edge_kernels")
                                  for m in ("int8_blocked", "int8")},
        "mma_route_ms": k3["mma_ms"], "wgmma_ms_by_bn": k3["wgmma_ms_by_bn"],
        "library_call": "torch._int_mm on the prebuilt im2col matrix (the GEMM alone, "
                        "int32 out, no epilogue), summed over the 21 blocks",
        "timing": "sums over the 21 block shapes of one main-path predict call of the time "
                  "per call by CUDA events around it, L2 flushed and a 1 ms spin before each; "
                  "ms and plain_ms with the store forms the int8_blocked walk uses",
        "share_of_bound": k3["share_of_bound"],
        "tolerance": "both routes bit-equal (torch.equal) to the plain version at every "
                     "block shape, the store forms' buffers and pooled codes too; masks "
                     "through K3 equal those through the plain version on every pixel "
                     "(int8_blocked and int8)",
        "blocks": [{k: r.get(k) for k in ("block", "shape", "k", "cout", "mode", "route", "bn",
                                          "bw", "ms", "mma_ms", "plain_ms", "library_ms",
                                          "bound_ms", "bound_by", "bound_dense_ms", "codes",
                                          "form", "fused_bn", "fused_bw", "fused_ms",
                                          "unfused_ms", "edge_ms", "unfused_k3_bw64_ms",
                                          "fused_bn256_ms", "walk_bound_ms")}
                   for r in k3["blocks"]],
    }, {
        "name": "input_conv", "route": "cuda",
        "source": "tpuseg_torch/csrc/input_conv.cu",
        "replaces": "tpuseg/infer/quant.py:544",
        "replaces_note": "XLA-fused on the TPU, not a Pallas kernel: conv_block's fp branch "
                         "(:544-560, _conv_fp + ReLU + folded BN) and emit (:526), blocked at "
                         ":665-674",
        "launches": main_res["launches"]["input_conv"],
        "launches_per_predict_call": K5_PER_CALL,
        "launches_int8_cli": main_res["launches"]["input_conv_dense_cli"],
        "launches_tiled": {"int8_blocked": main_res["k5_launches_tiled_dispatch"],
                           "int8": main_res["k5_launches_tiled_dispatch_int8"]},
        "launches_streaming": stream_res["engine"]["k5_launches"],
        "max_abs_err": k5["max_abs_err"], "ms": k5["ms"], "plain_ms": k5["plain_ms"],
        "bound_ms": k5["bound_ms"], "bound_by": k5["bound_by"],
        "library_ms": k5["library_ms"],
        "library_call": "F.conv2d on the bf16-rounded input and weights, f32 out, cuDNN "
                        "TF32 off (the conv alone, as _conv_fp ran it)",
        "dense_ms": k5["dense_ms"], "eager_ms": k5["eager_ms"],
        "eager_dense_ms": k5["eager_dense_ms"],
        "issue_floor_ms": k5["issue_floor_ms"],
        "sass_per_output": {lay: r["per_output"] for lay, r in k5["sass"].items()},
        "clock_max_mhz": k5["clock_max_mhz"],
        "grid": {lay: p["grid"] for lay, p in k5["plan"].items()},
        "resident_per_sm": {lay: p["resident_per_sm"] for lay, p in k5["plan"].items()},
        "division_check": {"main_path_scales": main_res["k5_division_main"],
                           "phase2_scale": k5["division"]["phase2_scale_every_value"],
                           "random_scales": k5["division"]["random_scales"]},
        "timing": "per call by CUDA events around it, L2 flushed and a 1 ms spin before "
                  "each; ms is the blocked layout (the int8_blocked main path), dense_ms the "
                  "int8 walk's",
        "shape": k5["shape"], "f": k5["f"], "share_of_bound": k5["share_of_bound"],
        "tolerance": "bit-equal (torch.equal) to the plain version in both layouts at the "
                     "main path's shape and at C 3; masks through K5 equal those through "
                     "the plain version on every pixel (int8_blocked and int8); the "
                     "reciprocal requantize's codes equal __fdiv_rn's on every f32 value for "
                     "each scale of the main path, and its quotients wherever nothing "
                     "underflows",
    }]
    d_fp, d_s8 = kern["dense"]["fp"], kern["dense"]["int8"]
    kernels.append({
        "name": "dense_head_argmax", "route": "cuda", "kernel_route": d_fp["route"],
        "source": "tpuseg_torch/csrc/head_argmax.cu",
        "replaces": "tpuseg/infer/quant.py:544",
        "replaces_note": "XLA-fused on the TPU, not a Pallas kernel: conv_block's head "
                         "(:544-560, dequant or _conv_s8 x wscale, + b, ReLU, * s + t) and "
                         "predict's argmax (:785-786) in the dense walk",
        "launches": main_res["launches"]["dense_head_argmax"],
        "launches_note": "the --quantize int8 inference CLI on phase 4's folder, one a predict "
                         "call; none under int8_blocked",
        "launches_int8_blocked_cli": main_res["launches"]["dense_head_argmax_int8_blocked"],
        "launches_int8_auto_cli": main_res["launches"]["int8_auto_cli"]["dense_head_argmax"],
        "launches_tiled": {"int8": main_res["k6_launches_tiled_dispatch_int8"],
                           "int8_blocked": main_res["k6_launches_tiled_dispatch"],
                           "int8_head": main_res["int8_head"]["k6_launches"]},
        "max_abs_err": d_fp["max_abs_err"], "ms": d_fp["ms"], "plain_ms": d_fp["plain_ms"],
        "bound_ms": d_fp["bound_ms"], "bound_by": d_fp["bound_by"], "library_ms": None,
        "library_note": "no single PyTorch call computes head + argmax; eager_ms is the eager "
                        "chain K6 replaced (dequant, cuDNN's f32 conv between permutes, the "
                        "epilogue, torch.argmax; the int8 head through K3)",
        "eager_ms": d_fp["eager_ms"], "share_of_bound": d_fp["share_of_bound"],
        "timing": "device time per call from the profiler, L2 flushed before each",
        "shape": list(DENSE_SHAPE), "ncls": NCLS, "agree": d_fp["agree"],
        "int8_variant": d_s8,
        "masks_vs_plain_agree_int8_cli": main_res["k6_vs_plain_agree_int8"]["all"],
        "int8_head_masks_pixels_differing": main_res["int8_head"]["pixels_differing"],
        "tolerance": "fp head: labels agree on >= 0.9999 (f32 sum order), also the "
                     "--quantize int8 masks; int8 head: labels bit-equal, and the int8-head "
                     "tiled masks equal on every pixel",
    })
    enc1 = k4["cases"]["enc1_bfloat16"]
    library_calls = {"stats": "torch.batch_norm_stats(x, eps)",
                     "apply": "torch.batch_norm_elemt(x, gamma, beta, mean, rstd, eps)",
                     "backward_reduce": "torch.batch_norm_backward_reduce(g, x, mean, rstd, "
                                        "gamma, True, True, True)",
                     "backward_apply": "torch.batch_norm_backward_elemt(g, x, mean, rstd, "
                                       "gamma, sum_dy, sum_dy_xmu, count)"}
    for kind in K4_KINDS:
        kernels.append({
            "name": f"batchnorm_{kind}", "route": "cuda",
            "source": "tpuseg_torch/csrc/batchnorm.cu",
            "replaces": "tpuseg/models/unet.py:94",
            "replaces_note": "XLA-fused on the TPU, not a Pallas kernel: ConvBlock's bias, "
                             "nn.relu and nn.BatchNorm (:94-102) and DeconvBlock's nn.BatchNorm "
                             "(:163-170)",
            "launches": train_res["launches"]["batchnorm"][kind],
            "launches_note": "the train CLI main path (phase 6): 23 a train step of each kind, "
                             "and 23 applies a test forward",
            "launches_tiled_none": main_res["k4_launches_tiled_none"][kind],
            "max_abs_err": k4["max_abs_err"][kind],
            "ms": enc1["ms"][f"kernel_{kind}"], "plain_ms": enc1["ms"][f"plain_{kind}"],
            "bound_ms": enc1["bound_ms"][kind], "bound_by": "bytes",
            "library_ms": enc1["ms"][f"library_{kind}"], "library_call": library_calls[kind],
            "library_note": "PyTorch's own sync-BN kernel, BatchNorm alone (no bias or ReLU)",
            "share_of_bound": enc1["share_of_bound"][kind],
            "shape": enc1["shape"], "dtype": "bfloat16",
            "head_bfloat16": {k: k4["cases"]["head_bfloat16"][k][kind] if k != "ms" else
                              k4["cases"]["head_bfloat16"]["ms"][f"kernel_{kind}"]
                              for k in ("ms", "bound_ms", "share_of_bound", "within_target")},
            "empty_launch_ms": k4["empty_launch_ms"],
            "vectors": "(b) and (d) derive mean, var, mask, rstd, mul, k1, k2 and dbias from "
                       "the sums in the kernel: bit-equal to finalize and the eager formulas "
                       "(rstd, mul within K4_RSQRT_ULPS, measured 0), running statistics "
                       "bit-equal to the two-line update",
            "by_case": {name: {"ms": r["ms"][f"kernel_{kind}"], "plain_ms": r["ms"][f"plain_{kind}"],
                               "library_ms": r["ms"][f"library_{kind}"],
                               "bound_ms": r["bound_ms"][kind]}
                        for name, r in k4["cases"].items()},
            "timing": "per call by CUDA events around it, L2 flushed and a 1 ms spin before "
                      "each; ms at enc1's [8, 64, 512, 512] in bf16 (the training main path)",
            "tolerance": "bit-equal (torch.equal) to the plain version given the same vectors"
                         if kind in ("apply", "backward_apply") else
                         "within gamma_d * sum |t| of the float64 sums, d the most f32 "
                         "additions between a term and its sum in the library's plan (u = "
                         "2^-24), and the plain f32 sums within twice that; planted faults "
                         "(a dropped block, each sum zeroed) fail the check; max_abs_err "
                         "against float64",
        })
    summary = {"card": card, "torch": torch.__version__, "build_s": build_s,
               "kernels": kern, "int8_conv": k3, "input_conv": k5, "batchnorm": k4,
               "shear": shear,
               "main": main_res,
               "train": train_res,
               "stream": stream_res, "migration": migration_res, "multigpu": multigpu_res,
               "spatial": spatial_res, "profiler_fallbacks": len(TIMER_FALLBACKS),
               "total_s": time.perf_counter() - t_start}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    log(f"total {summary['total_s']:.1f} s; calls timed by events for want of a complete "
        f"profiler window: {len(TIMER_FALLBACKS)}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
