#!/usr/bin/env python3
"""Time two or more checkouts of this repository against each other, in
turns on one card.

    python3 scripts/ab_torch.py --mode serving|train|k4 --checkout A --checkout B [--rounds 2]

Each ``--checkout`` is the root of a checkout (for instance the parent
commit unpacked by ``git archive`` into a directory ``.gitignore`` lists):
its ``tpuseg_torch`` is imported from there, and its kernels build into
its own ``build/``. The checkouts run in turns, A B B A A B ..., each
turn a child process of its own that prints one JSON line; the parent
prints the card's name and power limit, then a JSON summary: the median
over a checkout's turns of each headline number, and every turn's. The
modes:

- ``serving``: the same full-width random U-Net (base 64, 1 channel, 2
  classes, Keras init and jittered BatchNorm statistics from ``--seed``)
  and the same synthetic uint16 image (``--size``^2, smooth structure plus
  noise), calibrated on the image's centre tile; tiled passes (tile 1024,
  batch 8, ``--radius``) of the ``int8`` and ``int8_blocked`` predict
  functions, in turns after a warm-up pass each: host wall time around a
  synchronised pass, the median of ``--passes``; then one profiled pass of
  each (device time by kernel group, and the eager edge kernels on int8
  codes, by ``chip_smoke.py``'s ``device_profile`` and ``edge_kernels``).
  Headline: MP/s by mode.
- ``train``: steady raw train steps (512^2, batch 8, base 64, bf16, device
  augmentation, as ``chip_smoke.py``'s phase 6 times them): img/s and the
  child's CPU ms a step (medians of 3 windows of 10 steps), kernel
  launches a step by the profiler (3 steps behind 64 spins) and by group,
  and K4's launches a step.
- ``k4``: K4's four kernels at ``chip_smoke.py``'s shapes (enc1's [8, 64,
  512, 512] and the head's [8, 2, 512, 512], bf16, bias and ReLU on), each
  as the train step calls it (a checkout whose wrappers derive the vectors
  in the kernels, or one that takes them given), by CUDA events around
  each call with the L2 flushed (``chip_smoke.py``'s ``events_ms_cold``),
  and an empty launch (``torch.cuda._sleep(0)``) timed the same way.
  Headline: ms by shape and kernel.

``--device cpu`` rehearses ``serving`` without a card at a small
``--size`` and ``--base``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

TILE, BATCH, NCLS = 1024, 8, 2
TRAIN_SIZE, TRAIN_BATCH, TRAIN_BASE, TRAIN_LR = 512, 8, 64, 1e-3
K4_SHAPES = {"enc1": (TRAIN_BATCH, TRAIN_BASE, TRAIN_SIZE, TRAIN_SIZE),
             "head": (TRAIN_BATCH, NCLS, TRAIN_SIZE, TRAIN_SIZE)}
K4_KINDS = ("stats", "apply", "backward_reduce", "backward_apply")


def image(size: int, seed: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    f = rng.uniform(0.005, 0.03, 4)
    field = (np.sin(yy * f[0] + xx * f[1]) + np.cos(yy * f[2] - xx * f[3])) * 700 + 2000
    return np.clip(field + rng.normal(0, 150, (size, size)), 0, 65535).astype(np.uint16)


def smoke():
    """This checkout's ``chip_smoke.py`` as a module (its timing and
    profiling helpers)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke_ab", os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def serving_child(args) -> dict:
    import numpy as np
    import torch

    from tpuseg_torch.data.preprocess import zscore_stats
    from tpuseg_torch.infer import quant
    from tpuseg_torch.infer.tiled import _zscore, inference_tiled
    from tpuseg_torch.models.unet import UNet, init_unet

    dev = torch.device(args.device)
    if dev.type == "cuda":
        from tpuseg_torch.kernels import build

        build.build(["int8_conv", "input_conv", "head_argmax"])
    g = torch.Generator().manual_seed(args.seed)
    model = init_unet(UNet(NCLS, 1, args.base, dtype=torch.float32), g)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(torch.randn(m.num_features, generator=g) * 0.3)
                m.running_var.copy_(torch.rand(m.num_features, generator=g) * 1.5 + 0.5)
    img = image(args.size, args.seed)
    stats = zscore_stats(img)
    tile = min(TILE, args.size)
    c, h = args.size // 2, tile // 2
    mean, std = (torch.from_numpy(np.asarray(s, np.float32).reshape(-1)) for s in stats)
    crop = torch.from_numpy(img[c - h:c + h, c - h:c + h].astype(np.float32))
    cal = _zscore(crop[None, ..., None], mean, std)[0, ..., 0].numpy()
    folded = quant.fold_variables(model.eval())
    ranges = quant.calibrate(folded, [cal], device=dev)
    fns = {mode: quant.make_quantized_predict_fn(folded, ranges, blocked_edges=blocked)
           for mode, blocked in (("int8", False), ("int8_blocked", True))}

    def run(mode):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        inference_tiled(img, fns[mode], tile, args.radius, BATCH, NCLS, stats, dev)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return time.perf_counter() - t0

    for mode in fns:
        run(mode)
    times = {mode: [] for mode in fns}
    for rnd in range(args.passes):
        for mode in (list(fns) if rnd % 2 == 0 else list(fns)[::-1]):
            times[mode].append(run(mode))
    mp = args.size * args.size / 1e6
    res = {"pass_s": times, "mp_s": {m: mp / statistics.median(t) for m, t in times.items()}}
    if dev.type == "cuda":
        helpers = smoke()
        res["profile"] = {}
        for mode in fns:
            prof = helpers.device_profile(lambda: run(mode), mode)
            res["profile"][mode] = {
                "wall_ms": prof["wall_ms"], "busy_ms": prof["busy_ms"],
                "by_group_ms": {g: v["ms"] for g, v in prof["by_group"].items()},
                "edge_kernels": helpers.edge_kernels(prof) if prof["busy_ms"] else None}
    res["headline"] = {f"mp_s_{m}": v for m, v in res["mp_s"].items()}
    return res


def train_child(args) -> dict:
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpuseg_torch.aug.device import DeviceAugmentParams
    from tpuseg_torch.models.unet import UNet
    from tpuseg_torch.ops import batchnorm as bn
    from tpuseg_torch.train.steps import create_train_state, make_raw_steps
    from tpuseg_torch.utils.trace_analysis import kernel_group

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(args.seed)
    img = rng.integers(0, 4000, (TRAIN_BATCH, TRAIN_SIZE, TRAIN_SIZE, 1)).astype(np.int32)
    raw_img = torch.from_numpy(img).to(dev)
    raw_msk = torch.from_numpy((img[..., 0] > 2000).astype(np.uint8)).to(dev)
    state = create_train_state(UNet(NCLS, 1, TRAIN_BASE, "bfloat16"), args.seed, TRAIN_LR, dev)
    tstep, _ = make_raw_steps(NCLS, DeviceAugmentParams())
    for _ in range(5):
        tstep(state, raw_img, raw_msk)
    torch.cuda.synchronize()
    windows, host = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0, c0 = time.perf_counter(), time.process_time()
        for _ in range(10):
            m = tstep(state, raw_img, raw_msk)
        m["loss"].item()
        windows.append(TRAIN_BATCH * 10 / (time.perf_counter() - t0))
        host.append((time.process_time() - c0) / 10 * 1e3)
    bn.reset_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(64):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        for _ in range(3):
            tstep(state, raw_img, raw_msk)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    groups: dict = {}
    for e in events:
        if "spin_kernel" not in e.key:
            groups[kernel_group(e.key)] = groups.get(kernel_group(e.key), 0) + e.count
    res = {"img_per_s_windows": windows, "host_cpu_ms_per_step_windows": host,
           "launches_per_step_by_group": {g: n / 3 for g, n in groups.items()},
           "lead_in_seen": sum(e.count for e in events if "spin_kernel" in e.key),
           "k4_launches_per_step": {k: v / 3 for k, v in bn.LAUNCHES.items()}}
    res["headline"] = {"img_per_s": statistics.median(windows),
                       "host_cpu_ms_per_step": statistics.median(host),
                       "launches_per_step": sum(groups.values()) / 3}
    return res


def k4_child(args) -> dict:
    import torch

    from tpuseg_torch.ops import batchnorm as bn

    helpers = smoke()
    dev = torch.device("cuda", 0)
    res = {"empty_launch_ms": helpers.events_ms_cold(lambda: torch.cuda._sleep(0), 20),
           "ms": {}}
    derives = hasattr(bn, "bn_apply_train")  # the vectors derived inside (b) and (d)
    for where, shape in K4_SHAPES.items():
        x, bias, gamma, beta, gy = helpers.k4_inputs(shape, torch.bfloat16, args.seed, dev)
        run = (torch.zeros(shape[1], device=dev), torch.ones(shape[1], device=dev))
        stats = bn.batch_stats(x, bias, True)
        if derives:
            _, vec = bn.bn_apply_train(x, bias, True, stats, gamma, beta, 1e-3, *run, 0.99)
            mean, rstd = vec[0], vec[2]
            sums = bn.backward_reduce(x, bias, True, gy, mean, rstd)
            fns = {"apply": lambda: bn.bn_apply_train(x, bias, True, stats, gamma, beta, 1e-3,
                                                      *run, 0.99),
                   "backward_apply": lambda: bn.backward_apply_train(x, bias, True, gy, stats,
                                                                     vec, sums, sums)}
        else:  # (a) gives the sums alone: the count row added as the train step adds it
            n = shape[0] * shape[2] * shape[3]
            full = torch.cat([stats, stats.new_full((1, shape[1]), float(n))])
            mean, _, _, rstd, mul = bn.finalize(full, 1e-3, gamma)
            sums = bn.backward_reduce(x, bias, True, gy, mean, rstd)
            k1, k2 = sums[0] / n, sums[1] / n
            fns = {"apply": lambda: bn.bn_apply(x, bias, True, mean, mul, beta),
                   "backward_apply": lambda: bn.backward_apply(x, bias, True, gy, mean, rstd,
                                                               mul, k1, k2)}
        fns["stats"] = lambda: bn.batch_stats(x, bias, True)
        fns["backward_reduce"] = lambda: bn.backward_reduce(x, bias, True, gy, mean, rstd)
        times = {k: [] for k in K4_KINDS}
        for order in (K4_KINDS, K4_KINDS[::-1]):
            for k in order:
                times[k].append(helpers.events_ms_cold(fns[k], 10))
        res["ms"][where] = {k: sum(v) / len(v) for k, v in times.items()}
        del x, gy
        torch.cuda.empty_cache()
    res["derives_vectors"] = derives
    from tpuseg_torch.kernels import build

    res["ptxas"] = build.BUILD_LOGS.get("batchnorm")
    res["headline"] = {f"{w}_{k}": v for w, d in res["ms"].items() for k, v in d.items()}
    res["headline"]["empty_launch"] = res["empty_launch_ms"]
    return res


def child(args) -> dict:
    sys.path.insert(0, os.path.abspath(args.child))
    import torch

    import tpuseg_torch

    res = {"serving": serving_child, "train": train_child, "k4": k4_child}[args.mode](args)
    res["checkout"] = args.child
    res["package"] = os.path.dirname(tpuseg_torch.__file__)
    res["device"] = (torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu")
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mode", choices=("serving", "train", "k4"), default="serving")
    ap.add_argument("--checkout", action="append", default=[])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--passes", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--size", type=int, default=4096)
    ap.add_argument("--base", type=int, default=64)
    ap.add_argument("--radius", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args)), flush=True)
        return 0
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("ab_torch: no card (torch.cuda.is_available() is false)", file=sys.stderr)
            return 1
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip()
    elif args.mode != "serving":
        ap.error(f"--mode {args.mode} needs the card")
    else:
        card = "cpu (a rehearsal: no device numbers)"
    if len(args.checkout) < 2:
        ap.error("give two or more --checkout directories")
    order = []
    for rnd in range(args.rounds):
        order += args.checkout if rnd % 2 == 0 else args.checkout[::-1]
    runs = {c: [] for c in args.checkout}
    env = dict(os.environ, PYTHONPATH="")
    for c in order:
        cmd = [sys.executable, os.path.abspath(__file__), "--child", c] + [
            f"--{k}={getattr(args, k)}" for k in ("mode", "passes", "seed", "size", "base",
                                                 "radius", "device")]
        res = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=1800)
        if res.returncode:
            print(res.stdout[-4000:], res.stderr[-4000:], file=sys.stderr)
            return res.returncode
        line = json.loads(res.stdout.strip().splitlines()[-1])
        print(json.dumps(line), flush=True)
        runs[c].append(line["headline"])
    summary = {c: {m: statistics.median(r[m] for r in rs) for m in rs[0]}
               for c, rs in runs.items()}
    print(card)
    print(json.dumps({"card": card, "mode": args.mode, "order": order, "median": summary,
                      "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
