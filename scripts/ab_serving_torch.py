#!/usr/bin/env python3
"""Time the port's tiled int8 serving passes for two or more checkouts of
this repository, in turns on one card.

    python3 scripts/ab_serving_torch.py --checkout A --checkout B [--rounds 2]

Each ``--checkout`` is the root of a checkout (for instance the parent
commit unpacked by ``git archive`` into a directory ``.gitignore`` lists):
its ``tpuseg_torch`` is imported from there, and its kernels build into
its own ``build/``. The checkouts run in turns, A B B A A B ..., each
turn a child process of its own. A child makes the same full-width random
U-Net (base 64, 1 channel, 2 classes, Keras init and jittered BatchNorm
statistics from ``--seed``) and the same synthetic uint16 image
(``--size``^2, smooth structure plus noise), calibrates on the image's
centre tile, and times tiled passes (tile 1024, batch 8, ``--radius``)
of the ``int8`` and ``int8_blocked`` predict functions, in turns after a
warm-up pass each: host wall time around a synchronised pass, the median
of ``--passes``; then it profiles one pass of each mode (device time by
kernel group, and the eager edge kernels on int8 codes, by
``chip_smoke.py``'s ``device_profile`` and ``edge_kernels``). Each child
prints one JSON line; the parent prints the
card's name and power limit, then a JSON summary (MP/s per checkout and
mode, every turn's medians). ``--device cpu`` rehearses it without a
card at a small ``--size`` and ``--base``.
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


def image(size: int, seed: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    f = rng.uniform(0.005, 0.03, 4)
    field = (np.sin(yy * f[0] + xx * f[1]) + np.cos(yy * f[2] - xx * f[3])) * 700 + 2000
    return np.clip(field + rng.normal(0, 150, (size, size)), 0, 65535).astype(np.uint16)


def child(args) -> dict:
    sys.path.insert(0, os.path.abspath(args.child))
    import numpy as np
    import torch

    import tpuseg_torch
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
    res = {"checkout": args.child, "package": os.path.dirname(tpuseg_torch.__file__),
           "device": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
           "pass_s": times,
           "mp_s": {m: mp / statistics.median(t) for m, t in times.items()}}
    if dev.type == "cuda":
        import importlib.util

        spec = importlib.util.spec_from_file_location("chip_smoke_ab", os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "chip_smoke.py"))
        smoke = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(smoke)
        res["profile"] = {}
        for mode in fns:
            prof = smoke.device_profile(lambda: run(mode), mode)
            res["profile"][mode] = {
                "wall_ms": prof["wall_ms"], "busy_ms": prof["busy_ms"],
                "by_group_ms": {g: v["ms"] for g, v in prof["by_group"].items()},
                "edge_kernels": smoke.edge_kernels(prof) if prof["busy_ms"] else None}
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
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
            print("ab_serving_torch: no card (torch.cuda.is_available() is false)",
                  file=sys.stderr)
            return 1
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip()
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
            f"--{k}={getattr(args, k)}" for k in ("passes", "seed", "size", "base", "radius",
                                                 "device")]
        res = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=1800)
        if res.returncode:
            print(res.stdout[-4000:], res.stderr[-4000:], file=sys.stderr)
            return res.returncode
        line = json.loads(res.stdout.strip().splitlines()[-1])
        print(json.dumps(line), flush=True)
        runs[c].append(line["mp_s"])
    summary = {c: {m: statistics.median(r[m] for r in rs) for m in rs[0]}
               for c, rs in runs.items()}
    print(card)
    print(json.dumps({"card": card, "size": args.size, "order": order,
                      "mp_s_median": summary, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
