#!/usr/bin/env python3
"""Time K4's kernels of two or more checkouts of this repository against
each other, in turns on one card.

    python3 scripts/ab_torch.py --checkout A --checkout B [--rounds 2]

Each ``--checkout`` is the root of a checkout (for instance the parent
commit unpacked by ``git archive`` into a directory ``.gitignore`` lists):
its ``tpuseg_torch`` is imported from there, and its kernels build into
its own ``build/``. The checkouts run in turns, A B B A A B ..., each
turn a child process of its own that prints one JSON line; the parent
prints the card's name and power limit, then a JSON summary: the median
over a checkout's turns of each headline number, and every turn's.

It times K4's four kernels at ``chip_smoke.py``'s shapes (``K4_SHAPES``:
enc1's [8, 64, 512, 512] and the head's [8, 2, 512, 512], bf16, bias and
ReLU on), each as the train step calls it, by CUDA events around each
call with the L2 flushed (``chip_smoke.py``'s ``events_ms_cold``), and an
empty launch (``torch.cuda._sleep(0)``) timed the same way. Headline: ms
by shape and kernel. ``--mode k4`` is accepted, the one mode. The
end-to-end comparison of two commits is the benchmark's
(``benchmark/run.py``), run on each.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys


def smoke():
    """This checkout's ``chip_smoke.py`` as a module (its shapes, inputs and
    timing helpers, the same for every checkout timed)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke_ab", os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def k4_child(args) -> dict:
    import torch

    from tpuseg_torch.ops import batchnorm as bn

    helpers = smoke()
    dev = torch.device("cuda", 0)
    res = {"empty_launch_ms": helpers.events_ms_cold(lambda: torch.cuda._sleep(0), 20),
           "ms": {}}
    for where, shape in helpers.K4_SHAPES.items():
        x, bias, gamma, beta, gy = helpers.k4_inputs(shape, torch.bfloat16, args.seed, dev)
        run = (torch.zeros(shape[1], device=dev), torch.ones(shape[1], device=dev))
        stats = bn.batch_stats(x, bias, True)
        _, vec = bn.bn_apply_train(x, bias, True, stats, gamma, beta, 1e-3, *run, 0.99)
        mean, rstd = vec[0], vec[2]
        sums = bn.backward_reduce(x, bias, True, gy, mean, rstd)
        fns = {"stats": lambda: bn.batch_stats(x, bias, True),
               "apply": lambda: bn.bn_apply_train(x, bias, True, stats, gamma, beta, 1e-3,
                                                  *run, 0.99),
               "backward_reduce": lambda: bn.backward_reduce(x, bias, True, gy, mean, rstd),
               "backward_apply": lambda: bn.backward_apply_train(x, bias, True, gy, stats, vec,
                                                                 sums, sums)}
        kinds = list(fns)
        times = {k: [] for k in kinds}
        for order in (kinds, kinds[::-1]):
            for k in order:
                times[k].append(helpers.events_ms_cold(fns[k], 10))
        res["ms"][where] = {k: sum(v) / len(v) for k, v in times.items()}
        del x, gy
        torch.cuda.empty_cache()
    from tpuseg_torch.kernels import build

    res["ptxas"] = build.BUILD_LOGS.get("batchnorm")
    res["headline"] = {f"{w}_{k}": v for w, d in res["ms"].items() for k, v in d.items()}
    res["headline"]["empty_launch"] = res["empty_launch_ms"]
    return res


def child(args) -> dict:
    sys.path.insert(0, os.path.abspath(args.child))
    import torch

    import tpuseg_torch

    res = k4_child(args)
    res["checkout"] = args.child
    res["package"] = os.path.dirname(tpuseg_torch.__file__)
    res["device"] = torch.cuda.get_device_name(0)
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mode", choices=("k4",), default="k4")
    ap.add_argument("--checkout", action="append", default=[])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("ab_torch: no card (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    if len(args.checkout) < 2:
        ap.error("give two or more --checkout directories")
    order = []
    for rnd in range(args.rounds):
        order += args.checkout if rnd % 2 == 0 else args.checkout[::-1]
    runs = {c: [] for c in args.checkout}
    env = dict(os.environ, PYTHONPATH="")
    for c in order:
        cmd = [sys.executable, os.path.abspath(__file__), "--child", c, f"--seed={args.seed}"]
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
    print(json.dumps({"card": card, "order": order, "median": summary, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
