#!/usr/bin/env python3
"""Read the numbers that ``correct`` compares for TransUNet's training
cell, for the program, its control and its faults, on many seeds in one
process.

    python3 benchmark/tools/train_limits_transunet.py --seeds 101 ... [--out FILE]

``tools/train_limits.py`` with ``drivers/train_steps_transunet.py``'s
train state and ``reference/train_transunet.py``: for each seed it builds
the cell's train state from the seed as a run does, reads the program's
first steps, and trains the plain reference from the same weights on the
same batches. Beside them: the control, the reference computed as fp8
training computes (every conv's and linear's operands in float8 e4m3
forward, output gradients in e5m2 backward) in the program's place; and
the faults of half of each batch left out and of a step that returns its
state unchanged. One JSON line a seed, then a summary of the largest
program reading and the smallest control and fault readings of each
number.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

CELL = "transunet-train-512-b16"
NUMBERS = ("loss_gap", "grad_gap", "change_gap", "grad_err", "grad_err_median", "grad_dev",
           "grad_dev_decoder")


def readings(cell_name: str, seed: int, device, root: str) -> dict:
    import torch

    from drivers import train_steps as ts
    from drivers import train_steps_transunet as tt
    from harness import manifest, transunet_weights
    from harness.common import child_seeds, make_pool
    from reference import train_transunet as ref_transunet
    from tools.train_limits import FAULTS

    cell = manifest.load_cell(cell_name, root)
    cfg, traffic = cell.config, cell.traffic
    t0 = time.perf_counter()
    s_weights, s_pool, s_aug, s_drop = child_seeds(seed, 4)
    weights = transunet_weights.make(cfg, s_weights, device)
    pool = make_pool(traffic, s_pool, device)
    b = traffic["batch"]
    batches = [ts.batch(pool, i, b) for i in range(traffic["checked_steps"])]
    got = {}
    for name in ("program", "half_batch", "unchanged_state"):
        state, step = tt.build_step(cfg, traffic, weights, (s_aug, s_drop), device)
        got[name] = ts.readings(state, FAULTS[name](step, b), pool, traffic, weights)
        del state, step
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    common = (batches, s_aug, s_drop, cfg["train"]["learning_rate"], traffic["augment"],
              cfg["num_classes"], cfg, device)
    ref = ref_transunet.run_steps(weights, *common)
    got["control_fp8"] = ref_transunet.run_steps(weights, *common, fp8=True)
    stick = ref_transunet.run_steps(weights, *common, dtype=torch.bfloat16)
    out = {"seed": seed, "seconds": time.perf_counter() - t0, "losses": ref["losses"]}
    for name, r in got.items():
        out[name] = ref_transunet.compare(r, ref, stick)
        out[name]["worst_leaf"] = out[name].pop("worst_leaf")
        out[name]["losses"] = r["losses"]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cell", default=CELL)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("train_limits_transunet: no card", file=sys.stderr)
        return 1
    rows = []
    for seed in args.seeds:
        rows.append(readings(args.cell, seed, device, os.path.dirname(HERE)))
        print(json.dumps(rows[-1]), flush=True)
    summary = {n: dict({"lower": max(r["program"][n] for r in rows),
                        "program": [r["program"][n] for r in rows]},
                       **{side: min(r[side][n] for r in rows)
                          for side in ("control_fp8", "half_batch", "unchanged_state")})
               for n in NUMBERS}
    print(json.dumps({"summary": summary}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"cell": args.cell, "seeds": args.seeds, "rows": rows,
                       "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
