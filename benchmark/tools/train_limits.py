#!/usr/bin/env python3
"""Read the numbers that ``correct`` compares for a training cell, for the
program, its control and its faults, on many seeds in one process.

    python3 benchmark/tools/train_limits.py --cell train-512-b16 --seeds 101 ... [--out FILE]

For each seed it builds the cell's train state from the seed as a run
does, reads the program's first steps (``drivers/train_steps.py``), and
trains the plain reference from the same weights on the same batches.
Beside them: the control, the reference computed with its convs' inputs
and weights in float8 e4m3 (the precision below bf16) in the program's
place; and the faults of half of each batch left out (the program stepped
on the first half, its mean taken over that half) and of a step that
returns its state unchanged (the parameters and moments put back). One JSON
line a seed, then a summary of the largest program reading and the
smallest control and fault readings of each number.
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


def half_batch(step, b):
    """Half of each batch left out: the step sees the first half, and its
    loss is the mean over that half."""
    return lambda st, img, msk: step(st, img[:b // 2], msk[:b // 2])


def unchanged_state(step, b):
    """A step that returns its state unchanged: the parameters and Adam's
    moments are put back after it."""
    import torch

    def run(st, img, msk):
        params = [p.detach().clone() for p in st.model.parameters()]
        moments = {p: {k: v.clone() for k, v in s.items()} for p, s in st.optimizer.state.items()}
        out = step(st, img, msk)
        with torch.no_grad():
            for p, saved in zip(st.model.parameters(), params):
                p.copy_(saved)
        for p, s in moments.items():
            st.optimizer.state[p].update(s)
        return out
    return run


FAULTS = {"program": lambda step, b: step, "half_batch": half_batch,
          "unchanged_state": unchanged_state}


def readings(cell_name: str, seed: int, device, root: str) -> dict:
    import torch

    from drivers import train_steps as ts
    from harness import manifest
    from harness import weights as weights_lib
    from harness.common import child_seeds, make_pool
    from reference import train as ref_train

    cell = manifest.load_cell(cell_name, root)
    cfg, traffic = cell.config, cell.traffic
    t0 = time.perf_counter()
    s_weights, s_pool, s_aug, s_drop = child_seeds(seed, 4)
    weights = weights_lib.make(cfg, s_weights, device)
    pool = make_pool(traffic, s_pool, device)
    b = traffic["batch"]
    batches = [ts.batch(pool, i, b) for i in range(traffic["checked_steps"])]
    got = {}
    for name in ("program", "half_batch", "unchanged_state"):
        state, step = ts.build_step(cfg, traffic, weights, (s_aug, s_drop), device)
        step = FAULTS[name](step, b)
        got[name] = ts.readings(state, step, pool, traffic, weights)
        del state, step
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    lr = cfg["train"]["learning_rate"]
    common = (batches, s_aug, s_drop, lr, traffic["augment"], cfg["num_classes"],
              cfg["levels"], device)
    ref = ref_train.run_steps(weights, *common)
    got["control_fp8"] = ref_train.run_steps(weights, *common, fp8=True)
    stick = ref_train.run_steps(weights, *common, dtype=torch.bfloat16)
    out = {"seed": seed, "seconds": time.perf_counter() - t0, "losses": ref["losses"]}
    med = sorted(ref["grad_norms"].values())[len(ref["grad_norms"]) // 2]
    for name, r in got.items():
        out[name] = ref_train.compare(r, ref, yardstick=stick)
        out[name]["worst_leaf"] = out[name].pop("worst_leaf")
        out[name]["losses"] = r["losses"]
        out[name]["leaf_errors"] = ref_train.leaf_errors(r, ref, list(ref["grad_norms"]), med)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cell", default="train-512-b16")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("train_limits: no card", file=sys.stderr)
        return 1
    rows = []
    for seed in args.seeds:
        rows.append(readings(args.cell, seed, device, os.path.dirname(HERE)))
        print(json.dumps(rows[-1]), flush=True)
    nums = ("loss_gap", "grad_gap", "change_gap", "grad_err", "grad_err_median",
            "grad_dev")
    summary = {n: dict({"lower": max(r["program"][n] for r in rows),
                        "program": [r["program"][n] for r in rows]},
                       **{side: min(r[side][n] for r in rows)
                          for side in ("control_fp8", "half_batch", "unchanged_state")})
               for n in nums}
    print(json.dumps({"summary": summary}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"cell": args.cell, "seeds": args.seeds, "rows": rows,
                       "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
