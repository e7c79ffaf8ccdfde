#!/usr/bin/env python3
"""Read the numbers that ``correct`` compares, for the program and for its
controls, on many seeds in one process: the readings that
``benchmark/checks/<cell>.json``'s limits are set between.

    python3 benchmark/tools/limits.py --seeds 101 102 ... [--out FILE]

For each seed it makes the serving cells' set-up at their own sizes (one
set-up serves both: the weights, slides and head are made from the seed
alike), serves the first ``check_sample`` slides of the pool through each
configuration's predict function as a run does, and judges the masks as a
run does (``reference/check.py``, with each cell's yardstick and factor).
Beside them it judges each cell's control on the same slides: for the
int8 cell the reference computed with 4-bit weights and activations (the
next precision below int8), for the bf16 cell the program's own blocked
int8 path (the next below bf16). One JSON line a seed, then a summary:
for each cell the largest program reading and the smallest control
reading of each number.
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

INT8, BF16 = "int8b-4096-tiled", "bf16-4096-tiled"
CONTROL_BITS = 4


def readings(seed: int, device, root: str) -> dict:
    import torch

    from drivers import serve_tiled as st
    from harness import checks, manifest
    from reference import check as ref_check

    cells = {name: manifest.load_cell(name, root) for name in (INT8, BF16)}
    traffic, cfg = cells[INT8].traffic, cells[INT8].config
    t0 = time.perf_counter()
    state = st.setup(cells[INT8], seed, device)
    state["num_classes"] = cfg["num_classes"]
    pool, weights = state["pool"], state["weights"]
    k = traffic["check_sample"]
    masks = {INT8: [st.serve_one(state, traffic, i, device) for i in range(k)]}
    state["predict"] = st.build_predict(cells[BF16].config, weights, pool, state["stats"],
                                        device)
    masks[BF16] = [st.serve_one(state, traffic, i, device) for i in range(k)]
    state["predict"] = None
    gc.collect()
    specs = {name: checks.spec(name) for name in cells}
    sticks = {name: ref_check.forward_kwargs(specs[name]["yardstick"], weights, cfg["levels"],
                                             pool, device) for name in cells}
    int4 = ref_check.forward_kwargs({"quant_bits": CONTROL_BITS,
                                     "calibration": specs[INT8]["yardstick"]["calibration"]},
                                    weights, cfg["levels"], pool, device)
    got = {name: {"program": [], "control": []} for name in cells}
    common = (weights, cfg["levels"], traffic["tile"], traffic["radius"],
              traffic["reference_batch"])
    for i in range(k):
        j = ref_check.judge_slide(pool[i], {"program": [masks[INT8][i]]}, *common,
                                  sticks[INT8], specs[INT8]["factor"], device,
                                  controls={"control": int4})
        for side in got[INT8]:
            got[INT8][side] += j[side]
        j = ref_check.judge_slide(pool[i], {"program": [masks[BF16][i]],
                                            "control": [masks[INT8][i]]}, *common,
                                  sticks[BF16], specs[BF16]["factor"], device)
        for side in got[BF16]:
            got[BF16][side] += j[side]
    out = {"seed": seed, "head": state["head"], "seconds": time.perf_counter() - t0}
    for name, sides in got.items():
        out[name] = {side: dict(ref_check.numbers(js),
                                yardstick_flip_margin=[x["yardstick_flip_margin"] for x in js])
                     for side, js in sides.items()}
    del state, masks
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("limits: no card", file=sys.stderr)
        return 1
    rows = []
    for seed in args.seeds:
        rows.append(readings(seed, device, os.path.dirname(HERE)))
        print(json.dumps(rows[-1]), flush=True)
    summary = {}
    for cell in (INT8, BF16):
        nums = [n for n in rows[0][cell]["program"] if n != "yardstick_flip_margin"]
        summary[cell] = {n: {"lower": max(r[cell]["program"][n] for r in rows),
                             "upper": min(r[cell]["control"][n] for r in rows),
                             "program": [r[cell]["program"][n] for r in rows],
                             "control": [r[cell]["control"][n] for r in rows]}
                         for n in nums}
    print(json.dumps({"summary": summary}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"seeds": args.seeds, "rows": rows, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
