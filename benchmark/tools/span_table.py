#!/usr/bin/env python3
"""The program's spans on the card: each cell's traced stretch split by
what the program was doing, and what the spans cost.

    python3 benchmark/tools/span_table.py table --workload <cell> --seed <n> [--seconds 30]
    python3 benchmark/tools/span_table.py cost --seed <n> [--seconds 15]
    python3 benchmark/tools/span_table.py micro

``table`` runs the cell as ``run.py --trace 1`` does, with the program's
spans (``tpuseg_torch.utils.profiling.spans``) on inside the traced
stretch only, and prints one JSON line: the run's result, the span table
of ``harness/spans.py`` per item, its readings, and how its rows add up
against the trace's busy and idle time. Against a program without spans
the table holds only ``(outside the program)`` and every reading is None.

``cost`` sets each cell up as its driver does, then serves or steps it in
four turns of ``--seconds`` each, spans off, on, on, off, with no
profiler, and prints the rate of each turn (MP/s or img/s, host clock, a
synchronize at each turn's ends).

``micro`` times ``profiling.span`` off and on (no profiler) on the host,
in microseconds a call.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import sys
import time
import timeit

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [HERE, ROOT]

CELLS = ("int8b-4096-tiled", "bf16-4096-tiled", "train-512-b16")


def program_spans():
    """``profiling.spans()``, or nothing where the program has no spans."""
    from tpuseg_torch.utils import profiling

    return getattr(profiling, "spans", contextlib.nullcontext)()


@contextlib.contextmanager
def span_tracing(kept: dict):
    """Within the region, ``harness/trace.py``'s traced stretch runs with the
    program's spans on, and its summary, kept in ``kept["summary"]``, is
    ``spans.summarize``'s: every key as before, and the span table."""
    from harness import spans, trace

    stretch, base = trace.profile_stretch, trace.summarize

    def profiled(*args, **kwargs):
        with program_spans():
            kept["summary"] = stretch(*args, **kwargs)
        return kept["summary"]

    trace.profile_stretch = profiled
    trace.summarize = lambda doc, items: spans.summarize(doc, items, base)
    try:
        yield
    finally:
        trace.profile_stretch, trace.summarize = stretch, base


def _ratio(a: float, b: float):
    return a / b if b > 0 else None


def table(cell, seed: int, seconds: float, device) -> dict:
    from harness import runner, spans

    kept: dict = {}
    with span_tracing(kept):
        result = runner.run_cell(cell, seed=seed, seconds=seconds, trace=True, device=device,
                                 process_start=time.perf_counter())
    summary = kept["summary"]
    tab = summary["spans"]
    rows, items = tab["by_span"], tab["items"]
    idle = summary["window_s"] - summary["busy_s"]
    outside = rows.get(spans.OUTSIDE, {}).get("device_s", 0.0)
    return {
        "cell": cell.name, "seed": seed, "card": result.get("card"),
        "correct": result["correct"], "metrics": result["metrics"],
        "items": items, "window_ms": 1e3 * summary["window_s"] / items,
        "busy_ms": 1e3 * summary["busy_s"] / items, "idle_ms": 1e3 * idle / items,
        "sums": {"idle_by_span_over_idle": _ratio(sum(r["idle_s"] for r in rows.values()),
                                                  idle),
                 "device_by_span_over_busy": _ratio(sum(r["device_s"] for r in rows.values()),
                                                    summary["busy_s"]),
                 "busy_in_program_pct": 100.0 * (1.0 - outside / summary["busy_s"])
                 if summary["busy_s"] > 0 else None},
        "readings": {name: spans.reading(name, tab) for name in spans.READINGS},
        "per_item_ms": {name: {"count": r["count"] / items, "wall": 1e3 * r["wall_s"] / items,
                               "host": 1e3 * r["host_s"] / items,
                               "device": 1e3 * r["device_s"] / items,
                               "launches": r["launches"] / items,
                               "idle": 1e3 * r["idle_s"] / items}
                        for name, r in sorted(rows.items(), key=lambda kv: -kv[1]["device_s"])},
    }


def _serving(cell, seed: int, device):
    """``(one request, megapixels a request, free)`` of a serving cell."""
    from drivers import serve_tiled as st

    state = st.setup(cell, seed, device)
    state["num_classes"] = cell.config["num_classes"]
    order = st.Order(len(state["pool"]), state["order_seed"])
    for i in range(cell.traffic["warm_passes"]):
        st.serve_one(state, cell.traffic, i % len(state["pool"]), device)
    h, w = state["pool"][0].shape[:2]
    return (lambda: st.serve_one(state, cell.traffic, order.next(), device)), h * w / 1e6, state


def _training(cell, seed: int, device):
    """``(one step, images a step, free)`` of a training cell."""
    from drivers import train_steps as ts
    from harness import weights as weights_lib
    from harness.common import child_seeds, make_pool

    traffic = cell.traffic
    s_weights, s_pool, s_aug, s_drop = child_seeds(seed, 4)
    weights = weights_lib.make(cell.config, s_weights, device)
    pool = make_pool(traffic, s_pool, device)
    state, step = ts.build_step(cell.config, traffic, weights, (s_aug, s_drop), device)
    n = [0]

    def one():
        step(state, *ts.batch(pool, n[0], traffic["batch"]))
        n[0] += 1

    for _ in range(traffic["checked_steps"] + traffic["warm_steps"]):
        one()
    return one, traffic["batch"], {"state": state, "pool": pool}


def cost(cells, seed: int, seconds: float, device) -> list:
    from harness.common import sync

    out = []
    for cell in cells:
        serving = cell.traffic["driver"] == "serve_tiled"
        one, unit, keep = (_serving if serving else _training)(cell, seed, device)
        turns = []
        for on in (False, True, True, False):
            sync(device)
            t0, k = time.perf_counter(), 0
            with program_spans() if on else contextlib.nullcontext():
                while time.perf_counter() - t0 < seconds:
                    one()
                    k += 1
                sync(device)
            dt = time.perf_counter() - t0
            turns.append({"spans": on, "items": k, "seconds": dt, "rate": k * unit / dt})
        off = [t["rate"] for t in turns if not t["spans"]]
        on_ = [t["rate"] for t in turns if t["spans"]]
        out.append({"cell": cell.name, "unit": "MP/s" if serving else "img/s", "turns": turns,
                    "on_over_off": sum(on_) / sum(off)})
        del one, keep
        gc.collect()
        if device.type == "cuda":
            import torch

            torch.cuda.empty_cache()
    return out


def micro(n_off: int = 1_000_000, n_on: int = 200_000) -> dict:
    from tpuseg_torch.utils.profiling import span

    def bare():
        pass

    def marked():
        with span("tiled.upload"):
            pass

    base = min(timeit.repeat(bare, number=n_off, repeat=3)) / n_off
    off = min(timeit.repeat(marked, number=n_off, repeat=3)) / n_off
    with program_spans():
        on = min(timeit.repeat(marked, number=n_on, repeat=3)) / n_on
    return {"call_us": 1e6 * base, "span_off_us": 1e6 * (off - base),
            "span_on_us": 1e6 * (on - base)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("mode", choices=("table", "cost", "micro"))
    ap.add_argument("--workload", choices=CELLS)
    ap.add_argument("--seed", type=int, default=2 ** 31 + 1)
    ap.add_argument("--seconds", type=float)
    args = ap.parse_args(argv)
    if args.mode == "micro":
        print(json.dumps(micro()), flush=True)
        return 0
    from harness import isolation, manifest

    isolation.prepare_environment(ROOT)
    import torch

    if not torch.cuda.is_available():
        print("span_table: this tool measures the card", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    if args.mode == "table":
        cell = manifest.load_cell(args.workload, ROOT)
        print(json.dumps(table(cell, args.seed, args.seconds or 30.0, device)), flush=True)
    else:
        cells = [manifest.load_cell(name, ROOT) for name in
                 ([args.workload] if args.workload else CELLS)]
        print(json.dumps(cost(cells, args.seed, args.seconds or 15.0, device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
