#!/usr/bin/env python3
"""Run one cell of the benchmark of ``tpuseg_torch`` once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. ``BENCHMARK.json`` names the cell's model
configuration (``benchmark/configs/<config>.json``) and traffic mix
(``benchmark/workloads/<traffic>.json``); the traffic's ``driver`` names
the loop that serves it (``benchmark/drivers/<driver>.py``), and each
per-layer metric is read by ``benchmark/metrics/<metric>.py``. A cell,
configuration, traffic mix or metric is added by adding files and
entries: nothing here names one.

With ``--trace 0`` the run measures the cell's end-to-end metrics by the
host clock over a window of ``--seconds``; with ``--trace 1`` it profiles
a steady stretch inside the window and reports the per-layer metrics.
Either way it then checks what the timed path returned against the plain
reference (``benchmark/reference/``), prints each number compared beside
its limit as the last lines of standard error, and prints one JSON line
as the last line of standard output.

The run needs a CUDA card: without one (or with fewer than the cell asks
for) it exits 1 and prints no result.
"""

from __future__ import annotations

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for p in (HERE, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness import isolation, manifest  # noqa: E402


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def fail(msg: str) -> int:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    return 1


def main(argv=None) -> int:
    args = parse(argv)
    isolation.prepare_environment(ROOT)
    try:
        cell = manifest.load_cell(args.workload, ROOT)
    except manifest.ManifestError as e:
        return fail(str(e))
    import torch

    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: this benchmark measures the card")
    if torch.cuda.device_count() < cell.chips:
        return fail(f"cell {cell.name} needs {cell.chips} cards, "
                    f"torch.cuda.device_count() is {torch.cuda.device_count()}")
    from harness import runner

    result = runner.run_cell(cell, seed=args.seed, seconds=args.seconds,
                             trace=bool(args.trace), device=torch.device("cuda", 0),
                             process_start=PROCESS_START)
    found = isolation.forbidden_modules()
    if found:
        return fail("modules of the JAX package or JAX are loaded: " + ", ".join(found))
    runner.print_checks(result)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
