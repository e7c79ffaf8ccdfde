"""The limits that decide ``correct``, one file a cell.

``benchmark/checks/<cell>.json`` holds what the cell's driver needs to
judge (for serving: the yardstick's precision and the factor,
``reference/check.py``) and, for each number compared, its ``limit`` and
the two readings it was set between: ``lower``, the largest that sound
runs of the program gave over a dozen seeds or more, and ``upper``, the
smallest that the control gave (the reference computed in the next
precision below the configuration's, or the program's own path in it).
A number is met when it is at most its limit; a number without a limit
is never met.
"""

from __future__ import annotations

import json
import math
import os
import sys
from typing import Dict

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def spec(cell: str) -> dict:
    """The cell's check file, or ``{}``."""
    path = os.path.join(BENCH_DIR, "checks", f"{cell}.json")
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def compare(cell: str, numbers: Dict[str, float]) -> Dict[str, dict]:
    """Each number the cell's check file gives a limit, beside it; a cell
    without a check file compares every number against no limit."""
    lim = {k: v["limit"] for k, v in spec(cell).get("numbers", {}).items()}
    names = lim or numbers
    return {k: {"value": numbers[k], "limit": lim.get(k)} for k in names}


def met(checks: Dict[str, dict]) -> bool:
    return bool(checks) and all(
        c["limit"] is not None and math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())


def print_checks(checks: Dict[str, dict], stream=None) -> None:
    stream = stream or sys.stderr
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=stream, flush=True)
