"""Run a cell through its traffic's driver and assemble the result line.

A driver (``benchmark/drivers/<name>.py``, named by the traffic file's
``driver``) sets up the system under test from the seed, runs the
window, judges what the timed path produced, and returns the end-to-end
numbers (host clock), the context the per-layer readers take, the trace
summary of a traced run, and the numbers compared with their limits.
"""

from __future__ import annotations

import importlib
import math
import subprocess
import sys
import tempfile
from typing import Optional

from harness import checks as checks_lib
from harness import manifest


def power_limits():
    """``nvidia-smi``'s name and power limit of each card, or None."""
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return res.stdout.strip().splitlines()


def run_cell(cell: manifest.Cell, seed: int, seconds: float, trace: bool, device,
             process_start: float, tmpdir: Optional[str] = None) -> dict:
    driver = importlib.import_module(f"drivers.{cell.traffic['driver']}")
    out = driver.run(cell, seed=seed, seconds=seconds, trace=trace, device=device,
                     process_start=process_start, tmpdir=tmpdir or tempfile.gettempdir())
    if trace:
        metrics = manifest.read_metrics(cell.per_layer, out["ctx"])
    else:
        missing = [m["name"] for m in cell.end_to_end if m["name"] not in out["end_to_end"]]
        if missing:
            raise RuntimeError(f"driver {cell.traffic['driver']} measured no {missing}")
        metrics = {m["name"]: {"value": float(out["end_to_end"][m["name"]]), "unit": m["unit"]}
                   for m in cell.end_to_end}
    checks = out["checks"]
    result = {"correct": checks_lib.met(checks) and out["failed"] == 0,
              "attempted": out["attempted"], "failed": out["failed"], "metrics": metrics}
    if device.type == "cuda":
        import torch

        result["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                            "count": cell.chips, "memory_peak_bytes": out["memory_peak_bytes"]}
        result["card"] = power_limits()
    else:
        result["device"] = {"platform": "cpu", "kind": "cpu", "count": 0,
                            "memory_peak_bytes": 0}
    summary = out.get("trace")
    if trace and summary is not None:
        result["device"]["busy_s"] = summary["busy_s"]
        result["device"]["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["notes"] = out.get("notes", {})
    result["checks"] = checks
    return finite(result)


def finite(value):
    """``value`` with every float that is not finite replaced by None, so
    that the result line is strict JSON."""
    if isinstance(value, float) and not math.isfinite(value):
        return None
    if isinstance(value, dict):
        return {k: finite(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [finite(v) for v in value]
    return value


def print_checks(result: dict, stream=None) -> None:
    checks_lib.print_checks(result["checks"], stream or sys.stderr)

