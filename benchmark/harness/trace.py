"""A profiled stretch of a run, and what the benchmark reads from it.

:func:`profile_stretch` runs some whole items of the window (images or
steps) under ``torch.profiler``, behind a lead-in of spin kernels: on an
H100 the profiler drops the first kernel records of a window, more the
longer the process has run, and the spins take that loss. The items sit
inside a ``bench.stretch`` span, which is the traced window.

:func:`summarize` reduces the Chrome trace to what the per-layer readers
take: the device's busy time as the union of its kernel, copy and set
intervals inside the window (right where streams overlap, as NCCL's do
under DDP), device time and launches by kernel group (the benchmark's own
frozen table, ``kernel_groups.json``), host-to-device copy time, and a
breakdown: the device operations that took most time, and the idle gaps by
the host operation that was running while the device waited.
"""

from __future__ import annotations

import bisect
import json
import os
import time
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
                   "python_function")
STRETCH = "bench.stretch"
LEAD_IN = 64
TOP = 10

with open(os.path.join(HERE, "kernel_groups.json")) as _f:
    KERNEL_GROUPS = [(g, tuple(keys)) for g, keys in json.load(_f)["groups"]]


def kernel_group(name: str) -> str:
    for group, keys in KERNEL_GROUPS:
        if any(k in name for k in keys):
            return group
    return "other"


def union_us(intervals: List[Tuple[float, float]]) -> Tuple[float, List[Tuple[float, float]]]:
    """Length of the union of ``intervals`` and the merged intervals, sorted."""
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged), [(a, b) for a, b in merged]


def _host_label(host: List[dict], starts: List[float], t: float) -> str:
    """The innermost host operation running at ``t`` (µs): of those that
    cover ``t``, the one that started last. ``host`` is sorted by start."""
    i = bisect.bisect_right(starts, t)
    for e in reversed(host[max(0, i - 2000):i]):
        if e["ts"] + e["dur"] >= t:
            return e["name"]
    return "(no host operation)"


def summarize(doc: dict, items: int) -> Dict:
    events = [e for e in doc.get("traceEvents", []) if e.get("ph") == "X"]
    spans = [e for e in events if e.get("cat") == "user_annotation" and e["name"] == STRETCH]
    if not spans:
        raise RuntimeError(f"the trace holds no {STRETCH} span")
    lo = spans[0]["ts"]
    hi = lo + spans[0]["dur"]
    device = []
    for e in events:
        if e.get("cat") not in DEVICE_CATEGORIES or "spin_kernel" in e["name"]:
            continue
        a, b = max(e["ts"], lo), min(e["ts"] + e["dur"], hi)
        if b > a:
            device.append((a, b, e))
    busy, merged = union_us([(a, b) for a, b, _ in device])
    by_group: Dict[str, float] = defaultdict(float)
    launches_by_group: Dict[str, int] = defaultdict(int)
    by_name: Dict[str, float] = defaultdict(float)
    h2d = 0.0
    for a, b, e in device:
        g = kernel_group(e["name"])
        by_group[g] += (b - a) / 1e6
        by_name[e["name"]] += (b - a) / 1e6
        if e["cat"] == "kernel":
            launches_by_group[g] += 1
        if e["cat"] == "gpu_memcpy" and "HtoD" in e["name"]:
            h2d += (b - a) / 1e6
    host = [e for e in events if e.get("cat") in HOST_CATEGORIES
            and e["name"] != STRETCH and e["ts"] < hi
            and e["ts"] + e["dur"] > lo]
    host.sort(key=lambda e: e["ts"])
    starts = [e["ts"] for e in host]
    gaps: Dict[str, float] = defaultdict(float)
    edges = [lo] + [x for ab in merged for x in ab] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            gaps[_host_label(host, starts, (a + b) / 2)] += (b - a) / 1e6
    window = (hi - lo) / 1e6
    return {
        "items": items,
        "window_s": window,
        "busy_s": busy / 1e6,
        "idle_pct": 100.0 * (1.0 - busy / (hi - lo)) if hi > lo else None,
        "by_group_s": dict(by_group),
        "launches_by_group": dict(launches_by_group),
        "launches": sum(launches_by_group.values()),
        "h2d_s": h2d,
        "device_ops": sorted(([n[:160], s] for n, s in by_name.items()),
                             key=lambda r: -r[1])[:TOP],
        "idle_gaps": sorted(([n[:160], s] for n, s in gaps.items()),
                            key=lambda r: -r[1])[:TOP],
    }


def profile_stretch(step: Callable[[], None], items: int, tmpdir: str,
                    lead_in: int = LEAD_IN) -> Dict:
    """Run ``step`` ``items`` times under the profiler, behind ``lead_in``
    spin kernels, and summarize the trace; ``wall_s`` is the stretch's
    host time. The trace file goes to ``tmpdir`` and is removed."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(lead_in):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with record_function(STRETCH):
            for _ in range(items):
                with record_function("bench.item"):
                    step()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    path = os.path.join(tmpdir, f"bench-trace-{os.getpid()}.json")
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
    finally:
        if os.path.exists(path):
            os.remove(path)
    out = summarize(doc, items)
    out["wall_s"] = wall
    return out
