"""Device time by kernel from a ``torch.profiler`` Chrome trace.

Counterpart of ``tpuseg/utils/trace_analysis.py`` for the traces that
``tpuseg_torch.utils.profiling.trace`` writes (``cli.train
--profile_steps N`` puts them under ``<output>/profile``):

    python -m tpuseg_torch.utils.trace_analysis <profile_dir> [--top N]

It reports the card's kernel time (kernels, copies and sets on the device
timeline), the profiled steps (``ProfilerStep#N`` spans, with each one's
wall time) and device ms per step, device time and launch counts by group
of kernels (:data:`KERNEL_GROUPS`, also used by ``chip_smoke.py``), the
top-N kernels, and the busy share of the traced window: the union of
device intervals over the time from the first step's start to the last
step's end. It reports no FLOP/s or
bandwidth: a trace holds no operation counts. A trace without device
events (a CPU run) is reported as such, with ``device_plane`` None.
"""

from __future__ import annotations

import glob
import json
import os
import re
from collections import Counter
from typing import Dict, List, Optional, Tuple

# kernel-name fragments -> group, first match wins (a name heuristic)
KERNEL_GROUPS = (
    ("K1 shear_rows", ("shear_rows",)),
    ("K6 dense_head_argmax", ("dense_head_mma_kernel", "dense_head_fp_kernel")),
    ("K2 head_argmax", ("head_mma_kernel", "head_fp_kernel")),
    ("K3 int8_conv", ("int8_conv_kernel", "int8_conv_wgmma_kernel")),
    ("K5 input_conv", ("input_conv_kernel",)),
    ("K4 batchnorm", ("bn_reduce_kernel", "bn_apply_kernel")),
    ("NCCL", ("nccl", "ncclDevKernel", "ncclKernel")),
    ("layout transposes", ("nchwToNhwc", "nhwcToNchw")),
    ("cuDNN / GEMM", ("cudnn", "xmma", "gemm", "cutlass", "sm90_", "sm80_", "wgrad", "dgrad")),
    ("reductions", ("reduce_kernel",)),
    ("copies and casts", ("copy", "Cat", "Memcpy", "Memset")),
    ("elementwise", ("elementwise",)),
)

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
_STEP_RE = re.compile(r"^ProfilerStep#\d+$")


def kernel_group(name: str) -> str:
    for group, keys in KERNEL_GROUPS:
        if any(k in name for k in keys):
            return group
    return "other"


def find_trace(profile_dir: str) -> Optional[str]:
    """Newest ``*.pt.trace.json`` under a --profile_steps output directory."""
    hits = glob.glob(os.path.join(profile_dir, "**", "*.pt.trace.json"), recursive=True)
    return max(hits, key=os.path.getmtime) if hits else None


def _union_ms(intervals: List[Tuple[float, float]], lo: float, hi: float) -> float:
    """Length of the union of ``intervals`` (µs) clipped to [lo, hi], in ms."""
    total, end = 0.0, lo
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            total += b - a
            end = b
    return total / 1e3


def analyze(profile_dir: str, top: int = 25) -> Dict:
    """Aggregate the newest trace under ``profile_dir``.

    Returns ``{"trace", "device_plane": str|None, "total_ms", "steps",
    "step_wall_ms": [...], "ms_per_step", "window_ms", "busy_share",
    "groups": {group: {"ms", "share", "count"}},
    "top_kernels": [(ms, share, count, name), ...]}``,
    with a ``"note"`` (and the device numbers zero or None) for a trace
    that holds no device events."""
    fp = find_trace(profile_dir)
    if fp is None:
        raise IOError(f"no .pt.trace.json under {profile_dir} — did --profile_steps run?")
    with open(fp) as f:
        doc = json.load(f)
    events = [e for e in doc.get("traceEvents", []) if e.get("ph") == "X"]
    step_spans = {e["name"]: (e["ts"], e["ts"] + e["dur"]) for e in events
                  if _STEP_RE.match(str(e.get("name", "")))
                  and not str(e.get("cat", "")).startswith("gpu_")}
    device = [e for e in events if e.get("cat") in DEVICE_CATEGORIES]
    steps = len(step_spans)
    step_wall_ms = [(b - a) / 1e3 for a, b in sorted(step_spans.values())]
    if not device:
        return {"trace": fp, "device_plane": None, "total_ms": 0.0, "steps": steps,
                "step_wall_ms": step_wall_ms, "ms_per_step": None, "window_ms": None,
                "busy_share": None, "groups": {}, "top_kernels": [],
                "note": "no CUDA kernel events in the trace (a CPU-only run?)"}

    if step_spans:
        lo = min(a for a, _ in step_spans.values())
        hi = max(b for _, b in step_spans.values())
    else:
        lo = min(e["ts"] for e in events)
        hi = max(e["ts"] + e["dur"] for e in events)
    by_name: Counter = Counter()
    counts: Counter = Counter()
    for e in device:
        by_name[e["name"]] += e["dur"]
        counts[e["name"]] += 1
    total_us = sum(by_name.values())
    groups: Dict[str, Dict[str, float]] = {}
    for name, us in by_name.items():
        g = groups.setdefault(kernel_group(name), {"ms": 0.0, "share": 0.0, "count": 0})
        g["ms"] += us / 1e3
        g["count"] += counts[name]
    for g in groups.values():
        g["share"] = g["ms"] * 1e3 / total_us if total_us else 0.0
    props = doc.get("deviceProperties") or [{}]
    window_ms = (hi - lo) / 1e3
    busy_ms = _union_ms([(e["ts"], e["ts"] + e["dur"]) for e in device], lo, hi)
    return {
        "trace": fp,
        "device_plane": props[0].get("name", "cuda"),
        "total_ms": total_us / 1e3,
        "steps": steps,
        "step_wall_ms": step_wall_ms,
        "ms_per_step": total_us / 1e3 / steps if steps else None,
        "window_ms": window_ms,
        "busy_share": busy_ms / window_ms if window_ms > 0 else None,
        "groups": dict(sorted(groups.items(), key=lambda kv: -kv[1]["ms"])),
        "top_kernels": [(us / 1e3, us / total_us if total_us else 0.0, counts[name], name)
                        for name, us in by_name.most_common(top)],
    }


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(
        prog="trace_analysis",
        description="Aggregate device time by kernel from a torch.profiler trace "
                    "(the --profile_steps output)")
    parser.add_argument("profile_dir", type=str,
                        help="directory holding <host>_<pid>.<ms>.pt.trace.json")
    parser.add_argument("--top", type=int, default=25, help="how many kernels to list")
    args = parser.parse_args(argv)

    r = analyze(args.profile_dir, args.top)
    print(f"trace: {r['trace']}")
    if r["device_plane"] is None:
        print(f"{r['note']} ({r['steps']} steps)")
        return r
    per_step = (f" ({r['ms_per_step']:.2f} ms/step over {r['steps']} steps)"
                if r["steps"] else "")
    print(f"device: {r['device_plane']}")
    print(f"total device time: {r['total_ms']:.2f} ms{per_step}")
    if r["steps"]:
        print("step wall times: " + ", ".join(f"{ms:.2f}" for ms in r["step_wall_ms"]) + " ms")
    if r["busy_share"] is not None:
        print(f"busy share of the traced window ({r['window_ms']:.2f} ms): "
              f"{r['busy_share']:.1%}")
    print("\nby group:")
    for group, g in r["groups"].items():
        print(f"  {group:<18} {g['ms']:9.2f} ms  {g['share']:6.1%}  x{g['count']}")
    print(f"\ntop {len(r['top_kernels'])} kernels:")
    for ms, share, count, name in r["top_kernels"]:
        print(f"  {ms:8.2f} ms  {share:6.1%}  x{count:<5d} {name[:110]}")
    return r


if __name__ == "__main__":
    main()
