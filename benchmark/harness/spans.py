"""The program's own spans in a traced stretch, and the card's time split
by them.

``tpuseg_torch.utils.profiling.span`` marks what the program is doing
(``tiled.upload``, ``train.backward``, ...) as ``record_function`` ranges,
events of the same profiler session as the card's kernels and copies, so
they share the device trace's clock. A span that encloses one request
carries its number as a ``#N`` suffix (``tiled.image#12``,
``train.step#40``), which is stripped here before spans are added up.

:func:`reduce` takes the Chrome trace that ``harness/trace.py::summarize``
reads and, inside the same ``bench.stretch`` window, gives for each span
name:

- ``device_s`` and ``launches``: the device time and kernels that the
  span caused. Each kernel, copy or set is matched to the CUDA runtime or
  driver call that issued it (``args["correlation"]``), on whatever thread
  that call ran (the autograd engine issues the backward's kernels from
  its own thread while the main thread waits inside ``train.backward``),
  and goes to the innermost span open at the call's start. Where streams
  overlap, each instant of the device's busy union goes to the operation
  that reached it first, so the rows add up to the busy time;
- ``idle_s``: the device's idle time under the span, each idle instant
  given to the innermost span open on the stretch's thread at that
  instant, so the rows add up to the idle time;
- ``host_s``: the span's wall time less the union of CUDA runtime and
  driver calls, on any thread, inside it: the host's own work, without a
  spin in a full launch queue or a wait in a synchronize;
- ``wall_s`` and ``count``.

What no span covers goes to ``(outside the program)``. Times are totals
over the stretch's ``items``. :func:`summarize` is ``trace.summarize`` of
the trace without the program's spans (so each of its keys reads as it
does without them) with this table under ``spans``; :func:`reading`
gives the per-layer numbers read from it.
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

from harness import trace

PREFIXES = ("tiled.", "train.", "row_gather:", "row_gather_backward:", "halo_exchange:")
OUTSIDE = "(outside the program)"
RUNTIME_CATEGORIES = ("cuda_runtime", "cuda_driver")
_NUMBER = re.compile(r"#\d+$")


def span_name(name: str) -> str:
    """``name`` without a request's ``#N``."""
    return _NUMBER.sub("", name)


def is_program_span(e: dict) -> bool:
    return e.get("cat") == "user_annotation" and e["name"].startswith(PREFIXES)


def segments(spans: List[dict], lo: float, hi: float) -> List[Tuple[float, float, str]]:
    """``[(start, end, name)]`` in order, partitioning ``[lo, hi]``: at each
    instant the innermost of ``spans`` open (the one that started last;
    of two that start together, the shorter), or :data:`OUTSIDE`."""
    cuts = sorted({lo, hi} | {min(max(t, lo), hi) for e in spans
                              for t in (e["ts"], e["ts"] + e["dur"])})
    opens = sorted(spans, key=lambda e: (e["ts"], -e["dur"]))
    active: List[dict] = []
    out: List[Tuple[float, float, str]] = []
    i = 0
    for a, b in zip(cuts, cuts[1:]):
        while i < len(opens) and opens[i]["ts"] <= a:
            active.append(opens[i])
            i += 1
        active = [e for e in active if e["ts"] + e["dur"] > a]
        name = span_name(active[-1]["name"]) if active else OUTSIDE
        if out and out[-1][2] == name:
            out[-1] = (out[-1][0], b, name)
        else:
            out.append((a, b, name))
    return out


def _at(segs: List[Tuple[float, float, str]], starts: List[float], t: float) -> str:
    """The segment's name at ``t``; :data:`OUTSIDE` outside them all."""
    i = bisect.bisect_right(starts, t) - 1
    if i < 0 or t >= segs[i][1]:
        return OUTSIDE
    return segs[i][2]


def _covered(merged: List[Tuple[float, float]], ends: List[float], a: float, b: float) -> float:
    """How much of ``[a, b]`` the sorted disjoint intervals ``merged``
    (``ends`` their ends) cover."""
    total = 0.0
    for x, y in merged[bisect.bisect_right(ends, a):]:
        if x >= b:
            break
        total += min(y, b) - max(x, a)
    return total


def _row() -> Dict:
    return {"count": 0, "wall_s": 0.0, "host_s": 0.0, "device_s": 0.0, "launches": 0,
            "idle_s": 0.0}


def reduce(doc: dict, items: int) -> Dict:
    events = [e for e in doc.get("traceEvents", []) if e.get("ph") == "X"]
    stretch = [e for e in events if e.get("cat") == "user_annotation"
               and e["name"] == trace.STRETCH]
    if not stretch:
        raise RuntimeError(f"the trace holds no {trace.STRETCH} span")
    lo = stretch[0]["ts"]
    hi = lo + stretch[0]["dur"]
    main = (stretch[0].get("pid"), stretch[0].get("tid"))
    program = [e for e in events if is_program_span(e)
               and e["ts"] < hi and e["ts"] + e["dur"] > lo]
    runtime = [e for e in events if e.get("cat") in RUNTIME_CATEGORIES]
    issued = {e["args"]["correlation"]: e["ts"] for e in runtime
              if "correlation" in e.get("args", {})}
    device = []
    for e in events:
        if e.get("cat") not in trace.DEVICE_CATEGORIES or "spin_kernel" in e["name"]:
            continue
        a, b = max(e["ts"], lo), min(e["ts"] + e["dur"], hi)
        if b > a:
            device.append((a, b, e))
    rows: Dict[str, Dict] = defaultdict(_row)

    any_segs = segments(program, lo, hi)
    any_starts = [s[0] for s in any_segs]
    reached = lo
    for a, b, e in sorted(device, key=lambda d: (d[0], d[1])):
        t = issued.get(e.get("args", {}).get("correlation"))
        row = rows[OUTSIDE if t is None else _at(any_segs, any_starts, t)]
        row["device_s"] += max(0.0, b - max(a, reached)) / 1e6
        reached = max(reached, b)
        if e["cat"] == "kernel":
            row["launches"] += 1

    busy, merged = trace.union_us([(a, b) for a, b, _ in device])
    main_segs = segments([e for e in program if (e.get("pid"), e.get("tid")) == main], lo, hi)
    edges = [lo] + [x for ab in merged for x in ab] + [hi]
    k = 0
    for a, b in zip(edges[0::2], edges[1::2]):  # the idle intervals
        while k < len(main_segs) and main_segs[k][1] <= a:
            k += 1
        j = k
        while j < len(main_segs) and main_segs[j][0] < b:
            x, y, name = main_segs[j]
            rows[name]["idle_s"] += (min(y, b) - max(x, a)) / 1e6
            j += 1

    _, calls = trace.union_us([(e["ts"], e["ts"] + e["dur"]) for e in runtime])
    ends = [y for _, y in calls]
    for e in program:
        a, b = max(e["ts"], lo), min(e["ts"] + e["dur"], hi)
        row = rows[span_name(e["name"])]
        row["count"] += 1
        row["wall_s"] += (b - a) / 1e6
        row["host_s"] += (b - a - _covered(calls, ends, a, b)) / 1e6
    return {"items": items, "window_s": (hi - lo) / 1e6, "busy_s": busy / 1e6,
            "by_span": dict(rows)}


def without_program_spans(doc: dict) -> dict:
    return {**doc, "traceEvents": [e for e in doc.get("traceEvents", [])
                                   if not (e.get("ph") == "X" and is_program_span(e))]}


def summarize(doc: dict, items: int, base: Optional[Callable] = None) -> Dict:
    """``base`` (``trace.summarize``) of ``doc`` without the program's
    spans, with :func:`reduce`'s table under ``spans``."""
    out = (base or trace.summarize)(without_program_spans(doc), items)
    out["spans"] = reduce(doc, items)
    return out


def _per_item(table: Dict, span: str, key: str) -> Optional[float]:
    row = table["by_span"].get(span)
    if row is None or not table["items"]:
        return None
    return 1e3 * row[key] / table["items"]


def _per_span(table: Dict, span: str, key: str) -> Optional[float]:
    row = table["by_span"].get(span)
    if row is None or not row["count"]:
        return None
    return 1e3 * row[key] / row["count"]


def _outside_idle(table: Dict) -> Optional[float]:
    if "tiled.image" not in table["by_span"] or not table["items"]:
        return None
    return 1e3 * table["by_span"].get(OUTSIDE, _row())["idle_s"] / table["items"]


# the per-layer numbers read from a table, ms
READINGS: Dict[str, Callable[[Dict], Optional[float]]] = {
    # the card's idle time under the upload, an image
    "tiled.upload_idle_ms": lambda t: _per_item(t, "tiled.upload", "idle_s"),
    # the card's idle time while no span is open, an image: the gap between slides
    "serve.outside_idle_ms": _outside_idle,
    # the host's wall time of one predict call: its enqueue
    "tiled.predict_host_ms": lambda t: _per_span(t, "tiled.predict", "wall_s"),
    # the device time of Adam's foreach chain, a step
    "train.optimizer_ms": lambda t: _per_item(t, "train.optimizer", "device_s"),
    # a step's host work outside CUDA runtime and driver calls
    "train.host_ms": lambda t: _per_span(t, "train.step", "host_s"),
}


def reading(name: str, table: Optional[Dict]) -> Optional[float]:
    """The per-layer number ``name`` of :data:`READINGS` from a span table,
    or None where the table lacks its span (a program without spans, or a
    cell of the other kind)."""
    if not table:
        return None
    return READINGS[name](table)
