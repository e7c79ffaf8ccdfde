"""Find a cell and everything it names, by name, from ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix. The configuration's entry gives its file; the traffic mix is
``benchmark/workloads/<traffic>.json``; a per-layer metric's reader is
``benchmark/metrics/<metric>.py``. Which metrics a cell reports follows
from the manifest alone: an end-to-end metric with a ``workloads`` list
is reported in those cells, one without it in every cell; a per-layer
metric with a ``workloads`` list in those cells, one without it in every
cell that reports the end-to-end metric it ``moves``.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class ManifestError(ValueError):
    pass


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: dict
    traffic: dict
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)


def read_manifest(root: str) -> dict:
    path = os.path.join(root, "BENCHMARK.json")
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        raise ManifestError(f"no BENCHMARK.json at {root}") from None


def _read_json(path: str, what: str) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        raise ManifestError(f"{what}: no file {path}") from None


def cell_metrics(doc: dict, cell: str):
    """``(end_to_end, per_layer)``: the metric entries that ``cell`` reports."""
    e2e = [m for m in doc["end_to_end"] if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}

    def reports(m):
        return cell in m["workloads"] if "workloads" in m else m["moves"] in names

    return e2e, [m for m in doc["per_layer"] if reports(m)]


def load_cell(name: str, root: str) -> Cell:
    doc = read_manifest(root)
    cells = {w["name"]: w for w in doc["workloads"]}
    if name not in cells:
        raise ManifestError(f"no cell {name!r} in BENCHMARK.json (cells: {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in doc["configs"]}
    if w["config"] not in configs:
        raise ManifestError(f"cell {name}: no configuration {w['config']!r}")
    config = _read_json(os.path.join(root, configs[w["config"]]["file"]),
                        f"configuration {w['config']}")
    traffic = _read_json(os.path.join(BENCH_DIR, "workloads", f"{w['traffic']}.json"),
                         f"traffic {w['traffic']}")
    e2e, per_layer = cell_metrics(doc, name)
    return Cell(name=name, chips=int(w["chips"]), config_name=w["config"],
                traffic_name=w["traffic"], config=config, traffic=traffic,
                end_to_end=e2e, per_layer=per_layer)


def metric_reader(metric: str):
    """The ``read(ctx)`` function of ``benchmark/metrics/<metric>.py``."""
    path = os.path.join(BENCH_DIR, "metrics", f"{metric}.py")
    if not os.path.exists(path):
        raise ManifestError(f"metric {metric}: no reader {path}")
    spec = importlib.util.spec_from_file_location(f"bench_metric_{metric.replace('.', '_')}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def read_metrics(entries: List[dict], ctx: dict) -> Dict[str, dict]:
    """Each metric of ``entries`` that its reader finds something to read
    for, as ``{"value", "unit"}``; a reader that returns None is left out."""
    out = {}
    for m in entries:
        value = metric_reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
