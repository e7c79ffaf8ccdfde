"""``BENCHMARK.json`` against the benchmark's contract, and the harness
finding a new configuration, cell and metric from files alone."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from harness import manifest

BENCH = manifest.BENCH_DIR
ROOT = os.path.dirname(BENCH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def doc():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level(doc):
    assert set(doc) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert doc["command"][:2] == ["python3", "benchmark/run.py"] and len(doc["command"]) <= 32
    assert doc["paths"] == ["benchmark"]
    assert isinstance(doc["run_seconds"], int) and 1 <= doc["run_seconds"] <= 51
    # a full check of 24 cells fits: 2 + 14 runs a cell, each run_seconds + 60,
    # 2 x 90 s a cell to compile, 1200 s spare
    assert (2 + 14 * 24) * (doc["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_entries_have_just_their_keys_and_valid_names(doc):
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
            "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"}}
    for section, allowed in keys.items():
        names = [e["name"] for e in doc[section]]
        assert len(set(names)) == len(names)
        for e in doc[section]:
            assert set(e) <= allowed and set(e) >= allowed - {"workloads"}, e
            assert NAME.match(e["name"]), e["name"]
            for text in ("why", "layer", "source"):
                if text in e:
                    assert 1 <= len(e[text]) <= 200 and not set(e[text]) & {"\n", "\t"}
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    for w in doc["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
    pairs = [(w["config"], w["traffic"]) for w in doc["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert sum(w["chips"] == 4 for w in doc["workloads"]) <= max(1, len(pairs) // 4)


def test_metrics(doc):
    e2e = {m["name"]: m for m in doc["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in doc["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in doc["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and 1 <= len(m["layer"]) <= 200
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
        assert os.path.exists(os.path.join(BENCH, "metrics", f"{m['name']}.py"))
    for w in doc["workloads"]:
        reported, per_layer = manifest.cell_metrics(doc, w["name"])
        names = {m["name"] for m in reported}
        assert "setup_s" in names and len(names) >= 2 and per_layer
        for m in per_layer:
            assert m["moves"] in names, (w["name"], m["name"])


def test_every_cell_has_its_files(doc):
    configs = {c["name"]: c for c in doc["configs"]}
    used = set()
    for w in doc["workloads"]:
        cell = manifest.load_cell(w["name"], ROOT)
        used.add(w["config"])
        assert cell.traffic["driver"]
        assert os.path.exists(os.path.join(BENCH, "drivers", f"{cell.traffic['driver']}.py"))
        assert os.path.exists(os.path.join(BENCH, "checks", f"{w['name']}.json"))
    assert used == set(configs)
    for c in doc["configs"]:
        assert c["file"].startswith("benchmark/") and os.path.exists(os.path.join(ROOT, c["file"]))
        assert len(c["reduced"]) <= 16


def test_a_new_configuration_cell_and_metric_need_only_files(tmp_path, doc):
    """Copy the benchmark, add a configuration, a traffic mix, a cell and a
    per-layer metric as new files and manifest entries, and find them all
    with the copied harness unchanged."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    new = json.loads(json.dumps(doc))
    new["configs"].append({"name": "unet-new", "source": "https://example.org/unet",
                           "file": "benchmark/configs/unet-new.json", "reduced": [],
                           "why": "a new configuration"})
    new["workloads"].append({"name": "new-cell", "config": "unet-new",
                             "traffic": "tiled-new", "chips": 1, "why": "a new cell"})
    new["end_to_end"][0]["workloads"].append("new-cell")
    new["per_layer"].append({"name": "new.metric", "unit": "%", "better": "higher",
                             "source": "device_trace", "layer": "device",
                             "moves": new["end_to_end"][0]["name"],
                             "workloads": ["new-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(new))
    shutil.copy(os.path.join(BENCH, "configs", "unet-nist-bf16.json"),
                root / "benchmark" / "configs" / "unet-new.json")
    shutil.copy(os.path.join(BENCH, "workloads", "tiled-4096.json"),
                root / "benchmark" / "workloads" / "tiled-new.json")
    (root / "benchmark" / "metrics" / "new.metric.py").write_text(
        "def read(ctx):\n    return 42.0 if ctx.get('kind') == 'serve' else None\n")
    code = ("import json, sys; sys.path[:0] = [sys.argv[1]]\n"
            "from harness import manifest\n"
            "c = manifest.load_cell('new-cell', sys.argv[2])\n"
            "got = manifest.read_metrics([m for m in c.per_layer if m['name'] == 'new.metric'],"
            " {'kind': 'serve'})\n"
            "print(json.dumps({'config': c.config_name, 'traffic': c.traffic['driver'],"
            " 'e2e': [m['name'] for m in c.end_to_end], 'got': got}))\n")
    out = subprocess.run([sys.executable, "-c", code, str(root / "benchmark"), str(root)],
                         capture_output=True, text=True, check=True, timeout=120)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["config"] == "unet-new" and res["traffic"] == "serve_tiled"
    assert doc["end_to_end"][0]["name"] in res["e2e"] and "setup_s" in res["e2e"]
    assert res["got"] == {"new.metric": {"value": 42.0, "unit": "%"}}


def test_the_result_line_is_strict_json():
    from harness import runner

    line = runner.finite({"a": float("inf"), "b": [1.0, float("nan")], "c": {"d": 2}})
    assert json.loads(json.dumps(line, allow_nan=False)) == {"a": None, "b": [1.0, None],
                                                             "c": {"d": 2}}
