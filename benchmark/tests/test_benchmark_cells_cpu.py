"""Each one-chip cell's harness end to end at a tiny size on the CPU, and
the shape of the line a run prints."""

import json
import os
import subprocess
import sys

import pytest

import tiny
from harness import manifest

SERVING = ["int8b-4096-tiled", "bf16-4096-tiled"]
CELLS = SERVING + ["train-512-b16"]


def result_keys_ok(res: dict, cell: manifest.Cell):
    assert list(res)[:4] == ["correct", "attempted", "failed", "metrics"]
    assert list(res)[-1] == "checks"  # the numbers compared come last
    assert isinstance(res["correct"], bool) and res["attempted"] > 0 and res["failed"] == 0
    assert {m["name"]: m["unit"] for m in cell.end_to_end} == {
        k: v["unit"] for k, v in res["metrics"].items()}
    assert all(v["value"] > 0 for v in res["metrics"].values())
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(res["device"])
    json.loads(json.dumps(res, allow_nan=False))  # a valid JSON line


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_end_to_end_on_the_cpu(name):
    cell = tiny.cell(name)
    res = tiny.run(cell)
    result_keys_ok(res, cell)


def test_bf16_serving_is_correct_at_a_tiny_size():
    res = tiny.run(tiny.cell("bf16-4096-tiled"))
    assert res["correct"], res["checks"]


def test_runs_without_a_card_exit_1_and_print_no_result(tmp_path):
    root = os.path.dirname(manifest.BENCH_DIR)
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "int8b-4096-tiled",
                          "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
                         cwd=root, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode == 1
    assert out.stdout.strip() == ""
    assert "torch.cuda.is_available() is false" in out.stderr


def test_an_unknown_cell_exits_1(tmp_path):
    root = os.path.dirname(manifest.BENCH_DIR)
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "no-such-cell",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=root, capture_output=True, text=True, timeout=300)
    assert out.returncode == 1 and out.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_is_correct_on_the_card(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    root = os.path.dirname(manifest.BENCH_DIR)
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", name,
                          "--seed", str(2 ** 31 + 11), "--seconds", "3", "--trace", "0"],
                         cwd=root, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    result_keys_ok(res, manifest.load_cell(name, root))
    assert res["correct"], res["checks"]
