"""A run with its timed path broken underneath comes out not correct: the
harness's look for a card skipped, everything else of a run driven at a
tiny size on the CPU, once for each fault a cell can have. And each cell's
control, computed at a tiny size, fails the cell's limits."""

import pytest
import torch

import tiny
from drivers import serve_tiled, train_steps
from harness import checks


def half_batch_predict(fn):
    """Half of each predict call's tiles left out: labels 0 for them."""
    def predict(batch):
        out = fn(batch[: max(1, batch.shape[0] // 2)])
        full = torch.zeros((batch.shape[0],) + tuple(out.shape[1:]), dtype=out.dtype,
                           device=out.device)
        full[: out.shape[0]] = out
        return full
    return predict


def altered_predict(fn):
    """An answer altered where it is produced: the first tile of each call
    has its labels flipped."""
    def predict(batch):
        out = fn(batch).clone()
        out[0] = 1 - out[0]
        return out
    return predict


@pytest.mark.parametrize("fault", [half_batch_predict, altered_predict])
@pytest.mark.parametrize("name", ["int8b-4096-tiled", "bf16-4096-tiled"])
def test_serving_fault_is_not_correct(monkeypatch, name, fault):
    build = serve_tiled.build_predict
    monkeypatch.setattr(serve_tiled, "build_predict", lambda *a, **k: fault(build(*a, **k)))
    res = tiny.run(tiny.cell(name))
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("fault", ["half_batch", "unchanged_state"])
def test_training_fault_is_not_correct(monkeypatch, fault):
    """Half of the batch left out, the mean taken over the rest; a step
    that returns its state unchanged (``tools/train_limits.py``)."""
    from tools import train_limits

    build = train_steps.build_step

    def broken(cfg, traffic, *a, **k):
        state, step = build(cfg, traffic, *a, **k)
        return state, train_limits.FAULTS[fault](step, traffic["batch"])

    monkeypatch.setattr(train_steps, "build_step", broken)
    res = tiny.run(tiny.cell("train-512-b16"))
    assert not res["correct"], res["checks"]


def test_training_is_correct_at_a_tiny_size():
    res = tiny.run(tiny.cell("train-512-b16"))
    assert res["correct"], res["checks"]


def test_serving_controls_fail_their_limits(monkeypatch):
    from harness import manifest
    from tools import limits

    load = manifest.load_cell
    monkeypatch.setattr(manifest, "load_cell", lambda name, root: tiny.shrink(load(name, root)))
    row = limits.readings(2 ** 31 + 3, torch.device("cpu"), tiny.ROOT)
    for cell in (limits.INT8, limits.BF16):
        got = checks.compare(cell, row[cell]["control"])
        assert not checks.met(got), (cell, got)


def test_training_control_fails_its_limits(monkeypatch):
    from harness import manifest
    from tools import train_limits

    load = manifest.load_cell
    monkeypatch.setattr(manifest, "load_cell", lambda name, root: tiny.shrink(load(name, root)))
    row = train_limits.readings("train-512-b16", 2 ** 31 + 3, torch.device("cpu"), tiny.ROOT)
    for side in ("control_fp8", "half_batch", "unchanged_state"):
        got = checks.compare("train-512-b16", row[side])
        assert not checks.met(got), (side, got)
    assert checks.met(checks.compare("train-512-b16", row["program"]))
