"""The program's profiler spans (``tpuseg_torch/utils/profiling.py``): off
they cost a flag test and never reach ``torch.profiler``; on, a tiled
image and a raw train step each give the tree of spans that the
benchmark's span table (``benchmark/harness/spans.py``) splits the card's
time by."""

import contextlib
import json
import os
import re

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tpuseg_torch.aug.device import DeviceAugmentParams
from tpuseg_torch.infer.tiled import _plan, _zor_placements, inference_tiled, make_predict_fn
from tpuseg_torch.models.unet import UNet, init_unet
from tpuseg_torch.train.steps import create_train_state, make_raw_steps
from tpuseg_torch.utils import profiling

PREFIXES = ("tiled.", "train.")
TILE, RADIUS, BATCH = 48, 16, 3


def _spans(doc):
    """The program's spans of a Chrome trace, as ``(name, start, end)``
    sorted by start, outer first."""
    out = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in doc["traceEvents"]
           if e.get("ph") == "X" and e.get("cat") == "user_annotation"
           and e["name"].startswith(PREFIXES)]
    return sorted(out, key=lambda s: (s[1], -s[2]))


def _children(spans, parent):
    """The spans directly inside ``parent``, in order."""
    inside = [s for s in spans if s is not parent and parent[1] <= s[1] and s[2] <= parent[2]]
    return [s[0] for s in inside
            if not any(o is not s and o[1] <= s[1] and s[2] <= o[2] for o in inside)]


def _profile(fn, on):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.spans() if on else contextlib.nullcontext():
            fn()
    return prof


def _profiled(tmp_path, fn, on=True):
    prof = _profile(fn, on)
    path = os.path.join(str(tmp_path), "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        return _spans(json.load(f))


def _tiled():
    model = init_unet(UNet(2, 1, 2, torch.float32), torch.Generator().manual_seed(0)).eval()
    predict = make_predict_fn(model)
    calls = []

    def counted(x):
        calls.append(x.shape[0])
        return predict(x)

    img = np.random.default_rng(0).integers(0, 60000, (80, 80), dtype=np.uint16)
    stats = (np.float32([30000.0]), np.float32([17000.0]))

    def run():
        mask = inference_tiled(img, counted, TILE, RADIUS, BATCH, 2, stats, "cpu")
        assert mask.shape == img.shape

    return run, calls


def _train_step():
    state = create_train_state(UNet(2, 1, 2, "float32"), 0, 1e-3, "cpu")
    state.step = 5
    step, _ = make_raw_steps(2, DeviceAugmentParams())
    gen = torch.Generator().manual_seed(1)
    images = torch.randint(0, 60000, (2, 32, 32, 1), generator=gen).to(torch.int32)
    masks = torch.randint(0, 2, (2, 32, 32), generator=gen).to(torch.uint8)
    return lambda: step(state, images, masks)


def test_span_off_is_the_shared_null_context(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("reached torch.profiler with spans off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    first, second = profiling.span("tiled.upload"), profiling.span("train.step", 3)
    assert first is second
    with first:
        pass
    with profiling.spans():
        with pytest.raises(AssertionError, match="spans off"):
            profiling.span("tiled.upload")
        with profiling.spans():  # regions nest
            pass
        with pytest.raises(AssertionError, match="spans off"):
            profiling.span("tiled.upload")
    assert profiling.span("tiled.upload") is first


def test_a_tiled_image_gives_its_tree(tmp_path):
    run, calls = _tiled()
    spans = _profiled(tmp_path, run)
    roots = [s for s in spans if s[0].startswith("tiled.image")]
    assert len(roots) == 1 and re.fullmatch(r"tiled\.image#\d+", roots[0][0])
    n_tiles = len(_zor_placements(80, 80, TILE - 2 * RADIUS, TILE, RADIUS, 80, 80))
    assert calls == [min(BATCH, n_tiles - s) for s in range(0, n_tiles, BATCH)]
    # the banded pass: a call's bands go up and are z-scored before it; once
    # it is queued the next call's bands are staged and sent, it is
    # stitched, its finished rows are sent down, and earlier rows land
    # while it runs
    up, zs, stitch, down, land = ("tiled.upload", "tiled.zscore", "tiled.stitch",
                                  "tiled.download", "tiled.land")
    call = ["tiled.windows", "tiled.predict"]
    children = _children(spans, roots[0])
    assert children == (["tiled.prepare", up, zs] + call + [stitch]
                        + call + [stitch, down]
                        + call + [up, stitch, land]
                        + [zs] + call + [stitch, down]
                        + call + [up, stitch, down, land]
                        + [zs] + call + [stitch, land]
                        + call + [stitch, down]
                        + call + [stitch, land]
                        + call + [stitch, down, land])
    plan = _plan(_zor_placements(80, 80, TILE - 2 * RADIUS, TILE, RADIUS, 80, 80), TILE,
                 BATCH, 80)
    predicts = [k for k, name in enumerate(children) if name == "tiled.predict"]
    assert len(predicts) == len(plan.calls) == len(calls)
    for c, k in enumerate(predicts):  # every band a call reads is up and z-scored before it
        assert children[:k].count(up) >= plan.needs[c] and children[:k].count(zs) >= plan.needs[c]
    assert children.count(up) == children.count(zs) == len(plan.bands)
    assert all(roots[0][1] <= s[1] and s[2] <= roots[0][2] for s in spans)


def test_each_tiled_image_has_its_number(tmp_path):
    run, _ = _tiled()
    spans = _profiled(tmp_path, lambda: (run(), run()))
    first, second = (int(s[0].split("#")[1]) for s in spans if s[0].startswith("tiled.image"))
    assert second == first + 1


def test_a_raw_train_step_gives_its_tree(tmp_path):
    spans = _profiled(tmp_path, _train_step())
    roots = [s for s in spans if s[0].startswith("train.step")]
    assert [r[0] for r in roots] == ["train.step#5"]
    assert _children(spans, roots[0]) == ["train.augment", "train.forward", "train.loss",
                                          "train.backward", "train.optimizer",
                                          "train.metrics"]


def test_without_spans_the_profile_holds_none(tmp_path):
    run, _ = _tiled()
    step = _train_step()
    assert _profiled(tmp_path, lambda: (run(), step()), on=False) == []


def test_a_trace_region_carries_the_spans(tmp_path):
    run, _ = _tiled()
    logdir = str(tmp_path / "profile")
    with profiling.trace(logdir, "cpu") as prof:
        run()
        prof.step()
    assert profiling.span("tiled.upload") is profiling.span("tiled.stitch")  # off again
    (name,) = os.listdir(logdir)
    with open(os.path.join(logdir, name)) as f:
        names = [s[0] for s in _spans(json.load(f))]
    assert names[0].startswith("tiled.image#") and "tiled.upload" in names


def test_the_halo_ranges_are_spans(tmp_path):
    import torch.distributed as dist

    from tpuseg_torch.parallel.halo import Halo

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        halo = Halo(dist.group.WORLD, "cpu")
        x = torch.ones(1, 2, 4, 3)

        def run():
            halo.reduce_rows(halo.all_gather_rows(x).permute(0, 3, 1, 2))

        names = {e.key for e in _profile(run, on=True).key_averages()}
        assert {"row_gather:gloo", "row_gather_backward:gloo"} <= names
        assert not any(n.startswith("row_gather") for n in
                       (e.key for e in _profile(run, on=False).key_averages()))
    finally:
        dist.destroy_process_group()

