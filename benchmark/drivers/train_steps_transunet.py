"""Steady raw train steps of the program's TransUNet, from a pool on the device.

``drivers/train_steps.py`` with the configuration's TransUNet in its
U-Net's place: set-up makes the weights (``harness/transunet_weights.py``)
and the pool of image and mask pairs from the seed, builds one train state
of the program (``tpuseg_torch.models.transunet.TransUNet`` in the
configuration's dtype loaded with the weights, ``KerasAdam``, and its two
generators on the device, seeded from the seed) and the program's raw step
(``tpuseg_torch.train.steps.make_raw_steps``), reads its first
``checked_steps`` steps as ``train_steps.readings`` does, steps
``warm_steps`` more, then steps the same state for ``seconds``, batch after
batch of the pool in turn, and ends in a synchronize. The program's module
is imported when this driver is, before any work on the card, so that a
checkout without it fails at once.

The traced stretch runs under the profiler with the program's spans on
(``profiling.spans()``) and its counters reset: the trace is summarized as
``harness/spans.py::summarize`` does, with the model's spans
(``model.resnet``, ``model.vit``, ``model.decoder``) renamed into the
program's ``train.`` prefix, plus this driver's own kernel groups
(:data:`GROUPS`: SDPA's flash kernels, which the frozen table counts as
"cuDNN / GEMM"); the counters of the stretch (K4's launches and its order
after, attention and GroupNorm calls) go into the result's ``notes``.

Once the window has closed and the program's state is freed, the plain
reference (``reference/train_transunet.py``) trains from the same weights
on the same batches with generators seeded alike, in float32 and, as the
yardstick, in the configuration's precision, and the program is compared
with both (``reference/train_transunet.py::compare``).
"""

from __future__ import annotations

import gc
import json
import os
import time
from collections import defaultdict
from typing import Dict

import torch

# first: a checkout without the program's TransUNet fails here, at once
import tpuseg_torch.models.transunet as program_model
from drivers.train_steps import batch, readings
from harness import checks as checks_lib
from harness import spans as spans_lib
from harness import trace as trace_lib
from harness import transunet_weights
from harness.common import child_seeds, make_pool, sync
from reference import train as ref_train
from reference import train_transunet as ref_transunet
from work import transunet as work

# this driver's own kernel groups, by name fragment
GROUPS = {"attention": ("flash",)}
MODEL_SPAN = "model."


def build_step(cfg: dict, traffic: dict, weights: Dict[str, torch.Tensor], seeds, device):
    """The program's train state and raw step for the configuration."""
    from tpuseg_torch.aug.device import DeviceAugmentParams
    from tpuseg_torch.train.steps import KerasAdam, TrainState, make_raw_steps

    train = cfg["train"]
    if device.type == "cuda":
        from tpuseg_torch.kernels import build

        build.build(train["kernels"])
    with torch.device(device):
        model = program_model.TransUNet(**work.widths(cfg), dtype=train["dtype"])
    missing, unexpected = model.load_state_dict(weights, strict=False)
    if unexpected or any(not k.endswith("num_batches_tracked") for k in missing):
        raise RuntimeError(f"weights do not fit the model: missing {missing}, "
                           f"unexpected {unexpected}")
    aug_seed, drop_seed = seeds
    state = TrainState(model=model,
                       optimizer=KerasAdam(model.parameters(), lr=train["learning_rate"]),
                       aug_generator=torch.Generator(device=device).manual_seed(aug_seed),
                       dropout_generator=torch.Generator(device=device).manual_seed(drop_seed))
    step, _ = make_raw_steps(cfg["num_classes"], DeviceAugmentParams(**traffic["augment"]),
                             augment=train["augment"])
    return state, step


def with_model_spans(doc: dict) -> dict:
    """``doc`` with each ``model.*`` span renamed ``train.model.*``, so that
    ``harness/spans.py`` takes it as one of the program's spans."""
    events = []
    for e in doc.get("traceEvents", []):
        if (e.get("ph") == "X" and e.get("cat") == "user_annotation"
                and e.get("name", "").startswith(MODEL_SPAN)):
            e = dict(e, name="train." + e["name"])
        events.append(e)
    return {**doc, "traceEvents": events}


def group_times(doc: dict) -> Dict[str, float]:
    """Device time of :data:`GROUPS`' kernels inside the stretch, s."""
    events = [e for e in doc.get("traceEvents", []) if e.get("ph") == "X"]
    stretch = [e for e in events if e.get("cat") == "user_annotation"
               and e["name"] == trace_lib.STRETCH]
    lo = stretch[0]["ts"]
    hi = lo + stretch[0]["dur"]
    out: Dict[str, float] = defaultdict(float)
    for e in events:
        if e.get("cat") != "kernel":
            continue
        a, b = max(e["ts"], lo), min(e["ts"] + e["dur"], hi)
        for group, keys in GROUPS.items():
            if b > a and any(k in e["name"] for k in keys):
                out[group] += (b - a) / 1e6
    return dict(out)


def counters() -> Dict:
    from tpuseg_torch.ops import batchnorm

    return {"k4_launches": dict(batchnorm.LAUNCHES), "k4_after": dict(batchnorm.AFTER),
            "model": dict(program_model.COUNTS)}


def reset_counters() -> None:
    from tpuseg_torch.ops import batchnorm

    batchnorm.reset_counts()
    program_model.reset_counts()


def profile_stretch(step, items: int, tmpdir: str, lead_in: int = trace_lib.LEAD_IN) -> Dict:
    """``harness/trace.py::profile_stretch`` with the program's spans on and
    its counters reset: the summary of ``harness/spans.py`` with the model's
    spans, ``group_s`` of :func:`group_times` and ``counters``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from tpuseg_torch.utils import profiling

    torch.cuda.synchronize()
    reset_counters()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(lead_in):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profiling.spans(), record_function(trace_lib.STRETCH):
            for _ in range(items):
                with record_function("bench.item"):
                    step()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counted = counters()
    path = os.path.join(tmpdir, f"bench-trace-{os.getpid()}.json")
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            doc = with_model_spans(json.load(f))
    finally:
        if os.path.exists(path):
            os.remove(path)
    out = spans_lib.summarize(doc, items)
    out["wall_s"] = wall
    out["group_s"] = group_times(doc)
    out["counters"] = counted
    return out


def run(cell, seed: int, seconds: float, trace: bool, device, process_start: float,
        tmpdir: str) -> dict:
    cfg, traffic = cell.config, cell.traffic
    started = time.perf_counter() - process_start
    phases, t = {"process_start": started}, time.perf_counter()

    def done(name):
        nonlocal t
        sync(device)
        phases[name] = time.perf_counter() - t
        t = time.perf_counter()

    s_weights, s_pool, s_aug, s_drop = child_seeds(seed, 4)
    weights = transunet_weights.make(cfg, s_weights, device)
    done("weights")
    pool = make_pool(traffic, s_pool, device)
    done("pool")
    state, step = build_step(cfg, traffic, weights, (s_aug, s_drop), device)
    done("train_state")
    got = readings(state, step, pool, traffic, weights)
    for i in range(traffic["warm_steps"]):
        step(state, *batch(pool, traffic["checked_steps"] + i, traffic["batch"]))
    done("first_steps")
    setup_peak = 0
    if device.type == "cuda":
        setup_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    n = traffic["checked_steps"] + traffic["warm_steps"]
    first = n
    summary, stretch = None, (0, 0.0, 0.0)
    sync(device)
    t_start, c_start = time.perf_counter(), time.process_time()
    setup_s = t_start - process_start
    deadline = t_start + seconds

    def one():
        nonlocal n
        step(state, *batch(pool, n, traffic["batch"]))
        n += 1

    while time.perf_counter() < deadline:
        if trace and summary is None and time.perf_counter() >= t_start + seconds / 2:
            n0, t0, c0 = n, time.perf_counter(), time.process_time()
            summary = profile_stretch(one, traffic["trace_items"], tmpdir)
            stretch = (n - n0, time.perf_counter() - t0, time.process_time() - c0)
            continue
        one()
    sync(device)
    t_end, c_end = time.perf_counter(), time.process_time()
    window = t_end - t_start
    steps = n - first
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    del state, step
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    common = ([batch(pool, i, traffic["batch"]) for i in range(traffic["checked_steps"])],
              s_aug, s_drop, cfg["train"]["learning_rate"], traffic["augment"],
              cfg["num_classes"], cfg, device)
    ref = ref_transunet.run_steps(weights, *common)
    stick = ref_transunet.run_steps(weights, *common, dtype=ref_train.DTYPES[
        checks_lib.spec(cell.name)["yardstick"]["dtype"]])
    numbers = ref_transunet.compare(got, ref, stick)
    worst = numbers.pop("worst_leaf")
    checks = checks_lib.compare(cell.name, numbers)
    outside = steps - stretch[0]
    ctx = {"kind": "train", "model": cfg["model"], "config": cfg, "traffic": traffic,
           "trace": summary,
           "window": {"items": steps, "seconds": window, "items_outside": outside,
                      "seconds_outside": window - stretch[1],
                      "cpu_outside": (c_end - c_start) - stretch[2]},
           "images_per_step": traffic["batch"], "peak_window_bytes": peak}
    notes = {"setup_phases": phases, "losses": got["losses"],
             "reference_losses": ref["losses"], "worst_leaf": worst,
             "uncompared": {k: v for k, v in numbers.items() if k not in checks}}
    if summary is not None:
        notes["counters"] = dict(summary["counters"], steps=stretch[0],
                                 launches=summary["launches"])
    return {"end_to_end": {"train_img_s": steps * traffic["batch"] / window,
                           "setup_s": setup_s},
            "ctx": ctx, "trace": summary, "checks": checks, "attempted": steps, "failed": 0,
            "memory_peak_bytes": max(peak, setup_peak), "notes": notes}
