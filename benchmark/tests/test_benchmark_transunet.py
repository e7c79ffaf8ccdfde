"""TransUNet's training cell (``transunet-train-512-b16``) on the CPU: the
cell end to end at a tiny size of its own (``tiny.shrink`` knows the
U-Net's keys only), its faults and control against its limits, the work
count against a hand count, and the driver's and readers' trace handling on
a made-up trace."""

import pytest
import torch

import tiny
from drivers import train_steps_transunet as driver
from harness import checks, manifest
from test_benchmark_cells_cpu import result_keys_ok
from work import transunet as work

CELL = "transunet-train-512-b16"


def shrink(c: manifest.Cell) -> manifest.Cell:
    """Width 32, one unit a block, hidden 64, 2 layers of 4 heads, MLP 128,
    64^2 tiles; a pool of 8 pairs in batches of 4."""
    c.config.update(img_size=64, hidden_size=64)
    c.config["resnet"] = {"num_layers": [1, 1, 1], "width_factor": 0.5}
    c.config["transformer"] = dict(c.config["transformer"], num_layers=2, num_heads=4,
                                   mlp_dim=128)
    c.traffic.update(size=64, pool=8, batch=4, warm_steps=1)
    return c


def cell() -> manifest.Cell:
    return shrink(manifest.load_cell(CELL, tiny.ROOT))


def test_the_cell_runs_end_to_end_and_is_correct_at_a_tiny_size():
    c = cell()
    res = tiny.run(c)
    result_keys_ok(res, c)
    assert res["correct"], res["checks"]
    assert set(res["checks"]) == {"grad_dev_decoder", "change_gap", "loss_gap"}


def test_a_step_that_returns_its_state_unchanged_is_not_correct(monkeypatch):
    from tools import train_limits

    build = driver.build_step

    def broken(cfg, traffic, *a, **k):
        state, step = build(cfg, traffic, *a, **k)
        return state, train_limits.FAULTS["unchanged_state"](step, traffic["batch"])

    monkeypatch.setattr(driver, "build_step", broken)
    res = tiny.run(cell())
    assert not res["correct"], res["checks"]
    assert res["checks"]["change_gap"]["value"] > res["checks"]["change_gap"]["limit"]


def test_the_control_and_the_faults_fail_the_limits(monkeypatch):
    from tools import train_limits_transunet

    load = manifest.load_cell
    monkeypatch.setattr(manifest, "load_cell", lambda name, root: shrink(load(name, root)))
    row = train_limits_transunet.readings(CELL, 2 ** 31 + 3, torch.device("cpu"), tiny.ROOT)
    for side in ("control_fp8", "half_batch", "unchanged_state"):
        assert not checks.met(checks.compare(CELL, row[side])), side
    assert checks.met(checks.compare(CELL, row["program"]))


def _cfg():
    return manifest.load_cell(CELL, tiny.ROOT).config


def test_work_matches_a_hand_count():
    """One 512^2 image's forward, by part, multiply-adds worked out by hand
    (``work/transunet.py``'s conventions: the root conv on the one input
    channel, attention's QK^T and PV over all heads)."""
    parts = work.forward_macs_by_part(_cfg())
    s1, s2, s3 = 127, 64, 32
    resnet = 256 ** 2 * 49 * 64
    for side_in, side, cin, cmid, cout, units in ((s1, s1, 64, 64, 256, 3),
                                                  (s1, s2, 256, 128, 512, 4),
                                                  (s2, s3, 512, 256, 1024, 9)):
        resnet += (side_in ** 2 * cin * cmid + side ** 2 * 9 * cmid * cmid
                   + side ** 2 * cmid * cout + side ** 2 * cin * cout)
        resnet += (units - 1) * (side ** 2 * cout * cmid + side ** 2 * 9 * cmid * cmid
                                 + side ** 2 * cmid * cout)
    assert parts == {"resnet": resnet, "patch": 1024 * 1024 * 768,
                     "decoder": 40_542_142_464, "vit_linear": 86_973_087_744,
                     "attention": 19_327_352_832}
    assert work.forward_ops(_cfg()) == 2 * sum(parts.values())
    assert work.attention_train_ops(_cfg()) == 6 * 19_327_352_832
    # nine layers, four kernels: 8 activations' bytes in bf16, 24 B a channel each
    assert work.k4_train_bytes(_cfg(), 16) == 16 * 2 * 8 * 23_592_960 + 4 * 24 * 1440


def _doc():
    """A made-up trace of one item: the stretch, the model's spans, a flash
    kernel and a K4 kernel issued inside ``model.vit`` and
    ``model.decoder``."""
    def span(name, ts, dur):
        return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur,
                "pid": 1, "tid": 1}

    def runtime(ts, corr):
        return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts,
                "dur": 1, "pid": 1, "tid": 1, "args": {"correlation": corr}}

    def kernel(name, ts, dur, corr):
        return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur, "pid": 0,
                "tid": 7, "args": {"correlation": corr}}

    return {"traceEvents": [
        span("bench.stretch", 0, 1000), span("train.step#1", 10, 900),
        span("model.resnet", 20, 100), span("model.vit", 130, 300),
        span("model.decoder", 440, 100),
        runtime(140, 1), kernel("void pytorch_flash::flash_fwd_kernel<...>", 150, 200, 1),
        runtime(450, 2), kernel("void bn_apply_kernel<__nv_bfloat16, 8>", 460, 40, 2)]}


def _trace_metrics():
    """The cell's own metrics that read the traced stretch."""
    return [m for m in manifest.load_cell(CELL, tiny.ROOT).per_layer
            if m["workloads"] == [CELL] and m["source"] != "host_clock"]


def test_the_driver_reads_the_model_spans_and_its_kernel_groups():
    from harness import spans

    doc = driver.with_model_spans(_doc())
    assert driver.group_times(doc) == {"attention": 200e-6}
    table = spans.summarize(doc, 1)
    assert table["spans"]["by_span"]["train.model.vit"]["device_s"] == pytest.approx(200e-6)
    assert table["spans"]["by_span"]["train.model.decoder"]["device_s"] == pytest.approx(40e-6)
    ctx = {"kind": "train", "model": "transunet_r50_b16", "config": _cfg(),
           "images_per_step": 16, "trace": dict(table, group_s=driver.group_times(doc))}
    got = manifest.read_metrics(_trace_metrics(), ctx)
    assert got["transunet.vit_fwd_ms"]["value"] == pytest.approx(0.2)
    assert got["transunet.resnet_fwd_ms"]["value"] == 0.0  # no kernel under model.resnet
    ops = work.attention_train_ops(_cfg()) * 16
    assert got["transunet.attn_roofline"]["value"] == pytest.approx(100 * ops / 989e12 / 200e-6)
    assert got["k4_roofline.transunet"]["value"] == pytest.approx(
        100 * work.k4_train_bytes(_cfg(), 16) / 3.35e12 / 40e-6)
    # a trace without the model's spans or kernels reads nothing
    bare = {"kind": "train", "model": "transunet_r50_b16", "config": _cfg(),
            "images_per_step": 16, "trace": dict(spans.summarize(_doc(), 1), group_s={})}
    got = manifest.read_metrics(_trace_metrics(), bare)
    assert "transunet.vit_fwd_ms" not in got and "transunet.attn_roofline" not in got
