"""The span table of ``harness/spans.py`` on synthetic traces."""

import pytest

from harness import spans, trace


def ev(name, cat, ts, dur, tid=1, **args):
    return dict(ph="X", name=name, cat=cat, ts=ts, dur=dur, pid=1, tid=tid, args=args)


def launch(ts, dur, corr, tid=1, name="cudaLaunchKernel", cat="cuda_runtime"):
    return ev(name, cat, ts, dur, tid=tid, correlation=corr)


def kernel(ts, dur, corr, name="void k()", cat="kernel"):
    return ev(name, cat, ts, dur, tid=7, correlation=corr)


def train_doc():
    # a window of 100 us and one step. The backward's kernel is issued from
    # the autograd thread (tid 2) while the main thread waits in
    # train.backward; the optimizer's launch call spins 8 us in a full queue
    return {"traceEvents": [
        ev(trace.STRETCH, "user_annotation", 0, 100),
        ev("bench.item", "user_annotation", 0, 100),
        ev("train.step#7", "user_annotation", 10, 80),
        ev("train.forward", "user_annotation", 12, 18),
        ev("train.backward", "user_annotation", 30, 30),
        ev("train.optimizer", "user_annotation", 60, 20),
        launch(14, 2, 1),
        kernel(16, 20, 1, "void bn_apply_kernel()"),
        launch(35, 2, 2, tid=2, name="cuLaunchKernel", cat="cuda_driver"),
        kernel(40, 10, 2),
        launch(62, 2, 3),
        kernel(65, 5, 3),
        launch(70, 8, 4),
        kernel(78, 4, 4),
        kernel(92, 3, None),  # no issuing call in the trace
    ]}


def serve_doc():
    # an idle stretch from 5 to 30 us crosses the gap between slides and the
    # upload, which starts with its image (of two spans that start together
    # the shorter is the inner)
    return {"traceEvents": [
        ev(trace.STRETCH, "user_annotation", 0, 100),
        ev("bench.item", "user_annotation", 10, 85),
        ev("tiled.image#3", "user_annotation", 10, 85),
        ev("tiled.upload", "user_annotation", 10, 28),
        launch(-4, 2, 1),
        kernel(0, 5, 1, "Memcpy DtoH (Device -> Pageable)", "gpu_memcpy"),
        ev("cudaMemcpyAsync", "cuda_runtime", 12, 26, correlation=2),
        kernel(30, 8, 2, "Memcpy HtoD (Pageable -> Device)", "gpu_memcpy"),
        # idle from 38 to 40 us under the image alone
        ev("tiled.predict", "user_annotation", 40, 20),
        launch(41, 2, 3),
        kernel(42, 30, 3),
        ev("tiled.predict", "user_annotation", 60, 10),
        launch(61, 2, 4),
        kernel(65, 20, 4),  # overlaps the last from 65 to 72
        ev("tiled.download", "user_annotation", 80, 15),
        launch(81, 1, 5),
        kernel(85, 5, 5, "Memcpy DtoH (Device -> Pageable)", "gpu_memcpy"),
    ]}


def table(doc):
    return spans.reduce(doc, items=1)["by_span"]


def test_a_kernel_from_another_thread_goes_to_the_main_threads_backward():
    rows = table(train_doc())
    assert rows["train.backward"]["device_s"] == pytest.approx(10e-6)
    assert rows["train.backward"]["launches"] == 1
    assert rows["train.forward"]["device_s"] == pytest.approx(20e-6)
    assert rows["train.optimizer"]["device_s"] == pytest.approx(9e-6)
    assert rows[spans.OUTSIDE]["device_s"] == pytest.approx(3e-6)


def test_host_time_leaves_out_runtime_and_driver_calls():
    rows = table(train_doc())
    assert rows["train.optimizer"]["wall_s"] == pytest.approx(20e-6)
    assert rows["train.optimizer"]["host_s"] == pytest.approx(10e-6)  # less 2 and the 8 us spin
    # the step: 80 us less the four calls inside it, the autograd thread's too
    assert rows["train.step"]["host_s"] == pytest.approx(66e-6)
    assert rows["train.step"]["count"] == 1


def test_an_idle_interval_is_split_exactly_at_span_edges():
    rows = table(serve_doc())
    assert rows[spans.OUTSIDE]["idle_s"] == pytest.approx(5e-6 + 5e-6)  # 5-10 and 95-100
    assert rows["tiled.upload"]["idle_s"] == pytest.approx(20e-6)  # 10-30
    assert rows["tiled.predict"]["idle_s"] == pytest.approx(2e-6)  # 40-42
    assert rows["tiled.image"]["idle_s"] == pytest.approx(2e-6)  # 38-40
    assert rows["tiled.download"]["idle_s"] == pytest.approx(5e-6)  # 90-95
    assert rows["tiled.predict"]["count"] == 2
    assert rows["tiled.predict"]["wall_s"] == pytest.approx(30e-6)


def test_the_request_number_is_stripped():
    assert spans.span_name("train.step#12") == "train.step"
    assert spans.span_name("tiled.image#0") == "tiled.image"
    assert spans.span_name("halo_exchange:gloo") == "halo_exchange:gloo"
    rows = table(serve_doc())
    assert "tiled.image" in rows and not any("#" in name for name in rows)


@pytest.mark.parametrize("make", [train_doc, serve_doc])
def test_the_rows_add_up_to_busy_and_idle(make):
    out = spans.reduce(make(), items=1)
    base = trace.summarize(make(), items=1)
    rows = out["by_span"].values()
    assert out["busy_s"] == pytest.approx(base["busy_s"])
    assert sum(r["device_s"] for r in rows) == pytest.approx(base["busy_s"])
    assert sum(r["idle_s"] for r in rows) == pytest.approx(base["window_s"] - base["busy_s"])
    assert sum(r["launches"] for r in rows) == base["launches"]


def test_overlapping_streams_count_once():
    rows = table(serve_doc())
    # the second predict's kernel runs 65-85, the first's until 72
    assert rows["tiled.predict"]["device_s"] == pytest.approx(30e-6 + 13e-6)


@pytest.mark.parametrize("name,doc,value", [
    ("tiled.upload_idle_ms", serve_doc, 20e-3),
    ("serve.outside_idle_ms", serve_doc, 10e-3),
    ("tiled.predict_host_ms", serve_doc, 15e-3),
    ("train.optimizer_ms", train_doc, 9e-3),
    ("train.host_ms", train_doc, 66e-3),
])
def test_each_reading_reads_its_span_and_nothing_without_it(name, doc, value):
    assert spans.reading(name, spans.reduce(doc(), items=1)) == pytest.approx(value)
    other = train_doc if doc is serve_doc else serve_doc
    assert spans.reading(name, spans.reduce(other(), items=1)) is None
    bare = spans.without_program_spans(doc())
    assert spans.reading(name, spans.reduce(bare, items=1)) is None
    assert spans.reading(name, None) is None


def test_the_per_item_readings_divide_by_items():
    assert spans.reading("tiled.upload_idle_ms",
                         spans.reduce(serve_doc(), items=4)) == pytest.approx(5e-3)


@pytest.mark.parametrize("make", [train_doc, serve_doc])
def test_summarize_keeps_every_key_of_the_trace_summary(make):
    bare = spans.without_program_spans(make())
    assert not any(spans.is_program_span(e) for e in bare["traceEvents"])
    got = spans.summarize(make(), items=1)
    assert got.pop("spans") == spans.reduce(make(), items=1)
    assert got == trace.summarize(bare, items=1)


def test_summarize_keeps_the_idle_gaps_labels():
    # left in, the program's spans would label the idle gap from 90 to 100 us
    # (the innermost host range at its midpoint) as no trace without them does
    assert dict(trace.summarize(serve_doc(), 1)["idle_gaps"]).get("tiled.download")
    gaps = dict(spans.summarize(serve_doc(), 1)["idle_gaps"])
    assert gaps == pytest.approx({"cudaMemcpyAsync": 25e-6, "bench.item": 14e-6})


def test_a_trace_without_the_stretch_is_refused():
    with pytest.raises(RuntimeError):
        spans.reduce({"traceEvents": [kernel(0, 1, 1)]}, items=1)
