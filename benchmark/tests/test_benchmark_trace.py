"""The trace reduction of ``harness/trace.py`` on a synthetic trace."""

import pytest

from harness import trace


def ev(name, cat, ts, dur, **kw):
    return dict(ph="X", name=name, cat=cat, ts=ts, dur=dur, **kw)


def doc():
    # a window of 100 us: two streams overlap on [20, 30], a copy, a gap of
    # 40 us while the host sits in cudaMemcpyAsync, and a lead-in spin outside
    return {"traceEvents": [
        ev("spin_kernel", "kernel", -50, 10),
        ev(trace.STRETCH, "user_annotation", 0, 100),
        ev("bench.item", "user_annotation", 0, 100),
        ev("cudaMemcpyAsync", "cuda_runtime", 45, 40),
        ev("void (anonymous namespace)::int8_conv_wgmma_kernel<0, 128, false>", "kernel", 0, 30),
        ev("ncclDevKernel_AllReduce_Sum_f32", "kernel", 20, 20),
        ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 90, 5),
        ev("outside", "kernel", 120, 50),
    ]}


def test_union_counts_overlap_once():
    total, merged = trace.union_us([(0, 30), (20, 40), (90, 95)])
    assert total == 45
    assert merged == [(0, 40), (90, 95)]


def test_summarize_busy_idle_groups_and_gaps():
    s = trace.summarize(doc(), items=1)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx(45e-6)  # 0-40 and 90-95, the overlap once
    assert s["idle_pct"] == pytest.approx(55.0)
    assert s["by_group_s"]["K3 int8_conv"] == pytest.approx(30e-6)
    assert s["by_group_s"]["NCCL"] == pytest.approx(20e-6)
    assert s["h2d_s"] == pytest.approx(5e-6)
    assert s["launches"] == 2  # the spin and the kernel outside the window left out
    gaps = dict(s["idle_gaps"])
    assert gaps["cudaMemcpyAsync"] == pytest.approx(50e-6)  # 40-90: the copy call is innermost
    assert gaps["bench.item"] == pytest.approx(5e-6)  # 95-100
    assert s["device_ops"][0][0].startswith("void (anonymous namespace)::int8_conv")


def test_a_trace_without_the_stretch_is_refused():
    with pytest.raises(RuntimeError):
        trace.summarize({"traceEvents": [ev("k", "kernel", 0, 1)]}, items=1)


@pytest.mark.parametrize("name,group", [
    ("void (anonymous namespace)::bn_apply_kernel<__nv_bfloat16, 8, 1, false>", "K4 batchnorm"),
    ("void (anonymous namespace)::head_mma_kernel<true, 1, true>", "K2 head_argmax"),
    ("void (anonymous namespace)::dense_head_mma_kernel<1>", "K6 dense_head_argmax"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32", "cuDNN / GEMM"),
    ("Memcpy DtoH (Device -> Pageable)", "copies and casts"),
    ("something_else", "other"),
])
def test_kernel_groups(name, group):
    assert trace.kernel_group(name) == group
