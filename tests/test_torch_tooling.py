"""The port's training tooling on the CPU: the profiled window
(``cli.train --profile_steps``, utils/profiling.py), the trace analysis
(utils/trace_analysis.py) and the TensorBoard event files
(utils/tb_events.py), against tpuseg's trainer where it has an output to
compare.

- a profiled CPU run writes a Chrome trace under ``<output>/profile`` with
  one ``ProfilerStep#N`` span per profiled step, and ``analyze`` reports it
  as a trace without device events;
- ``analyze`` on a synthetic card trace groups, sums and counts kernels,
  counts steps and takes the busy share over the steps' window;
- the run's event files read back through the ``tensorboard`` package's
  ``EventAccumulator`` with the run's own losses (float32), and hold the
  tags and steps of tpuseg's tensorboardX files for the same config.
"""

import contextlib
import glob
import json
import os

import numpy as np
import pytest
import torch

from tpuseg_torch.cli.train import main as train_main
from tpuseg_torch.utils import tb_events, trace_analysis

from test_torch_trainer import write_db
from torch_threads import one_cpu_thread  # noqa: F401 (autouse)

ARGS = ["--batch_size", "2", "--test_every_n_steps", "3", "--max_epochs", "2",
        "--early_stopping", "10", "--log_every_n_steps", "2", "--seed", "3"]


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    root = tmp_path_factory.mktemp("dbs")
    train, test = str(root / "train.lmdb"), str(root / "test.lmdb")
    write_db(train, 8, 32, 0)
    write_db(test, 4, 32, 1)
    return train, test


@pytest.fixture(scope="module")
def profiled_run(dbs, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("run") / "out")
    res = train_main(["--train_database", dbs[0], "--test_database", dbs[1],
                      "--output_dir", out, "--device", "cpu", "--base_features", "4",
                      "--profile_steps", "2", *ARGS])
    return out, res


def test_profile_steps_writes_a_cpu_trace(profiled_run, capsys):
    out, res = profiled_run
    assert res.epochs_run == 2 and res.steps == 8
    trace = trace_analysis.find_trace(os.path.join(out, "profile"))
    assert trace and trace.endswith(".pt.trace.json")
    r = trace_analysis.analyze(os.path.join(out, "profile"))
    assert r["device_plane"] is None and "no CUDA kernel events" in r["note"]
    assert r["steps"] == 2 and r["total_ms"] == 0.0 and r["groups"] == {}
    assert len(r["step_wall_ms"]) == 2 and min(r["step_wall_ms"]) > 0
    trace_analysis.main([os.path.join(out, "profile")])
    assert "no CUDA kernel events" in capsys.readouterr().out
    with open(trace) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"ProfilerStep#0", "ProfilerStep#1"} <= names and "ProfilerStep#2" not in names


def test_profile_window_closes_at_epoch_end(dbs, tmp_path):
    """A window longer than epoch 1 closes with the epoch: 4 steps traced."""
    out = str(tmp_path / "out")
    res = train_main(["--train_database", dbs[0], "--test_database", dbs[1],
                      "--output_dir", out, "--device", "cpu", "--base_features", "4",
                      "--profile_steps", "99", *ARGS])
    assert res.epochs_run == 2
    assert trace_analysis.analyze(os.path.join(out, "profile"))["steps"] == 4


def _synthetic_trace(folder):
    """Two steps: step 0 [0, 100) µs, step 1 [100, 220) µs; device events
    on two streams, one of them overlapping, one outside the steps."""
    def ev(name, cat, ts, dur, tid=7):
        return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 0, "tid": tid}

    events = [
        ev("ProfilerStep#0", "user_annotation", 0, 100, 1),
        ev("ProfilerStep#1", "user_annotation", 100, 120, 1),
        ev("ProfilerStep#0", "gpu_user_annotation", 5, 90),  # the device copy of a step
        ev("aten::conv2d", "cpu_op", 2, 50, 1),
        ev("shear_rows_kernel", "kernel", 10, 4),
        ev("shear_rows_kernel", "kernel", 110, 4),
        ev("void cudnn::bn_fw_kernel<float>", "kernel", 20, 30),
        ev("void at::native::elementwise_kernel<128, 2>", "kernel", 40, 20, 8),  # overlaps
        ev("void at::native::reduce_kernel<512, 1>", "kernel", 120, 50),
        ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 200, 10),
        ev("mystery_kernel", "kernel", 230, 10),  # after the last step
    ]
    os.makedirs(folder)
    path = os.path.join(folder, "host_1.1.pt.trace.json")
    with open(path, "w") as f:
        json.dump({"deviceProperties": [{"id": 0, "name": "NVIDIA H100 80GB HBM3"}],
                   "traceEvents": events}, f)
    return path


def test_analyze_synthetic_card_trace(tmp_path, capsys):
    path = _synthetic_trace(str(tmp_path / "profile"))
    r = trace_analysis.analyze(str(tmp_path / "profile"), top=3)
    assert r["trace"] == path and r["device_plane"] == "NVIDIA H100 80GB HBM3"
    assert r["steps"] == 2 and r["step_wall_ms"] == pytest.approx([0.100, 0.120])
    assert r["total_ms"] == pytest.approx((4 + 4 + 30 + 20 + 50 + 10 + 10) / 1e3)
    assert r["ms_per_step"] == pytest.approx(r["total_ms"] / 2)
    g = r["groups"]
    assert g["K1 shear_rows"]["count"] == 2 and g["K1 shear_rows"]["ms"] == pytest.approx(0.008)
    assert g["cuDNN / GEMM"]["ms"] == pytest.approx(0.030)
    assert g["elementwise"]["count"] == 1 and g["reductions"]["count"] == 1
    assert g["copies and casts"]["ms"] == pytest.approx(0.010)
    assert g["other"]["ms"] == pytest.approx(0.010)
    assert sum(v["share"] for v in g.values()) == pytest.approx(1.0)
    assert list(g)[0] == "reductions"  # ordered by time
    assert [name for *_, name in r["top_kernels"]] == [
        "void at::native::reduce_kernel<512, 1>", "void cudnn::bn_fw_kernel<float>",
        "void at::native::elementwise_kernel<128, 2>"]
    # busy over [0, 220): [10,14) [20,60) [110,114) [120,170) [200,210) = 108 µs
    assert r["window_ms"] == pytest.approx(0.220)
    assert r["busy_share"] == pytest.approx(108 / 220)
    trace_analysis.main([str(tmp_path / "profile")])
    assert "K1 shear_rows" in capsys.readouterr().out


def test_kernel_groups():
    assert trace_analysis.kernel_group("shear_rows_kernel") == "K1 shear_rows"
    assert trace_analysis.kernel_group(
        "void head_mma_kernel<true, 1, true>(...)") == "K2 head_argmax"
    assert trace_analysis.kernel_group("sm90_xmma_fprop_implicit_gemm") == "cuDNN / GEMM"
    assert trace_analysis.kernel_group(
        "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevComm*, unsigned long, ncclWork*)") == "NCCL"
    assert trace_analysis.kernel_group("something_else") == "other"
    with pytest.raises(IOError, match="profile_steps"):
        trace_analysis.analyze(os.path.dirname(os.path.abspath(__file__)) + "/no-such-dir")


class _StubLibrary:
    """A loaded library's stand-in: one C function that records its
    arguments and returns ``err``, and the error-string entry."""

    def __init__(self, err):
        self.err, self.calls = err, []

    def tpuseg_stub(self, *args):
        self.calls.append(args)
        return self.err

    def tpuseg_cuda_error_string(self, err):
        return f"stub error {err}".encode()


@pytest.mark.parametrize("err", [0, 2])
@pytest.mark.parametrize("index, guarded", [(0, False), (None, False), (1, True)],
                         ids=["current", "no_index", "other"])
def test_launch_path(monkeypatch, index, guarded, err):
    """``build.launch`` on a stub library, no card: the stream handle goes
    last, a device guard is entered only for a device that is not the
    current one, and a non-zero return raises with the caller's text, the
    library's message, the code and the caller's note."""
    from tpuseg_torch.kernels import build

    lib = _StubLibrary(err)
    guards = []
    monkeypatch.setitem(build._LIBS, "stub", lib)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: guards.append(device) or contextlib.nullcontext())
    dev = torch.device("cuda", index) if index is not None else torch.device("cuda")
    args = ("stub", "tpuseg_stub", dev, 1234, 7, 8.5, None)
    if err:
        with pytest.raises(RuntimeError) as info:
            build.launch(*args, what="stub kernel launch failed", note="; a note")
        assert str(info.value) == "stub kernel launch failed: stub error 2 (2; a note)"
    else:
        build.launch(*args, what="stub kernel launch failed")
    assert lib.calls == [(7, 8.5, None, 1234)]
    assert guards == ([dev] if guarded else [])
    build.check(lib, 0, "never raised")
    with pytest.raises(RuntimeError, match=r"^plan failed: stub error 9 \(9\)$"):
        build.check(lib, 9, "plan failed")


def _accumulate(folder):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(folder)
    acc.Reload()
    return {tag: acc.Scalars(tag) for tag in acc.Tags()["scalars"]}


def _tb_dirs(out):
    tb = glob.glob(os.path.join(out, "tensorboard-*"))
    assert len(tb) == 1, tb
    return os.path.join(tb[0], "train"), os.path.join(tb[0], "test")


def test_event_files_read_by_tensorboard(profiled_run):
    out, res = profiled_run
    train_dir, test_dir = _tb_dirs(out)
    train, test = _accumulate(train_dir), _accumulate(test_dir)
    assert set(train) == {"loss", "accuracy", "images_per_sec"}
    assert set(test) == {"loss", "accuracy"}
    assert [s.value for s in train["loss"]] == list(np.float32(res.train_losses))
    assert len(train["images_per_sec"]) == len(res.train_losses) - 1
    assert [s.value for s in test["loss"]] == list(np.float32(res.test_loss))
    assert [s.step for s in test["loss"]] == [3, 6]
    # the port's own reader gives the same events, CRCs checked
    (path,) = glob.glob(os.path.join(train_dir, "events.out.tfevents.*"))
    events = tb_events.read_events(path)
    assert events[0]["file_version"] == tb_events.FILE_VERSION
    assert [e["value"] for e in events if e.get("tag") == "loss"] == \
        [s.value for s in train["loss"]]


def test_event_tags_and_steps_match_tpuseg(dbs, profiled_run, tmp_path):
    """tpuseg's trainer (tensorboardX) on the same config, profiled the
    same way: the same tags at the same steps."""
    from tpuseg.train.trainer import TrainConfig, train_model

    out, _ = profiled_run
    jax_out = str(tmp_path / "jax")
    train_model(TrainConfig(
        train_database=dbs[0], test_database=dbs[1], output_folder=jax_out, batch_size=2,
        test_every_n_steps=3, max_epochs=2, early_stopping_count=10, log_every_n_steps=2,
        seed=3, dtype="float32", base_features=2, profile_steps=2))
    for port_dir, jax_dir in zip(_tb_dirs(out), _tb_dirs(jax_out)):
        port, want = _accumulate(port_dir), _accumulate(jax_dir)
        assert set(port) == set(want)
        for tag in want:
            assert [s.step for s in port[tag]] == [s.step for s in want[tag]], tag


def test_event_file_crc_is_checked(tmp_path):
    w = tb_events.EventFileWriter(str(tmp_path))
    w.add_scalar("loss", 0.25, 7)
    w.close()
    events = tb_events.read_events(w.path)
    assert events[1] == {"wall_time": events[1]["wall_time"], "step": 7, "tag": "loss",
                         "value": 0.25}
    raw = bytearray(open(w.path, "rb").read())
    raw[-6] ^= 0x40  # inside the scalar's payload
    open(w.path, "wb").write(bytes(raw))
    with pytest.raises(IOError, match="payload CRC"):
        tb_events.read_events(w.path)
