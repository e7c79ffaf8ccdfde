"""The port's whole-slide streaming engine (tpuseg_torch/infer/tiled.py
inference_tiled_streaming, the runner's streaming mode) against the JAX
package's and against the port's own in-RAM engine, on the CPU.

Geometry of tests/test_inference.py's streaming tests: a 640x480 uint16
slide as a tiled BigTIFF (tile 128), windows of 288 with a radius of 96,
batch 2. At fp32 the streamed masks equal the JAX package's. Under
int8_blocked the two packages' engines differ in about one pixel in 3000,
streamed or in RAM (the fp enc1a block sums in another order than XLA;
tests/test_torch_quant.py holds them at 0.999), so there the streamed
masks must equal each package's own in-RAM masks exactly, and differ from
each other only where the in-RAM engines do."""

import os
import threading
import time

import numpy as np
import pytest
import torch

from tpuseg.data.preprocess import zscore_stats
from tpuseg.infer import quant as jq
from tpuseg.infer import tiled as jt
from tpuseg.infer.runner import InferenceConfig as JaxConfig
from tpuseg.infer.runner import inference as jax_inference
from tpuseg.utils import bigtiff as jbt
from tpuseg_torch.cli.inference import main
from tpuseg_torch.infer import quant as tq
from tpuseg_torch.infer import tiled as tt
from tpuseg_torch.utils import bigtiff as tbt
from tpuseg_torch.utils.jax_bridge import unet_from_flax

from test_torch_runner import _port_args, ckpts  # noqa: F401 (fixture)
from test_torch_tiled import port_cli_args, write_checkpoints
from test_torch_unet import jax_model_and_vars
from torch_threads import one_cpu_thread  # noqa: F401 (autouse)

TILE, RADIUS, BATCH = 288, 96, 2


@pytest.fixture(scope="module")
def engines():
    """fp32 and int8_blocked predict_fns of one base-4 U-Net in both
    packages; the int8 scales are the JAX package's, calibrated on a crop
    of the slide, shared by both."""
    model, variables = jax_model_and_vars()
    port = unet_from_flax(variables, 2, 1, 4, torch.float32)
    img = np.random.default_rng(8).integers(0, 4096, size=(640, 480)).astype(np.uint16)
    mean, std = zscore_stats(img)
    calib = [(img[192:448, 112:368, None].astype(np.float32) - mean) / std]
    jfold = jq.fold_variables(variables)
    ranges = jq.calibrate(jfold, calib)
    return img, {
        "fp32": (jt.make_predict_fn(model, variables), tt.make_predict_fn(port)),
        "int8_blocked": (jq.make_quantized_predict_fn(jfold, ranges, blocked_edges=True),
                         tq.make_quantized_predict_fn(tq.fold_variables(port), ranges,
                                                      blocked_edges=True)),
    }


def _slide(tmp_path, img, name="slide.tif"):
    src = str(tmp_path / name)
    tbt.write_bigtiff(src, img, tile=(128, 128))
    return src


def _port_stream(src, fn, out, **kw):
    with tbt.BigTiffReader(src) as reader:
        tt.inference_tiled_streaming(reader, fn, out, TILE, RADIUS, BATCH, progress=False,
                                     device="cpu", **kw)
    return tbt.read_bigtiff(out)


@pytest.mark.parametrize("mode", ["fp32", "int8_blocked"])
def test_streaming_matches_tpuseg(engines, tmp_path, mode):
    img, fns = engines
    jfn, tfn = fns[mode]
    stats = zscore_stats(img)
    src = _slide(tmp_path, img)
    with jbt.BigTiffReader(src) as reader:
        jt.inference_tiled_streaming(reader, jfn, str(tmp_path / "jax.tif"), TILE, RADIUS,
                                     BATCH, num_classes=2, norm_stats=stats, progress=False)
    want = jbt.read_bigtiff(str(tmp_path / "jax.tif"))
    got = _port_stream(src, tfn, str(tmp_path / "port.tif"), num_classes=2, norm_stats=stats)
    assert got.shape == want.shape == img.shape and got.dtype == want.dtype == np.uint8
    if mode == "fp32":
        np.testing.assert_array_equal(got, want)
        return
    port_ram = tt.inference_tiled(img, tfn, TILE, RADIUS, BATCH, 2, stats, "cpu")
    jax_ram = np.asarray(jt.inference_tiled(img, jfn, TILE, RADIUS, BATCH, 2,
                                            norm_stats=stats))
    np.testing.assert_array_equal(got, port_ram)
    np.testing.assert_array_equal(want, jax_ram)
    np.testing.assert_array_equal(got != want, port_ram != jax_ram)
    agree = (got == want).mean()
    print(f"int8_blocked streamed port vs tpuseg: {int((got != want).sum())} of "
          f"{got.size} pixels differ (agreement {agree:.7f})")
    assert agree >= 0.999


@pytest.mark.parametrize("num_classes, src_dtype, out_dtype", [
    (2, np.uint16, np.uint8), (300, np.uint16, np.uint16), (None, np.float32, np.int32)])
def test_streaming_matches_port_in_ram(engines, tmp_path, num_classes, src_dtype, out_dtype):
    """Equal stats, a slide whose last zone row and column are partial
    (400 x 336 at zone 96), and the output dtype by class count."""
    _, fns = engines
    tfn = fns["fp32"][1]
    rng = np.random.default_rng(12)
    img = rng.integers(0, 4096, (400, 336)).astype(src_dtype)
    stats = zscore_stats(img)
    want = tt.inference_tiled(img, tfn, TILE, RADIUS, BATCH, num_classes, stats, "cpu")
    got = _port_stream(_slide(tmp_path, img), tfn, str(tmp_path / "m.tif"),
                       num_classes=num_classes, norm_stats=stats)
    assert got.dtype == out_dtype and got.shape == img.shape
    np.testing.assert_array_equal(got, want)


def test_streaming_default_stats_close_to_in_ram(engines, tmp_path):
    """With its own single-pass float64 stats the streamed mask agrees with
    the in-RAM engine away from decision boundaries."""
    _, fns = engines
    tfn = fns["fp32"][1]
    img = np.random.default_rng(9).integers(0, 4096, size=(320, 320)).astype(np.uint16)
    want = tt.inference_tiled(img, tfn, TILE, RADIUS, BATCH, 2, zscore_stats(img), "cpu")
    got = _port_stream(_slide(tmp_path, img), tfn, str(tmp_path / "m.tif"), num_classes=2)
    agree = (got == want).mean()
    assert agree > 0.999, f"streamed/in-RAM agreement {agree}"


def _stream_threads():
    return [t for t in threading.enumerate() if t.name == "tpuseg-torch-stream-read"]


def test_streaming_failure_aborts_writer_and_releases_reader(engines, tmp_path):
    """A predict_fn that fails on its third call: the error propagates, the
    mask file is left unfinalized (no IFD, so it does not read), and the
    reading thread ends."""
    img, fns = engines
    tfn = fns["fp32"][1]
    calls = []

    def flaky(batch):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("device lost")
        return tfn(batch)

    out = str(tmp_path / "m.tif")
    with pytest.raises(RuntimeError, match="device lost"):
        _port_stream(_slide(tmp_path, img), flaky, out, num_classes=2)
    with pytest.raises(IOError):
        tbt.read_bigtiff(out)
    deadline = time.monotonic() + 10
    while _stream_threads() and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not _stream_threads()


def test_streaming_refuses_small_slide_and_bad_geometry(engines, tmp_path):
    _, fns = engines
    src = _slide(tmp_path, np.zeros((256, 300), np.uint16))
    with tbt.BigTiffReader(src) as reader:
        with pytest.raises(ValueError, match="whole-slide"):
            tt.inference_tiled_streaming(reader, fns["fp32"][1], str(tmp_path / "m.tif"),
                                         TILE, RADIUS, device="cpu")
        with pytest.raises(ValueError, match="multiples of 16"):
            tt.inference_tiled_streaming(reader, fns["fp32"][1], str(tmp_path / "m.tif"),
                                         200, 40, device="cpu")
    assert not os.path.exists(tmp_path / "m.tif")


def test_streaming_refuses_to_write_over_its_input(ckpts, tmp_path):  # noqa: F811
    _, port_path, _ = ckpts
    folder = str(tmp_path / "slides")
    os.makedirs(folder)
    img = np.random.default_rng(3).integers(0, 4096, (200, 180)).astype(np.uint16)
    tbt.write_bigtiff(os.path.join(folder, "s.tif"), img, tile=(64, 64))
    with pytest.raises(ValueError, match="cannot write over its input"):
        main(_port_args(port_path, folder, folder, "--radius", "16", "--streaming"))
    np.testing.assert_array_equal(tbt.read_bigtiff(os.path.join(folder, "s.tif")), img)


@pytest.mark.parametrize("extra", [("--quantize", "int8_blocked"), ("--auto_tile",)])
def test_runner_streaming_matches_tpuseg(ckpts, tmp_path, extra):  # noqa: F811
    """One folder of tiled-BigTIFF slides through tpuseg.infer.runner and the
    port's CLI with --streaming, from one checkpoint. fp32 with --auto_tile:
    masks equal. int8_blocked: each package calibrates on central crops of
    the slides read through the reader, normalized with the slides'
    streaming stats; the scales agree to 1e-4 and the masks on >= 0.999 of
    pixels."""
    import json

    jax_path, port_path, _ = ckpts
    folder = str(tmp_path / "slides")
    os.makedirs(folder)
    rng = np.random.default_rng(4)
    shapes = {"a.tif": (200, 180), "b.tif": (176, 240)}
    for name, shape in shapes.items():
        tbt.write_bigtiff(os.path.join(folder, name),
                          rng.integers(0, 4096, shape).astype(np.uint16), tile=(64, 64))
    int8 = "--quantize" in extra
    jax_inference(JaxConfig(
        checkpoint_filepath=jax_path, image_folder=folder,
        output_folder=str(tmp_path / "jax"), number_classes=2, number_channels=1,
        tile_size=64, radius=16, batch_size=2, dtype="float32", base_features=4,
        data_parallel=False, streaming=True, auto_tile=not int8,
        quantize="int8_blocked" if int8 else "none",
        calibration_out=str(tmp_path / "jax.json") if int8 else None))
    args = ["--radius", "16", "--streaming", "--dtype", "float32", *extra]
    if int8:
        args += ["--calibration_out", str(tmp_path / "port.json")]
    written = main(_port_args(port_path, folder, str(tmp_path / "port"), *args))
    assert sorted(os.path.basename(p) for p in written) == sorted(shapes)
    for name, shape in shapes.items():
        got = tbt.read_bigtiff(str(tmp_path / "port" / name))
        want = jbt.read_bigtiff(str(tmp_path / "jax" / name))
        assert got.shape == want.shape == shape and got.dtype == want.dtype == np.uint8
        if int8:
            assert (got == want).mean() >= 0.999
        else:
            np.testing.assert_array_equal(got, want)
    if int8:
        with open(tmp_path / "jax.json") as f:
            want = json.load(f)["act_ranges"]
        with open(tmp_path / "port.json") as f:
            got = json.load(f)["act_ranges"]
        assert set(got) == set(want)
        for k, v in want.items():
            assert got[k] == pytest.approx(v, rel=1e-4), k


def test_streaming_three_channels_four_classes_matches_tpuseg(tmp_path):
    """C=3 / K=4 slides streamed through tpuseg's runner and the port's CLI,
    --quantize none in f32: labels agree on >= 0.999 of pixels."""
    jax_path, port_path = write_checkpoints(str(tmp_path))
    folder = str(tmp_path / "slides")
    os.makedirs(folder)
    rng = np.random.default_rng(7)
    shapes = {"a.tif": (200, 180), "b.tif": (176, 240)}
    for name, shape in shapes.items():
        tbt.write_bigtiff(os.path.join(folder, name),
                          rng.integers(0, 4096, shape + (3,)).astype(np.uint16), tile=(64, 64))
    jax_inference(JaxConfig(
        checkpoint_filepath=jax_path, image_folder=folder, output_folder=str(tmp_path / "jax"),
        number_classes=4, number_channels=3, tile_size=64, radius=16, batch_size=2,
        dtype="float32", base_features=4, data_parallel=False, streaming=True,
        quantize="none"))
    main(port_cli_args(port_path, folder, str(tmp_path / "port"), "--streaming"))
    for name, shape in shapes.items():
        got = tbt.read_bigtiff(str(tmp_path / "port" / name))
        want = jbt.read_bigtiff(str(tmp_path / "jax" / name))
        assert got.shape == want.shape == shape and got.dtype == want.dtype == np.uint8
        assert got.max() <= 3 and len(np.unique(want)) > 1
        agree = (got == want).mean()
        assert agree >= 0.999, (name, agree)


def test_inference_single_matches_tpuseg(engines):
    model, variables = jax_model_and_vars()
    _, fns = engines
    img = np.random.default_rng(0).random((50, 70)).astype(np.float32)  # not x16
    want = jt.inference_single(img, fns["fp32"][0])
    got = tt.inference_single(img, fns["fp32"][1], device="cpu")
    assert got.shape == (50, 70) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    with pytest.raises(IOError, match="HW or HWC"):
        tt.inference_single(np.zeros((4, 4, 4, 4), np.float32), fns["fp32"][1], device="cpu")


def test_device_output_matches_tpuseg(engines):
    _, fns = engines
    jfn, tfn = fns["fp32"]
    img = np.random.default_rng(6).integers(0, 4096, (300, 340)).astype(np.uint16)
    stats = zscore_stats(img)
    want = np.asarray(jt.inference_tiled(img, jfn, TILE, RADIUS, BATCH, 2, norm_stats=stats,
                                         device_output=True))
    got = tt.inference_tiled(img, tfn, TILE, RADIUS, BATCH, 2, stats, "cpu",
                             device_output=True)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.uint8
    assert tuple(got.shape) == want.shape == (300, 340)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), tt.inference_tiled(img, tfn, TILE, RADIUS, BATCH, 2, stats, "cpu"))
