"""The port's tiled inference (tpuseg_torch/infer/tiled.py) against the JAX
package's on the CPU: the geometry helpers are pure Python and must agree
exactly; the masks of the halo-tiled and the batched small-image engines
must equal tpuseg's for the same f32 model and the same uint16 image."""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from tpuseg.data.preprocess import zscore_stats
from tpuseg.infer import runner as jrunner
from tpuseg.infer import tiled as jt
from tpuseg.models.unet import UNet as JaxUNet
from tpuseg.train.steps import create_train_state
from tpuseg.utils.checkpoint import save_checkpoint
from tpuseg_torch.cli.inference import main as port_cli
from tpuseg_torch.infer import runner as trunner
from tpuseg_torch.infer import tiled as tt
from tpuseg_torch.utils.checkpoint import save_model
from tpuseg_torch.utils.imagio import imread, imwrite
from tpuseg_torch.utils.jax_bridge import unet_from_flax

from test_torch_unet import jax_model_and_vars
from torch_threads import one_cpu_thread  # noqa: F401 (autouse)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as smoke  # noqa: E402


@pytest.fixture(scope="module")
def models():
    model, variables = jax_model_and_vars()
    port = unet_from_flax(variables, 2, 1, 4, torch.float32)
    return jt.make_predict_fn(model, variables), tt.make_predict_fn(port)


def test_geometry_helpers_agree():
    for h, w, zor, tile, r in [(100, 140, 32, 64, 16), (4096, 4096, 832, 1024, 96),
                               (3330, 2000, 1024, 1216, 96), (300, 50, 64, 96, 16)]:
        ch, cw = max(h, tile), max(w, tile)
        assert tt._zor_placements(h, w, zor, tile, r, ch, cw) == \
            jt._zor_placements(h, w, zor, tile, r, ch, cw)
    for h, w, r, chunk in [(4096, 4096, 96, 8), (3330, 3330, 96, 8), (2048, 1500, 112, 4),
                           (600, 900, 32, 1)]:
        assert tt.choose_tile_size(h, w, r, chunk=chunk) == \
            jt.choose_tile_size(h, w, r, chunk=chunk)
    for b in (1, 3, 8, 16):
        assert tt.max_auto_tile(b) == jt.max_auto_tile(b)
    paths = [f"im{i:03d}.tif" for i in range(37)]
    for k in (1, 4, 5, 37, 50):
        assert trunner._calibration_sample(paths, k) == jrunner._calibration_sample(paths, k)


def test_inference_tiled_matches(models):
    jfn, tfn = models
    img = np.random.default_rng(0).integers(0, 4096, (100, 140)).astype(np.uint16)
    stats = zscore_stats(img)
    want = jt.inference_tiled(img, jfn, tile_size=64, radius=16, batch_size=3,
                              num_classes=2, norm_stats=stats)
    got = tt.inference_tiled(img, tfn, tile_size=64, radius=16, batch_size=3,
                             num_classes=2, norm_stats=stats, device="cpu")
    assert got.shape == want.shape == (100, 140) and got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_inference_single_batch_matches(models):
    jfn, tfn = models
    rng = np.random.default_rng(1)
    imgs = [rng.integers(0, 4096, (40, 36)).astype(np.uint16) for _ in range(3)]
    want = jt.inference_single_batch(imgs, jfn, batch_size=2)
    got = tt.inference_single_batch(imgs, tfn, batch_size=2, device="cpu")
    assert len(got) == 3
    for g, w in zip(got, want):
        assert g.shape == (40, 36)
        np.testing.assert_array_equal(g, np.asarray(w))


def test_make_softmax_fn_matches(models):
    """The reference-contract softmax of a batch, against tpuseg's, within
    the f32 logits' tolerance (tests/test_torch_unet.py)."""
    model, variables = jax_model_and_vars()
    port = unet_from_flax(variables, 2, 1, 4, torch.float32)
    batch = np.random.default_rng(2).normal(0, 1, (3, 32, 48, 1)).astype(np.float32)
    want = np.asarray(jt.make_softmax_fn(model, variables)(batch))
    got = tt.make_softmax_fn(port)(torch.from_numpy(batch)).numpy()
    assert got.shape == want.shape == (3, 32, 48, 2)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def write_checkpoints(root, ncls=4, channels=3):
    """(tpuseg checkpoint dir, port checkpoint file) holding one base-4
    U-Net of ``channels`` inputs and ``ncls`` classes."""
    _, variables = jax_model_and_vars(ncls=ncls, channels=channels)
    model = JaxUNet(num_classes=ncls, base_features=4, dtype=jax.numpy.float32)
    state = create_train_state(model, jax.random.PRNGKey(0), channels, 1e-4)
    state = state.replace(
        params=jax.tree_util.tree_map(jax.numpy.asarray, variables["params"]),
        batch_stats=jax.tree_util.tree_map(jax.numpy.asarray, variables["batch_stats"]))
    jax_path, port_path = os.path.join(root, "checkpoint"), os.path.join(root, "port.pt")
    save_checkpoint(jax_path, state)
    save_model(port_path, unet_from_flax(variables, ncls, channels, 4, torch.float32))
    return jax_path, port_path


def port_cli_args(port_path, imgdir, outdir, *extra, ncls=4, channels=3):
    return ["--checkpoint_filepath", port_path, "--image_folder", imgdir,
            "--output_folder", outdir, "--number_classes", str(ncls),
            "--number_channels", str(channels), "--base_features", "4", "--tile_size", "64",
            "--batch_size", "2", "--radius", "16", "--dtype", "float32",
            "--quantize", "none", "--device", "cpu", *extra]


def test_cli_three_channels_four_classes_matches_tpuseg(tmp_path):
    """C=3 / K=4 through the inference CLI in RAM (one tiled image, one
    batched small image), --quantize none in f32: labels agree on >= 0.999
    of pixels with tpuseg's runner."""
    jax_path, port_path = write_checkpoints(str(tmp_path))
    imgdir = str(tmp_path / "imgs")
    os.makedirs(imgdir)
    rng = np.random.default_rng(3)
    shapes = {"big.tif": (100, 140), "small.tif": (48, 40)}
    for name, shape in shapes.items():
        imwrite(os.path.join(imgdir, name),
                rng.integers(0, 4096, shape + (3,)).astype(np.uint16))
    jrunner.inference(jrunner.InferenceConfig(
        checkpoint_filepath=jax_path, image_folder=imgdir, output_folder=str(tmp_path / "jax"),
        number_classes=4, number_channels=3, tile_size=64, radius=16, batch_size=2,
        dtype="float32", base_features=4, data_parallel=False, quantize="none"))
    port_cli(port_cli_args(port_path, imgdir, str(tmp_path / "port")))
    for name, shape in shapes.items():
        got = imread(str(tmp_path / "port" / name))
        want = imread(str(tmp_path / "jax" / name))
        assert got.shape == want.shape == shape and got.dtype == want.dtype
        assert got.max() <= 3 and len(np.unique(want)) > 1
        agree = (got == want).mean()
        assert agree >= 0.999, (name, agree)


def test_uint16_ships_exactly():
    """uint16 pixels travel as int16 bits and come back 0..65535 exactly."""
    img = np.array([[0, 1, 32767, 32768, 65535]], np.uint16)
    np.testing.assert_array_equal(tt._to_device(img, "cpu").numpy(), img.astype(np.float32))


def test_minimize_dtype_matches():
    for mask in (np.array([[0, 1]]), np.array([[0, 300]]), np.array([[-1, 2]]),
                 np.array([[0, 70000]]), np.zeros((0, 3), np.int32)):
        got, want = tt.minimize_dtype(mask), jt.minimize_dtype(mask)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


# The one-device pass as a copy pipeline: the band and zone schedule, the
# masks against a whole-image stitch, and PIPELINE

def _conv_predict(ncls, channels, seed=0):
    """NHWC float batch -> int32 labels of a fixed 3x3 conv with zero
    padding: a label depends on where the window was cut, so a tile
    stitched from the wrong window shows."""
    w = torch.randn(ncls, channels, 3, 3, generator=torch.Generator().manual_seed(seed))

    def predict(x):
        y = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), w, padding=1)
        return y.argmax(1).to(torch.int32)

    return predict


# (image, tile, radius, batch): the serving cells' slide, a one-call
# image, a skinny image padded up to a tile, a non-multiple-of-16 image;
# then each call's read limit, the mask rows each call finishes, and
# PIPELINE after a pass
SCHEDULES = {
    "cells_4096": ((4096, 4096), 1024, 96, 8, [1760, 3424, 4096, 4096],
                   [(0, 832), (832, 2496), (2496, 3328), (3328, 4096)],
                   {"upload_bands": 3, "early_calls": 2, "download_bands": 4,
                    "early_downloads": 3}),
    "one_call": ((100, 140), 64, 16, 32, [112], [(0, 100)],
                 {"upload_bands": 1, "early_calls": 0, "download_bands": 1,
                  "early_downloads": 0}),
    "skinny": ((40, 200), 64, 16, 4, [64, 64, 64, 64], [(0, 0), (0, 32), (32, 32), (32, 40)],
               {"upload_bands": 1, "early_calls": 0, "download_bands": 2,
                "early_downloads": 1}),
    "not_x16": ((130, 97), 64, 16, 4, [64, 80, 112, 144, 144],
                [(0, 32), (32, 64), (64, 96), (96, 128), (128, 130)],
                {"upload_bands": 4, "early_calls": 3, "download_bands": 5,
                 "early_downloads": 4}),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_band_and_zone_schedule(name):
    """Each call reads rows below its limit and waits for the bands that
    cover them and no more; the bands tile the image's rows in order and
    end at the read limits; each call finishes the zone rows whose last
    tile it holds; PIPELINE counts the pass."""
    (h0, w0), tile, radius, batch, reads, downs, counts = SCHEDULES[name]
    h, w = max(tile, -(-h0 // 16) * 16), max(tile, -(-w0 // 16) * 16)
    placements = tt._zor_placements(-(-h0 // 16) * 16, -(-w0 // 16) * 16,
                                    tile - 2 * radius, tile, radius, h, w)
    plan = tt._plan(placements, tile, batch, h0)
    assert plan.reads == reads and plan.downs == downs
    assert [r0 for r0, _ in plan.bands] == [0] + [r1 for _, r1 in plan.bands[:-1]]
    assert plan.bands[-1][1] == h
    assert [r1 for _, r1 in plan.bands] == sorted(set(reads))
    for c, r in enumerate(reads):
        assert plan.bands[plan.needs[c] - 1][1] >= r > plan.bands[plan.needs[c] - 1][0]
        windows = placements[plan.calls[c][0]:plan.calls[c][1]]
        assert max(p[4] for p in windows) + tile <= r
    img = np.random.default_rng(4).integers(0, 60000, (h0, w0)).astype(np.uint16)
    mask = tt.inference_tiled(img, lambda x: torch.ones(x.shape[:3], dtype=torch.int32), tile,
                              radius, batch, 2, (np.float32([3e4]), np.float32([1.7e4])), "cpu")
    assert mask.shape == (h0, w0) and (mask == 1).all()
    assert tt.PIPELINE == counts and counts["upload_bands"] == len(plan.bands)


@pytest.mark.parametrize("device_output", [False, True])
@pytest.mark.parametrize("ncls", [2, 300])
@pytest.mark.parametrize("kind", ["uint16", "float32", "uint16_c3"])
def test_pipelined_pass_equals_whole_image_stitch(kind, ncls, device_output):
    """The banded pass gives, on every pixel, the mask of a plain
    whole-image z-score and stitch with the same predict function
    (``chip_smoke.whole_image_stitch``, which the card test uses): uint8
    at <= 256 classes, int32 above, a fresh contiguous array (or the
    cropped tensor with ``device_output``)."""
    rng = np.random.default_rng(5)
    shape = (130, 97, 3) if kind == "uint16_c3" else (130, 97)
    img = (rng.normal(5, 3, shape).astype(np.float32) if kind == "float32"
           else rng.integers(0, 60000, shape).astype(np.uint16))
    channels = img.reshape(130, 97, -1).shape[2]
    stats = (img.reshape(-1, channels).mean(0).astype(np.float32),
             img.reshape(-1, channels).std(0).astype(np.float32))
    predict = _conv_predict(ncls, channels)
    want = smoke.whole_image_stitch(img, predict, 16, stats, "cpu", 64, 3, ncls)
    got = tt.inference_tiled(img, predict, 64, 16, 3, ncls, stats, "cpu",
                             device_output=device_output)
    if device_output:
        assert tt.PIPELINE["download_bands"] == 0
        got = got.numpy()
    else:
        assert tt.PIPELINE["download_bands"] > 1 and got.flags["C_CONTIGUOUS"]
    assert got.dtype == (np.uint8 if ncls <= 256 else np.int32) and got.shape == (130, 97)
    assert len(np.unique(want)) > 1
    np.testing.assert_array_equal(got, want)


def test_a_devices_list_takes_the_whole_image_pass():
    """A ``devices`` list keeps the whole-image pass (PIPELINE stays zero)
    and gives the pipelined pass's mask."""
    img = np.random.default_rng(6).integers(0, 60000, (100, 140)).astype(np.uint16)
    stats = (np.float32([3e4]), np.float32([1.7e4]))
    predict = _conv_predict(2, 1)
    banded = tt.inference_tiled(img, predict, 64, 16, 3, 2, stats, "cpu")
    assert tt.PIPELINE["upload_bands"] > 1
    whole = tt.inference_tiled(img, predict, 64, 16, 3, 2, stats, "cpu", devices=["cpu"])
    assert all(v == 0 for v in tt.PIPELINE.values())
    np.testing.assert_array_equal(banded, whole)
