"""The port's tiled inference (tpuseg_torch/infer/tiled.py) against the JAX
package's on the CPU: the geometry helpers are pure Python and must agree
exactly; the masks of the halo-tiled and the batched small-image engines
must equal tpuseg's for the same f32 model and the same uint16 image."""

import os

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
