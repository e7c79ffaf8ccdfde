"""The port's tiled inference (tpuseg_torch/infer/tiled.py) against the JAX
package's on the CPU: the geometry helpers are pure Python and must agree
exactly; the masks of the halo-tiled and the batched small-image engines
must equal tpuseg's for the same f32 model and the same uint16 image."""

import numpy as np
import pytest
import torch

from tpuseg.data.preprocess import zscore_stats
from tpuseg.infer import runner as jrunner
from tpuseg.infer import tiled as jt
from tpuseg_torch.infer import runner as trunner
from tpuseg_torch.infer import tiled as tt
from tpuseg_torch.utils.jax_bridge import unet_from_flax

from test_torch_unet import jax_model_and_vars


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
