"""The port's metrics (tpuseg_torch/ops/metrics.py, cli/evaluate.py) against
the JAX package's (tpuseg/ops/metrics.py) on the CPU: confusion counts
exactly equal, including labels outside [0, K) (255, -1) and an empty
input; IoU, Dice and mIoU within 1e-6; evaluate_folder's dicts equal on a
folder mixing tiled-BigTIFF pairs on different tile grids with non-BigTIFF
pairs."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuseg.ops import metrics as jm
from tpuseg_torch.cli.evaluate import main as evaluate_main
from tpuseg_torch.ops import metrics as tm
from tpuseg_torch.utils import bigtiff
from torch_threads import one_cpu_thread  # noqa: F401 (autouse)


def _labels(seed, shape, k, void=()):
    rng = np.random.default_rng(seed)
    out = rng.integers(0, k, shape).astype(np.int32)
    for v in void:
        out[rng.random(shape) < 0.05] = v
    return out


@pytest.mark.parametrize("k, shape, void", [
    (2, (3, 17, 19), ()),
    (3, (2, 32, 24), (255,)),
    (5, (4, 16, 16), (-1, 255)),
    (4, (0,), ()),
])
def test_confusion_matrix_matches_tpuseg(k, shape, void):
    pred = _labels(1, shape, k, void)
    true = _labels(2, shape, k, void[::-1])
    want = np.asarray(jm.confusion_matrix(jnp.asarray(pred), jnp.asarray(true), k))
    got = tm.confusion_matrix(torch.from_numpy(pred), torch.from_numpy(true), k)
    assert got.dtype == torch.int32 and tuple(got.shape) == (k, k)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), tm._bincount_cm(pred, true, k))


def test_confusion_matrix_uint8_void_labels():
    """uint8 masks with the 255 void label, as masks are stored."""
    pred = _labels(3, (40, 30), 2, (255,)).astype(np.uint8)
    true = _labels(4, (40, 30), 2, (255,)).astype(np.uint8)
    want = np.asarray(jm.confusion_matrix(jnp.asarray(pred), jnp.asarray(true), 2))
    got = tm.confusion_matrix(torch.from_numpy(pred), torch.from_numpy(true), 2)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.sum() < pred.size


@pytest.mark.parametrize("as_logits", [True, False])
def test_segmentation_metrics_match_tpuseg(as_logits):
    k = 4
    rng = np.random.default_rng(5)
    true = _labels(6, (2, 24, 20), k)
    true[true == 3] = 2  # class 3 absent from the truth
    if as_logits:
        pred = rng.normal(0, 1, (2, 24, 20, k)).astype(np.float32)
        labels = np.eye(k, dtype=np.float32)[true]
    else:
        pred, labels = _labels(7, (2, 24, 20), 3), true  # 3 absent from both
    want = jm.segmentation_metrics(jnp.asarray(pred), jnp.asarray(labels), k)
    got = tm.segmentation_metrics(torch.from_numpy(pred), torch.from_numpy(labels), k)
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["confusion"].numpy(), np.asarray(want["confusion"]))
    for name in ("iou", "mean_iou", "dice", "pixel_accuracy"):
        assert got[name].dtype == torch.float32, name
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), rtol=0,
                                   atol=1e-6, err_msg=name)


def _write_pair_folders(tmp_path):
    """Masks in two folders: BigTIFF pairs on different tile grids (one with
    void labels, one HWC1), a PNG pair, and one unmatched file on each
    side."""
    pred_dir, truth_dir = tmp_path / "pred", tmp_path / "truth"
    pred_dir.mkdir(), truth_dir.mkdir()
    rng = np.random.default_rng(11)
    for name, shape, ptile, ttile in (("a.tif", (300, 260), 128, 96),
                                      ("b.tif", (150, 170), 64, 112)):
        t = rng.integers(0, 3, shape).astype(np.uint8)
        p = np.where(rng.random(shape) < 0.8, t, rng.integers(0, 3, shape)).astype(np.uint8)
        if name == "a.tif":
            t[:10] = 255
            p = p[..., None]
        bigtiff.write_bigtiff(str(pred_dir / name), p, tile=(ptile, ptile))
        bigtiff.write_bigtiff(str(truth_dir / name), t, tile=(ttile, ttile))
    import imageio.v3 as iio

    t = rng.integers(0, 3, (40, 50)).astype(np.uint8)
    iio.imwrite(str(truth_dir / "c.png"), t)
    iio.imwrite(str(pred_dir / "c.png"), np.where(rng.random(t.shape) < 0.5, t, 0)
                .astype(np.uint8))
    iio.imwrite(str(pred_dir / "only_pred.png"), t)
    iio.imwrite(str(truth_dir / "only_truth.png"), t)
    return str(pred_dir), str(truth_dir)


def test_evaluate_folder_matches_tpuseg(tmp_path, capsys):
    pred_dir, truth_dir = _write_pair_folders(tmp_path)
    want = jm.evaluate_folder(pred_dir, truth_dir, 3)
    capsys.readouterr()
    got = tm.evaluate_folder(pred_dir, truth_dir, 3)
    assert "1 prediction file(s) and 1 truth file(s)" in capsys.readouterr().out
    assert got == want
    assert got["num_images"] == 3 and 0 < got["pixel_accuracy"] < 1


def test_stream_confusion_crosses_tile_grids(tmp_path):
    """The tile-by-tile sweep over pred's grid gives the whole-array counts
    when the truth's tile grid differs."""
    rng = np.random.default_rng(13)
    p = rng.integers(0, 3, (333, 251)).astype(np.uint8)
    t = rng.integers(0, 3, (333, 251)).astype(np.uint8)
    bigtiff.write_bigtiff(str(tmp_path / "p.tif"), p, tile=(96, 128))
    bigtiff.write_bigtiff(str(tmp_path / "t.tif"), t, tile=(64, 80))
    got = tm._stream_confusion(str(tmp_path / "p.tif"), str(tmp_path / "t.tif"), 3)
    np.testing.assert_array_equal(got, tm._bincount_cm(p, t, 3))
    np.testing.assert_array_equal(
        got, jm._stream_confusion(str(tmp_path / "p.tif"), str(tmp_path / "t.tif"), 3))


def test_shape_mismatch_is_value_error(tmp_path):
    """ValueError, not IOError, so evaluate_folder's imread fallback cannot
    score wrongly paired pixels."""
    for d in ("p", "t"):
        os.makedirs(tmp_path / d)
    bigtiff.write_bigtiff(str(tmp_path / "p" / "m.tif"), np.zeros((64, 96), np.uint8))
    bigtiff.write_bigtiff(str(tmp_path / "t" / "m.tif"), np.zeros((96, 64), np.uint8))
    with pytest.raises(ValueError, match="shape mismatch"):
        tm.evaluate_folder(str(tmp_path / "p"), str(tmp_path / "t"), 2)
    with pytest.raises(ValueError, match="shape mismatch"):
        tm._bincount_cm(np.zeros((4, 6)), np.zeros((6, 4)), 2)
    with pytest.raises(IOError, match="no matching"):
        tm.evaluate_folder(str(tmp_path / "p"), str(tmp_path), 2)


def test_evaluate_cli_exits_zero(tmp_path):
    pred_dir, truth_dir = _write_pair_folders(tmp_path)
    args = ["--pred_folder", pred_dir, "--truth_folder", truth_dir, "--number_classes", "3"]
    assert evaluate_main(args) == 0
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-m", "tpuseg_torch.cli.evaluate", *args],
                         cwd=root, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert '"mean_iou"' in res.stdout
