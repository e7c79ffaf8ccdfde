"""Tile groups sharded over a list of devices (tpuseg_torch/infer/tiled.py
``devices=``) on the CPU, and the runner's choice of devices.

- ``devices=[cpu, cpu]`` (two replicas of the predict function) against
  ``devices=[cpu]``: masks bit-equal for ``none``, ``int8`` and
  ``int8_blocked`` in the tiled, batched small-image and streamed engines,
  with every chunk full (the last group padded) and the chunks dealt to
  the replicas in turn;
- against the JAX package's ``inference_tiled(mesh=...)`` over two of its
  CPU devices, at the agreement of the cross-package tests (>= 0.999 of
  pixels, tests/test_torch_quant.py)."""

import os

import numpy as np
import pytest
import torch

from tpuseg_torch.infer import quant as tq
from tpuseg_torch.infer import runner
from tpuseg_torch.infer import tiled as tt
from tpuseg_torch.utils.jax_bridge import unet_from_flax

from test_torch_unet import jax_model_and_vars
from torch_threads import one_cpu_thread  # noqa: F401 (autouse)

TILE, RADIUS, BATCH = 64, 16, 3
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def setup():
    """(flax variables, port model, calibrated ranges, image, its stats)."""
    _, variables = jax_model_and_vars()
    port = unet_from_flax(variables, 2, 1, 4, torch.float32)
    img = np.random.default_rng(5).integers(0, 4096, (128, 160)).astype(np.uint16)
    stats = (np.asarray([img.mean()], np.float32), np.asarray([img.std()], np.float32))
    ranges = tq.calibrate(tq.fold_variables(port), [(img - stats[0][0]) / stats[1][0]],
                          device="cpu")
    return variables, port, ranges, img, stats


class Counted:
    """A predict function that records the batch size of each call."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, batch):
        self.calls.append(batch.shape[0])
        return self.fn(batch)


def _replicas(setup, mode, n):
    _, port, ranges, _, _ = setup
    if mode == "none":
        return [Counted(tt.make_predict_fn(port)) for _ in range(n)]
    folded = tq.fold_variables(port)
    return [Counted(tq.make_quantized_predict_fn(folded, ranges, dtype=torch.float32,
                                                 blocked_edges=mode == "int8_blocked"))
            for _ in range(n)]


def _serve(setup, engine, fns, devices, tmp_path):
    _, _, _, img, stats = setup
    if engine == "tiled":
        return tt.inference_tiled(img, fns, TILE, RADIUS, BATCH, 2, stats, device=CPU,
                                  devices=devices)
    if engine == "single_batch":
        imgs = [img[:48, :40], img[48:96, :40], img[:48, 40:80], img[48:96, 40:80],
                img[80:128, 80:120]]
        return np.stack(tt.inference_single_batch(imgs, fns, 2, device=CPU, devices=devices))
    from tpuseg_torch.utils.bigtiff import BigTiffReader, read_bigtiff, write_bigtiff

    src = str(tmp_path / "slide.tif")
    if not os.path.exists(src):
        write_bigtiff(src, img, tile=(64, 64))
    out = str(tmp_path / f"mask{len(devices)}.tif")
    with BigTiffReader(src) as reader:
        tt.inference_tiled_streaming(reader, fns, out, TILE, RADIUS, BATCH, num_classes=2,
                                     norm_stats=stats, progress=False, device=CPU,
                                     devices=devices)
    return read_bigtiff(out)


@pytest.mark.parametrize("engine", ["tiled", "single_batch", "streaming"])
@pytest.mark.parametrize("mode", ["none", "int8", "int8_blocked"])
def test_two_shards_equal_one(setup, tmp_path, mode, engine):
    one = _replicas(setup, mode, 1)
    two = _replicas(setup, mode, 2)
    want = _serve(setup, engine, one, [CPU], tmp_path)
    got = _serve(setup, engine, two, [CPU, CPU], tmp_path)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert 0.01 < (want == 1).mean() < 0.99  # both classes present: not a trivial equality
    per = 2 if engine == "single_batch" else BATCH
    # every chunk full, dealt to the shards in turn
    assert set(one[0].calls) == set(two[0].calls) == set(two[1].calls) == {per}
    assert len(two[0].calls) == len(two[1].calls)
    assert len(two[0].calls) + len(two[1].calls) >= len(one[0].calls)


def test_one_device_list_pads_where_the_plain_engine_runs_a_short_chunk(setup):
    """``devices=None`` keeps the single-device engine's short last chunk;
    a device list runs full chunks. The 20 tiles of the image: 6 full
    chunks and one of 2, against 7 full chunks."""
    _, port, _, img, stats = setup
    plain = Counted(tt.make_predict_fn(port))
    listed = Counted(tt.make_predict_fn(port))
    a = tt.inference_tiled(img, plain, TILE, RADIUS, BATCH, 2, stats, device=CPU)
    b = tt.inference_tiled(img, [listed], TILE, RADIUS, BATCH, 2, stats, device=CPU,
                           devices=[CPU])
    assert plain.calls == [3] * 6 + [2] and listed.calls == [3] * 7
    np.testing.assert_array_equal(a, b)


def test_predict_functions_must_match_devices(setup):
    _, port, _, img, stats = setup
    fn = tt.make_predict_fn(port)
    with pytest.raises(ValueError, match="2 predict functions for 3 devices"):
        tt.inference_tiled(img, [fn, fn], TILE, RADIUS, BATCH, 2, stats, device=CPU,
                           devices=[CPU] * 3)


@pytest.mark.parametrize("mode", ["none", "int8_blocked"])
def test_sharded_tiled_matches_jax_mesh(setup, mode):
    import jax
    import jax.numpy as jnp

    from tpuseg.infer import quant as jq
    from tpuseg.infer import tiled as jt
    from tpuseg.models.unet import UNet as JaxUNet
    from tpuseg.parallel.mesh import make_mesh

    variables, _, ranges, img, stats = setup
    if mode == "none":
        jfn = jt.make_predict_fn(JaxUNet(num_classes=2, base_features=4, dtype=jnp.float32),
                                 variables)
    else:
        jfn = jq.make_quantized_predict_fn(jq.fold_variables(variables), ranges,
                                           dtype=jnp.float32, blocked_edges=True)
    want = jt.inference_tiled(img, jfn, TILE, RADIUS, BATCH, num_classes=2,
                              mesh=make_mesh(jax.devices()[:2]), norm_stats=stats)
    got = _serve(setup, "tiled", _replicas(setup, mode, 2), [CPU, CPU], None)
    assert got.shape == want.shape == img.shape
    agree = float((got == np.asarray(want)).mean())
    print(f"{mode}: port (2 shards) vs tpuseg (2-device mesh) agreement {agree}")
    assert agree >= 0.999


def test_runner_shards_over_the_gpus_this_process_owns(monkeypatch):
    """Every visible GPU for the node's only process; cuda:LOCAL_RANK alone
    under a multi-process torchrun; an explicit cuda:N alone; one GPU with
    --no_data_parallel or when only one is visible."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    monkeypatch.delenv("LOCAL_RANK", raising=False)

    def pick(device="cuda", data_parallel=True):
        cfg = runner.InferenceConfig("c", "i", "o", 2, 1, device=device,
                                     data_parallel=data_parallel)
        return runner._serving_devices(cfg)

    cuda = [torch.device("cuda", i) for i in range(2)]
    assert pick() == (cuda[0], cuda)
    assert pick(data_parallel=False) == (torch.device("cuda"), None)
    assert pick("cuda:1") == (cuda[1], None)
    assert pick("cpu") == (CPU, None)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert pick() == (cuda[1], None)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert pick() == (torch.device("cuda"), None)
