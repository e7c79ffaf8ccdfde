"""The port's folder runner and CLI (tpuseg_torch/infer/runner.py,
tpuseg_torch/cli/inference.py) against tpuseg's, on the CPU.

The tpuseg run restores an orbax checkpoint written with save_checkpoint;
the port's checkpoint holds the same weights through the bridge. Both
serve one folder with --quantize int8_blocked from one shared scales file:
masks must agree on at least 0.999 of pixels (the fp enc1a and head blocks
sum their bf16 products in another order than XLA; the int8 blocks are
exact)."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from tpuseg.infer.erf import estimate_radius as jax_radius
from tpuseg.infer.runner import InferenceConfig as JaxConfig
from tpuseg.infer.runner import inference as jax_inference
from tpuseg.models.unet import UNet as JaxUNet
from tpuseg.train.steps import create_train_state
from tpuseg.utils.checkpoint import save_checkpoint
from tpuseg_torch.cli.inference import main
from tpuseg_torch.infer.erf import estimate_radius
from tpuseg_torch.utils.checkpoint import load_model, save_model
from tpuseg_torch.utils.imagio import imread, imwrite
from tpuseg_torch.utils.jax_bridge import unet_from_flax

from test_torch_unet import jax_model_and_vars
from torch_threads import one_cpu_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """(tpuseg checkpoint dir, port checkpoint file, port model) holding one
    set of weights (base 4, jittered BN stats)."""
    _, variables = jax_model_and_vars()
    model = JaxUNet(num_classes=2, base_features=4, dtype=jax.numpy.float32)
    state = create_train_state(model, jax.random.PRNGKey(0), num_channels=1,
                               learning_rate=1e-4)
    state = state.replace(params=jax.tree_util.tree_map(jax.numpy.asarray, variables["params"]),
                          batch_stats=jax.tree_util.tree_map(jax.numpy.asarray,
                                                             variables["batch_stats"]))
    root = tmp_path_factory.mktemp("ck")
    jax_path = str(root / "checkpoint")
    save_checkpoint(jax_path, state)
    port = unet_from_flax(variables, 2, 1, 4, torch.float32)
    port_path = str(root / "port.pt")
    save_model(port_path, port)
    return jax_path, port_path, port


def _corpus(folder):
    os.makedirs(folder)
    rng = np.random.default_rng(0)
    shapes = {"a_small.tif": (48, 40), "b_big.tif": (100, 140), "c_small.tif": (48, 40)}
    for name, shape in shapes.items():
        imwrite(os.path.join(folder, name), rng.integers(0, 4096, shape).astype(np.uint16))
    return shapes


def _port_args(port_path, imgdir, outdir, *extra):
    return ["--checkpoint_filepath", port_path, "--image_folder", imgdir,
            "--output_folder", outdir, "--number_classes", "2", "--number_channels", "1",
            "--base_features", "4", "--tile_size", "64", "--batch_size", "2",
            "--device", "cpu", *extra]


def test_cli_int8_blocked_matches_tpuseg(ckpts, tmp_path):
    jax_path, port_path, _ = ckpts
    imgdir = str(tmp_path / "imgs")
    shapes = _corpus(imgdir)
    cal = str(tmp_path / "cal.json")
    jax_out = str(tmp_path / "jax_out")
    jax_inference(JaxConfig(
        checkpoint_filepath=jax_path, image_folder=imgdir, output_folder=jax_out,
        number_classes=2, number_channels=1, tile_size=64, radius=16, batch_size=2,
        dtype="float32", base_features=4, data_parallel=False,
        quantize="int8_blocked", calibration_out=cal))
    port_out = str(tmp_path / "port_out")
    written = main(_port_args(port_path, imgdir, port_out, "--radius", "16",
                              "--quantize", "int8_blocked", "--calibration_in", cal))
    assert sorted(os.path.basename(p) for p in written) == sorted(shapes)
    total = agree = 0
    for name, shape in shapes.items():
        got = imread(os.path.join(port_out, name))
        want = imread(os.path.join(jax_out, name))
        assert got.shape == want.shape == shape and got.dtype == np.uint8
        total += got.size
        agree += int((got == want).sum())
    print(f"port vs tpuseg int8_blocked mask agreement {agree / total:.6f}")
    assert agree / total >= 0.999


def test_checkpoint_roundtrip(ckpts, tmp_path):
    _, port_path, port = ckpts
    loaded = load_model(port_path, dtype="float32")
    assert loaded.config() == port.config() and not loaded.training
    for (k, a), (_, b) in zip(loaded.state_dict().items(), port.state_dict().items()):
        assert torch.equal(a, b), k


def test_erf_radius_matches_tpuseg(ckpts):
    model, variables = jax_model_and_vars()
    _, _, port = ckpts
    # noise seed 1: the gradient support is measurable on this tiny random
    # model (most seeds give a dead center pixel and the 96 fallback)
    want = jax_radius(model, variables, 1, rng=np.random.default_rng(1))
    got = estimate_radius(port, 1, rng=np.random.default_rng(1))
    assert got == want == 80


@pytest.mark.parametrize("extra, exc", [
    (("--multihost", "1"), RuntimeError),
    (("--quantize", "none", "--calibration_out", "x.json"), ValueError),
])
def test_cli_refuses_what_is_not_ported(ckpts, tmp_path, extra, exc, monkeypatch):
    """--multihost without torchrun's environment has no process group to
    join; calibration files need a quantized mode."""
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    _, port_path, _ = ckpts
    imgdir = str(tmp_path / "imgs")
    os.makedirs(imgdir)
    with pytest.raises(exc):
        main(_port_args(port_path, imgdir, str(tmp_path / "out"), *extra))


def test_cli_cuda_without_a_card_raises(ckpts, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present, so --device cuda runs")
    _, port_path, _ = ckpts
    imgdir = str(tmp_path / "imgs")
    os.makedirs(imgdir)
    args = _port_args(port_path, imgdir, str(tmp_path / "out"))
    args[args.index("cpu")] = "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        main(args)


def test_port_imports_neither_jax_nor_tpuseg():
    """Every tpuseg_torch module (53 with the ``parallel`` package's
    data-parallel and spatial modules and K3's ``infer.int8_conv``) imports
    in a fresh interpreter without pulling in
    jax, flax, orbax, TensorFlow, protobuf or anything of tpuseg."""
    code = (
        "import importlib, pkgutil, sys, tpuseg_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(tpuseg_torch.__path__, 'tpuseg_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'orbax', 'tpuseg', 'tensorflow') "
        "or k.startswith('google.protobuf'))\n"
        "assert len(mods) >= 53, mods\n"
        "assert {'tpuseg_torch.parallel.distributed', 'tpuseg_torch.parallel.mesh', "
        "'tpuseg_torch.parallel.dryrun', 'tpuseg_torch.parallel.halo', "
        "'tpuseg_torch.infer.int8_conv'} <= set(mods), mods\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
